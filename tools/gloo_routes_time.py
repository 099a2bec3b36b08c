#!/usr/bin/env python3
"""Time gloo's collectives between two ranks sharing one card.

    python3 tools/gloo_routes_time.py [--mib 256] [--reps 5]

Starts two rank processes over gloo on a free localhost port and, on one
bucket of ``--mib`` MiB of f32 viewed as ``[2, w]`` (a ZeRO-1 bucket at
dp 2: row ``i`` belongs to rank ``i``), times in each rank's pinned host
memory, as ``parallel/mesh.py`` stages a card's tensors:

* ``reduce_scatter_tensor`` (this rank's row of the sum);
* ``all_to_all_single`` (each row to its owner: the port's reduce-scatter,
  which then sums on the card, and its all-gather);
* ``all_gather_into_tensor`` and ``all_reduce``;

then the port's own ZeRO-1 pair on a 1 GiB card tensor of f32
(``mesh.reduce_scatter_rows`` and ``mesh.all_gather_rows_``, D2H and H2D
copies included).  Each figure is the mean wall of ``--reps`` calls after
one warm-up, between barriers.  Prints one JSON line with the card's name
and power limit.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK = r"""
import json, sys, time
sys.path.insert(0, sys.argv[5])
import torch
import torch.distributed as dist
from music_analyst_tpu_torch.parallel import mesh as M, multihost
rank, n, port, mib, root, reps = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], int(sys.argv[4]), sys.argv[5],
                                  int(sys.argv[6]))
multihost.initialize(f"localhost:{port}", n, rank, backend="gloo",
                     timeout_s=300)
mesh = M.build_mesh(M.MeshSpec((("dp", n),)))
torch.cuda.set_device(mesh.device)
w = (mib << 20) // 4 // n
x = torch.randn(n, w).pin_memory()
recv = torch.empty_like(x).pin_memory()
mine = torch.empty(w).pin_memory()

def timed(fn):
    fn()
    dist.barrier()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dist.barrier()
    return (time.perf_counter() - t) / reps * 1e3

out = dict(bucket_mib=mib)
out["reduce_scatter_tensor_ms"] = timed(
    lambda: dist.reduce_scatter_tensor(mine, x.view(-1)))
out["all_to_all_single_ms"] = timed(
    lambda: dist.all_to_all_single(recv.view(-1), x.view(-1)))
out["all_gather_into_tensor_ms"] = timed(
    lambda: dist.all_gather_into_tensor(recv.view(-1), x[rank].contiguous()))
out["all_reduce_ms"] = timed(lambda: dist.all_reduce(x))
grad = torch.randn(1 << 28, device=mesh.device)           # 1 GiB of f32
out["port_reduce_scatter_ms_per_gib"] = timed(
    lambda: M.reduce_scatter_rows([grad], mesh, "dp"))
out["port_all_gather_ms_per_gib"] = timed(
    lambda: M.all_gather_rows_([grad], mesh, "dp"))
out["routes"] = dict(M.ROUTES)
if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
multihost.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mib", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "2", port, str(args.mib), ROOT,
         str(args.reps)], stdout=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(p.returncode for p in procs):
        print(f"a rank failed: {[p.returncode for p in procs]}",
              file=sys.stderr)
        return 1
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("RESULT "))
    print(json.dumps(dict(json.loads(line[len("RESULT "):]), card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
