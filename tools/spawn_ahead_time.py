#!/usr/bin/env python3
"""Time a rank group's start-up with and without spawning it ahead.

    python3 tools/spawn_ahead_time.py [--ranks 2 4] [--repeats 3] [--units 40]

``chip_smoke.py`` spawns some of its rank groups a phase early
(``spawn_ranks``): their processes import torch and the port while the
phase before them runs, then wait for ``run_ranks``.  For each group size
this script measures, with a child that imports what the smoke's rank
children import, joins a gloo group and touches the card:

* ``fresh_s``: the wall of ``run_ranks`` on a group started by it;
* ``ahead_s``: the wall of ``run_ranks`` on a group spawned before
  ``--units`` units of work in this process (each a fixed pure-Python
  loop and 20 bf16 products of 8192 x 8192 on the card, a phase's mix);
* ``work_s`` / ``work_beside_s``: the wall of that work alone, and while
  the spawned group imports beside it.

The start-up taken off the critical path is ``fresh_s - ahead_s``; what the
overlapped phase pays for it is ``work_beside_s - work_s``.  Each repeat
runs fresh, work alone, then ahead.  Prints one JSON line with the card's
name and power limit.  Without a card the work is host-only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

_CHILD = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
from music_analyst_tpu_torch import kernels
from music_analyst_tpu_torch.models.llama import LlamaZeroShotClassifier
from music_analyst_tpu_torch.parallel import mesh as M, multihost
sys.argv = cs.rank_argv(sys.argv)
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
multihost.initialize(f"localhost:{port}", n, rank, backend="gloo",
                     timeout_s=300)
if torch.cuda.is_available():
    torch.zeros(1, device=f"cuda:{rank % torch.cuda.device_count()}")
multihost.barrier("up")
print("RESULT " + json.dumps(dict(rank=rank)), flush=True)
multihost.shutdown()
"""


def work(torch, units: int) -> float:
    """Wall of ``units`` units of host and device work."""
    cuda = torch.cuda.is_available()
    if cuda:
        a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(units):
        cs.python_ms()
        if cuda:
            for _ in range(20):
                a @ a
            torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--units", type=int, default=40)
    args = ap.parse_args()
    import torch

    os.makedirs(cs.WORK, exist_ok=True)
    card = None
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    work(torch, 1)   # the card's context and the product's first launch
    rows = []
    for n in args.ranks:
        for i in range(args.repeats):
            tag = f"spawn_ahead_np{n}_{i}"
            t0 = time.perf_counter()
            cs.run_ranks(_CHILD, n, [], tag + "_fresh")
            fresh = time.perf_counter() - t0
            alone = work(torch, args.units)
            group = cs.spawn_ranks(_CHILD, n, tag + "_ahead")
            beside = work(torch, args.units)
            t0 = time.perf_counter()
            cs.run_ranks(_CHILD, n, [], tag + "_ahead", spawned=group)
            ahead = time.perf_counter() - t0
            rows.append(dict(ranks=n, fresh_s=fresh, ahead_s=ahead,
                             work_s=alone, work_beside_s=beside,
                             saved_s=fresh - ahead - (beside - alone)))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    print(json.dumps(dict(card=card, units=args.units, rows=rows)))


if __name__ == "__main__":
    main()
