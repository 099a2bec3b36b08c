"""Launch N ranks of a port script as separate processes (gloo on the CPU).

Shared by the port's multi-process tests.  Each rank runs ``python -c
SCRIPT RANK N PORT *ARGS`` from the repo root, with its output in files
(no pipe can fill and stall a rank).  The launcher waits for every rank
under one deadline; the moment a rank fails, or the deadline passes, the
remaining ranks are killed, so no peer is left blocked in a collective.
"""

import os
import pathlib
import socket
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(script, n, args, workdir, timeout=240.0):
    """Run ``n`` ranks of ``script``; returns their stdouts in rank order.
    Raises ``AssertionError`` with the failing rank's stderr."""
    port = str(free_port())
    # One thread per rank: the tests run beside other test workers.
    env = dict(os.environ, OMP_NUM_THREADS="1")
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    procs, logs = [], []
    try:
        for rank in range(n):
            out = open(workdir / f"rank{rank}.out", "w+")
            err = open(workdir / f"rank{rank}.err", "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(rank), str(n), port,
                 *map(str, args)],
                stdout=out, stderr=err, env=env, cwd=REPO,
            ))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        codes = [p.poll() for p in procs]
        for rank, code in enumerate(codes):
            if code != 0:
                err = logs[rank][1]
                err.seek(0)
                raise AssertionError(
                    f"rank {rank} of {n}: exit {code} (None = timed out)\n"
                    f"{err.read()[-3000:]}")
        outs = []
        for out, _ in logs:
            out.seek(0)
            outs.append(out.read())
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for out, err in logs:
            out.close()
            err.close()
