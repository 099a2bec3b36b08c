#!/usr/bin/env python3
"""Time one checkout's host-bound CLI paths as processes on the card.

    python3 tools/host_paths_time.py --root DIR [--work DIR]
                                     [--paths persong,mock_cli,serve_mock]

Runs, with ``DIR``'s ``music_analyst_tpu_torch`` (``python -m`` from
``DIR``), on corpora generated by this checkout's generator with
``chip_smoke.py``'s seeds:

* ``persong_s``: ``wordcount-per-song`` on 57,650 songs (``--delimiter ,``),
  process wall;
* ``mock_cli_s``: ``sentiment --mock`` on 16,384 songs, process wall;
* ``serve_mock_req_s``: ``serve --stdio --mock`` answering a 2,048-request
  burst, requests/s from the first write to the last reply (start-up
  excluded), as ``chip_smoke.py`` times it.

Beside them ``python_ms`` (``chip_smoke.python_ms``, a fixed pure-Python
loop) shows the host's speed at that moment.  Prints one JSON line with
the card's name and power limit.  Compare two checkouts within one call
on one card in the order parent, change, change, parent.  Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cli_wall(root, args) -> float:
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "music_analyst_tpu_torch",
                           *args], cwd=root, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"{args[0]}: rc {proc.returncode}: "
                         f"{proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def _serve_mock_rate(root, texts, device) -> float:
    lines = "".join(json.dumps({"id": i, "op": "sentiment", "text": t}) + "\n"
                    for i, t in enumerate(texts))
    proc = subprocess.Popen(
        [sys.executable, "-m", "music_analyst_tpu_torch", "serve", "--stdio",
         "--mock", "--no-response-cache", "--device", device, "--max-queue",
         str(len(texts) + 16)], cwd=root, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    stderr = []
    threading.Thread(target=lambda: stderr.extend(proc.stderr),
                     daemon=True).start()
    try:
        deadline = time.perf_counter() + 300
        while not any("ready" in s for s in stderr):
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise SystemExit(f"serve did not start: {''.join(stderr)}")
            time.sleep(0.05)
        t0 = time.perf_counter()
        writer = threading.Thread(
            target=lambda: (proc.stdin.write(lines), proc.stdin.flush()),
            daemon=True)
        writer.start()
        for _ in texts:
            proc.stdout.readline()
        wall = time.perf_counter() - t0
        writer.join()
        proc.stdin.close()
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return len(texts) / wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose music_analyst_tpu_torch is timed")
    ap.add_argument("--work", default=os.path.join(HERE, "build",
                                                    "host_paths"),
                    help="directory for the corpora and outputs")
    ap.add_argument("--paths", default="persong,mock_cli,serve_mock",
                    help="comma-separated paths to time (default: all)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the timed runs (cpu only rehearses)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.data.synthetic import generate_dataset

    smoke = _chip_smoke()
    os.makedirs(args.work, exist_ok=True)
    corpora = {}
    for name, songs, seed in (("analyze", 57_650, 17), ("main", 16_384, 11),
                              ("serve", 2048, 19)):
        path = os.path.join(args.work, f"songs_{songs}.csv")
        if not os.path.exists(path):
            generate_dataset(path, num_songs=songs, seed=seed)
        corpora[name] = path
    out = os.path.join(args.work, "out")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"root": os.path.abspath(args.root), "card": card,
              "python_ms": smoke.python_ms()}
    paths = args.paths.split(",")
    if "persong" in paths:
        result["persong_s"] = _cli_wall(args.root, [
            "wordcount-per-song", corpora["analyze"], "--delimiter", ",",
            "--device", args.device, "--output-dir",
            os.path.join(out, "persong")])
    if "mock_cli" in paths:
        result["mock_cli_s"] = _cli_wall(args.root, [
            "sentiment", corpora["main"], "--mock", "--device", args.device,
            "--output-dir", os.path.join(out, "mock")])
    if "serve_mock" in paths:
        result["serve_mock_req_s"] = _serve_mock_rate(
            args.root, [t for _, _, t in iter_songs(corpora["serve"])],
            args.device)
    result["python_ms_after"] = smoke.python_ms()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
