#!/usr/bin/env python3
"""Time one checkout's Llama-3-8B continuous generate path, per weight scheme.

    python3 tools/llama_decode_time.py [--root DIR] [--songs N] [--int4-songs N]
                                       [--schemes bf16,int8,int4]

Imports ``music_analyst_tpu_torch`` from ``DIR`` (default: this checkout)
and, for each weight scheme (bf16, ``weight_quant`` int8, int4), builds
the full-width Llama-3-8B with random weights drawn on the card (seed 0),
warms it with one 8-prompt wave, then runs ``generate_batch_continuous``
on the first N prompts of ``chip_smoke.py``'s Llama corpus
(``generate_dataset(seed=13)``; 8 slots, 16 new tokens, page 16, region
1024) and reads the scheduler's own stats:

* ``ms_per_decode_step``: wall seconds of the decode dispatches over the
  decode steps they ran (the number ``chip_smoke.py`` prints);
* ``songs_per_s``: prompts over the wall of the whole call;
* ``decode_dispatches``, ``prefill_dispatches``.

Two host-speed probes bracket each scheme: ``python_ms`` (a pure-Python
loop, no torch; ``chip_smoke.python_ms``) and ``paged_host_us`` (host
time of one paged-attention wrapper call, as
``tools/paged_wrapper_time.py``), so a slower host shows as such.
Prints one JSON line with the card's name and power limit.  Two
checkouts are compared within one session on one card by running the
script once per ``--root``, in the order parent, change, change, parent
(or longer alternations of that kind).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (not the one under
    ``--root``, so both checkouts are timed by the same functions)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose music_analyst_tpu_torch is timed")
    ap.add_argument("--songs", type=int, default=16,
                    help="prompts per bf16 and int8 run (default 16: two "
                         "waves of 8 slots)")
    ap.add_argument("--int4-songs", type=int, default=8,
                    help="prompts per int4 run (default 8)")
    ap.add_argument("--schemes", default="bf16,int8,int4",
                    help="comma-separated weight schemes to time")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    import torch

    if not torch.cuda.is_available():
        print("llama_decode_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.data.csv_io import iter_songs
    from music_analyst_tpu_torch.data.synthetic import generate_dataset
    from music_analyst_tpu_torch.models.llama import (
        LYRICS_TRUNCATION,
        PROMPT_TEMPLATE,
        LlamaConfig,
        LlamaZeroShotClassifier,
    )
    from music_analyst_tpu_torch.ops.paged_attention import paged_attention

    if not kernels.PACKAGE_DIR.startswith(root):
        print(f"llama_decode_time: imported {kernels.PACKAGE_DIR}, not "
              f"{root}", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False

    case = cs.paged_case(torch, dev, False)
    pargs, pkw = cs._pargs(case)
    paged = lambda: paged_attention(*pargs, **pkw)  # noqa: E731
    paged()
    torch.cuda.synchronize()

    def probes() -> dict:
        return dict(python_ms=cs.python_ms(),
                    paged_host_us=cs.host_us(torch, paged, 200))

    work = os.path.join(root, "build", "llama_decode_time")
    os.makedirs(work, exist_ok=True)
    dataset = os.path.join(work, "songs.csv")
    generate_dataset(dataset, num_songs=max(args.songs, args.int4_songs),
                     seed=13)
    prompts = [PROMPT_TEMPLATE.format(lyrics=t.strip()[:LYRICS_TRUNCATION])
               for _, _, t in iter_songs(dataset)]
    out = dict(root=os.path.relpath(root, HERE), card=card, schemes={})
    base = LlamaConfig.llama3_8b()
    songs = {"bf16": args.songs, "int8": args.songs, "int4": args.int4_songs}
    for scheme in args.schemes.split(","):
        n = songs[scheme]
        gc.collect()
        torch.cuda.empty_cache()
        field = {} if scheme == "bf16" else {"weight_quant": scheme}
        clf = LlamaZeroShotClassifier(
            config=dataclasses.replace(base, **field),
            max_prompt_len=cs.PAGED_REGION, device=dev, seed=0,
            decode_mode="generate", continuous_slots=cs.PAGED_SLOTS)
        row = dict(before=probes())
        clf.generate_batch_continuous(
            prompts[:cs.PAGED_SLOTS], max_new_tokens=cs.PAGED_NEW,
            n_slots=cs.PAGED_SLOTS)
        clf._slot_schedulers.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf.generate_batch_continuous(prompts[:n], max_new_tokens=cs.PAGED_NEW,
                                      n_slots=cs.PAGED_SLOTS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (sched,) = clf._slot_schedulers.values()
        stats = sched.stats()
        row.update(
            songs=n, wall_s=wall, songs_per_s=n / wall,
            ms_per_decode_step=(stats["decode_seconds"]
                                / stats["decode_steps"] * 1e3),
            decode_dispatches=stats["decode_dispatches"],
            prefill_dispatches=stats["prefill_dispatches"],
            after=probes())
        out["schemes"][scheme] = row
        print(f"llama_decode_time {out['root']} {scheme}: {json.dumps(row)}",
              file=sys.stderr, flush=True)
        del clf, sched
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
