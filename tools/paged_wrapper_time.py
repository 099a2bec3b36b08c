#!/usr/bin/env python3
"""Time one checkout's paged-attention wrapper at the Llama-3-8B decode shape.

    python3 tools/paged_wrapper_time.py [--root DIR]

Imports ``music_analyst_tpu_torch`` from ``DIR`` (default: this checkout),
builds its paged kernel there, and times ``paged_attention`` on the case
``chip_smoke.py`` holds the kernel to (8 slots, page 16, region 1024, bf16
pools, seed 5), with this checkout's timing functions:

* ``host_us``: host time of one wrapper call, mean over 200 back-to-back
  calls, read before the card is waited for;
* ``event_ms``: CUDA events around 100 back-to-back calls;
* ``ms`` / ``ms_l2_flushed``: kernel device time by ``torch.profiler``,
  warm and after a 128 MB write before each call.

Prints one JSON line with the card's name and power limit.  Two checkouts
are compared within one session on one card by running the script once
per ``--root``, in the order parent, change, change, parent.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

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
    root = os.path.abspath(ap.parse_args().root)
    import torch

    if not torch.cuda.is_available():
        print("paged_wrapper_time: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from music_analyst_tpu_torch import kernels
    from music_analyst_tpu_torch.ops.paged_attention import paged_attention

    if not kernels.PACKAGE_DIR.startswith(root):
        print(f"paged_wrapper_time: imported {kernels.PACKAGE_DIR}, not "
              f"{root}", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    case = cs.paged_case(torch, dev, False)
    args, kw = cs._pargs(case)
    call = lambda: paged_attention(*args, **kw)  # noqa: E731
    call()
    torch.cuda.synchronize()
    out = dict(root=os.path.relpath(root, HERE), card=card,
               host_us=cs.host_us(torch, call, 200),
               event_ms=cs.time_ms(torch, call, 100, 3),
               ms=cs.device_ms(torch, call, 100),
               ms_l2_flushed=cs.device_ms(torch, call, 100, flush=True),
               host_us_again=cs.host_us(torch, call, 200))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
