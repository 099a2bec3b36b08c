#!/usr/bin/env python3
"""Probe ``torch._int_mm`` (cuBLASLt int8 x int8 -> int32) on the card.

    python3 tools/int_mm_probe.py

What the quantized products in ``music_analyst_tpu_torch/ops/quant.py``
rely on, measured at the Llama-3-8B projection shapes (K x N: 4096 x
4096, 4096 x 14336, 14336 x 4096, 4096 x 128256) for M = 17, 32 and 512
rows:

* which row counts the card accepts (M = 8, 16, 17, 32 at K = N = 64);
* device time (``torch.profiler``, warm; 0.0 where it records no
  kernel) and CUDA-event time of the product with the weight
  K-contiguous (``w.t()`` of a contiguous ``[N, K]``, the layout
  ``WqLinear`` keeps) and row-major (``[K, N]`` contiguous), each held
  exactly against a float64 product on the CPU, beside the bf16 product
  ``x @ w.t()``.

Prints one JSON line per shape, then a summary line with the card's name
and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4096, 4096), (4096, 14336), (14336, 4096), (4096, 128256)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("int_mm_probe: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(1)
    accepted = {}
    for M in (8, 16, 17, 32):
        a = torch.randint(-127, 128, (M, 64), dtype=torch.int8, device=dev,
                          generator=gen)
        b = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device=dev,
                          generator=gen)
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
            accepted[M] = "ok"
        except RuntimeError as exc:
            accepted[M] = str(exc).splitlines()[0][:160]
    for K, N in SHAPES:
        for M in (17, 32, 512):
            a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev,
                              generator=gen)
            w = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=dev,
                              generator=gen)
            want = a.cpu().double() @ w.cpu().double().t()
            out = dict(K=K, N=N, M=M)
            for name, b in (("k_contiguous", w.t()),
                            ("row_major", w.t().contiguous())):
                got = torch._int_mm(a, b)
                out[name] = dict(
                    exact=bool((got.cpu().double() == want).all()),
                    ms=chip_smoke.profiled_ms(
                        torch, lambda: torch._int_mm(a, b), 10),
                    event_ms=chip_smoke.time_ms(
                        torch, lambda: torch._int_mm(a, b), 10))
            xb = torch.randn(M, K, device=dev, generator=gen).to(torch.bfloat16)
            wb = torch.randn(N, K, device=dev, generator=gen).to(torch.bfloat16)
            out["bf16_ms"] = chip_smoke.profiled_ms(torch, lambda: xb @ wb.t(),
                                                    10)
            out["bf16_event_ms"] = chip_smoke.time_ms(torch, lambda: xb @ wb.t(),
                                                      10)
            print(json.dumps(out), flush=True)
            del a, w, want, xb, wb
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "rows_accepted_at_k64": accepted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
