"""music_analyst_tpu_torch — the PyTorch + CUDA port of ``music_analyst_tpu``.

The JAX package beside this one is the reference; this package computes
the same results with PyTorch on an NVIDIA Hopper card (H100).  Every
Pallas kernel on a ported path is a CUDA C++ kernel here (``csrc/``,
built with ``nvcc`` at first use into ``build/torch_kernels/`` and bound
with ``ctypes``), with a plain PyTorch version of the same function beside
each wrapper.  The wrappers launch the kernel for CUDA tensors and run the
plain version only for CPU tensors (the CPU parity tests).

Ported so far (the batch-sentiment slice):

* ``data/``     — CSV reader and synthetic dataset generator (copies).
* ``ops/``      — keyword scan (``--mock``) and flash attention, each a
                  wrapper over a hand-written kernel plus its plain version.
* ``models/``   — tokenizers, attention/MLP layers, the DistilBERT
                  classifier, the keyword classifier.
* ``runtime/``  — the host→device wire and the bounded prefetch pipeline.
* ``engines/``  — ``run_sentiment``.
* ``cli/``      — ``python -m music_analyst_tpu_torch sentiment ...``.

The package imports neither JAX nor anything of ``music_analyst_tpu``.
"""

__version__ = "0.1.0"
