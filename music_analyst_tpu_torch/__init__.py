"""music_analyst_tpu_torch — the PyTorch + CUDA port of ``music_analyst_tpu``.

The JAX package beside this one is the reference; this package computes
the same results with PyTorch on an NVIDIA Hopper card (H100).  Every
Pallas kernel on a ported path is a CUDA C++ kernel here (``csrc/``,
built with ``nvcc`` at first use into ``build/torch_kernels/`` and bound
with ``ctypes``), with a plain PyTorch version of the same function beside
each wrapper.  The wrappers launch the kernel for CUDA tensors and run the
plain version only for CPU tensors (the CPU parity tests).

Ported so far (batch sentiment, Llama decode, word count):

* ``data/``     — CSV readers and the exact parser, tokenizers, vocab,
                  corpus ingest (C++ or Python) with its persistent cache,
                  the column splitters, the synthetic dataset generator.
* ``ops/``      — keyword scan (``--mock``), flash attention and paged
                  attention, each a wrapper over a hand-written kernel plus
                  its plain version; the word-count histograms (torch ops
                  on the card: the JAX package has no kernel there).
* ``models/``   — tokenizers, attention/MLP layers, the DistilBERT and
                  Llama classifiers, the keyword classifier.
* ``runtime/``, ``serving/`` — the host→device wire, the bounded prefetch
                  pipeline, the continuous decode scheduler.
* ``metrics/``, ``parallel/`` — stage timers, ``performance_metrics.json``,
                  the one-device mesh.
* ``engines/``  — ``run_sentiment``, ``run_analysis``, ``run_joint``.
* ``cli/``      — ``python -m music_analyst_tpu_torch {analyze,sentiment,split}``.

The package imports neither JAX nor anything of ``music_analyst_tpu``.
"""

__version__ = "0.1.0"
