"""PyTorch + CUDA port of the dsm-tpu streaming STT serving step.

The package mirrors ``dsm_tpu``'s layout (ops, models, sessions, server) so
each module's JAX counterpart is found by path.  It imports torch, numpy
and the standard library only: never ``jax`` and never ``dsm_tpu``.

Plain tensor code is eager PyTorch.  The three kernels of the serving
path (``ops/ring_kernels.py``, ``ops/decode_attn.py``) are CUDA C++ for
``sm_90a`` in ``csrc/``, built with ``nvcc`` at first use
(``ops/_build.py``).  Each wrapper runs its plain PyTorch version for a
CPU tensor and launches its kernel for a CUDA tensor; there is no
fallback between the two.
"""

__version__ = "0.1.0"
