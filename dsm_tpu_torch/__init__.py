"""PyTorch + CUDA port of dsm-tpu: the streaming STT server (stt-1b and
stt-2.6b), the batched TTS server (tts-1.6b and tts_202501), the
full-duplex dialogue server (s2s-2b) and the Mimi codec rooms, with int8 or
packed-int4 KV rings, prometheus metrics and an auth issuance service.

The package mirrors ``dsm_tpu``'s layout (ops, models, sessions, server) so
each module's JAX counterpart is found by path.  It imports torch, numpy
and the standard library only: never ``jax`` and never ``dsm_tpu``.

Plain tensor code is eager PyTorch.  Every Pallas kernel of the JAX package
has a counterpart in CUDA C++ for ``sm_90a`` in ``csrc/`` (the ring commits,
the int8 and int4 ring attentions, the fused attention + commit, the voice
cross-attention, the weight-only int8 matmul, the tuning tool's attention),
built with ``nvcc`` at first use (``ops/_build.py``).  Each wrapper runs its
plain PyTorch version for a CPU tensor and launches its kernel for a CUDA
tensor; there is no fallback between the two.  The ASR mailboxes' frame
packer is C++ (``csrc/packer.cpp``), built with ``g++`` at first use
(``server/native.py``).
"""

__version__ = "0.1.0"
