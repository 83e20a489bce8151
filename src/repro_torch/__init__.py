"""repro_torch — the latency-prediction pipeline on PyTorch and CUDA.

A port of the JAX package `repro` to one NVIDIA H100.  It mirrors the
reference's module paths (``repro_torch.core.executor`` is the twin of
``repro.core.executor``) and imports nothing of it: pure-numpy modules
are copied, device code is rewritten on torch, and the tree-ensemble
traversal runs in hand-written CUDA kernels (`repro_torch.kernels`).

Every entry point runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; without CUDA the default raises RuntimeError.
"""

__version__ = "0.1.0"
