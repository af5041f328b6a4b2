"""PyTorch/CUDA port of the DP-MF system, one slice at a time.

Mirrors the layout of the JAX package ``repro`` (``repro_torch/core/ranks.py``
is the counterpart of ``repro/core/ranks.py``, and so on) so a reader finds
each counterpart by name.  This package imports ``torch`` and ``numpy`` only:
never ``jax``, never anything of ``repro``.

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).  CUDA tensors go through the hand-written
kernels under ``kernels/csrc/``; CPU tensors go through each kernel's plain
PyTorch version.
"""
