"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Mirrors ``src/repro/`` module for module (each file's reference is its
namesake there) and imports neither JAX nor ``repro``.  Plain tensor code
is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++ kernel
under ``csrc/`` built for ``sm_90a`` at first use (``kernels/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit CPU request they raise.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
