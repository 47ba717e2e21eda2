"""PyTorch / CUDA port of the SemanticXR reproduction.

A second package beside ``repro`` (the JAX reference), with the same module
layout and public names: ``repro_torch/core/store.py`` is the counterpart of
``repro/core/store.py``, and so on.  It imports ``torch`` and never ``jax``
or anything of ``repro``.  Entry points run on the GPU unless the caller
passes ``device="cpu"`` (see ``repro_torch.device``); the two TPU kernels of
the main path are CUDA C++ kernels under ``repro_torch/kernels/csrc``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
