"""PyTorch / CUDA port of the SemanticXR reproduction.

A second package beside ``repro`` (the JAX reference), with the same module
layout and public names: ``repro_torch/core/store.py`` is the counterpart of
``repro/core/store.py``, and so on.  It imports ``torch`` and never ``jax``
or anything of ``repro``.  Entry points run on the GPU unless the caller
passes ``device="cpu"`` (see ``repro_torch.device``); each of the reference's
four TPU kernels (lift_compact, query_topk_bias, flash_attention,
nearest_dist) is a CUDA C++ kernel under ``repro_torch/kernels/csrc``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
