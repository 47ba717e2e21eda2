"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions,
and the device-picking entry points (``ops``)."""
