"""Device resolution for the PyTorch port.

Every entry point of ``repro_torch`` runs on the card unless the caller asks
for the CPU: constructors take ``device="cuda"`` by default and resolve it
here.  Without a GPU that default raises instead of carrying on silently on
the CPU, so a run that was meant to measure the card can never end up timing
PyTorch's CPU kernels.  Tests pass ``device="cpu"`` explicitly.

Resolving a CUDA device also switches TF32 off for matmuls and cuDNN: the
reference keeps f32 products at full precision, and TF32 keeps about three
decimal digits.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` -> ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
