"""Per-object semantic embeddings: the MobileCLIP role in the paper's
pipeline (Sec. 4.1).  Port of ``repro.perception.embedder.OracleEmbedder``.

Deterministic class-conditioned unit vectors + per-view noise, so retrieval
quality differences come from SYSTEM choices, not model noise.  The class
basis is drawn by ``np.random.default_rng(seed)`` exactly as in the
reference, so it is bit-identical.  The per-view noise is not: the reference
draws it with ``jax.random.normal``.  ``embed_observation`` therefore takes
the noise as an input — either a ``[D, E]`` standard-normal tensor (parity
tests pass the reference's own draws) or a ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.scenes import N_CLASSES
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclass
class OracleEmbedder:
    embed_dim: int = 512
    noise: float = 0.4
    seed: int = 7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        basis = rng.normal(size=(N_CLASSES, self.embed_dim))
        basis /= np.linalg.norm(basis, axis=1, keepdims=True)
        self.basis_np = basis.astype(np.float32)
        self._basis = {}                  # device -> [N_CLASSES, E] f32

    def basis(self, device) -> torch.Tensor:
        dev = torch.device(device)
        if dev not in self._basis:
            self._basis[dev] = torch.from_numpy(self.basis_np).to(dev)
        return self._basis[dev]

    def embed_observation(self, class_ids: torch.Tensor,
                          noise: torch.Tensor | torch.Generator, *,
                          quality: float = 1.0) -> torch.Tensor:
        """[D] class ids -> [D, E] noisy unit view embeddings on the ids'
        device.  ``noise`` is a [D, E] standard-normal tensor or a
        ``torch.Generator`` to draw one from; ``quality`` in (0, 1] scales
        the noise up for degraded observations."""
        base = self.basis(class_ids.device)[class_ids.long()]
        # ``noise`` is the total perturbation norm (dim-independent): the
        # per-component sigma scales by 1/sqrt(E); f32 steps as the reference
        sigma = np.float32(self.noise) / np.float32(max(quality, 1e-3))
        sigma = float(np.float32(sigma / np.float32(self.embed_dim ** 0.5)))
        if isinstance(noise, torch.Generator):
            z = torch.randn(base.shape, generator=noise,
                            device=noise.device, dtype=torch.float32)
        else:
            z = noise
        if tuple(z.shape) != tuple(base.shape):
            raise ValueError(f"noise shape {tuple(z.shape)} != "
                             f"{tuple(base.shape)}")
        e = base + z.to(base.device, torch.float32) * sigma
        return e / torch.clamp(torch.linalg.vector_norm(e, dim=-1,
                                                        keepdim=True),
                               min=1e-9)

    def embed_text(self, class_id: int,
                   device=DEFAULT_DEVICE) -> torch.Tensor:
        """Query-side embedding for 'where is my <class>?'."""
        return self.basis(resolve_device(device))[int(class_id)]
