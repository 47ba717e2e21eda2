"""SemanticXR's own server-side model config: the ~110M captioner LM.

Port of ``repro.configs.semanticxr``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("semanticxr-captioner-110m")
def captioner() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="semanticxr-captioner-110m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_head=64,
        d_ff=2048,
        vocab_size=32000,
        rope_theta=10000.0,
        tie_embeddings=True,
    )
