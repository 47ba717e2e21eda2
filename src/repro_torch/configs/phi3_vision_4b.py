"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend stub
(precomputed patch embeddings). [hf:microsoft/Phi-3-vision-128k-instruct; hf]
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.

Port of ``repro.configs.phi3_vision_4b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("phi-3-vision-4.2b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="phi-3-vision-4.2b",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_head=96,
        d_ff=8192,
        vocab_size=32064,
        frontend="vision",
        n_frontend_tokens=576,           # CLIP ViT-L/14 @336px patch tokens
        rope_theta=10000.0,
        tie_embeddings=False,
        remat=True,                      # the reference's ArchConfig default
    )
