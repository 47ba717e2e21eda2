"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE every other layer.
[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
MoE 16e top-2.

Port of ``repro.configs.jamba_v01_52b``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm

_M = cm.MIXER_MAMBA
_A = cm.MIXER_FULL


@register("jamba-v0.1-52b")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="jamba-v0.1-52b",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab_size=65536,
        # 8-layer jamba block: attention at index 4, mamba elsewhere;
        # MoE replaces the dense MLP on every other layer.
        mixers=(_M, _M, _M, _M, _A, _M, _M, _M),
        mlps=(cm.MLP_DENSE, cm.MLP_MOE),
        moe=cm.MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, n_shared=0),
        mamba=cm.MambaConfig(d_state=16, d_conv=4, expand=2, chunk=32),
        rope_theta=10000.0,
        tie_embeddings=False,
        remat=True,                      # the reference's ArchConfig default
    )
