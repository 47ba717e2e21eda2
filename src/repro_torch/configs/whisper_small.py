"""whisper-small [audio] — enc-dec; conv frontend is a stub (precomputed
frame embeddings). [arXiv:2212.04356; unverified]
12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.

Port of ``repro.configs.whisper_small``.
"""
from repro_torch.configs.base import register
from repro_torch.models import common as cm


@register("whisper-small")
def config() -> cm.ArchConfig:
    return cm.ArchConfig(
        name="whisper-small",
        n_layers=12,                     # decoder
        n_enc_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_head=64,
        d_ff=3072,
        vocab_size=51865,
        encdec=True,
        frontend="audio",
        enc_seq=1500,
        act="gelu",
        tie_embeddings=True,
        remat=True,                      # the reference's ArchConfig default
    )
