"""Shared building blocks of the port's language model.

Port of the parts of ``repro.models.common`` that the model paths read
(dense attention, DeepSeek's MLA + MoE, the recurrent Mamba and RWKV-6
mixers, and whisper's encoder-decoder): the architecture config with its MLA, Mamba, RWKV and MoE
sub-configs, the numerics (``rms_norm``, ``softcap``,
``act_fn``, rotary embeddings), parameter initialisation by naming
rule and ``count_params``.  Parameters are nested dicts (lists for the
layer stack) of tensors; ``ParamTree`` registers such a tree on an
``nn.Module``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Mixer kinds understood by blocks.py.
MIXER_FULL = "attn_full"          # dense causal attention
MIXER_SWA = "attn_swa"            # sliding-window causal attention
MIXER_GLOBAL = "attn_global"      # gemma2 "global" layer (full, with softcap)
MIXER_MLA = "mla"                 # DeepSeek multi-head latent attention
MIXER_MAMBA = "mamba"             # Mamba-1 selective SSM
MIXER_RWKV6 = "rwkv6"             # RWKV-6 "Finch" time mixing

MLP_DENSE = "dense"
MLP_MOE = "moe"

@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention (V2 / V3) widths."""
    q_lora_rank: int = 1536          # 0 => no query compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # decode scores queries against the latent cache (W_UK folded into the
    # query, W_UV into the output) instead of re-expanding K / V
    absorb: bool = False


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM widths; ``chunk`` is the scan's chunk length."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 => ceil(d_model / 16)
    chunk: int = 64


@dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 time-mix widths; ``chunk`` is the wkv scan's chunk length."""
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32
    chunk: int = 64


@dataclass(frozen=True)
class MoEConfig:
    """Shared + routed top-k experts.  ``router_dtype`` is the router's
    parameter dtype.  ``dispatch`` ("dense" / "ragged") is carried for
    config equality only: the reference's ``moe_apply`` never reads it."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 1
    capacity_factor: float = 1.25
    router_dtype: Any = torch.float32
    dispatch: str = "dense"


@dataclass(frozen=True)
class ArchConfig:
    """The fields of ``repro.models.common.ArchConfig`` that the model
    paths read.  ``dtype`` is a ``torch.dtype``.  ``kv_cache_dtype`` is
    "bf16" (the cache in the model dtype) or "int8" (int8 values and an f32
    scale per token and kv head).  ``mla`` is DeepSeek's sub-config,
    ``moe`` DeepSeek's and jamba's, ``mamba`` and ``rwkv`` the recurrent
    mixers'; ``moe_groups`` is the least number of MoE dispatch
    groups.  ``moe_weight_shard`` and ``rwkv_tm_shard`` choose the mesh's
    expert and RWKV time-mix shardings: the sharding rules
    (``distributed/sharding.py``) read them, no model code does.
    ``act_shard`` is set only by the dry run's ``seq_parallel`` rewrite, and
    nothing reads it.  ``prune_tiles`` (skip fully masked attention tiles)
    is read by the cost model alone: the port's flash kernel skips such
    tiles anyway.
    ``frontend`` is None, "vision" (precomputed patch embeddings,
    ``n_frontend_tokens`` an image, put in front of the text through
    ``vis_proj``) or "audio" (whisper's stub: precomputed frame embeddings
    fed to the encoder).  ``encdec`` marks the encoder-decoder: then
    ``n_layers`` is the decoder's depth, ``n_enc_layers`` the encoder's, and
    ``enc_seq`` the encoder length that sizes a serving cache's cross k /
    v (the encoder itself runs at its frames' length).  The other JAX
    execution knobs (scan, the jnp attention's q-chunk) are not ported.
    ``remat`` checkpoints each body period's activations
    (``torch.utils.checkpoint``) as the reference's ``jax.checkpoint``
    does; ``grad_accum`` splits a train step's batch into microbatches."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                       # 0 => d_model // n_heads

    # layer pattern: mixers[i % len(mixers)] / mlps[i % len(mlps)] after the
    # dense prefix of ``n_dense_prefix`` layers
    mixers: tuple = (MIXER_FULL,)
    mlps: tuple = (MLP_DENSE,)
    n_dense_prefix: int = 0
    d_ff_dense_prefix: int = 0            # 0 => d_ff

    # attention knobs
    sliding_window: int = 4096
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False

    # family sub-configs
    mla: MLAConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    moe: MoEConfig | None = None

    # encoder-decoder (whisper): n_layers is the decoder depth
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500                   # stub conv frontend output frames

    # modality frontend stub: None | "audio" | "vision"
    frontend: str | None = None
    n_frontend_tokens: int = 0            # vision: patch tokens per image

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: str = "silu"                     # mlp activation ("silu"|"gelu")
    dtype: Any = torch.bfloat16
    kv_cache_dtype: str = "bf16"          # "bf16" (the model dtype) | "int8"
    remat: bool = False                   # activation checkpointing per period
    grad_accum: int = 1                   # microbatches per train step
    moe_groups: int = 1                   # MoE dispatch groups (at least)
    moe_weight_shard: str = "2d"          # "2d" | "ep": the expert rule
    act_shard: tuple | None = None        # dry run's seq_parallel; unread
    rwkv_tm_shard: str = "model"          # "model" | "replicated"
    prune_tiles: bool = False             # the cost model's tile count

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head",
                               self.d_model // max(self.n_heads, 1))

    @property
    def period(self) -> int:
        return int(np.lcm(len(self.mixers), len(self.mlps)))

    @property
    def n_body_layers(self) -> int:
        return self.n_layers - self.n_dense_prefix

    @property
    def n_periods(self) -> int:
        assert self.n_body_layers % self.period == 0, (
            f"{self.name}: body layers {self.n_body_layers} not divisible by "
            f"period {self.period}")
        return self.n_body_layers // self.period

    def block_kinds(self, slot: int) -> tuple[str, str]:
        """(mixer, mlp) for period slot ``slot``."""
        return (self.mixers[slot % len(self.mixers)],
                self.mlps[slot % len(self.mlps)])

    def layer_kinds(self) -> list[tuple[str, str]]:
        """(mixer, mlp) of every layer in order: the dense prefix, then the
        body's periods."""
        prefix = [(self.mixers[0], MLP_DENSE)] * self.n_dense_prefix
        return prefix + [self.block_kinds(s) for _ in range(self.n_periods)
                         for s in range(self.period)]

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap


def act_fn(name: str):
    """``jax.nn.gelu`` defaults to the tanh approximation, and so does this."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu,
            "relu2": lambda x: F.relu(x).square()}[name]


def rope_freqs(d: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))


_ROPE_FREQS: dict = {}


def _rope_freqs_on(d: int, theta: float, device: torch.device):
    """``rope_freqs`` as f32 on ``device``, copied there once: a copy from
    host memory on every call would make the host wait for the card."""
    key = (d, float(theta), device)
    if key not in _ROPE_FREQS:
        _ROPE_FREQS[key] = torch.as_tensor(rope_freqs(d, theta),
                                           dtype=torch.float32).to(device)
    return _ROPE_FREQS[key]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, d]; positions: broadcastable to [..., seq].
    Half-split rotation (not interleaved), in f32, cast back."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)
    angles = positions.float()[..., None] * freqs                 # [..., S, d/2]
    cos = torch.cos(angles)[..., None, :]                         # [..., S, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Spec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def spec(shape, dtype) -> Spec:
    return Spec(tuple(int(s) for s in shape), dtype)


def stack_specs(tree, n: int):
    """A tree of ``Spec`` (dicts, lists, NamedTuples such as a cache, None
    for an absent field) with ``n`` put in front of every leaf's shape: the
    reference's stacked layout of ``n`` layers."""
    if tree is None:
        return None
    if isinstance(tree, Spec):
        return spec((n,) + tree.shape, tree.dtype)
    if isinstance(tree, dict):
        return {k: stack_specs(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [stack_specs(v, n) for v in tree]
    return type(tree)(*(stack_specs(v, n) for v in tree))


def count_params(specs) -> int:
    """The number of parameters of a tree of ``Spec``."""
    return int(sum(math.prod(s.shape) for _, s in leaves(specs)))


def _leaf_init(gen: torch.Generator, path: str, shape, dtype,
               fan_in: int | None = None):
    """Init rule by naming convention, the reference's: *scale -> zeros
    (rms uses 1+scale), *bias -> zeros (Mamba's ``dt_bias`` too: the
    reference tests "bias" before its own ``dt_bias`` rule), Mamba's
    ``A_log`` -> log(1 .. d_state) tiled, RWKV's ``decay_base`` -> -6 + 5
    (i / (n-1))^0.7 (in f32 as the reference's, each log and power formed
    in f64 and rounded once: XLA's own f32 log and pow match no other
    library's bits, and are within two ulps of that) and ``mix_mu`` ->
    uniform on [0.3, 0.7), embeddings & matmuls -> truncated normal /
    sqrt(fan_in) (fan_in ``shape[-1]`` for a 1-D leaf, ``shape[-2]``
    otherwise, unless given).  Drawn in f32 on the generator's device,
    scaled in place (one f32 temporary: DeepSeek-V3's [256, 7168, 2048]
    expert leaf is 15 GB in f32), then cast."""
    dev = gen.device
    if path.endswith("scale") or path.endswith("bias"):
        return torch.zeros(shape, dtype=dtype, device=dev)
    if path.endswith("A_log") or path.endswith("decay_base"):
        n = shape[-1]
        if path.endswith("A_log"):
            row = np.log(np.arange(1, n + 1, dtype=np.float64)).astype(
                np.float32)
        else:
            f = np.arange(n, dtype=np.float32) / np.float32(max(n - 1, 1))
            p = np.power(f.astype(np.float64), float(np.float32(0.7)))
            row = np.float32(-6.0) + np.float32(5.0) * p.astype(np.float32)
        row = torch.from_numpy(row).to(dev)
        return row.expand(shape).to(dtype).contiguous()
    if path.endswith("mix_mu"):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        return w.uniform_(0.3, 0.7, generator=gen).to(dtype)
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.empty(shape, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.div_(math.sqrt(max(fan_in, 1))).to(dtype)


def leaves(tree, prefix=""):
    """(path, leaf) in sorted-key order, list entries by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from leaves(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def map_tree(fn, tree, prefix=""):
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def init_from_specs(gen: torch.Generator, specs, fan_in=None) -> Any:
    """specs: tree of ``Spec``; returns a tree of tensors, each leaf drawn
    from ``gen`` in sorted path order (numbers differ from JAX's).
    ``fan_in(path, shape)``, where given, overrides a leaf's fan-in when it
    returns a number."""
    values = {p: _leaf_init(gen, p, s.shape, s.dtype,
                            fan_in and fan_in(p, s.shape))
              for p, s in leaves(specs)}
    return map_tree(lambda p, _: values[p], specs)


class ParamTree(nn.Module):
    """A tree of dicts (and lists) of tensors as an ``nn.Module``: dict keys
    become submodules or parameters, lists ``nn.ModuleList``s, and
    ``tree["key"]`` reads an entry, so the model's functions take either
    this or a plain dict.  Parameters are frozen, as serving wants them;
    ``requires_grad_(True)`` makes them trainable."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList(ParamTree(t) for t in v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        """The parameters themselves as a tree of dicts and lists."""
        out = dict(self._parameters)
        for k, mod in self._modules.items():
            out[k] = ([m.tree() for m in mod]
                      if isinstance(mod, nn.ModuleList) else mod.tree())
        return out


def as_tree(params):
    """A ``ParamTree``'s tree, or ``params`` itself when it is one."""
    return params.tree() if isinstance(params, ParamTree) else params
