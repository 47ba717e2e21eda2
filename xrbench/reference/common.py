"""Plain PyTorch pieces the references share, and the precision they run in.

The references compute in float32 with TF32 off.  ``Precision("fp8")`` is
the control: the same reference with every weight matrix and every
matrix product's input rounded to float8 e4m3 (a scale per output channel
for a weight, per row for an activation), the step below the served
bfloat16 that a later change might be tempted to take.  Nothing here
imports the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (f32) rounded to e4m3 with one scale along ``dim``'s slices."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """``mm(x, w)`` and ``weight(w)`` of the reference: f32, or the fp8
    control."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A bf16 weight matrix [..., in, out] as the reference reads it."""
        w = w.float()
        if self.kind == "fp8" and w.dim() >= 2:
            w = fp8_round(w, dim=-2)
        return w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x, dim=-1) if self.kind == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ self.weight(w)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """x / rms(x) * (1 + scale), in f32."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())


def glu_mlp(x, wg, wu, wd, p: Precision):
    """SiLU-gated MLP: (silu(x wg) * (x wu)) wd."""
    return p.mm(F.silu(p.mm(x, wg)) * p.mm(x, wu), wd)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, L, H, dh] at positions 0 .. L-1, the
    half-split (not interleaved) rotation, in f64 angles."""
    L, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh)
    ang = torch.arange(L, dtype=torch.float64)[:, None] * inv[None]
    cos = torch.cos(ang).float().to(x.device)[None, :, None]
    sin = torch.sin(ang).float().to(x.device)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_gqa_attention(q, k, v) -> torch.Tensor:
    """Softmax attention, causal, q [B, L, H, dh] over k, v [B, L, K, dh];
    query head h reads kv head h // (H / K).  Blocks of 512 queries keep
    the score matrix small."""
    B, L, H, dh = q.shape
    K = k.shape[2]
    k = k.repeat_interleave(H // K, dim=2).transpose(1, 2)    # [B,H,L,dh]
    v = v.repeat_interleave(H // K, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    pos = torch.arange(L, device=q.device)
    for q0 in range(0, L, 512):
        q1 = min(q0 + 512, L)
        s = q[:, :, q0:q1] @ k[:, :, :q1].transpose(-1, -2) * dh ** -0.5
        mask = pos[None, :q1] > pos[q0:q1, None]
        s = s.masked_fill(mask, float("-inf"))
        out[:, :, q0:q1] = torch.softmax(s, dim=-1) @ v[:, :, :q1]
    return out.transpose(1, 2)


def head_logits(x_last: torch.Tensor, final_scale, head, eps,
                p: Precision) -> torch.Tensor:
    """Final norm and head at the positions given: [B, P, d] -> [B, P, V]."""
    return p.mm(rms_norm(x_last, final_scale, eps), head)
