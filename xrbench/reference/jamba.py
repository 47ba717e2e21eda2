"""Plain PyTorch reference of the served jamba decoder, and its weight layout.

A straightforward forward pass in float32 over whole sequences: no cache,
no chunking, no kernel.  It follows the published Jamba block (arXiv
2403.19887: Mamba-1 and grouped-query attention layers 7 : 1, an MoE of
top-2 experts on every other layer, RMSNorm before each half) with the
port's stated departures, which it computes as the program does:
  * the token embedding is scaled by sqrt(d_model), rounded to bf16;
  * Mamba has no RMSNorm on dt, B and C, and attention takes rotary
    embeddings (``rope_theta``);
  * RMSNorm multiplies by (1 + scale);
  * the MoE is capacity-bounded per call: a call's tokens route to their
    top-2 experts (ties to the lower expert), and of the copies an expert
    receives, in token order, only the first
    max(8, ceil8(ceil(T * top_k * capacity_factor / n_experts))) count;
    the rest add nothing.  The served path makes one call of the whole
    prompt batch and one a decode step, so ``served_logits`` routes the
    prompt positions of all rows as one call and each later position as
    another.
The Mamba recurrence runs step by step: h_t = exp(dt_t A) h_{t-1} +
dt_t u_t B_t, y_t = C_t h_t + D u_t.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from xrbench.reference import common as rc
from xrbench.weights import Leaf, draw_group, out_gain


def dims(conf: dict) -> dict:
    d = conf["hidden_size"]
    return dict(
        d=d, L=conf["num_hidden_layers"], H=conf["num_attention_heads"],
        K=conf["num_key_value_heads"], dh=d // conf["num_attention_heads"],
        f=conf["intermediate_size"], V=conf["vocab_size"],
        E=conf["num_experts"], k=conf["num_experts_per_tok"],
        di=conf["mamba_expand"] * d,
        R=conf["mamba_dt_rank"] or math.ceil(d / 16),
        N=conf["mamba_d_state"], conv=conf["mamba_d_conv"],
        eps=conf["rms_norm_eps"], cf=conf["capacity_factor"],
        theta=conf["rope_theta"])


def layer_kinds(conf: dict) -> list:
    """(mixer, mlp) of each layer: "attention" at offset mod period, else
    "mamba"; "moe" at the expert offset mod its period, else "dense"."""
    out = []
    for i in range(conf["num_hidden_layers"]):
        mixer = ("attention" if i % conf["attn_layer_period"]
                 == conf["attn_layer_offset"] else "mamba")
        mlp = ("moe" if i % conf["expert_layer_period"]
               == conf["expert_layer_offset"] else "dense")
        out.append((mixer, mlp))
    return out


def layout(conf: dict) -> dict:
    """The weights' tree: names and shapes of the program's parameters."""
    m = dims(conf)
    d, di, N, R = m["d"], m["di"], m["N"], m["R"]
    top = {"embed": Leaf((m["V"], d), fan_in=d),
           "final_scale": Leaf((d,), init="zeros")}
    if not conf["tie_word_embeddings"]:
        top["lm_head"] = Leaf((d, m["V"]))
    out = out_gain(m["L"])
    layers = []
    for mixer, mlp in layer_kinds(conf):
        if mixer == "mamba":
            mx = {"in_proj": Leaf((d, 2 * di)),
                  "conv_w": Leaf((di, m["conv"]), fan_in=m["conv"]),
                  "conv_bias": Leaf((di,), init="zeros"),
                  "x_proj": Leaf((di, R + 2 * N)),
                  "dt_proj": Leaf((R, di)),
                  "dt_bias": Leaf((di,), "f32", init="dt_bias"),
                  "A_log": Leaf((di, N), "f32", init="A_log"),
                  "D": Leaf((di,), "f32", init="ones"),
                  "out_proj": Leaf((di, d), gain=out)}
        else:
            H, K, dh = m["H"], m["K"], m["dh"]
            mx = {"wq": Leaf((d, H * dh)), "wk": Leaf((d, K * dh)),
                  "wv": Leaf((d, K * dh)),
                  "wo": Leaf((H * dh, d), gain=out)}
        if mlp == "moe":
            E, f = m["E"], m["f"]
            ff = {"router": Leaf((d, E), "f32"),
                  "we_g": Leaf((E, d, f)), "we_u": Leaf((E, d, f)),
                  "we_d": Leaf((E, f, d), gain=out)}
        else:
            ff = {"wg": Leaf((d, m["f"])), "wu": Leaf((d, m["f"])),
                  "wd": Leaf((m["f"], d), gain=out)}
        layers.append({"ln1_scale": Leaf((d,), init="zeros"), "mixer": mx,
                       "ln2_scale": Leaf((d,), init="zeros"), "mlp": ff})
    return {"top": top, "layers": layers}


def embed_scale(d: int) -> float:
    return float(torch.tensor(d ** 0.5, dtype=torch.bfloat16))


def mamba(x, W, m, p: rc.Precision):
    B, L, _ = x.shape
    di, N, R, Kc = m["di"], m["N"], m["R"], m["conv"]
    xin, z = p.mm(x, W["in_proj"]).split(di, dim=-1)
    xp = F.pad(xin, (0, 0, Kc - 1, 0))
    cw = W["conv_w"].float()
    xc = sum(xp[:, i:i + L] * cw[:, i] for i in range(Kc))
    xc = F.silu(xc + W["conv_bias"].float())
    dbc = p.mm(xc, W["x_proj"])
    dt = F.softplus(p.mm(dbc[..., :R], W["dt_proj"]) + W["dt_bias"])
    Bm, Cm = dbc[..., R:R + N], dbc[..., R + N:]
    A = -torch.exp(W["A_log"])
    decay = torch.exp(dt[..., None] * A)                   # [B, L, di, N]
    h = (dt * xc)[..., None] * Bm[:, :, None, :]           # drive, then h
    for t in range(1, L):
        h[:, t].addcmul_(decay[:, t], h[:, t - 1])
    del decay
    y = torch.einsum("bldn,bln->bld", h, Cm) + xc * W["D"]
    return p.mm(y * F.silu(z), W["out_proj"])


def attention(x, W, m, p: rc.Precision):
    B, L, _ = x.shape
    H, K, dh = m["H"], m["K"], m["dh"]
    q = rc.rope(p.mm(x, W["wq"]).view(B, L, H, dh), m["theta"])
    k = rc.rope(p.mm(x, W["wk"]).view(B, L, K, dh), m["theta"])
    v = p.mm(x, W["wv"]).view(B, L, K, dh)
    o = rc.causal_gqa_attention(q, k, v)
    return p.mm(o.reshape(B, L, H * dh), W["wo"])


def capacity(tokens: int, m) -> int:
    c = math.ceil(tokens * m["k"] * m["cf"] / m["E"])
    return max(8, -(-c // 8) * 8)


def moe(x, W, m, p: rc.Precision, calls, experts):
    """``calls``: (start, end) position ranges, each routed as one call
    over all rows.  ``experts``: the expert weights as read, [E, ...]."""
    B, L, d = x.shape
    E, k = m["E"], m["k"]
    wg, wu, wd = experts
    router = W["router"].float()
    y = torch.zeros_like(x)
    for a, b in calls:
        xs = x[:, a:b].reshape(-1, d)
        probs = torch.softmax(xs @ router, dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[:, :k], idx[:, :k]
        w = w / w.sum(-1, keepdim=True)
        C = capacity(xs.shape[0], m)
        flat = idx.reshape(-1)
        out = torch.zeros_like(xs)
        for e in range(E):
            copies = torch.nonzero(flat == e)[:C, 0]
            if copies.numel() == 0:
                continue
            tok, slot = copies // k, copies % k
            he = rc.glu_mlp(xs[tok], wg[e], wu[e], wd[e], p)
            out.index_add_(0, tok, he * w[tok, slot][:, None])
        y[:, a:b] = out.view(B, b - a, d)
    return y


def _read_experts(W, p: rc.Precision):
    return tuple(p.weight(W[n]) for n in ("we_g", "we_u", "we_d"))


def served_logits(conf: dict, seed: int, seqs: list, prompt_len: int,
                  device, kinds=("f32",)) -> dict:
    """Reference logits at the served positions.  ``seqs``: token tensors
    [B, Lt] (each a batch: its prompts, then the tokens served but the
    last); the served positions are prompt_len - 1 .. Lt - 1.  Returns
    {kind: [f32 logits [B, Lt - prompt_len + 1, V] a batch]}, for each
    precision kind ("f32" is the reference, "fp8" the control)."""
    rc.no_tf32()
    m = dims(conf)
    lay = layout(conf)
    top = draw_group(lay["top"], seed, -1, device)
    scale = embed_scale(m["d"])
    precs = {kd: rc.Precision(kd) for kd in kinds}
    xs = {kd: [precs[kd].act(top["embed"][s.to(device).long()].float())
               * scale for s in seqs] for kd in kinds}
    calls = [[(0, prompt_len)] + [(t, t + 1) for t in
                                  range(prompt_len, s.shape[1])]
             for s in seqs]
    for i, (mixer, mlp) in enumerate(layer_kinds(conf)):
        W = draw_group(lay["layers"][i], seed, i, device)
        for kd, p in precs.items():
            experts = _read_experts(W["mlp"], p) if mlp == "moe" else None
            for j, x in enumerate(xs[kd]):
                h = rc.rms_norm(x, W["ln1_scale"], m["eps"])
                x = x + (mamba(h, W["mixer"], m, p) if mixer == "mamba"
                         else attention(h, W["mixer"], m, p))
                h = rc.rms_norm(x, W["ln2_scale"], m["eps"])
                if mlp == "moe":
                    x = x + moe(h, W["mlp"], m, _ExpertsRead(p), calls[j],
                                experts)
                else:
                    x = x + rc.glu_mlp(h, W["mlp"]["wg"], W["mlp"]["wu"],
                                       W["mlp"]["wd"], p)
                xs[kd][j] = x
            del experts
        del W
    head = top["lm_head"] if "lm_head" in top else top["embed"].T
    return {kd: [rc.head_logits(x[:, prompt_len - 1:], top["final_scale"],
                                head, m["eps"], precs[kd])
                 for x in xs[kd]] for kd in kinds}


class _ExpertsRead(rc.Precision):
    """``p`` with expert weights already read (``weight`` passes them)."""

    def __init__(self, p: rc.Precision):
        super().__init__(p.kind)

    def weight(self, w):
        return w
