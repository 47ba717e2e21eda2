"""Plain PyTorch reference of the served RWKV-6 ("Finch") decoder, and its
weight layout.

A straightforward forward pass in float32 over whole sequences: no cache,
no chunking.  It follows the published Finch block (arXiv 2404.05892:
data-dependent token shift through a low-rank mix, data-dependent decay,
the wkv recurrence with a bonus for the current token, then the squared
ReLU channel mix), with the port's stated departures, which it computes as
the program does:
  * the token embedding is scaled by sqrt(d_model), rounded to bf16;
  * RMSNorm (times 1 + scale) stands where the published block has
    LayerNorm, before each half;
  * the wkv output is normalised per head by its RMS (eps 1e-5) where the
    published block has a GroupNorm, then times (1 + ln_x_scale) and the
    gate.
The recurrence runs step by step, per head:
  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t,
with w_t = exp(-exp(decay_t)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from xrbench.reference import common as rc
from xrbench.weights import Leaf, draw_group, out_gain

SLOTS = 5      # token-shift mixes: r, k, v, w, g


def dims(conf: dict) -> dict:
    d = conf["hidden_size"]
    return dict(d=d, L=conf["num_hidden_layers"], dh=conf["head_size"],
                h=d // conf["head_size"], f=conf["intermediate_size"],
                V=conf["vocab_size"], mix=conf["time_mix_extra_dim"],
                dec=conf["time_decay_extra_dim"],
                eps=conf["layer_norm_epsilon"])


def layer_kinds(conf: dict) -> list:
    return [("rwkv6", "channel_mix")] * conf["num_hidden_layers"]


def layout(conf: dict) -> dict:
    m = dims(conf)
    d, f = m["d"], m["f"]
    top = {"embed": Leaf((m["V"], d), fan_in=d),
           "final_scale": Leaf((d,), init="zeros")}
    if not conf["tie_word_embeddings"]:
        top["lm_head"] = Leaf((d, m["V"]))
    out = out_gain(m["L"])
    layers = []
    for _ in range(m["L"]):
        tm = {"mix_base/mix_mu": Leaf((d,), "f32", "uniform", lo=0.3, hi=0.7),
              "mix/mix_mu": Leaf((SLOTS, d), "f32", "uniform", lo=0.3,
                                 hi=0.7),
              "mix_w1": Leaf((d, SLOTS * m["mix"])),
              "mix_w2": Leaf((SLOTS, m["mix"], d)),
              "wr": Leaf((d, d)), "wk": Leaf((d, d)), "wv": Leaf((d, d)),
              "wg": Leaf((d, d)),
              "decay_base": Leaf((d,), "f32", init="decay_base"),
              "decay_w1": Leaf((d, m["dec"])),
              "decay_w2": Leaf((m["dec"], d)),
              "bonus_u": Leaf((m["h"], m["dh"]), "f32", "uniform"),
              "ln_x_scale": Leaf((d,), init="zeros"),
              "wo": Leaf((d, d), gain=out)}
        cmx = {"cmix_k/mix_mu": Leaf((d,), "f32", "uniform", lo=0.3, hi=0.7),
               "cmix_r/mix_mu": Leaf((d,), "f32", "uniform", lo=0.3, hi=0.7),
               "wk": Leaf((d, f)), "wv": Leaf((f, d), gain=out),
               "wr": Leaf((d, d))}
        layers.append({"ln1_scale": Leaf((d,), init="zeros"), "mixer": tm,
                       "ln2_scale": Leaf((d,), init="zeros"), "mlp": cmx})
    return {"top": top, "layers": layers}


def _shift(x):
    """x_{t-1}, zeros before the first token."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix(x, W, m, p: rc.Precision):
    B, L, d = x.shape
    h, dh = m["h"], m["dh"]
    xx = _shift(x) - x
    base = x + xx * W["mix_base/mix_mu"]
    lora = torch.tanh(p.mm(base, W["mix_w1"])).view(B, L, SLOTS, -1)
    offs = torch.einsum("blsi,sid->blsd", p.act(lora), p.weight(W["mix_w2"]))
    xm = x[:, :, None] + xx[:, :, None] * (W["mix/mix_mu"] + offs)
    xr, xk, xv, xw, xg = xm.unbind(dim=2)
    del xm, offs
    r = p.mm(xr, W["wr"]).view(B, L, h, dh)
    k = p.mm(xk, W["wk"]).view(B, L, h, dh)
    v = p.mm(xv, W["wv"]).view(B, L, h, dh)
    g = F.silu(p.mm(xg, W["wg"]))
    dec = W["decay_base"] + p.mm(torch.tanh(p.mm(xw, W["decay_w1"])),
                                 W["decay_w2"])
    w = torch.exp(-torch.exp(dec)).view(B, L, h, dh)
    y = (r * W["bonus_u"] * k).sum(-1, keepdim=True) * v     # the bonus
    S = torch.zeros(B * h, dh, dh, dtype=torch.float32, device=x.device)
    rs, ks, vs, ws = (t.transpose(1, 2).reshape(B * h, L, dh)
                      for t in (r, k, v, w))
    ys = torch.empty(B * h, L, dh, dtype=torch.float32, device=x.device)
    for t in range(L):
        torch.bmm(rs[:, t:t + 1], S, out=ys[:, t:t + 1])
        S.mul_(ws[:, t, :, None]).baddbmm_(ks[:, t, :, None],
                                           vs[:, t:t + 1])
    y = y + ys.view(B, h, L, dh).transpose(1, 2)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-5)
    y = y.reshape(B, L, d) * (1.0 + W["ln_x_scale"].float()) * g
    return p.mm(y, W["wo"])


def channel_mix(x, W, m, p: rc.Precision):
    xx = _shift(x) - x
    xk = x + xx * W["cmix_k/mix_mu"]
    xr = x + xx * W["cmix_r/mix_mu"]
    k = F.relu(p.mm(xk, W["wk"])).square()
    return torch.sigmoid(p.mm(xr, W["wr"])) * p.mm(k, W["wv"])


def served_logits(conf: dict, seed: int, seqs: list, prompt_len: int,
                  device, kinds=("f32",)) -> dict:
    """As ``reference.jamba.served_logits``: {kind: [f32 logits [B, Lt -
    prompt_len + 1, V] a batch]} at the served positions.  Sequences of
    one length run as one batch: nothing couples the rows."""
    rc.no_tf32()
    m = dims(conf)
    lay = layout(conf)
    top = draw_group(lay["top"], seed, -1, device)
    scale = float(torch.tensor(m["d"] ** 0.5, dtype=torch.bfloat16))
    sizes = [s.shape[0] for s in seqs]
    tokens = torch.cat([s.to(device).long() for s in seqs])
    precs = {kd: rc.Precision(kd) for kd in kinds}
    xs = {kd: precs[kd].act(top["embed"][tokens].float()) * scale
          for kd in kinds}
    for i in range(m["L"]):
        W = draw_group(lay["layers"][i], seed, i, device)
        for kd, p in precs.items():
            x = xs[kd]
            x = x + time_mix(rc.rms_norm(x, W["ln1_scale"], m["eps"]),
                             W["mixer"], m, p)
            x = x + channel_mix(rc.rms_norm(x, W["ln2_scale"], m["eps"]),
                                W["mlp"], m, p)
            xs[kd] = x
        del W
    head = top["lm_head"] if "lm_head" in top else top["embed"].T
    out = {}
    for kd in kinds:
        logits = rc.head_logits(xs[kd][:, prompt_len - 1:],
                                top["final_scale"], head, m["eps"],
                                precs[kd])
        out[kd] = list(logits.split(sizes))
    return out
