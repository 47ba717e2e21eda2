"""Training the port's recurrent families (jamba's Mamba + attention + MoE,
RWKV-6) against the JAX reference on the CPU.

The reference trains ``jamba-v0.1-52b`` and ``rwkv6-3b`` with
``jax.value_and_grad`` of ``repro.models.lm.lm_loss``: both scans are jnp
(Mamba's ``associative_scan`` inside a ``lax.scan`` over chunks, RWKV's
chunked linear attention), so the port runs autograd through its own chunk
loops, with the flash gradient's plain version at jamba's attention layer
on CPU tensors (the trainers' checkpoints, each resumed by the other
package's trainer, are ``test_torch_recurrent_ckpt.py``'s).  Whole models start from the reference's own smoke
parameters (``convert.lm_params_from_numpy``; the bf16 tree is the f32 one
cast leaf by leaf to its spec's dtype).  jamba runs at 32 tokens, a
multiple of its smoke chunk of 16 (the reference's Mamba raises at a
ragged length past its chunk), rwkv at 40.

Tolerances, each with its reason (those of ``test_torch_mla_moe_train.py``
unless said):
  * whole-model gradients in f32 rtol 1e-4 / atol 2e-6 (``GRAD_TOL``: the
    same arithmetic in another order through an autodiff of another
    framework); losses 1e-5;
  * a module's gradients rtol 1e-4 and an absolute error of 1e-6 of each
    array's largest entry (``MODULE_TOL``);
  * bf16 losses and gradients 3e-2 (``LOSS_TOL``: bf16 rounds at other
    points in the two frameworks), jamba's MoE calls taking the
    reference's expert ids (a bf16 ulp can flip a route);
  * AdamW 1e-6 relative / 1e-8 absolute (``OPT_TOL``: the same f32
    operations one by one);
Expert ids are held exactly at every MoE call in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import api as japi
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw

from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw as tadamw

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
SEQ = {JAMBA: 32, RWKV: 40}
MOE_LAYERS = {JAMBA: 4, RWKV: 0}          # jamba-smoke: MoE on odd slots
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOSS_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
            "bf16": dict(rtol=3e-2, atol=3e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
MODULE_TOL = dict(rtol=1e-4, atol_of_max=1e-6)
OPT_TOL = dict(rtol=1e-6, atol=1e-8)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what="", tol=GRAD_TOL):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _of_max(tol, want):
    """``tol`` with its absolute part a share of ``want``'s largest entry."""
    return dict(rtol=tol["rtol"],
                atol=tol["atol_of_max"] * float(np.abs(_np(want)).max()))


class _Routes:
    """Reads the expert ids of every MoE call of both packages (the
    reference's through ``jax.debug.callback``, under ``jit`` and
    ``value_and_grad``).  With ``feed``, the port's n-th call routes to the
    reference's n-th ids, its weights the port's own probabilities at those
    ids, renormalised: the reference must have made that call first."""

    def __init__(self, monkeypatch, feed=False):
        self.ref, self.port = [], []
        jroute, troute = jmoe._route, tmoe._route

        def jspy(*a, **kw):
            out = jroute(*a, **kw)
            jax.debug.callback(lambda i: self.ref.append(np.array(i)),
                               out[1], ordered=True)
            return out

        def tspy(params, x2d, cfg):
            w, idx, probs = troute(params, x2d, cfg)
            self.port.append(idx.numpy().copy())
            if feed:
                jax.effects_barrier()
                idx = torch.from_numpy(self.ref[len(self.port) - 1]).long()
                w = probs.gather(1, idx)
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            return w, idx, probs

        monkeypatch.setattr(jmoe, "_route", jspy)
        monkeypatch.setattr(tmoe, "_route", tspy)

    def check(self, what, calls):
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) == calls, what
        for i, (a, b) in enumerate(zip(self.ref, self.port)):
            np.testing.assert_array_equal(b, a, err_msg=f"{what} call {i}")


# ------------------------------------------------------------ whole models
_REF: dict = {}


def _ref(name, dtype, remat=False):
    """(reference cfg, its smoke parameters in ``dtype``, jitted
    value_and_grad of lm_loss, port cfg); the f32 tree is the reference's
    seeded init, made once per config for the file, and the bf16 tree
    that tree cast leaf by leaf to its spec's dtype."""
    key = (name, dtype, remat)
    if key not in _REF:
        jcfg = jget_config(name).replace(dtype=JDT[dtype], remat=remat)
        tcfg = get_config(name).replace(dtype=TDT[dtype], remat=remat)
        api = japi.model_api(jcfg)
        if (name, "f32") not in _REF:
            f32 = jget_config(name).replace(dtype=jnp.float32)
            _REF[name, "f32"] = jax.jit(japi.model_api(f32).init)(
                jax.random.key(0))
        params = jax.tree.map(lambda a, sp: a.astype(sp.dtype),
                              _REF[name, "f32"], jlm.lm_param_specs(jcfg))
        vg = jax.jit(jax.value_and_grad(
            lambda p, t: api.loss(p, {"tokens": t}), has_aux=True))
        _REF[key] = (jcfg, params, vg, tcfg)
    return _REF[key]


def _port_lm(cfg, params):
    lm = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device="cpu")
    return lm.requires_grad_(True)


def _port_loss_and_grads(cfg, lm, toks):
    loss, metrics, grads = tsteps.loss_and_grads(
        tapi.model_api(cfg).loss, lm, {"tokens": torch.from_numpy(toks)})
    return loss, metrics, dict(tcm.leaves(grads))


def _ref_grads(cfg, jg) -> dict:
    """The reference's gradient tree in the port's layout, by path."""
    return dict(tcm.leaves(convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jg), device="cpu").tree()))


def _tokens(name, seed, b=2):
    return np.random.default_rng(seed).integers(0, 512, (b, SEQ[name])) \
        .astype(np.int32)


@pytest.mark.parametrize("name", [JAMBA, RWKV])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_loss_and_every_gradient_match_value_and_grad(name, dtype,
                                                         monkeypatch):
    """The smoke model's loss (ce + 0.01 aux) and the gradient of every
    leaf (Mamba's ``A_log`` / ``D`` / ``dt_bias``, RWKV's decays, bonus
    and slash-named mixing leaves among them) against
    ``jax.value_and_grad`` of the reference's ``lm_loss``: f32 (the
    reference under ``remat=True``, its configs' default; the port without
    it) with the same expert ids at every MoE call, bf16 with the
    reference's ids fed to the port.  Every gradient is finite: RWKV's -inf
    mask before the exponent carries a zero gradient, not a NaN."""
    jcfg, params, vg, cfg = _ref(name + "-smoke", dtype,
                                 remat=dtype == "f32")
    cfg = cfg.replace(remat=False)
    toks = _tokens(name, 31)
    spy = _Routes(monkeypatch, feed=dtype == "bf16")
    (jl, jm), jg = vg(params, jnp.asarray(toks))
    lm = _port_lm(cfg, params)
    tl, tm, got = _port_loss_and_grads(cfg, lm, toks)
    n = MOE_LAYERS[name]
    jax.effects_barrier()
    # the reference under remat routes each MoE layer again in its backward
    assert len(spy.port) == n and len(spy.ref) == n * (1 + jcfg.remat)
    if dtype == "f32":
        for i, (a, b) in enumerate(zip(spy.ref, spy.port)):
            np.testing.assert_array_equal(b, a, err_msg=f"{name} call {i}")
    tol = LOSS_TOL[dtype]
    for g, w, what in ((tl, jl, "loss"), (tm["ce"], jm["ce"], "ce"),
                       (tm["aux"], jm["aux"], "aux")):
        _close(g, w, what, tol)
    assert (float(tm["aux"]) > 0) == (name == JAMBA)
    want = _ref_grads(cfg, jg)
    assert sorted(got) == sorted(want)
    own = {JAMBA: ("A_log", "D", "dt_bias", "conv_w", "mlp/router"),
           RWKV: ("decay_base", "bonus_u", "mix_base/mix_mu",
                  "cmix_k/mix_mu")}[name]
    assert all(any(p.endswith(s) for p in got) for s in own)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert bool(torch.isfinite(got[path]).all()), path
        _close(got[path], want[path], path,
               GRAD_TOL if dtype == "f32" else tol)


@pytest.mark.parametrize("name", [JAMBA, RWKV])
def test_remat_gives_the_same_gradients_and_the_references(name):
    """``cfg.remat`` recomputes each period in the backward pass (jamba's
    8 layers, rwkv's one) and, inside it, each Mamba scan chunk: the same
    loss and gradient bits as without it, f32; so it too is within
    ``GRAD_TOL`` of the reference's ``remat=True`` gradients."""
    jcfg, params, vg, cfg = _ref(name + "-smoke", "f32", remat=True)
    assert cfg.remat and jcfg.remat
    toks = _tokens(name, 32)
    lm = _port_lm(cfg, params)
    plain = _port_loss_and_grads(cfg.replace(remat=False), lm, toks)
    remat = _port_loss_and_grads(cfg, lm, toks)
    assert torch.equal(plain[0], remat[0])
    assert sorted(plain[2]) == sorted(remat[2])
    for path, g in plain[2].items():
        assert torch.equal(g, remat[2][path]), path
    (jl, _), jg = vg(params, jnp.asarray(toks))
    _close(remat[0], jl, "loss", LOSS_TOL["f32"])
    want = _ref_grads(cfg, jg)
    for path, g in remat[2].items():
        _close(g, want[path], path, GRAD_TOL)


def _saved_bytes(fn) -> int:
    """The bytes of the distinct storages autograd saves while ``fn``
    runs, counted by ``saved_tensors_hooks``."""
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return sum(seen.values()), out


def test_chunk_recompute_saves_under_a_quarter_of_the_scan():
    """The Mamba scan at jamba's d_state 16 and chunk 32 (d_inner 64, 256
    steps): without recompute its chunks save about 11 f32
    ``[d_inner, d_state]`` arrays a token for the backward, with each chunk
    under ``checkpoint`` about 0.2 (the carried states and the inputs),
    under a quarter; the gradients have the same bits either way."""
    g = torch.Generator().manual_seed(0)
    B, S, d, N, Cn = 1, 256, 64, 16, 32
    u, dt = (torch.randn(B, S, d, generator=g), 0.1 * torch.rand(
        B, S, d, generator=g))
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    A = -torch.arange(1.0, N + 1).expand(d, N).clone()
    h0 = torch.randn(B, d, N, generator=g)
    array = d * N * 4
    runs = []
    for recompute in (False, True):
        leaves = [t.clone().requires_grad_() for t in (u, Bm, Cm, dt, A)]
        x, Bl, Cl, dtl, Al = leaves
        nbytes, (h, y) = _saved_bytes(lambda: tmamba._scan(
            h0, x, Bl, Cl, dtl, Al, Cn, recompute=recompute))
        grads = torch.autograd.grad(y.square().sum() + h.sum(), leaves)
        runs.append((nbytes / (B * S) / array, h, y, grads))
    (plain, h1, y1, g1), (chunked, h2, y2, g2) = runs
    assert plain > 8 and chunked < plain / 4, (plain, chunked)
    assert torch.equal(h1, h2) and torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def _moe_cfgs(n_experts):
    jcfg = jget_config(JAMBA + "-smoke").replace(dtype=jnp.float32)
    tcfg = get_config(JAMBA + "-smoke").replace(dtype=torch.float32)
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                 n_experts=n_experts)),
            tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                 n_experts=n_experts)))


@pytest.mark.parametrize("n_experts", [2, 4])
def test_jamba_moe_gradients_match_jax_grad(n_experts, monkeypatch):
    """jamba's top-2 MoE (no shared expert) under grad, f32: d(sum(y * r) +
    aux) for x, the router and the experts against ``jax.grad`` with the
    same expert ids; at 2 experts (the full-width training cut's) every
    token reaches both and no copy drops, at the smoke's 4 the router
    chooses."""
    jcfg, tcfg = _moe_cfgs(n_experts)
    specs = jmoe.moe_param_specs(jcfg)
    rng = np.random.default_rng(40 + n_experts)
    npar = {k: (rng.normal(size=specs[k].shape)
                / np.sqrt(specs[k].shape[-2])).astype(np.float32)
            for k in sorted(specs)}
    x, r = (rng.normal(size=(2, 24, 128)).astype(np.float32)
            for _ in range(2))
    spy = _Routes(monkeypatch)

    def jloss(p, x):
        y, st = jmoe.moe_apply(p, x, jcfg)
        return jnp.sum(y * r) + st.aux_loss, st.dropped_frac

    (jl, jdrop), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(a) for k, a in npar.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in npar.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, st = tmoe.moe_apply(tp, tx, tcfg)
    tl = torch.sum(y * torch.from_numpy(r)) + st.aux_loss
    grads = torch.autograd.grad(tl, [tx, *tp.values()])
    spy.check(f"{n_experts} experts", 1)
    if n_experts == 2:
        # the reference's mean rounds to -3e-8 where none drop
        assert float(st.dropped_frac) == 0.0 and abs(float(jdrop)) < 1e-6
        assert (np.sort(spy.port[0], axis=1) == [0, 1]).all()
    _close(tl, jl, "loss", LOSS_TOL["f32"])
    _close(grads[0], jgx, "dx", _of_max(MODULE_TOL, jgx))
    for k, g in zip(tp, grads[1:]):
        _close(g, jgp[k], f"d{k}", _of_max(MODULE_TOL, jgp[k]))


# ------------------------------------------------------------------- adamw
@pytest.mark.parametrize("name", [JAMBA, RWKV])
def test_adamw_on_the_recurrent_tree_matches_the_reference(name):
    """Three AdamW steps on the bf16 smoke tree against
    ``repro.optim.adamw``: the decay mask by name (Mamba's ``A_log``, ``D``
    and ``dt_bias``, RWKV's ``decay_base``, ``bonus_u`` and the
    slash-named ``*/mix_mu`` leaves take none; the projections do); the
    f32 leaves' f32 parameter, master and moments; every master and moment
    and the parameters written back."""
    _, params, _, tcfg = _ref(name + "-smoke", "bf16")
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1,
                clip_norm=0.5)
    jo, to = jadamw.AdamWConfig(**ocfg), tadamw.AdamWConfig(**ocfg)
    lm = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                      device="cpu")
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            jadamw._decay_mask(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = dict(jax.tree_util.tree_flatten_with_path(convert.lm_params_to_tree(
        lm))[0])
    got = {"/".join(str(getattr(k, "key", k)) for k in path):
           tadamw._decay_mask("/".join(str(getattr(k, "key", k))
                                       for k in path))
           for path in got}
    assert got == want
    no_decay = {JAMBA: ("A_log", "D", "dt_bias", "ln1_scale"),
                RWKV: ("decay_base", "bonus_u", "mix_base/mix_mu",
                       "mix/mix_mu", "cmix_k/mix_mu", "cmix_r/mix_mu")}[name]
    decay = {JAMBA: ("in_proj", "router", "x_proj"),
             RWKV: ("wr", "decay_w1", "mix_w1")}[name]
    for s in no_decay + decay:
        hits = [v for k, v in want.items() if k.endswith("/" + s)]
        assert hits and all(v == (s in decay) for v in hits), s
    jp, jopt = params, jadamw.init_opt_state(params, jo)
    topt = tadamw.init_opt_state(lm, to)
    upd = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, jo))
    rng = np.random.default_rng(33)
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (
            0.3 + step)).astype(np.float32), jax.tree.map(np.asarray, jp))
        jp, jopt, jm = upd(jax.tree.map(jnp.asarray, grads), jopt, jp)
        tg = convert.lm_params_from_numpy(tcfg.replace(dtype=torch.float32),
                                          grads, device="cpu").tree()
        lm, topt, tm = tadamw.adamw_update(tg, topt, lm, to)
        for key in ("lr", "grad_norm"):
            _close(tm[key], jm[key], key, OPT_TOL)
    f32 = [p for p, t in tcm.leaves(lm.tree()) if t.dtype == torch.float32]
    assert f32 and all(dict(tcm.leaves(tree))[p].dtype == torch.float32
                       for tree in (topt.master, topt.m, topt.v) for p in f32)
    out = convert.opt_state_to_numpy(topt, tcfg)
    for field in ("master", "m", "v"):
        for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(
                getattr(out, field))[0],
                jax.tree.leaves(getattr(jopt, field))):
            _close(g, w, f"{field} {path}", OPT_TOL)
    back = convert.lm_params_to_tree(lm)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(jp)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        if g.dtype == torch.float32:         # its own master
            _close(g, w, str(path), OPT_TOL)
        else:         # bf16 of f32 masters that may straddle a rounding
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                       rtol=8e-3, atol=1e-6,
                                       err_msg=str(path))
