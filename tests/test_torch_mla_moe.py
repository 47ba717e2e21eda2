"""The port's DeepSeek decoder (MLA + MoE) against the JAX reference on the
CPU.

``deepseek-v3-671b-smoke`` (4 layers: 3 dense-MLP prefix layers and 1 MoE
layer, d 128, 4 heads, MLA ranks 64 / 32, heads 32 + 16 / 32, 4 experts
top-2) and ``deepseek-v2-236b-smoke`` (1 + 1 layers) go through both
packages with the reference's own initialised parameters, carried across
by ``convert.lm_params_from_numpy``; the module tests feed both packages
the same numpy-seeded inputs and parameters (scaled by 1 / sqrt(fan_in),
as the init draws them).  On CPU tensors the prefill attention runs the
flash kernel's plain version.  Every MoE call's expert ids are read from
both packages (the reference's through ``jax.debug.callback``, so it runs
under ``jit``) and compared before any float.

Tolerances, as in ``test_torch_models.py``: f32 1e-5 (the same arithmetic
summed in another order); bf16 3e-2 absolute and relative (bf16 rounds at
other points in the two frameworks).  Expert ids, capacity drops and f32
greedy tokens are held exactly.  In a whole bf16 model the hidden states
differ by ulps between the frameworks, which can flip a route (measured: 0
to 2 of 96 token copies); there the port's MoE calls take the reference's
route of the same call, so the floats compare like with like, and at most
5 % of the port's own routes may differ.  A whole bf16 model's logits are
held to rtol 3e-2 and atol 1e-1 (``BF16_MODEL``): each of the 4 layers
rounds its residual output one bf16 ulp differently (measured, with the
reference's input to each layer), and the residual grows to magnitude 6,
where an ulp is 0.031; the logits were measured 0.0625 apart at most.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mla as jmla
from repro.models import moe as jmoe

from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe

V3, V2 = "deepseek-v3-671b", "deepseek-v2-236b"
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}
BF16_MODEL = dict(rtol=3e-2, atol=1e-1)     # whole-model bf16 logits
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, what="", tol=None):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **(tol or TOL[dtype]))


def _logits_close(got, want, dtype, what=""):
    _close(got, want, dtype, what, BF16_MODEL if dtype == "bf16" else None)


def _rand(shape, dtype, seed, scale=1.0):
    x = (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _cfgs(name, dtype, **extra):
    """(reference cfg, port cfg)."""
    jcfg = jget_config(name).replace(dtype=JDT[dtype], **extra)
    tcfg = get_config(name).replace(dtype=TDT[dtype], **extra)
    return jcfg, tcfg


def _spec_params(specs_j, seed):
    """Numpy-seeded parameters for a reference spec dict, each normal /
    sqrt(fan_in) (norm scales 0.1 normal): (jax, numpy)."""
    rng = np.random.default_rng(seed)
    out_j, out_n = {}, {}
    for k in sorted(specs_j):
        sp = specs_j[k]
        scale = 0.1 if k.endswith("scale") else sp.shape[-2] ** -0.5
        a = (scale * rng.normal(size=sp.shape)).astype(np.float32)
        out_j[k] = jnp.asarray(a, sp.dtype)
        out_n[k] = a
    return out_j, out_n


def _to_port(np_params, specs_t):
    return {k: torch.from_numpy(v).to(specs_t[k].dtype)
            for k, v in np_params.items()}


class _RouteSpy:
    """Records the expert ids of every ``_route`` call of both packages (the
    reference's at run time, under ``jit`` too).  With ``force``, the
    port's n-th call returns the reference's n-th route (weights, ids,
    probabilities): the reference must have made that call first."""

    def __init__(self, monkeypatch, force=False):
        self.routes, self.t = [], []
        jroute, troute = jmoe._route, tmoe._route

        def jspy(*a, **kw):
            out = jroute(*a, **kw)
            jax.debug.callback(
                lambda *r: self.routes.append([np.array(x) for x in r]),
                *out, ordered=True)
            return out

        def tspy(*a, **kw):
            out = troute(*a, **kw)
            self.t.append(out[1].numpy().copy())
            if not force:
                return out
            jax.effects_barrier()
            w, idx, probs = self.routes[len(self.t) - 1]
            return (torch.from_numpy(w), torch.from_numpy(idx).long(),
                    torch.from_numpy(probs))

        monkeypatch.setattr(jmoe, "_route", jspy)
        monkeypatch.setattr(tmoe, "_route", tspy)

    @property
    def j(self):
        jax.effects_barrier()
        return [r[1] for r in self.routes]

    def check(self, what=""):
        j = self.j
        assert len(j) == len(self.t) > 0, what
        for i, (a, b) in enumerate(zip(j, self.t)):
            np.testing.assert_array_equal(b, a, err_msg=f"{what} call {i}")

    def flipped(self) -> float:
        """The share of the port's token copies routed elsewhere."""
        j = self.j
        assert len(j) == len(self.t) > 0
        return float(np.mean(np.concatenate(
            [(a != b).ravel() for a, b in zip(j, self.t)])))


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", [V3, V2, V3 + "-smoke", V2 + "-smoke"])
def test_configs_match_the_reference(name):
    j, t = jget_config(name), get_config(name)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_head", "d_ff", "vocab_size", "rope_theta", "tie_embeddings",
              "norm_eps", "act", "sliding_window", "mixers", "mlps",
              "n_dense_prefix", "d_ff_dense_prefix", "n_periods", "period",
              "moe_groups", "moe_weight_shard", "act_shard", "remat"):
        assert getattr(t, f) == getattr(j, f), (name, f)
    assert dataclasses.asdict(t.mla) == dataclasses.asdict(j.mla)
    jm, tm = dataclasses.asdict(j.moe), dataclasses.asdict(t.moe)
    assert jm.pop("router_dtype") == jnp.float32
    assert tm.pop("router_dtype") == torch.float32
    assert tm == jm
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


# --------------------------------------------------------------------- moe
MOE_CASES = {
    "default": {},
    "tied_router": dict(tie=True),
    "capacity_pressure": dict(capacity_factor=0.3),
    "groups_2": dict(n_groups=2),
    "groups_2_T_odd": dict(n_groups=2, S=7),
    "no_shared": dict(n_shared=0),
    "shared_2": dict(n_shared=2),
}


def _moe_run(dtype, *, tie=False, capacity_factor=None, n_groups=1, S=12,
             n_shared=None):
    jcfg, tcfg = _cfgs(V3 + "-smoke", dtype)
    mo = {}
    if capacity_factor is not None:
        mo["capacity_factor"] = capacity_factor
    if n_shared is not None:
        mo["n_shared"] = n_shared
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **mo))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **mo))
    jp, npar = _spec_params(jmoe.moe_param_specs(jcfg), 5)
    if tie:      # experts 2, 3 copy 0, 1: every top-2 is a tie to break
        r = npar["router"]
        r[:, 2], r[:, 3] = r[:, 0], r[:, 1]
        jp["router"] = jnp.asarray(r)
    tp = _to_port(npar, tmoe.moe_param_specs(tcfg))
    jx, tx = _rand((3, S, 128), dtype, 6)
    jy, js = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jcfg,
                                                 n_groups=n_groups))(jp, jx)
    ty, ts = tmoe.moe_apply(tp, tx, tcfg, n_groups=n_groups)
    return (jy, js), (ty, ts)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_apply_matches(dtype, case, monkeypatch):
    spy = _RouteSpy(monkeypatch)
    (jy, js), (ty, ts) = _moe_run(dtype, **MOE_CASES[case])
    spy.check(case)
    if case == "tied_router":      # (a, a + 2) tie: a comes first
        ids = spy.t[0]
        assert set(ids[:, 0]) <= {0, 1} and (ids[:, 1] == ids[:, 0] + 2).all()
    assert ty.dtype == TDT[dtype] and ty.shape == jy.shape
    _close(ty, jy, dtype, "y")
    _close(ts.aux_loss, js.aux_loss, "f32", "aux_loss")
    assert ts.aux_loss.dtype == torch.float32
    assert float(ts.dropped_frac) == pytest.approx(float(js.dropped_frac),
                                                   abs=1e-7)
    if case == "capacity_pressure":
        assert float(ts.dropped_frac) > 0


def test_route_breaks_ties_to_the_lower_expert():
    cfg = get_config(V3 + "-smoke").replace(dtype=torch.float32)
    params = {"router": torch.zeros(128, 4)}
    w, idx, probs = tmoe._route(params, torch.randn(5, 128), cfg)
    assert idx.tolist() == [[0, 1]] * 5
    assert torch.equal(w, torch.full((5, 2), 0.5))
    jw, jidx, _ = jmoe._route({"router": jnp.zeros((128, 4))},
                              jnp.ones((5, 128)), jget_config(V3 + "-smoke"))
    np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())


def test_dropped_copies_read_zeros_and_leave_the_last_slot_alone():
    """With capacity 8 and 12 copies routed to expert 3 only, the last 4
    copies go to the padding row: their tokens get no expert output, and
    slot E*C - 1 holds the 8th copy, not a dropped one."""
    cfg = get_config(V3 + "-smoke").replace(dtype=torch.float32)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, top_k=1, n_shared=0))
    E, C, d = 4, 8, 128
    x = torch.randn(12, d)
    params = {k: torch.randn(s.shape) * 0.2
              for k, s in tmoe.moe_param_specs(cfg).items()}
    y, drop = tmoe._group_dispatch(x, torch.ones(12, 1),
                                   torch.full((12, 1), 3), params, cfg, C)
    assert float(drop) == pytest.approx(4 / 12)
    assert not y[8:].any() and y[:8].abs().sum(-1).gt(0).all()
    h = torch.nn.functional.silu(x[7] @ params["we_g"][3]) * (
        x[7] @ params["we_u"][3])
    torch.testing.assert_close(y[7], h @ params["we_d"][3])


# --------------------------------------------------------------------- mla
def _jmla(jcfg):
    """The reference's ``mla_mixer`` under ``jit``: (params, x, positions,
    cache or None) -> (y, cache)."""
    return jax.jit(lambda p, x, pos, c: jmla.mla_mixer(p, x, jcfg,
                                                       positions=pos,
                                                       cache=c))


def _mla_params(jcfg, tcfg, seed):
    jp, npar = _spec_params(jmla.mla_param_specs(jcfg), seed)
    return jp, _to_port(npar, tmla.mla_param_specs(tcfg))


@pytest.mark.parametrize("q_lora", [64, 0], ids=["q_lora", "wq"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_mixer_prefill_and_prefill_fill(dtype, q_lora):
    jcfg, tcfg = _cfgs(V3 + "-smoke", dtype)
    jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, q_lora_rank=q_lora))
    tcfg = tcfg.replace(mla=dataclasses.replace(tcfg.mla, q_lora_rank=q_lora))
    jp, tp = _mla_params(jcfg, tcfg, 7)
    assert ("wq" in tp) == (q_lora == 0)
    B, S, T = 2, 37, 44
    jx, tx = _rand((B, S, 128), dtype, 8)
    jpos, tpos = jnp.arange(S)[None], torch.arange(S)[None]
    jmix = _jmla(jcfg)
    jy, _ = jmix(jp, jx, jpos, None)
    ty, tc = tmla.mla_mixer(tp, tx, tcfg, positions=tpos)
    assert tc is None and ty.dtype == TDT[dtype]
    _close(ty, jy, dtype, "prefill y")

    cache = tmla.init_mla_cache(tcfg, B, T, device="cpu")
    cache.c_kv.fill_(7.0)                 # prefill-fill zeroes the tail
    jy, jc = jmix(jp, jx, jpos, jmla.init_mla_cache(jcfg, B, T))
    ty, tc = tmla.mla_mixer(tp, tx, tcfg, positions=tpos, cache=cache)
    _close(ty, jy, dtype, "prefill-fill y")
    assert int(tc.length) == int(jc.length) == S
    assert tc.c_kv.shape == (B, T, 32) and tc.k_rope.shape == (B, T, 16)
    assert not tc.c_kv[:, S:].any()
    assert tc.c_kv.data_ptr() == cache.c_kv.data_ptr()   # written in place
    _close(tc.c_kv, jc.c_kv, dtype, "c_kv")
    _close(tc.k_rope, jc.k_rope, dtype, "k_rope")


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_mixer_decode_steps(dtype, absorb):
    """Prefill-fill 20 tokens into a 22-slot cache, then 3 decode steps:
    the third writes slot T-1 again (``min(length, T-1)``)."""
    jcfg, tcfg = _cfgs(V3 + "-smoke", dtype)
    jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, absorb=absorb))
    tcfg = tcfg.replace(mla=dataclasses.replace(tcfg.mla, absorb=absorb))
    jp, tp = _mla_params(jcfg, tcfg, 9)
    B, S, T = 2, 20, 22
    jx, tx = _rand((B, S, 128), dtype, 10)
    jmix = _jmla(jcfg)
    _, jc = jmix(jp, jx, jnp.arange(S)[None], jmla.init_mla_cache(jcfg, B, T))
    _, tc = tmla.mla_mixer(tp, tx, tcfg, positions=torch.arange(S)[None],
                           cache=tmla.init_mla_cache(tcfg, B, T,
                                                     device="cpu"))
    for i in range(3):
        jx1, tx1 = _rand((B, 1, 128), dtype, 11 + i)
        jy, jc = jmix(jp, jx1, jnp.full((1, 1), S + i), jc)
        ty, tc = tmla.mla_mixer(tp, tx1, tcfg, cache=tc,
                                positions=torch.full((1, 1), S + i))
        assert ty.shape == (B, 1, 128) and ty.dtype == TDT[dtype]
        _close(ty, jy, dtype, f"decode step {i} y")
        assert int(tc.length) == int(jc.length) == S + i + 1
        _close(tc.c_kv, jc.c_kv, dtype, f"decode step {i} c_kv")
        _close(tc.k_rope, jc.k_rope, dtype, f"decode step {i} k_rope")


def test_mla_modes_agree_in_f32():
    """Absorbing W_UK / W_UV only reassociates the products: in f32 the
    two decode modes give the same output within the f32 tolerance."""
    tcfg = get_config(V3 + "-smoke").replace(dtype=torch.float32)
    jcfg = jget_config(V3 + "-smoke").replace(dtype=jnp.float32)
    _, tp = _mla_params(jcfg, tcfg, 12)
    _, tx = _rand((1, 9, 128), "f32", 13)
    out = []
    for absorb in (False, True):
        cfg = tcfg.replace(mla=dataclasses.replace(tcfg.mla, absorb=absorb))
        _, c = tmla.mla_mixer(tp, tx[:, :8], cfg,
                              positions=torch.arange(8)[None],
                              cache=tmla.init_mla_cache(cfg, 1, 9,
                                                        device="cpu"))
        y, _ = tmla.mla_mixer(tp, tx[:, 8:], cfg, cache=c,
                              positions=torch.full((1, 1), 8))
        out.append(y)
    _close(out[1], out[0], "f32")


# --------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,S", [(True, 150), (False, 133)],
                         ids=["causal", "ragged"])
@pytest.mark.parametrize("dqk,dv", [(192, 128), (48, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_takes_v_of_its_own_width(dtype, dqk, dv, causal, S):
    """At MLA's head widths against the reference's ``blocked_attention``:
    the scale is dqk^-0.5 and the output has v's width; non-causal at a
    ragged S, the padded keys past S are masked in both."""
    jq, tq = _rand((2, S, 4, dqk), dtype, 14)
    jk, tk = _rand((2, S, 4, dqk), dtype, 15)
    jv, tv = _rand((2, S, 4, dv), dtype, 16)
    got = ops.flash_attention_bshd(tq, tk, tv, causal=causal)
    want = jattn.blocked_attention(jq, jk, jv, causal=causal, q_chunk=64,
                                   k_chunk=64)
    assert got.shape == (2, S, 4, dv) and got.dtype == TDT[dtype]
    _close(got, want, dtype)
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                       return_lse=True)
    assert torch.equal(o, got) and lse.shape == (2, 4, S)


def test_flash_attention_autograd_refuses_another_v_width():
    """v of another width is no longer refused under grad: at (48, 32)
    ``ops.flash_attention_bshd`` runs its backward, dq and dk at q's width
    and dv at v's, and the gradient kernel is built for MLA's (192, 128)."""
    q = torch.randn(1, 16, 2, 48, requires_grad=True)
    k = torch.randn(1, 16, 2, 48, requires_grad=True)
    v = torch.randn(1, 16, 2, 32, requires_grad=True)
    out = ops.flash_attention_bshd(q, k, v)
    assert out.shape == (1, 16, 2, 32)
    dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert (192, 128) in tfa.HEAD_PAIRS and (48, 32) not in tfa.HEAD_PAIRS


# ------------------------------------------------------------ whole models
_MODELS: dict = {}


def _models(name, dtype):
    """(jax cfg, jax params, port cfg, port LM on the CPU), made once per
    (config, dtype) for the file."""
    key = (name, dtype)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(name, dtype)
        params = jax.jit(japi.model_api(jcfg).init)(jax.random.key(0))
        model = convert.lm_params_from_numpy(
            tcfg, jax.tree.map(np.asarray, params), device="cpu")
        _MODELS[key] = (jcfg, params, tcfg, model)
    return _MODELS[key]


def _check_routes(spy, dtype, what):
    if dtype == "f32":
        spy.check(what)
    else:
        assert spy.flipped() <= 0.05, what


@pytest.mark.parametrize("name", [V3, V2])
def test_lm_params_round_trip_and_keep_the_f32_router(name):
    _, params, tcfg, model = _models(name + "-smoke", "bf16")
    router = model["layers"][-1]["mlp"]["router"]
    assert router.dtype == torch.float32
    assert model["layers"][0]["mixer"]["wkv_down"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        router.numpy(), np.asarray(params["body"][0]["mlp"]["router"][0]))
    back = convert.lm_params_to_numpy(model)
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path],
                                      np.asarray(leaf, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    again = convert.lm_params_from_numpy(tcfg, back, device="cpu")
    for (n, a), b in zip(model.named_parameters(), again.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    init = tapi.model_api(tcfg).init(device="cpu")
    assert init["layers"][-1]["mlp"]["router"].dtype == torch.float32
    assert sum(p.numel() for p in init.parameters()) == sum(
        p.numel() for p in model.parameters())


@pytest.mark.parametrize("name", [V3, V2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_loss_match(name, dtype, monkeypatch):
    jcfg, params, tcfg, model = _models(name + "-smoke", dtype)
    toks = np.random.default_rng(17).integers(0, 512, (2, 40)).astype(
        np.int32)
    spy = _RouteSpy(monkeypatch, force=dtype == "bf16")
    want, jaux = jax.jit(lambda p, t: jlm.forward_logits(p, t, jcfg))(
        params, jnp.asarray(toks))
    got = tlm.forward_logits(model, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, 40, 512) and got.dtype == TDT[dtype]
    _logits_close(got, want, dtype, "logits")
    jl, jm = jax.jit(lambda p, b: jlm.lm_loss(p, b, jcfg))(
        params, {"tokens": jnp.asarray(toks)})
    tl, tm = tlm.lm_loss(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    _check_routes(spy, dtype, "forward, loss")
    assert len(spy.t) == 2 and float(tm["aux"]) > 0
    for got_, want_, what in ((tl, jl, "loss"), (tm["ce"], jm["ce"], "ce"),
                              (tm["aux"], jm["aux"], "aux"),
                              (tm["aux"], jaux, "aux = forward's")):
        _close(got_, want_, dtype, what)


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
@pytest.mark.parametrize("name", [V3, V2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_then_four_decode_steps_match(name, dtype, absorb,
                                              monkeypatch):
    """Prefill a [2, 24] prompt, then 4 greedy decode steps, in both
    packages; both decode the reference's greedy token, and in f32 the
    port's own greedy tokens equal it."""
    jcfg, params, tcfg, model = _models(name + "-smoke", dtype)
    jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, absorb=absorb))
    tcfg = tcfg.replace(mla=dataclasses.replace(tcfg.mla, absorb=absorb))
    ja, ta = japi.model_api(jcfg), tapi.model_api(tcfg)
    B, S, steps = 2, 24, 4
    toks = np.random.default_rng(18).integers(0, 512, (B, S)).astype(
        np.int32)
    spy = _RouteSpy(monkeypatch, force=dtype == "bf16")
    jl, jc = jax.jit(ja.prefill)(params, {"tokens": jnp.asarray(toks)},
                                 ja.init_cache(B, S + steps))
    tl, tc = ta.prefill(model, {"tokens": torch.from_numpy(toks)},
                        ta.init_cache(B, S + steps, device="cpu"))
    logits, tokens = [(tl, jl)], ([], [])
    jdec = jax.jit(ja.decode)
    for i in range(steps):
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
        tokens[0].append(tlm.greedy_token(tl).ravel().tolist())
        tokens[1].append(np.asarray(jt).ravel().tolist())
        jl, jc = jdec(params, jt, jc, S + i)
        tl, tc = ta.decode(model, torch.from_numpy(np.array(jt)), tc, S + i)
        logits.append((tl, jl))
    _check_routes(spy, dtype, "serve")
    assert len(spy.t) == 5            # one MoE layer: prefill + 4 steps
    if dtype == "f32":
        assert tokens[0] == tokens[1]
    for i, (tl, jl) in enumerate(logits):
        assert tl.shape == (2, 512) and tl.dtype == TDT[dtype]
        assert torch.isfinite(tl).all()
        _logits_close(tl, jl, dtype, f"logits after step {i}")
    assert all(isinstance(c, tmla.MLACache) and int(c.length) == S + steps
               for c in tc)
