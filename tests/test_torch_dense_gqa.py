"""The port's dense grouped-query-attention configs against the JAX reference
on the CPU: gemma2-27b (sliding-window and global layers in turn, softcaps),
h2o-danube-3-4b (every layer sliding-window, d_head 120), yi-9b and
minitron-4b, with the ring and int8 KV caches.

The configs and their smoke shrinks field by field.  ``attention_mixer``'s
prefill-fill and 6 decode steps through both packages on the same
numpy-seeded inputs and parameters, with a prompt below, at and past the
smoke window of 32 (the ring's roll shift 0 and 13), on a sliding-window
and a global layer, with a bf16 and an int8 cache, in f32 and bf16.  The
cache plumbing is held exactly: the port's ``_fill`` / ``_write_slot`` fed
the reference's own k and v give the reference's cache bit for bit (k, v,
int8 values, scales, ring slots, lengths).  The mixers end to end compute
their own k and v, whose f32 products sum in another order (measured: 2
f32 ulps apart, 4.8e-7), so there the f32 caches are held to 1e-6
(rtol = atol) with the int8 values and lengths exact, and the outputs to
1e-5.  ``flash_attention_plain`` at d_head 120 against the Pallas kernel in
interpret mode and against ``blocked_attention``.  The four smoke models
through prefill and 4 greedy steps past the window: in f32 the tokens are
equal and the logits within 1e-5; gemma2 in bf16 at
``test_torch_models.py``'s tolerances (3e-2; the reference's tokens fed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.kernels import flash_attention as jfa
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import common as jcm

from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm

DENSE = ("gemma2-27b", "h2o-danube-3-4b", "yi-9b", "minitron-4b")
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}
CACHE_F32 = dict(rtol=1e-6, atol=1e-6)      # f32 k, v: 2 ulps measured
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _cfgs(name, dtype, **extra):
    """(reference cfg, port cfg)."""
    return (jget_config(name).replace(dtype=JDT[dtype], **extra),
            get_config(name).replace(dtype=TDT[dtype], **extra))


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", [n + s for n in DENSE for s in ("", "-smoke")])
def test_configs_match_the_reference(name):
    j, t = jget_config(name), get_config(name)
    common = sorted({f.name for f in dataclasses.fields(t)}
                    & {f.name for f in dataclasses.fields(j)} - {"dtype"})
    assert len(common) == len(dataclasses.fields(t)) - 1
    for f in common + ["n_periods", "period"]:
        assert getattr(t, f) == getattr(j, f), (name, f)
    assert t.layer_kinds() == [j.block_kinds(i % j.period)
                               for i in range(j.n_layers)]
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


# ------------------------------------------------------- quantize, ring
def test_quantize_rounds_half_to_even_like_the_reference():
    """A row whose largest magnitude is 127 has scale 1, so x / s lands on
    the halves: both round half to even; a zero row keeps scale 1e-8."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0],
                   np.float32)
    x = np.stack([row, np.zeros_like(row), row * 0.37])[None, :, None]
    jq, js = jattn._quantize_kv(jnp.asarray(x))
    tq, ts = tattn._quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, 126, -127]
    back = tattn._dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jattn._dequantize_kv(jq, js, jnp.float32)))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window,max_len", [(True, 40), (True, 20),
                                            (False, 40)])
def test_init_kv_cache_matches_the_reference(int8, window, max_len):
    jcfg, tcfg = _cfgs("gemma2-27b-smoke", "bf16",
                       kv_cache_dtype="int8" if int8 else "bf16")
    j = jattn.init_kv_cache(jcfg, 2, max_len, window=window)
    t = tattn.init_kv_cache(tcfg, 2, max_len, device="cpu", window=window)
    for f in tattn.KVCache._fields:
        a, b = getattr(t, f), getattr(j, f)
        if b is None:
            assert a is None, f
            continue
        assert tuple(a.shape) == b.shape and not a.any(), f
        assert str(a.dtype).split(".")[-1] == str(b.dtype), f
    assert t.k.shape[1] == (min(max_len, 32) if window else max_len)


# ----------------------------------------------------------------- mixer
def _mixer_params(jcfg, tcfg, seed):
    """The mixer's parameters, each normal / sqrt(fan_in): (jax, port)."""
    rng = np.random.default_rng(seed)
    jspecs, tspecs = (jattn.attn_param_specs(jcfg),
                      tattn.attn_param_specs(tcfg))
    jp, tp = {}, {}
    for k in sorted(jspecs):
        sp = jspecs[k]
        a = (rng.normal(size=sp.shape) * sp.shape[-2] ** -0.5).astype(
            np.float32)
        jp[k], tp[k] = (jnp.asarray(a, sp.dtype),
                        torch.from_numpy(a).to(tspecs[k].dtype))
    return jp, tp


def _ref_kv(jp, x, jcfg, positions):
    """k and v as the reference's mixer forms them (the same eager jnp
    operations on the same arrays, so the same bits)."""
    B, S, _ = x.shape
    K, dh = jcfg.n_kv_heads, jcfg.d_head
    k = (x @ jp["wk"]).reshape(B, S, K, dh)
    v = (x @ jp["wv"]).reshape(B, S, K, dh)
    if jcfg.qk_norm:
        k = jcm.rms_norm(k, jp["k_scale"], jcfg.norm_eps)
    return jcm.apply_rope(k, positions, jcfg.rope_theta), v


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(dtype) if dtype is not None else t


def _same_cache(got, want, what):
    """Bit for bit: k, v (int8 or the model dtype), scales, length."""
    assert int(got.length) == int(want.length), what
    for f in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, (what, f)
            continue
        np.testing.assert_array_equal(a.float().numpy(), _np(b),
                                      err_msg=f"{what} {f}")


def _close_cache(got, want, dtype, what):
    """End to end: int8 values and lengths exact (f32), scales 1e-6
    relative, k / v at CACHE_F32 (f32) or TOL["bf16"]; a bf16 model's int8
    cache compared dequantized."""
    assert int(got.length) == int(want.length), what
    if want.k_scale is None:
        tol = CACHE_F32 if dtype == "f32" else TOL["bf16"]
        _close(got.k, want.k, tol, f"{what} k")
        _close(got.v, want.v, tol, f"{what} v")
        return
    for f in ("k", "v"):
        gq, gs = getattr(got, f), getattr(got, f + "_scale")
        wq, ws = getattr(want, f), getattr(want, f + "_scale")
        if dtype == "f32":
            np.testing.assert_array_equal(gq.numpy(), np.asarray(wq),
                                          err_msg=f"{what} {f} int8")
            _close(gs, ws, dict(rtol=1e-6, atol=0), f"{what} {f} scale")
        else:
            _close(gq.float() * gs, _np(wq) * _np(ws), TOL["bf16"],
                   f"{what} {f} dequantized")


# (mixer kind, prompt S): below the window (the ring wraps while decoding),
# at it (roll shift 0), past it (shift 13), and a global layer past it
MIXER_CASES = [(jcm.MIXER_SWA, 28), (jcm.MIXER_SWA, 32), (jcm.MIXER_SWA, 45),
               (jcm.MIXER_GLOBAL, 45)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_cache",
                                                     "int8_cache"])
@pytest.mark.parametrize("kind,S", MIXER_CASES,
                         ids=[f"{k}-S{s}" for k, s in MIXER_CASES])
def test_attention_mixer_fill_and_six_decode_steps(kind, S, int8, dtype):
    """gemma2's smoke mixer (softcap 50, window 32): prefill-fill of a
    [2, S] prompt into a cache of S + 6 positions, then 6 decode steps, in
    both packages.  After every call the outputs and caches agree end to
    end, and the port's cache writes fed the reference's k, v reproduce
    the reference's cache exactly."""
    jcfg, tcfg = _cfgs("gemma2-27b-smoke", dtype,
                       kv_cache_dtype="int8" if int8 else "bf16")
    jp, tp = _mixer_params(jcfg, tcfg, 3)
    B, steps, D = 2, 6, jcfg.d_model
    T = S + steps
    window = jcfg.sliding_window if kind == jcm.MIXER_SWA else 0
    ring = bool(window) and T >= window
    rng = np.random.default_rng(S)
    jc = jattn.init_kv_cache(jcfg, B, T, window=bool(window))
    tc = tattn.init_kv_cache(tcfg, B, T, device="cpu", window=bool(window))
    shadow = tattn.init_kv_cache(tcfg, B, T, device="cpu",
                                 window=bool(window))
    assert tc.k.shape[1] == (window if ring else T)
    for i in range(1 + steps):
        n = S if i == 0 else 1
        pos0 = 0 if i == 0 else S + i - 1
        x = rng.normal(size=(B, n, D)).astype(np.float32)
        pos = np.arange(pos0, pos0 + n)[None]
        jx, jpos = jnp.asarray(x, JDT[dtype]), jnp.asarray(pos)
        jy, jc = jattn.attention_mixer(jp, jx, jcfg, kind=kind,
                                       positions=jpos, cache=jc)
        ty, tc = tattn.attention_mixer(tp, _t(x, TDT[dtype]), tcfg,
                                       kind=kind,
                                       positions=torch.from_numpy(pos),
                                       cache=tc)
        what = f"{'fill' if i == 0 else f'decode {i}'}"
        assert ty.shape == (B, n, D) and ty.dtype == TDT[dtype]
        _close(ty, jy, TOL[dtype], f"{what} output")
        _close_cache(tc, jc, dtype, what)
        k, v = _ref_kv(jp, jx, jcfg, jpos)
        k, v = _t(k, TDT[dtype]), _t(v, TDT[dtype])
        shadow = (tattn._fill(shadow, k, v, window) if i == 0 else
                  tattn._write_slot(shadow, k, v, ring))
        _same_cache(shadow, jc, f"{what}: the port's writes of the "
                    "reference's k, v")
    assert int(tc.length) == S + steps


def test_decode_attention_ring_reads_every_filled_slot():
    """``ring=True`` drops the window mask: with cache_len past T every
    slot counts, as the reference's ring decode has it."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 1, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(1, 8, 2, 32)).astype(np.float32)
            for _ in range(2))
    for cache_len, ring in ((5, True), (11, True), (11, False), (5, False)):
        want = jattn.decode_attention(
            *(jnp.asarray(a) for a in (q, k, v)), cache_len=cache_len,
            window=8, softcap_val=50.0, ring=ring)
        got = tattn.decode_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), cache_len=cache_len,
            window=8, softcap_val=50.0, ring=ring)
        _close(got, want, TOL["f32"], f"cache_len {cache_len} ring {ring}")


# ------------------------------------------------------------ flash at 120
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_at_d_head_120(dtype):
    """H = 2, S = 200, window 64, softcap 50, causal, in the reference's
    [H, S, dh] layout: the plain version against the Pallas kernel in
    interpret mode and against ``blocked_attention`` (f32 2e-5, bf16 2e-2,
    the reference's own tolerances)."""
    H, S, dh = 2, 200, 120
    rng = np.random.default_rng(120)
    q, k, v = (rng.normal(size=(H, S, dh)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=True, window=64, softcap=50.0)
    got = ops.flash_attention(*(_t(a, TDT[dtype]) for a in (q, k, v)), **kw)
    assert got.shape == (H, S, dh) and got.dtype == TDT[dtype]
    jargs = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    tol = {"f32": 2e-5, "bf16": 2e-2}[dtype]
    pallas = jfa.flash_attention_pallas(*jargs, interpret=True, **kw)
    _close(got, pallas, dict(rtol=tol, atol=tol), "Pallas")
    blocked = jattn.blocked_attention(
        *(a.transpose(1, 0, 2)[None] for a in jargs), causal=True,
        window=64, softcap_val=50.0)
    _close(got, blocked[0].transpose(1, 0, 2), dict(rtol=tol, atol=tol),
           "blocked_attention")


def test_flash_gradient_takes_120_and_refuses_96():
    """Named for the widths it held before phi-3's head was ported: both
    kernels now take (120, 120) and (96, 96), whose wrappers get past the
    head widths to the device check, with the true width in the tensor
    map; at (80, 80) the gradient's wrapper raises the head-width error and
    launches nothing."""
    assert (120, 120) in tfa.HEAD_PAIRS and (96, 96) in tfa.HEAD_PAIRS
    assert (80, 80) not in tfa.HEAD_PAIRS
    t = torch.zeros(2, 129, 8, 120, dtype=torch.bfloat16)
    assert tfa.tma_layout(t) == ((120, 129, 8, 2), (240 * 8, 240, 240 * 129
                                                    * 8), (64, 128, 1, 1))
    lse = torch.zeros(2, 8, 129)
    n0 = ops.launch_counts()["flash_attention_bwd"]
    for width in (120, 96):
        t = torch.zeros(2, 129, 8, width, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tfa.flash_attention_cuda(t, t, t)
        with pytest.raises(ValueError, match="flash_attention_bwd_cuda needs "
                           "CUDA tensors"):
            tfa.flash_attention_bwd_cuda(t, t, t, t, t, lse)
    t = torch.zeros(2, 129, 8, 96, dtype=torch.bfloat16)
    assert tfa.tma_layout(t) == ((96, 129, 8, 2), (192 * 8, 192, 192 * 129
                                                   * 8), (64, 128, 1, 1))
    n = torch.zeros(2, 129, 8, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"head widths \(q/k 80, v 80\)"):
        tfa.flash_attention_bwd_cuda(n, n, n, n, n, lse)
    assert ops.launch_counts()["flash_attention_bwd"] == n0


# ----------------------------------------------------------- whole models
_MODELS: dict = {}


def _models(name, dtype):
    """(jax cfg, jax params, port cfg, port LM on the CPU), made once per
    (config, dtype) for the file."""
    key = (name, dtype)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(name + "-smoke", dtype)
        params = jax.jit(japi.model_api(jcfg).init)(jax.random.key(0))
        model = convert.lm_params_from_numpy(
            tcfg, jax.tree.map(np.asarray, params), device="cpu")
        _MODELS[key] = (jcfg, params, tcfg, model)
    return _MODELS[key]


SERVE_CASES = [(n, "f32", "bf16") for n in DENSE] + [
    ("gemma2-27b", "bf16", "bf16"), ("h2o-danube-3-4b", "f32", "int8")]


@pytest.mark.parametrize("name,dtype,cache", SERVE_CASES,
                         ids=[f"{n}-{d}-{c}" for n, d, c in SERVE_CASES])
def test_prefill_then_four_greedy_steps_past_the_window(name, dtype, cache):
    """Prefill a [2, 45] prompt (past the 32-token window: the ring's roll
    shift is 13), then 4 greedy steps, in both packages; both decode the
    reference's greedy token, and in f32 the port's own tokens equal it."""
    jcfg, params, tcfg, model = _models(name, dtype)
    jcfg = jcfg.replace(kv_cache_dtype=cache)
    tcfg = tcfg.replace(kv_cache_dtype=cache)
    ja, ta = japi.model_api(jcfg), tapi.model_api(tcfg)
    B, S, steps = 2, 45, 4
    toks = np.random.default_rng(22).integers(0, 512, (B, S)).astype(
        np.int32)
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
    if dtype == "f32":
        assert tokens[0] == tokens[1]
    for i, (tl, jl) in enumerate(logits):
        assert tl.shape == (B, 512) and torch.isfinite(tl).all()
        _close(tl, jl, TOL[dtype], f"logits after step {i}")
    kinds = tcfg.layer_kinds()
    for layer, (mk, _) in enumerate(kinds):
        c = tc[layer]
        assert int(c.length) == S + steps
        ring = mk == tcm.MIXER_SWA
        assert c.k.shape[1] == (tcfg.sliding_window if ring else S + steps)
        assert (c.k.dtype == torch.int8) == (cache == "int8")
    slot = jc["body"][0]
    assert np.asarray(slot.length)[0] == S + steps
