"""RWKV-6's sequence wkv (``kernels/wkv6.py``, ``kernels.ops.wkv6``) and the
time mix's choice of path, on the CPU.

``ops.wkv6`` on a CPU tensor is the chunk loop, ``wkv6_plain``; it is held
against the JAX reference's own ``_wkv_chunk`` driven the reference's way
(padded, ``lax.scan``) and against the recurrence itself, stepped in
float64, which is what the card's kernel computes in f32.  The kernel's
wrapper refuses what the kernel does not take before it looks for a card.
``rwkv_time_mix`` sends frozen inputs to ``ops.wkv6`` and inputs that need
a gradient to ``wkv6_plain`` (the kernel has no backward), and counts each
call in ``rwkv_wkv_calls_total`` under the path it took, which the
benchmark's ``wkv_kernel_share`` reads.

Tolerance: f32 1e-5, relative to the output's largest entry (the chunk
loop and the reference sum in another order; measured at most 2.3e-7 here).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import rwkv as jrwkv
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6
from repro_torch.models import api as tapi
from repro_torch.models import rwkv as trwkv
from repro_torch.obs import MetricsRegistry, set_registry
from xrbench import core

RWKV = "rwkv6-3b-smoke"
TOL = 1e-5


def _inputs(B, S, H, dh, seed, state_scale=1.0):
    """numpy-seeded r, k, v [B, S, H, dh], lw = -exp(dec) with dec spread
    as ``decay_base``'s init spreads it (decays from 0.998 to 0.7 a step),
    u [H, dh] and state0 [B, H, dh, dh]."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, dh)).astype(np.float32)
               for _ in range(3))
    dec = (-6.0 + 5.0 * np.linspace(0, 1, dh) ** 0.7
           + 0.3 * rng.normal(size=(B, S, H, dh)))
    lw = (-np.exp(dec)).astype(np.float32)
    u = rng.normal(size=(H, dh)).astype(np.float32)
    s0 = (state_scale * rng.normal(size=(B, H, dh, dh))).astype(np.float32)
    return r, k, v, lw, u, s0


def _reference_wkv(r, k, v, lw, u, s0, chunk):
    """The JAX package's wkv: its ``_wkv_chunk`` over padded chunks by
    ``lax.scan``, as its ``rwkv_time_mix`` runs it."""
    B, S, H, dh = r.shape
    Cn = min(chunk, S)
    pad = (-S) % Cn
    n = (S + pad) // Cn

    def split(a):
        a = jnp.pad(jnp.asarray(a), ((0, 0), (0, pad), (0, 0), (0, 0)))
        return jnp.moveaxis(a.reshape(B, n, Cn, H, dh), 1, 0)

    uj = jnp.asarray(u)
    last, ys = jax.lax.scan(lambda c, i: jrwkv._wkv_chunk(c, (*i, uj)),
                            jnp.asarray(s0), tuple(map(split, (r, k, v, lw))))
    y = jnp.moveaxis(ys, 0, 1).reshape(B, S + pad, H, dh)[:, :S]
    return np.asarray(y), np.asarray(last)


def _recurrent_f64(r, k, v, lw, u, s0):
    """The recurrence step by step in float64: y_t = r_t (S + diag(u)
    k_t^T v_t), then S <- diag(exp(lw_t)) S + k_t^T v_t."""
    r, k, v, lw, u, st = (a.astype(np.float64) for a in (r, k, v, lw, u, s0))
    y = np.empty_like(r)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]         # [B,H,i,j]
        y[:, t] = np.einsum("bhi,bhij->bhj", r[:, t],
                            st + u[None, :, :, None] * kv)
        st = np.exp(lw[:, t])[..., None] * st + kv
    return y, st


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("S, chunk, state_scale", [
    (29, 8, 1.0), (29, 8, 0.0), (16, 8, 1.0), (1, 8, 1.0), (5, 64, 1.0)])
def test_ops_wkv6_on_cpu_matches_the_reference(S, chunk, state_scale):
    """``ops.wkv6`` on CPU tensors: y and the end state against the
    reference's chunk scan and against the f64 recurrence; S = 29 in
    chunks of 8 has a ragged tail of 5 padded steps."""
    args = _inputs(2, S, 3, 32, seed=S + chunk, state_scale=state_scale)
    y, st = ops.wkv6(*map(torch.from_numpy, args), chunk)
    assert y.shape == (2, S, 3, 32) and st.shape == (2, 3, 32, 32)
    assert y.dtype == st.dtype == torch.float32
    want_y, want_st = _reference_wkv(*args, chunk)
    _close(y, want_y, "y against the reference")
    _close(st, want_st, "end state against the reference")
    rec_y, rec_st = _recurrent_f64(*args)
    _close(y, rec_y, "y against the f64 recurrence")
    _close(st, rec_st, "end state against the f64 recurrence")


def test_time_mix_ragged_cached_prefill_matches_the_reference():
    """The whole time mix at S = 29 in chunks of 8 from a nonzero cache,
    through ``ops.wkv6``, against the reference's ``rwkv_time_mix``."""
    tcfg = get_config(RWKV).replace(dtype=torch.float32)
    tcfg = tcfg.replace(rwkv=dataclasses.replace(tcfg.rwkv, chunk=8))
    jcfg = jget_config(RWKV).replace(dtype=jnp.float32)
    jcfg = jcfg.replace(rwkv=dataclasses.replace(jcfg.rwkv, chunk=8))
    rng = np.random.default_rng(3)
    specs = jrwkv.rwkv_tm_param_specs(jcfg)
    params = {}
    for name in sorted(specs):
        shape = specs[name].shape
        z = rng.normal(size=shape)
        a = (rng.uniform(0.3, 0.7, size=shape) if name.endswith("mix_mu")
             else -6.0 + 5.0 * np.linspace(0, 1, shape[-1]) ** 0.7 + 0.1 * z
             if name == "decay_base" else 0.1 * z if name.endswith("scale")
             else z / np.sqrt(shape[-2] if len(shape) >= 2 else shape[-1]))
        params[name] = a.astype(np.float32)
    d, (h, dh) = tcfg.d_model, trwkv._dims(tcfg)
    x = rng.normal(size=(2, 29, d)).astype(np.float32)
    cache = [rng.normal(size=s).astype(np.float32)
             for s in ((2, d), (2, d), (2, h, dh, dh))]
    jy, (js, jprev) = jrwkv.rwkv_time_mix(
        {n: jnp.asarray(a) for n, a in params.items()}, jnp.asarray(x), jcfg,
        cache=jrwkv.RWKVCache(*map(jnp.asarray, cache)))
    ty, (ts, tprev) = trwkv.rwkv_time_mix(
        {n: torch.from_numpy(a) for n, a in params.items()},
        torch.from_numpy(x), tcfg,
        cache=trwkv.RWKVCache(*map(torch.from_numpy, cache)))
    _close(ty, np.asarray(jy), "time mix")
    _close(ts, np.asarray(js), "state")
    np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))


def _cuda_args(**change):
    """Arguments ``wkv6_cuda`` takes but for the device (CPU here), with
    ``change`` applied: a name -> a replacement tensor."""
    B, S, H, dh = 2, 5, 3, 64
    args = dict(zip(("r", "k", "v", "lw", "u", "state0"),
                    map(torch.from_numpy, _inputs(B, S, H, dh, seed=1))))
    args.update(change)
    return args


@pytest.mark.parametrize("change, match", [
    ({}, "needs CUDA tensors"),
    ({"k": torch.zeros(2, 5, 3, 64, dtype=torch.bfloat16)}, "dtype"),
    ({"lw": torch.zeros(2, 3, 5, 64).transpose(1, 2)}, "not contiguous"),
    ({"state0": torch.zeros(2, 3, 64, 64).transpose(2, 3)},
     "not contiguous"),
    ({"u": torch.zeros(3, 32)}, "shape"),
    ({"r": torch.zeros(2, 5, 3, 32), "k": torch.zeros(2, 5, 3, 32),
      "v": torch.zeros(2, 5, 3, 32), "lw": torch.zeros(2, 5, 3, 32),
      "u": torch.zeros(3, 32), "state0": torch.zeros(2, 3, 32, 32)},
     "dh = 64"),
    ({"r": torch.zeros(2, 0, 3, 64)}, "S >= 1"),
    ({"v": torch.zeros(2 * 5 * 3 * 64 + 1)[1:].view(2, 5, 3, 64)},
     "16-byte aligned"),
])
def test_wkv6_cuda_refuses_what_the_kernel_does_not_take(change, match):
    n0 = wkv6.launches
    with pytest.raises(ValueError, match=match):
        wkv6.wkv6_cuda(**_cuda_args(**change))
    assert wkv6.launches == n0


def _model(n_layers=3):
    cfg = get_config(RWKV).replace(dtype=torch.float32, n_layers=n_layers)
    api = tapi.model_api(cfg)
    model = api.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    return cfg, api, model, tokens


class _Spy:
    """Counts calls to ``ops.wkv6`` and ``wkv6.wkv6_plain`` (each still
    runs); with ``launch``, ``ops.wkv6`` also counts a kernel launch, as
    on the card."""

    def __init__(self, monkeypatch, launch=False):
        self.ops, self.plain = 0, 0
        plain, wkv = wkv6.wkv6_plain, ops.wkv6

        def ops_spy(*a):
            self.ops += 1
            out = wkv(*a)
            if launch:
                wkv6.launches += 1
            return out

        def plain_spy(*a):
            self.plain += 1
            return plain(*a)

        monkeypatch.setattr(ops, "wkv6", ops_spy)
        monkeypatch.setattr(wkv6, "wkv6_plain", plain_spy)


@pytest.mark.parametrize("grad", [False, True])
def test_time_mix_takes_ops_when_frozen_and_the_loop_under_grad(
        grad, monkeypatch):
    """Frozen parameters (``LM``'s serving state): one ``ops.wkv6`` call a
    layer a prefill.  A parameter that requires grad: ``wkv6_plain`` is
    called directly, ``ops.wkv6`` never, and the loss differentiates."""
    cfg, api, model, tokens = _model()
    if grad:
        model.requires_grad_(True)
    spy = _Spy(monkeypatch)
    with torch.set_grad_enabled(grad):
        logits = api.forward(model, {"tokens": tokens})
    if grad:
        assert (spy.ops, spy.plain) == (0, cfg.n_layers)
        logits.float().square().mean().backward()
        u = [p for n, p in model.named_parameters() if "bonus_u" in n]
        assert u and all(p.grad is not None and p.grad.abs().sum() > 0
                         for p in u)
    else:
        assert (spy.ops, spy.plain) == (cfg.n_layers, cfg.n_layers)


@pytest.mark.parametrize("launch, path", [(False, "chunks"),
                                          (True, "kernel")])
def test_wkv_calls_counted_once_a_layer_under_their_path(
        launch, path, monkeypatch):
    """With a registry installed a prefill counts one
    ``rwkv_wkv_calls_total`` a layer, under "kernel" where the kernel
    launched and "chunks" where it did not; decode steps count none."""
    cfg, api, model, tokens = _model()
    _Spy(monkeypatch, launch=launch)
    reg = MetricsRegistry()
    prev = set_registry(reg)
    try:
        caches = api.init_cache(2, 24, device="cpu")
        logits, caches = api.prefill(model, {"tokens": tokens}, caches)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        api.decode(model, tok, caches, 20)
    finally:
        set_registry(prev)
    c = reg.snapshot()["counters"]["rwkv_wkv_calls_total"]
    assert c == {f'{{path="{path}"}}': cfg.n_layers}


def _share(counts):
    counters = {} if counts is None else {"rwkv_wkv_calls_total": counts}
    return core.reader("wkv_kernel_share")(
        {"profile": {"counters": {"counters": counters}}})


@pytest.mark.parametrize("counts, want", [
    ({'{path="kernel"}': 32}, 100.0),
    ({'{path="chunks"}': 32}, 0.0),
    ({'{path="kernel"}': 24, '{path="chunks"}': 8}, 75.0),
    (None, None),
])
def test_wkv_kernel_share_reads_the_counter(counts, want):
    assert _share(counts) == want
    assert core.reader("wkv_kernel_share")({"profile": None}) is None
