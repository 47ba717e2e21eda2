"""The port's recurrent families (Mamba with jamba, RWKV-6) against the JAX
reference on the CPU.

``jamba-v0.1-52b-smoke`` (8 layers: Mamba at every slot but 4, attention
at 4, MoE on odd slots; d 128, d_inner 256, d_state 8, chunk 16, 4
experts top-2) and ``rwkv6-3b-smoke`` (1 layer, d 128, 4 heads of 32,
chunk 16) go through both packages with the port's seeded parameters
(drawn by the reference's rules, held against them leaf by leaf here),
carried to the reference by ``convert.lm_params_to_numpy``; the module
tests feed both packages the same numpy-seeded inputs and parameters.

Tolerances: f32 1e-5 (the port's log-step scan inside a chunk and its
reductions round in another order than JAX's tree: measured about 4e-6 on
the smoke models); bf16 3e-2 absolute and relative for a module, and a
whole bf16 model's logits at ``BF16_MODEL`` (rtol 3e-2, atol 1e-1), with
jamba's MoE calls fed the reference's routes (a bf16 ulp can flip one), as
``tests/test_torch_mla_moe.py`` does.  Expert ids and f32 greedy tokens
are held exactly.

The reference's ``mamba_mixer`` raises at a length past its chunk that is
no multiple of it (it adds ``u * D`` with ``u`` padded); the model is
causal, so the port at the ragged length is held against the reference
at the next multiple, cut to the ragged length, and the raise is pinned.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import api as japi
from repro.models import blocks as jblk
from repro.models import common as jcm
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import get_config
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
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


def _close_time_mix(got, want, dtype, what=""):
    """The time mix's output: its per-head RMS norm divides each head's
    row by its own scale, so a row that is small before the norm (a
    sequence's first token, the bonus term alone) carries the rounding of
    the products before it up to the output's scale; the f32 limit is
    1e-5 of the output's largest entry (measured 1.4e-5 at an entry of 0.1
    beside a largest of 2.8)."""
    tol = None
    if dtype == "f32":
        tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(_np(want)).max()))
    _close(got, want, dtype, what, tol)


def _rand(shape, dtype, seed, scale=1.0):
    x = (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _cfgs(name, dtype):
    """(reference cfg, port cfg) of ``name`` in ``dtype``."""
    return (jget_config(name).replace(dtype=JDT[dtype]),
            get_config(name).replace(dtype=TDT[dtype]))


def _spec_params(specs_j, specs_t, seed):
    """Numpy-seeded parameters for a mixer's spec dict, each leaf in its
    spec's dtype: weights normal / sqrt(fan_in), norm scales 0.1 normal,
    and the recurrences' own leaves near their init rules (decays that
    neither vanish nor explode).  Returns (jax, port)."""
    rng = np.random.default_rng(seed)
    out_j, out_t = {}, {}
    for k in sorted(specs_j):
        shape = specs_j[k].shape
        z = rng.normal(size=shape)
        if k == "A_log":
            a = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * z
        elif k == "dt_bias":
            a = 0.5 * z - 2.0
        elif k.endswith("mix_mu"):
            a = rng.uniform(0.3, 0.7, size=shape)
        elif k == "decay_base":
            a = -6.0 + 5.0 * np.linspace(0, 1, shape[-1]) ** 0.7 + 0.1 * z
        elif k.endswith("scale") or k.endswith("bias"):
            a = 0.1 * z
        else:
            a = z / np.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        a = a.astype(np.float32)
        out_j[k] = jnp.asarray(a, specs_j[k].dtype)
        out_t[k] = torch.from_numpy(a).to(specs_t[k].dtype)
    return out_j, out_t


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", [JAMBA, RWKV, JAMBA + "-smoke",
                                  RWKV + "-smoke"])
def test_configs_match_the_reference(name):
    j, t = jget_config(name), get_config(name)
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_head", "d_ff", "vocab_size", "rope_theta", "tie_embeddings",
              "norm_eps", "act", "sliding_window", "mixers", "mlps",
              "n_dense_prefix", "n_periods", "period", "remat",
              "rwkv_tm_shard", "moe_groups"):
        assert getattr(t, f) == getattr(j, f), (name, f)
    for sub in ("mamba", "rwkv"):
        js, ts = getattr(j, sub), getattr(t, sub)
        assert (js is None) == (ts is None), (name, sub)
        if js is not None:
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    if j.moe is None:
        assert t.moe is None
    else:
        jm, tm = dataclasses.asdict(j.moe), dataclasses.asdict(t.moe)
        jm.pop("router_dtype"), tm.pop("router_dtype")
        assert tm == jm
    assert t.remat == (not name.endswith("-smoke"))
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


def _ulps(a, b) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


def _slot_leaves(cfg, jcfg, slot):
    """The reference's init of one body slot's block specs, stacked
    ``[n_periods, ...]`` as its ``init_lm_params`` draws them, as numpy
    leaves at the port's per-layer paths of that slot."""
    kinds = jcfg.block_kinds(slot)
    specs = jlm._stack_specs(jblk.block_param_specs(jcfg, *kinds),
                             jcfg.n_periods)
    tree = jax.jit(lambda k: jcm.init_from_specs(k, specs))(
        jax.random.key(slot))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(p.key) for p in path)
        for i in range(cfg.n_periods):
            out[f"layers/{i * cfg.period + slot}/{name}"] = np.asarray(
                leaf[i], np.float32)
    return out


@pytest.mark.parametrize("name", [JAMBA + "-smoke", JAMBA + "-2-periods",
                                  RWKV + "-smoke"])
def test_init_rules_match_the_reference(name):
    """``init_lm_params`` of the port against the reference's draw of the
    same block specs (slot 0, stacked as the reference's LM stacks them):
    the deterministic leaves (``decay_base`` within two ulps of the jitted
    draw, where XLA fuses the rule's f32 steps into its own power: 2
    measured; ``A_log`` log(1 .. d_state)
    formed in f64 and rounded once, within one ulp of XLA's f32 log, which
    rounds log 7 one ulp off; ``dt_bias``, ``conv_bias`` and
    ``ln_x_scale`` zeros); ``mix_mu`` uniform on [0.3, 0.7) in f32; ``D``
    and ``bonus_u`` truncated normal at the reference's fan-in: the second-
    to-last axis of the leaf as the reference draws it, stacked ``[n_periods,
    ...]``, so n_periods for ``D`` (1, and 2 on jamba cut to two periods)
    and h for ``bonus_u``."""
    base = JAMBA + "-smoke" if name == JAMBA + "-2-periods" else name
    jcfg, tcfg = jget_config(base), get_config(base)
    if base != name:
        jcfg, tcfg = (c.replace(n_layers=16) for c in (jcfg, tcfg))
    want = _slot_leaves(tcfg, jcfg, 0)
    tspecs = dict(tcm.leaves(tlm.lm_param_specs(tcfg)))
    got = {p: t for p, t in tcm.leaves(tlm.init_lm_params(
        tcfg, torch.Generator().manual_seed(0))) if p in want}
    assert set(got) == set(want) and len(want) > 10
    seen = set()
    for path, t in got.items():
        leaf, w = path.split("/")[-1], want[path]
        assert t.dtype == tspecs[path].dtype, path
        a = t.float().numpy()
        if leaf == "decay_base":
            assert _ulps(a, w) <= 2, path
        elif leaf == "A_log":
            np.testing.assert_array_equal(a, np.broadcast_to(np.log(
                np.arange(1, a.shape[-1] + 1)).astype(np.float32), a.shape))
            assert _ulps(a, w) <= 1, path
        elif leaf in ("dt_bias", "conv_bias", "ln_x_scale"):
            assert not a.any() and not w.any(), path
        elif leaf == "mix_mu":
            assert t.dtype == torch.float32
            assert a.min() >= 0.3 and a.max() < 0.7, path
            assert w.min() >= 0.3 and w.max() < 0.7, path
        elif leaf in ("D", "bonus_u"):
            fan_in = tcfg.n_periods if a.ndim == 1 else a.shape[-2]
            for x in (a, w):
                assert np.abs(x).max() <= 2 / np.sqrt(fan_in), path
                assert np.abs(x).max() > 1.5 / np.sqrt(fan_in), path
        else:
            continue
        seen.add(leaf)
    assert seen == ({"A_log", "dt_bias", "conv_bias", "D"} if "jamba" in name
                    else {"decay_base", "mix_mu", "ln_x_scale", "bonus_u"})


@pytest.mark.parametrize("d", [128, 1024, 2560])
def test_decay_base_bit_for_bit_at_published_widths(d):
    """The reference's rule run op by op (eager, each f32 step rounded) at
    the smoke width, a 1024-wide cut and rwkv6-3b's 2560 channels, stacked
    as the reference stacks a body leaf: bit for bit."""
    want = jcm._leaf_init(jax.random.key(0), "body/0/mixer/decay_base",
                          (2, d), jnp.float32)
    got = tcm._leaf_init(torch.Generator().manual_seed(0),
                         "layers/0/mixer/decay_base", (d,), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[1])


# ------------------------------------------------------------------- mamba
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_carries_its_inputs(dtype):
    """Two calls with the carried inputs equal one call over the whole
    sequence, in both packages, and the port equals the reference."""
    jx, tx = _rand((2, 11, 16), dtype, 1)
    jw, tw = _rand((16, 4), dtype, 2, 0.5)
    jb, tb = _rand((16,), dtype, 3, 0.1)
    jp, tp = _rand((2, 3, 16), dtype, 4)
    jy, jc = jmamba._causal_conv(jx, jw, jb, jp)
    ty, tc = tmamba._causal_conv(tx, tw, tb, tp)
    assert ty.dtype == TDT[dtype] and tc.dtype == TDT[dtype]
    _close(ty, jy, dtype, "y")
    np.testing.assert_array_equal(_np(tc), _np(jc))
    np.testing.assert_array_equal(_np(tc), _np(tx[:, -3:]))
    y1, c1 = tmamba._causal_conv(tx[:, :5], tw, tb, tp)
    y2, c2 = tmamba._causal_conv(tx[:, 5:], tw, tb, c1)
    assert torch.equal(torch.cat([y1, y2], 1), ty) and torch.equal(c2, tc)


def _mamba(dtype, seed=5):
    jcfg, tcfg = _cfgs(JAMBA + "-smoke", dtype)
    jp, tp = _spec_params(jmamba.mamba_param_specs(jcfg),
                          tmamba.mamba_param_specs(tcfg), seed)
    jmix = jax.jit(lambda p, x, c: jmamba.mamba_mixer(p, x, jcfg, cache=c))
    return jcfg, tcfg, jp, tp, jmix


def _mamba_cache(jc, dtype):
    return tmamba.MambaCache(_t(jc.conv, TDT[dtype]),
                             _t(jc.ssm, torch.float32))


@pytest.mark.parametrize("S", [8, 16, 48])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_mixer_prefill(dtype, S):
    """No cache: S within one chunk (8 < 16), one whole chunk, three."""
    jcfg, tcfg, jp, tp, jmix = _mamba(dtype)
    jx, tx = _rand((2, S, 128), dtype, 6)
    jy, _ = jmix(jp, jx, None)
    ty, tc = tmamba.mamba_mixer(tp, tx, tcfg)
    assert tc is None and ty.dtype == TDT[dtype] and ty.shape == jy.shape
    _close(ty, jy, dtype, f"y at S={S}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba_mixer_fill_then_four_decode_steps(dtype):
    """A prefill-fill of 32 tokens continues from a nonzero cache; then 4
    decode steps.  The port writes its cache in place: the conv inputs and
    the scan state equal the reference's after every call."""
    jcfg, tcfg, jp, tp, jmix = _mamba(dtype)
    jc = jmamba.MambaCache(
        conv=_rand((2, 3, 256), dtype, 7)[0],
        ssm=jnp.asarray(np.random.default_rng(8).normal(
            size=(2, 256, 8)).astype(np.float32)))
    tc = _mamba_cache(jc, dtype)
    jx, tx = _rand((2, 36, 128), dtype, 9)
    for what, sl in [("fill", slice(0, 32))] + [
            (f"decode {i}", slice(32 + i, 33 + i)) for i in range(4)]:
        jy, jc = jmix(jp, jx[:, sl], jc)
        ty, tc2 = tmamba.mamba_mixer(tp, tx[:, sl], tcfg, cache=tc)
        assert tc2 is tc
        _close(ty, jy, dtype, what)
        assert tc.conv.dtype == TDT[dtype] and tc.ssm.dtype == torch.float32
        _close(tc.conv, jc.conv, dtype, what + ": conv")
        _close(tc.ssm, jc.ssm, dtype, what + ": ssm")


def test_mamba_ragged_length_matches_the_reference_causal_prefix():
    """At S = 29 (past the chunk of 16, no multiple of it) the reference
    raises; the port's output equals the reference's at S = 32 cut to its
    first 29 positions (the mixer is causal), and its cache equals the
    port's own 16-token fill followed by 13 decode steps (within f32: the
    input projection sums over other row counts)."""
    jcfg, tcfg, jp, tp, jmix = _mamba("f32")
    jx, tx = _rand((2, 32, 128), "f32", 10)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jmix(jp, jx[:, :29], None)
    jy, _ = jmix(jp, jx, None)
    ty, _ = tmamba.mamba_mixer(tp, tx[:, :29], tcfg)
    _close(ty, jy[:, :29], "f32", "ragged prefix")
    fill = tmamba.init_mamba_cache(tcfg, 2, device="cpu")
    tmamba.mamba_mixer(tp, tx[:, :29], tcfg, cache=fill)
    step = tmamba.init_mamba_cache(tcfg, 2, device="cpu")
    tmamba.mamba_mixer(tp, tx[:, :16], tcfg, cache=step)
    for t in range(16, 29):
        tmamba.mamba_mixer(tp, tx[:, t:t + 1], tcfg, cache=step)
    _close(fill.ssm, step.ssm, "f32", "state")
    _close(fill.conv, step.conv, "f32", "conv inputs")


# -------------------------------------------------------------------- rwkv
def _rwkv(dtype, seed=11):
    jcfg, tcfg = _cfgs(RWKV + "-smoke", dtype)
    jtm, ttm = _spec_params(jrwkv.rwkv_tm_param_specs(jcfg),
                            trwkv.rwkv_tm_param_specs(tcfg), seed)
    jcm_, tcm_ = _spec_params(jrwkv.rwkv_cm_param_specs(jcfg),
                              trwkv.rwkv_cm_param_specs(tcfg), seed + 1)
    jtime = jax.jit(lambda p, x, c: jrwkv.rwkv_time_mix(p, x, jcfg, cache=c))
    jchan = jax.jit(lambda p, x, c: jrwkv.rwkv_channel_mix(p, x, jcfg,
                                                           cache=c))
    return tcfg, (jtm, ttm, jtime), (jcm_, tcm_, jchan)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rwkv_mixes_fill_then_four_decode_steps(dtype):
    """Time and channel mixing at S = 37 (two chunks of 16 and a ragged
    third) with no cache, then a prefill-fill of 37 from a nonzero cache
    and 4 decode steps: outputs and the three cache fields (the wkv state,
    the two token-shift inputs) equal the reference's after every call."""
    tcfg, (jtm, ttm, jtime), (jch, tch, jchan) = _rwkv(dtype)
    jx, tx = _rand((2, 41, 128), dtype, 13)
    jy, (js, jprev) = jtime(jtm, jx[:, :37], None)
    ty, (ts, tprev) = trwkv.rwkv_time_mix(ttm, tx[:, :37], tcfg)
    _close_time_mix(ty, jy, dtype, "time mix, no cache")
    _close(ts, js, dtype, "state, no cache")
    jy, jprev = jchan(jch, jx[:, :37], None)
    ty, tprev = trwkv.rwkv_channel_mix(tch, tx[:, :37], tcfg)
    _close(ty, jy, dtype, "channel mix, no cache")
    np.testing.assert_array_equal(_np(tprev), _np(jprev))

    rng = np.random.default_rng(14)
    jc = jrwkv.RWKVCache(*(
        jnp.asarray(rng.normal(size=s).astype(np.float32), dt)
        for s, dt in (((2, 128), JDT[dtype]), ((2, 128), JDT[dtype]),
                      ((2, 4, 32, 32), jnp.float32))))
    tc = trwkv.RWKVCache(_t(jc.tm_prev, TDT[dtype]),
                         _t(jc.cm_prev, TDT[dtype]),
                         _t(jc.state, torch.float32))
    for what, sl in [("fill", slice(0, 37))] + [
            (f"decode {i}", slice(37 + i, 38 + i)) for i in range(4)]:
        jy, (js, jtp) = jtime(jtm, jx[:, sl], jc)
        ty, (ts, ttp) = trwkv.rwkv_time_mix(ttm, tx[:, sl], tcfg, cache=tc)
        jy2, jcp = jchan(jch, jx[:, sl], jc)
        ty2, tcp = trwkv.rwkv_channel_mix(tch, tx[:, sl], tcfg, cache=tc)
        _close_time_mix(ty, jy, dtype, what + ": time mix")
        _close(ty2, jy2, dtype, what + ": channel mix")
        assert ts.dtype == torch.float32
        _close(ts, js, dtype, what + ": state")
        jc = jrwkv.RWKVCache(tm_prev=jtp, cm_prev=jcp, state=js)
        tc = trwkv.RWKVCache(tm_prev=ttp, cm_prev=tcp, state=ts)
        for a, b in ((ttp, jtp), (tcp, jcp)):
            assert a.dtype == TDT[dtype]
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=what)


# ------------------------------------------------------------ whole models
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

    def check(self, dtype, n_calls, what=""):
        """As many calls in both packages; in f32 the same ids at each."""
        jax.effects_barrier()
        assert len(self.routes) == len(self.t) == n_calls, what
        if dtype == "f32":
            for i, (r, t) in enumerate(zip(self.routes, self.t)):
                np.testing.assert_array_equal(t, r[1],
                                              err_msg=f"{what} call {i}")


_MODELS: dict = {}


def _models(name, dtype):
    """(jax cfg, jax params, port cfg, port LM on the CPU), made once per
    (config, dtype) for the file."""
    key = (name, dtype)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(name, dtype)
        model = tapi.model_api(tcfg).init(torch.Generator().manual_seed(0),
                                          device="cpu")
        params = jax.tree.map(
            lambda a, sp: jnp.asarray(a, sp.dtype),
            convert.lm_params_to_numpy(model), jlm.lm_param_specs(jcfg))
        _MODELS[key] = (jcfg, params, tcfg, model)
    return _MODELS[key]


def _logits_close(got, want, dtype, what=""):
    _close(got, want, dtype, what, BF16_MODEL if dtype == "bf16" else None)


# MoE calls of one pass: jamba-smoke has 4 MoE layers (odd slots)
MOE_LAYERS = {JAMBA: 4, RWKV: 0}


@pytest.mark.parametrize("name", [JAMBA, RWKV])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_loss_match(name, dtype, monkeypatch):
    jcfg, params, tcfg, model = _models(name + "-smoke", dtype)
    toks = np.random.default_rng(17).integers(0, 512, (2, 48)).astype(
        np.int32)
    spy = _RouteSpy(monkeypatch, force=dtype == "bf16")
    (want, jaux), (jl, jm) = jax.jit(lambda p, t: (
        jlm.forward_logits(p, t, jcfg), jlm.lm_loss(p, {"tokens": t}, jcfg)))(
        params, jnp.asarray(toks))
    got = tlm.forward_logits(model, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, 48, 512) and got.dtype == TDT[dtype]
    _logits_close(got, want, dtype, "logits")
    tl, tm = tlm.lm_loss(model, {"tokens": torch.from_numpy(toks)}, tcfg)
    spy.check(dtype, 2 * MOE_LAYERS[name], "forward, loss")
    for got_, want_, what in ((tl, jl, "loss"), (tm["ce"], jm["ce"], "ce"),
                              (tm["aux"], jm["aux"], "aux"),
                              (tm["aux"], jaux, "aux = forward's")):
        _close(got_, want_, dtype, what)
    assert (float(tm["aux"]) > 0) == (name == JAMBA)


def _ref_slot(tree, period, i):
    """Period ``i`` of a reference cache stacked ``[n_periods, ...]``."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32)[i],
                        tree["body"][period])


@pytest.mark.parametrize("name", [JAMBA, RWKV])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_then_four_decode_steps_match(name, dtype, monkeypatch):
    """Prefill a [2, S] prompt (jamba 32, a multiple of its chunk of 16,
    the lengths the reference's Mamba runs at; rwkv 37), then 4 greedy
    decode steps, in both packages; both decode the reference's greedy
    token, and in f32 the port's own greedy tokens equal it.  The caches
    the caller holds are written in place, and after the last step each
    equals the reference's (the Mamba conv inputs and scan state, the RWKV
    wkv state and token-shift inputs, the attention KV cache's length and,
    in f32, its entries), in bf16 at ``BF16_MODEL``."""
    jcfg, params, tcfg, model = _models(name + "-smoke", dtype)
    ja, ta = japi.model_api(jcfg), tapi.model_api(tcfg)
    B, S, steps = 2, (32 if name == JAMBA else 37), 4
    toks = np.random.default_rng(18).integers(0, 512, (B, S)).astype(
        np.int32)
    spy = _RouteSpy(monkeypatch, force=dtype == "bf16")
    held = ta.init_cache(B, S + steps, device="cpu")
    kinds = [mk for mk, _ in tcfg.layer_kinds()]
    assert [type(c).__name__ for c in held] == [
        {tcm.MIXER_MAMBA: "MambaCache", tcm.MIXER_RWKV6: "RWKVCache",
         tcm.MIXER_FULL: "KVCache"}[k] for k in kinds]
    jl, jc = jax.jit(ja.prefill)(params, {"tokens": jnp.asarray(toks)},
                                 ja.init_cache(B, S + steps))
    tl, tc = ta.prefill(model, {"tokens": torch.from_numpy(toks)}, held)
    logits, tokens, caches = [(tl, jl)], ([], []), [(tc, jc)]
    jdec = jax.jit(ja.decode)
    for i in range(steps):
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
        tokens[0].append(tlm.greedy_token(tl).ravel().tolist())
        tokens[1].append(np.asarray(jt).ravel().tolist())
        jl, jc = jdec(params, jt, jc, S + i)
        tl, tc = ta.decode(model, torch.from_numpy(np.array(jt)), tc, S + i)
        logits.append((tl, jl))
        caches.append((tc, jc))
    spy.check(dtype, (1 + steps) * MOE_LAYERS[name], "serve")
    if dtype == "f32":
        assert tokens[0] == tokens[1]
    for i, (tl, jl) in enumerate(logits):
        assert tl.shape == (2, 512) and tl.dtype == TDT[dtype]
        assert torch.isfinite(tl).all()
        _logits_close(tl, jl, dtype, f"logits after step {i}")
    tc, jc = caches[-1]
    for a, b, k in zip(tc, held, kinds):    # a KVCache: the same buffers
        assert a is b if k != tcm.MIXER_FULL else a.k is b.k and a.v is b.v
    for n, (c, k) in enumerate(zip(tc, kinds)):
        want = _ref_slot(jc, n % tcfg.period, n // tcfg.period)
        for f in c._fields:
            got = getattr(c, f)
            if got is None or (k == tcm.MIXER_FULL and f != "length"
                               and dtype == "bf16"):
                continue
            # in bf16 a layer's input carries the model's rounding so far
            _close(got, getattr(want, f), dtype, f"layer {n} {f}",
                   BF16_MODEL if dtype == "bf16" else None)


@pytest.mark.parametrize("name", [JAMBA, RWKV])
def test_lm_params_round_trip_keep_every_slash_named_leaf(name, tmp_path):
    """A reference tree (jamba's body stacked ``[1, ...]`` over 8 period
    slots) through ``convert`` and back equals itself leaf for leaf, each
    port leaf in its spec's dtype; a leaf whose name holds a slash
    (``mix_base/mix_mu``, ``cmix_k/mix_mu``) stays one parameter; a
    checkpoint of the tree restores it whole."""
    _, params, tcfg, model = _models(name + "-smoke", "bf16")
    flat_j = jax.tree_util.tree_flatten_with_path(params)[0]
    back = convert.lm_params_to_numpy(model)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_t) == len(flat_j)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path],
                                      np.asarray(leaf, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
    specs = dict(tcm.leaves(tlm.lm_param_specs(tcfg)))
    got = dict(tcm.leaves(model.tree()))
    assert set(got) == set(specs)
    for p, t in got.items():
        assert t.dtype == specs[p].dtype, p
    names = dict(model.named_parameters())
    slashed = [n for n in names if "/" in n]
    want = ({"mix_base/mix_mu", "mix/mix_mu", "cmix_k/mix_mu",
             "cmix_r/mix_mu"} if name == RWKV else set())
    assert {n.split(".")[-1] for n in slashed} == want
    assert len(names) == len(specs)
    if name == RWKV:
        assert model["layers"][0]["mixer"]["mix/mix_mu"].shape == (5, 128)
        assert model["layers"][0]["mlp"]["cmix_k/mix_mu"].dtype == \
            torch.float32
    tree = convert.lm_params_to_tree(model)
    ckpt.save(tmp_path, 1, tree)
    again = ckpt.restore(tmp_path, 1, tree, device="cpu")
    for (p, a), (q, b) in zip(tcm.leaves(tree), tcm.leaves(again)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), p
    model2 = convert.lm_params_from_numpy(tcfg, back, device="cpu")
    for (n, a), b in zip(model.named_parameters(), model2.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
