"""The port's captioner serving path against the JAX reference on the CPU.

``semanticxr-captioner-110m-smoke`` cut to 2 layers (d 128, 4 / 2 heads,
dh 32, vocab 512) goes through both packages with the reference's own
initialised parameters, carried across by ``convert.lm_params_from_numpy``.
On CPU tensors the attention kernel runs its plain version.  Tolerances:
f32 1e-5 (the same arithmetic summed in another order; measured about
1e-6); bf16 3e-2 absolute and relative (bf16 rounds at other points in the
two frameworks: one bf16 ulp of the logits' magnitude, about 0.016 at 3,
was measured), and greedy tokens equal in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import list_configs as jlist_configs
from repro.data import tokens as jtokens
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import blocks as jblk
from repro.models import common as jcm

from repro_torch import convert
from repro_torch.configs.base import get_config, list_configs
from repro_torch.data import tokens as ttokens
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblk
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm

SMOKE = "semanticxr-captioner-110m-smoke"
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# the gelu / softcap / qk-norm corners the captioner itself does not use
VARIANT = dict(act="gelu", attn_logit_softcap=50.0, final_logit_softcap=30.0,
               qk_norm=True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **TOL[dtype])


def _models(dtype, **extra):
    """(jax cfg, jax params, port cfg, port LM on the CPU)."""
    jcfg = jget_config(SMOKE).replace(n_layers=2, dtype=JDT[dtype], **extra)
    tcfg = get_config(SMOKE).replace(n_layers=2, dtype=TDT[dtype], **extra)
    params = japi.model_api(jcfg).init(jax.random.key(0))
    model = convert.lm_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, tcfg, model


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["body"][0])


def _rand(shape, dtype, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _kv_from_jax(c, layer=None):
    """The reference's KVCache (optionally one layer of a stacked one) as
    the port's."""
    pick = (lambda a: np.array(a, np.float32)) if layer is None else \
        (lambda a: np.array(a, np.float32)[layer])
    dt = torch.bfloat16 if c.k.dtype == jnp.bfloat16 else torch.float32
    return tattn.KVCache(torch.from_numpy(pick(c.k)).to(dt),
                         torch.from_numpy(pick(c.v)).to(dt),
                         torch.tensor(int(pick(c.length)), dtype=torch.int32))


# ------------------------------------------------------------- configs, data
def test_configs_match_the_reference():
    """The port registers the reference's whole registry, whisper-small
    included; the captioner's fields and whisper's (its encoder's depth and
    ``enc_seq`` too) equal the reference's, full and smoke."""
    assert list_configs() == jlist_configs()
    assert "whisper-small" in list_configs()
    for name in ("semanticxr-captioner-110m", SMOKE, "whisper-small",
                 "whisper-small-smoke"):
        j, t = jget_config(name), get_config(name)
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_head", "d_ff", "vocab_size", "rope_theta",
                  "tie_embeddings", "norm_eps", "act", "sliding_window",
                  "mixers", "mlps", "n_periods", "period", "encdec",
                  "n_enc_layers", "enc_seq", "frontend"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16


def test_caption_batches_match_the_reference():
    assert ttokens.VOCAB == jtokens.VOCAB
    j = next(jtokens.batch_iterator(3, 70, seed=4, vocab_size=512))
    t = next(ttokens.batch_iterator(3, 70, seed=4, vocab_size=512))
    np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert t["tokens"].dtype == np.int32


# ----------------------------------------------------------------- numerics
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_rope_and_activations_match(dtype):
    jx, tx = _rand((2, 5, 3, 32), dtype, 0)
    js, ts = _rand((32,), dtype, 1)
    _close(tcm.rms_norm(tx, ts, 1e-6), jcm.rms_norm(jx, js, 1e-6), dtype)
    pos = np.arange(100, 105)[None]
    got = tcm.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    assert got.dtype == tx.dtype
    _close(got, jcm.apply_rope(jx, jnp.asarray(pos), 10000.0), dtype)
    for name in ("silu", "gelu"):
        _close(tcm.act_fn(name)(tx), jcm.act_fn(name)(jx), dtype, name)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 401)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(tcm.act_fn("gelu")(x).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(x).numpy()
    assert np.abs(exact - want).max() > 1e-4


def test_embedding_scale_is_rounded_to_the_model_dtype():
    cfg = get_config("semanticxr-captioner-110m")
    assert tlm.embed_scale(cfg) == 27.75
    assert tlm.embed_scale(cfg) == float(jnp.asarray(768 ** 0.5,
                                                     jnp.bfloat16))
    assert tlm.embed_scale(cfg.replace(dtype=torch.float32)) == float(
        np.float32(768 ** 0.5))


def test_greedy_token_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]],
                          dtype=torch.bfloat16)
    assert tlm.greedy_token(logits).tolist() == [[1], [0]]


# ------------------------------------------------------------ mixer, block
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_mixer_prefill_fill_and_decode(dtype):
    """No cache, then prefill-fill into a longer cache (k, v padded to T,
    length S), then one decode step at position S."""
    jcfg, params, tcfg, model = _models(dtype)
    jp, tp = _layer0(params)["mixer"], model["layers"][0]["mixer"]
    B, S, T = 2, 70, 76
    jx, tx = _rand((B, S, 128), dtype, 2)
    jpos, tpos = jnp.arange(S)[None], torch.arange(S)[None]
    kw = dict(kind=jcm.MIXER_FULL)
    jy, _ = jattn.attention_mixer(jp, jx, jcfg, positions=jpos, **kw)
    ty, tc = tattn.attention_mixer(tp, tx, tcfg, positions=tpos, **kw)
    assert tc is None and ty.dtype == TDT[dtype]
    _close(ty, jy, dtype, "no cache")

    jc0 = jattn.init_kv_cache(jcfg, B, T)
    tcache = tattn.init_kv_cache(tcfg, B, T, device="cpu")
    tcache.k.fill_(7.0)                   # prefill-fill zeroes the tail
    jy, jc = jattn.attention_mixer(jp, jx, jcfg, positions=jpos, cache=jc0,
                                   **kw)
    ty, tc = tattn.attention_mixer(tp, tx, tcfg, positions=tpos,
                                   cache=tcache, **kw)
    _close(ty, jy, dtype, "prefill-fill y")
    assert int(tc.length) == int(jc.length) == S
    assert tc.k.shape == (B, T, 2, 32) and not tc.k[:, S:].any()
    _close(tc.k, jc.k, dtype, "prefill-fill k")
    _close(tc.v, jc.v, dtype, "prefill-fill v")
    assert tc.k.data_ptr() == tcache.k.data_ptr()   # written in place

    jx1, tx1 = _rand((B, 1, 128), dtype, 3)
    jy, jc = jattn.attention_mixer(jp, jx1, jcfg, cache=jc,
                                   positions=jnp.full((1, 1), S), **kw)
    ty, tc = tattn.attention_mixer(tp, tx1, tcfg, cache=tc,
                                   positions=torch.full((1, 1), S), **kw)
    _close(ty, jy, dtype, "decode y")
    assert int(tc.length) == int(jc.length) == S + 1
    _close(tc.k, jc.k, dtype, "decode k")
    _close(tc.v, jc.v, dtype, "decode v")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_block_apply_matches(dtype):
    jcfg, params, tcfg, model = _models(dtype)
    B, S = 2, 40
    jx, tx = _rand((B, S, 128), dtype, 4)
    kinds = dict(mixer_kind=jcm.MIXER_FULL, mlp_kind=jcm.MLP_DENSE)
    jout = jblk.block_apply(_layer0(params), jx, jcfg,
                            positions=jnp.arange(S)[None], **kinds)
    tout = tblk.block_apply(model["layers"][0], tx, tcfg,
                            positions=torch.arange(S)[None], **kinds)
    _close(tout.x, jout.x, dtype)
    assert tout.cache is None


class _RefSpec:
    """A reference parameter spec (shape, dtype name) that a stacked layer
    index slices, so ``convert._from_reference`` lays the reference's
    specs out as the port's tree without allocating them."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), str(dtype).split(".")[-1]

    def __getitem__(self, i):
        return _RefSpec(self.shape[1:], self.dtype)


def test_unported_families_raise_naming_the_roadmap():
    """No family is left unported: every config registered in
    ``repro.configs``, full and smoke, builds in the port, and its
    ``param_specs`` hold the reference's parameters leaf for leaf, each
    stacked reference leaf as its layers' leaves, in shape and dtype
    (specs only, nothing allocated).  An unknown name raises ``KeyError``,
    as the reference's registry does, and names no roadmap.  An unknown
    mixer or MLP kind raises ``ValueError``, as the reference's blocks
    do."""
    cfg = get_config(SMOKE)
    for name in jlist_configs():
        for full in (name, name + "-smoke"):
            jcfg, tcfg = jget_config(full), get_config(full)
            want = convert._from_reference(
                tcfg, jax.tree.map(lambda x: _RefSpec(x.shape, x.dtype),
                                   japi.model_api(jcfg).param_specs()),
                lambda _, x: x)
            got = dict(tcm.leaves(tapi.model_api(tcfg).param_specs()))
            want = dict(tcm.leaves(want))
            assert sorted(got) == sorted(want), full
            for path, sp in got.items():
                assert (sp.shape, str(sp.dtype).split(".")[-1]) == (
                    want[path].shape, want[path].dtype), (full, path)
    with pytest.raises(KeyError) as err:
        get_config("whisper-large")
    assert "ROADMAP" not in str(err.value)
    for kinds in (("cross_attn", tcm.MLP_DENSE), (tcm.MIXER_FULL, "glu")):
        with pytest.raises(ValueError):
            tblk.block_param_specs(cfg, *kinds)
        with pytest.raises(ValueError):
            jblk.block_param_specs(jget_config(SMOKE), *kinds)


# --------------------------------------------------------- prefill + decode
def _serve(dtype, *, steps, max_extra, extra):
    """Prefill a [2, 80] prompt, then ``steps`` greedy decode steps, in
    both packages.  Both decode the reference's greedy token, so the
    logits stay comparable even if an argmax differs.
    Returns (pairs of logits, pairs of token lists, pair of caches)."""
    jcfg, params, tcfg, model = _models(dtype, **extra)
    ja, ta = japi.model_api(jcfg), tapi.model_api(tcfg)
    B, S = 2, 80
    T = S + max_extra
    toks = np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)
    jl, jc = jax.jit(ja.prefill)(params, {"tokens": jnp.asarray(toks)},
                                 ja.init_cache(B, T))
    tl, tc = ta.prefill(model, {"tokens": torch.from_numpy(toks)},
                        ta.init_cache(B, T, device="cpu"))
    logits, tokens = [(tl, jl)], ([], [])
    jdec = jax.jit(ja.decode)
    for i in range(steps):
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
        tokens[0].append(tlm.greedy_token(tl).ravel().tolist())
        tokens[1].append(np.asarray(jt).ravel().tolist())
        jl, jc = jdec(params, jt, jc, S + i)
        tl, tc = ta.decode(model, torch.from_numpy(np.array(jt)), tc, S + i)
        logits.append((tl, jl))
    return logits, tokens, (tc, jc)


@pytest.mark.parametrize("dtype,extra", [("f32", {}), ("bf16", {}),
                                         ("f32", VARIANT)],
                         ids=["f32", "bf16", "f32-gelu-softcap-qknorm"])
def test_prefill_then_four_decode_steps_match(dtype, extra):
    logits, tokens, (tc, jc) = _serve(dtype, steps=4, max_extra=4,
                                      extra=extra)
    for i, (tl, jl) in enumerate(logits):
        assert tl.shape == (2, 512)
        # logits keep the model dtype unless a final softcap makes them f32
        assert tl.dtype == (torch.float32 if extra else TDT[dtype])
        assert torch.isfinite(tl).all()
        _close(tl, jl, dtype, f"logits after step {i}")
    if dtype == "f32":
        assert tokens[0] == tokens[1]
    for layer in range(2):
        got, want = tc[layer], _kv_from_jax(jc["body"][0], layer)
        assert int(got.length) == int(want.length) == 84
        _close(got.k, want.k, dtype, f"layer {layer} k")
        _close(got.v, want.v, dtype, f"layer {layer} v")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_logits_without_a_cache_match(dtype):
    from repro.models import lm as jlm
    jcfg, params, tcfg, model = _models(dtype)
    toks = np.random.default_rng(1).integers(0, 512, (2, 70)).astype(
        np.int32)
    want, _ = jlm.forward_logits(params, jnp.asarray(toks), jcfg)
    got = tlm.forward_logits(model, torch.from_numpy(toks), tcfg)
    assert got.shape == (2, 70, 512) and got.dtype == TDT[dtype]
    _close(got, want, dtype)


def test_decode_past_the_cache_end_rewrites_the_last_slot():
    """With 2 free slots, decode steps 3 and 4 write slot T-1 again
    (``min(length, T-1)``) and the length keeps counting."""
    logits, tokens, (tc, jc) = _serve("f32", steps=4, max_extra=2, extra={})
    for i, (tl, jl) in enumerate(logits):
        _close(tl, jl, "f32", f"logits after step {i}")
    assert tokens[0] == tokens[1]
    assert int(tc[0].length) == int(np.asarray(jc["body"][0].length)[0]) == 84
    _close(tc[1].k, _kv_from_jax(jc["body"][0], 1).k, "f32")


def test_lm_param_conversion_splits_stacked_layers_and_keeps_tying():
    _, params, tcfg, model = _models("f32")
    assert "lm_head" not in model and len(model["layers"]) == 2
    wq = np.asarray(params["body"][0]["mixer"]["wq"])
    for i in range(2):
        np.testing.assert_array_equal(
            model["layers"][i]["mixer"]["wq"].numpy(), wq[i])
    assert sum(p.numel() for p in model.parameters()) == sum(
        x.size for x in jax.tree.leaves(params))


def test_seeded_init_follows_the_naming_rules():
    cfg = get_config(SMOKE).replace(n_layers=2)
    a = tapi.model_api(cfg).init(torch.Generator().manual_seed(3),
                                 device="cpu")
    b = tapi.model_api(cfg).init(torch.Generator().manual_seed(3),
                                 device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.dtype == torch.bfloat16 and torch.equal(p, q), name
        if name.endswith("scale"):
            assert not p.any(), name
        else:      # truncated normal / sqrt(fan_in): within 2 / sqrt(fan_in)
            fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
            assert 0 < p.float().abs().max() <= 2 / fan_in ** 0.5 + 1e-2, name


def test_model_api_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = tapi.model_api(get_config(SMOKE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(1, 8)
