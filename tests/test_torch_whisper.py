"""The port's encoder-decoder (``whisper-small``) against the JAX reference
on the CPU.

The smoke model (2 encoder + 2 decoder layers, d 128, 4 heads of 32,
vocab 512, gelu, tied embeddings) goes through both packages from the
reference's own initialised parameters (``convert.encdec_params_from_numpy``),
in f32 and bf16, and at a variant with ``n_kv_heads=2`` (the encoder's and
the decoder's self-attention read 2 kv heads; the cross-attention keeps
``n_heads``: at whisper's 12 and 12 a mix-up would not show).  The
encoder runs at its frames' length (37 here, not ``enc_seq``); on CPU
tensors the attention runs the flash kernel's plain forward and its
written-out plain gradient, with k / v of another length than q in the
cross-attention.  Inputs are numpy, seeded.

Tolerances, each with its reason (those of ``test_torch_vision.py``):
  * hidden states, logits and losses in f32 1e-5 (the same arithmetic
    summed in another order); bf16 3e-2 (``LOSS_TOL``: bf16 rounds at other
    points in the two frameworks);
  * gradients in f32 rtol 1e-4 / atol 2e-6 (``GRAD_TOL``: the same
    arithmetic in another order through an autodiff of another framework);
  * the attention and its gradient against ``blocked_attention`` and
    ``jax.vjp`` of it 2e-5 (``ATTN_GRAD_TOL``: f32 scores summed in another
    order);
  * AdamW's metrics rtol 1e-5 / atol 1e-6 and its masters rtol 1e-5 /
    atol 1e-4 (Adam's first step moves a weight by about lr * g / (|g| +
    eps), so where |g| is near eps it follows g's rounding noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import base as jbase
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.optim import adamw as jadamw

from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import encdec as ted
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw

WHISPER = "whisper-small"
SMOKE = WHISPER + "-smoke"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOSS_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
            "bf16": dict(rtol=3e-2, atol=3e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
ATTN_GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
B, S_ENC, S_DEC = 2, 37, 20      # 37 frames: not enc_seq (32), no tile


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what="", tol=GRAD_TOL):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _batch(seed, b=B, s_enc=S_ENC, s_dec=S_DEC, d=128):
    """(numpy frames [b, s_enc, d] f32, numpy tokens [b, s_dec] int32)."""
    rng = np.random.default_rng(seed)
    return _normal(rng, (b, s_enc, d)), \
        rng.integers(0, 512, (b, s_dec)).astype(np.int32)


def _jbatch(frames, toks=None):
    out = {"frames": jnp.asarray(frames)}
    if toks is not None:
        out["tokens"] = jnp.asarray(toks)
    return out


def _tbatch(frames, toks=None):
    out = {"frames": torch.from_numpy(frames)}
    if toks is not None:
        out["tokens"] = torch.from_numpy(toks)
    return out


# ------------------------------------------------------------------ configs
CONFIG_FIELDS = ("name", "n_layers", "n_enc_layers", "enc_seq", "d_model",
                 "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab_size",
                 "rope_theta", "tie_embeddings", "norm_eps", "act", "remat",
                 "encdec", "frontend", "attn_logit_softcap", "qk_norm")


@pytest.mark.parametrize("name", [WHISPER, SMOKE])
def test_config_matches_the_reference_field_by_field(name):
    """Every field the port has: the decoder's 12 and the encoder's 12
    layers (2 + 2 in the smoke), ``enc_seq`` 1500 (32), the audio
    frontend, ``remat`` (the reference's ArchConfig default, on in the
    full config, off in the smoke shrink)."""
    j, t = jbase.get_config(name), tbase.get_config(name)
    for f in CONFIG_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert t.encdec and t.frontend == "audio" and t.remat == (name == WHISPER)
    assert (t.n_enc_layers, t.enc_seq) == ((12, 1500) if name == WHISPER
                                           else (2, 32))


def test_param_specs_and_init_match_the_reference_leaf_for_leaf():
    """whisper-small's 294,683,904 parameters: every leaf of the port's
    per-layer tree is a layer of the reference's stacked leaf, in shape and
    dtype; ``init`` on the CPU draws the smoke tree by those specs,
    scales zero, and an ``EncDec`` of frozen parameters."""
    for name in (WHISPER, SMOKE):
        jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
        got = dict(tcm.leaves(tapi.model_api(tcfg).param_specs()))
        want = jax.tree_util.tree_flatten_with_path(
            japi.model_api(jcfg).param_specs())[0]
        assert len(got) == sum(
            (leaf.shape[0] if "body" in jax.tree_util.keystr(p) else 1)
            for p, leaf in want)
        for p, leaf in want:
            path = "/".join(str(getattr(k, "key", k)) for k in p)
            for mine, ref in (("enc_layers", "enc_body"),
                              ("dec_layers", "dec_body")):
                if path.startswith(ref):
                    rest = path[len(ref) + 1:]
                    for i in range(leaf.shape[0]):
                        assert got[f"{mine}/{i}/{rest}"] == tcm.spec(
                            leaf.shape[1:], torch.bfloat16), path
                    break
            else:
                assert got[path] == tcm.spec(leaf.shape, torch.bfloat16)
    assert tcm.count_params(tapi.model_api(
        tbase.get_config(WHISPER)).param_specs()) == 294_683_904
    model = tapi.model_api(tbase.get_config(SMOKE)).init(device="cpu")
    assert isinstance(model, ted.EncDec) and model.device.type == "cpu"
    assert not any(p.requires_grad for p in model.parameters())
    assert not model["dec_layers"][1]["ln_x_scale"].any()
    assert model["dec_layers"][1]["cross"]["wk"].shape == (128, 128)


# ------------------------------------------------------ attention at T != S
TS_CASES = [(5, 37, 4, 4), (37, 5, 4, 4), (1, 33, 4, 4), (37, 200, 4, 2),
            (130, 1, 4, 2)]


@pytest.mark.parametrize("S,T,H,Kv", TS_CASES,
                         ids=[f"S{s}-T{t}-H{h}-Kv{k}"
                              for s, t, h, k in TS_CASES])
def test_flash_plain_at_t_ne_s_matches_blocked_attention_and_its_vjp(S, T, H,
                                                                     Kv):
    """``flash_attention_plain`` with q [2, S, H, 32] and k, v [2, T, Kv,
    32], non-causal, against the reference's ``blocked_attention`` (chunks
    of 16, so both lengths pad), and ``flash_attention_bwd_plain`` on its
    lse against ``jax.vjp`` of it: o, dq [.., S, ..], dk and dv [.., T, ..],
    the lse against a float64 logsumexp."""
    rng = np.random.default_rng(S * 1000 + T)
    q, do = (_normal(rng, (2, S, H, 32)) for _ in range(2))
    k, v = (_normal(rng, (2, T, Kv, 32)) for _ in range(2))
    kw = dict(causal=False, window=0, softcap=0.0)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)
    assert lse.shape == (2, H, S) and o.shape == (2, S, H, 32)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    G = H // Kv
    s = np.einsum("bqkgd,btkd->bkgqt", q.reshape(2, S, Kv, G, 32)
                  .astype(np.float64), k.astype(np.float64)) * 32 ** -0.5
    mx = s.max(-1, keepdims=True)
    want_lse = (mx[..., 0] + np.log(np.exp(s - mx).sum(-1))).reshape(2, H, S)
    _close(lse, want_lse, "lse", ATTN_GRAD_TOL)

    def attn(a, b, c):
        return jattn.blocked_attention(a, b, c, causal=False, q_chunk=16,
                                       k_chunk=16)

    def fwd_vjp(a, b, c, d):
        out, pull = jax.vjp(attn, a, b, c)
        return out, pull(d)

    want_o, want = jax.jit(fwd_vjp)(*map(jnp.asarray, (q, k, v, do)))
    _close(o, want_o, "o", ATTN_GRAD_TOL)
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, f"d{name}", ATTN_GRAD_TOL)


def test_flash_plain_at_t_ne_s_in_bf16_matches_blocked_attention():
    """The bf16 forward at S 5 / T 37, GQA: p rounded to bf16 before the PV
    product in both, output within ``LOSS_TOL``'s bf16 limit."""
    rng = np.random.default_rng(4)
    q = _normal(rng, (2, 5, 4, 32))
    k, v = (_normal(rng, (2, 37, 2, 32)) for _ in range(2))
    got = tfa.flash_attention_plain(*(torch.from_numpy(t).bfloat16()
                                      for t in (q, k, v)), causal=False)
    want = jattn.blocked_attention(*(jnp.asarray(t, jnp.bfloat16)
                                     for t in (q, k, v)), causal=False)
    assert got.dtype == torch.bfloat16
    _close(got, want, "o", LOSS_TOL["bf16"])


def test_padded_keys_and_query_rows_get_no_gradient_and_give_none():
    """Keys past T never count: k, v padded with rows of large values past
    T = 37 give the same output to the last bit as the unpadded call, and
    ``flash_attention_bwd_plain`` at T gives dk, dv only at T; a query row
    appended past S adds nothing to dk or dv when its do is zero."""
    rng = np.random.default_rng(5)
    q, do = (torch.from_numpy(_normal(rng, (1, 9, 4, 32))) for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, (1, 37, 4, 32))) for _ in range(2))
    kw = dict(causal=False)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    dq, dk, dv = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    q2 = torch.cat([q, torch.full((1, 3, 4, 32), 50.0)], dim=1)
    do2 = torch.cat([do, torch.zeros(1, 3, 4, 32)], dim=1)
    o2, lse2 = tfa.flash_attention_plain(q2, k, v, return_lse=True, **kw)
    assert torch.equal(o2[:, :9], o) and torch.equal(lse2[..., :9], lse)
    dq2, dk2, dv2 = tfa.flash_attention_bwd_plain(q2, k, v, o2, do2, lse2,
                                                  **kw)
    _close(dk2, dk, "dk", ATTN_GRAD_TOL)
    _close(dv2, dv, "dv", ATTN_GRAD_TOL)
    assert torch.equal(dq2[:, :9], dq)


@pytest.mark.parametrize("kw", [dict(causal=True, window=0),
                                dict(causal=False, window=4)],
                         ids=["causal", "window"])
def test_flash_refuses_t_ne_s_with_a_mask(kw):
    """T != S is taken only without the causal mask and the window: no
    caller in the reference makes such a call, and both plain versions
    and both kernels' wrappers raise ``ValueError`` before any launch."""
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 16, 2, 64)
    lse = torch.zeros(1, 2, 8)
    kw = dict(softcap=0.0, **kw)
    with pytest.raises(ValueError, match="must be attended"):
        tfa.flash_attention_plain(q, k, k, **kw)
    with pytest.raises(ValueError, match="must be attended"):
        tfa.flash_attention_bwd_plain(q, k, k, q, q, lse, **kw)
    with pytest.raises(ValueError, match="must be attended"):
        tfa.flash_attention_cuda(q, k, k, **kw)
    with pytest.raises(ValueError, match="must be attended"):
        tfa.flash_attention_bwd_cuda(q, k, k, q, q, lse, **kw)
    with pytest.raises(ValueError, match="T >= 1"):
        tfa.flash_attention_plain(q, k[:, :0], k[:, :0], causal=False)


def test_flash_autograd_at_t_ne_s_is_the_plain_gradient():
    """``ops.flash_attention_bshd`` under grad with q [2, 7, 4, 32] against
    k, v [2, 45, 2, 32]: ``FlashAttention`` saves the plain forward's lse
    and its backward returns ``flash_attention_bwd_plain``'s bits, dk and
    dv at T."""
    rng = np.random.default_rng(6)
    q, do = (torch.from_numpy(_normal(rng, (2, 7, 4, 32))) for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, (2, 45, 2, 32))) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention_bshd(*leaves, causal=False)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True,
                                       causal=False)
    assert torch.equal(out.detach(), o)
    assert torch.equal(out.grad_fn.saved_tensors[4], lse)
    grads = torch.autograd.grad(out, leaves, do)
    direct = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=False)
    for a, b in zip(grads, direct):
        assert a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------------ whole models
_REF: dict = {}
MODEL_CASES = [("f32", {}), ("bf16", {}), ("f32", {"n_kv_heads": 2})]
MODEL_IDS = ["f32", "bf16", "f32-kv2"]


def _ref(dtype, **extra):
    """(reference cfg, its parameters, jitted value_and_grad of the loss,
    port cfg), made once per (dtype, extra) for the file."""
    key = (dtype, tuple(sorted(extra.items())))
    if key not in _REF:
        jcfg = jbase.get_config(SMOKE).replace(dtype=JDT[dtype], **extra)
        tcfg = tbase.get_config(SMOKE).replace(dtype=TDT[dtype], **extra)
        api = japi.model_api(jcfg)
        params = api.init(jax.random.key(0))
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss(p, b), has_aux=True))
        _REF[key] = (jcfg, params, vg, tcfg)
    return _REF[key]


def _port(cfg, params, trainable=False):
    model = convert.encdec_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    return model.requires_grad_(trainable)


@pytest.mark.parametrize("dtype,extra", MODEL_CASES, ids=MODEL_IDS)
def test_encode_cross_kv_and_decode_train_match(dtype, extra):
    """``encode`` at the frames' length (37, cast to the model dtype), its
    cross k / v stacked [L, B, 37, n_heads, dh], and the teacher-forced
    decoder's hidden [B, 20, d], against ``repro.models.encdec``'s: f32 at
    1e-5, bf16 at ``LOSS_TOL``; ``api.forward`` is the encoder."""
    jcfg, params, _, tcfg = _ref(dtype, **extra)
    model = _port(tcfg, params)
    frames, toks = _batch(71)
    want = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(params, frames)
    got = tapi.model_api(tcfg).forward(model, _tbatch(frames))
    assert got.shape == (B, S_ENC, 128) and got.dtype == TDT[dtype]
    _close(got, want, "encode", LOSS_TOL[dtype])
    jk, jv = jax.jit(lambda p, e: jed.cross_kv(p, e, jcfg))(params, want)
    ek = torch.from_numpy(np.array(want, np.float32)).to(TDT[dtype])
    tk, tv = ted.cross_kv(model, ek, tcfg)
    assert tk.shape == (2, B, S_ENC, 4, 32)
    _close(tk, jk, "cross k", LOSS_TOL[dtype])
    _close(tv, jv, "cross v", LOSS_TOL[dtype])
    jx = jax.jit(lambda p, t, e: jed.decode_train(p, t, e, jcfg))(
        params, toks, want)
    tx = ted.decode_train(model, torch.from_numpy(toks), ek, tcfg)
    assert tx.shape == (B, S_DEC, 128)
    _close(tx, jx, "decode_train", LOSS_TOL[dtype])


@pytest.mark.parametrize("dtype,extra", MODEL_CASES, ids=MODEL_IDS)
def test_loss_and_every_gradient_match_value_and_grad(dtype, extra):
    """``encdec_loss`` (f32 of the model-dtype product over the whole
    sequence, labels padded by -1) and the gradient of every leaf of both
    stacks against ``jax.value_and_grad`` of the reference's: f32 at
    ``GRAD_TOL``, bf16 at ``LOSS_TOL``; the gradients in each leaf's
    dtype."""
    jcfg, params, vg, tcfg = _ref(dtype, **extra)
    frames, toks = _batch(72)
    (jl, jm), jg = vg(params, _jbatch(frames, toks))
    model = _port(tcfg, params, trainable=True)
    tl, tm, grads = tsteps.loss_and_grads(tapi.model_api(tcfg).loss, model,
                                          _tbatch(frames, toks))
    tol = LOSS_TOL[dtype]
    for g, w, what in ((tl, jl, "loss"), (tm["ce"], jm["ce"], "ce"),
                       (tm["aux"], jm["aux"], "aux")):
        _close(g, w, what, tol)
    got = dict(tcm.leaves(grads))
    want = dict(tcm.leaves(convert.encdec_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jg), device="cpu").tree()))
    assert sorted(got) == sorted(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        _close(got[path], want[path], path,
               GRAD_TOL if dtype == "f32" else tol)


def test_remat_is_bit_equal_to_no_remat():
    """Under ``remat`` each layer of both stacks runs under
    ``checkpoint``: the loss and every gradient equal the plain run's bit
    for bit (f32)."""
    _, params, _, tcfg = _ref("f32")
    frames, toks = _batch(73)
    out = []
    for remat in (False, True):
        cfg = tcfg.replace(remat=remat)
        out.append(tsteps.loss_and_grads(
            tapi.model_api(cfg).loss, _port(cfg, params, trainable=True),
            _tbatch(frames, toks)))
    assert torch.equal(out[0][0], out[1][0])
    for (p, a), (_, b) in zip(tcm.leaves(out[0][2]), tcm.leaves(out[1][2])):
        assert torch.equal(a, b), p


def _jcache(jcfg, b, max_len):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        jed.encdec_cache_specs(jcfg, b, max_len))


@pytest.mark.parametrize("dtype,extra", MODEL_CASES, ids=MODEL_IDS)
def test_prefill_then_greedy_steps_match(dtype, extra):
    """Prefill (encode, cross k / v at the frames' 37, the BOS step) then 4
    greedy decode steps at ``pos = 1 + t`` in both packages: the same
    greedy tokens, logits f32 at 1e-5 and bf16 at ``LOSS_TOL``.  The port
    writes caches in place, yet its prefill returns the caller's self cache
    unwritten (the same buffers, zeros, length 0), as the reference's
    "self cache stays empty until decode"; ``caches=None`` gives the same
    logits.  After the steps each layer's cache holds 4 entries."""
    jcfg, params, _, tcfg = _ref(dtype, **extra)
    ja, ta = japi.model_api(jcfg), tapi.model_api(tcfg)
    model = _port(tcfg, params)
    frames, _ = _batch(74)
    steps, L = 4, 8
    jl, jc = jax.jit(ja.prefill)(params, _jbatch(frames),
                                 _jcache(jcfg, B, L))
    given = ta.init_cache(B, L, device="cpu")
    assert given.cross_k.shape == (2, B, 32, 4, 32)
    tl, tc = ta.prefill(model, _tbatch(frames), given)
    assert tc.self_kv is given.self_kv
    assert all(int(c.length) == 0 and not c.k.any() and not c.v.any()
               for c in tc.self_kv)
    assert tc.cross_k.shape == (2, B, S_ENC, 4, 32)
    assert jc.cross_k.shape == tc.cross_k.shape
    bare, none = ta.prefill(model, _tbatch(frames))
    assert torch.equal(bare, tl) and none.self_kv is None
    jdec = jax.jit(ja.decode)
    tokens = ([], [])
    for i in range(steps):
        _close(tl, jl, f"logits before step {i}", LOSS_TOL[dtype])
        tt = tlm.greedy_token(tl)
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
        tokens[0].append(tt.ravel().tolist())
        tokens[1].append(np.asarray(jt).ravel().tolist())
        feed = tt if dtype == "f32" else torch.from_numpy(np.asarray(jt))
        jl, jc = jdec(params, jt, jc, 1 + i)
        tl, tc = ta.decode(model, feed, tc, 1 + i)
    _close(tl, jl, "last logits", LOSS_TOL[dtype])
    if dtype == "f32":
        assert tokens[0] == tokens[1]
    assert all(int(c.length) == steps for c in tc.self_kv)
    assert all(a.k is b.k for a, b in zip(tc.self_kv, given.self_kv))


# -------------------------------------------------------------- training
def test_train_step_matches_adamw_update_on_the_same_gradients():
    """One ``build_train_step`` step against the reference's
    ``jax.value_and_grad`` and ``adamw_update`` from the same state (f32):
    the metrics, and every master and moment in the reference's stacked
    layout through ``convert.opt_state_to_numpy``."""
    jcfg, params, vg, tcfg = _ref("f32")
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jo, to = jadamw.AdamWConfig(**ocfg), tadamw.AdamWConfig(**ocfg)
    frames, toks = _batch(75)
    (jl, jm), jg = vg(params, _jbatch(frames, toks))
    jp, jopt, jom = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, jo))(
        jg, jadamw.init_opt_state(params, jo), params)
    model = _port(tcfg, params, trainable=True)
    model, topt, tm = tsteps.build_train_step(tcfg, to)(
        model, tadamw.init_opt_state(model, to), _tbatch(frames, toks))
    want = {"loss": jl, **jm, **jom}
    assert sorted(tm) == sorted(want)
    for key in want:
        _close(tm[key], want[key], key, dict(rtol=1e-5, atol=1e-6))
    got = convert.opt_state_to_numpy(topt, tcfg)
    assert int(got.step) == int(jopt.step) == 1
    for field in ("m", "master"):
        for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(
                getattr(got, field))[0], jax.tree.leaves(getattr(jopt,
                                                                 field))):
            _close(g, w, f"{field} {path}",
                   GRAD_TOL if field == "m" else dict(rtol=1e-5, atol=1e-4))
    for g, w in zip(jax.tree.leaves(convert.encdec_params_to_numpy(model)),
                    jax.tree.leaves(jp)):
        _close(g, w, "params", dict(rtol=1e-5, atol=1e-4))


def test_grad_accum_splits_frames_and_tokens_like_build_train_step():
    """The reference's train step with grad_accum = 2, built for a 1 x 1
    CPU mesh on an encoder-decoder cell (frames [4, 16, 128], tokens
    [4, 24]), against the port's from the same state: both split
    ``frames`` along the batch as they split the tokens; metrics, first
    moments and parameters, f32 (parameters within 10 % of lr: Adam's
    first step moves a weight by about lr * g / (|g| + eps), which follows
    g's rounding noise where |g| is near eps)."""
    jcfg, params, _, tcfg = _ref("f32")
    jcfg, tcfg = (c.replace(grad_accum=2) for c in (jcfg, tcfg))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    cell = jbase.ShapeCell("t", 16, 4, "train")
    jstep, _ = jsteps.build_train_step(jcfg, mesh, cell,
                                       jadamw.AdamWConfig(**ocfg))
    frames, toks = _batch(76, b=4, s_enc=16, s_dec=24)
    fresh = lambda t: jax.tree.map(lambda x: jnp.asarray(np.array(x)), t)
    jp = fresh(params)
    jopt = fresh(jadamw.init_opt_state(params, jadamw.AdamWConfig(**ocfg)))
    with mesh:
        jp, jopt, jm = jstep(jp, jopt, _jbatch(frames, toks))
    model = _port(tcfg, params, trainable=True)
    to = tadamw.AdamWConfig(**ocfg)
    model, topt, tm = tsteps.build_train_step(tcfg, to)(
        model, tadamw.init_opt_state(model, to), _tbatch(frames, toks))
    assert sorted(tm) == sorted(jm)
    for key in jm:
        _close(tm[key], jm[key], key, dict(rtol=1e-5, atol=1e-6))
    got = convert.opt_state_to_numpy(topt, tcfg)
    for g, w in zip(jax.tree.leaves(got.m), jax.tree.leaves(jopt.m)):
        _close(g, w, "m", GRAD_TOL)
    for g, w in zip(jax.tree.leaves(convert.encdec_params_to_numpy(model)),
                    jax.tree.leaves(jp)):
        _close(g, w, "params", dict(rtol=1e-5, atol=1e-4))


def test_convert_round_trip_is_exact():
    """``encdec_params_from_numpy`` turns the reference's stacked tree into
    one tree a layer and ``encdec_params_to_numpy`` turns it back, bit for
    bit, in bf16 and f32; the optimizer state's maps likewise, and each
    layer of the port is the reference's slice of its stack."""
    for dtype in ("bf16", "f32"):
        _, params, _, tcfg = _ref(dtype)
        model = _port(tcfg, params)
        assert len(model["enc_layers"]) == len(model["dec_layers"]) == 2
        ref = np.asarray(params["dec_body"]["cross"]["wv"], np.float32)
        assert np.array_equal(_np(model["dec_layers"][1]["cross"]["wv"]),
                              ref[1])
        back = convert.encdec_params_to_numpy(model)
        flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
        flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
        assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
        for (p, a), (_, b) in zip(flat_back, flat_ref):
            assert np.array_equal(a, np.asarray(b, np.float32)), p
        again = convert.encdec_params_from_numpy(tcfg, back, device="cpu")
        for (p, a), (_, b) in zip(tcm.leaves(again.tree()),
                                  tcm.leaves(model.tree())):
            assert a.dtype == b.dtype and torch.equal(a, b), p
    opt = tadamw.init_opt_state(model, tadamw.AdamWConfig())
    opt_back = convert.opt_state_from_numpy(
        tcfg, convert.opt_state_to_numpy(opt, tcfg), device="cpu")
    for (p, a), (_, b) in zip(tcm.leaves(opt_back.master),
                              tcm.leaves(opt.master)):
        assert torch.equal(a, b), p
