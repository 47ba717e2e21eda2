"""The port's training path against the JAX reference on the CPU.

``semanticxr-captioner-110m-smoke`` cut to 2 layers (d 128, 4 / 2 heads,
dh 32, vocab 512) goes through both packages with the reference's own
initialised parameters, carried across by ``convert.lm_params_from_numpy``;
on CPU tensors the attention runs its plain forward and its written-out
plain gradient (``flash_attention_bwd_plain``).  Inputs are numpy, seeded.

Tolerances, each with its reason:
  * f32 losses 1e-5 and gradients rtol 1e-4 / atol 2e-6: the same
    arithmetic summed in another order (about 1e-6 measured), through a
    gradient written out by hand rather than JAX's autodiff of a scan;
  * bf16 losses 3e-2 (bf16 rounds at other points in the two frameworks,
    as in ``test_torch_models.py``);
  * the attention gradient against ``jax.vjp`` 2e-5 (f32, one layer), and
    the forward's log-sum-exp against a float64 numpy ``logsumexp`` with
    the same bound (f32 scores summed in another order);
  * AdamW and the learning rate 1e-6 relative, 1e-8 absolute: the same
    f32 operations one by one, only the global norm's sum in another
    order (a master that crosses zero is a difference of terms of about
    1e-2, whose f32 spacing is about 1e-9);
  * int8 compression: bit for bit (``round`` is half-to-even in both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs.base import ShapeCell
from repro.configs.base import get_config as jget_config
from repro.distributed import collectives as jcoll
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.models import attention as jattn
from repro.optim import adamw as jadamw

from repro_torch import convert
from repro_torch.configs.base import get_config
from repro_torch.distributed import collectives as tcoll
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.optim import adamw as tadamw

SMOKE = "semanticxr-captioner-110m-smoke"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOSS_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
            "bf16": dict(rtol=3e-2, atol=3e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
ATTN_GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-8)
B, S, CHUNK = 3, 40, 24          # 40 = 24 + 16: two chunks, 8 padded rows


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(seed=0, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, 512, size=(b, s)).astype(np.int32)


def _jtree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _fresh(tree):
    """The same values in buffers of their own (a donated step may not see
    one buffer twice)."""
    return jax.tree.map(lambda x: jnp.asarray(np.array(x)), tree)


@pytest.fixture(scope="module")
def ref():
    """Reference configs, parameters and jitted loss / grad per dtype."""
    out = {}
    for name, jdt in JDT.items():
        jcfg = jget_config(SMOKE).replace(n_layers=2, dtype=jdt)
        tcfg = get_config(SMOKE).replace(n_layers=2, dtype=TDT[name])
        api = japi.model_api(jcfg)
        params = api.init(jax.random.key(0))
        loss = jax.jit(lambda p, t, api=api: api.loss(
            p, {"tokens": t}, loss_chunk=CHUNK))
        grad = jax.jit(jax.grad(lambda p, t, api=api: api.loss(
            p, {"tokens": t}, loss_chunk=CHUNK)[0]))
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, params=params, loss=loss,
                         grad=grad)
    return out


def _port(r, *, trainable=False, **extra):
    cfg = r["tcfg"].replace(**extra)
    lm = convert.lm_params_from_numpy(cfg, _jtree_np(r["params"]),
                                      device="cpu")
    return cfg, lm.requires_grad_(trainable)


# ------------------------------------------------------------------ lm_loss
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_loss_matches_the_reference(ref, dtype):
    r = ref[dtype]
    toks = _tokens(1)
    jl, jm = r["loss"](r["params"], jnp.asarray(toks))
    cfg, lm = _port(r)
    tl, tm = tapi.model_api(cfg).loss(lm, {"tokens": torch.from_numpy(toks)},
                                      loss_chunk=CHUNK)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    assert tm["aux"].dtype == torch.float32 and float(tm["aux"]) == 0.0
    for got, want, what in ((tl, jl, "loss"), (tm["ce"], jm["ce"], "ce"),
                            (tm["aux"], jm["aux"], "aux")):
        np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                                   **LOSS_TOL[dtype])


def test_lm_loss_chunking_does_not_change_the_loss(ref):
    r = ref["f32"]
    cfg, lm = _port(r)
    toks = {"tokens": torch.from_numpy(_tokens(2))}
    api = tapi.model_api(cfg)
    whole = api.loss(lm, toks)[0]                  # one chunk of 40
    for chunk in (7, 24, 40):
        np.testing.assert_allclose(float(api.loss(lm, toks,
                                                  loss_chunk=chunk)[0]),
                                   float(whole), rtol=1e-6)


def test_lm_loss_refuses_frontend_tokens(ref):
    """Named for the refusal it held while the vision frontend was not
    ported: the loss now takes ``extra_embeds`` (the captioner has no
    ``vis_proj``, so they go in front unprojected, their positions labelled
    -1), and this holds it to the reference's loss on the same batch, f32."""
    r = ref["f32"]
    cfg, lm = _port(r)
    rng = np.random.default_rng(15)
    toks = _tokens(15)
    extra = rng.normal(size=(B, 6, 128)).astype(np.float32)
    want = japi.model_api(r["jcfg"]).loss(
        r["params"], {"tokens": jnp.asarray(toks),
                      "extra_embeds": jnp.asarray(extra)}, loss_chunk=CHUNK)
    got = tapi.model_api(cfg).loss(lm, {"tokens": torch.from_numpy(toks),
                                        "extra_embeds": torch.from_numpy(
                                            extra)}, loss_chunk=CHUNK)
    for g, w, what in ((got[0], want[0], "loss"),
                       (got[1]["ce"], want[1]["ce"], "ce")):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=what,
                                   **LOSS_TOL["f32"])


def test_forward_matches_the_reference(ref):
    r = ref["f32"]
    toks = _tokens(3)
    want = japi.model_api(r["jcfg"]).forward(r["params"],
                                             {"tokens": jnp.asarray(toks)})
    cfg, lm = _port(r)
    got = tapi.model_api(cfg).forward(lm, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), _np(want), **LOSS_TOL["f32"])


def _port_grads(cfg, lm, toks, **kw):
    _, _, grads = tsteps.loss_and_grads(
        lambda p, b: tapi.model_api(cfg).loss(p, b, loss_chunk=CHUNK), lm,
        {"tokens": torch.from_numpy(toks)}, **kw)
    return grads


def test_every_gradient_matches_jax_grad_f32(ref):
    r = ref["f32"]
    toks = _tokens(4)
    want = convert.lm_params_from_numpy(
        r["tcfg"], _jtree_np(r["grad"](r["params"], jnp.asarray(toks))),
        device="cpu").tree()
    cfg, lm = _port(r, trainable=True)
    got = dict(tcm.leaves(_port_grads(cfg, lm, toks)))
    want = dict(tcm.leaves(want))
    assert sorted(got) == sorted(want) and len(got) == 2 + 2 * 9
    for path in want:
        np.testing.assert_allclose(_np(got[path]), _np(want[path]),
                                   err_msg=path, **GRAD_TOL)


def test_remat_gives_the_same_gradients(ref):
    toks = _tokens(5)
    cfg, lm = _port(ref["f32"], trainable=True)
    plain = _port_grads(cfg, lm, toks)
    cfg_r = cfg.replace(remat=True)
    remat = _port_grads(cfg_r, lm, toks)
    for (path, a), (_, b) in zip(tcm.leaves(plain), tcm.leaves(remat)):
        assert torch.equal(a, b), path


def test_serving_parameters_stay_frozen(ref):
    cfg, lm = _port(ref["f32"])
    assert not any(p.requires_grad for p in lm.parameters())
    lm.requires_grad_(True)
    assert all(p.requires_grad for p in lm.parameters())


# ------------------------------------------------------ attention gradient
def _attn_inputs(b, s, h, kv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh),
                          (b, s, h, dh))]


ATTN_CASES = {                   # (B, S, H, Kv, dh, causal, window, softcap)
    "causal": (2, 40, 6, 2, 32, True, 0, 0.0),
    "window": (1, 50, 3, 3, 16, True, 9, 0.0),
    "softcap": (2, 33, 4, 4, 32, True, 0, 5.0),
    "non_causal_ragged": (1, 37, 2, 2, 16, False, 0, 0.0),
    "gqa_g3_all_options": (1, 45, 6, 2, 16, True, 12, 3.0),
    "g1": (2, 24, 3, 3, 8, True, 0, 0.0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_bwd_plain_matches_jax_vjp(case):
    Bq, Sq, H, Kv, dh, causal, window, cap = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(Bq, Sq, H, Kv, dh, seed=len(case))
    kw = dict(causal=causal, window=window, softcap=cap)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)

    # blocked_attention (GQA, the model layout); q_chunk / k_chunk smaller
    # than S so its padding and masks of keys past S run
    _, vjp = jax.vjp(lambda a, b_, c: jattn.blocked_attention(
        a, b_, c, causal=causal, window=window, softcap_val=cap,
        q_chunk=16, k_chunk=16), *map(jnp.asarray, (q, k, v)))
    for g, w, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        np.testing.assert_allclose(_np(g), np.asarray(w), err_msg=f"d{name}",
                                   **ATTN_GRAD_TOL)

    # flash_attention_ref ([H, S, dh] per batch slice, no GQA: kv heads
    # repeated, their gradients summed over each group)
    G = H // Kv
    for b in range(Bq):
        kr, vr = (np.repeat(a[b], G, axis=1) for a in (k, v))
        _, vjp = jax.vjp(lambda a, b_, c: jref.flash_attention_ref(
            a, b_, c, **kw), *(jnp.asarray(x.transpose(1, 0, 2))
                               for x in (q[b], kr, vr)))
        dq, dk, dv = (np.asarray(x).transpose(1, 0, 2)
                      for x in vjp(jnp.asarray(do[b].transpose(1, 0, 2))))
        dk = dk.reshape(Sq, Kv, G, dh).sum(axis=2)
        dv = dv.reshape(Sq, Kv, G, dh).sum(axis=2)
        for g, w, name in zip(got, (dq, dk, dv), "qkv"):
            np.testing.assert_allclose(_np(g[b]), w, err_msg=f"d{name}",
                                       **ATTN_GRAD_TOL)

    # torch.autograd through the plain forward
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(tfa.flash_attention_plain(*leaves, **kw),
                               leaves, tdo)
    for g, w, name in zip(got, auto, "qkv"):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"d{name}",
                                   **ATTN_GRAD_TOL)


def test_flash_attention_bwd_plain_keeps_the_dtype_and_rounds_p_in_bf16():
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _attn_inputs(1, 30, 2, 1, 16, seed=9))
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    got = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse)
    assert all(g.dtype == torch.bfloat16 for g in got)
    f32 = tfa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o,
                                                             do)), lse)
    for g, w in zip(got, f32):
        np.testing.assert_allclose(_np(g), _np(w), rtol=3e-2, atol=3e-2)


def test_flash_attention_bwd_plain_rounds_ds_in_bf16():
    """In bf16, ds is rounded to bf16 before dq and dk (the kernel's
    tensor cores take bf16 operands): the plain version's dq and dk are,
    up to f32 against f64 arithmetic, a float64 gradient from the rounded
    ds, and differ from one without that rounding."""
    B_, S_, H, Kv, dh = 1, 48, 4, 2, 32
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _attn_inputs(B_, S_, H, Kv, dh, seed=11))
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    dq, dk, _ = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse)

    G = H // Kv
    qd, od, gd = (t.double() for t in (q, o, do))
    kr, vr = (t.double().repeat_interleave(G, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bthd->bhqt", qd, kr) * dh ** -0.5
    keep = torch.ones(S_, S_, dtype=torch.bool).tril()
    p = torch.where(keep, torch.exp(s - lse.double()[..., None]), 0.0)
    dp = torch.einsum("bqhd,bthd->bhqt", gd, vr)
    dsum = (gd * od).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - dsum) * dh ** -0.5

    def mismatch(got, want):
        return float((got != want.to(torch.bfloat16)).double().mean())

    for rounded, bound in ((True, 0.02), (False, None)):
        d = ds.to(torch.bfloat16).double() if rounded else ds
        dq_ref = torch.einsum("bhqt,bthd->bqhd", d, kr)
        dk_ref = torch.einsum("bhqt,bqhd->bthd", d, qd).reshape(
            B_, S_, Kv, G, dh).sum(3)
        m = mismatch(dq, dq_ref), mismatch(dk, dk_ref)
        if rounded:
            assert max(m) <= bound, m
        else:
            assert min(m) >= 0.1, m


def test_flash_attention_saves_the_lse_only_under_grad(monkeypatch):
    """Under grad ``FlashAttention`` asks the forward for its lse and
    saves it beside q, k, v and o; a ``no_grad`` or frozen forward never
    asks for it."""
    asked = []
    real = tfa.flash_attention_plain

    def spy(*args, **kw):
        asked.append(kw.get("return_lse", False))
        return real(*args, **kw)

    monkeypatch.setattr(tfa, "flash_attention_plain", spy)
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(2, 20, 4, 2, 16,
                                                            seed=5))
    qg = q.clone().requires_grad_()
    out = ops.flash_attention_bshd(qg, k, v, window=7)
    assert asked == [True]
    _, want = real(q, k, v, window=7, return_lse=True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].dtype == torch.float32
    assert torch.equal(saved[4], want)
    torch.autograd.grad(out, qg, do)
    with torch.no_grad():
        ops.flash_attention_bshd(qg, k, v)
    ops.flash_attention_bshd(q, k, v)                       # frozen inputs
    assert asked == [True, False, False]


def test_ops_routes_through_the_autograd_function_only_with_grad():
    q, k, v, _ = (torch.from_numpy(a) for a in _attn_inputs(1, 20, 2, 2, 16,
                                                            seed=3))
    before = ops.launch_counts()
    plain = ops.flash_attention_bshd(q, k, v)
    assert plain.grad_fn is None
    assert torch.equal(plain, tfa.flash_attention_plain(q, k, v))
    qg = q.clone().requires_grad_()
    out = ops.flash_attention_bshd(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert ops.flash_attention_bshd(qg, k, v).grad_fn is None
    torch.autograd.grad(out.sum(), qg)
    assert ops.launch_counts() == before         # CPU tensors launch nothing
    assert "flash_attention_bwd" in before


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_attention_plain_lse_is_the_masked_logsumexp(case, dtype):
    """``return_lse=True`` leaves o's bits as they are and returns each
    row's log-sum-exp over the masked, softcapped, scaled scores."""
    Bq, Sq, H, Kv, dh, causal, window, cap = ATTN_CASES[case]
    q, k, v, _ = _attn_inputs(Bq, Sq, H, Kv, dh, seed=len(case) + 1)
    kw = dict(causal=causal, window=window, softcap=cap)
    tq, tk, tv = (torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(o, tfa.flash_attention_plain(tq, tk, tv, **kw))
    assert lse.shape == (Bq, H, Sq) and lse.dtype == torch.float32

    qd, kd = (t.double().numpy() for t in (tq, tk))
    s = np.einsum("bqhd,bthd->bhqt", qd,
                  np.repeat(kd, H // Kv, axis=2)) * dh ** -0.5
    if cap:
        s = np.tanh(s / cap) * cap
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sq)[None, :]
    keep = np.ones((Sq, Sq), bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= qpos - kpos < window
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, **ATTN_GRAD_TOL)


# ------------------------------------------------------------------- AdamW
def test_adamw_matches_the_reference_over_three_steps(ref):
    r = ref["bf16"]
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1,
                clip_norm=0.5)
    jo = jadamw.AdamWConfig(**ocfg)
    to = tadamw.AdamWConfig(**ocfg)
    jp = r["params"]
    jopt = jadamw.init_opt_state(jp, jo)
    cfg, lm = _port(r)
    topt = tadamw.init_opt_state(lm, to)
    rng = np.random.default_rng(7)
    upd = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, jo))
    for step in range(3):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (
            0.3 + step)).astype(np.float32), _jtree_np(jp))
        jp, jopt, jm = upd(jax.tree.map(jnp.asarray, grads), jopt, jp)
        tg = convert.lm_params_from_numpy(cfg.replace(dtype=torch.float32),
                                          grads, device="cpu").tree()
        lm, topt, tm = tadamw.adamw_update(tg, topt, lm, to)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       err_msg=key, **OPT_TOL)
    assert int(topt.step) == int(jopt.step) == 3
    assert topt.step.dtype == torch.int32
    got = convert.opt_state_to_numpy(topt, cfg)
    for field in ("master", "m", "v"):
        for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(
                getattr(got, field))[0],
                jax.tree.leaves(getattr(jopt, field))):
            np.testing.assert_allclose(g, np.asarray(w), **OPT_TOL,
                                       err_msg=f"{field} {path}")
    back = convert.lm_params_to_numpy(lm)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(jp)):
        # written back in bf16: equal but where the f32 masters straddle a
        # rounding boundary, one bf16 ulp
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=8e-3,
                                   atol=1e-6, err_msg=str(path))
    assert all(p.dtype == torch.bfloat16 for p in lm.parameters())


def test_decay_mask_per_name(ref):
    r = ref["f32"]
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            jadamw._decay_mask(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(
                r["params"])[0]}
    _, lm = _port(r)
    got = {p: tadamw._decay_mask(p) for p, _ in tcm.leaves(lm.tree())}
    names = lambda d: {p.rsplit("/", 1)[-1]: v for p, v in d.items()}  # noqa
    assert names(got) == names(want)
    assert names(got)["ln1_scale"] is False and names(got)["wq"] is True
    for suffix in jadamw._NO_DECAY_SUFFIXES:
        assert tadamw._decay_mask(f"layers/0/{suffix}") is False


@pytest.mark.parametrize("step", [0, 3, 10, 11, 55, 100, 130])
def test_lr_schedule_matches_the_reference(step):
    ocfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = jadamw.lr_schedule(jnp.asarray(step, jnp.int32),
                              jadamw.AdamWConfig(**ocfg))
    got = tadamw.lr_schedule(torch.tensor(step, dtype=torch.int32),
                             tadamw.AdamWConfig(**ocfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **OPT_TOL)


# ------------------------------------------------------ int8 compression
def test_compress_int8_is_bit_equal():
    rng = np.random.default_rng(11)
    g = rng.normal(size=(257, 33)).astype(np.float32)
    g[0, :4] = [1.0, -1.0, 0.5 / 127, 1.5 / 127]       # half-way cases
    for x in (g, np.zeros((5,), np.float32), g[:1, :3] * 1e-20):
        jq, js = jcoll.compress_int8(jnp.asarray(x))
        tq, ts = tcoll.compress_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert np.float32(ts).view(np.int32) == np.asarray(js).view(np.int32)
        np.testing.assert_array_equal(
            tcoll.decompress_int8(tq, ts).numpy(),
            np.asarray(jcoll.decompress_int8(jq, js)))


def test_compress_grads_ef_is_bit_equal_over_steps():
    rng = np.random.default_rng(12)
    shapes = {"a": (31, 7), "b": {"c": (5,), "d": (3, 3)}}
    jtree = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple))
    jef = jcoll.init_ef(jtree)
    tef = tcoll.init_ef(jax.tree.map(torch.from_numpy, jtree))
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32), jtree)
        jd, jef = jcoll.compress_grads_ef(jax.tree.map(jnp.asarray, g), jef)
        td, tef = tcoll.compress_grads_ef(jax.tree.map(torch.from_numpy, g),
                                          tef)
        for a, b in zip(jax.tree.leaves(jd) + jax.tree.leaves(jef.residual),
                        jax.tree.leaves(jax.tree.map(
                            lambda t: t.numpy(), (td, tef.residual)))):
            np.testing.assert_array_equal(b, np.asarray(a))
    assert tcoll.compressed_bytes(td) == jcoll.compressed_bytes(jd) == \
        31 * 7 + 5 + 9 + 12


# ---------------------------------------------------------------- the step
def test_grad_accum_step_matches_build_train_step(ref):
    """The reference's train step with grad_accum = 2, built for a 1 x 1
    CPU mesh, against the port's, from the same parameters, optimizer
    state and batch."""
    r = ref["f32"]
    jcfg = r["jcfg"].replace(grad_accum=2)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jstep, _ = jsteps.build_train_step(jcfg, mesh, ShapeCell("t", S, 4,
                                                             "train"),
                                       jadamw.AdamWConfig(**ocfg))
    toks = _tokens(13, b=4)
    jp = _fresh(r["params"])
    jopt = _fresh(jadamw.init_opt_state(r["params"],
                                        jadamw.AdamWConfig(**ocfg)))
    with mesh:
        jp, jopt, jm = jstep(jp, jopt, {"tokens": jnp.asarray(toks)})

    cfg, lm = _port(r, trainable=True, grad_accum=2)
    to = tadamw.AdamWConfig(**ocfg)
    step = tsteps.build_train_step(cfg, to)
    lm, topt, tm = step(lm, tadamw.init_opt_state(lm, to),
                        {"tokens": torch.from_numpy(toks)})
    assert sorted(tm) == sorted(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   err_msg=key, rtol=1e-5, atol=1e-6)
    got = convert.opt_state_to_numpy(topt, cfg)
    for g, w in zip(jax.tree.leaves(got.m), jax.tree.leaves(jopt.m)):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL)
    # Adam's first step moves a weight by about lr * g / (|g| + eps): where
    # |g| is near eps (1e-8) the step follows g's rounding noise, so the
    # parameters are held to 5 % of lr (1e-3) absolute
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(lm)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=5e-5)


def test_grad_accum_equals_the_whole_batch_gradient(ref):
    """Two microbatches of 2 average to the gradient of the batch of 4
    (each microbatch's loss is its own token mean, and here both have the
    same token count)."""
    cfg, lm = _port(ref["f32"], trainable=True)
    toks = _tokens(14, b=4)
    whole = _port_grads(cfg, lm, toks)
    accum = _port_grads(cfg, lm, toks, accum=2)
    for (path, a), (_, b) in zip(tcm.leaves(whole), tcm.leaves(accum)):
        np.testing.assert_allclose(_np(b), _np(a), err_msg=path, **GRAD_TOL)
        assert b.dtype == torch.float32
