"""The port's vision frontend (``phi-3-vision-4.2b``) against the JAX
reference on the CPU.

A vision model takes ``extra_embeds`` [B, n_vis, d] (precomputed CLIP patch
embeddings, f32), multiplies them by ``vis_proj`` in f32 and puts them in
front of the scaled text embeddings; the causal mask and the positions run
over the whole sequence and the frontend positions predict nothing.  The
smoke model (1 layer, d 128, 4 heads of 32, 8 frontend tokens) goes
through both packages from the reference's own initialised parameters
(``convert.lm_params_from_numpy``); on CPU tensors the attention runs its
plain forward and its written-out plain gradient, at d_head 32 and, in one
case a test, at phi-3's 96.  Inputs are numpy, seeded.  Also here: the
shape cells' input specs, the flash plain versions at (96, 96), AdamW and
the trainer on the phi-3 tree.

Tolerances, each with its reason (those of ``test_torch_dense_gqa_train.py``):
  * logits and losses in f32 1e-5 (the same arithmetic summed in another
    order); bf16 3e-2 (``LOSS_TOL``: bf16 rounds at other points in the two
    frameworks);
  * gradients in f32 rtol 1e-4 / atol 2e-6 (``GRAD_TOL``: the same
    arithmetic in another order through an autodiff of another framework);
  * the attention and its gradient against ``blocked_attention`` and
    ``jax.vjp`` of it 2e-5 (``ATTN_GRAD_TOL``: f32 scores summed in another
    order);
  * AdamW 1e-6 relative / 1e-8 absolute (``OPT_TOL``: the same f32
    operations one by one);
  * the two trainers from one checkpoint: masters rtol 1e-4 / atol 1e-6
    after two steps and logged losses within 2e-4.
"""
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import ASSIGNED
from repro.configs import base as jbase
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.optim import adamw as jadamw

from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import base as tbase
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw

PHI3 = "phi-3-vision-4.2b"
SMOKE = PHI3 + "-smoke"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOSS_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
            "bf16": dict(rtol=3e-2, atol=3e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
ATTN_GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-8)
B, S, N_VIS = 2, 40, 8           # 8 frontend + 40 text positions
LOG = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) ce (\d+\.\d{4}) "
                 r"gnorm (\d+\.\d{2}) lr (\d\.\d{2}e[-+]\d{2}) tok/s \d+$")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, what="", tol=GRAD_TOL):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _batch(seed, b=B, s=S, n_vis=N_VIS, d=128):
    """(numpy tokens [b, s] int32, numpy patch embeddings [b, n_vis, d]
    f32)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 512, (b, s)).astype(np.int32),
            _normal(rng, (b, n_vis, d)))


def _jbatch(toks, extra):
    return {"tokens": jnp.asarray(toks), "extra_embeds": jnp.asarray(extra)}


def _tbatch(toks, extra):
    return {"tokens": torch.from_numpy(toks),
            "extra_embeds": torch.from_numpy(extra)}


# ------------------------------------------------------------------ configs
CONFIG_FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                 "d_head", "d_ff", "vocab_size", "rope_theta",
                 "tie_embeddings", "norm_eps", "act", "sliding_window",
                 "mixers", "mlps", "period", "n_periods", "remat",
                 "frontend", "n_frontend_tokens", "encdec",
                 "attn_logit_softcap", "final_logit_softcap", "qk_norm")


@pytest.mark.parametrize("name", [PHI3, SMOKE])
def test_config_matches_the_reference_field_by_field(name):
    """Every field the port has, ``remat`` (the reference's ArchConfig
    default, on in the full config, off in the smoke shrink), ``frontend``
    and ``n_frontend_tokens`` (576, and 8 in the smoke) among them."""
    j, t = jbase.get_config(name), tbase.get_config(name)
    for f in CONFIG_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert t.frontend == "vision" and t.remat == (name == PHI3)
    assert t.n_frontend_tokens == (576 if name == PHI3 else 8)


def _spec_tuple(specs):
    return {k: (tuple(s.shape), str(s.dtype).split(".")[-1])
            for k, s in specs.items()}


CELLS = list(jbase.SHAPES) + ["smoke", "encdec"]


@pytest.mark.parametrize("cell", CELLS)
def test_input_specs_match_the_reference(cell):
    """``input_specs`` of every config the port has, shape and dtype, for
    one cell of ``SHAPES`` (and ``SMOKE_CELL``) at a time, equal to the
    reference's; ``encdec``: the encoder-decoder branch's arithmetic
    (frames and 448 tokens to train on) over every cell, on a ported config
    marked ``encdec``."""
    names = tbase.list_configs()
    assert PHI3 in names
    cells = ([(jbase.SMOKE_CELL, tbase.SMOKE_CELL)] if cell == "smoke" else
             [(jbase.SHAPES[c], tbase.SHAPES[c]) for c in
              (jbase.SHAPES if cell == "encdec" else [cell])])
    for name in names + [n + "-smoke" for n in names]:
        jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
        if cell == "encdec":
            jcfg, tcfg = (c.replace(encdec=True) for c in (jcfg, tcfg))
        for jc, tc in cells:
            assert tc == tbase.ShapeCell(jc.name, jc.seq_len,
                                         jc.global_batch, jc.kind)
            assert _spec_tuple(tbase.input_specs(tcfg, tc)) == _spec_tuple(
                jbase.input_specs(jcfg, jc)), (name, jc.name)
    if cell == "train_4k":
        specs = tbase.input_specs(tbase.get_config(PHI3),
                                  tbase.SHAPES["train_4k"])
        assert _spec_tuple(specs) == {
            "tokens": ((256, 3520), "int32"),
            "extra_embeds": ((256, 576, 3072), "float32")}


def test_cell_is_runnable_matches_the_reference():
    """Over every assigned config and every cell, and the sets behind it."""
    assert tbase.FULL_ATTENTION_ONLY == jbase.FULL_ATTENTION_ONLY
    for arch in ASSIGNED:
        for cell in jbase.SHAPES:
            assert tbase.cell_is_runnable(arch, cell) == \
                jbase.cell_is_runnable(arch, cell), (arch, cell)
    assert not tbase.cell_is_runnable(PHI3, "long_500k")


@pytest.mark.parametrize("name", [SMOKE, "gemma2-27b-smoke"])
def test_make_inputs_shapes_dtypes_and_token_range(name):
    """``make_inputs`` on the smoke cell: the reference's shapes and dtypes,
    tokens in [0, vocab), the patch embeddings finite and about unit
    scale; the same generator seed gives the same bits."""
    tcfg, jcfg = tbase.get_config(name), jbase.get_config(name)
    got = tbase.make_inputs(tcfg, tbase.SMOKE_CELL,
                            torch.Generator().manual_seed(3), device="cpu")
    want = jbase.make_inputs(jcfg, jbase.SMOKE_CELL, jax.random.key(3))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    toks = got["tokens"]
    assert int(toks.min()) >= 0 and int(toks.max()) < tcfg.vocab_size
    assert len(torch.unique(toks)) > 50
    if "extra_embeds" in got:
        e = got["extra_embeds"]
        assert bool(torch.isfinite(e).all()) and 0.8 < float(e.std()) < 1.2
    again = tbase.make_inputs(tcfg, tbase.SMOKE_CELL,
                              torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


# ---------------------------------------------------------- attention at 96
@pytest.mark.parametrize("window,softcap", [(64, 50.0), (0, 0.0)],
                         ids=["window_softcap", "causal"])
def test_flash_plain_at_96_matches_blocked_attention_and_its_vjp(window,
                                                                 softcap):
    """``flash_attention_plain`` at (96, 96), H = 4 over Kv = 2, S = 200,
    against the reference's ``blocked_attention``, and
    ``flash_attention_bwd_plain`` on its lse against ``jax.vjp`` of it
    (chunks of 64, S padded past 200), the scale 96^-0.5."""
    rng = np.random.default_rng(window + 96)
    q = _normal(rng, (1, 200, 4, 96))
    k, v = (_normal(rng, (1, 200, 2, 96)) for _ in range(2))
    do = _normal(rng, (1, 200, 4, 96))
    kw = dict(causal=True, window=window, softcap=softcap)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]

    def attn(a, b, c):
        return jattn.blocked_attention(a, b, c, causal=True, window=window,
                                       softcap_val=softcap, q_chunk=64,
                                       k_chunk=64)

    def fwd_vjp(a, b, c, d):
        out, pull = jax.vjp(attn, a, b, c)
        return out, pull(d)

    want_o, want = jax.jit(fwd_vjp)(*map(jnp.asarray, (q, k, v, do)))
    _close(o, want_o, "o", ATTN_GRAD_TOL)
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, f"d{name}", ATTN_GRAD_TOL)


def test_flash_autograd_at_96_is_the_plain_gradient():
    """``ops.flash_attention_bshd`` under grad at (96, 96) on CPU tensors:
    ``FlashAttention`` saves the plain forward's lse and its backward
    returns ``flash_attention_bwd_plain``'s bits on it."""
    rng = np.random.default_rng(97)
    q, do = (torch.from_numpy(_normal(rng, (2, 70, 4, 96))) for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, (2, 70, 2, 96))) for _ in range(2))
    kw = dict(causal=True, window=32, softcap=50.0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention_bshd(*leaves, **kw)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert torch.equal(out.detach(), o)
    assert torch.equal(out.grad_fn.saved_tensors[4], lse)
    grads = torch.autograd.grad(out, leaves, do)
    direct = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    for a, b in zip(grads, direct):
        assert a.shape == b.shape and torch.equal(a, b)


# ------------------------------------------------------------ whole models
_REF: dict = {}


def _ref(dtype, name=SMOKE, **extra):
    """(reference cfg, its parameters, jitted value_and_grad of the loss
    and forward on a batch with patch embeddings, port cfg), made once per
    (config, dtype, extra) for the file."""
    key = (name, dtype, tuple(sorted(extra.items())))
    if key not in _REF:
        jcfg = jbase.get_config(name).replace(dtype=JDT[dtype], **extra)
        tcfg = tbase.get_config(name).replace(dtype=TDT[dtype], **extra)
        api = japi.model_api(jcfg)
        params = api.init(jax.random.key(0))
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: api.loss(p, b), has_aux=True))
        _REF[key] = (jcfg, params, vg, jax.jit(api.forward), tcfg)
    return _REF[key]


def _port_lm(cfg, params, trainable=False):
    lm = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device="cpu")
    return lm.requires_grad_(trainable)


MODEL_CASES = [("f32", {}), ("bf16", {}), ("f32", {"d_head": 96})]
MODEL_IDS = ["f32", "bf16", "f32-dh96"]


@pytest.mark.parametrize("dtype,extra", MODEL_CASES, ids=MODEL_IDS)
def test_forward_with_frontend_tokens_matches_the_reference(dtype, extra):
    """``forward`` with 8 patch embeddings in front of 40 tokens: logits
    [2, 48, 512] against ``model_api(cfg).forward`` of ``repro``; f32 at
    1e-5, bf16 at ``LOSS_TOL``; also at d_head 96, phi-3's head width."""
    jcfg, params, _, fwd, tcfg = _ref(dtype, **extra)
    toks, emb = _batch(51)
    want = fwd(params, _jbatch(toks, emb))
    got = tapi.model_api(tcfg).forward(_port_lm(tcfg, params),
                                       _tbatch(toks, emb))
    assert got.shape == (B, N_VIS + S, 512) and got.dtype == TDT[dtype]
    _close(got, want, "logits", LOSS_TOL[dtype])


@pytest.mark.parametrize("dtype,extra", MODEL_CASES, ids=MODEL_IDS)
def test_loss_and_every_gradient_match_value_and_grad(dtype, extra):
    """The loss (frontend positions labelled -1) and the gradient of every
    leaf, ``vis_proj``'s included, against ``jax.value_and_grad`` of the
    reference's ``lm_loss`` with ``extra_embeds``: f32 at ``GRAD_TOL``,
    bf16 at ``LOSS_TOL``."""
    jcfg, params, vg, _, tcfg = _ref(dtype, **extra)
    toks, emb = _batch(52)
    (jl, jm), jg = vg(params, _jbatch(toks, emb))
    lm = _port_lm(tcfg, params, trainable=True)
    tl, tm, grads = tsteps.loss_and_grads(tapi.model_api(tcfg).loss, lm,
                                          _tbatch(toks, emb))
    tol = LOSS_TOL[dtype]
    for g, w, what in ((tl, jl, "loss"), (tm["ce"], jm["ce"], "ce")):
        _close(g, w, what, tol)
    got = dict(tcm.leaves(grads))
    want = dict(tcm.leaves(convert.lm_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jg), device="cpu").tree()))
    assert sorted(got) == sorted(want) and "vis_proj" in got
    assert float(got["vis_proj"].float().abs().max()) > 0
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        _close(got[path], want[path], path,
               GRAD_TOL if dtype == "f32" else tol)


@pytest.mark.parametrize("dtype,extra", [("f32", {}), ("f32", {"d_head": 96})],
                         ids=["f32", "f32-dh96"])
def test_prefill_with_frontend_then_greedy_steps_match(dtype, extra):
    """Prefill 8 patch embeddings and 40 tokens, then 4 greedy steps at
    ``pos = n_vis + S + t`` (the cache counts the frontend tokens) in both
    packages: the same greedy tokens, logits at 1e-5; each step's logits
    equal the forward's over the whole sequence at that position."""
    jcfg, params, _, _, tcfg = _ref(dtype, **extra)
    ja, ta = japi.model_api(jcfg), tapi.model_api(tcfg)
    lm = _port_lm(tcfg, params)
    steps, L = 4, N_VIS + S + 4
    toks, emb = _batch(53)
    jl, jc = jax.jit(ja.prefill)(params, _jbatch(toks, emb),
                                 ja.init_cache(B, L))
    tl, tc = ta.prefill(lm, _tbatch(toks, emb),
                        ta.init_cache(B, L, device="cpu"))
    assert int(tc[0].length) == N_VIS + S
    jdec = jax.jit(ja.decode)
    seq, tokens = [], ([], [])
    for i in range(steps):
        _close(tl, jl, f"logits before step {i}", LOSS_TOL[dtype])
        tt = tlm.greedy_token(tl)
        jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
        tokens[0].append(tt.ravel().tolist())
        tokens[1].append(np.asarray(jt).ravel().tolist())
        seq.append(tt)
        jl, jc = jdec(params, jt, jc, N_VIS + S + i)
        tl, tc = ta.decode(lm, tt, tc, N_VIS + S + i)
    assert tokens[0] == tokens[1]
    assert int(tc[0].length) == L
    whole = ta.forward(lm, {"tokens": torch.cat([torch.from_numpy(toks)]
                                                + seq, dim=1),
                            "extra_embeds": torch.from_numpy(emb)})
    _close(tl, whole[:, -1], "last step vs whole forward", LOSS_TOL[dtype])


def test_frontend_product_is_f32_then_cast_bit_for_bit():
    """``_embed`` of a bf16 model: the frontend rows are ``extra_embeds``
    (f32) times ``vis_proj`` (bf16) formed in f32, then cast to bf16, as
    jnp's promotion forms it: equal to the reference's bit for bit, the
    text rows too.  The inputs are multiples of 2^-10 below 2 and
    ``vis_proj`` of 2^-6 below 1, so every partial sum is exact in f32 and
    the order of the sum cannot move a bit; they are not bf16 numbers, so a
    bf16 product (``extra_embeds`` rounded first) gives other bits, which
    the test also shows."""
    jcfg, params, _, _, tcfg = _ref("bf16")
    rng = np.random.default_rng(54)
    params = dict(params)
    params["vis_proj"] = jnp.asarray(
        rng.integers(-63, 64, (128, 128)) / 64.0, jnp.bfloat16)
    emb = (rng.integers(-2047, 2048, (B, N_VIS, 128)) / 1024.0).astype(
        np.float32)
    toks = _batch(54)[0]
    want = jlm._embed(params, jnp.asarray(toks), jcfg, jnp.asarray(emb))
    lm = _port_lm(tcfg, params)
    got = tlm._embed(lm, torch.from_numpy(toks), tcfg, torch.from_numpy(emb))
    assert got.dtype == torch.bfloat16 and got.shape == (B, N_VIS + S, 128)
    want = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    assert torch.equal(got, want)
    rounded = (torch.from_numpy(emb).to(torch.bfloat16)
               @ lm["vis_proj"]).to(torch.bfloat16)
    assert not torch.equal(rounded, want[:, :N_VIS])


def test_captioner_takes_frontend_tokens_unprojected():
    """A config without ``vis_proj`` (the captioner's smoke, f32, 2
    layers) takes ``extra_embeds`` and puts them in front unprojected, as
    the reference does: logits and loss at 1e-5."""
    name = "semanticxr-captioner-110m-smoke"
    jcfg, params, vg, fwd, tcfg = _ref("f32", name, n_layers=2)
    assert "vis_proj" not in params
    toks, emb = _batch(55, n_vis=5)
    lm = _port_lm(tcfg, params)
    api = tapi.model_api(tcfg)
    _close(api.forward(lm, _tbatch(toks, emb)), fwd(params,
                                                    _jbatch(toks, emb)),
           "logits", LOSS_TOL["f32"])
    (jl, _), _ = vg(params, _jbatch(toks, emb))
    _close(api.loss(lm, _tbatch(toks, emb))[0], jl, "loss", LOSS_TOL["f32"])


# -------------------------------------------------------------- training
def test_adamw_on_a_tokens_only_batch_decays_vis_proj():
    """Two AdamW steps on the phi-3 smoke tree with a tokens-only batch, as
    the reference's trainer feeds it (``jax.value_and_grad`` then
    ``repro.optim.adamw.adamw_update``), f32: ``vis_proj``'s gradient is
    zero in both packages, its master moves by weight decay alone,
    ``prod(1 - lr_t * wd)`` times its first value, as the reference's
    does; the metrics and the other masters follow the reference's (Adam's
    first steps move a weight by about lr * g / (|g| + eps), so where |g|
    is near eps the step follows g's rounding noise: 5 % of lr a step).  In bf16
    the port's zero gradient is a bf16 zero, the leaf's own dtype."""
    jcfg, params, _, _, tcfg = _ref("f32")
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4, weight_decay=0.1)
    jo, to = jadamw.AdamWConfig(**ocfg), tadamw.AdamWConfig(**ocfg)
    api = japi.model_api(jcfg)

    @jax.jit
    def jstep(p, o, t):
        (loss, m), g = jax.value_and_grad(
            lambda p: api.loss(p, {"tokens": t}), has_aux=True)(p)
        p, o, om = jadamw.adamw_update(g, o, p, jo)
        return p, o, {"loss": loss, **m, **om}, g["vis_proj"]

    lm = _port_lm(tcfg, params, trainable=True)
    tstep = tsteps.build_train_step(tcfg, to)
    jp, jopt = params, jadamw.init_opt_state(params, jo)
    topt = tadamw.init_opt_state(lm, to)
    first = topt.master["vis_proj"].clone()
    factor = 1.0
    for step in range(2):
        toks = {"tokens": torch.from_numpy(_batch(60 + step)[0])}
        jp, jopt, jm, jgv = jstep(jp, jopt, jnp.asarray(toks["tokens"]))
        grads = tsteps.loss_and_grads(tapi.model_api(tcfg).loss, lm,
                                      toks)[2]
        assert grads["vis_proj"].dtype == torch.float32
        assert not grads["vis_proj"].any()
        assert not np.asarray(jgv).any()
        lm, topt, tm = tstep(lm, topt, toks)
        assert sorted(tm) == sorted(jm)
        for key in jm:
            _close(tm[key], jm[key], key, dict(rtol=1e-5, atol=1e-6))
        factor *= 1.0 - float(tm["lr"]) * ocfg["weight_decay"]
    _close(topt.master["vis_proj"], first * factor, "decay alone", OPT_TOL)
    got = convert.opt_state_to_numpy(topt, tcfg)
    _close(got.master["vis_proj"], jopt.master["vis_proj"], "vis_proj",
           OPT_TOL)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(
            got.master)[0], jax.tree.leaves(jopt.master)):
        _close(g, w, f"master {path}", dict(rtol=1e-5, atol=1e-4))
    bcfg, bparams = _ref("bf16")[4], _ref("bf16")[1]
    grads = tsteps.loss_and_grads(
        tapi.model_api(bcfg).loss, _port_lm(bcfg, bparams, trainable=True),
        toks)[2]
    assert grads["vis_proj"].dtype == torch.bfloat16
    assert not grads["vis_proj"].any()


def test_grad_accum_splits_the_frontend_batch_like_build_train_step():
    """The reference's train step with grad_accum = 2, built for a 1 x 1
    CPU mesh on a vision cell (tokens [4, 40] and extra_embeds [4, 8,
    128]), against the port's from the same state: both split
    ``extra_embeds`` along the batch as they split the tokens; metrics,
    first moments and parameters, f32."""
    jcfg, params, _, _, tcfg = _ref("f32")
    jcfg, tcfg = (c.replace(grad_accum=2) for c in (jcfg, tcfg))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    cell = jbase.ShapeCell("t", N_VIS + S, 4, "train")
    jstep, _ = jsteps.build_train_step(jcfg, mesh, cell,
                                       jadamw.AdamWConfig(**ocfg))
    toks, emb = _batch(56, b=4)
    # buffers of their own: the donated step may not see one buffer twice
    fresh = lambda t: jax.tree.map(lambda x: jnp.asarray(np.array(x)), t)
    jp = fresh(params)
    jopt = fresh(jadamw.init_opt_state(params, jadamw.AdamWConfig(**ocfg)))
    with mesh:
        jp, jopt, jm = jstep(jp, jopt, _jbatch(toks, emb))
    lm = _port_lm(tcfg, params, trainable=True)
    to = tadamw.AdamWConfig(**ocfg)
    lm, topt, tm = tsteps.build_train_step(tcfg, to)(
        lm, tadamw.init_opt_state(lm, to), _tbatch(toks, emb))
    assert sorted(tm) == sorted(jm)
    for key in jm:
        _close(tm[key], jm[key], key, dict(rtol=1e-5, atol=1e-6))
    got = convert.opt_state_to_numpy(topt, tcfg)
    for g, w in zip(jax.tree.leaves(got.m), jax.tree.leaves(jopt.m)):
        _close(g, w, "m", GRAD_TOL)
    # Adam's first step moves a weight by about lr * g / (|g| + eps): where
    # |g| is near eps the step follows g's rounding noise (5 % of lr)
    for g, w in zip(jax.tree.leaves(convert.lm_params_to_numpy(lm)),
                    jax.tree.leaves(jp)):
        _close(g, w, "params", dict(rtol=1e-5, atol=5e-5))


def test_convert_and_checkpoints_keep_vis_proj(tmp_path):
    """``lm_params_from_numpy`` / ``lm_params_to_tree`` and the optimizer
    state's maps carry ``vis_proj`` both ways, bit for bit, and a
    checkpoint of the tree holds it under its own name."""
    _, params, _, _, tcfg = _ref("bf16")
    lm = _port_lm(tcfg, params)
    assert "vis_proj" in lm and lm["vis_proj"].shape == (128, 128)
    tree = convert.lm_params_to_tree(lm)
    assert sorted(k for k in tree if k not in ("body",)) == sorted(
        k for k in params if k not in ("body",))
    assert torch.equal(tree["vis_proj"],
                       torch.from_numpy(np.asarray(params["vis_proj"],
                                                   np.float32)).bfloat16())
    back = convert.lm_params_from_numpy(tcfg, convert.lm_params_to_numpy(lm),
                                        device="cpu")
    for (p, a), (_, b) in zip(tcm.leaves(back.tree()), tcm.leaves(lm.tree())):
        assert torch.equal(a, b), p
    opt = tadamw.init_opt_state(lm, tadamw.AdamWConfig())
    opt_back = convert.opt_state_from_numpy(
        tcfg, convert.opt_state_to_numpy(opt, tcfg), device="cpu")
    assert torch.equal(opt_back.master["vis_proj"], opt.master["vis_proj"])
    tckpt.save(tmp_path, 1, tree)
    names = np.load(tmp_path / "step_1" / "arrays.npz").files
    assert "vis_proj" in names
    got = tckpt.restore(tmp_path, 1, tree, device="cpu")
    assert torch.equal(got["vis_proj"], tree["vis_proj"])


def _log(text):
    return [LOG.match(ln) for ln in text.splitlines()
            if ln.startswith("step ")]


def test_trainer_kill_resume_and_checkpoints_interchange(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``repro_torch.launch.train --arch phi-3-vision-4.2b-smoke`` (tokens
    only, as the reference's trainer) is killed after step 2 of 4 (exit
    42, a checkpoint at step 2 holding ``vis_proj``); the port's rerun and
    ``repro.launch.train`` each resume a copy of it to step 4 and agree.
    Then ``repro.launch.train`` is killed at step 2 and the port resumes
    its run.  f32."""
    monkeypatch.setattr(jtrain, "get_config", lambda n: jbase.get_config(
        n).replace(dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "get_config", lambda n: tbase.get_config(
        n).replace(dtype=torch.float32))
    argv = ["--arch", SMOKE, "--steps", "4", "--batch", "2", "--seq", "40",
            "--ckpt-every", "2", "--log-every", "1"]
    first = tmp_path / "port_killed"
    saved = {}

    def snap(step, m, params):
        if step == 2:
            saved["tree"] = convert.lm_params_to_tree(params)

    with pytest.raises(SystemExit) as e:
        ttrain.main(argv + ["--ckpt-dir", str(first), "--kill-at", "2"],
                    device="cpu", on_step=snap)
    assert e.value.code == 42
    assert "vis_proj" in saved["tree"]
    back = tckpt.restore(first / SMOKE, 2, saved["tree"], device="cpu")
    for (p, a), (_, b) in zip(tcm.leaves(back), tcm.leaves(saved["tree"])):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    capsys.readouterr()
    for who in ("ref", "port"):
        shutil.copytree(first, tmp_path / who)
    ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "port")], device="cpu")
    port_out = capsys.readouterr().out
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    ref_out = capsys.readouterr().out
    for out in (ref_out, port_out):
        assert out.splitlines()[0] == "[restore] resuming from step 2"
        assert out.splitlines()[-1] == "training complete"
    ref_log, port_log = _log(ref_out), _log(port_out)
    assert len(ref_log) == len(port_log) == 2
    assert all(ref_log) and all(port_log), port_out
    for a, b in zip(ref_log, port_log):
        assert a.group(1) == b.group(1) and a.group(5) == b.group(5)
        for i in (2, 3):
            assert abs(float(a.group(i)) - float(b.group(i))) <= 2e-4
    data = {who: np.load(tmp_path / who / SMOKE / "opt" / "step_4" /
                         "arrays.npz") for who in ("ref", "port")}
    masters = sorted(k for k in data["ref"].files if k.startswith("master|"))
    assert "master|vis_proj" in masters
    assert masters == sorted(k for k in data["port"].files
                             if k.startswith("master|"))
    for k in masters:
        np.testing.assert_allclose(data["port"][k], data["ref"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)

    # the reference's killed run resumes in the port
    ref_first = tmp_path / "ref_killed"
    with pytest.raises(SystemExit) as e:
        jtrain.main(argv + ["--ckpt-dir", str(ref_first), "--kill-at", "2"])
    assert e.value.code == 42
    capsys.readouterr()
    ttrain.main(argv + ["--ckpt-dir", str(ref_first)], device="cpu")
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "[restore] resuming from step 2"
    assert out.splitlines()[-1] == "training complete"
    assert [m.group(1) for m in _log(out)] == ["3", "4"]
    assert tckpt.latest_step(ref_first / SMOKE) == 4
