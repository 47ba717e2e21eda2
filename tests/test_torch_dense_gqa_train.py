"""Training the port's dense grouped-query-attention configs (gemma2-27b,
h2o-danube-3-4b, yi-9b, minitron-4b) against the JAX reference on the CPU.

The reference trains them with ``jax.value_and_grad`` of
``repro.models.lm.lm_loss``; its attention gradient is ``jax.grad`` of the
jnp ``blocked_attention``.  The port runs autograd over the same modules,
with the flash gradient's plain version (``flash_attention_bwd_plain``) on
CPU tensors: at d_head 32 in the smoke models, at h2o-danube-3's 120 in
one whole-model case and in the kernel-level cases.  Inputs are numpy,
seeded; whole models start from the reference's own initialised
parameters (``convert.lm_params_from_numpy``).  The smoke models run 40
tokens past their 32-token window, gemma2's softcaps (attention 50, final
30) and gelu, minitron's relu2, tied (gemma2, h2o) and untied (yi,
minitron) heads.

Tolerances, each with its reason (those of ``test_torch_mla_moe_train.py``):
  * the attention gradient against ``jax.vjp`` 2e-5 (``ATTN_GRAD_TOL``: f32
    scores summed in another order);
  * whole-model gradients in f32 rtol 1e-4 / atol 2e-6 (``GRAD_TOL``: the
    same arithmetic in another order through an autodiff of another
    framework); losses 1e-5;
  * bf16 losses and gradients 3e-2 (``LOSS_TOL``: bf16 rounds at other
    points in the two frameworks);
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

from repro.configs.base import get_config as jget_config
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.models import attention as jattn
from repro.optim import adamw as jadamw

from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import get_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tadamw

DENSE = ("gemma2-27b", "h2o-danube-3-4b", "yi-9b", "minitron-4b")
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOSS_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
            "bf16": dict(rtol=3e-2, atol=3e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
ATTN_GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-8)
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


# ------------------------------------------------------ attention gradient
@pytest.mark.parametrize("window,softcap", [(64, 50.0), (0, 0.0)],
                         ids=["window_softcap", "causal"])
def test_flash_bwd_plain_at_120_matches_jax_vjp(window, softcap):
    """dq, dk, dv at (120, 120), H = 4 over Kv = 2, S = 200 (past the
    window of 64), the scale 120^-0.5, against ``jax.vjp`` of the
    reference's ``blocked_attention`` (chunks of 64, S padded past 200)."""
    rng = np.random.default_rng(window + 120)
    q = _normal(rng, (1, 200, 4, 120))
    k, v = (_normal(rng, (1, 200, 2, 120)) for _ in range(2))
    do = _normal(rng, (1, 200, 4, 120))
    kw = dict(causal=True, window=window, softcap=softcap)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, **kw)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    def attn(a, b, c):
        return jattn.blocked_attention(a, b, c, causal=True, window=window,
                                       softcap_val=softcap, q_chunk=64,
                                       k_chunk=64)

    # jitted: compiling it takes less time than running it op by op
    want = jax.jit(lambda a, b, c, d: jax.vjp(attn, a, b, c)[1](d))(
        *map(jnp.asarray, (q, k, v, do)))
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, f"d{name}", ATTN_GRAD_TOL)


def test_flash_autograd_at_120_is_the_plain_gradient():
    """``ops.flash_attention_bshd`` under grad at (120, 120) on CPU
    tensors: ``FlashAttention`` saves the plain forward's lse and its
    backward returns ``flash_attention_bwd_plain``'s bits on it."""
    rng = np.random.default_rng(121)
    q, do = (torch.from_numpy(_normal(rng, (2, 70, 4, 120)))
             for _ in range(2))
    k, v = (torch.from_numpy(_normal(rng, (2, 70, 2, 120))) for _ in range(2))
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


def _ref(name, dtype, **extra):
    """(reference cfg, its initialised parameters, jitted value_and_grad of
    lm_loss, port cfg), made once per (config, dtype, extra) for the
    file."""
    key = (name, dtype, tuple(sorted(extra.items())))
    if key not in _REF:
        jcfg = jget_config(name).replace(dtype=JDT[dtype], **extra)
        tcfg = get_config(name).replace(dtype=TDT[dtype], **extra)
        api = japi.model_api(jcfg)
        # eager: at these widths faster than compiling it, the same bits
        params = api.init(jax.random.key(0))
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


def _tokens(seed, b=2, s=40):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def _ref_grads(cfg, jg):
    return dict(tcm.leaves(convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jg), device="cpu").tree()))


# gemma2's f32 case runs under remat on both sides, sharing its reference
# with the remat test below
MODEL_CASES = [(n, dt, {"remat": True} if (n, dt) == ("gemma2-27b", "f32")
                else {}) for n in DENSE for dt in ("f32", "bf16")] + [
    ("h2o-danube-3-4b", "f32", {"d_head": 120})]
CASE_TAGS = {"remat": "-remat", "d_head": "-dh120"}


@pytest.mark.parametrize(
    "name,dtype,extra", MODEL_CASES,
    ids=[f"{n}-{dt}" + "".join(CASE_TAGS[k] for k in ex)
         for n, dt, ex in MODEL_CASES])
def test_lm_loss_and_every_gradient_match_value_and_grad(name, dtype,
                                                         extra):
    """The smoke model's loss and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's ``lm_loss``: f32 at
    ``GRAD_TOL``, bf16 at ``LOSS_TOL``; gemma2's f32 under remat; h2o's
    smoke also at d_head 120, so every layer's attention runs at
    h2o-danube-3's head width."""
    jcfg, params, vg, tcfg = _ref(name + "-smoke", dtype, **extra)
    toks = _tokens(41)
    (jl, jm), jg = vg(params, jnp.asarray(toks))
    lm = _port_lm(tcfg, params)
    tl, tm, got = _port_loss_and_grads(tcfg, lm, toks)
    tol = LOSS_TOL[dtype]
    for g, w, what in ((tl, jl, "loss"), (tm["ce"], jm["ce"], "ce")):
        _close(g, w, what, tol)
    assert float(tm["aux"]) == 0.0
    want = _ref_grads(tcfg, jg)
    assert sorted(got) == sorted(want)
    assert ("lm_head" in got) == (not tcfg.tie_embeddings)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert bool(torch.isfinite(got[path]).all()), path
        _close(got[path], want[path], path,
               GRAD_TOL if dtype == "f32" else tol)


def test_remat_over_gemma2s_period_gives_the_same_gradients():
    """``remat`` over gemma2's SWA / GLOBAL period (the smoke model is one
    period): in the port the same loss and gradient bits as without it,
    and both at ``GRAD_TOL`` of the reference's ``remat=True``, f32."""
    name = "gemma2-27b-smoke"
    jcfg, params, vg, tcfg = _ref(name, "f32", remat=True)
    assert tcfg.remat and tcfg.period == tcfg.n_layers == 2
    toks = _tokens(42)
    lm = _port_lm(tcfg, params)
    remat = _port_loss_and_grads(tcfg, lm, toks)
    plain = _port_loss_and_grads(tcfg.replace(remat=False), lm, toks)
    assert torch.equal(plain[0], remat[0])
    assert sorted(plain[2]) == sorted(remat[2])
    for path, g in plain[2].items():
        assert torch.equal(g, remat[2][path]), path
    (jl, _), jg = vg(params, jnp.asarray(toks))
    _close(remat[0], jl, "loss", LOSS_TOL["f32"])
    want = _ref_grads(tcfg, jg)
    for path in want:
        _close(remat[2][path], want[path], path)


@pytest.mark.parametrize("name", ["gemma2-27b", "minitron-4b"],
                         ids=["tied", "untied"])
def test_chunked_loss_matches_one_whole_chunk(name):
    """``lm_loss`` in chunks of 16 over 40 positions (the last one padded
    with label -1): gemma2's final softcap and tied head and minitron's
    untied one give the loss of one whole chunk within 1e-6 and its
    gradients at ``GRAD_TOL``, f32."""
    _, params, _, tcfg = _ref(name + "-smoke", "f32")
    toks = {"tokens": torch.from_numpy(_tokens(44))}
    lm = _port_lm(tcfg, params)
    leaves = [t for _, t in tcm.leaves(lm.tree())]
    runs = []
    for chunk in (16, 512):
        loss, _ = tlm.lm_loss(lm, toks, tcfg, loss_chunk=chunk)
        runs.append((loss, torch.autograd.grad(loss, leaves)))
    _close(runs[0][0], runs[1][0], "loss", dict(rtol=1e-6, atol=1e-6))
    for a, b in zip(runs[0][1], runs[1][1]):
        _close(a, b, "gradient")


@pytest.mark.parametrize("name", ["gemma2-27b", "minitron-4b"],
                         ids=["tied", "untied"])
def test_adamw_on_a_dense_tree_matches_the_reference(name):
    """Three AdamW steps on the bf16 smoke tree, gemma2's tied embedding
    and minitron's untied head: the decay mask by name (norm scales do not
    decay), lr and grad norm, every master and moment and the parameters
    written back."""
    _, params, _, tcfg = _ref(name + "-smoke", "bf16")
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1,
                clip_norm=0.5)
    jo, to = jadamw.AdamWConfig(**ocfg), tadamw.AdamWConfig(**ocfg)
    lm = _port_lm(tcfg, params).requires_grad_(False)
    assert ("lm_head" in lm.tree()) == (name == "minitron-4b")
    want = sorted(jadamw._decay_mask(path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(params)[0])
    got = sorted(tadamw._decay_mask(p) for p, _ in tcm.leaves(lm.tree()))
    assert got == want and not all(got) and any(got)
    jp, jopt = params, jadamw.init_opt_state(params, jo)
    topt = tadamw.init_opt_state(lm, to)
    upd = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, jo))
    rng = np.random.default_rng(43)
    for step in range(3):
        grads = jax.tree.map(lambda a: _normal(rng, a.shape, 0.3 + step),
                             jax.tree.map(np.asarray, jp))
        jp, jopt, jm = upd(jax.tree.map(jnp.asarray, grads), jopt, jp)
        tg = convert.lm_params_from_numpy(tcfg.replace(dtype=torch.float32),
                                          grads, device="cpu").tree()
        lm, topt, tm = tadamw.adamw_update(tg, topt, lm, to)
        for key in ("lr", "grad_norm"):
            _close(tm[key], jm[key], key, OPT_TOL)
    got = convert.opt_state_to_numpy(topt, tcfg)
    for field in ("master", "m", "v"):
        for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(
                getattr(got, field))[0],
                jax.tree.leaves(getattr(jopt, field))):
            _close(g, w, f"{field} {path}", OPT_TOL)
    back = convert.lm_params_to_tree(lm)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(jp)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        # bf16 of f32 masters that may straddle a rounding
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   rtol=8e-3, atol=1e-6, err_msg=str(path))


# ------------------------------------------------------------------ trainer
def _log(text):
    return [LOG.match(ln) for ln in text.splitlines()
            if ln.startswith("step ")]


@pytest.mark.parametrize("name", ["gemma2-27b", "minitron-4b"])
def test_trainer_kill_resume_and_checkpoints_interchange(name, tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``repro_torch.launch.train --arch <name>-smoke`` is killed after
    step 2 of 4 (exit 42, a checkpoint at step 2); the port's rerun and
    ``repro.launch.train`` each resume a copy of it to step 4 and agree.
    Then ``repro.launch.train`` is killed at step 2 and the port resumes
    its run.  f32, as ``test_torch_ckpt.py`` runs the captioner's."""
    arch = name + "-smoke"
    monkeypatch.setattr(jtrain, "get_config", lambda n: jget_config(
        n).replace(dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "get_config", lambda n: get_config(
        n).replace(dtype=torch.float32))
    argv = ["--arch", arch, "--steps", "4", "--batch", "2", "--seq", "40",
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
    assert tckpt.latest_step(first / arch) == 2
    back = tckpt.restore(first / arch, 2, saved["tree"], device="cpu")
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
    data = {who: np.load(tmp_path / who / arch / "opt" / "step_4" /
                         "arrays.npz") for who in ("ref", "port")}
    masters = sorted(k for k in data["ref"].files if k.startswith("master|"))
    assert ("master|lm_head" in masters) == (name == "minitron-4b")
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
    assert tckpt.latest_step(ref_first / arch) == 4
