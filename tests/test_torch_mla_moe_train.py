"""Training the port's DeepSeek decoder (MLA + MoE) against the JAX reference
on the CPU.

The reference trains these configs with ``jax.value_and_grad`` of
``repro.models.lm.lm_loss``: its attention gradient is ``jax.grad`` of the
jnp ``blocked_attention`` and its MoE gradient goes through the dispatch's
``.at[slot].set(mode="drop")`` / ``.at[slot].get(mode="fill")``.  The port
runs autograd over the same modules, with the flash gradient's plain
version (``flash_attention_bwd_plain``) at MLA's head widths on CPU
tensors.  Inputs are numpy, seeded; whole models start from the
reference's own initialised parameters (``convert.lm_params_from_numpy``).

Tolerances, each with its reason:
  * the attention gradient at (48, 32) and (192, 128) against ``jax.vjp``
    2e-5 (``ATTN_GRAD_TOL`` of ``test_torch_train.py``: f32 scores summed
    in another order);
  * whole-model gradients in f32 rtol 1e-4 / atol 2e-6 (``GRAD_TOL`` of
    ``test_torch_train.py``: the same arithmetic in another order through
    an autodiff of another framework); losses 1e-5;
  * a module's gradients (of ``sum(y * r)``, whose gradients reach
    magnitude 5 where the loss's stay near 1e-2) rtol 1e-4 and an absolute
    error of 1e-6 of each array's largest magnitude (``MODULE_TOL``): sums
    in another order in f32 err by about 1e-7 of their terms per add, so
    an entry that cancels to near zero keeps an error of the terms' size
    (measured: 2.3e-6 at a largest gradient of 5);
  * bf16 losses 3e-2 (``LOSS_TOL``: bf16 rounds at other points in the two
    frameworks).  In bf16 a ulp can flip a route, so there the port's MoE
    calls take the reference's expert ids of the same call (weights and
    probabilities stay the port's own, so the router keeps its gradient);
  * AdamW 1e-6 relative / 1e-8 absolute (``OPT_TOL``: the same f32
    operations one by one);
  * the two trainers from one checkpoint: masters rtol 1e-4 / atol 1e-6
    after two steps and logged losses within 2e-4, as
    ``test_torch_ckpt.py`` holds the captioner's.
Expert ids are held exactly at every MoE call in f32.
"""
import dataclasses
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
from repro.models import mla as jmla
from repro.models import moe as jmoe
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
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw as tadamw

V3, V2 = "deepseek-v3-671b", "deepseek-v2-236b"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
LOSS_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
            "bf16": dict(rtol=3e-2, atol=3e-2)}
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
ATTN_GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
OPT_TOL = dict(rtol=1e-6, atol=1e-8)
MODULE_TOL = dict(rtol=1e-4, atol_of_max=1e-6)
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


def _spec_params(specs, seed):
    """Numpy-seeded f32 parameters for a reference spec dict, normal /
    sqrt(fan_in) (norm scales 0.1 normal), as the init draws them."""
    rng = np.random.default_rng(seed)
    return {k: _normal(rng, specs[k].shape, 0.1 if k.endswith("scale")
                       else specs[k].shape[-2] ** -0.5)
            for k in sorted(specs)}


def _scaled_close(got, want, what):
    """rtol 1e-4 and an absolute error of 1e-6 of the array's largest
    magnitude (``MODULE_TOL``)."""
    w = _np(want)
    _close(got, w, what, dict(rtol=MODULE_TOL["rtol"], atol=MODULE_TOL[
        "atol_of_max"] * float(np.abs(w).max())))


def _grads_close(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k in want:
        _scaled_close(got[k], want[k], f"{what} d{k}")


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


# ------------------------------------------------------ attention gradient
@pytest.mark.parametrize("causal,S", [(True, 70), (False, 45)],
                         ids=["causal", "ragged"])
@pytest.mark.parametrize("dqk,dv", [(48, 32), (192, 128)])
def test_flash_bwd_plain_at_mla_widths_matches_jax_vjp(dqk, dv, causal, S):
    """dq, dk at q's width and dv at v's, the scale dqk^-0.5, against
    ``jax.vjp`` of the reference's ``blocked_attention`` (chunks of 16, so
    its padded keys past S are masked in the ragged non-causal case)."""
    rng = np.random.default_rng(dqk + S)
    q, k = (_normal(rng, (2, S, 2, dqk)) for _ in range(2))
    v, do = (_normal(rng, (2, S, 2, dv)) for _ in range(2))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal,
                                       return_lse=True)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse,
                                        causal=causal)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    _, vjp = jax.vjp(lambda a, b, c: jattn.blocked_attention(
        a, b, c, causal=causal, q_chunk=16, k_chunk=16),
        *map(jnp.asarray, (q, k, v)))
    for g, w, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        _close(g, w, f"d{name}", ATTN_GRAD_TOL)


def test_flash_autograd_at_another_v_width_is_the_plain_gradient():
    """``FlashAttention`` at (48, 32) on CPU tensors: the forward saves the
    plain forward's lse, and its backward returns
    ``flash_attention_bwd_plain``'s bits on that lse."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(_normal(rng, (2, 40, 4, 48))) for _ in range(2))
    v, do = (torch.from_numpy(_normal(rng, (2, 40, 4, 32)))
             for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention_bshd(*leaves, causal=True)
    o, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    assert torch.equal(out.detach(), o)
    assert torch.equal(out.grad_fn.saved_tensors[4], lse)
    grads = torch.autograd.grad(out, leaves, do)
    direct = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse)
    for a, b in zip(grads, direct):
        assert a.shape == b.shape and torch.equal(a, b)


# --------------------------------------------------------------- moe grads
MOE_CASES = {                     # (n_groups, capacity_factor, tied router)
    "one_group": (1, None, False),
    "two_groups_drops": (2, 0.3, False),
    "tied_probabilities_drops": (1, 0.5, True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_gradients_match_jax_grad(case, monkeypatch):
    """d(sum(y * r) + aux) for x, the router, the experts and the shared
    experts, f32, with the same expert ids at every call; the capacity
    cases drop copies (whose gradient is zero in both), the tied router
    gives every token two experts of equal probability."""
    n_groups, cap, tie = MOE_CASES[case]
    jcfg = jget_config(V3 + "-smoke").replace(dtype=jnp.float32)
    tcfg = get_config(V3 + "-smoke").replace(dtype=torch.float32)
    if cap is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=cap))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe,
                                                    capacity_factor=cap))
    npar = _spec_params(jmoe.moe_param_specs(jcfg), 21)
    if tie:              # experts 2, 3 copy 0, 1: every top-2 is a tie
        npar["router"][:, 2:] = npar["router"][:, :2]
    rng = np.random.default_rng(22)
    x, r = _normal(rng, (3, 12, 128)), _normal(rng, (3, 12, 128))
    spy = _Routes(monkeypatch)

    def jloss(p, x):
        y, st = jmoe.moe_apply(p, x, jcfg, n_groups=n_groups)
        return jnp.sum(y * r) + st.aux_loss, st.dropped_frac

    (jl, jdrop), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(a) for k, a in npar.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in npar.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, st = tmoe.moe_apply(tp, tx, tcfg, n_groups=n_groups)
    tl = torch.sum(y * torch.from_numpy(r)) + st.aux_loss
    grads = torch.autograd.grad(tl, [tx, *tp.values()])
    spy.check(case, 1)
    assert float(st.dropped_frac) == pytest.approx(float(jdrop), abs=1e-7)
    if cap is not None:
        assert float(st.dropped_frac) > 0
    _close(tl, jl, "loss", LOSS_TOL["f32"])
    _scaled_close(grads[0], jgx, "dx")
    _grads_close(dict(zip(tp, grads[1:])), dict(jgp), case)


@pytest.mark.parametrize("q_lora", [64, 0], ids=["q_lora", "wq"])
def test_mla_mixer_prefill_gradients_match_jax_grad(q_lora):
    """d sum(y * r) of the prefill mixer (no cache: the training path) for
    x and every MLA parameter, f32; the rope key all heads share sums its
    gradient over the heads."""
    jcfg = jget_config(V3 + "-smoke").replace(dtype=jnp.float32)
    tcfg = get_config(V3 + "-smoke").replace(dtype=torch.float32)
    jcfg = jcfg.replace(mla=dataclasses.replace(jcfg.mla, q_lora_rank=q_lora))
    tcfg = tcfg.replace(mla=dataclasses.replace(tcfg.mla, q_lora_rank=q_lora))
    npar = _spec_params(jmla.mla_param_specs(jcfg), 23)
    assert ("wq" in npar) == (q_lora == 0)
    rng = np.random.default_rng(24)
    B, S = 2, 37
    x, r = _normal(rng, (B, S, 128)), _normal(rng, (B, S, 128))

    def jloss(p, x):
        y, _ = jmla.mla_mixer(p, x, jcfg, positions=jnp.arange(S)[None])
        return jnp.sum(y * r)

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(a) for k, a in npar.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(a).requires_grad_() for k, a in npar.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, cache = tmla.mla_mixer(tp, tx, tcfg, positions=torch.arange(S)[None])
    assert cache is None
    tl = torch.sum(y * torch.from_numpy(r))
    grads = torch.autograd.grad(tl, [tx, *tp.values()])
    _close(tl, jl, "loss", LOSS_TOL["f32"])
    _scaled_close(grads[0], jgx, "dx")
    _grads_close(dict(zip(tp, grads[1:])), dict(jgp), f"q_lora {q_lora}")


# ------------------------------------------------------------ whole models
_REF: dict = {}


def _ref(name, dtype):
    """(reference cfg, its initialised parameters, jitted value_and_grad of
    lm_loss, port cfg), made once per (config, dtype) for the file."""
    key = (name, dtype)
    if key not in _REF:
        jcfg = jget_config(name).replace(dtype=JDT[dtype])
        tcfg = get_config(name).replace(dtype=TDT[dtype])
        api = japi.model_api(jcfg)
        params = jax.jit(api.init)(jax.random.key(0))
        vg = jax.jit(jax.value_and_grad(
            lambda p, t: api.loss(p, {"tokens": t}), has_aux=True))
        _REF[key] = (jcfg, params, vg, tcfg)
    return _REF[key]


def _port_lm(tcfg, params, **extra):
    cfg = tcfg.replace(**extra)
    lm = convert.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device="cpu")
    return cfg, lm.requires_grad_(True)


def _port_loss_and_grads(cfg, lm, toks):
    loss, metrics, grads = tsteps.loss_and_grads(
        tapi.model_api(cfg).loss, lm, {"tokens": torch.from_numpy(toks)})
    return loss, metrics, dict(tcm.leaves(grads))


def _tokens(seed, b=2, s=40):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("name", [V3, V2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_loss_and_every_gradient_match_value_and_grad(name, dtype,
                                                         monkeypatch):
    """The smoke model's loss (ce + 0.01 aux) and the gradient of every
    leaf against ``jax.value_and_grad`` of the reference's ``lm_loss``:
    f32 at ``GRAD_TOL`` with the same expert ids at every MoE call; bf16
    at ``LOSS_TOL`` with the reference's ids fed to the port."""
    jcfg, params, vg, tcfg = _ref(name + "-smoke", dtype)
    toks = _tokens(31)
    spy = _Routes(monkeypatch, feed=dtype == "bf16")
    (jl, jm), jg = vg(params, jnp.asarray(toks))
    cfg, lm = _port_lm(tcfg, params)
    tl, tm, got = _port_loss_and_grads(cfg, lm, toks)
    n_moe = cfg.n_layers - cfg.n_dense_prefix
    if dtype == "f32":
        spy.check(name, n_moe)
    tol = LOSS_TOL[dtype]
    for g, w, what in ((tl, jl, "loss"), (tm["ce"], jm["ce"], "ce"),
                       (tm["aux"], jm["aux"], "aux")):
        _close(g, w, what, tol)
    want = dict(tcm.leaves(convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jg), device="cpu").tree()))
    assert sorted(got) == sorted(want)
    assert any(p.endswith("mlp/router") for p in got)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        assert bool(torch.isfinite(got[path]).all()), path
        _close(got[path], want[path], path,
               GRAD_TOL if dtype == "f32" else tol)


@pytest.mark.parametrize("name", [V3, V2])
def test_remat_gives_the_same_gradients(name):
    """``cfg.remat`` recomputes each body period (the MoE layers) in the
    backward pass: the same loss and gradient bits, f32."""
    _, params, _, tcfg = _ref(name + "-smoke", "f32")
    toks = _tokens(32)
    cfg, lm = _port_lm(tcfg, params)
    plain = _port_loss_and_grads(cfg, lm, toks)
    remat = _port_loss_and_grads(cfg.replace(remat=True), lm, toks)
    assert torch.equal(plain[0], remat[0])
    assert sorted(plain[2]) == sorted(remat[2])
    for path, g in plain[2].items():
        assert torch.equal(g, remat[2][path]), path


def test_adamw_on_the_deepseek_tree_matches_the_reference():
    """Three AdamW steps on the bf16 v3 smoke tree: the decay mask by
    name (``router`` decays, ``q_ln_scale`` / ``kv_ln_scale`` do not), the
    f32 router's f32 parameter, master and moments, every master and
    moment and the parameters written back."""
    _, params, _, tcfg = _ref(V3 + "-smoke", "bf16")
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1,
                clip_norm=0.5)
    jo, to = jadamw.AdamWConfig(**ocfg), tadamw.AdamWConfig(**ocfg)
    want = {"/".join(str(getattr(k, "key", k)) for k in path).rsplit(
        "/", 1)[-1]: jadamw._decay_mask(path)
        for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    assert want["router"] and not want["q_ln_scale"] \
        and not want["kv_ln_scale"]
    cfg, lm = _port_lm(tcfg, params)
    lm.requires_grad_(False)
    got = {p.rsplit("/", 1)[-1]: tadamw._decay_mask(p)
           for p, _ in tcm.leaves(lm.tree())}
    assert got == want
    jp, jopt = params, jadamw.init_opt_state(params, jo)
    topt = tadamw.init_opt_state(lm, to)
    upd = jax.jit(lambda g, o, p: jadamw.adamw_update(g, o, p, jo))
    rng = np.random.default_rng(33)
    for step in range(3):
        grads = jax.tree.map(lambda a: _normal(rng, a.shape, 0.3 + step),
                             jax.tree.map(np.asarray, jp))
        jp, jopt, jm = upd(jax.tree.map(jnp.asarray, grads), jopt, jp)
        tg = convert.lm_params_from_numpy(cfg.replace(dtype=torch.float32),
                                          grads, device="cpu").tree()
        lm, topt, tm = tadamw.adamw_update(tg, topt, lm, to)
        for key in ("lr", "grad_norm"):
            _close(tm[key], jm[key], key, OPT_TOL)
    router = "layers/3/mlp/router"
    for tree in (lm.tree(), topt.master, topt.m, topt.v):
        assert dict(tcm.leaves(tree))[router].dtype == torch.float32
    got = convert.opt_state_to_numpy(topt, cfg)
    for field in ("master", "m", "v"):
        for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(
                getattr(got, field))[0],
                jax.tree.leaves(getattr(jopt, field))):
            _close(g, w, f"{field} {path}", OPT_TOL)
    back = convert.lm_params_to_tree(lm)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(jp)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        if g.dtype == torch.float32:         # the router: its f32 master
            _close(g, w, str(path), OPT_TOL)
        else:         # bf16 of f32 masters that may straddle a rounding
            np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                       rtol=8e-3, atol=1e-6,
                                       err_msg=str(path))


# ------------------------------------------------------------------ trainer
def _log(text):
    return [LOG.match(ln) for ln in text.splitlines()
            if ln.startswith("step ")]


def test_trainer_kill_resume_and_checkpoints_interchange(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``repro_torch.launch.train --arch deepseek-v3-671b-smoke`` is killed
    after step 2 of 4 (exit 42, a checkpoint at step 2); the port's rerun
    and ``repro.launch.train`` each resume a copy of it to step 4 and
    agree.  Then ``repro.launch.train`` is killed at step 2 and the port
    resumes its run.  Both configs in f32, as ``test_torch_ckpt.py`` runs
    the captioner's."""
    name = V3 + "-smoke"
    monkeypatch.setattr(jtrain, "get_config", lambda n: jget_config(
        n).replace(dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "get_config", lambda n: get_config(
        n).replace(dtype=torch.float32))
    argv = ["--arch", name, "--steps", "4", "--batch", "2", "--seq", "32",
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
    assert tckpt.latest_step(first / name) == 2
    back = tckpt.restore(first / name, 2, saved["tree"], device="cpu")
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
    data = {who: np.load(tmp_path / who / name / "opt" / "step_4" /
                         "arrays.npz") for who in ("ref", "port")}
    masters = [k for k in data["ref"].files if k.startswith("master|")]
    assert "master|body|0|mlp|router" in masters
    assert sorted(masters) == sorted(k for k in data["port"].files
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
    assert tckpt.latest_step(ref_first / name) == 4
