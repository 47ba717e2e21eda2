"""The port's mini-CLIP against the JAX reference on the CPU.

The reference's initialised parameters go through both packages
(``convert.clip_params_from_numpy``); batches are the reference's
``pair_batches`` draws.  Tolerances: the loss and its gradients in f32
within 1e-5 (the same products summed in another order, about 1e-7
measured); crops, stats and tokens exactly (the same numpy code over the
same rendered frames).  The port's own training mirrors
``tests/test_clip.py::test_clip_learns``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data.scenes import make_scene as jmake_scene
from repro.perception import clip as jclip

from repro_torch import convert
from repro_torch.data.scenes import N_CLASSES, make_scene
from repro_torch.optim import adamw as tadamw
from repro_torch.perception import clip as tclip

TOL = dict(rtol=1e-5, atol=1e-5)


def _batch(seed, n=10):
    rng = np.random.default_rng(seed)
    return {"crops": rng.random((n, tclip.CROP, tclip.CROP), np.float32),
            "stats": rng.random((n, 4), np.float32),
            "tokens": rng.integers(0, 6, size=(n, 4)).astype(np.int32)}


def test_specs_and_init_follow_the_reference():
    ccfg = tclip.ClipConfig()
    want = jclip.clip_param_specs(jclip.ClipConfig())
    got = tclip.clip_param_specs(ccfg)
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    p = tclip.init_clip_params(ccfg, device="cpu")
    jp = jclip.init_clip_params(jclip.ClipConfig(), jax.random.key(0))
    assert float(p["logit_scale"]) == float(jp["logit_scale"])
    assert float(p["logit_scale"]) == np.float32(np.log(1 / 0.07))
    assert all(v.dtype == torch.float32 for v in p.values())
    assert not p["obj_b0_bias"].any()


def test_clip_loss_and_gradients_match_the_reference():
    ccfg = jclip.ClipConfig(width=64, depth=2, embed_dim=32)
    tcfg = tclip.ClipConfig(width=64, depth=2, embed_dim=32)
    jp = jclip.init_clip_params(ccfg, jax.random.key(1))
    batch = _batch(2)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jclip.clip_loss(p, {k: jnp.asarray(v) for k, v in
                                      batch.items()}, ccfg),
        has_aux=True)(jp)
    tp = convert.clip_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tl, tm = tclip.clip_loss(tp, {k: torch.from_numpy(v) for k, v in
                                  batch.items()}, tcfg)
    tg = torch.autograd.grad(tl, list(tp.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["scale"].detach()), float(jm["scale"]),
                               **TOL)
    for (name, _), g in zip(tp.items(), tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   err_msg=name, **TOL)
    back = convert.clip_params_to_numpy({k: v.detach() for k, v in
                                         tp.items()})
    assert all(np.array_equal(back[k], np.asarray(jp[k])) for k in jp)


def test_encoders_match_the_reference():
    ccfg = jclip.ClipConfig()
    jp = jclip.init_clip_params(ccfg, jax.random.key(2))
    tp = convert.clip_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")
    b = _batch(3)
    toks = np.stack([tclip.class_tokens(c) for c in range(N_CLASSES)])
    np.testing.assert_array_equal(toks, np.stack(
        [jclip.class_tokens(c) for c in range(N_CLASSES)]))
    np.testing.assert_allclose(
        tclip.encode_text(tp, torch.from_numpy(toks), ccfg).numpy(),
        np.asarray(jclip.encode_text(jp, jnp.asarray(toks), ccfg)), **TOL)
    np.testing.assert_allclose(
        tclip.encode_object(tp, torch.from_numpy(b["crops"]),
                            torch.from_numpy(b["stats"]), ccfg).numpy(),
        np.asarray(jclip.encode_object(jp, jnp.asarray(b["crops"]),
                                       jnp.asarray(b["stats"]), ccfg)),
        **TOL)


def test_pair_batches_yield_the_reference_draws():
    kw = dict(batch=12, seed=4, h=80, w=100, n_frames=30)
    jscene, tscene = jmake_scene(n_objects=40, seed=4), make_scene(
        n_objects=40, seed=4)
    jit = jclip.pair_batches(jscene, {o.oid: o.class_id
                                      for o in jscene.objects}, **kw)
    tit = tclip.pair_batches(tscene, {o.oid: o.class_id
                                      for o in tscene.objects},
                             device="cpu", **kw)
    for _ in range(3):
        j, t = next(jit), next(tit)
        np.testing.assert_array_equal(t["class_ids"], j["class_ids"])
        for k in ("crops", "stats", "tokens"):
            assert t[k].device.type == "cpu"
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]),
                                          err_msg=k)


def test_clip_learns():
    """The port's counterpart of ``tests/test_clip.py::test_clip_learns``:
    the same shape, budget and optimizer settings."""
    ccfg = tclip.ClipConfig(width=64, depth=2, embed_dim=32)
    params = tclip.init_clip_params(ccfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    ocfg = tadamw.AdamWConfig(lr=2e-3, total_steps=80, warmup_steps=10,
                              weight_decay=0.01)
    opt = tadamw.init_opt_state(params, ocfg)
    scene = make_scene(n_objects=40, seed=4)
    classes = {o.oid: o.class_id for o in scene.objects}
    it = tclip.pair_batches(scene, classes, batch=12, h=80, w=100,
                            n_frames=30, device="cpu")
    for v in params.values():
        v.requires_grad_(True)
    losses = []
    for _ in range(80):
        b = next(it)
        b.pop("class_ids")
        loss, _ = tclip.clip_loss(params, b, ccfg)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        params, opt, _ = tadamw.adamw_update(grads, opt, params, ocfg)
        losses.append(float(loss.detach()))
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10])

    all_toks = torch.from_numpy(np.stack([tclip.class_tokens(c)
                                          for c in range(N_CLASSES)]))
    with torch.no_grad():
        te = tclip.encode_text(params, all_toks, ccfg)
        b = next(it)
        oe = tclip.encode_object(params, b["crops"], b["stats"], ccfg)
        pred = torch.argmax(oe @ te.T, dim=1).numpy()
    acc = float((pred == b["class_ids"]).mean())
    assert acc > 3.0 / N_CLASSES, f"retrieval acc {acc:.2f}"
