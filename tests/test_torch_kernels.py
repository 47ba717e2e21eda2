"""The port's kernel modules against the JAX reference on the CPU.

On a CPU tensor each kernel entry point runs its plain PyTorch version (the
CUDA kernels are held against those same plain versions on the GPU by
``chip_smoke.py``).  Here the plain versions are held against the
reference: ``lift_compact`` against ``lift_compact_xla`` and the Pallas
kernel in interpret mode (ints exact, floats rtol/atol 1e-4), and
``query_topk_bias`` against the Pallas kernel in interpret mode and
``ref.query_topk_bias_ref`` (scores 1e-5, slots exact), ties and k >
valid count included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lift_compact as jlc
from repro.kernels import query_topk as jqt
from repro.kernels import ref as jref

from repro_torch.kernels import build, ops
from repro_torch.kernels import lift_compact as tlc
from repro_torch.kernels import query_topk as tqt

LIFT_SHAPES = [   # d, h, w, stride, budget, cap, block_t (tests/test_kernels)
    (4, 24, 32, 1, 64, 4096, 256),
    (8, 48, 64, 5, 512, 4096, 512),
    (3, 20, 26, 2, 16, 32, 128),
    (6, 30, 40, 3, 100, 80, 512),     # budget > cap + non-divisible tiling
]


def _lift_inputs(d, h, w, seed):
    rng = np.random.default_rng(seed)
    depth = np.where(rng.random((h, w)) > 0.25,
                     rng.uniform(0.4, 6.0, (h, w)), 0.0).astype(np.float32)
    masks = rng.random((d, h, w)) > 0.5
    masks[d // 2] = False                     # one empty detection
    intr = np.asarray([0.9 * w, 0.9 * w, w / 2, h / 2], np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q.astype(np.float32)
    pose[:3, 3] = rng.uniform(-1, 1, 3).astype(np.float32)
    return depth, masks, intr, pose


def _assert_lift_equal(got, want):
    for name, g, w in zip(["pts", "n", "cent", "mn", "mx"], got, want):
        g, w = np.asarray(g), np.asarray(w)
        if name == "n":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=name)


@pytest.mark.parametrize("d,h,w,stride,budget,cap,block_t", LIFT_SHAPES)
def test_lift_compact_plain_matches_reference(d, h, w, stride, budget, cap,
                                              block_t):
    depth, masks, intr, pose = _lift_inputs(d, h, w, d * h + w)
    kw = dict(stride=stride, budget=budget, lift_cap=cap)
    got = [x.numpy() for x in tlc.lift_compact_plain(
        torch.from_numpy(depth), torch.from_numpy(masks),
        torch.from_numpy(intr), torch.from_numpy(pose), **kw)]
    jargs = [jnp.asarray(a) for a in (depth, masks, intr, pose)]
    _assert_lift_equal(got, jlc.lift_compact_xla(*jargs, **kw))
    _assert_lift_equal(got, jlc.lift_compact_pallas(
        *jargs, block_t=block_t, interpret=True, **kw))
    assert got[1][d // 2] == 0 and not got[0][d // 2].any()


def _topk_inputs(Q, N, E, seed, frac=0.8):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(Q, E)).astype(np.float32)
    emb = rng.normal(size=(N, E)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    bias = np.where(rng.random((Q, N)) < frac,
                    0.1 * rng.random((Q, N)), jqt.NEG).astype(np.float32)
    return qs, emb, bias


def _tie_inputs(Q, N, E):
    """Every included slot scores exactly the same (values exact in f32
    under any summation order); a third of the slots are excluded."""
    qs = np.full((Q, E), 0.5, np.float32)
    emb = np.full((N, E), 0.25, np.float32)
    bias = np.where(np.arange(N)[None, :] % 3 == 1, jqt.NEG,
                    0.0).repeat(Q, 0).astype(np.float32)
    return qs, emb, bias


def _check_topk(qs, emb, bias, k, *, block_n):
    tv, ti = ops.query_topk_bias(*(torch.from_numpy(a)
                                   for a in (qs, emb, bias)), k)
    tv, ti = tv.numpy(), ti.numpy()
    jv, ji = (np.asarray(x) for x in jqt.query_topk_bias_pallas(
        jnp.asarray(qs), jnp.asarray(emb), jnp.asarray(bias), k,
        block_n=block_n, interpret=True))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    # the oracle pads with -inf where the kernels emit NEG / -1
    rv, ri = (np.asarray(x) for x in jref.query_topk_bias_ref(
        jnp.asarray(qs), jnp.asarray(emb), jnp.asarray(bias), k))
    fin = np.isfinite(rv)
    np.testing.assert_array_equal(ti[fin], ri[fin])
    np.testing.assert_allclose(tv[fin], rv[fin], rtol=1e-5, atol=1e-5)
    assert np.all(ti[~fin] == -1) and np.all(tv[~fin] == np.float32(jqt.NEG))
    return ti


@pytest.mark.parametrize("Q,N,E,k", [(1, 100, 64, 5), (4, 1024, 128, 8),
                                     (16, 3000, 512, 10), (3, 64, 32, 3)])
def test_query_topk_bias_plain_matches_reference(Q, N, E, k):
    qs, emb, bias = _topk_inputs(Q, N, E, Q * N + E)
    _check_topk(qs, emb, bias, k, block_n=256)


def test_query_topk_bias_ties_go_to_the_lower_slot():
    qs, emb, bias = _tie_inputs(2, 300, 64)
    ti = _check_topk(qs, emb, bias, 12, block_n=128)
    want = np.nonzero(np.arange(300) % 3 != 1)[0][:12]
    np.testing.assert_array_equal(ti, np.stack([want, want]))


def test_query_topk_bias_k_past_valid_count_pads():
    qs, emb, bias = _topk_inputs(2, 256, 32, 7, frac=0.02)
    n_valid = (bias > jqt.NEG / 2).sum(1)
    k = int(n_valid.max()) + 4
    ti = _check_topk(qs, emb, bias, k, block_n=128)
    for q in range(2):
        assert (ti[q] >= 0).sum() == n_valid[q]
        assert np.all(ti[q, n_valid[q]:] == -1)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    qs, emb, bias = (torch.from_numpy(a) for a in _topk_inputs(2, 80, 16, 1))
    got = ops.query_topk_bias(qs, emb, bias, 4)
    want = tqt.query_topk_bias_plain(qs, emb, bias, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = [torch.from_numpy(a) for a in _lift_inputs(3, 12, 16, 2)]
    got = ops.lift_compact(*args, stride=2, budget=8, lift_cap=64)
    want = tlc.lift_compact_plain(*args, stride=2, budget=8, lift_cap=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts() == {"lift_compact": 0, "query_topk_bias": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    qs, emb, bias = (torch.from_numpy(a) for a in _topk_inputs(1, 8, 4, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tqt.query_topk_bias_cuda(qs, emb, bias, 2)
    args = [torch.from_numpy(a) for a in _lift_inputs(2, 8, 8, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        tlc.lift_compact_cuda(*args, budget=4)
    assert ops.launch_counts() == {"lift_compact": 0, "query_topk_bias": 0}


def test_kernel_library_is_keyed_by_source_and_lives_in_build_dir():
    for name in build.SOURCES:
        p = build.library_path(name)
        assert (build.CSRC / f"{name}.cu").is_file()
        assert p.parent == build.BUILD_DIR and p.name.startswith(name + "-")
        assert p == build.library_path(name)
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")


@pytest.mark.parametrize("bad,match", [
    (torch.zeros(4, 3, dtype=torch.float64), "dtype"),
    (torch.zeros(3, 4), "shape"),
    (torch.zeros(3, 4).T, "contiguous"),
    (torch.zeros(4, 3, device="meta"), "is on meta"),
])
def test_kernel_argument_check_refuses_what_the_kernel_does_not_take(bad,
                                                                     match):
    build.check_arg("k", "x", torch.zeros(4, 3), (torch.float32,), (4, 3),
                    torch.device("cpu"))
    with pytest.raises(ValueError, match=match):
        build.check_arg("k", "x", bad, (torch.float32,), (4, 3),
                        torch.device("cpu"))
