"""The port's kernel modules against the JAX reference on the CPU.

On a CPU tensor each kernel entry point runs its plain PyTorch version (the
CUDA kernels are held against those same plain versions on the GPU by
``chip_smoke.py``).  Here the plain versions are held against the
reference: ``lift_compact`` against ``lift_compact_xla`` and the Pallas
kernel in interpret mode (ints exact, floats rtol/atol 1e-4), and
``query_topk_bias`` against the Pallas kernel in interpret mode and
``ref.query_topk_bias_ref`` (scores 1e-5, slots exact), ties and k >
valid count included.  ``flash_attention`` against the Pallas kernel in
interpret mode (f32 2e-5, bf16 2e-2: the reference's own tolerances) and,
where the Pallas kernel lets zero-padded keys into a non-causal softmax,
against ``ref.flash_attention_ref``; its log-sum-exp (``return_lse``)
against ``jax.nn.logsumexp`` of the masked scores (2e-5); the bf16 kernel's host-side pieces
(its TMA tensor-map layout and its persistent tile schedule) on their
own; ``nearest_dist`` against the Pallas
kernel in interpret mode (1e-4), 1e30 for a row with no valid neighbour.
The host-side pieces of the ``lift_compact`` and ``nearest_dist`` cluster
kernels: their work splits, numpy models of the lift kernel's ranking and
kept-slot walk (held against the plain version's cumsum and slot rule),
and the nearest kernel's reordered expansion in f32 (within 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import lift_compact as jlc
from repro.kernels import pairwise as jpw
from repro.kernels import query_topk as jqt
from repro.kernels import ref as jref

from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import lift_compact as tlc
from repro_torch.kernels import pairwise as tpw
from repro_torch.kernels import query_topk as tqt

NO_LAUNCHES = {"lift_compact": 0, "query_topk_bias": 0, "flash_attention": 0,
               "flash_attention_bwd": 0, "nearest_dist": 0, "wkv6": 0}

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
    assert ops.launch_counts() == NO_LAUNCHES


def test_cuda_wrappers_refuse_cpu_tensors():
    qs, emb, bias = (torch.from_numpy(a) for a in _topk_inputs(1, 8, 4, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tqt.query_topk_bias_cuda(qs, emb, bias, 2)
    args = [torch.from_numpy(a) for a in _lift_inputs(2, 8, 8, 0)]
    with pytest.raises(ValueError, match="CUDA"):
        tlc.lift_compact_cuda(*args, budget=4)
    assert ops.launch_counts() == NO_LAUNCHES


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


# ---------------------------------------------------------- flash_attention
def _attn_inputs(shapes, dtype, seed):
    """numpy f32 arrays of the given shapes, rounded to ``dtype``'s grid."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    if dtype == "bf16":
        arrs = [torch.from_numpy(a).bfloat16().float().numpy() for a in arrs]
    return arrs


def _to(a, dtype, lib):
    if lib == "jax":
        return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else
                           jnp.float32)
    return torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16" else
                                  torch.float32)


ATTN_TOL = {"f32": 2e-5, "bf16": 2e-2}


@pytest.mark.parametrize("h,s,dh,causal,window,softcap,dtype", [
    (2, 128, 64, True, 0, 0.0, "f32"),        # tests/test_kernels.py:75-81
    (4, 256, 64, True, 64, 0.0, "f32"),
    (2, 200, 128, True, 0, 50.0, "f32"),
    (1, 128, 64, False, 0, 0.0, "f32"),
    (2, 256, 64, True, 0, 0.0, "bf16"),
    (2, 200, 64, True, 0, 0.0, "bf16"),      # ragged S in bf16
])
def test_flash_attention_plain_matches_pallas(h, s, dh, causal, window,
                                              softcap, dtype):
    q, k, v = _attn_inputs([(h, s, dh)] * 3, dtype, s + h)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(*(_to(a, dtype, "torch") for a in (q, k, v)),
                              **kw)
    want = jfa.flash_attention_pallas(*(_to(a, dtype, "jax")
                                        for a in (q, k, v)),
                                      interpret=True, **kw)
    assert got.shape == (h, s, dh)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else
                         torch.float32)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_flash_attention_non_causal_ragged_masks_padded_keys():
    """Non-causal at S = 200 (not a multiple of the Pallas tile of 128):
    the Pallas kernel lets its 56 zero-padded keys into the softmax, the
    port masks them as ``ref.flash_attention_ref`` does."""
    q, k, v = _attn_inputs([(2, 200, 64)] * 3, "f32", 7)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False).numpy()
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    want = np.asarray(jref.flash_attention_ref(*jargs, causal=False))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    pallas = np.asarray(jfa.flash_attention_pallas(*jargs, causal=False,
                                                   interpret=True))
    assert np.abs(pallas - want).max() > 1e-2     # the reference's fault


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_gqa_reads_kv_head_h_over_g(dtype):
    """q [B, S, H, dh] against k, v [B, S, Kv, dh]: query head h reads kv
    head h // (H / Kv), as the Pallas kernel does on repeated k, v."""
    B, S, H, Kv, dh = 2, 96, 6, 2, 64
    q, k, v = _attn_inputs([(B, S, H, dh), (B, S, Kv, dh), (B, S, Kv, dh)],
                           dtype, 3)
    got = ops.flash_attention_bshd(*(_to(a, dtype, "torch")
                                     for a in (q, k, v)), window=40)
    assert got.shape == (B, S, H, dh)
    rep = [np.repeat(a, H // Kv, axis=2) for a in (k, v)]
    for b in range(B):
        want = jfa.flash_attention_pallas(
            *(_to(a[b].transpose(1, 0, 2), dtype, "jax")
              for a in (q, *rep)), window=40, interpret=True)
        np.testing.assert_allclose(
            got[b].float().numpy().transpose(1, 0, 2),
            np.asarray(want, np.float32), rtol=ATTN_TOL[dtype],
            atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("h,s,dh,causal,window,softcap,dtype", [
    (2, 128, 64, True, 0, 0.0, "f32"),
    (4, 256, 64, True, 64, 0.0, "f32"),
    (2, 200, 128, True, 0, 50.0, "f32"),
    (1, 128, 64, False, 0, 0.0, "f32"),
    (2, 200, 64, True, 0, 0.0, "bf16"),
    (3, 77, 64, False, 5, 20.0, "bf16"),
])
def test_flash_attention_plain_lse_matches_jax_logsumexp(h, s, dh, causal,
                                                         window, softcap,
                                                         dtype):
    """``return_lse=True``: the same output bits, and each row's lse equal
    (2e-5, f32 scores in another order) to ``jax.nn.logsumexp`` of the
    masked, softcapped, scaled f32 scores of the same (rounded) inputs."""
    q, k, v = _attn_inputs([(h, s, dh)] * 3, dtype, 2 * s + h)
    kw = dict(causal=causal, window=window, softcap=softcap)
    tq, tk, tv = (_to(a, dtype, "torch").transpose(0, 1)[None]
                  for a in (q, k, v))
    o, lse = tfa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(o, tfa.flash_attention_plain(tq, tk, tv, **kw))
    assert lse.shape == (1, h, s) and lse.dtype == torch.float32

    sc = jnp.einsum("hqd,hkd->hqk", jnp.asarray(q), jnp.asarray(k)) \
        * dh ** -0.5
    if softcap:
        sc = jnp.tanh(sc / softcap) * softcap
    qpos, kpos = jnp.arange(s)[:, None], jnp.arange(s)[None, :]
    keep = jnp.ones((s, s), bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= qpos - kpos < window
    want = jax.nn.logsumexp(jnp.where(keep, sc, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse[0].numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_flash_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch on CUDA tensors or raise: no fallback
    to the plain version, the lse path included."""
    q = torch.zeros(1, 64, 2, 64)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_cuda(q, q, q, q, q, lse)
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("bad,match", [
    (dict(k=torch.zeros(1, 64, 3, 64)), "multiple"),
    (dict(k=torch.zeros(1, 32, 2, 64)), "must be"),
    (dict(q=torch.zeros(64, 4, 64)), "4-D"),
])
def test_flash_attention_refuses_mismatched_shapes(bad, match):
    args = dict(q=torch.zeros(1, 64, 4, 64), k=torch.zeros(1, 64, 2, 64),
                v=torch.zeros(1, 64, 2, 64))
    args.update(bad)
    if "k" in bad:
        args["v"] = args["k"]
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention_plain(**args)


def _hsd_view(h, s, dh):
    """[1, S, H, dh] view of a contiguous [H, S, dh] tensor, as
    ``ops.flash_attention`` passes the reference's layout on."""
    return torch.zeros(h, s, dh, dtype=torch.bfloat16).transpose(0, 1)[None]


@pytest.mark.parametrize("t,dims,strides", [
    # the model's contiguous [B, S, H, dh] (the captioner's prefill q)
    (torch.zeros(8, 1024, 12, 64, dtype=torch.bfloat16), (64, 1024, 12, 8),
     (1536, 128, 1572864)),
    # k at dh 128 with GQA
    (torch.zeros(2, 333, 4, 128, dtype=torch.bfloat16), (128, 333, 4, 2),
     (1024, 256, 340992)),
    # the reference's [H, S, dh] seen as [1, S, H, dh]
    # (a size-1 batch dim keeps the stride PyTorch gives it)
    (_hsd_view(4, 200, 64), (64, 200, 4, 1), (128, 25600, 25600)),
    # h2o-danube-3's q at dh 120: the true width, 240-byte rows, the same
    # box (its second panel's columns 120-127 arrive as zeros)
    (torch.zeros(2, 5000, 32, 120, dtype=torch.bfloat16), (120, 5000, 32, 2),
     (7680, 240, 38400000)),
])
def test_flash_tma_layout_reads_the_strides(t, dims, strides):
    """dims innermost first (dh, S, heads, B), byte strides of S, heads
    and B, and a box of one 64-column panel by 128 rows."""
    assert tfa.tma_layout(t) == (dims, strides, (64, 128, 1, 1))


@pytest.mark.parametrize("t", [
    torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16)[..., :64],  # row 136 B
    torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)[..., ::2],  # dh strided
    torch.zeros(1, 64, 3, 64, dtype=torch.bfloat16)[:, :, :, 4:36],  # +8 B
    torch.zeros(1, 64, 2, 100, dtype=torch.bfloat16),      # dh 100: not 8k
    torch.zeros(1, 64, 2, 136, dtype=torch.bfloat16),      # dh 136: 3 panels
    torch.zeros(1 * 64 * 2 * 64 + 4, dtype=torch.bfloat16)[4:].view(
        1, 64, 2, 64),                                            # base + 8 B
])
def test_flash_tma_layout_refuses_what_tma_cannot_read(t):
    with pytest.raises(ValueError, match="tma_layout"):
        tfa.tma_layout(t)


@pytest.mark.parametrize("B,S,H,n_blocks", [
    (8, 1024, 12, 132),     # the captioner's prefill on an H100
    (2, 333, 12, 132),      # fewer tiles than blocks
    (1, 1025, 12, 7),       # one row past a tile, many rounds
    (3, 17, 1, 2),
])
def test_flash_tile_schedule_runs_every_tile_once_heaviest_first(B, S, H,
                                                                 n_blocks):
    """The bf16 kernel's persistent blocks together run every (query tile,
    b, h) exactly once; each block takes its tiles heaviest (latest query
    tile) first, and the blocks' causal work differs by at most one
    query tile's worth."""
    sched = tfa.tile_schedule(B, S, H, n_blocks)
    n_q = -(-S // tfa.TILE)
    tiles = [t for blk in sched for t in blk]
    assert sorted(tiles) == sorted((qt, b, h) for qt in range(n_q)
                                   for b in range(B) for h in range(H))
    for blk in sched:
        assert [t[0] for t in blk] == sorted((t[0] for t in blk),
                                             reverse=True)
    work = [sum(t[0] + 1 for t in blk) for blk in sched]
    assert max(work) - min(work) <= n_q


# ------------------------------------------------------------- nearest_dist
def _nd_inputs(m, n, d, seed, frac=0.9):
    rng = np.random.default_rng(seed)
    a = (2 * rng.normal(size=(m, d))).astype(np.float32)
    b = (2 * rng.normal(size=(n, d))).astype(np.float32)
    return a, b, rng.random(n) < frac


def _nd_pallas(a, b, bv):
    """The Pallas kernel in interpret mode, D padded to 8 as
    ``repro.kernels.ops.nearest_dist`` pads it."""
    pad = ((0, 0), (0, (-a.shape[1]) % 8))
    return np.asarray(jpw.nearest_dist_pallas(
        jnp.asarray(np.pad(a, pad)), jnp.asarray(np.pad(b, pad)),
        jnp.asarray(bv), interpret=True))


@pytest.mark.parametrize("m,n,d", [(50, 70, 3), (256, 512, 3), (1000, 333, 3),
                                   (128, 128, 8)])
def test_nearest_dist_plain_matches_pallas(m, n, d):
    a, b, bv = _nd_inputs(m, n, d, m * n)
    got = ops.nearest_dist(*(torch.from_numpy(x) for x in (a, b, bv)))
    assert got.dtype == torch.float32 and got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), _nd_pallas(a, b, bv),
                               rtol=1e-4, atol=1e-4)


def test_nearest_dist_no_valid_neighbour_is_1e30():
    """A row with no valid b gets the Pallas kernel's 1e30, where
    ``ref.nearest_dist_ref`` gives inf."""
    a, b, _ = _nd_inputs(40, 30, 3, 5)
    bv = np.zeros(30, bool)
    got = ops.nearest_dist(*(torch.from_numpy(x) for x in (a, b, bv)))
    assert np.all(got.numpy() == np.float32(tpw.INF))
    np.testing.assert_array_equal(got.numpy(), _nd_pallas(a, b, bv))
    assert np.all(np.isinf(np.asarray(jref.nearest_dist_ref(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(bv)))))


def test_new_cuda_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, q, q)
    a, b, bv = (torch.from_numpy(x) for x in _nd_inputs(4, 4, 3, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tpw.nearest_dist_cuda(a, b, bv)
    got = ops.flash_attention(q[0].transpose(0, 1), q[0].transpose(0, 1),
                              q[0].transpose(0, 1))
    assert got.shape == (2, 64, 64) and ops.launch_counts() == NO_LAUNCHES


# ------------------------------------- the CUDA kernels' host-side pieces
@pytest.mark.parametrize("h,w", [(1, 1), (20, 26), (31, 33), (144, 256),
                                 (720, 1280)])
@pytest.mark.parametrize("d", [1, 4, 32])
def test_lift_work_split_tiles_the_pixels_in_order(h, w, d):
    """The blocks of one object's cluster cover [0, H*W) in rank order, with
    no gap and no overlap; at most 8 blocks, shares of whole 16-pixel
    loads, warps of threads; at the main path's 144x256 with 32
    detections each block's share fits one register chunk."""
    sp = tlc.work_split(h, w, d)
    assert 1 <= sp.cluster <= tlc.MAX_CLUSTER == 8
    assert len(sp.ranges) == sp.cluster and sp.share % tlc.PIX == 0
    assert sp.threads % 32 == 0 and 32 <= sp.threads <= tlc.MAX_THREADS
    ends = [0] + [e for _, e in sp.ranges]
    assert [b for b, _ in sp.ranges] == ends[:-1] and ends[-1] == h * w
    assert all(b <= e and e - b <= sp.share for b, e in sp.ranges)
    if (h, w, d) == (144, 256, 32):
        assert sp.share <= sp.threads * tlc.PIX


def _kept_slots(rho0, c, nl, budget):
    """csrc/lift_compact.cu's walk over the output slots whose ranks fall
    in [rho0, rho0 + c): [(slot, rank)], the first slot from one division,
    the next ranks by stepping nl / budget with its remainder."""
    if c == 0 or rho0 >= nl:
        return []
    if nl > budget:
        i = (rho0 * budget + nl - 1) // nl
        r, rem = divmod(i * nl, budget)
        step_q, step_r = divmod(nl, budget)
    else:
        i, r, rem, step_q, step_r = rho0, rho0, 0, 1, 0
    out = []
    while r < min(rho0 + c, nl) and i < budget:
        out.append((i, r))
        i, r, rem = i + 1, r + step_q, rem + step_r
        if rem >= budget:
            r, rem = r + 1, rem - budget
    return out


def _lift_emulated(depth, masks, intr, pose, *, stride, budget, lift_cap):
    """numpy model of csrc/lift_compact.cu: per-block counts over
    ``work_split`` -> exclusive scan across the cluster -> chunks of
    ``threads * PIX`` pixels -> exclusive scan of per-thread counts ->
    bit order inside a thread; then each thread's walk over its kept slots
    and the back-projection in f32.  Returns (ranks [D, HW] (-1 where
    invalid), n_out, points)."""
    D, H, W = masks.shape
    HW = H * W
    sp = tlc.work_split(H, W, D)
    v = masks.reshape(D, HW) & (depth.reshape(HW) > tlc.Z_EPS)[None]
    counts = np.array([[v[d, b:e].sum() for b, e in sp.ranges]
                       for d in range(D)])
    bases = np.cumsum(counts, axis=1) - counts          # cluster scan
    n = np.minimum(counts.sum(axis=1), lift_cap)
    n_out = np.minimum(n, budget)
    ranks = np.full((D, HW), -1, np.int64)
    pts = np.zeros((D, budget, 3), np.float32)
    fx, fy, cx, cy = intr
    chunk = sp.threads * tlc.PIX
    for d in range(D):
        for (b, e), base in zip(sp.ranges, bases[d]):
            for c0 in range(b, e, chunk):
                flags = np.zeros(chunk, bool)
                flags[:min(chunk, e - c0)] = v[d, c0:min(c0 + chunk, e)]
                per_thread = flags.reshape(sp.threads, tlc.PIX)
                cnt = per_thread.sum(axis=1)
                thread_base = base + np.cumsum(cnt) - cnt
                bit_rank = np.cumsum(per_thread, axis=1) - per_thread
                r = (thread_base[:, None] + bit_rank).reshape(-1)
                idx = np.nonzero(flags)[0]
                ranks[d, c0 + idx] = r[idx]
                base += cnt.sum()
                for t in np.nonzero(cnt)[0]:
                    pix = c0 + t * tlc.PIX + np.nonzero(per_thread[t])[0]
                    for slot, rank in _kept_slots(int(thread_base[t]),
                                                  int(cnt[t]), int(n[d]),
                                                  budget):
                        p = pix[rank - thread_base[t]]
                        z = depth.reshape(HW)[p]
                        xf = np.float32((p % W + 0.5) * stride)
                        yf = np.float32((p // W + 0.5) * stride)
                        cam = np.array([(xf - cx) / fx * z,
                                        (yf - cy) / fy * z, z], np.float32)
                        pts[d, slot] = pose[:3, :3] @ cam + pose[:3, 3]
    return ranks, n_out.astype(np.int32), pts


def test_lift_kept_slot_walk_equals_the_slot_rule():
    """Stepping r(i) = floor(i * n / budget) from the first slot keeps
    exactly the ranks the reference's slot rule keeps (slot = ceil(r *
    budget / n), kept iff it maps back to r), for every rank window."""
    for nl, budget in [(4096, 2000), (80, 100), (32, 16), (4096, 16),
                       (2001, 2000), (7, 7), (1, 5)]:
        want = {}
        for rho in range(nl):
            if nl > budget:
                slot = -(-rho * budget // nl)
                if slot * nl // budget == rho and slot < budget:
                    want[slot] = rho
            elif rho < budget:
                want[rho] = rho
        got = {}
        for rho0 in range(0, nl + 20, 13):
            got.update(_kept_slots(rho0, 13, nl, budget))
        assert got == want


@pytest.mark.parametrize("d,h,w,stride,budget,cap,block_t", LIFT_SHAPES)
def test_lift_cluster_ranking_matches_the_plain_cumsum(d, h, w, stride,
                                                       budget, cap, block_t):
    """The kernel's ranking (block counts, cluster scan, in-block scan)
    gives every valid pixel the rank of the plain version's cumsum, and
    the slot rule on those ranks gives its points and counts."""
    depth, masks, intr, pose = _lift_inputs(d, h, w, d * h + w)
    kw = dict(stride=stride, budget=budget, lift_cap=cap)
    ranks, n_out, pts = _lift_emulated(depth, masks, intr, pose, **kw)
    v = masks.reshape(d, -1) & (depth.reshape(-1) > tlc.Z_EPS)[None]
    want_ranks = np.where(v, np.cumsum(v, axis=1) - 1, -1)
    np.testing.assert_array_equal(ranks, want_ranks)
    want = tlc.lift_compact_plain(*(torch.from_numpy(x) for x in
                                    (depth, masks, intr, pose)), **kw)
    np.testing.assert_array_equal(n_out, want[1].numpy())
    np.testing.assert_allclose(pts, want[0].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("M,N", [(64000, 4096), (2000, 2000), (50, 70),
                                 (513, 2049), (20000, 17000), (1, 1)])
def test_nearest_dist_split_covers_b_in_order(M, N):
    """The blocks of one row block's cluster take [0, N) in rank order
    with no gap and no overlap; at the path's M = 64000 and the chamfer's
    M = 2000 the blocks spread over the card, at most one an SM."""
    rows, split, share, ranges = tpw.nd_split(M, N)
    assert rows in (1, 4) and 1 <= split <= tpw.MAX_SPLIT == 8
    assert len(ranges) == split
    ends = [0] + [e for _, e in ranges]
    assert [b for b, _ in ranges] == ends[:-1] and ends[-1] == N
    assert all(e - b <= share for b, e in ranges)
    blocks = -(-M // (tpw.THREADS * rows)) * split
    if M >= 2000:
        assert 64 <= blocks <= 132


def _nd_reordered(a, b, bv):
    """csrc/pairwise.cu's arithmetic in f32: |a|^2 + min_j of
    fma(-2a_z, b_z, fma(-2a_y, b_y, fma(-2a_x, b_x, |b_j|^2))).  Each fused
    multiply-add is taken exactly in f64 (a product of two f32 is exact
    there) and rounded to f32, which can differ from one rounding in the
    last bit, far inside the tolerance."""
    f32 = np.float32

    def sq(x):
        s = np.zeros(x.shape[0], f32)
        for k in range(x.shape[1]):
            s = (s + (x[:, k] * x[:, k]).astype(f32)).astype(f32)
        return s

    a2, b2 = sq(a), sq(b)
    t = np.broadcast_to(b2[None, :], (a.shape[0], b.shape[0])).astype(f32)
    for k in range(a.shape[1]):
        t = (t.astype(np.float64) + (-2 * a[:, k:k + 1]).astype(np.float64)
             * b[None, :, k].astype(np.float64)).astype(f32)
    best = np.where(bv[None, :], t, np.inf).min(axis=1)
    return np.where(np.isinf(best), f32(tpw.INF), (a2 + best).astype(f32))


@pytest.mark.parametrize("case", ["self", "radius5", "room"])
def test_nearest_dist_reordered_expansion_within_tolerance(case):
    """The kernel's order of the expansion stays within ND_TOL (1e-4
    absolute + relative, chip_smoke.py) of the plain version's, where a
    row of a equals a valid b row (every term cancels) and for points 5 m
    from the origin."""
    rng = np.random.default_rng({"self": 0, "radius5": 1, "room": 2}[case])
    b = ((rng.random((600, 3)) - 0.5) * 10).astype(np.float32)
    bv = rng.random(600) < 0.9
    if case == "room":
        a = ((rng.random((400, 3)) - 0.5) * 10).astype(np.float32)
    else:
        if case == "radius5":
            b = (5 * b / np.linalg.norm(b, axis=1, keepdims=True)).astype(
                np.float32)
        a = b[np.nonzero(bv)[0][:400]].copy()        # a row = a valid b row
    got = _nd_reordered(a, b, bv)
    want = tpw.nearest_dist_plain(*(torch.from_numpy(x) for x in
                                    (a, b, bv))).numpy()
    tol = 1e-4 + 1e-4 * np.abs(want)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
