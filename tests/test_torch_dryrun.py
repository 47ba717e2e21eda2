"""The port's dry run, meshes and host-mesh steps on the CPU
(``repro_torch.launch.{dryrun,mesh,steps}``, ``checkpoint.ckpt.restore(
shardings=)``).

``python -m repro_torch.launch.dryrun`` plans a cell in a fresh
interpreter without ``jax`` or ``repro`` (the counterpart of
``tests/test_dryrun_smoke.py``, which compiles on 512 forced host devices
and runs only as slow); ``main --all`` plans every assigned cell on both
planning meshes and writes the reference's file names and skip records.
Each record's analytic figures equal ``repro.launch.costs.step_costs``'
for the same rewritten config, exactly, with and without ``prune_tiles``,
and its roofline's compute and memory terms equal the reference's
``roofline_terms`` at the port's hardware (the collective term is left
out).  On a CPU host mesh the built steps give the mesh-free path's
outputs bit for bit: the step is the same eager function.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import costs as jcosts

from repro_torch.checkpoint import ckpt
from repro_torch.configs import ASSIGNED
from repro_torch.configs import base as tbase
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import costs as tcosts
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models.lm import greedy_token
from repro_torch.optim import adamw as tadamw

ROOT = Path(__file__).resolve().parents[1]
# the fields the dry run's per-kind rewrites and flags may change
REWRITTEN = ("name", "moe_groups", "moe_weight_shard", "rwkv_tm_shard",
             "kv_cache_dtype", "prune_tiles", "act_shard", "grad_accum",
             "remat")
REF_KEYS = {"arch", "shape", "kind", "mesh", "chips", "multi_pod",
            "mla_absorb", "prune_tiles", "seq_parallel", "grad_accum",
            "int8_kv", "memory", "hlo_cost_raw", "collectives", "analytic",
            "roofline", "timings"}


def _ref_config(tcfg, arch):
    """The reference's config with the port's rewrites of ``arch``'s
    (``test_torch_sharding`` holds ``dryrun.cell_config`` to the reference
    dry run's own rewrites, field by field)."""
    j = jbase.get_config(arch)
    kw = {f: getattr(tcfg, f) for f in REWRITTEN}
    if tcfg.mla is not None:
        kw["mla"] = dataclasses.replace(j.mla, absorb=tcfg.mla.absorb)
    return j.replace(**kw)


def test_dryrun_module_plans_a_cell_without_jax_or_repro(tmp_path):
    code = (
        "import runpy, sys\n"
        "sys.argv = ['dryrun', '--arch', 'whisper-small', '--shape',\n"
        f"            'decode_32k', '--out', {str(tmp_path)!r}]\n"
        "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("clean"), r.stdout
    files = sorted((tmp_path / "pod1").iterdir())
    assert [f.name for f in files] == ["whisper-small__decode_32k.json"]
    rec = json.loads(files[0].read_text())
    assert set(rec) == REF_KEYS | {"not_reckoned"}
    # the reference's spec arithmetic: 1.1572 GiB a device on 16 x 16
    assert round(rec["memory"]["argument_bytes_per_dev"] / 2**30, 4) == 1.1572
    assert rec["memory"]["temp_bytes_per_dev"] is None
    assert rec["hlo_cost_raw"] is None and rec["collectives"] is None
    assert set(rec["not_reckoned"]) >= {"temp_bytes_per_dev",
                                        "peak_bytes_per_dev", "hlo_cost_raw",
                                        "collectives"}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_dryrun_all_plans_every_cell_with_the_reference_names(tmp_path,
                                                              multi_pod):
    argv = ["--all", "--out", str(tmp_path)] + (["--multi-pod"] if multi_pod
                                                 else [])
    dryrun.main(argv)                  # raises SystemExit(1) on a failure
    out = tmp_path / ("pod2" if multi_pod else "pod1")
    names = {f.name for f in out.iterdir()}
    assert names == {f"{a}__{s}.json" for a in ASSIGNED for s in tbase.SHAPES}
    chips = 512 if multi_pod else 256
    for a in ASSIGNED:
        for s in tbase.SHAPES:
            rec = json.loads((out / f"{a}__{s}.json").read_text())
            if not jbase.cell_is_runnable(a, s):
                assert rec["skipped"] and s == "long_500k", (a, s)
                continue
            assert set(rec) == REF_KEYS | {"not_reckoned"}, (a, s)
            assert rec["chips"] == chips and rec["kind"] == \
                tbase.SHAPES[s].kind
            m = rec["memory"]
            assert m["argument_bytes_per_dev"] > 0 and \
                0 < m["alias_bytes_per_dev"] <= m["output_bytes_per_dev"]
            assert "collective_s" not in rec["roofline"]


@pytest.mark.parametrize("prune", [False, True], ids=["full", "prune"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_run_cell_costs_equal_the_reference(multi_pod, prune):
    mesh = tmesh.make_planning_mesh(multi_pod=multi_pod)
    n = 0
    for arch in ASSIGNED:
        for shape, cell in jbase.SHAPES.items():
            if not jbase.cell_is_runnable(arch, shape):
                continue
            rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                                  prune_tiles=prune, verbose=False)
            jcfg = _ref_config(dryrun.cell_config(arch, shape, mesh,
                                                  prune_tiles=prune), arch)
            want = jcosts.step_costs(jcfg, cell)
            assert rec["analytic"] == {
                "flops": want.flops, "hbm_bytes": want.hbm_bytes,
                "model_flops": want.model_flops, "n_params": want.n_params,
                "n_active": want.n_active}, (arch, shape)
            rl = jcosts.roofline_terms(want, 0.0, chips=mesh.size,
                                       hw=tcosts.H100_SXM)
            for k in ("compute_s", "memory_s", "bound_s", "roofline_mfu",
                      "useful_ratio", "dominant"):
                assert rec["roofline"][k] == rl[k], (arch, shape, k)
            n += 1
    assert n == 34


def test_prune_tiles_changes_the_attention_cost():
    cfg = tbase.get_config("gemma2-27b")
    cell = tbase.SHAPES["prefill_32k"]
    full = tcosts.step_costs(cfg, cell).flops
    pruned = tcosts.step_costs(cfg.replace(prune_tiles=True), cell).flops
    assert pruned < full


def test_meshes():
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"need {n} CUDA devices"):
            tmesh.make_production_mesh(multi_pod=multi)
        pm = tmesh.make_planning_mesh(multi_pod=multi)
        assert pm.size == n and not hasattr(pm, "devices")
    host = tmesh.make_host_mesh("cpu")
    assert dict(host.shape) == {"data": 1, "model": 1}
    assert list(host.devices.flat) == [torch.device("cpu")]
    assert tsh.zone_shard_devices(host, 3) == [torch.device("cpu")] * 3


def test_restore_places_leaves_by_their_shardings(tmp_path):
    host = tmesh.make_host_mesh("cpu")
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.tensor([1, 2], dtype=torch.int32),
                  torch.ones(4, dtype=torch.bfloat16)]}
    ckpt.save(tmp_path, 3, tree)
    shardings = tsh.shardings_of(
        tsh.map_tree(lambda _, t: tsh.P(*([None] * t.ndim)), tree), host)
    got = ckpt.restore(tmp_path, 3, tree, shardings=shardings)
    for (_, w), (_, g) in zip(tsh.leaves(tree), tsh.leaves(got)):
        assert g.device == torch.device("cpu") and g.dtype == w.dtype
        assert torch.equal(g, w)
    plan = tsh.shardings_of(tsh.map_tree(lambda _, t: tsh.P(), tree),
                            tmesh.make_planning_mesh())
    with pytest.raises(ValueError, match="one-device mesh"):
        ckpt.restore(tmp_path, 3, tree, shardings=plan)


# ------------------------------------------------------ host-mesh steps
SMOKES = ("whisper-small-smoke", "yi-9b-smoke", "jamba-v0.1-52b-smoke")


@pytest.fixture
def one_thread():
    """The smoke models' many small ops on one thread: a second each alone,
    but a hundred times that when every worker of a parallel test run
    spins its own pool of threads on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, cell, seed):
    return tbase.make_inputs(cfg, cell, torch.Generator().manual_seed(seed),
                             device="cpu")


def _same(a, b) -> bool:
    ta, tb = list(tsteps.arg_tensors(a)), list(tsteps.arg_tensors(b))
    return len(ta) == len(tb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))


def _placed_bytes(*trees) -> int:
    return sum(t.nbytes for t in tsteps.arg_tensors(trees))


@pytest.mark.parametrize("name", SMOKES)
def test_host_mesh_serving_steps_equal_the_mesh_free_path(name, one_thread):
    cfg = tbase.get_config(name)
    api = tapi.model_api(cfg)
    host = tmesh.make_host_mesh("cpu")
    pcell, dcell = ShapeCell("p", 16, 2, "prefill"), \
        ShapeCell("d", 24, 2, "decode")
    params = api.init(torch.Generator().manual_seed(3), device="cpu")
    prefill, pargs = tsteps.build_step(cfg, host, pcell)
    decode, dargs = tsteps.build_step(cfg, host, dcell)
    batch = _batch(cfg, pcell, 5)
    runs = []
    for fn in ((prefill, decode), (api.prefill, api.decode)):
        caches = api.init_cache(2, 24, device="cpu")
        logits, caches = fn[0](params, batch, caches)
        outs = [logits]
        tok = greedy_token(logits)
        for t in range(3):
            pos = 1 + t if cfg.encdec else 16 + t
            logits, caches = fn[1](params, tok, caches, pos)
            tok = greedy_token(logits)
            outs.append(logits)
        runs.append((outs, caches))
    assert _same(runs[0], runs[1]), name
    # the tensors' bytes are the arguments' bytes on the 1 x 1 mesh (the
    # decode step's pos is a host int)
    caches = api.init_cache(2, 24, device="cpu")
    assert _placed_bytes(params, batch) == sum(
        tsteps.bytes_per_device(a) for a in pargs[:2])
    tok = torch.zeros((2, 1), dtype=torch.int32)
    assert _placed_bytes(params, tok, caches) == sum(
        tsteps.bytes_per_device(a) for a in dargs[:3])


@pytest.mark.parametrize("name", SMOKES)
def test_host_mesh_train_step_equals_build_train_step(name, one_thread):
    cfg = tbase.get_config(name)
    api = tapi.model_api(cfg)
    host = tmesh.make_host_mesh("cpu")
    cell = ShapeCell("t", 16, 2, "train")
    ocfg = tadamw.AdamWConfig(warmup_steps=1, total_steps=4)
    step, args = tsteps.build_sharded_train_step(cfg, host, cell, ocfg)
    runs = []
    for fn in (step, tsteps.build_train_step(cfg, ocfg)):
        params = api.init(torch.Generator().manual_seed(4), device="cpu")
        params.requires_grad_(True)
        opt = tadamw.init_opt_state(params, ocfg)
        batch = _batch(cfg, cell, 6)
        if fn is step:
            assert _placed_bytes(params, opt, batch) == sum(
                tsteps.bytes_per_device(a) for a in args)
        mets = []
        for i in range(2):
            params, opt, m = fn(params, opt, _batch(cfg, cell, 6 + i))
            mets.append(m)
        runs.append((params, opt, mets))
    assert _same(runs[0], runs[1]), name
    assert set(runs[0][2][0]) == set(tsteps.METRICS)


def test_steps_on_a_planning_mesh_or_off_the_mesh_device_raise():
    cfg = tbase.get_config("yi-9b-smoke")
    step, _ = tsteps.build_step(cfg, tmesh.make_planning_mesh(),
                                tbase.SHAPES["decode_32k"])
    with pytest.raises(RuntimeError, match="planned but not run"):
        step(None, None, None, 0)
    host = tmesh.make_host_mesh("cpu")
    step, _ = tsteps.build_step(cfg, host, ShapeCell("p", 16, 2, "prefill"))
    meta = {"tokens": torch.zeros((2, 16), dtype=torch.int32, device="meta")}
    with pytest.raises(ValueError, match="not on the mesh's device"):
        step({}, meta, None)
    assert np.prod(list(host.shape.values())) == 1
