"""The port's mesh sharding rules (``repro_torch.distributed.sharding``,
``repro_torch.launch.steps``) against ``repro``'s on the CPU.

The reference's side is built on ``jax.sharding.AbstractMesh``: its
``build_step`` makes every cell's argument trees with their
``NamedSharding``s without devices and without a compile.  The port's side
is built on its host mesh (1 x 1, on the CPU) and its planning meshes
(16 x 16 and 2 x 16 x 16).  For every assigned config at every runnable
cell, on each mesh, plain and under the dry run's per-kind rewrites and
its ``int8_kv``, ``absorb_mla``, ``seq_parallel``, ``grad_accum`` and
``prune_tiles`` variants, these are held exactly, keyed by the reference's
path names:
  * every leaf's spec tuple from ``param_pspecs``, ``zero_pspecs``,
    ``cache_pspecs`` and ``input_pspecs``, and ``_logits_pspec``;
  * ``cache_specs`` and ``opt_state_specs``, shape and dtype leaf for leaf;
  * ``build_step``'s argument trees: shape, dtype, spec and per-device
    bytes of every leaf, the sum over the arguments of
    ``prod(shard_shape) * itemsize``.
There is no tolerance: the rules and the byte counts are integer work.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import base as jbase
from repro.distributed import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import api as japi
from repro.optim import adamw as jadamw

from repro_torch.configs import ASSIGNED
from repro_torch.configs import base as tbase
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as tadamw

MESHES = ("1x1", "16x16", "2x16x16")
# (flags of the dry run's cell_config) or None: the registered config as is
VARIANTS = {"plain": None, "dryrun": {}, "int8_kv": dict(int8_kv=True),
            "absorb_mla": dict(absorb_mla=True),
            "seq_parallel": dict(seq_parallel=True),
            "grad_accum": dict(grad_accum=2),
            "prune_tiles": dict(prune_tiles=True)}


def _meshes(name):
    """(reference AbstractMesh, port mesh)."""
    if name == "1x1":
        return (AbstractMesh((1, 1), ("data", "model")),
                tmesh.make_host_mesh("cpu"))
    multi = name == "2x16x16"
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else \
        ((16, 16), ("data", "model"))
    return AbstractMesh(shape, axes), tmesh.make_planning_mesh(multi_pod=multi)


def _ref_cell_config(arch, cell, mesh, *, absorb_mla=False,
                     prune_tiles=False, seq_parallel=False, grad_accum=1,
                     int8_kv=False):
    """The reference dry run's config rewrites (``repro/launch/dryrun.py``
    run_cell), which it applies inline before its compile."""
    cfg = jbase.get_config(arch)
    dp = int(np.prod([mesh.shape[a] for a in mesh.axis_names
                      if a != "model"]))
    if cfg.moe is not None:
        cfg = cfg.replace(moe_groups=min(dp, cell.global_batch),
                          moe_weight_shard="2d" if cell.kind == "train"
                          else "ep")
    if cfg.rwkv is not None and cell.kind != "train":
        cfg = cfg.replace(rwkv_tm_shard="replicated")
    if int8_kv and cell.kind == "decode":
        cfg = cfg.replace(kv_cache_dtype="int8")
    if absorb_mla and cfg.mla is not None:
        cfg = cfg.replace(mla=cfg.mla, name=cfg.name + "+absorb")
        cfg = cfg.replace(mla=dataclasses.replace(cfg.mla, absorb=True))
    if prune_tiles:
        cfg = cfg.replace(prune_tiles=True)
    if seq_parallel and cell.kind == "train" and cell.seq_len % 16 == 0:
        dpa = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        cfg = cfg.replace(act_shard=(dpa, "model"))
    if grad_accum > 1 and cell.kind == "train":
        cfg = cfg.replace(grad_accum=grad_accum)
    if cell.kind != "train":
        cfg = cfg.replace(remat=False)
    return cfg


def _configs(arch, shape, variant, jmesh, tmesh_):
    flags = VARIANTS[variant]
    if flags is None:
        return jbase.get_config(arch), tbase.get_config(arch)
    return (_ref_cell_config(arch, jbase.SHAPES[shape], jmesh, **flags),
            tdry.cell_config(arch, shape, tmesh_, **flags))


def _field(cfg, name):
    """A config field, a sub-config as a dict."""
    v = getattr(cfg, name)
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def _name(path) -> str:
    return jsh._leaf_name(path)


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _jleaves(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {_name(p): x for p, x in flat}


def _jspecs(tree) -> dict:
    return {k: (tuple(s.shape), _dt(s.dtype)) for k, s in
            _jleaves(tree).items()}


def _tspecs(tree) -> dict:
    return {k: (tuple(s.shape), _dt(s.dtype)) for k, s in tsh.leaves(tree)}


def _jps(tree) -> dict:
    from jax.sharding import PartitionSpec
    return {k: tuple(p) for k, p in _jleaves(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec)).items()}


def _tps(tree) -> dict:
    return {k: tuple(p) for k, p in tsh.leaves(tree)}


def _jargs(args) -> dict:
    out = {}
    for i, a in enumerate(args):
        for k, s in _jleaves(a).items():
            out[f"{i}/{k}"] = (tuple(s.shape), _dt(s.dtype),
                               tuple(s.sharding.spec),
                               math.prod(s.sharding.shard_shape(s.shape))
                               * s.dtype.itemsize)
    return out


def _targs(args) -> dict:
    return {f"{i}/{k}": (tuple(s.shape), _dt(s.dtype), tuple(s.sharding.spec),
                         s.bytes_per_device)
            for i, a in enumerate(args) for k, s in tsh.leaves(a)}


def _runnable(arch):
    return [s for s in tbase.SHAPES if tbase.cell_is_runnable(arch, s)]


def test_assigned_configs_and_meshes_match_the_reference():
    assert ASSIGNED == JASSIGNED and len(ASSIGNED) == 10
    for name in MESHES:
        jm, tm = _meshes(name)
        assert tuple(tm.axis_names) == tuple(jm.axis_names)
        assert dict(tm.shape) == dict(jm.shape) and tm.size == jm.size


@pytest.mark.parametrize("arch", ASSIGNED)
def test_rules_specs_and_argument_bytes_equal_the_reference(arch):
    """Every rule's spec tuples, the cache and optimizer specs and
    ``build_step``'s argument trees, for each runnable cell, mesh and
    variant, equal the reference's."""
    ocfg = tadamw.AdamWConfig()
    n_cases = 0
    for mesh_name in MESHES:
        jm, tm = _meshes(mesh_name)
        for shape in _runnable(arch):
            jcell, tcell = jbase.SHAPES[shape], tbase.SHAPES[shape]
            B, S = tcell.global_batch, tcell.seq_len
            for variant in VARIANTS:
                jcfg, tcfg = _configs(arch, shape, variant, jm, tm)
                where = (arch, mesh_name, shape, variant)
                common = ({f.name for f in dataclasses.fields(tcfg)}
                          & {f.name for f in dataclasses.fields(jcfg)}
                          - {"dtype", "moe"})
                assert {f: _field(tcfg, f) for f in common} == \
                    {f: _field(jcfg, f) for f in common}, where
                japi_, tapi_ = japi.model_api(jcfg), tapi.model_api(tcfg)
                jp, tp = japi_.param_specs(), tapi_.stacked_param_specs()
                jc, tc = japi_.cache_specs(B, S), tapi_.cache_specs(B, S)
                jo = jadamw.opt_state_specs(jp, jadamw.AdamWConfig())
                to = tadamw.opt_state_specs(tp, ocfg)
                ji, ti = jbase.input_specs(jcfg, jcell), \
                    tbase.input_specs(tcfg, tcell)
                assert _tspecs(tp) == _jspecs(jp), where
                assert _tspecs(tc) == _jspecs(jc), where
                assert _tspecs(to) == _jspecs(jo), where
                assert _tps(tsh.param_pspecs(tcfg, tp, tm)) == \
                    _jps(jsh.param_pspecs(jcfg, jp, jm)), where
                assert _tps(tsh.zero_pspecs(tcfg, to, tm)) == \
                    _jps(jsh.zero_pspecs(jcfg, jo, jm)), where
                assert _tps(tsh.cache_pspecs(tcfg, tc, tm, global_batch=B)) \
                    == _jps(jsh.cache_pspecs(jcfg, jc, jm, global_batch=B)), \
                    where
                assert _tps(tsh.input_pspecs(tcfg, ti, tm, global_batch=B)) \
                    == _jps(jsh.input_pspecs(jcfg, ji, jm, global_batch=B)), \
                    where
                assert tuple(tsteps._logits_pspec(tm, B, tcfg.vocab_size)) == \
                    tuple(jsteps._logits_pspec(jm, B, jcfg.vocab_size)), where
                _, jargs = jsteps.build_step(jcfg, jm, jcell)
                _, targs = tsteps.build_step(tcfg, tm, tcell)
                assert _targs(targs) == _jargs(jargs), where
                n_cases += 1
    assert n_cases == len(MESHES) * len(_runnable(arch)) * len(VARIANTS)


# the reference's per-device argument bytes on the 16 x 16 mesh (its spec
# arithmetic over the registered configs), in GiB to 4 places
ARG_GIB = {("yi-9b", "train_4k"): 1.8979,
           ("whisper-small", "decode_32k"): 1.1572,
           ("deepseek-v3-671b", "prefill_32k"): 13.0383,
           ("rwkv6-3b", "long_500k"): 0.4161}


@pytest.mark.parametrize("arch,shape", sorted(ARG_GIB))
def test_argument_bytes_per_device_on_the_production_mesh(arch, shape):
    jm, tm = _meshes("16x16")
    _, jargs = jsteps.build_step(jbase.get_config(arch), jm,
                                 jbase.SHAPES[shape])
    _, targs = tsteps.build_step(tbase.get_config(arch), tm,
                                 tbase.SHAPES[shape])
    want = sum(v[3] for v in _jargs(jargs).values())
    got = sum(tsteps.bytes_per_device(a) for a in targs)
    assert got == want and round(got / 2**30, 4) == ARG_GIB[arch, shape]


# master leaves whose ZeRO "data" lands on the stacked period axis, of all
@pytest.mark.parametrize("arch,want", [("minitron-4b", (9, 12)),
                                       ("yi-9b", (9, 12)),
                                       ("phi-3-vision-4.2b", (9, 13)),
                                       ("rwkv6-3b", (21, 24))])
def test_zero_shards_the_stacked_period_axis(arch, want):
    jm, tm = _meshes("16x16")
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    to = tadamw.opt_state_specs(tapi.model_api(tcfg).stacked_param_specs(),
                                tadamw.AdamWConfig())
    jo = jadamw.opt_state_specs(japi.model_api(jcfg).param_specs(),
                                jadamw.AdamWConfig())
    got = {k: v for k, v in _tps(tsh.zero_pspecs(tcfg, to, tm)).items()
           if k.startswith("master/")}
    assert got == {k: v for k, v in _jps(jsh.zero_pspecs(jcfg, jo, jm))
                   .items() if k.startswith("master/")}
    on_period = [k for k, ps in got.items()
                 if "/body/" in k and ps and ps[0] == "data"]
    assert (len(on_period), len(got)) == want


def test_partition_spec_and_shard_shape_behave_as_jax():
    from jax.sharding import NamedSharding as JNS
    from jax.sharding import PartitionSpec as JP
    jm, tm = _meshes("2x16x16")
    for names in [(("data",), None), ((), "model"), (("pod", "data"), None),
                  (None,), ()]:
        assert tuple(tsh.P(*names)) == tuple(JP(*names))
    for names, shape in [((("pod", "data"), "model"), (64, 32)),
                         (("model",), (48, 3)), ((None, "data"), (5, 16))]:
        assert tsh.NamedSharding(tm, tsh.P(*names)).shard_shape(shape) == \
            tuple(JNS(jm, JP(*names)).shard_shape(shape))
    with pytest.raises(ValueError):
        tsh.NamedSharding(tm, tsh.P("model")).shard_shape((24,))
    with pytest.raises(ValueError):
        tsh.NamedSharding(tm, tsh.P(None, None)).shard_shape((4,))
    with pytest.raises(ValueError):
        tsh.NamedSharding(tm, tsh.P("nope"))


def test_cache_specs_match_init_cache_and_stack_its_layers():
    """``cache_specs`` is ``init_cache``'s shapes and dtypes in the stacked
    layout (smoke configs, int8 KV included): each stacked leaf is the
    per-layer caches' leaves stacked."""
    for name in ("jamba-v0.1-52b-smoke", "deepseek-v3-671b-smoke",
                 "gemma2-27b-smoke", "rwkv6-3b-smoke", "whisper-small-smoke"):
        for kv in ("bf16", "int8"):
            cfg = tbase.get_config(name).replace(kv_cache_dtype=kv)
            api = tapi.model_api(cfg)
            specs = dict(tsh.leaves(api.cache_specs(2, 40)))
            caches = api.init_cache(2, 40, device="cpu")
            if cfg.encdec:
                layers = [dict(tsh.leaves(c)) for c in caches.self_kv]
                got = {f"self_kv/{k}": ((len(layers),) + tuple(t.shape),
                                        t.dtype)
                       for k, t in layers[0].items()}
                got.update({k: (tuple(t.shape), t.dtype) for k, t in
                            (("cross_k", caches.cross_k),
                             ("cross_v", caches.cross_v))})
            else:
                got = {}
                npre, per = cfg.n_dense_prefix, cfg.period
                for i, c in enumerate(caches[:npre]):
                    got.update({f"prefix/{i}/{k}": (tuple(t.shape), t.dtype)
                                for k, t in tsh.leaves(c)})
                for s in range(per):
                    got.update({f"body/{s}/{k}": ((cfg.n_periods,) +
                                                  tuple(t.shape), t.dtype)
                                for k, t in tsh.leaves(caches[npre + s])})
            assert got == {k: (s.shape, s.dtype) for k, s in specs.items()}, \
                (name, kv)
