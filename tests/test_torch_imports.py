"""The port stands alone: no ``jax`` and nothing of ``repro`` is imported by
``src/repro_torch`` or ``chip_smoke.py``, and its entry points refuse to run
on the CPU unless the caller asks for it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list:
    """Every module name an import statement of ``path`` names, at any
    depth (function-local imports included)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_source_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_port_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


TRAINING_MODULES = ("optim/adamw.py", "distributed/collectives.py",
                    "launch/steps.py", "launch/train.py",
                    "checkpoint/ckpt.py", "perception/clip.py")
MODEL_MODULES = ("models/mla.py", "models/moe.py",
                 "configs/deepseek_v3_671b.py", "configs/deepseek_v2_236b.py")


def _scanned_and_import_alone(modules) -> None:
    """``modules`` are among the scanned files, and each imports in a
    fresh interpreter without ``jax`` or ``repro``."""
    assert all(PORT / m in PORT_FILES for m in modules)
    mods = ", ".join(repr("repro_torch." + m[:-3].replace("/", "."))
                     for m in modules)
    code = (
        "import importlib, sys\n"
        f"for m in ({mods},):\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_training_modules_are_scanned_and_import_alone():
    _scanned_and_import_alone(TRAINING_MODULES)


def test_deepseek_modules_are_scanned_and_import_alone():
    _scanned_and_import_alone(MODEL_MODULES)


RECURRENT_MODULES = ("models/mamba.py", "models/rwkv.py",
                     "configs/jamba_v01_52b.py", "configs/rwkv6_3b.py")


def test_recurrent_modules_are_scanned_and_import_alone():
    _scanned_and_import_alone(RECURRENT_MODULES)


def test_cost_model_is_scanned_and_imports_alone():
    _scanned_and_import_alone(("launch/costs.py",))


ENCDEC_MODULES = ("models/encdec.py", "configs/whisper_small.py",
                  "models/api.py", "convert.py")


def test_encdec_modules_are_scanned_and_import_alone():
    _scanned_and_import_alone(ENCDEC_MODULES)


MESH_MODULES = ("launch/mesh.py", "launch/dryrun.py", "launch/steps.py",
                "distributed/sharding.py")


def test_mesh_and_dryrun_modules_are_scanned_and_import_alone():
    _scanned_and_import_alone(MESH_MODULES)


def _entry_points():
    from repro_torch.core import (CloudService, DeviceClient, Knobs,
                                  MappingServer, init_local_map, init_store)
    from repro_torch.configs.base import get_config
    from repro_torch.core.store import (clustered_synthetic_store,
                                        synthetic_store)
    from repro_torch.index import CellGrid, ClusterIndex
    from repro_torch.core.runtime import ClientSession, NetworkModel
    from repro_torch.models.api import model_api
    from repro_torch.perception.embedder import OracleEmbedder
    from repro_torch.server import (FleetServer, FleetSimulator,
                                    MeshSessionTier, SessionManager,
                                    ZoneGrid, ZoneShardedStore)
    from repro_torch.serving.loadgen import LoadGenerator, LoadSpec
    from repro_torch.serving.loop import IngestStream
    from repro_torch.sim import ScenarioEngine, WorldState, churn_scenario
    from repro_torch.checkpoint import ckpt
    from repro_torch.convert import clip_params_from_numpy
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.perception.clip import ClipConfig, init_clip_params
    kn = Knobs(server_capacity=8, client_capacity=4,
               max_object_points_server=8, max_object_points_client=4)
    grid = ZoneGrid.for_room(8.0, 2, 2)
    return {
        "init_store": lambda: init_store(8, 4, 8),
        "synthetic_store": lambda: synthetic_store(4, 8, 4, 8),
        "init_local_map": lambda: init_local_map(kn, 4),
        "MappingServer": lambda: MappingServer(
            knobs=kn, embedder=OracleEmbedder(embed_dim=4)),
        "MappingServer(mode=baseline)": lambda: MappingServer(
            knobs=kn, embedder=OracleEmbedder(embed_dim=4), mode="baseline"),
        "MappingServer(mode=parallel)": lambda: MappingServer(
            knobs=kn, embedder=OracleEmbedder(embed_dim=4), mode="parallel"),
        "MappingServer(instrument=True)": lambda: MappingServer(
            knobs=kn, embedder=OracleEmbedder(embed_dim=4), instrument=True),
        "clustered_synthetic_store": lambda: clustered_synthetic_store(
            4, 8, 4, 8),
        "ClusterIndex": lambda: ClusterIndex(
            grid=CellGrid(origin=(0.0, 0.0), size=(1.0, 1.0), nx=2, nz=2),
            embed_dim=4, capacity=8, cell_cap=16),
        "DeviceClient": lambda: DeviceClient(knobs=kn, embed_dim=4),
        "CloudService": lambda: CloudService(knobs=kn, store_ref=None),
        "OracleEmbedder.embed_text": lambda: OracleEmbedder(
            embed_dim=4).embed_text(0),
        "model_api.init": lambda: model_api(get_config(
            "semanticxr-captioner-110m-smoke")).init(),
        "model_api.init(deepseek)": lambda: model_api(get_config(
            "deepseek-v3-671b-smoke")).init(),
        "model_api.init_cache(deepseek)": lambda: model_api(get_config(
            "deepseek-v3-671b-smoke")).init_cache(1, 8),
        "model_api.init(jamba)": lambda: model_api(get_config(
            "jamba-v0.1-52b-smoke")).init(),
        "model_api.init_cache(jamba)": lambda: model_api(get_config(
            "jamba-v0.1-52b-smoke")).init_cache(1, 8),
        "model_api.init_cache(rwkv)": lambda: model_api(get_config(
            "rwkv6-3b-smoke")).init_cache(1, 8),
        "ClientSession": lambda: ClientSession(
            dev=DeviceClient(knobs=kn, embed_dim=4), net=NetworkModel(),
            knobs=kn),
        "SessionManager": lambda: SessionManager(knobs=kn, n_clients=2,
                                                 capacity=8),
        "MeshSessionTier": lambda: MeshSessionTier(knobs=kn, capacity=8,
                                                   n_clients=4, n_shards=2),
        "ZoneShardedStore": lambda: ZoneShardedStore(knobs=kn, embed_dim=4,
                                                     grid=grid),
        "FleetServer": lambda: FleetServer(knobs=kn, embed_dim=4,
                                           n_clients=2, grid=grid),
        "FleetSimulator": lambda: FleetSimulator(knobs=kn, embed_dim=4,
                                                 n_clients=2),
        "ScenarioEngine": lambda: ScenarioEngine(churn_scenario(
            n_objects=2, n_ticks=2, n_clients=1)),
        "WorldState": lambda: WorldState(knobs=kn, embed_dim=4),
        "IngestStream": lambda: IngestStream(n_ticks=2, n_live=4,
                                             embed_dim=4, max_points=4,
                                             churn=2),
        "LoadGenerator": lambda: LoadGenerator(LoadSpec(n_clients=2,
                                                        n_ticks=2),
                                               embed_dim=4),
        "init_clip_params": lambda: init_clip_params(ClipConfig()),
        "clip_params_from_numpy": lambda: clip_params_from_numpy({}),
        "ckpt.restore": lambda: ckpt.restore("absent", 1, {}),
        "make_host_mesh": lambda: make_host_mesh(),
        "launch.train.main": lambda: train.main(
            ["--arch", "semanticxr-captioner-110m-smoke", "--steps", "1"]),
        "launch.train.main(jamba)": lambda: train.main(
            ["--arch", "jamba-v0.1-52b-smoke", "--steps", "1"]),
        "launch.train.main(rwkv)": lambda: train.main(
            ["--arch", "rwkv6-3b-smoke", "--steps", "1"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda_and_raise_without_it(name,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_explicit_cpu_device_runs():
    from repro_torch.core import init_store
    st = init_store(8, 4, 8, device="cpu")
    assert st.ids.device.type == "cpu" and st.ids.dtype == torch.int32


def test_chip_scripts_fail_without_a_gpu_and_outside_a_checkout(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result;
    copied alone into an empty directory it exits non-zero as well."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, PYTHONPATH=""))
        assert r.returncode != 0, r.stdout
        assert '"ok"' not in r.stdout
