"""The port's checkpoints and trainer against the JAX reference's.

A checkpoint interchanges between the packages: the port writes the names,
shapes, dtypes and bits ``repro.checkpoint.ckpt`` writes (bf16 as uint16
bits), reads what it wrote, and the two trainers resume each other's runs.
The trainers are held to each other in f32 (both configs patched to
``dtype=float32`` and 2 layers): the same arithmetic in another order,
masters within rtol 1e-4 / atol 1e-6 after two more steps (about 1e-6
measured); their logged losses within 2e-4, one unit of the last printed
digit.
"""
import json
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.models.api import model_api as jmodel_api
from repro.optim import adamw as jadamw

from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models.api import model_api
from repro_torch.optim import adamw as tadamw

SMOKE = "semanticxr-captioner-110m-smoke"
LOG = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) ce (\d+\.\d{4}) "
                 r"gnorm (\d+\.\d{2}) lr (\d\.\d{2}e[-+]\d{2}) tok/s \d+$")


def _lm(dtype=torch.bfloat16, seed=0):
    cfg = get_config(SMOKE).replace(n_layers=2, dtype=dtype)
    return cfg, model_api(cfg).init(torch.Generator().manual_seed(seed),
                                    device="cpu")


def _bits(x) -> np.ndarray:
    """Any leaf (tensor, jax or numpy array) as its raw bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    a = np.atleast_1d(np.asarray(x))
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else \
        a.view(np.uint8)


def _same_bits(a, b) -> bool:
    return np.array_equal(_bits(a), _bits(b))


def test_bf16_round_trip_is_bit_exact(tmp_path):
    cfg, lm = _lm()
    tree = convert.lm_params_to_tree(lm)
    tckpt.save(tmp_path, 7, tree)
    assert tckpt.latest_step(tmp_path) == 7
    back = tckpt.restore(tmp_path, 7, tree, device="cpu")
    got = convert.lm_params_from_numpy(cfg, back, device="cpu")
    for (n, a), (_, b) in zip(lm.named_parameters(), got.named_parameters()):
        assert a.dtype == b.dtype == torch.bfloat16, n
        assert _same_bits(a, b), n
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    names = [leaf["name"] for leaf in manifest["leaves"]]
    assert "body/0/mixer/wq" in names and "embed" in names
    assert {leaf["dtype"] for leaf in manifest["leaves"]} == {"bfloat16"}


def test_retention_keeps_the_newest_three(tmp_path):
    _, lm = _lm()
    tree = convert.lm_params_to_tree(lm)
    for s in (1, 2, 3, 4, 5):
        tckpt.save(tmp_path, s, tree, keep=3)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4, 5]
    assert tckpt.latest_step(tmp_path) == 5


def test_a_leftover_temp_dir_never_becomes_latest(tmp_path):
    _, lm = _lm()
    tree = convert.lm_params_to_tree(lm)
    assert tckpt.latest_step(tmp_path) is None
    tckpt.save(tmp_path, 3, tree)
    crashed = tmp_path / ".tmp_step_4_99999"      # a writer that died
    crashed.mkdir()
    (crashed / "arrays.npz").write_bytes(b"partial")
    assert tckpt.latest_step(tmp_path) == 3
    assert jckpt.latest_step(tmp_path) == 3
    tckpt.save(tmp_path, 5, tree, keep=1)
    assert tckpt.latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_5"]
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path, 4, tree, device="cpu")


def test_the_port_reads_what_repro_wrote_and_back(tmp_path):
    """Parameters (bf16) and an optimizer state (f32, step int32) written by
    one package restore in the other with the same bits."""
    jcfg = jget_config(SMOKE).replace(n_layers=2)
    jparams = jmodel_api(jcfg).init(jax.random.key(3))
    jopt = jadamw.init_opt_state(jparams, jadamw.AdamWConfig())
    jopt = jopt._replace(step=jnp.asarray(17, jnp.int32),
                         m=jax.tree.map(lambda x: x + 0.25, jopt.master))
    jckpt.save(tmp_path / "ref", 17, jparams)
    jckpt.save(tmp_path / "ref" / "opt", 17, jopt)

    cfg, lm = _lm()
    like_p = convert.lm_params_to_tree(lm)
    like_o = convert.opt_state_to_numpy(tadamw.init_opt_state(
        lm, tadamw.AdamWConfig()), cfg)
    # repro -> port
    tp = tckpt.restore(tmp_path / "ref", 17, like_p, device="cpu")
    to = tckpt.restore(tmp_path / "ref" / "opt", 17, like_o, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [str(p) for p, _ in jl] == [str(p) for p, _ in tl]
    assert all(_same_bits(a, b) for (_, a), (_, b) in zip(jl, tl))
    opt = convert.opt_state_from_numpy(cfg, to, device="cpu")
    assert int(opt.step) == 17 and opt.step.dtype == torch.int32
    for field in ("master", "m", "v"):
        assert all(_same_bits(a, b) for a, b in zip(
            jax.tree.leaves(getattr(jopt, field)),
            jax.tree.leaves(getattr(to, field))))
    # port -> repro
    lm2 = convert.lm_params_from_numpy(cfg, tp, device="cpu")
    tckpt.save(tmp_path / "port", 18, convert.lm_params_to_tree(lm2))
    tckpt.save(tmp_path / "port" / "opt", 18,
               convert.opt_state_to_numpy(opt, cfg))
    jp = jckpt.restore(tmp_path / "port", 18, jparams)
    jo = jckpt.restore(tmp_path / "port" / "opt", 18, jopt)
    assert all(a.dtype == b.dtype and _same_bits(a, b) for a, b in zip(
        jax.tree.leaves(jp), jax.tree.leaves(jparams)))
    assert all(a.dtype == b.dtype and _same_bits(a, b) for a, b in zip(
        jax.tree.leaves(jo), jax.tree.leaves(jopt)))
    ref_names = json.loads((tmp_path / "ref" / "opt" / "step_17" /
                            "manifest.json").read_text())["leaves"]
    port_names = json.loads((tmp_path / "port" / "opt" / "step_18" /
                             "manifest.json").read_text())["leaves"]
    assert ref_names == port_names


def test_restore_refuses_a_shape_mismatch(tmp_path):
    _, lm = _lm()
    tckpt.save(tmp_path, 1, {"embed": lm["embed"]})
    with pytest.raises(ValueError, match="embed"):
        tckpt.restore(tmp_path, 1, {"embed": torch.zeros(3, 4)},
                      device="cpu")


def _log_lines(text):
    return [LOG.match(ln) for ln in text.splitlines()
            if ln.startswith("step ")]


def test_either_trainer_resumes_the_others_run(tmp_path, monkeypatch,
                                               capsys):
    """``repro.launch.train`` runs 2 steps of 4 and checkpoints (killed at
    step 2, exit 42); copies of its directory are resumed to step 4 by both
    trainers, which then agree."""
    monkeypatch.setattr(jtrain, "get_config", lambda name: jget_config(
        name).replace(n_layers=2, dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "get_config", lambda name: get_config(
        name).replace(n_layers=2, dtype=torch.float32))
    argv = ["--arch", SMOKE, "--steps", "4", "--batch", "2", "--seq", "32",
            "--ckpt-every", "2", "--log-every", "1"]
    first = tmp_path / "first"
    with pytest.raises(SystemExit) as e:
        jtrain.main(argv + ["--ckpt-dir", str(first), "--kill-at", "2"])
    assert e.value.code == 42
    capsys.readouterr()
    for who in ("ref", "port"):
        shutil.copytree(first, tmp_path / who)
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    ref_out = capsys.readouterr().out
    ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "port")], device="cpu")
    port_out = capsys.readouterr().out

    for out in (ref_out, port_out):
        assert out.splitlines()[0] == "[restore] resuming from step 2"
        assert out.splitlines()[-1] == "training complete"
    ref_log, port_log = _log_lines(ref_out), _log_lines(port_out)
    assert len(ref_log) == len(port_log) == 2
    assert all(port_log) and all(ref_log), port_out
    for a, b in zip(ref_log, port_log):
        assert a.group(1) == b.group(1) and a.group(5) == b.group(5)
        for i in (2, 3):
            assert abs(float(a.group(i)) - float(b.group(i))) <= 2e-4

    name = SMOKE
    data = {who: np.load(tmp_path / who / name / "opt" / "step_4" /
                         "arrays.npz") for who in ("ref", "port")}
    masters = [k for k in data["ref"].files if k.startswith("master|")]
    assert sorted(masters) == sorted(k for k in data["port"].files
                                     if k.startswith("master|"))
    assert int(data["ref"]["step"]) == int(data["port"]["step"]) == 4
    for k in masters:
        np.testing.assert_allclose(data["port"][k], data["ref"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # the port's run resumes in the reference too: nothing is left to do
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out.splitlines()
    assert out == ["[restore] resuming from step 4", "training complete"]
