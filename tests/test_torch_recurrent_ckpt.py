"""The recurrent families' trainers (jamba-v0.1-52b-smoke, rwkv6-3b-smoke)
through both packages' ``launch.train``, on the CPU: a run killed by
``--kill-at`` resumes under either trainer, with masters within rtol 1e-4 /
atol 1e-6 after two steps and logged losses within 2e-4 (the bounds
``test_torch_ckpt.py`` holds the captioner's to), and the reference's
checkpoint resumes under the port.  Their checkpoints carry Mamba's f32
leaves and RWKV's slash-named ones (``mix_base/mix_mu``, stored as
``mix_base|mix_mu``).
"""
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.launch import train as jtrain

from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs.base import get_config
from repro_torch.launch import train as ttrain
from repro_torch.models import common as tcm

JAMBA, RWKV = "jamba-v0.1-52b", "rwkv6-3b"
SEQ = {JAMBA: 32, RWKV: 40}     # jamba: a multiple of its smoke chunk of 16
LOG = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) ce (\d+\.\d{4}) "
                 r"gnorm (\d+\.\d{2}) lr (\d\.\d{2}e[-+]\d{2}) tok/s \d+$")


def _log(text):
    return [LOG.match(ln) for ln in text.splitlines()
            if ln.startswith("step ")]


@pytest.mark.parametrize("name", [JAMBA, RWKV])
def test_trainer_kill_resume_and_checkpoints_interchange(name, tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """``repro_torch.launch.train --arch <name>-smoke`` is killed after
    step 2 of 4 (exit 42, a checkpoint at step 2, restored bit-equal); the
    port's rerun and ``repro.launch.train`` each resume a copy of it to
    step 4 and agree (the f32 Mamba leaves and the slash-named RWKV leaves
    among the masters).  Then the port resumes the reference's step-4
    checkpoint and trains on to step 6.  f32, as ``test_torch_ckpt.py``
    runs the captioner's."""
    arch = name + "-smoke"
    monkeypatch.setattr(jtrain, "get_config", lambda n: jget_config(
        n).replace(dtype=jnp.float32))
    monkeypatch.setattr(ttrain, "get_config", lambda n: get_config(
        n).replace(dtype=torch.float32))
    argv = ["--arch", arch, "--batch", "2", "--seq", str(SEQ[name]),
            "--ckpt-every", "2", "--log-every", "1"]
    four = argv + ["--steps", "4"]
    first = tmp_path / "port_killed"
    saved = {}

    def snap(step, m, params):
        if step == 2:
            saved["tree"] = convert.lm_params_to_tree(params)

    with pytest.raises(SystemExit) as e:
        ttrain.main(four + ["--ckpt-dir", str(first), "--kill-at", "2"],
                    device="cpu", on_step=snap)
    assert e.value.code == 42
    assert tckpt.latest_step(first / arch) == 2
    back = tckpt.restore(first / arch, 2, saved["tree"], device="cpu")
    for (p, a), (_, b) in zip(tcm.leaves(back), tcm.leaves(saved["tree"])):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    capsys.readouterr()
    for who in ("ref", "port"):
        shutil.copytree(first, tmp_path / who)
    ttrain.main(four + ["--ckpt-dir", str(tmp_path / "port")], device="cpu")
    port_out = capsys.readouterr().out
    jtrain.main(four + ["--ckpt-dir", str(tmp_path / "ref")])
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
    masters = [k for k in data["ref"].files if k.startswith("master|")]
    own = {JAMBA: "master|body|0|mixer|A_log",
           RWKV: "master|body|0|mixer|mix_base|mix_mu"}[name]
    assert own in masters, masters
    assert sorted(masters) == sorted(k for k in data["port"].files
                                     if k.startswith("master|"))
    for k in masters:
        np.testing.assert_allclose(data["port"][k], data["ref"][k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)

    # the reference's run resumes in the port
    ttrain.main(argv + ["--steps", "6", "--ckpt-dir", str(tmp_path / "ref")],
                device="cpu")
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "[restore] resuming from step 4"
    assert out.splitlines()[-1] == "training complete"
    assert [m.group(1) for m in _log(out)] == ["5", "6"]
    assert all(np.isfinite(float(m.group(2))) for m in _log(out))
    assert tckpt.latest_step(tmp_path / "ref" / arch) == 6
