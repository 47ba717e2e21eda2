"""The port's analytic cost model (``repro_torch.launch.costs``) against
``repro.launch.costs`` on the CPU.

The model is plain arithmetic over a config and a shape cell, written with
the reference's float expressions in the reference's order, so every
figure is held exactly: ``param_counts``, every ``CellCosts`` field and
every ``breakdown`` entry, for each config the port registers, full and
smoke, at every cell of ``SHAPES`` and at ``SMOKE_CELL``; ``roofline_terms``
given the reference's own hardware dict, the encoder-decoder
(whisper-small) among them.  The port's default hardware is an H100 SXM's
data sheet.
"""
import dataclasses
import itertools

import pytest
import torch

from repro.configs import base as jbase
from repro.launch import costs as jcosts

from repro_torch.configs import base as tbase
from repro_torch.launch import costs as tcosts
from repro_torch.models import common as tcm
from repro_torch.models.api import model_api

NAMES = tbase.list_configs()
CELLS = [*tbase.SHAPES, "smoke"]


def _cells():
    """(reference cell, port cell) pairs: SHAPES in order, then SMOKE_CELL."""
    return ([(jbase.SHAPES[k], tbase.SHAPES[k]) for k in tbase.SHAPES]
            + [(jbase.SMOKE_CELL, tbase.SMOKE_CELL)])


def test_cells_and_configs_cover_the_port():
    assert NAMES == jbase.list_configs() and len(NAMES) == 11
    for (jc, tc) in _cells():
        assert dataclasses.astuple(jc) == dataclasses.astuple(tc)


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_step_costs_equal_the_reference_at_every_cell(name, variant):
    full = name if variant == "full" else name + "-smoke"
    jcfg, tcfg = jbase.get_config(full), tbase.get_config(full)
    assert tcosts.param_counts(tcfg) == jcosts.param_counts(jcfg)
    assert tcm.count_params(model_api(tcfg).param_specs()) == \
        jcosts.param_counts(jcfg)[0]
    for jcell, tcell in _cells():
        want = jcosts.step_costs(jcfg, jcell)
        got = tcosts.step_costs(tcfg, tcell)
        for f in ("flops", "hbm_bytes", "model_flops", "n_params",
                  "n_active", "useful_ratio"):
            assert getattr(got, f) == getattr(want, f), (full, tcell.name, f)
        assert got.breakdown == want.breakdown, (full, tcell.name)
        assert type(got.n_params) is int and type(got.n_active) is int
        terms = tcosts.roofline_terms(got, 1.5e9, chips=4, hw=jcosts.V5E)
        assert terms == jcosts.roofline_terms(want, 1.5e9, chips=4)


def test_cache_bytes_equal_the_reference_with_the_int8_cache():
    jcfg = jbase.get_config("h2o-danube-3-4b").replace(kv_cache_dtype="int8")
    tcfg = tbase.get_config("h2o-danube-3-4b").replace(kv_cache_dtype="int8")
    for B, T in ((1, 1), (4, 5000), (128, 32768)):
        assert tcosts._cache_bytes(tcfg, B, T) == \
            jcosts._cache_bytes(jcfg, B, T)


def test_roofline_defaults_to_the_h100_data_sheet():
    assert tcosts.H100_SXM == dict(peak_flops=989e12, hbm_bw=3.35e12,
                                   ici_bw=450e9)
    assert set(tcosts.H100_SXM) == set(jcosts.V5E)
    assert not hasattr(tcosts, "V5E")
    got = tcosts.step_costs(tbase.get_config("rwkv6-3b"),
                            tbase.SHAPES["train_4k"])
    terms = tcosts.roofline_terms(got, 0.0, chips=1)
    assert terms["compute_s"] == got.flops / 989e12
    assert terms["memory_s"] == got.hbm_bytes / 3.35e12
    assert terms["dominant"] == "compute_s"
    assert terms["roofline_mfu"] == pytest.approx(
        got.model_flops / got.flops)


def test_encoder_decoder_costs_are_not_ported():
    """The encoder-decoder branch is ported: whisper-small's costs, full
    and smoke, equal the reference's exactly at every cell of ``SHAPES``
    and at ``SMOKE_CELL`` (train: frames + 448 decoder tokens; prefill:
    the encoder; decode: one step against ``enc_seq`` cross keys), with
    ``remat`` off as well as on."""
    for name, remat in itertools.product(
            ("whisper-small", "whisper-small-smoke"), (True, False)):
        jcfg = jbase.get_config(name).replace(remat=remat)
        tcfg = tbase.get_config(name).replace(remat=remat)
        for jcell, tcell in _cells():
            want = jcosts.step_costs(jcfg, jcell)
            got = tcosts.step_costs(tcfg, tcell)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), (
                name, remat, tcell.name)
            assert "layers_fwd" in got.breakdown
            assert ("hbm_cache" in got.breakdown) == (tcell.kind == "decode")


def test_count_params_counts_every_leaf():
    specs = {"a": tcm.spec((3, 4), torch.bfloat16),
             "b": [{"c": tcm.spec((5,), torch.float32)},
                   {"c": tcm.spec((), torch.float32)}]}
    assert tcm.count_params(specs) == 12 + 5 + 1
