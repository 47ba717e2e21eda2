"""The plain references against the port at smoke sizes on the CPU, the
control, and the faults that the check has to catch."""
import pytest
import torch

from xrbench import check, core, weights
from xrbench.generators import offline_batches as gen
from xrbench.tests import smoke

from repro_torch.models import common as cm
from repro_torch.models import lm as lm_mod
from repro_torch.models.api import model_api
from repro_torch.models.lm import LM, greedy_token

FAMILIES = {"jamba": smoke.jamba, "rwkv6": smoke.rwkv6}
CELLS = {"jamba": ["jamba-2p.prefill_2k", "jamba-2p.chat_128"],
         "rwkv6": ["rwkv6-3b.prefill_4k"]}


def limits(fam, pick):
    """Each number's limit over the family's cells, the least (``min``)
    or the largest (``max``)."""
    cells = [core.load("workloads", c)["check"]["limits"]
             for c in CELLS[fam]]
    return {k: pick(c[k] for c in cells) for k in cells[0]}


def served(conf, seed, traffic, dtype=torch.bfloat16):
    """The port's logits at every served position and the served tokens,
    for batch 0 of ``traffic``, on the CPU: weights drawn as a run draws
    them (cast to ``dtype``)."""
    ref, adapter = core.family(conf)
    cfg = adapter.arch_config(conf, torch).replace(dtype=dtype)
    api = model_api(cfg)
    tree = cm.map_tree(lambda _, t: t if t.dtype == torch.float32
                       else t.to(dtype),
                       weights.draw_model(ref.layout(conf), seed, "cpu"))
    model = LM(cfg, tree, device="cpu")
    p = gen.prompts(traffic, seed, 0, conf["vocab_size"], "cpu")
    B, S = p.shape
    caches = api.init_cache(B, S + traffic["new_tokens"], device="cpu")
    logits, caches = api.prefill(model, {"tokens": p}, caches)
    outs, toks = [logits.float()], [greedy_token(logits)]
    for i in range(traffic["new_tokens"] - 1):
        logits, caches = api.decode(model, toks[-1], caches, S + i)
        outs.append(logits.float())
        toks.append(greedy_token(logits))
    toks = torch.cat(toks, dim=1)
    seq = torch.cat([p, toks[:, :-1].long()], dim=1)
    return torch.stack(outs, dim=1), toks, seq


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_reference_matches_port_in_f32(fam):
    """The port run in f32 on the weights a run draws (bf16 values) and the
    f32 reference agree at every served position: prefill, the cache's
    hand-off and each decode step, with the MoE's routing and capacity."""
    conf = FAMILIES[fam]()
    traffic = smoke.traffic(batch=3, prompt=37, new_tokens=6)
    prog, _, seq = served(conf, 5, traffic, torch.float32)
    ref = core.family(conf)[0].served_logits(conf, 5, [seq], 37, "cpu")
    err = float((prog - ref["f32"][0]).abs().max())
    assert err < 1e-4, err


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_bf16_port_within_the_limits_and_control_beyond(fam):
    """The served bf16 port passes its cells' limits on three seeds.  The
    fp8 control, in the port's place on the same tokens, reads a 95th
    percentile gap three times the port's or more, and a limit between
    the two (half the control's) passes the port and fails the control.
    At the cells' own sizes ``xrbench/control.py`` reads the control on
    the card."""
    conf = FAMILIES[fam]()
    traffic = smoke.traffic(batch=8, prompt=40, new_tokens=16)
    strict = limits(fam, min)
    for seed in (11, 12, 13):
        _, toks, seq = served(conf, seed, traffic)
        out = core.family(conf)[0].served_logits(conf, seed, [seq], 40,
                                                 "cpu", kinds=("f32", "fp8"))
        prog = check.gap_stats([check.served_gaps(out["f32"][0], toks)])
        ctrl = check.gap_stats([check.control_gaps(out["f32"][0],
                                                   out["fp8"][0])])
        assert all(prog[k] <= v for k, v in strict.items()), prog
        assert ctrl["gap_p95"] > 0
        assert ctrl["gap_p95"] >= 3 * prog["gap_p95"], (prog, ctrl)
        lim = dict(strict, gap_p95=ctrl["gap_p95"] / 2)
        assert check.passes(check.compared(prog, lim, 0, 0))
        assert not check.passes(check.compared(ctrl, lim, 0, 0))


def _altered_token(monkeypatch):
    """Every fourth token served comes out one above the greedy pick."""
    real, calls = lm_mod.greedy_token, [0]

    def altered(logits):
        tok = real(logits)
        calls[0] += 1
        if calls[0] % 4 == 0:
            tok = tok.clone()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(lm_mod, "greedy_token", altered)


def _state_unchanged(monkeypatch):
    """The prefill hands decode its caches as they were before it ran."""
    real = lm_mod.prefill

    def stale(params, tokens, cfg, caches, **kw):
        logits, caches = real(params, tokens, cfg, caches, **kw)
        for c in caches:
            for t in c:
                if isinstance(t, torch.Tensor):
                    t.zero_()
        return logits, caches
    monkeypatch.setattr(lm_mod, "prefill", stale)


@pytest.mark.parametrize("fam", sorted(FAMILIES))
@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged])
def test_fault_in_the_timed_path_fails_the_check(fam, fault, monkeypatch):
    """A run whose served path is broken underneath comes out not correct
    at the widest of its cells' limits; the same run unbroken is correct at
    the narrowest."""
    conf = FAMILIES[fam]()
    kw = dict(device="cpu", conf=conf, log=lambda text: None, metrics=[],
              traffic=smoke.traffic(batch=4, prompt=24, new_tokens=8))
    ok = core.run_cell("smoke", 9, 0.1, False, workload=smoke.workload(
        conf["name"], "smoke", limits(fam, min)), **kw)
    assert ok["correct"], ok["compared"]
    fault(monkeypatch)
    bad = core.run_cell("smoke", 9, 0.1, False, workload=smoke.workload(
        conf["name"], "smoke", limits(fam, max)), **kw)
    assert not bad["correct"], bad["compared"]
