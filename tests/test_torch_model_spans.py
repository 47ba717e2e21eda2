"""Spans and counters inside the port's model modules (``repro_torch.obs``).

At smoke size on the CPU: a jamba and an rwkv6 prefill + two decode steps
under a tracer and a CPU ``torch.profiler`` emit each model span in the
tracer's buffer and as a profiler range of the same name, nested as
placed; the logits and caches are bit-equal with the tracer and registry
installed and without them; the MoE counters match hand counts; a tensor
passed to ``Counter.inc`` stays a tensor until it is exported; and with no
tracer no span and no profiler range is opened.
"""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.base import get_config
from repro_torch.models import api as tapi
from repro_torch.models import common as cm
from repro_torch.models import moe as tmoe
from repro_torch.obs import MetricsRegistry, Tracer, set_registry, set_tracer
from repro_torch.obs import trace as ttrace
from repro_torch.obs.metrics import Counter

JAMBA, RWKV = "jamba-v0.1-52b-smoke", "rwkv6-3b-smoke"
B, S, STEPS = 2, 20, 2
SPANS = {JAMBA: {"mamba.scan", "moe.dispatch", "moe.experts",
                 "moe.combine", "lm.decode_step"},
         RWKV: {"rwkv.wkv", "lm.decode_step"}}


def _serve(name):
    """Prefill B x S seeded tokens into fresh caches and decode STEPS
    greedy tokens: (every logits tensor, the caches)."""
    cfg = get_config(name)
    api = tapi.model_api(cfg)
    model = api.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1))
    caches = api.init_cache(B, S + STEPS, device="cpu")
    logits, caches = api.prefill(model, {"tokens": tokens}, caches)
    out = [logits]
    for t in range(STEPS):
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        logits, caches = api.decode(model, tok, caches, S + t)
        out.append(logits)
    return out, caches


def _observed(fn, *, profiled=True):
    tracer, reg = Tracer(), MetricsRegistry()
    prev_t, prev_r = set_tracer(tracer), set_registry(reg)
    try:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out = fn()
        else:
            out, prof = fn(), None
    finally:
        set_tracer(prev_t), set_registry(prev_r)
    return out, tracer, reg, prof


def _ranges(prof, names):
    """(name, start, end) of the profiler's ranges named in ``names``."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name in names]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("name", [JAMBA, RWKV])
def test_model_spans_in_buffer_and_profiler(name):
    """Each span in the tracer's buffer and as a profiler range of its
    name: the scans only in the prefill, every MoE range inside a decode
    step or outside all of them, each decode step's ranges inside it."""
    _, tracer, _, prof = _observed(lambda: _serve(name))
    want = SPANS[name]
    spans = tracer.chrome_trace()["traceEvents"]
    assert {e["name"] for e in spans} == want
    assert all(e["cat"] == "model" for e in spans)
    ranges = _ranges(prof, want)
    assert sorted(n for n, _, _ in ranges) == sorted(e["name"]
                                                     for e in spans)
    steps = [r for r in ranges if r[0] == "lm.decode_step"]
    assert len(steps) == STEPS
    scans = [r for r in ranges if r[0] in ("mamba.scan", "rwkv.wkv")]
    n_scan = sum(mk in (cm.MIXER_MAMBA, cm.MIXER_RWKV6)
                 for mk, _ in get_config(name).layer_kinds())
    assert len(scans) == n_scan                 # the prefill's, no step's
    assert not any(_inside(r, st) for r in scans for st in steps)
    n_moe = sum(lk == cm.MLP_MOE and mk != cm.MIXER_RWKV6
                for mk, lk in get_config(name).layer_kinds())
    moe = [r for r in ranges if r[0].startswith("moe.")]
    # a call: the route's dispatch, one group's three, the concatenation
    assert len(moe) == 5 * n_moe * (1 + STEPS)
    assert sum(any(_inside(r, st) for st in steps) for r in moe) == \
        5 * n_moe * STEPS


def test_spans_nest_in_the_tracer_buffer():
    """A decode step's MoE spans lie one level under it in the buffer."""
    _, tracer, _, _ = _observed(lambda: _serve(JAMBA), profiled=False)
    evs = tracer.chrome_trace()["traceEvents"]
    steps = [e for e in evs if e["name"] == "lm.decode_step"]
    assert len(steps) == STEPS and all(e["args"]["depth"] == 0
                                       for e in steps)
    inside = [e for e in evs if e["name"].startswith("moe.") and any(
        st["ts"] <= e["ts"] and e["ts"] + e["dur"] <= st["ts"] + st["dur"]
        for st in steps)]
    assert inside and all(e["args"]["depth"] == 1 for e in inside)
    assert all(e["args"]["depth"] == 0 for e in evs
               if e["name"] == "mamba.scan")


@pytest.mark.parametrize("name", [JAMBA, RWKV])
def test_observing_leaves_logits_and_caches_bit_equal(name):
    """The replay-purity rule: tracer, registry and profiler installed or
    not, the same logits and caches, bit for bit."""
    plain, caches = _serve(name)
    (seen, seen_caches), *_ = _observed(lambda: _serve(name))
    for a, b in zip(plain, seen):
        assert torch.equal(a, b)
    for ca, cb in zip(caches, seen_caches):
        for a, b in zip(ca, cb):
            assert (a is None and b is None) or torch.equal(a, b)


def _moe_case(E=4, k=2, cf=0.5, d=16):
    cfg = cm.ArchConfig(name="moe-case", n_layers=1, d_model=d, n_heads=1,
                        n_kv_heads=1, d_head=d, d_ff=32, vocab_size=32,
                        mlps=(cm.MLP_MOE,),
                        moe=cm.MoEConfig(n_experts=E, top_k=k, d_ff_expert=8,
                                         n_shared=0, capacity_factor=cf),
                        dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    params = {n: torch.randn(s.shape, generator=g, dtype=torch.float32)
              for n, s in tmoe.moe_param_specs(cfg).items()}
    return cfg, params


@pytest.mark.parametrize("groups,S", [(1, 12), (2, 12), (3, 1)])
def test_moe_counters_match_hand_counts(groups, S):
    """copies = T k, rows = E C groups, kept / copies = 1 - dropped_frac,
    on a case that drops (capacity factor 0.5), under its phase label."""
    cfg, params = _moe_case()
    mo = cfg.moe
    Bn = 96 // S
    x = torch.randn((Bn, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    (y, stats), _, reg, _ = _observed(
        lambda: tmoe.moe_apply(params, x, cfg, n_groups=groups),
        profiled=False)
    phase = "decode" if S == 1 else "prefill"
    T = Bn * S
    C = tmoe.expert_capacity(T // groups, cfg)
    snap = reg.snapshot()["counters"]
    key = f'{{phase="{phase}"}}'
    assert snap["moe_copies_total"] == {key: T * mo.top_k}
    assert snap["moe_expert_rows_total"] == {key: mo.n_experts * C * groups}
    kept = snap["moe_copies_kept_total"][key]
    assert isinstance(kept, int)
    assert float(stats.dropped_frac) > 0
    assert kept / (T * mo.top_k) == pytest.approx(
        1.0 - float(stats.dropped_frac), abs=1e-6)
    y0, s0 = tmoe.moe_apply(params, x, cfg, n_groups=groups)
    assert torch.equal(y, y0) and torch.equal(stats.dropped_frac,
                                              s0.dropped_frac)


def test_counter_keeps_a_tensor_until_export():
    c = Counter("kept")
    c.inc(torch.tensor(3), phase="decode")
    c.inc(torch.tensor(4), phase="decode")
    c.inc(2, phase="prefill")
    assert isinstance(c.values[(("phase", "decode"),)], torch.Tensor)
    assert c.value(phase="decode") == 7 and isinstance(
        c.value(phase="decode"), int)
    assert c.total() == 9 and isinstance(c.total(), int)
    reg = MetricsRegistry()
    reg.counters["kept"] = c
    assert reg.snapshot()["counters"]["kept"] == {'{phase="decode"}': 7,
                                                  '{phase="prefill"}': 2}
    assert 'kept{phase="decode"} 7\n' in reg.to_prometheus()
    assert isinstance(c.values[(("phase", "decode"),)], torch.Tensor)


def test_no_tracer_opens_no_span_and_no_range(monkeypatch):
    """With no tracer or registry, ``span`` is the shared null span, and a
    profiled serve holds no model range and makes no counter op."""
    prev_t, prev_r = set_tracer(None), set_registry(None)
    try:
        assert ttrace.span("mamba.scan", "model") is ttrace._NULL_SPAN
        entered = []
        monkeypatch.setattr(torch.autograd.profiler.record_function,
                            "__enter__", lambda self: entered.append(self))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _serve(JAMBA)
        assert entered == []
        assert _ranges(prof, SPANS[JAMBA]) == []
    finally:
        set_tracer(prev_t), set_registry(prev_r)


def test_span_off_the_profiler_opens_no_range(monkeypatch):
    """A tracer installed with no profiler recording keeps its own buffer
    and opens no profiler range."""
    entered = []
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", lambda self: entered.append(self))
    tr = Tracer()
    with tr.span("lm.decode_step", "model"):
        pass
    assert entered == [] and tr.durations_ms("lm.decode_step")


def _outer_aten_ops(tracer, reg):
    """The aten ops a jamba serve issues, but those nested in another aten
    op, by name: with ``tracer`` and ``reg`` installed under a CPU
    profiler."""
    def outer(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                return False
            p = p.cpu_parent
        return True

    prev_t, prev_r = set_tracer(tracer), set_registry(reg)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _serve(JAMBA)
    finally:
        set_tracer(prev_t), set_registry(prev_r)
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("aten::") and outer(e))


def test_instrumentation_adds_no_op_but_the_kept_count():
    """With no registry the spans add no torch op to a serve; a registry
    adds the kept-copy count's sum and add, one each a MoE group."""
    _outer_aten_ops(None, None)                 # first-call effects
    bare = _outer_aten_ops(None, None)
    assert _outer_aten_ops(Tracer(), None) == bare
    counted = _outer_aten_ops(Tracer(), MetricsRegistry())
    n_moe = sum(lk == cm.MLP_MOE for _, lk in get_config(JAMBA).layer_kinds())
    assert counted - bare == collections.Counter(
        {"aten::sum": n_moe * (1 + STEPS), "aten::add": n_moe * (1 + STEPS)})
    assert bare - counted == collections.Counter()
