"""Device milliseconds launched inside the MoE's three spans in the traced
batch's prefill: ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
(``models/moe.py``), on the profiler's clock."""
from xrbench import spans


def read(run):
    return spans.launched_ms(run["profile"],
                             ("moe.dispatch", "moe.experts", "moe.combine"),
                             spans.PREFILL)
