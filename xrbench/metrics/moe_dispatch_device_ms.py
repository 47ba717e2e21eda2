"""Device milliseconds launched inside the MoE's bookkeeping around its
products in the traced batch's prefill: the ``moe.dispatch`` (route, rank,
scatter) and ``moe.combine`` (gather, weighting, k-sum) spans."""
from xrbench import spans


def read(run):
    return spans.launched_ms(run["profile"], ("moe.dispatch", "moe.combine"),
                             spans.PREFILL)
