"""Device milliseconds launched inside the program's recurrent scans in
the traced batch's prefill: the ``mamba.scan`` and ``rwkv.wkv`` spans
(``models/mamba.py``, ``models/rwkv.py``), on the profiler's clock."""
from xrbench import spans


def read(run):
    return spans.launched_ms(run["profile"], ("mamba.scan", "rwkv.wkv"),
                             spans.PREFILL)
