"""Device milliseconds a decode step launched: the mean over the traced
batch's ``lm.decode_step`` spans (``models/lm.py``) of the device work
launched inside each, on the profiler's clock."""
from xrbench import spans


def read(run):
    per = spans.per_range_ms(run["profile"], "lm.decode_step", spans.DECODE)
    return None if per is None else sum(per) / len(per)
