"""Host milliseconds a decode step: the mean duration of the traced batch's
``lm.decode_step`` spans (``models/lm.py``), the op issue and the host's
waits on the device inside the step."""
from xrbench import spans


def read(run):
    ms = spans.durations_ms(run["profile"], ("lm.decode_step",),
                            spans.DECODE)
    return None if ms is None else sum(ms) / len(ms)
