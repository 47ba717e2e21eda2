"""Runtime calls a decode step that block the host on the device: per
traced ``lm.decode_step`` span, the stream, device and event synchronizes
and the device-to-host copies launched inside it, averaged over the steps
(a ``.item()`` is a copy and a synchronize: two)."""
from xrbench import spans


def read(run):
    per = spans.waits(run["profile"], "lm.decode_step", spans.DECODE)
    return None if per is None else sum(per) / len(per)
