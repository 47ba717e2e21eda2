"""aten ops the host issued inside the traced batch's prefill range
(``xrbench.prefill``), as the profiler counts them (nested ops included)."""
from xrbench import trace


def read(run):
    prof = run["profile"]
    if prof is None:
        return None
    ops = trace.host_ops(prof, "xrbench.prefill")
    return None if ops is None else len(ops)
