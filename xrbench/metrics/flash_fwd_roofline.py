"""The flash forward kernels' share of their roofline in the traced batch:
the frozen count's FLOPs and bytes of every launch a prefill makes
(``costs.flash_fwd_cost`` at the call's shapes, from the adapter's
``flash_calls``), at the chip's peaks, over the kernels' device time.
Nothing where the batch launched none, or not one a layer that the count
expects."""
from xrbench import costs, trace

KERNEL = "flash_wgmma_kernel"


def read(run):
    prof, tr = run["profile"], run["traffic"]
    if prof is None:
        return None
    calls = run["adapter"].flash_calls(run["conf"], tr["batch"], tr["prompt"])
    flash = [e for e in trace.device_events(prof) if KERNEL in e["name"]]
    seconds = sum(e["dur"] for e in flash) / 1e6
    if not calls or len(flash) != len(calls) or seconds <= 0:
        return None
    flops = bytes_ = 0.0
    for c in calls:
        f, b = costs.flash_fwd_cost(*c)
        flops, bytes_ = flops + f, bytes_ + b
    return costs.roofline_share(flops, bytes_, seconds)
