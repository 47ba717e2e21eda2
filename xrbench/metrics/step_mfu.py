"""Model FLOPs of the window's work (the frozen count of each call a batch
makes: its tokens through every layer, MoE at its top-k experts, the head
at the served positions) over the window's time, as a share of the chip's
dense bf16 peak."""
from xrbench import costs


def read(run):
    conf, adapter = run["conf"], run["adapter"]
    per_batch = sum(adapter.model_flops(conf, b, n, ctx)
                    for b, n, ctx in run["generator"].calls(run["traffic"]))
    flops = per_batch * len(run["batches"])
    return 100.0 * flops / run["window_s"] / costs.PEAK_BF16_FLOPS
