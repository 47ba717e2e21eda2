"""The allocator's peak over the window (``max_memory_allocated`` after
``reset_peak_memory_stats``), in 1e9 bytes."""


def read(run):
    return run["peak_bytes"] / 1e9
