"""Prompt and served tokens of every batch finished in the window, over
the window's whole time (host clock)."""


def read(run):
    return sum(b["tokens"] for b in run["batches"]) / run["window_s"]
