"""The window's decode time over its decode steps (``model_api(cfg).decode``
and the greedy pick), host clock."""


def read(run):
    steps = sum(x["steps"] for x in run["batches"])
    if not steps:
        return None
    return 1e3 * sum(x["decode_s"] for x in run["batches"]) / steps
