"""The window's prefill time over its prefills: a host clock around each
prefill (fresh caches, ``model_api(cfg).prefill``), synchronised."""


def read(run):
    b = run["batches"]
    return 1e3 * sum(x["prefill_s"] for x in b) / len(b) if b else None
