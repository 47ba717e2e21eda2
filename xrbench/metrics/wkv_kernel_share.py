"""Per cent of the RWKV time mix's sequence wkv calls in the traced batch
that launched the ``wkv6`` kernel: 100 x ``rwkv_wkv_calls_total`` under
path "kernel" over all its calls ("kernel" and "chunks", the chunk loop;
``models/rwkv.py``'s counter).  None where the program has no such
counter."""


def read(run):
    prof = run["profile"]
    if prof is None:
        return None
    calls = prof["counters"]["counters"].get("rwkv_wkv_calls_total")
    if not calls:
        return None
    kernel = calls.get('{path="kernel"}', 0)
    total = kernel + calls.get('{path="chunks"}', 0)
    return 100.0 * kernel / total if total else None
