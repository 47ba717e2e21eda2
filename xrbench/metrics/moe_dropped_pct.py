"""Per cent of the MoE's routed copies dropped past capacity in the traced
batch's prefill: 100 x (1 - ``moe_copies_kept_total`` /
``moe_copies_total``), phase "prefill" (``models/moe.py``'s counters)."""


def read(run):
    prof = run["profile"]
    if prof is None:
        return None
    c = prof["counters"]["counters"]
    key = '{phase="prefill"}'
    copies = c.get("moe_copies_total", {}).get(key)
    kept = c.get("moe_copies_kept_total", {}).get(key)
    if not copies or kept is None:
        return None
    return 100.0 * (1.0 - kept / copies)
