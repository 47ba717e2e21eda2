"""Per cent of the expert rows the MoE's products computed in decode that
held a routed copy: 100 x ``moe_copies_kept_total`` /
``moe_expert_rows_total``, phase "decode", over the traced batch
(``models/moe.py``'s counters)."""


def read(run):
    prof = run["profile"]
    if prof is None:
        return None
    c = prof["counters"]["counters"]
    key = '{phase="decode"}'
    rows = c.get("moe_expert_rows_total", {}).get(key)
    kept = c.get("moe_copies_kept_total", {}).get(key)
    if not rows or kept is None:
        return None
    return 100.0 * kept / rows
