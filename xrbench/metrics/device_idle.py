"""Per cent of the traced batch's window with no kernel, copy or memset
running on the device; nothing where the trace holds no device activity."""


def read(run):
    prof = run["profile"]
    if prof is None or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
