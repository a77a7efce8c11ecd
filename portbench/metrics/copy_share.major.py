"""Device copies' share of the card's busy time in the traced window,
in %."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * t["memcpy_s"] / t["busy_s"]
