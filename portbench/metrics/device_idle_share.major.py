"""The card's idle share of the window's merges, in %: the time of the
benchmark's ``merge`` spans (one a unit, around the program's merge
call) less the union of kernels, copies and sets inside them, over
that time.  The schedule's waits and the checks between units are
left out."""


def read(record):
    t = record.get("trace")
    if not t:
        return None
    span = t.get("span_s", {}).get("merge", 0.0)
    busy = t.get("span_busy_s", {}).get("merge", 0.0)
    if span <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / span)
