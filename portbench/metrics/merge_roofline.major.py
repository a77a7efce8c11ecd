"""The merge kernels' share of their roofline in the traced window, in
%: the least time the merges' own work needs at the card's peak memory
bandwidth, over the device time of the kernels whose name holds
``merge``.

The work is counted from the cell's keys, not from launch shapes: a
merge reads one 32-bit order word of each input key (the narrowest
operand that orders a partition of these keys) and writes one 4-bit
source tag a surviving key (enough for up to 16 runs), once each; its
operations are far below the bandwidth bound."""

from portbench.counters import peak


def read(record):
    t = record.get("trace")
    g = record.get("generator", {})
    if not t or not g.get("units"):
        return None
    kernel_s = sum(s for name, s in t["by_name"].items()
                   if "merge" in name.lower())
    if kernel_s <= 0:
        return None
    work = g["units"] * (4.0 * g["keys_in"] + 0.5 * g["keys_out"])
    least = work / peak(record.get("device_kind", ""), "hbm_bytes_per_s")
    return 100.0 * least / kernel_s
