"""Kernel K2's share of its roofline: the least time the patch gathers of
the window could take, their bytes (the benchmark's own count from the
gathers' shapes) over the card's HBM bandwidth, against the device time
of K2's launches in the trace."""


def read(rec):
    k2 = rec.get("k2")
    if not k2 or not k2["launches"]:
        return None
    t = sum(v for n, v in rec["trace"]["device_by_name"].items()
            if k2["kernel"] in n)
    if t <= 0:
        return None
    return 100.0 * k2["bytes"] / rec["peaks"]["hbm_bytes_per_s"] / t
