"""The share of the traced window in which no device operation ran, in %
(`device_idle.<cell kind>`: the split follows the rate each cell
reports)."""

from portbench import trace


def read(rec):
    lo, hi = rec["window"]
    if hi <= lo or not trace.in_window(rec):
        return None
    return 100.0 * (1.0 - trace.busy_ns(rec) / (hi - lo))
