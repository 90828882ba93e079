"""Device operations launched per 1000 frames emitted in the traced walks
(a count that repeats exactly for the same seed;
`launches_per_kframe.<cell kind>`)."""

from portbench import trace


def read(rec):
    n = len(trace.in_window(rec))
    if not n or not rec.get("frames"):
        return None
    return n / (rec["frames"] / 1000.0)
