"""Host milliseconds per walk inside the program's `walk.lm` ranges: the
crowd step's gated LM refinement (the frozen LM's jacobian, B2's solve,
B5's mixture terms)."""

from portbench import trace


def read(rec):
    if not any(r[0] == "walk.lm" for r in rec["ranges"]):
        return None
    return trace.range_host_ms(rec, "walk.lm") / rec["walks"]
