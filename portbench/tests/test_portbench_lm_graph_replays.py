"""The reader of `lm_graph_replays_per_walk.crowd` on small snapshots."""

import pytest

from portbench import harness


def _traced_crowd(counts):
    """A snapshot of one untraced and one traced crowd walk whose walk.lm
    spans carry `counts` (the traced walk's alone are read)."""
    fields = ["id", "name", "start_ns", "end_ns", "parent", "root", "counts"]
    spans, roots = [], []
    for rid, profiled in ((10, False), (20, True)):
        spans += [[rid + i, "walk.lm", rid * 100 + i, rid * 100 + i + 1,
                   rid, rid, counts] for i in (1, 2)]
        spans.append([rid, "crowd", rid * 100, rid * 100 + 9, None, rid,
                      None])
        roots.append(dict(id=rid, name="crowd", start_ns=rid * 100,
                          end_ns=rid * 100 + 9, profiled=profiled,
                          armed=profiled))
    return {"clock": "time.time_ns", "capacity": 64, "dropped": 0,
            "fields": fields, "spans": spans, "roots": roots,
            "counters": {}, "syncs": []}


def test_lm_graph_replays_per_walk():
    """0 from a program that counts no replay; else the traced walks'
    replays over their count."""
    read = harness.reader("lm_graph_replays_per_walk.crowd")
    assert read({"program": _traced_crowd(None), "walks": 1}) == 0
    assert read({"program": _traced_crowd({"walk.lm.eager": 1}),
                 "walks": 1}) == 0
    replays = _traced_crowd({"walk.lm.graph_replays": 4})
    assert read({"program": replays, "walks": 1}) == pytest.approx(8.0)
    assert read({"program": replays, "walks": 2}) == pytest.approx(4.0)
    assert read({"program": None, "walks": 1}) is None
