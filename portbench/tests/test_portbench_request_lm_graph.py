"""The reader of `lm_graph_replays_per_step.service` on small snapshots,
and its entry in BENCHMARK.json."""

import pytest

from portbench import harness

import helpers

CELL = "ref_actions.service_requests"
METRIC = "lm_graph_replays_per_step.service"


def _traced_requests(lm_counts, steps=(3, 5)):
    """A snapshot of one untraced and two traced requests: each a
    `generate` span counting its steps and one `request.lm` span a step
    carrying `lm_counts` (the traced requests' alone are read)."""
    fields = ["id", "name", "start_ns", "end_ns", "parent", "root", "counts"]
    spans, roots = [], []
    for rid, profiled, n in ((10, False, 4), (20, True, steps[0]),
                             (30, True, steps[1])):
        t = rid * 1000
        spans.append([rid + 1, "generate", t + 1, t + 900, rid, rid,
                      {"request.steps": n}])
        spans += [[rid + 2 + i, "request.lm", t + 2 + i, t + 3 + i, rid + 1,
                   rid, lm_counts] for i in range(n)]
        spans.append([rid, "serve.request", t, t + 999, None, rid, None])
        roots.append(dict(id=rid, name="serve.request", start_ns=t,
                          end_ns=t + 999, profiled=profiled, armed=profiled,
                          method="POST", path="/run_morphablegraphs"))
    return {"clock": "time.time_ns", "capacity": 64, "dropped": 0,
            "fields": fields, "spans": spans, "roots": roots,
            "counters": {}, "syncs": []}


def test_lm_graph_replays_per_step():
    """0 from a program that counts no replay; else the traced requests'
    replays over their steps."""
    read = harness.reader(METRIC)
    assert read({"program": _traced_requests(None)}) == 0
    assert read({"program": _traced_requests(
        {"request.lm.eager": 1})}) == 0
    replays = _traced_requests({"request.lm.graph_replays": 1})
    assert read({"program": replays}) == pytest.approx(1.0)
    # one step of each traced request ran eagerly: 6 replays over 8 steps
    partial = _traced_requests({"request.lm.graph_replays": 1})
    for s in partial["spans"]:
        if s[1] == "request.lm" and s[5] != 10 and s[0] in (22, 32):
            s[6] = {"request.lm.eager": 1}
    assert read({"program": partial}) == pytest.approx(6 / 8)
    assert read({"program": None}) is None
    uncounted = _traced_requests({"request.lm.graph_replays": 1},
                                 steps=(0, 0))
    assert read({"program": uncounted}) is None


def test_entry_moves_the_service_rate():
    spec = harness.cell_spec(helpers.bench(), CELL)
    entry = [m for m in spec["per_layer"] if m["name"] == METRIC]
    assert entry == [dict(name=METRIC, unit="replays", better="higher",
                          source="program_counter", layer="request path",
                          moves="frames_per_s.crowd", workloads=[CELL])]
    assert callable(harness.reader(METRIC))
    for other in ("ref_walk.crowd_root", "ref_walk.random_segments"):
        names = {m["name"] for m in harness.cell_spec(
            helpers.bench(), other)["per_layer"]}
        assert METRIC not in names
