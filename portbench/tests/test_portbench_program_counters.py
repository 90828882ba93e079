"""The readers of the program's tracer (`program.py`, the metrics
`walk_lm_host_ms.crowd`, `walk_align_host_ms.segments`,
`host_syncs_per_walk.*`, `device_mallocs_per_walk.*`) on a recorded
snapshot, and on a tracer that holds nothing."""

import pytest

from portbench import harness, program


ROOT_NS = 90_000_000  # a walk; they start 100 ms apart


def _root(rid, name, profiled, start):
    return dict(id=rid, name=name, start_ns=start, end_ns=start + ROOT_NS,
                profiled=profiled, armed=profiled)


def _walk(rid, name, profiled, start, stage, stage_ns, counts=None):
    """A root and its spans, in the order they end: `stage` twice
    (stage_ns in all), another stage between, then the root with its own
    counts."""
    half = stage_ns // 2
    spans = [[rid + 1, stage, start + 10, start + 10 + half, rid, rid,
              counts],
             [rid + 2, "walk.other", start + 40_000_000,
              start + 40_000_100, rid, rid, None],
             [rid + 3, stage, start + 50_000_000,
              start + 50_000_000 + stage_ns - half, rid, rid, counts],
             [rid, name, start, start + ROOT_NS, None, rid,
              {"cuda.syncs": 1} if profiled else None]]
    return spans, _root(rid, name, profiled, start)


def _snapshot(name, stage, walks, dropped=0):
    """walks: [(profiled, stage ns)] in the order they ran."""
    spans, roots = [], []
    for i, (profiled, ns) in enumerate(walks):
        counts = {"cuda.syncs": 2, "cuda.mallocs": 3} if profiled else None
        s, r = _walk(10 * (i + 1), name, profiled, 100_000_000 * (i + 1),
                     stage, ns, counts)
        spans += s
        roots.append(r)
    return {"clock": "time.time_ns", "capacity": 64, "dropped": dropped,
            "fields": ["id", "name", "start_ns", "end_ns", "parent", "root",
                       "counts"],
            "spans": spans, "roots": roots, "counters": {}, "syncs": []}


# the warm walk (skipped), three window walks, two traced walks (skipped)
CROWD = _snapshot("crowd", "walk.lm", [(False, 9_000_000), (False, 2_000_000),
                                       (False, 4_000_000), (False, 3_000_000),
                                       (True, 50_000_000), (True, 70_000_000)])
SEGMENTS = _snapshot("random_walk", "walk.align",
                     [(False, 100), (False, 1_000_000), (False, 5_000_000),
                      (True, 8_000_000)])


def _rec(snap, walks):
    return {"program": snap, "walks": walks}


def test_stage_median_skips_the_warm_walk_and_the_traced_walks():
    read = harness.reader("walk_lm_host_ms.crowd")
    assert read(_rec(CROWD, 2)) == pytest.approx(3.0)
    read = harness.reader("walk_align_host_ms.segments")
    assert read(_rec(SEGMENTS, 1)) == pytest.approx(3.0)
    # each reader reads its own entry's roots only
    assert harness.reader("walk_lm_host_ms.crowd")(_rec(SEGMENTS, 1)) is None


@pytest.mark.parametrize("metric,per_walk", [
    ("host_syncs_per_walk.crowd", (2 * 2 + 1) * 2 / 2),
    ("host_syncs_per_walk.segments", (2 * 2 + 1) * 2 / 2),
    ("device_mallocs_per_walk.crowd", 2 * 3 * 2 / 2),
    ("device_mallocs_per_walk.segments", 2 * 3 * 2 / 2)])
def test_counts_per_traced_walk(metric, per_walk):
    """The traced roots' counters, the roots' own and their spans', over
    the record's walks."""
    assert harness.reader(metric)(_rec(CROWD, 2)) == pytest.approx(per_walk)
    one = _snapshot("random_walk", "walk.align", [(False, 1), (True, 1)])
    assert harness.reader(metric)(_rec(one, 1)) == pytest.approx(per_walk)


def test_a_root_whose_spans_the_ring_dropped_is_not_read():
    # the warm walk's spans and the first window walk's (root 20) first
    # stage span are gone
    snap = dict(CROWD, dropped=5, spans=CROWD["spans"][5:])
    assert [r["id"] for r in program.window_roots(snap, "crowd")] == [30, 40]
    assert harness.reader("walk_lm_host_ms.crowd")(_rec(snap, 2)) == \
        pytest.approx(3.5)


METRICS = ("walk_lm_host_ms.crowd", "walk_align_host_ms.segments",
           "host_syncs_per_walk.crowd", "host_syncs_per_walk.segments",
           "device_mallocs_per_walk.crowd",
           "device_mallocs_per_walk.segments")


@pytest.mark.parametrize("metric", METRICS)
def test_none_on_an_empty_tracer(metric):
    empty = _snapshot("crowd", "walk.lm", [])
    assert harness.reader(metric)(_rec(empty, 1)) is None
    # a program without the tracer
    assert harness.reader(metric)(_rec(None, 1)) is None
    # untraced roots alone: no traced walk to count, no window to time
    # beyond the warm walk
    warm = _snapshot("crowd", "walk.lm", [(False, 5)])
    assert harness.reader(metric)(_rec(warm, 1)) is None


def test_the_live_tracer_is_read_once_per_record():
    from morphablegraphs_tpu_torch.utils import profiling
    rec = {"walks": 1}
    snap = program.snapshot(rec)
    assert snap is not None and snap["clock"] == "time.time_ns"
    assert set(snap) >= {"spans", "roots", "counters", "syncs", "dropped"}
    with profiling.span("t.after"):
        pass
    assert program.snapshot(rec) is snap
