"""The port's tracer (`utils.profiling`): spans in the ring with their
parent and root, the profiler's ranges on the same clock, counters in the
innermost span, the kernel wrappers' launch and error counts, the ring's
capacity, the armed counters' capture of synchronising calls, the walks'
`walk.*` ranges, and the service's and CLI's use of it."""

import json
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

torch.set_num_threads(1)

from morphablegraphs_tpu_torch.models import graph as graph_mod  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as sk  # noqa: E402
from morphablegraphs_tpu_torch.ops import cuda_build, kernels  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path  # noqa: E402
from morphablegraphs_tpu_torch.serve import cli, rest  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import walk  # noqa: E402
from morphablegraphs_tpu_torch.utils import profiling  # noqa: E402
from morphablegraphs_tpu_torch.utils import synthetic  # noqa: E402

ID, NAME, START, END, PARENT, ROOT, COUNTS = range(7)


def _spans(tracer, name=None):
    return [s for s in tracer.snapshot()["spans"]
            if name is None or s[NAME] == name]


def _kineto_ranges(prof, names):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() in names]


def test_unprofiled_span_enters_no_record_function(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) outside a trace")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)
    tr = profiling.Tracer()
    with tr.span("crowd", seed=3):
        assert tr.current_root() is not None
        with tr.span("walk.goal"):
            pass
        with tr.span("walk.lm"):
            with tr.span("inner"):
                pass
    assert tr.current_root() is None
    spans = {s[NAME]: s for s in _spans(tr)}
    root = spans["crowd"]
    assert root[PARENT] is None and root[ROOT] == root[ID]
    assert spans["walk.goal"][PARENT] == root[ID]
    assert spans["inner"][PARENT] == spans["walk.lm"][ID]
    assert {s[ROOT] for s in spans.values()} == {root[ID]}
    assert all(s[START] <= s[END] for s in spans.values())
    assert root[START] <= spans["walk.goal"][START] \
        and spans["inner"][END] <= root[END]
    (r,) = tr.snapshot()["roots"]
    assert (r["id"], r["name"], r["profiled"], r["armed"], r["seed"]) == \
        (root[ID], "crowd", False, False, 3)


def test_profiled_spans_are_ranges_on_the_same_clock():
    """Under a profiler every span is a range of the trace, starting within
    1 ms of its start in the ring, but for an entry point's root (not
    ranged), which a CUDA trace would show as a device annotation."""
    tr = profiling.Tracer()
    names = {"crowd.t", "root.t", "walk.a", "walk.b"}
    with profile(activities=[ProfilerActivity.CPU]):  # warm the profiler
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("crowd.t", ranged=False):
            with tr.span("root.t"):
                for name in ("walk.a", "walk.b", "walk.a"):
                    with tr.span(name):
                        torch.ones(64).sum()
    ranges = sorted(_kineto_ranges(prof, names), key=lambda r: r[1])
    spans = sorted(_spans(tr), key=lambda s: s[START])
    assert spans[0][NAME] == "crowd.t"
    spans = spans[1:]
    assert [r[0] for r in ranges] == [s[NAME] for s in spans]
    for (name, start, end), s in zip(ranges, spans):
        assert abs(start - s[START]) < 1_000_000, name  # within 1 ms
        assert s[START] <= start and end <= s[END], name
    (root,) = tr.snapshot()["roots"]
    assert root["profiled"] and root["armed"]  # armed by the profiler


def test_counters_go_to_the_innermost_open_span():
    tr = profiling.Tracer()
    tr.count("outside")
    with tr.span("r"):
        tr.count("x")
        with tr.span("a"):
            tr.count("x", 2)
            with tr.span("b"):
                tr.count("y", 5)
            tr.count("x")
    counts = {s[NAME]: s[COUNTS] for s in _spans(tr)}
    assert counts == {"r": {"x": 1}, "a": {"x": 3}, "b": {"y": 5}}
    assert tr.counters() == {"outside": 1, "x": 4, "y": 5}
    tr.reset("x")
    assert tr.counters() == {"outside": 1, "y": 5} and _spans(tr)
    tr.reset()
    assert tr.counters() == {} and not _spans(tr)
    assert not tr.snapshot()["roots"]


META_CALLS = {
    "chol_solve": lambda d: kernels.chol_solve(torch.zeros(4, 3, 3, device=d),
                                               torch.zeros(4, 3, device=d)),
    "lm_delta": lambda d: kernels.lm_delta(
        torch.zeros(2, 5, 3, device=d), torch.zeros(2, 5, device=d),
        torch.ones(2, device=d), torch.ones(2, device=d)),
    "crowd_back_project": lambda d: kernels.crowd_back_project(
        torch.zeros(2, 3, device=d), torch.zeros(8, 3, device=d),
        torch.zeros(8, device=d), torch.zeros(5, 2, device=d)),
    "gmm_scores": lambda d: kernels.gmm_scores(
        torch.zeros(2, 3, device=d), torch.ones(2, device=d) / 2,
        torch.zeros(2, 3, device=d),
        torch.eye(3, device=d).expand(2, 3, 3).contiguous()),
}


@pytest.mark.parametrize("wrapper", sorted(META_CALLS))
def test_kernel_wrapper_counts_its_kernel_error(wrapper):
    """On CPU tensors a wrapper runs its twin and counts no launch and no
    error; on a device with no kernel it counts the KernelError it raises,
    under its own name and in the open span."""
    errors = kernels.ERRORS + wrapper
    before = profiling.counters().get(errors, 0)
    launches = kernels.launch_counts()
    META_CALLS[wrapper]("cpu")
    assert kernels.launch_counts() == launches
    assert profiling.counters().get(errors, 0) == before
    with profiling.span("t.kernel_error"):
        with pytest.raises(kernels.KernelError, match="no kernel"):
            META_CALLS[wrapper]("meta")
    assert profiling.counters()[errors] == before + 1
    last = _spans(profiling.TRACER, "t.kernel_error")[-1]
    assert last[COUNTS] == {errors: 1}
    assert kernels.launch_counts() == launches


def test_ring_drops_its_oldest_records_at_capacity():
    tr = profiling.Tracer(capacity=4, root_capacity=2)
    for i in range(6):
        with tr.span(f"s{i}"):
            pass
    snap = tr.snapshot()
    assert [s[NAME] for s in snap["spans"]] == ["s2", "s3", "s4", "s5"]
    assert snap["dropped"] == 2
    assert [r["name"] for r in snap["roots"]] == ["s4", "s5"]
    json.dumps(snap)


def test_armed_root_counts_each_sync_and_restores_the_filters():
    """An armed root counts every synchronising-call warning, once per call
    and not once per call site, keeps its call site, prints none and
    leaves the warning filters and hook as they were."""
    tr = profiling.Tracer()

    def sync():
        warnings.warn(profiling.SYNC_MESSAGE)

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        filters, hook = list(warnings.filters), warnings.showwarning
        with tr.span("unarmed"):
            sync()
        with tr.tracing(), tr.span("armed"):
            with tr.span("walk.x"):
                for _ in range(3):
                    sync()
            sync()
        assert warnings.filters == filters and warnings.showwarning is hook
    assert len(seen) == 1  # the unarmed root's, shown as before
    assert tr.counters() == {"cuda.syncs": 4}
    counts = {s[NAME]: s[COUNTS] for s in _spans(tr)}
    assert counts["walk.x"] == {"cuda.syncs": 3}
    assert counts["armed"] == {"cuda.syncs": 1}
    syncs = tr.snapshot()["syncs"]
    line = sync.__code__.co_firstlineno + 1
    assert [s[1] for s in syncs] == [f"tests/test_torch_profiling.py:{line}"] * 4
    assert [r["armed"] for r in tr.snapshot()["roots"]] == [False, True]


def _crowd_inputs(n_chars=3):
    graph = graph_mod.build_graph_from_dict(synthetic.make_graph_dict())
    skeleton, _ = sk.load_bvh(synthetic.TEST_BVH)
    graph.skeleton = skeleton
    stacked = graph_mod.stack_graph(graph)
    rng = np.random.default_rng(5)
    paths = []
    for _ in range(n_chars):
        h = rng.uniform(-0.4, 0.4)
        pts = [[0.0, 0.0, 0.0]] + [[60.0 * k * np.sin(h), 0.0,
                                    60.0 * k * np.cos(h)] for k in (1, 2, 3)]
        paths.append(spline_path.build(np.asarray(pts, np.float32),
                                       unconstrained_dims=(1,)))
    start = torch.full((n_chars,), stacked.node_id(("walk",
                                                    "beginLeftStance")))
    return skeleton, stacked, spline_path.stack_paths(paths), start


def _walk_ranges(run, entry):
    """A traced run -> ([(walk.* range name, names of the walk.* ranges it
    lies in)] in order, the entry's root record)."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    ranges = sorted(((e.name(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("walk.")),
                    key=lambda r: r[1])
    nested = [(n, [m for m, s2, e2 in ranges if (s2, e2) != (s, e)
                   and s2 <= s and e <= e2]) for n, s, e in ranges]
    (root,) = [r for r in profiling.snapshot()["roots"] if r["name"] == entry]
    spans = [s for s in profiling.snapshot()["spans"]
             if s[NAME].startswith("walk.")]
    assert {s[ROOT] for s in spans} == {root["id"]}
    assert [s[NAME] for s in sorted(spans, key=lambda s: s[START])] == \
        [n for n, _ in nested]
    return nested, root


@pytest.mark.parametrize("entry", ["crowd", "random_walk"])
def test_traced_walks_keep_their_ranges(entry):
    """A traced CPU crowd walk and a traced random_walk_segments show the
    walk.* ranges they showed before the tracer, none nested in another,
    under one profiled, armed root of the entry."""
    n_steps = 3
    skeleton, stacked, paths, start = _crowd_inputs()
    gen = torch.Generator().manual_seed(11)
    if entry == "crowd":
        stages = ["walk.goal", "walk.sample", "walk.select", "walk.rescore",
                  "walk.lm", "walk.back_project", "walk.advance"]
        cfg = constrained_walk.WalkConfig(max_step_frames=48, n_samples=128,
                                          lm_iters=2, lm_threshold=0.0,
                                          lm_frozen=True)
        draws = walk.torch_sampler(gen, stacked, start.shape[0], 128)
        run = lambda: constrained_walk.constrained_walk_full_crowd(  # noqa
            skeleton, stacked, paths, start, n_steps, draws=draws, cfg=cfg)
        want = stages * n_steps
    else:
        draws = walk.torch_sampler(gen, stacked, start.shape[0], 1)
        run = lambda: walk.random_walk_segments(  # noqa: E731
            stacked, start, n_steps, draws, max_step_frames=48)
        want = ["walk.sample", "walk.back_project",
                "walk.advance"] * n_steps + ["walk.align"]
    nested, root = _walk_ranges(run, entry)
    assert [n for n, _ in nested] == want
    assert all(not inside for _, inside in nested)
    assert root["profiled"] and root["armed"]


def test_requests_are_roots_with_their_own_ids(monkeypatch):
    """Each HTTP request is a serve.request root: its request.* spans carry
    its id, two requests have two ids, and an answer 500 (a KernelError)
    counts serve.errors."""
    def plan(ctx, body):
        with profiling.span("request.plan"):
            with profiling.span("request.lm"):
                pass
        if body == b"fail":
            raise cuda_build.KernelError("score_locomotion_candidates "
                                         "launch: CUDA error 209")
        return rest._json(200, {"ok": True})

    monkeypatch.setitem(rest.ROUTES, "/t_plan", (("POST",), plan))
    monkeypatch.setattr(rest, "write_message_to_log", lambda *a: None)
    app = rest.make_app(ctx=None)
    profiling.reset()
    assert app("POST", "/t_plan", b"")[0] == 200
    assert app("POST", "/t_plan", b"fail")[0] == 500
    assert app("GET", "/t_plan", b"")[0] == 405
    snap = profiling.snapshot()
    roots = [r for r in snap["roots"] if r["name"] == "serve.request"]
    ids = [r["id"] for r in roots]
    assert len(ids) == 3 and len(set(ids)) == 3
    assert [r["method"] for r in roots] == ["POST", "POST", "GET"]
    by_root = {}
    for s in snap["spans"]:
        if s[NAME].startswith("request."):
            by_root.setdefault(s[ROOT], []).append(s[NAME])
    assert by_root == {ids[0]: ["request.lm", "request.plan"],
                       ids[1]: ["request.lm", "request.plan"]}
    assert snap["counters"]["serve.errors"] == 1
    errs = [s for s in snap["spans"] if s[COUNTS] and "serve.errors"
            in s[COUNTS]]
    assert [s[ID] for s in errs] == [ids[1]]


def test_cli_trace_out_arms_and_writes_the_snapshot(monkeypatch, tmp_path):
    def run_pipeline(*args, **kwargs):
        with profiling.span("generate"):
            profiling.count("t.cli")
        return "out.bvh"

    monkeypatch.setattr(cli, "run_pipeline", run_pipeline)
    monkeypatch.setattr(profiling.TRACER, "enabled", False)
    out = tmp_path / "trace.json"
    profiling.reset()
    cli.main(["run", "g.zip", "in", "o", "--device", "cpu",
              "--trace-out", str(out)])
    snap = json.loads(out.read_text())
    (root,) = snap["roots"]
    assert (root["name"], root["armed"]) == ("generate", True)
    assert snap["counters"] == {"t.cli": 1}
