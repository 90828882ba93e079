"""The crowd walk's LM stage (walk.lm, the frozen closed form) replayed as
one CUDA graph (`constrained_walk.LM_GRAPHS`, `ops.cuda_graphs`), on the
card: a 64-character crowd of the reference-scale model over 3 steps, on
the root route and on the end-effector closed route.  They skip without a
card.  This file imports no JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_lm_graph.py
"""

import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu_torch.constraints import compiled  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as graph_mod  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as sk  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels, spline_path  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import walk  # noqa: E402
from morphablegraphs_tpu_torch.utils import profiling, synthetic  # noqa: E402

N_CHARS, N_STEPS = 64, 3
EE_JOINT = "RightHand"
ROUTES = {
    "root": dict(lm_frozen=True),
    "ee": dict(pallas_ee=EE_JOINT, lm_frozen=True, frozen_ee=EE_JOINT),
    # the step block as kernel B4 instead of B2
    "ee_fused": dict(pallas_ee=EE_JOINT, lm_frozen=True, frozen_ee=EE_JOINT,
                     lm_fused_step=True),
}
COUNTERS = ("walk.lm.eager", "walk.lm.graph_captures",
            "walk.lm.graph_replays")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(cuda):
    graph = graph_mod.build_graph_from_dict(
        synthetic.make_reference_scale_graph_dict())
    skel, _ = sk.load_bvh(synthetic.REF_BVH)
    return skel, graph_mod.stack_graph(graph, device=cuda)


def _paths(n_chars, device, seed=1):
    rng = np.random.default_rng(seed)
    paths = []
    for _ in range(n_chars):
        pts = [[0.0, 0.0, 0.0]]
        x, z, h = 0.0, 0.0, rng.uniform(-0.6, 0.6)
        for _ in range(3):
            h += rng.uniform(-0.4, 0.4)
            x, z = x + 60 * np.sin(h), z + 60 * np.cos(h)
            pts.append([x, 0.0, z])
        paths.append(spline_path.build(np.asarray(pts, np.float32),
                                       unconstrained_dims=(1,),
                                       granularity=256, device="cpu"))
    return spline_path.map_leaves(spline_path.stack_paths(paths),
                                  lambda t: t.to(device))


def _crowd(model, route, n_chars=N_CHARS, seed=2):
    """run() -> the outputs of one crowd's walk, the same paths and draws
    at every call."""
    skel, st = model
    dev = st.eigen_s.device
    paths = _paths(n_chars, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sampler = walk.torch_sampler(gen, st, n_chars, 128)
    draws = [sampler(t) for t in range(N_STEPS)]
    start = torch.full((n_chars,), st.node_id(("walk", "beginLeftStance")),
                       device=dev)
    cfg = cw.WalkConfig(max_step_frames=160, n_samples=128, lm_iters=3,
                        lm_threshold=5.0, **ROUTES[route])
    scs = None
    if route != "root":
        scs = cw.stack_steps(compiled.set_keyframe_constraint(
            compiled.empty_step_constraints(skel, 0), 2, skel, EE_JOINT,
            129.0, position=np.asarray((20.0, 110.0, 80.0), np.float32)),
            N_STEPS)

    def run():
        out = cw.constrained_walk_full_crowd(
            skel, st, paths, start, N_STEPS, draws=lambda t: draws[t],
            step_scs=scs, cfg=cfg)
        torch.cuda.synchronize()
        return out

    return run


def _added(before):
    after = profiling.counters()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in COUNTERS + tuple(kernels.LAUNCHES + n
                                      for n in kernels.KERNELS)}


@pytest.fixture
def fresh_graphs():
    cw.LM_GRAPHS.clear()
    yield cw.LM_GRAPHS
    cw.LM_GRAPHS.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graphed_stage_is_the_eager_stage(model, route, fresh_graphs,
                                          monkeypatch):
    """At every step the graphed stage's (s, err) equal, bit for bit, the
    eager stage's on the same inputs; step 0 runs eagerly, step 1 captures
    and replays, step 2 replays; the latents step 1 emitted are unchanged
    after step 2's replay (they are clones, not the graph's outputs)."""
    run = _crowd(model, route)
    graphs_run = fresh_graphs.run
    steps = []

    def checked(fn, inputs, key=None, reads=()):
        out = graphs_run(fn, inputs, key, reads)
        eager = fn(*inputs)
        steps.append(all(torch.equal(a, b) for a, b in zip(out, eager)))
        return out

    emitted = []
    emit_step = cw._emit_step

    def keep(g, path, state, s, *a, **kw):
        emitted.append((s, s.clone()))
        return emit_step(g, path, state, s, *a, **kw)

    monkeypatch.setattr(fresh_graphs, "run", checked)
    monkeypatch.setattr(cw, "_emit_step", keep)
    before = profiling.counters()
    run()
    added = _added(before)
    assert steps == [True] * N_STEPS
    assert (added["walk.lm.eager"], added["walk.lm.graph_captures"],
            added["walk.lm.graph_replays"]) == (1, 1, 2)
    assert len(emitted) == N_STEPS
    assert all(torch.equal(s, kept) for s, kept in emitted)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graphed_walk_counts_the_kernels_an_eager_walk_runs(
        model, route, fresh_graphs, monkeypatch):
    """A graphed walk launches every kernel (B2 or B4, and B5 in the LM) as
    often as an eager one (a capture counts nothing, each replay its
    kernels) and gives the same walk; a cache of no keys runs every stage
    eagerly."""
    run = _crowd(model, route)
    before = profiling.counters()
    graphed = run()
    counts_graphed = _added(before)
    monkeypatch.setattr(fresh_graphs, "capacity", 0)
    fresh_graphs.clear()
    before = profiling.counters()
    eager = run()
    counts_eager = _added(before)
    assert counts_graphed["walk.lm.graph_replays"] == 2
    assert counts_eager["walk.lm.eager"] == N_STEPS
    assert counts_eager["walk.lm.graph_replays"] == 0
    step = "lm_delta" if ROUTES[route].get("lm_fused_step") else "chol_solve"
    for name in (step, "gmm_scores"):
        assert counts_eager[kernels.LAUNCHES + name] > 0, name
    for name in kernels.KERNELS:
        key = kernels.LAUNCHES + name
        assert counts_graphed[key] == counts_eager[key], name
    for a, b in zip(graphed, eager):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_second_crowd_size_captures_its_own_graph(model, fresh_graphs):
    """Each crowd size is its own key: 32 characters after 64 see, capture
    and replay their own graph, and 64 then replays its graph again."""
    big, small = _crowd(model, "root"), _crowd(model, "root", n_chars=32)
    before = profiling.counters()
    big()
    assert _added(before)["walk.lm.graph_captures"] == 1
    before = profiling.counters()
    small()
    added = _added(before)
    assert (added["walk.lm.eager"], added["walk.lm.graph_captures"],
            added["walk.lm.graph_replays"]) == (1, 1, 2)
    before = profiling.counters()
    big()
    added = _added(before)
    assert (added["walk.lm.eager"], added["walk.lm.graph_captures"],
            added["walk.lm.graph_replays"]) == (0, 0, N_STEPS)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_eager_stage_never_synchronises(model, route, fresh_graphs,
                                            monkeypatch):
    """The LM stage makes no synchronising CUDA call (a capture could not
    hold one): run eagerly under the sync debug mode, every call site it
    names is listed."""
    run = _crowd(model, route)
    stage = cw._lm_stage
    sites = set()

    def watched(*a, **kw):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = stage(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        sites.update(f"{w.filename}:{w.lineno}" for w in caught
                     if profiling.SYNC_MESSAGE in str(w.message))
        return out

    monkeypatch.setattr(fresh_graphs, "capacity", 0)
    monkeypatch.setattr(cw, "_lm_stage", watched)
    before = profiling.counters()
    run()
    assert _added(before)["walk.lm.eager"] == N_STEPS
    assert not sites, sorted(sites)
