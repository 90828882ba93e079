"""The request path's exact LM (stage request.lm, `generator.refine_lm`)
replayed as one CUDA graph per primitive and constraint layout
(`generator.LM_GRAPHS`, `ops.cuda_graphs`).

On the CPU: the stage stays eager and is the LM composed by hand, the
graph key tells apart what the stage depends on, and the constants made
once equal the fresh ones they replaced.  The steps come from the
service's requests (`portbench/drivers/service.py`) of the action
configuration at 4 joints.  On the card (`cuda`, skipped without one),
the same at the configuration's 19 joints and standard settings:

    python -m pytest --noconftest -o addopts="" \\
        tests/test_torch_request_lm_graph.py

This file imports no JAX."""

import dataclasses
import inspect
import json
import pathlib
import sys
import warnings

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from morphablegraphs_tpu_torch.constraints import compiled  # noqa: E402
from morphablegraphs_tpu_torch.ops import cuda_graphs, kernels  # noqa: E402
from morphablegraphs_tpu_torch.ops import lm as lm_ops, quat  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import generator  # noqa: E402
from morphablegraphs_tpu_torch.utils import profiling  # noqa: E402
from portbench.drivers import service  # noqa: E402
from portbench.reference import requests as rq  # noqa: E402

# a seed whose walk request ends in a few steps on the small model (as in
# tests/test_torch_service_requests.py)
SEED = 3000000008
SMALL = dict(n_joints=4, n_dim=19, n_basis_spatial=8, k_s=5, k_t=2,
             n_components=3, n_canonical_frames=40)
SHORT = dict(walk_cm=[120.0, 240.0], action_walk_cm=[60.0, 120.0])
SIZES = dict(n_random_samples=16, lm_iterations=3)
COUNTERS = ("request.lm.eager", "request.lm.graph_captures",
            "request.lm.graph_replays")
SIGNATURE = inspect.signature(generator.refine_lm)


def _load(path):
    with open(ROOT / path) as f:
        return json.load(f)


def _driver(device, small: bool):
    config = _load("portbench/configs/ref_actions.json")
    traffic = _load("portbench/traffic/service_requests.json")
    if small:
        config, traffic = dict(config, **SMALL), dict(traffic, **SHORT)
    d = service.Driver(config, traffic, SEED, device)
    if small:
        d.ctx.configure(SIZES)
        d.settings = rq.Settings(**SIZES)
    return d


def _record(driver, monkeypatch, kinds=("walk", "action")):
    """Every refine_lm call of one request of each kind: (skeleton, prim,
    set, starts, the other arguments by name), in order."""
    calls = []
    refine = generator.refine_lm

    def spy(*a, **kw):
        bound = SIGNATURE.bind(*a, **kw)
        bound.apply_defaults()
        args = dict(bound.arguments)
        calls.append((args.pop("skeleton"), args.pop("prim"),
                      args.pop("sc"), args.pop("s0").clone(), args))
        return refine(*a, **kw)

    with monkeypatch.context() as m:
        m.setattr(generator, "refine_lm", spy)
        for kind in kinds:
            driver.walk(next(i for i in range(8)
                             if driver.request(i)[0] == kind))
    return calls


def _cases(calls) -> dict:
    """A root-only walk step with its trajectory, and a step whose
    keyframe is off the root (the dense FK)."""
    walk = next(c for c in calls
                if c[4]["root_only"] and c[2].traj is not None)
    keyframe = next(c for c in calls if not c[4]["root_only"])
    return {"walk": walk, "keyframe": keyframe}


def _added(before):
    after = profiling.counters()
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in COUNTERS + tuple(kernels.LAUNCHES + n
                                      for n in kernels.KERNELS)}


def _by_hand(skel, prim, sc, s0, kw):
    """The exact LM and its final error composed from their parts, the
    family gate made afresh."""
    rows = generator._rows(sc, s0.shape[0])
    gate = {k: kw[k] for k in ("use_traj", "use_ca", "use_ts")}
    fam = dict(gate, families=kw["families"], root_only=kw["root_only"])
    active = compiled.active_mask(rows) * torch.as_tensor(
        compiled.static_family_gate(**gate), device=s0.device)

    def residuals(s):
        res = compiled.evaluate_residuals(skel, prim, rows, s, **fam)
        return active * (kw["error_scale"] * res + kw["quality_scale"]
                         * generator._gmm_nll(prim, s)[:, None])

    s_opt, _ = lm_ops.lm_minimize(residuals, s0, kw["n_iters"],
                                  init_lambda=kw["init_lambda"])
    return s_opt, compiled.error_from_residuals(compiled.evaluate_residuals(
        skel, prim, rows, s_opt, **fam))


def _key(skel, prim, sc, s0, kw):
    """The key request.lm's graphs are kept under for refine_lm's
    arguments (`cuda_graphs.stage_key` of what refine_lm hands
    `LM_GRAPHS.run`); the stage itself is not run."""
    keys = []

    def run(fn, inputs, key=None, reads=()):
        keys.append(cuda_graphs.stage_key(
            key, cuda_graphs._flatten(inputs, []), reads))
        return s0, s0.new_zeros(s0.shape[:1])

    with pytest.MonkeyPatch.context() as m:
        m.setattr(generator.LM_GRAPHS, "run", run)
        generator.refine_lm(skel, prim, sc, s0, **kw)
    return keys[0]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_calls():
    with pytest.MonkeyPatch.context() as m:
        return _record(_driver("cpu", small=True), m)


@pytest.fixture(scope="module")
def cpu_cases(cpu_calls):
    return _cases(cpu_calls)


def test_stage_graphs_run_cpu_inputs_eagerly_under_any_key(cpu_cases):
    """On the CPU a stage runs as under no key: `StageGraphs` runs CPU
    inputs eagerly whatever key and reads it is handed, and keeps no key
    for them."""
    skel, prim, sc, s0, kw = cpu_cases["walk"]
    graphs = cuda_graphs.StageGraphs("test.cpu")
    rows = generator._rows(sc, s0.shape[0])

    def stage(rows, s):
        return s + 1.0, rows.kf_active.sum(-1)

    before = profiling.counters()
    for key, reads in ((("k",), ()), (("k",), (prim.eigen_s,)),
                       (_key(skel, prim, sc, s0, kw), (prim.mean_s,))):
        for _ in range(3):
            out = graphs.run(stage, (rows, s0), key, reads)
            assert all(torch.equal(a, b)
                       for a, b in zip(out, stage(rows, s0)))
    after = profiling.counters()
    assert {k: after.get(k, 0) - before.get(k, 0)
            for k in ("test.cpu.eager", "test.cpu.graph_captures",
                      "test.cpu.graph_replays")} == {
        "test.cpu.eager": 9, "test.cpu.graph_captures": 0,
        "test.cpu.graph_replays": 0}
    assert not graphs._entries


@pytest.mark.parametrize("case", ["walk", "keyframe"])
def test_cpu_stage_is_eager_and_the_lm_by_hand(cpu_cases, case):
    """On the CPU refine_lm counts one eager run of request.lm and returns
    what lm_minimize and the final exact error return called directly."""
    skel, prim, sc, s0, kw = cpu_cases[case]
    before = profiling.counters()
    s_opt, err = generator.refine_lm(skel, prim, sc, s0, **kw)
    added = _added(before)
    assert (added["request.lm.eager"], added["request.lm.graph_captures"],
            added["request.lm.graph_replays"]) == (1, 0, 0)
    s_ref, e_ref = _by_hand(skel, prim, sc, s0, kw)
    assert torch.equal(s_opt, s_ref) and torch.equal(err, e_ref)
    assert err.shape == (s0.shape[0],)


VARIANTS = {
    "primitive": None,  # the keyframe step's primitive
    "moved_table": None,  # the primitive's eigenvectors at a new address
    "families": dict(families=frozenset()),
    "root_only": dict(root_only=False),
    "n_iters": dict(n_iters=5),
    "quality_scale": dict(quality_scale=0.2),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_key_separates_what_the_stage_depends_on(cpu_cases, variant):
    skel, prim, sc, s0, kw = cpu_cases["walk"]
    base = _key(skel, prim, sc, s0, kw)
    if variant == "primitive":
        other_prim = cpu_cases["keyframe"][1]
        assert other_prim.name != prim.name
        other = _key(skel, other_prim, sc, s0, kw)
    elif variant == "moved_table":
        moved = dataclasses.replace(prim, eigen_s=prim.eigen_s.clone())
        assert torch.equal(moved.eigen_s, prim.eigen_s)
        other = _key(skel, moved, sc, s0, kw)
    else:
        other = _key(skel, prim, sc, s0, dict(kw, **VARIANTS[variant]))
    assert other != base


def test_key_is_equal_for_equal_arguments(cpu_cases):
    skel, prim, sc, s0, kw = cpu_cases["walk"]
    same = dict(kw, families=set(kw["families"]),
                n_iters=int(kw["n_iters"]))
    key = _key(skel, prim, sc, s0, kw)
    assert key == _key(skel, prim, sc, s0, same)
    assert hash(key) == hash(_key(skel, prim, sc, s0, same))


@pytest.mark.parametrize("flags", [(True, True, False), (True, False, False),
                                   (False, False, True), (False, True, True)])
def test_family_gate_is_the_fresh_gate(flags):
    """`compiled.family_gate` (refine_lm, the global spatial LM) equals the
    per-call tensor it replaced and is made once."""
    fresh = torch.as_tensor(compiled.static_family_gate(*flags),
                            device="cpu")
    gate = compiled.family_gate("cpu", *flags)
    assert gate.dtype == fresh.dtype and torch.equal(gate, fresh)
    assert compiled.family_gate(torch.device("cpu"), *flags) is gate


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_conjugate_constant_is_the_fresh_constant(dtype):
    q = torch.randn(5, 3, 4, generator=torch.Generator().manual_seed(3),
                    dtype=dtype)
    fresh = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype)
    out = quat.conjugate(q)
    assert out.dtype == dtype and torch.equal(out, fresh)


# ---------------------------------------------------------------------------
# The card: the action configuration at 19 joints, standard settings
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def served(cuda):
    """Two of the driver's requests (one of each kind) through the
    service, the stage graphed: their refine_lm calls, every key they
    saw, the keys evicted by the end and the counts they added."""
    generator.LM_GRAPHS.clear()
    seen = set()
    run = generator.LM_GRAPHS.run

    def watch(fn, inputs, key=None, reads=()):
        if key is not None:
            seen.add(cuda_graphs.stage_key(
                key, cuda_graphs._flatten(inputs, []), reads))
        return run(fn, inputs, key, reads)

    before = profiling.counters()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(generator.LM_GRAPHS, "run", watch)
        calls = _record(_driver(cuda, small=False), m)
    torch.cuda.synchronize()
    added = _added(before)
    evicted = [k for k in seen if k not in generator.LM_GRAPHS._entries]
    generator.LM_GRAPHS.clear()
    return dict(calls=calls, seen=seen, evicted=evicted, added=added)


@pytest.fixture(scope="module")
def card_cases(served):
    """The walk and keyframe steps (sets the kernel `request_lm` covers),
    and the walk step with collision avoidance (a set the eager stage
    runs)."""
    cases = _cases(served["calls"])
    skel, prim, sc, s0, kw = cases["walk"]
    cases["walk_ca"] = (skel, prim, sc, s0, dict(kw, use_ca=True))
    return cases


@pytest.fixture
def fresh_graphs():
    generator.LM_GRAPHS.clear()
    yield generator.LM_GRAPHS
    generator.LM_GRAPHS.clear()


def _starts(case, c: int):
    """The step's start, and at c = 3 two more starts around it."""
    skel, prim, sc, s0, kw = case
    if c > 1:
        noise = torch.randn((c - 1,) + s0.shape[1:],
                            generator=torch.Generator().manual_seed(5))
        s0 = torch.cat([s0[:1], s0[:1] + 0.05 * noise.to(s0.device)])
    return skel, prim, sc, s0, kw


def _refine(case):
    skel, prim, sc, s0, kw = case
    out = generator.refine_lm(skel, prim, sc, s0, **kw)
    torch.cuda.synchronize()
    return out


def _stage(case):
    """The stage refine_lm runs on the card for the case's set: the kernel
    `request_lm` for a set it covers, else the eager stage."""
    skel, prim, sc, s0, kw = case
    covered = generator.lm_kernel_covers(skel, prim, sc, kw["use_ca"],
                                         kw["use_ts"], kw["families"],
                                         kw["root_only"])
    return generator._lm_kernel_stage if covered else generator._lm_stage


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("case", ["walk", "keyframe", "walk_ca"])
def test_graphed_stage_is_the_eager_stage(card_cases, case, c,
                                          fresh_graphs):
    """The first sight runs eagerly, the second captures and replays, the
    third replays: each returns, bit for bit, the stage's (s_opt, err) run
    directly (the kernel's for the walk and keyframe sets, the eager
    stage's for walk_ca), and a replay's outputs stay as they were after
    the next one (clones, not the graph's own outputs)."""
    args = _starts(card_cases[case], c)
    skel, prim, sc, s0, kw = args
    assert (_stage(args) is generator._lm_stage) == (case == "walk_ca")
    eager = _stage(args)(skel, prim, generator._rows(sc, c), s0, **kw)
    before = profiling.counters()
    outs = [_refine(args) for _ in range(3)]
    kept = [tuple(t.clone() for t in out) for out in outs]
    added = _added(before)
    assert (added["request.lm.eager"], added["request.lm.graph_captures"],
            added["request.lm.graph_replays"]) == (1, 1, 2)
    for out, same in zip(outs, kept):
        assert out[0].shape == (c, s0.shape[1]) and out[1].shape == (c,)
        for a, b, e in zip(out, same, eager):
            assert torch.equal(a, e) and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walk", "keyframe", "walk_ca"])
def test_graphed_stage_counts_the_kernels_an_eager_stage_runs(
        card_cases, case, fresh_graphs, monkeypatch):
    """Three graphed runs (eager, capture + replay, replay) launch every
    kernel (request_lm for the walk and keyframe sets; B2 and B5 for
    walk_ca, the eager stage) as often as three eager runs; a cache of no
    keys runs every stage eagerly."""
    args = card_cases[case]
    before = profiling.counters()
    graphed = [_refine(args) for _ in range(3)]
    counts_graphed = _added(before)
    monkeypatch.setattr(fresh_graphs, "capacity", 0)
    fresh_graphs.clear()
    before = profiling.counters()
    eager = [_refine(args) for _ in range(3)]
    counts_eager = _added(before)
    assert counts_graphed["request.lm.graph_replays"] == 2
    assert (counts_eager["request.lm.eager"],
            counts_eager["request.lm.graph_replays"]) == (3, 0)
    ran = (("chol_solve", "gmm_scores") if case == "walk_ca"
           else ("request_lm",))
    assert (_stage(args) is generator._lm_stage) == (case == "walk_ca")
    for name in ran:
        assert counts_eager[kernels.LAUNCHES + name] > 0, name
    for name in kernels.KERNELS:
        key = kernels.LAUNCHES + name
        assert counts_graphed[key] == counts_eager[key], name
    for g, e in zip(graphed, eager):
        assert all(torch.equal(a, b) for a, b in zip(g, e))


@pytest.mark.cuda
def test_a_second_primitive_captures_its_own_graph(card_cases,
                                                   fresh_graphs):
    walk, keyframe = card_cases["walk"], card_cases["keyframe"]
    assert walk[1].name != keyframe[1].name
    before = profiling.counters()
    _refine(walk), _refine(walk)
    _refine(keyframe), _refine(keyframe)
    added = _added(before)
    assert (added["request.lm.eager"], added["request.lm.graph_captures"],
            added["request.lm.graph_replays"]) == (2, 2, 2)
    before = profiling.counters()
    _refine(walk), _refine(keyframe)
    added = _added(before)
    assert (added["request.lm.eager"], added["request.lm.graph_captures"],
            added["request.lm.graph_replays"]) == (0, 0, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walk", "keyframe", "walk_ca"])
def test_the_eager_stage_never_synchronises(card_cases, case, fresh_graphs,
                                            monkeypatch):
    """The stage makes no synchronising CUDA call (a capture could not hold
    one): run eagerly under the sync debug mode (the kernel's stage for the
    walk and keyframe sets, the eager stage for walk_ca), every call site
    it names is listed."""
    stage = _stage(card_cases[case])
    assert (stage is generator._lm_stage) == (case == "walk_ca")
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
    monkeypatch.setattr(generator, stage.__name__, watched)
    before = profiling.counters()
    _refine(card_cases[case])
    assert _added(before)["request.lm.eager"] == 1
    assert not sites, sorted(sites)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walk", "keyframe"])
def test_the_stage_syncs_once_at_its_gate(card_cases, case, fresh_graphs):
    """`_refine_starts`, the span request.lm, synchronises once: at the
    threshold gate before the LM, never after the replay (the LM's device
    time is left to the step's next sync)."""
    skel, prim, sc, s0, kw = card_cases[case]
    errs = torch.full((s0.shape[0],), 1e3, device=s0.device)
    args = (skel, prim, sc, s0, errs, 0.0, kw["n_iters"], kw["error_scale"],
            kw["quality_scale"])
    fam = {k: kw[k] for k in ("use_traj", "use_ca", "use_ts", "families",
                              "root_only")}

    def sites():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                s, err = generator._refine_starts(*args, **fam)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        assert s.shape == s0.shape[1:] and err.shape == ()
        return [(w.filename, w.lineno) for w in caught
                if profiling.SYNC_MESSAGE in str(w.message)]

    eager = sites()
    generator._refine_starts(*args, **fam)  # the capture, and a replay
    replay = sites()
    assert len(eager) == 1 and eager == replay, (eager, replay)
    assert eager[0][0].endswith("generator.py")


@pytest.mark.cuda
def test_two_service_requests_leave_no_key_evicted(served):
    """Two of the driver's requests, one of each kind, see fewer keys
    than the stage keeps: none is evicted, and the keys seen again were
    captured and replayed."""
    assert served["seen"]
    assert len(served["seen"]) <= generator.LM_GRAPHS.capacity
    assert not served["evicted"]
    added = served["added"]
    assert added["request.lm.graph_captures"] >= 1
    assert added["request.lm.graph_replays"] >= 1
    # each run is eager or a replay (a capture is followed by its replay)
    assert added["request.lm.eager"] + added["request.lm.graph_replays"] \
        == len(served["calls"])
