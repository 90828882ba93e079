"""The request path's exact LM as one kernel (`kernels.request_lm`,
csrc/request_lm.cu), which `generator.refine_lm` runs on a CUDA device for
the sets `generator.lm_kernel_covers` (no collision avoidance, no
trajectory set, single-slot families at most the direction).

On the CPU: which keys take the kernel, the packing of a step's set into
the kernel's arguments, the C source's argument order, and refine_lm on
CPU tensors (the plain stage, the LM composed by hand).  On the card
(`cuda`, skipped without one) the kernel against the plain version, the
eager stage `generator._lm_stage`, at the service's widths
(`portbench/model_actions.py`, 19 joints): one iteration from the same
start, the gain of ten iterations over seeded starts, its launches under
the stage's graph, and the sets it leaves to the eager stage:

    python -m pytest --noconftest -o addopts="" \\
        tests/test_torch_request_lm_kernel.py

This file imports no JAX."""

import dataclasses
import pathlib
import re
import statistics
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from morphablegraphs_tpu_torch.constraints import compiled  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as sk_mod  # noqa: E402
from morphablegraphs_tpu_torch.ops import consts, kernels  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import generator  # noqa: E402
from morphablegraphs_tpu_torch.utils import profiling  # noqa: E402
from test_torch_request_lm_graph import (  # noqa: E402
    _by_hand, _driver, _record)

COUNTERS = ("request.lm.fallback", "request.lm.eager",
            "request.lm.graph_captures", "request.lm.graph_replays",
            kernels.LAUNCHES + "request_lm", kernels.LAUNCHES + "chol_solve")
# one LM iteration from the same start: the kernel's latent within this
# share of the largest latent entry, or within NUDGE_FACTOR times what the
# eager stage itself moves when its start moves by NUDGE (relative); a
# step whose trajectory search changes an index under such a nudge moves
# by up to ~2% at the service's widths
S_RTOL, NUDGE, NUDGE_FACTOR, N_NUDGES = 1e-3, 1e-6, 4.0, 5
# the kernel's final error against the exact evaluator at its latent (the
# search's index can change within float32 rounding: ~2.4e-4 seen)
ERR_RTOL = 2e-3
# ten iterations over seeded starts: the judge's lm_shortfall (the median
# over starts the eager LM improves by MIN_GAIN or more of (the kernel's
# error - the eager stage's) / the eager stage's gain) at most SHORTFALL,
# and its lm_stuck_share (the share of such starts whose shortfall is over
# STUCK) at most STUCK_SHARE (portbench/reference/judge.py and the service
# cell's limits)
N_STARTS, START_NOISE, MIN_GAIN, SHORTFALL = 24, 0.1, 0.1, 0.1
STUCK, STUCK_SHARE = 0.5, 0.34


def _added(before):
    after = profiling.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


def _covers(case, **change):
    skel, prim, sc, s0, kw = case
    kw = dict(kw, **change)
    return generator.lm_kernel_covers(skel, prim, sc, kw["use_ca"],
                                      kw["use_ts"], kw["families"],
                                      kw["root_only"])


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_cases():
    with pytest.MonkeyPatch.context() as m:
        calls = _record(_driver("cpu", small=True), m)
    walk = next(c for c in calls
                if c[4]["root_only"] and c[2].traj is not None)
    keyframe = next(c for c in calls if not c[4]["root_only"])
    return {"walk": walk, "keyframe": keyframe}


# (families, use_traj, use_ca, use_ts, root_only) -> the kernel takes it
RULE = {
    "path_step": ({"dir"}, True, False, False, True, True),
    "path_step_dense_fk": ({"dir"}, True, False, False, False, True),
    "keyframe_step": (set(), False, False, False, False, True),
    "keyframe_on_root": (set(), False, False, False, True, True),
    "keyframe_with_path": (set(), True, False, False, False, True),
    "direction_only": ({"dir"}, False, False, False, True, True),
    "look_at": ({"dir", "la"}, True, False, False, False, False),
    "relative_transform": ({"rt"}, False, False, False, False, False),
    "joint_rotation": ({"jr"}, False, False, False, True, False),
    "pose": ({"pose"}, True, False, False, False, False),
    "collision_avoidance": ({"dir"}, True, True, False, False, False),
    "trajectory_set": (set(), False, False, True, False, False),
    "every_family": (None, True, False, False, False, False),
}


@pytest.mark.parametrize("name", sorted(RULE))
def test_dispatch_rule(cpu_cases, name):
    """The kernel takes a key without collision avoidance and trajectory
    set whose single-slot families are at most the direction, the
    trajectory on or off, root_only or not; any other key the eager
    stage."""
    fams, use_traj, use_ca, use_ts, root_only, want = RULE[name]
    skel, prim, sc, s0, kw = cpu_cases["walk"]
    got = generator.lm_kernel_covers(
        skel, prim, sc, use_ca, use_ts,
        None if fams is None else frozenset(fams), root_only)
    assert got is want
    assert generator.lm_kernel_covers(
        skel, prim, sc.replace(traj=None), use_ca, use_ts,
        None if fams is None else frozenset(fams), root_only) is want


def test_dispatch_rule_refuses_what_the_kernel_cannot_hold(cpu_cases):
    """A mixture over other dims than the latent's, or a set field the
    kernel cannot read in place (not dense, of another type) send a
    covered key to the eager stage on any device (the sizes the library
    takes are asked on the card: test_the_library_refuses_what_it_cannot_
    hold)."""
    skel, prim, sc, s0, kw = cpu_cases["walk"]
    fam = frozenset({"dir"})
    assert generator.lm_kernel_covers(skel, prim, sc, False, False, fam, True)
    wide = dataclasses.replace(prim, n_time=40)
    other = dataclasses.replace(prim, gmm=dataclasses.replace(
        prim.gmm, means=prim.gmm.means[:, :-1]))
    strided = sc.replace(prev_last=torch.stack([sc.prev_last] * 2, -1)[..., 0])
    assert not strided.prev_last.is_contiguous()
    narrow = sc.replace(kf_node=sc.kf_node.int())
    for p, s in ((wide, sc), (other, sc), (prim, strided), (prim, narrow)):
        assert not generator.lm_kernel_covers(skel, p, s, False, False, fam,
                                              True)


@pytest.mark.parametrize("table", ["device_tables", "constant"])
def test_cached_tables_made_inside_a_transform_keep_storage(cpu_cases,
                                                            table):
    """The skeleton's device tables and the ops' constants, first asked for
    inside torch.func.jvp (as the eager stage asks), are cached as plain
    tensors: the kernel's wrapper reads their storage afterwards, and they
    hold the values asked for.  Keys no other test asks for (a skeleton of
    its own offsets, values of its own), so no cache is cleared."""
    skel = cpu_cases["walk"][0]
    skel = dataclasses.replace(skel, offsets=skel.offsets * 1.375)
    values = (0.25, -1.5, 3.0, 1.0 / 1.375)
    dev = torch.device("cpu")
    make, want = {
        "device_tables": (lambda: sk_mod.device_tables(
            skel, torch.float64, dev)["offsets"],
            torch.as_tensor(skel.offsets, dtype=torch.float64)),
        "constant": (lambda: consts.constant(values, torch.float64, dev),
                     torch.tensor(values, dtype=torch.float64)),
    }[table]
    x = torch.ones(want.shape[-1], dtype=torch.float64)
    torch.func.jvp(lambda v: v * make(), (x,), (x,))
    cached = make()
    assert cached.data_ptr() != 0
    assert torch.equal(cached, want)


@pytest.mark.parametrize("case", ["walk", "keyframe"])
def test_packing_round_trips_the_set(cpu_cases, case):
    """Each set field the kernel reads is row 0 of the set's own tensor (a
    view: nothing is copied), and a set rebuilt from the packed fields
    evaluates to the same residuals; the sizes and settings are the
    primitive's and refine_lm's."""
    skel, prim, sc, s0, kw = cpu_cases[case]
    c = 3
    starts = s0.expand(c, -1).contiguous()
    rows = generator._rows(sc, c)
    args = kernels.pack_request_lm(
        skel, prim, rows, starts, kw["n_iters"], kw["error_scale"],
        kw["quality_scale"], kw["init_lambda"], "dir" in kw["families"],
        kw["use_traj"], kw["root_only"])
    t = args.tensors
    assert tuple(t) == kernels.REQUEST_LM_POINTERS
    rebuilt = {}
    for name in kernels.REQUEST_LM_SET_FIELDS:
        leaf = kernels._set_leaf(sc, name)
        if leaf is None:
            assert t[name] is None
            continue
        assert torch.equal(t[name], leaf[0]), name
        assert t[name].data_ptr() == leaf.data_ptr(), name
        rebuilt[name] = t[name][None]
    traj = sc.traj
    if traj is not None:
        traj = traj.__class__(**{f: rebuilt.pop("traj." + f) for f in (
            "points", "n_points", "table_u", "table_arc", "table_points",
            "unconstrained")})
    same = sc.replace(traj=traj, **rebuilt)
    fam = {k: kw[k] for k in ("use_traj", "use_ca", "use_ts", "families",
                              "root_only")}
    assert torch.equal(
        compiled.evaluate_residuals(skel, prim, same, s0, **fam),
        compiled.evaluate_residuals(skel, prim, sc, s0, **fam))
    assert t["s0"] is starts and t["s_out"].shape == (c, prim.n_latent)
    assert t["err_out"].shape == (c,)
    assert t["eigen"] is prim.eigen_s and t["gmm_prec"] is prim.gmm.prec_chol
    assert args.ints[:10] == (
        c, prim.n_latent, prim.n_spatial, prim.n_basis, prim.n_dim,
        prim.knots_s.shape[-1], skel.n_nodes, prim.gmm.weights.shape[-1],
        0 if sc.traj is None or not kw["use_traj"]
        else sc.traj.table_arc.shape[-1], kw["n_iters"])
    assert args.ints[10:14] == (int("dir" in kw["families"]),
                                int(kw["use_traj"]),
                                int(kw["use_traj"] and sc.traj is not None),
                                int(kw["root_only"]))
    assert args.ints[15:] == prim.gmm.prec_chol.stride()
    assert args.floats == (kw["error_scale"], kw["quality_scale"],
                           kw["init_lambda"], kernels.DAMP_FLOOR_REL)


def _enum(source: str, name: str) -> list:
    body = re.search(r"enum %s \{(.*?)\};" % name, source, re.S).group(1)
    return [v.strip() for v in body.split(",") if v.strip()]


def test_argument_order_is_the_sources():
    """REQUEST_LM_POINTERS, the ints and the floats are in the order of
    the kernel source's enums."""
    src = (ROOT / "morphablegraphs_tpu_torch" / "csrc"
           / "request_lm.cu").read_text()
    ptrs = _enum(src, "Ptr")
    assert ptrs[-1] == "N_PTRS"
    assert ptrs[:-1] == ["P_" + n.upper().replace("TRAJ.", "TR_")
                         for n in kernels.REQUEST_LM_POINTERS]
    ints, flts = _enum(src, "Int"), _enum(src, "Flt")
    assert ints[-1] == "N_INTS" and flts[-1] == "N_FLTS"
    assert len(ints) - 1 == 18 and len(flts) - 1 == 4


@pytest.mark.parametrize("case", ["walk", "keyframe"])
def test_cpu_refine_lm_runs_the_plain_stage(cpu_cases, case):
    """On CPU tensors refine_lm runs the plain stage whatever the set:
    what lm_minimize and the exact error give when composed by hand, no
    kernel launched; a covered set counts no fallback, a set with
    collision avoidance one."""
    skel, prim, sc, s0, kw = cpu_cases[case]
    assert _covers(cpu_cases[case])
    before = profiling.counters()
    s_opt, err = generator.refine_lm(skel, prim, sc, s0, **kw)
    added = _added(before)
    assert added["request.lm.fallback"] == 0
    assert added[kernels.LAUNCHES + "request_lm"] == 0
    s_ref, e_ref = _by_hand(skel, prim, sc, s0, kw)
    assert torch.equal(s_opt, s_ref) and torch.equal(err, e_ref)
    before = profiling.counters()
    generator.refine_lm(skel, prim, sc, s0, **dict(kw, use_ca=True))
    assert _added(before)["request.lm.fallback"] == 1


# ---------------------------------------------------------------------------
# The card: the action configuration at 19 joints, standard settings
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_cases(cuda):
    """Steps of two service requests (one of each kind) on the card: a
    root-only path step with a previous clip and the first (from the start
    pose), a RightHand keyframe step, and that step with an orientation
    target."""
    generator.LM_GRAPHS.clear()
    with pytest.MonkeyPatch.context() as m:
        calls = _record(_driver(cuda, small=False), m)
    torch.cuda.synchronize()
    generator.LM_GRAPHS.clear()
    paths = [c for c in calls if c[4]["root_only"] and c[2].traj is not None]
    keyframe = next(c for c in calls if not c[4]["root_only"])
    skel, prim, sc, s0, kw = keyframe
    q = torch.tensor([0.9, 0.1, -0.3, 0.2], device=cuda)
    quat = sc.replace(kf_has_quat=sc.kf_active.clone(),
                      kf_quat=(q / q.norm()).expand_as(sc.kf_quat).clone())
    return {
        "path": next(c for c in paths if float(c[2].has_prev[0]) > 0),
        "path_first": next(c for c in paths if float(c[2].has_prev[0]) == 0),
        "keyframe": keyframe,
        "keyframe_quat": (skel, prim, quat, s0, kw),
    }


def _starts(s0, c: int, noise: float = 0.05, seed: int = 5):
    if c == 1:
        return s0[:1]
    g = torch.Generator().manual_seed(seed)
    more = torch.randn((c - 1,) + s0.shape[1:], generator=g)
    return torch.cat([s0[:1], s0[:1] + noise * more.to(s0.device)])


def _eager(case, s0, n_iters):
    """The eager stage's (s_opt, err) from the starts s0."""
    skel, prim, sc, _, kw = case
    return generator._lm_stage(skel, prim, generator._rows(sc, s0.shape[0]),
                               s0, **dict(kw, n_iters=n_iters))


def _stages(case, s0, n_iters):
    """(the kernel's, the eager stage's) (s_opt, err) from the starts s0."""
    skel, prim, sc, _, kw = case
    before = profiling.counters()
    got = generator._lm_kernel_stage(skel, prim,
                                     generator._rows(sc, s0.shape[0]), s0,
                                     **dict(kw, n_iters=n_iters))
    torch.cuda.synchronize()
    assert _added(before)[kernels.LAUNCHES + "request_lm"] == 1
    return got, _eager(case, s0, n_iters)


def _error(case, s):
    skel, prim, sc, _, kw = case
    fam = {k: kw[k] for k in ("use_traj", "use_ca", "use_ts", "families",
                              "root_only")}
    return compiled.error_from_residuals(compiled.evaluate_residuals(
        skel, prim, generator._rows(sc, s.shape[0]), s, **fam))


CASES = ["keyframe", "keyframe_quat", "path", "path_first"]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("case", CASES)
def test_one_iteration_is_the_eager_stage(card_cases, case, c):
    """From the same starts, one iteration of the kernel lands where the
    eager stage does (S_RTOL, or the eager stage's own spread under
    nudges of its start), and the kernel's error is the exact evaluator's
    at its latent."""
    args = card_cases[case]
    assert _covers(args)
    s0 = _starts(args[3], c)
    (s_k, e_k), (s_e, _) = _stages(args, s0, 1)
    assert s_k.shape == s_e.shape == s0.shape and e_k.shape == (c,)
    assert torch.isfinite(s_k).all() and torch.isfinite(e_k).all()
    g = torch.Generator().manual_seed(11)
    spread = torch.zeros(c, device=s0.device)
    for _ in range(N_NUDGES):
        nudge = 1 + NUDGE * torch.randn(s0.shape, generator=g).to(s0.device)
        s_n = _eager(args, s0 * nudge, 1)[0]
        spread = torch.maximum(spread, (s_n - s_e).abs().amax(-1))
    gap = (s_k - s_e).abs().amax(-1)
    bound = torch.maximum(S_RTOL * s_e.abs().amax(-1), NUDGE_FACTOR * spread)
    print(f"{case} c={c}: gap {gap.tolist()}, bound {bound.tolist()}")
    assert (gap <= bound).all(), (gap.tolist(), bound.tolist())
    want = _error(args, s_k)
    torch.testing.assert_close(e_k, want, rtol=ERR_RTOL, atol=1e-5)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walk", "keyframe"])
def test_small_widths_launch(cuda, case):
    """At the 4-joint model's widths (a block's shared memory under the
    48 KB a launch may take without opting in) one iteration of the
    kernel lands where the eager stage does."""
    with pytest.MonkeyPatch.context() as m:
        calls = _record(_driver(cuda, small=True), m)
    generator.LM_GRAPHS.clear()
    args = next(c for c in calls if c[4]["root_only"] == (case == "walk"))
    assert _covers(args)
    (s_k, e_k), (s_e, _) = _stages(args, args[3], 1)
    gap = float((s_k - s_e).abs().max())
    print(f"small {case}: gap {gap:.3e}")
    assert gap <= S_RTOL * float(s_e.abs().max()) + 1e-4
    torch.testing.assert_close(e_k, _error(args, s_k), rtol=ERR_RTOL,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_ten_iterations_gain_as_the_eager_stage(card_cases, case):
    """Over N_STARTS seeded starts, ten iterations of the kernel fall short
    of the eager stage's by at most SHORTFALL of its gain (the median, as
    the judge's lm_shortfall; the better of start and result, as
    `_refine_starts` keeps it), and at most STUCK_SHARE of the starts fall
    short by more than STUCK (the judge's lm_stuck_share)."""
    args = card_cases[case]
    s0 = _starts(args[3], N_STARTS, START_NOISE, seed=17)
    (s_k, e_k), (s_e, e_e) = _stages(args, s0, 10)
    e0 = _error(args, s0)
    ek, ee = torch.minimum(e0, e_k), torch.minimum(e0, e_e)
    gain = e0 - ee
    short = [float(v) for v in ((ek - ee) / gain)[gain >= MIN_GAIN]]
    assert len(short) >= N_STARTS // 2, (e0.tolist(), e_e.tolist())
    med = statistics.median(short)
    stuck = sum(v > STUCK for v in short) / len(short)
    print(f"{case}: shortfall median {med:.4f} over {len(short)} starts, "
          f"max {max(short):.4f}, min {min(short):.4f}, stuck {stuck:.4f}")
    assert med <= SHORTFALL, short
    assert stuck <= STUCK_SHARE, short
    torch.cuda.synchronize()


@pytest.fixture
def fresh_graphs():
    generator.LM_GRAPHS.clear()
    yield generator.LM_GRAPHS
    generator.LM_GRAPHS.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "keyframe"])
def test_a_replay_launches_the_kernel_once(card_cases, case, fresh_graphs):
    """Under the stage's graph (eager, capture and replay, replay) the
    kernel launches once a run and B2 never; no fallback is counted; a
    further replay adds one launch, and every run returns the same."""
    skel, prim, sc, s0, kw = card_cases[case]
    before = profiling.counters()
    outs = [generator.refine_lm(skel, prim, sc, s0, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    added = _added(before)
    assert added[kernels.LAUNCHES + "request_lm"] == 3
    assert added[kernels.LAUNCHES + "chol_solve"] == 0
    assert added["request.lm.fallback"] == 0
    assert (added["request.lm.eager"], added["request.lm.graph_captures"],
            added["request.lm.graph_replays"]) == (1, 1, 2)
    before = profiling.counters()
    last = generator.refine_lm(skel, prim, sc, s0, **kw)
    torch.cuda.synchronize()
    added = _added(before)
    assert added[kernels.LAUNCHES + "request_lm"] == 1
    assert added["request.lm.graph_replays"] == 1
    for out in outs + [last]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


FALLBACK = {
    "look_at": lambda sc, kw: (sc.replace(la_active=torch.ones_like(
        sc.la_active)), dict(kw, families=frozenset(kw["families"])
                             | {"la"})),
    "collision_avoidance": lambda sc, kw: (sc, dict(kw, use_ca=True)),
    "trajectory_set": lambda sc, kw: (sc, dict(kw, use_ts=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FALLBACK))
def test_other_sets_take_the_eager_stage(card_cases, name, fresh_graphs):
    """A set with look-at, collision avoidance or a trajectory set runs
    the eager stage (B2, no request_lm) and counts request.lm.fallback."""
    skel, prim, sc, s0, kw = card_cases["path"]
    sc, kw = FALLBACK[name](sc, dict(kw, n_iters=2))
    assert not generator.lm_kernel_covers(skel, prim, sc, kw["use_ca"],
                                          kw["use_ts"], kw["families"],
                                          kw["root_only"])
    before = profiling.counters()
    s_opt, err = generator.refine_lm(skel, prim, sc, s0, **kw)
    torch.cuda.synchronize()
    added = _added(before)
    assert added["request.lm.fallback"] == 1
    assert added[kernels.LAUNCHES + "request_lm"] == 0
    assert added[kernels.LAUNCHES + "chol_solve"] > 0
    assert torch.isfinite(s_opt).all() and torch.isfinite(err).all()


@pytest.mark.cuda
def test_the_library_refuses_what_it_cannot_hold(card_cases):
    """The library's check takes the service's sizes, with and without a
    path table, and refuses more latents than a warp's lanes and a path
    table beyond the shared memory a block may take; a covered key of
    such sizes runs the eager stage."""
    skel, prim, sc, s0, kw = card_cases["path"]
    dev = s0.device
    g1 = sc.traj.table_arc.shape[-1]
    for root_only in (True, False):
        assert kernels.request_lm_takes(skel, prim, g1, root_only, dev)
        assert kernels.request_lm_takes(skel, prim, 0, root_only, dev)
    wide = dataclasses.replace(prim, n_time=40)
    assert wide.n_latent > 32
    assert not kernels.request_lm_takes(skel, wide, g1, True, dev)
    assert not kernels.request_lm_takes(skel, prim, 20000, True, dev)
    arc = sc.traj.table_arc
    long = sc.replace(traj=dataclasses.replace(sc.traj, table_arc=arc[
        ..., :1].expand(arc.shape[:-1] + (20000,)).contiguous()))
    assert not _covers((skel, prim, long, s0, kw))


FAULT = """
import sys
sys.path[:0] = [{root!r}, {tests!r}]
import pytest, torch
from test_torch_request_lm_graph import _driver, _record
from morphablegraphs_tpu_torch.synthesis import generator
with pytest.MonkeyPatch.context() as m:
    calls = _record(_driver(torch.device("cuda"), small=True), m)
skel, prim, sc, s0, kw = next(c for c in calls if not c[4]["root_only"])
assert generator.lm_kernel_covers(skel, prim, sc, kw["use_ca"], kw["use_ts"],
                                  kw["families"], kw["root_only"])
torch.cuda.synchronize()
print("the set runs", flush=True)
sc = sc.replace(kf_node=torch.full_like(sc.kf_node, skel.n_nodes))
out = generator._lm_kernel_stage(skel, prim, generator._rows(sc, 1), s0[:1],
                                 **kw)
torch.cuda.synchronize()
print("returned", out, flush=True)
"""


@pytest.mark.cuda
def test_a_node_out_of_range_raises(cuda):
    """A set whose keyframe node lies outside the skeleton stops the kernel
    with a device fault, which the next synchronisation raises (as
    PyTorch's own index checks on the card): no NaNs handed back.  In a
    process of its own, whose CUDA context the fault ends."""
    code = FAULT.format(root=str(ROOT), tests=str(ROOT / "tests"))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    print(run.stdout[-2000:], run.stderr[-2000:])
    assert "the set runs" in run.stdout
    assert run.returncode != 0 and "returned" not in run.stdout
    assert "CUDA error" in run.stderr
