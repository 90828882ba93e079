"""Holden et al.'s PFNN controller (`models.pfnn.holden_step`) and its crowd
(`synthesis.pfnn_crowd.pfnn_crowd_walk`) judged by the benchmark's plain
reference (`portbench/reference/pfnn.py`, `judge_pfnn.py`) with the limits
of the cell `pfnn_holden.crowd_paths`, on the CPU: a small network (5
joints, so X 186 and Y 77; hidden 16; 6 characters, 30 frames) followed
frame by frame from the program's own state; one frame, the graph zip's
pfnn/ section and the planner's PFNN route at the published widths (X 342,
Y 311, hidden 512, 31 joints).  Each planted fault of the controller, and
the control (the reference in the program's place in TF32), is not
correct.  Imports no JAX."""

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from morphablegraphs_tpu_torch.models import pfnn  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as sk  # noqa: E402
from morphablegraphs_tpu_torch.models import zip_writer  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import pfnn_crowd  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import \
    state_planner as spt  # noqa: E402
from morphablegraphs_tpu_torch.utils import profiling  # noqa: E402
from portbench import model_pfnn  # noqa: E402
from portbench.drivers import pfnn_crowd as driver_mod  # noqa: E402
from portbench.reference import judge_pfnn  # noqa: E402
from portbench.reference import ops as ref_ops  # noqa: E402
from portbench.reference import pfnn as ref_pfnn  # noqa: E402

CELL = "pfnn_holden.crowd_paths"
SEED = 3000000019


def _load(path):
    with open(ROOT / path) as f:
        return json.load(f)


FULL = _load("portbench/configs/pfnn_holden.json")
SMALL = dict(FULL, n_joints=5, x_dim=186, y_dim=77, hidden=16)
TRAFFIC = dict(_load("portbench/traffic/crowd_paths.json"), characters=6,
               frames=30, judged=6)
LIMITS = _load(f"portbench/limits/{CELL}.json")


def _correct(numbers: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= LIMITS[k]
               for k in LIMITS)


def _driver(seed=SEED, config=SMALL, traffic=TRAFFIC):
    return driver_mod.Driver(config, traffic, seed, "cpu")


def _judged(d, index=0):
    d.walk(index, keep=True)
    return d.judge(d.kept, "cpu")


@pytest.mark.parametrize("seed", [SEED, 3000000041, 2 ** 31 + 7])
def test_crowd_matches_reference_frame_by_frame(seed):
    """Every judged character's every frame within the cell's limits."""
    numbers = _judged(_driver(seed))
    assert numbers["state_missing"] == 0 and numbers["counts_wrong"] == 0
    assert _correct(numbers), numbers


def _linear_phase(n_controls, phase):
    p = phase * n_controls
    k = torch.floor(p).long() % n_controls
    w = p - torch.floor(p)
    out = torch.zeros(phase.shape + (n_controls,), dtype=phase.dtype)
    out.scatter_add_(-1, k[:, None], (1 - w)[:, None])
    return out.scatter_add_(-1, ((k + 1) % n_controls)[:, None], w[:, None])


def _roll(d):
    d.model = dataclasses.replace(d.model, **{
        f: torch.roll(getattr(d.model, f), 1, 0)
        for f in ("w0", "b0", "w1", "b1", "w2", "b2")})


def _no_phase(update):
    def wrong(state, y, parents):
        new, frame = update(state, y, parents)
        return dataclasses.replace(new, phase=state.phase), frame
    return wrong


FAULTS = {
    "linear_phase": lambda mp, d: mp.setattr(pfnn, "_catmull_rom_coeffs",
                                             _linear_phase),
    "relu": lambda mp, d: mp.setattr(pfnn.F, "elu", F.relu),
    "rolled_controls": lambda mp, d: _roll(d),
    "no_phase_update": lambda mp, d: mp.setattr(
        pfnn, "holden_update", _no_phase(pfnn.holden_update)),
    "no_blend": lambda mp, d: mp.setattr(
        pfnn, "blend_trajectory", lambda state, *a: state),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_is_not_correct(fault, monkeypatch):
    d = _driver()
    FAULTS[fault](monkeypatch, d)
    numbers = _judged(d)
    assert not _correct(numbers), numbers


def _stale_state(d, monkeypatch):
    """Every frame stepped from the walk's first state (a state left
    unchanged): each step is right, the chain is not."""
    first = {}
    step = d.entry._frame_step

    def stale(model, paths, parents, bias, state, arc, speed):
        state = first.setdefault("state", state)
        return d.entry._frame_step(model, paths, parents, bias, state, arc,
                                   speed)

    d.entry = types.SimpleNamespace(
        pfnn_crowd_walk=pfnn_crowd.pfnn_crowd_walk, _frame_step=step)
    monkeypatch.setattr(pfnn_crowd, "_frame_step", stale)


def _misplaced(move):
    """The walk's frames moved out of their slots by move(frames)."""
    def plant(d, monkeypatch):
        step = d.entry._frame_step

        def walk(*args, **kwargs):
            frames, n = pfnn_crowd.pfnn_crowd_walk(*args, **kwargs)
            return move(frames), n

        d.entry = types.SimpleNamespace(pfnn_crowd_walk=walk,
                                        _frame_step=step)
        monkeypatch.setattr(pfnn_crowd, "_frame_step",
                            lambda *a: d.entry._frame_step(*a))
    return plant


def _slot_0(frames):
    """Each frame written to slot 0: the last one left there."""
    out = torch.zeros_like(frames)
    out[:, 0] = frames[:, -1]
    return out


WALK_FAULTS = {
    "state_not_carried": (_stale_state, "chain_gap"),
    "frame_in_slot_0": (_misplaced(_slot_0), "emitted_gap"),
    "frames_shifted": (_misplaced(lambda f: torch.roll(f, 1, 1)),
                       "emitted_gap"),
}


@pytest.mark.parametrize("fault", sorted(WALK_FAULTS))
def test_each_walk_fault_is_not_correct(fault, monkeypatch):
    """Faults of the walk around a right frame step: only the chain of
    states or the frames handed back can show them, and they do."""
    plant, number = WALK_FAULTS[fault]
    d = _driver()
    plant(d, monkeypatch)
    numbers = _judged(d)
    assert numbers["state_missing"] == 0, numbers
    bad = {k for k in LIMITS if not numbers[k] <= LIMITS[k]}
    assert bad == {number}, numbers


def test_right_walk_chains_exactly():
    """The program hands each frame the last one's state and returns each
    stepped frame in its slot, bit for bit."""
    numbers = _judged(_driver())
    assert numbers["chain_gap"] == 0 and numbers["emitted_gap"] == 0


def test_tf32_control_is_not_correct():
    """The reference in the program's place, every matrix product's
    operands rounded to TF32: net_gap leaves its limit."""
    d = _driver()
    d.walk(0, keep=True)
    control = d.reference_outputs(d.kept, torch.float32, "cpu",
                                  ref_ops.tf32_round)
    numbers = d.judge(d.kept, "cpu", outputs={
        k: v.double() for k, v in control.items()})
    assert numbers["net_gap"] > LIMITS["net_gap"], numbers
    assert not _correct(numbers)


def test_unobserved_step_reports_state_missing():
    """A program whose crowd makes no observable frame step is not
    correct, and says why."""
    d = _driver()
    d.entry = types.SimpleNamespace(
        pfnn_crowd_walk=pfnn_crowd.pfnn_crowd_walk)
    numbers = _judged(d)
    assert numbers["state_missing"] == 1 and not _correct(numbers)


def _full_model(seed=SEED):
    a = model_pfnn.arrays(FULL, seed)
    return pfnn.load_from_arrays(a["weights"], a["means"], device="cpu"), a


@pytest.mark.parametrize("part", ["shapes", "input", "frame"])
def test_one_frame_at_published_widths(part):
    """Two characters at X 342, Y 311, hidden 512, 31 joints, from rest:
    the input's blocks and the frame's layout."""
    model, _ = _full_model()
    skel = pfnn.skeleton_of(model_pfnn.JOINTS)
    rest = torch.as_tensor(pfnn.rest_positions(skel), dtype=torch.float32)
    gait = torch.tensor([[0.0, 1.0, 0, 0, 0, 0], [0.0, 0, 1.0, 0, 0, 0]])
    facing = torch.tensor([[0.6, 0.8], [0.0, 1.0]])
    state = pfnn.holden_initial_state(torch.tensor([[10.0, 5.0], [0, 0]]),
                                      facing, gait, torch.tensor([0.1, 0.7]),
                                      rest)
    x = pfnn.holden_input(state)
    new, y, frame = pfnn.holden_step(model, state, facing, facing * 2.5,
                                     skel.parents, 0.5)
    if part == "shapes":
        assert x.shape == (2, 342) and y.shape == (2, 311)
        assert frame.shape == (2, 127) == (2, skel.n_frame_params)
        assert new.traj_pos.shape == (2, 120, 2)
        assert new.joint_pos.shape == (2, 31, 3)
        assert pfnn.holden_joints(342, 311) == 31
        with pytest.raises(ValueError):
            pfnn.holden_joints(342, 310)
    elif part == "input":
        # every sample at the root facing its way: positions 0, facings
        # (0, 1) in the root's frame; gaits one-hot; flat ground
        torch.testing.assert_close(x[:, 0:36], torch.zeros(2, 36))
        torch.testing.assert_close(x[:, 36:48], torch.ones(2, 12))
        torch.testing.assert_close(x[:, 48:120].reshape(2, 6, 12),
                                   gait[:, :, None].expand(2, 6, 12))
        torch.testing.assert_close(x[:, 120:213].reshape(2, 31, 3),
                                   rest.expand(2, 31, 3), atol=1e-4,
                                   rtol=0)
        torch.testing.assert_close(x[:, 213:], torch.zeros(2, 129))
    else:
        q = frame[:, 3:].reshape(2, 31, 4)
        torch.testing.assert_close(torch.linalg.vector_norm(q, dim=-1),
                                   torch.ones(2, 31))
        torch.testing.assert_close(frame[:, :3], new.joint_pos[:, 0])
        assert bool(((new.phase >= 0) & (new.phase < 1)).all())


def test_zip_round_trip_at_hidden_512(tmp_path):
    """The pfnn/ section at the published widths, written by zip_writer
    and read by read_pfnn_from_zip(hidden=512), as a package ships it."""
    model, arrays = _full_model()
    path = str(tmp_path / "pfnn.zip")
    zip_writer.write_graph_zip(path, pfnn.holden_skeleton(), {}, {},
                               pfnn_data=arrays)
    back = pfnn.read_pfnn_from_zip(path, 4, 512, device="cpu")
    assert back.w0.shape == (4, 512, 342) and back.w2.shape == (4, 311, 512)
    for f in dataclasses.fields(model):
        torch.testing.assert_close(getattr(back, f.name),
                                   getattr(model, f.name), rtol=0, atol=0)


def test_catmull_rom_matches_the_reference():
    phase = torch.linspace(0.0, 0.999, 97, dtype=torch.float64)
    a = model_pfnn.arrays(SMALL, SEED)
    net = ref_pfnn.Network(a, torch.float64, "cpu")
    torch.testing.assert_close(pfnn._catmull_rom_coeffs(4, phase),
                               net.coefficients(phase))


def test_skeleton_exports_as_bvh(tmp_path):
    """The crowd's frames of the 31-joint skeleton written as BVH and read
    back."""
    model, _ = _full_model()
    skel = pfnn.holden_skeleton()
    from morphablegraphs_tpu_torch.ops import spline_path
    pts = np.zeros((1, 3, 3), np.float32)
    pts[0, :, 2] = [0.0, 200.0, 400.0]
    paths = spline_path.stack_paths([spline_path.build(
        pts[0], unconstrained_dims=(1,), granularity=64, device="cpu")])
    frames, n = pfnn_crowd.pfnn_crowd_walk(
        model, paths, torch.tensor([[0.0, 1, 0, 0, 0, 0]]),
        torch.tensor([0.25]), 12, torch.tensor([150.0]), skeleton=skel)
    text = sk.write_bvh(skel, frames[0].numpy(), str(tmp_path / "a.bvh"))
    back, euler = sk.load_bvh(text)
    assert back.animated_joints == skel.animated_joints
    quats = sk.bvh_to_quat_frames(back, euler)
    np.testing.assert_allclose(quats[:, :3], frames[0, :, :3].numpy(),
                               atol=1e-4)
    dots = np.abs((quats[:, 3:].reshape(12, 31, 4)
                   * frames[0, :, 3:].reshape(12, 31, 4).numpy()).sum(-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def test_crowd_spans_and_counters():
    """One walk: its root span, a frame span a frame, the frames counter
    and (on the CPU) every frame eager."""
    profiling.reset()
    d = _driver()
    d.walk(0)
    snap = profiling.snapshot()
    roots = [r for r in snap["roots"] if r["name"] == "pfnn_crowd"]
    assert len(roots) == 1
    names = [s[1] for s in snap["spans"] if s[5] == roots[0]["id"]]
    for stage in ("pfnn.frame", "pfnn.encode", "pfnn.net", "pfnn.decode"):
        assert names.count(stage) == TRAFFIC["frames"], stage
    assert snap["counters"]["pfnn.frames"] == 6 * TRAFFIC["frames"]
    assert snap["counters"]["pfnn.eager"] == TRAFFIC["frames"]


def test_planner_pfnn_route_matches_reference(monkeypatch):
    """MGStatePlanner's PFNN locomotion through `pfnn.HoldenWrapper` at
    the published widths, on the CPU: every frame the controller stepped,
    recomputed by the reference from the controller's state, within the
    cell's limits; the state queue holds those frames."""
    from morphablegraphs_tpu_torch.models import graph as graph_mod
    from morphablegraphs_tpu_torch.utils import synthetic
    model, arrays = _full_model()
    seen = []
    step = pfnn.holden_step

    def spy(model, state, target_dir, target_vel, parents, bias):
        new, y, frame = step(model, state, target_dir, target_vel, parents,
                             bias)
        seen.append((state, target_dir, target_vel, y, frame, new))
        return new, y, frame

    monkeypatch.setattr(pfnn, "holden_step", spy)
    graph = graph_mod.build_graph_from_dict(synthetic.make_graph_dict())
    graph.skeleton, _ = sk.load_bvh(synthetic.TEST_BVH)
    planner = spt.MGStatePlanner(graph, spt.MGStatePlanningSettings(
        min_pfnn_target_distance=8.0, min_pfnn_primitive_steps=40,
        max_pfnn_frames=120, pfnn_blend_bias=0.5), device="cpu",
        pfnn_wrapper=pfnn.HoldenWrapper(model, gait="walk"))
    planner.use_pfnn = True
    planner.generate_locomotion("walk", np.array([[0.0, 0, 60.0],
                                                  [40.0, 0, 150.0]]))
    frames = np.concatenate([e.state.frames for e in
                             planner.state_queue._queue])
    assert 40 <= len(seen) == len(frames) <= 120
    observed = {"in." + k: torch.stack([getattr(s[0], k) for s in seen])
                for k in judge_pfnn.STATE if k != "arc"}
    observed.update({"out." + k: torch.stack([getattr(s[5], k)
                                              for s in seen])
                     for k in judge_pfnn.STATE if k != "arc"})
    observed["in.arc"] = torch.zeros(len(seen), 1)
    observed["out.arc"] = torch.zeros(len(seen), 1)
    observed["facing"] = torch.stack([s[1] for s in seen])
    observed["y"] = torch.stack([s[3] for s in seen])
    observed["frame"] = torch.stack([s[4] for s in seen])
    speed = (torch.linalg.vector_norm(seen[0][2], dim=-1)
             / torch.linalg.vector_norm(seen[0][1], dim=-1) * 60.0)
    torch.testing.assert_close(speed, torch.tensor([150.0]))
    net = ref_pfnn.Network(arrays, torch.float64, "cpu")
    parents = tuple(p for _, p, _ in model_pfnn.JOINTS)
    mine = judge_pfnn.reference_outputs(net, parents, observed, speed, 0.5,
                                        torch.float64, "cpu")
    y = judge_pfnn.flat(observed["y"]).double()
    assert float(((y - mine["y"]).abs() / net.y_std).max()) \
        <= LIMITS["net_gap"]
    frame = judge_pfnn.flat(observed["frame"]).double()
    assert float((frame - mine["frame"]).abs().max()) <= LIMITS["frame_gap"]
    for k in ("traj_pos", "traj_dir", "joint_pos", "joint_vel"):
        got = judge_pfnn.flat(observed["out." + k]).double()
        assert float((got - mine["out." + k]).abs().max()) \
            <= LIMITS["state_gap"], k
    # the first state is the controller's frames as they came (the later
    # ones are aligned to the pose buffer)
    first = planner.state_queue._queue[0].state.frames
    np.testing.assert_allclose(first, judge_pfnn.flat(observed["frame"])[
        :len(first)].numpy(), atol=1e-5)


def test_reference_and_drivers_import_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.pfnn, portbench.reference.judge_pfnn,"
            "portbench.drivers.pfnn_crowd, portbench.drivers.crowd_ranks,"
            "portbench.model_pfnn, portbench.counts.pfnn;"
            "import morphablegraphs_tpu_torch.synthesis.pfnn_crowd;"
            "bad = sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'morphablegraphs_tpu'});"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
