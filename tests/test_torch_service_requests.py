"""The service's sequential request path (`POST /run_morphablegraphs`
through `serve.rest.make_app`) judged by the benchmark's plain reference
of the request path (`portbench/reference/requests.py`,
`judge_requests.py`) with the limits of the cell
`ref_actions.service_requests`, at a small size on the CPU: the action
configuration's frozen builder at 4 joints (Hips, Spine, RightArm,
RightHand), 8 spatial bases, 5 + 2 latents, 16 candidates and 3 LM
iterations a step, shorter paths.  The program's request is correct for
both request kinds; each fault of the timed path, and the control (the
reference in the program's place in TF32), is not.  Imports no JAX."""

import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from morphablegraphs_tpu_torch.models import graph as graph_mod  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as sk  # noqa: E402
from morphablegraphs_tpu_torch.serve import rest  # noqa: E402
from morphablegraphs_tpu_torch.synthesis.motion_generator import \
    MotionResult  # noqa: E402
from morphablegraphs_tpu_torch.utils import profiling  # noqa: E402
from morphablegraphs_tpu_torch.utils.config import \
    default_config  # noqa: E402
from portbench import model_actions  # noqa: E402
from portbench.drivers import service  # noqa: E402
from portbench.reference import ops as ref_ops  # noqa: E402
from portbench.reference import requests as rq  # noqa: E402

CELL = "ref_actions.service_requests"
# a seed whose action request places both keyframes within the four-joint
# arm's reach, so that the IK is judged (a target out of reach is not: the
# damped Gauss-Newton steps wander, `judge_requests.IK_REACH`), and whose
# walk request ends in 5 steps (on this toy model some walks stall for
# dozens of steps short of the path's end: slow, not wrong)
SEED = 3000000008
SMALL = dict(n_joints=4, n_dim=19, n_basis_spatial=8, k_s=5, k_t=2,
             n_components=3, n_canonical_frames=40)
SHORT = dict(walk_cm=[120.0, 240.0], action_walk_cm=[60.0, 120.0])
# the service's sizes, made smaller on the driver and the context
SIZES = dict(n_random_samples=16, lm_iterations=3)


def _load(path):
    with open(ROOT / path) as f:
        return json.load(f)


CONFIG = dict(_load("portbench/configs/ref_actions.json"), **SMALL)
TRAFFIC = dict(_load("portbench/traffic/service_requests.json"), **SHORT)
LIMITS = _load(f"portbench/limits/{CELL}.json")


@pytest.fixture(scope="module")
def driver():
    d = service.Driver(CONFIG, TRAFFIC, SEED, "cpu")
    d.ctx.configure(SIZES)
    d.settings = rq.Settings(**SIZES)
    return d


def _index(driver, kind):
    return next(i for i in range(8) if driver.request(i)[0] == kind)


def _judged(driver, kind):
    driver.walk(_index(driver, kind), keep=True)
    return driver.judge(driver.kept, "cpu")


def _correct(numbers):
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in LIMITS.items())


@pytest.mark.parametrize("kind", service.KINDS)
def test_request_is_correct(driver, kind):
    numbers = _judged(driver, kind)
    assert _correct(numbers), numbers
    assert numbers["steps"] >= 3 and numbers["stages_observed"] == 1
    assert numbers["lm_steps"] > 0
    assert numbers["emit_gap"] < 1e-3 and numbers["frames_gap"] < 1e-3
    if kind == "action":  # both keyframes in the IK's reach, and judged
        assert numbers["ik_unreached"] == 0


def _lm_skipped(monkeypatch):
    from morphablegraphs_tpu_torch.ops import lm

    def unchanged(fn, s0, n_iters, **kw):
        return s0, torch.zeros(s0.shape[0], dtype=s0.dtype)

    monkeypatch.setattr(lm, "lm_minimize", unchanged)


def _ik_skipped(monkeypatch):
    from morphablegraphs_tpu_torch.synthesis import postprocess
    monkeypatch.setattr(postprocess, "apply_ik_constraints",
                        lambda skeleton, frames, *a, **kw: frames)


def _blend(scale):
    """The keyframe IK's blend over `scale` times its window."""
    def breaks(monkeypatch):
        from morphablegraphs_tpu_torch.synthesis import postprocess
        inner = postprocess.apply_ik_constraints

        def blended(*a, interpolation_window, **kw):
            return inner(*a, interpolation_window=int(
                interpolation_window * scale), **kw)

        monkeypatch.setattr(postprocess, "apply_ik_constraints", blended)
    return breaks


def _emit_shifted(monkeypatch):
    from morphablegraphs_tpu_torch.ops import kernels
    inner = kernels.emit_frames

    def shifted(*a, **kw):
        frames, last = inner(*a, **kw)
        return frames + 0.01, last + 0.01

    monkeypatch.setattr(kernels, "emit_frames", shifted)


def _wrong_transition(monkeypatch):
    """The path's end condition negated: the walk turns into its end state
    where it should go on."""
    from morphablegraphs_tpu_torch.synthesis import action_builder
    check = action_builder.ActionConstraintSet.check_end_condition
    monkeypatch.setattr(action_builder.ActionConstraintSet,
                        "check_end_condition",
                        lambda self, *a: not check(self, *a))


def _not_handed_out(monkeypatch):
    run = rest.MGContext.run

    def forgetful(self, *a, **kw):
        out = run(self, *a, **kw)
        self.last_result = None
        return out

    monkeypatch.setattr(rest.MGContext, "run", forgetful)


FAULTS = {"lm_skipped": (_lm_skipped, "action", "lm_shortfall"),
          "ik_skipped": (_ik_skipped, "action", "ik_shortfall"),
          "ik_blend_off": (_blend(0), "action", "ik_blend_gap"),
          "ik_blend_halved": (_blend(0.5), "action", "ik_blend_gap"),
          "emit_shifted": (_emit_shifted, "walk", "emit_gap"),
          "wrong_transition": (_wrong_transition, "walk", "nodes_wrong"),
          "result_not_handed_out": (_not_handed_out, "walk",
                                    "steps_missing")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(driver, monkeypatch, fault):
    """Each fault of the timed path comes out not correct, by the number
    that checks its stage."""
    breaks, kind, number = FAULTS[fault]
    breaks(monkeypatch)
    numbers = _judged(driver, kind)
    assert not _correct(numbers)
    value = numbers[number]
    assert not math.isfinite(value) or value > LIMITS[number], numbers
    if fault == "result_not_handed_out":
        assert numbers["steps_missing"] == 1


def test_control_is_not_correct(driver):
    """The reference in the program's place, its matrix products' operands
    rounded to TF32 (`ops.tf32_round`), fails a limit."""
    kept = driver.reference_request(_index(driver, "action"), torch.float32,
                                    "cpu", ref_ops.tf32_round)
    numbers = driver.judge(kept, "cpu")
    assert not _correct(numbers), numbers
    # in float64 it is the reference itself: every limit holds
    kept = driver.reference_request(_index(driver, "action"), torch.float64,
                                    "cpu")
    assert _correct(driver.judge(kept, "cpu"))


def _context():
    gd = model_actions.graph_dict(CONFIG, SEED)
    graph = graph_mod.build_graph_from_dict(gd)
    graph.skeleton, _ = sk.load_bvh(model_actions.bvh(CONFIG))
    cfg = default_config()
    cfg.update(SIZES)
    return rest.MGContext(graph, cfg, device="cpu")


def test_context_hands_out_the_last_motion_result(driver):
    """MGContext keeps the last request's MotionResult: its steps' node
    keys, latents, frame ranges, errors and filled constraint sets, the
    frames it answered; the next request replaces it."""
    ctx = _context()
    app = rest.make_app(ctx)
    assert ctx.last_result is None
    before = profiling.counters()
    results = []
    for kind in service.KINDS:
        _, req = driver.request(_index(driver, kind))
        status, _, body = app("POST", "/run_morphablegraphs",
                              json.dumps(req).encode())
        assert status == 200
        res = ctx.last_result
        assert isinstance(res, MotionResult)
        assert res.frames.shape[0] == int(
            json.loads(body)["bvh"].split("Frames: ")[1].split()[0])
        for i, step in enumerate(res.steps):
            assert step.node_key in ctx.graph.nodes
            assert step.parameters.shape == (CONFIG["k_s"] + CONFIG["k_t"],)
            assert step.end_frame >= step.start_frame
            assert i == 0 or step.start_frame == res.steps[i - 1].end_frame + 1
            assert np.isfinite(step.error)
            assert step.step_constraints is not None
        results.append(res)
    assert results[0] is not results[1]
    after = profiling.counters()

    def added(name):
        return after.get(name, 0) - before.get(name, 0)

    n_steps = sum(len(r.steps) for r in results)
    assert added("request.steps") == n_steps
    assert added("request.ik.constraints") == 2  # the pick and the place
    # an answer of the other endpoints leaves it
    app("GET", "/get_skeleton", b"")
    assert ctx.last_result is results[1]


@pytest.mark.parametrize("n_joints", [4, 19])
def test_reference_forward_kinematics_matches_the_program(n_joints):
    """The reference's chain FK reads a joint as the program's FK does,
    on both skeletons of the configuration (frames with non-unit
    quaternions)."""
    cfg = dict(CONFIG, n_joints=n_joints, n_dim=3 + 4 * n_joints)
    skel_p, _ = sk.load_bvh(model_actions.bvh(cfg))
    skel_r = rq.Skeleton(model_actions.tree(cfg), torch.float64, "cpu")
    assert list(skel_p.animated_joints) == skel_r.names
    gen = torch.Generator().manual_seed(5)
    frames = torch.randn((3, 3 + 4 * n_joints), generator=gen,
                         dtype=torch.float64) * 0.5
    frames[:, 3::4] += 1.0
    pos, ori = sk.fk_global(skel_p, frames.float())
    for joint in ("Hips", "Spine", "RightArm", "RightHand"):
        p, q = skel_r.joint(frames, joint)
        i = skel_p.index_of(joint)
        np.testing.assert_allclose(p.numpy(), pos[:, i].double().numpy(),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(q.numpy(), ori[:, i].double().numpy(),
                                   rtol=1e-5, atol=1e-5)
