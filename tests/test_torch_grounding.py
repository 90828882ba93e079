"""Parity of the PyTorch port's post-process passes with the JAX
package's on the CPU: the batched IK solve (`ops.ik.solve_ik_frames`),
every grounding function of `synthesis.grounding` on WALK_BVH frames (a
skeleton with feet and toes, as tests/test_postprocess.py builds them),
the port's `smooth_bitvector`, the trajectory IK pass and the whole
`post_process_motion`.

Tolerances: on unit-quaternion frames the IK passes are well conditioned
and the port's frames agree with JAX's to 1e-3 (measured <= 4.2e-4: float32
rounding through 8-10 damped Gauss-Newton steps); contact bits, runs and
anchors are compared exactly on inputs kept away from the contact
thresholds (tests/test_postprocess.py's plant motion), the anchors to
1e-4.  Grounding a whole motion first moves it onto the ground by frame
0: the plant motion, whose first frames rise 0.5 cm a frame, then has
frames exactly on the contact thresholds (1.0, 3.0), and its first
contact run pins a foot while the root slides under straight legs, a
singular pose where the IK is chaotic (port and JAX 1.4e-3 to 0.64 apart
from process to process).  The passes that ground whole motions run on
`_stand_then_jump` instead: standing still, then airborne 8 cm and
more above the ground.  Pinning its straight legs while a jitter slides
the root by up to 2 cm lands 1.8e-3 from JAX (the port's float64 normal
equations against JAX's float32 ones; the same in every process), held
at PLANT_ATOL."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.construct import preprocessing as prepj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.ops import ik as ikj  # noqa: E402
from morphablegraphs_tpu.ops import spline_path as spj  # noqa: E402
from morphablegraphs_tpu.synthesis import grounding as grj  # noqa: E402
from morphablegraphs_tpu.synthesis import postprocess as ppj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402
from morphablegraphs_tpu_torch.construct import \
    preprocessing as prept  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.ops import ik as ikt  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path as spt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import grounding as grt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import \
    postprocess as ppt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

FRAMES_ATOL = 1e-3
PLANT_ATOL = 3e-3
PLANT_SETTINGS = {"generate_foot_plant_constraints": True,
                  "contact_tolerance": 1.0, "foot_lift_tolerance": 3.0,
                  "foot_lift_search_window": 5,
                  "smoothing_constraints_window": 3,
                  "constraint_range": 4, "graph_walk_grounding_window": 4,
                  "activate_blending": True}


@pytest.fixture(scope="module")
def skels():
    return skj.load_bvh(synj.WALK_BVH)[0], skt.load_bvh(synj.WALK_BVH)[0]


def _rest_frame(skel):
    f = np.zeros(skel.n_frame_params, np.float32)
    f[:3] = [0, 90, 0]
    f[3::4] = 1.0
    return f


def _plant_motion(skel, n=60):
    """tests/test_postprocess.py's plant motion: standing on y = 0 for
    frames 10-35, airborne and moving elsewhere."""
    frames = np.tile(_rest_frame(skel), (n, 1))
    pos = np.asarray(skj.fk_positions(skel, jnp.asarray(frames[0])))
    frames[:, 1] = 90.0 - pos[skel.index_of("LeftFoot")][1]
    for i in range(n):
        if i < 10 or i > 35:
            frames[i, 1] += 8.0 + 0.5 * i
            frames[i, 0] += 0.8 * i
    return frames


def _stand_then_jump(skel, n=60):
    """Standing on y = 0 for frames 0-29, then airborne 8 cm and more
    above the ground and moving forward."""
    frames = np.tile(_rest_frame(skel), (n, 1))
    pos = np.asarray(skj.fk_positions(skel, jnp.asarray(frames[0])))
    frames[:, 1] = 90.0 - pos[skel.index_of("LeftFoot")][1]
    for i in range(30, n):
        frames[i, 1] += 8.0 + 0.5 * (i - 30)
        frames[i, 2] += 0.8 * (i - 30)
    return frames


def _random_pose_frames(skel, n, seed=0):
    """n frames with unit joint quaternions near the rest pose."""
    return np.stack([tp.prev_frame(skel.n_frame_params, 0.5 * i, 1.0 * i,
                                   seed=seed + i) for i in range(n)])


def test_solve_ik_frames_matches_jax_vmap(skels):
    """The batched solve against JAX's one-frame solve vmapped over the
    frames (each frame its own targets and mask, a leg joint mask), and
    against the port's one-frame call frame by frame (equal)."""
    sj, st = skels
    frames = _random_pose_frames(st, 12)
    pos = np.asarray(skj.fk_positions(sj, jnp.asarray(frames)))
    m = ikj.MAX_IK_CONSTRAINTS
    nodes = np.zeros((12, m), np.int32)
    targets = np.zeros((12, m, 3), np.float32)
    mask = np.zeros((12, m), np.float32)
    for c, joint in enumerate(("LeftFoot", "RightFoot")):
        nodes[:, c] = sj.index_of(joint)
        targets[:, c] = pos[:, nodes[0, c]] + [3.0 - c, 4.0, -2.0]
        mask[:, c] = (np.arange(12) + c) % 3 > 0
    jm = grj._leg_joint_mask(sj, ["LeftFoot", "RightFoot"])
    out_j = np.asarray(jax.vmap(
        lambda f, n, t, k: ikj.solve_ik(sj, f, n, t, k, jnp.asarray(jm),
                                        n_iters=8))(
        jnp.asarray(frames), jnp.asarray(nodes), jnp.asarray(targets),
        jnp.asarray(mask)))
    args = [torch.as_tensor(a) for a in (frames, nodes, targets, mask, jm)]
    out_t = ikt.solve_ik_frames(st, *args, n_iters=8).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=FRAMES_ATOL)
    one = np.stack([ikt.solve_ik(st, *(a[i] for a in args[:4]), args[4],
                                 n_iters=8).numpy() for i in range(12)])
    np.testing.assert_array_equal(one, out_t)


@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("bvh", ["WALK_BVH", "REF_BVH", "TEST_BVH"])
def test_ik_jacobian_matches_forward_mode(bvh, unit):
    """The IK's closed-form jacobian (`ik._linearize`) against forward
    mode (`lm.linearize`) through the deltas' application and the FK, on
    random frames with unit or unnormalized joint quaternions, random
    constrained nodes, targets, tip offsets, constraint and joint masks
    and deltas: residuals equal, the jacobian within 1e-5 of its largest
    entry (measured <= 3e-7: float32 rounding)."""
    from morphablegraphs_tpu_torch.ops import lm, quat
    skel = skt.load_bvh(getattr(synj, bvh))[0]
    rng = np.random.default_rng(5)
    f, j, c = 7, skel.n_animated, ikt.MAX_IK_CONSTRAINTS
    q = rng.normal(size=(f, j, 4)).astype(np.float32)
    if unit:
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    frames = torch.as_tensor(np.concatenate(
        [10.0 * rng.normal(size=(f, 3)), q.reshape(f, -1)], 1),
        dtype=torch.float32)
    nodes = torch.as_tensor(rng.integers(0, skel.n_nodes, size=(f, c)))
    targets = torch.as_tensor(30.0 * rng.normal(size=(f, c, 3)),
                              dtype=torch.float32)
    offsets = torch.as_tensor(rng.normal(size=(f, c, 3)), dtype=torch.float32)
    mask = torch.as_tensor(rng.random((f, c)) > 0.3, dtype=torch.float32)
    joint_mask = torch.as_tensor(rng.random(j) > 0.2, dtype=torch.float32)
    deltas = torch.as_tensor(0.5 * rng.normal(size=(f, 3 * j)),
                             dtype=torch.float32)
    rows = torch.arange(f)[:, None]

    def residuals(d):
        pos, ori = skt.fk_global(skel, ikt._apply_deltas(
            skel, frames, d.reshape(f, j, 3), joint_mask))
        tip = pos[rows, nodes] + quat.rotate_vec(
            quat.normalize(ori[rows, nodes]), offsets)
        return ((tip - targets) * mask[..., None]).reshape(f, -1)
    r_want, jac_want = lm.linearize(residuals, deltas)
    r, jac = ikt._linearize(skel, frames, deltas, joint_mask, nodes,
                            targets, offsets, mask)
    torch.testing.assert_close(r, r_want, rtol=0, atol=0)
    scale = float(jac_want.abs().max())
    torch.testing.assert_close(jac, jac_want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("source_frame", [0, 7])
def test_move_to_ground_matches_jax(skels, source_frame):
    sj, st = skels
    frames = _random_pose_frames(st, 12)
    frames[:, 1] += 25.0
    out_j = grj.move_to_ground(sj, frames, source_frame=source_frame)
    out_t = grt.move_to_ground(st, frames, source_frame=source_frame,
                               device="cpu")
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(grt.align_xz_to_origin(frames),
                                  grj.align_xz_to_origin(frames))


# (primitive, scene): the flat stance step, a begin step grounding both
# feet at the start, and tests/test_postprocess.py's slope
GROUND_STEPS = {"leftStance_flat": ("leftStance", None),
                "beginRightStance_flat": ("beginRightStance", None),
                "endRightStance_slope": ("endRightStance", 0.2),
                "unknown_primitive": ("turnAround", None)}


@pytest.mark.parametrize("name", sorted(GROUND_STEPS))
def test_ground_step_matches_jax(skels, name):
    """One step by its configuration: both anchors with their blend
    windows and, for stance_mode "toe", the stance pin and swing clamp;
    on a slope each anchor takes the height under its own root."""
    sj, st = skels
    mp, slope = GROUND_STEPS[name]
    frames = np.tile(_rest_frame(st), (30, 1))
    frames[:, 0] = np.linspace(0.0, 50.0 if slope else 10.0, 30)
    frames[:, 1] = -8.0 + (slope or 0.0) * frames[:, 0]
    fn = (lambda x, z: slope * x) if slope else None
    out_j = grj.ground_step(sj, frames, mp, 0, 29,
                            grj.SceneInterface(height_fn=fn))
    out_t = grt.ground_step(st, frames, mp, 0, 29,
                            grt.SceneInterface(height_fn=fn), device="cpu")
    np.testing.assert_allclose(out_t, out_j, atol=FRAMES_ATOL)
    if mp == "turnAround":
        np.testing.assert_array_equal(out_t, frames)


def test_ground_stance_swing_matches_jax(skels):
    """tests/test_postprocess.py's drifting root: the stance foot pinned
    at its first position, one IK pass over the 20 frames."""
    sj, st = skels
    frames = np.tile(_rest_frame(st), (20, 1))
    frames[:, 0] = np.linspace(0.0, 10.0, 20)
    frames[10:, 1] -= 4.0  # the swing foot sinks in the second half
    pos0 = np.asarray(skj.fk_positions(sj, jnp.asarray(frames[0])))
    ground = float(pos0[sj.index_of("RightFoot")][1])
    cfg = grj.MP_CONFIGURATIONS["leftStance"]
    out_j = grj.ground_stance_swing(sj, frames, cfg, 0, 19, ground)
    out_t = grt.ground_stance_swing(st, frames, cfg, 0, 19, ground,
                                    device="cpu")
    np.testing.assert_allclose(out_t, out_j, atol=FRAMES_ATOL)
    assert float(np.abs(out_t - frames).max()) > 1e-2


def test_detect_ground_contacts_matches_jax(skels):
    """The contact bits per foot, exactly, on the plant motion (feet on
    y = 0 or at least 8 cm above it: away from every threshold)."""
    sj, st = skels
    frames = _plant_motion(sj)
    s = {k: PLANT_SETTINGS[k] for k in (
        "contact_tolerance", "foot_lift_tolerance",
        "foot_lift_search_window", "smoothing_constraints_window")}
    c_j = grj.detect_ground_contacts(sj, frames, s)
    c_t = grt.detect_ground_contacts(st, frames, s, device="cpu")
    assert sorted(c_t) == sorted(c_j) == ["LeftFoot", "RightFoot"]
    for foot in c_j:
        np.testing.assert_array_equal(c_t[foot], c_j[foot])
    assert c_t["LeftFoot"][20] == 1 and c_t["LeftFoot"][2] == 0


@pytest.mark.parametrize("with_steps", [False, True])
def test_foot_plant_constraints_match_jax(skels, with_steps):
    """generate_foot_plant_constraints (runs clipped to their step's
    range with steps) and apply_grounding_constraints with blending on
    the jittered plant motion."""
    sj, st = skels
    frames = _plant_motion(sj)
    steps = ([types.SimpleNamespace(node_key=("walk", "leftStance"),
                                    start_frame=0, end_frame=21),
              types.SimpleNamespace(node_key=("walk", "rightStance"),
                                    start_frame=22, end_frame=59)]
             if with_steps else None)
    cs_j, br_j, _ = grj.generate_foot_plant_constraints(
        sj, frames, PLANT_SETTINGS, steps=steps)
    cs_t, br_t, _ = grt.generate_foot_plant_constraints(
        st, frames, PLANT_SETTINGS, steps=steps, device="cpu")
    assert [c[:3] for c in cs_t] == [c[:3] for c in cs_j]
    assert br_t == br_j
    for a, b in zip(cs_j, cs_t):
        np.testing.assert_allclose(b[3], a[3], rtol=1e-6, atol=1e-4)
    noisy = frames.copy()
    noisy[15:30, 0] += np.linspace(0, 2.0, 15)
    out_j = grj.apply_grounding_constraints(sj, noisy, cs_j,
                                            activate_blending=True,
                                            constraint_range=4)
    out_t = grt.apply_grounding_constraints(st, noisy, cs_t,
                                            activate_blending=True,
                                            constraint_range=4, device="cpu")
    np.testing.assert_allclose(out_t, out_j, atol=FRAMES_ATOL)
    assert float(np.abs(out_t - noisy).max()) > 1e-2


@pytest.mark.parametrize("foot_plants", [True, False])
def test_ground_motion_matches_jax(skels, foot_plants):
    """Both paths of ground_motion: the foot plants of `_stand_then_jump`
    (jittered while standing), and the stance table over two steps of a
    drifting root with the feet 3 cm below the ground; a skeleton without
    feet returns its input."""
    sj, st = skels
    if foot_plants:
        frames = _stand_then_jump(sj)
        frames[5:25, 0] += np.linspace(0.0, 2.0, 20)
        bounds = ((0, 29), (30, 59))
    else:
        frames = np.tile(_rest_frame(st), (40, 1))
        frames[:, 0] = np.linspace(0.0, 10.0, 40)
        frames[:, 1] = -8.0
        bounds = ((0, 19), (20, 39))
    steps = [types.SimpleNamespace(node_key=("walk", mp), start_frame=a,
                                   end_frame=b)
             for mp, (a, b) in zip(("leftStance", "rightStance"), bounds)]
    s = dict(PLANT_SETTINGS, generate_foot_plant_constraints=foot_plants)
    out_t = grt.ground_motion(st, frames, steps, grt.SceneInterface(), s,
                              device="cpu")
    out_j = grj.ground_motion(sj, frames, steps, grj.SceneInterface(), s)
    np.testing.assert_allclose(out_t, out_j, atol=PLANT_ATOL)
    assert float(np.abs(out_t - frames).max()) > 2 * PLANT_ATOL
    toy = skt.load_bvh(synj.TEST_BVH)[0]
    flat = np.tile(_rest_frame(toy), (5, 1))
    assert grt.ground_motion(toy, flat, [], device="cpu") is flat


@pytest.mark.parametrize("window", [1, 3, 8, 70])
def test_smooth_bitvector_matches_jax(window):
    """The port's own copy of the contact bits' majority vote."""
    bv = (np.random.default_rng(window).random(64) > 0.4).astype(np.int8)
    np.testing.assert_array_equal(prept.smooth_bitvector(bv, window),
                                  prepj.smooth_bitvector(bv, window))


def _trajectory_case(skel_mod, sp_mod, skel, fixed_range, unconstrained):
    """tests/test_config_knobs.py's trajectory IK input: 40 rest frames
    of TEST_BVH, a straight line 5 cm beside the Head joint over frames
    8-31."""
    base = np.zeros((40, skel.n_frame_params), np.float32)
    base[:, 3::4] = 1.0
    base[:, 0] = np.linspace(0.0, 6.0, 40)
    joint = skel.node_names[2]
    jidx = skel.index_of(joint)
    f0 = (jnp.asarray(base[0]) if skel_mod is skj
          else torch.as_tensor(base[0]))
    p0 = np.asarray(skel_mod.fk_positions(skel, f0))[jidx]
    line = np.stack([p0 + [5.0, 0.0, -10.0], p0 + [5.0, 3.0, 0.0],
                     p0 + [5.0, 0.0, 10.0]]).astype(np.float32)
    return base, joint, sp_mod.build(line, unconstrained_dims=unconstrained)


@pytest.mark.parametrize("fixed_range,unconstrained",
                         [(True, ()), (False, ()), (False, (1,))])
def test_apply_ik_trajectory_constraints_matches_jax(fixed_range,
                                                     unconstrained):
    """The trajectory IK pass: the start arc fixed or searched, a height
    that follows the joint's own path and the edge ramp (JAX pads the 24
    frames to 32, the port solves them unpadded); frames outside the range
    untouched."""
    sj, st = (m.load_bvh(synj.TEST_BVH)[0] for m in (skj, skt))
    out = []
    for sk_mod, sp_mod, pp, skel in ((skj, spj, ppj, sj),
                                     (skt, spt, ppt, st)):
        base, joint, sp = _trajectory_case(sk_mod, sp_mod, skel,
                                           fixed_range, unconstrained)
        c = pp.IKTrajectoryConstraint(
            joint=joint, spline=sp, start_frame=8, end_frame=31,
            fixed_range=fixed_range, unconstrained_dims=unconstrained)
        kw = {} if pp is ppj else {"device": "cpu"}
        out.append(pp.apply_ik_trajectory_constraints(
            skel, base, [c], n_iters=10, blend_window=4, **kw))
    np.testing.assert_allclose(out[1], out[0], atol=FRAMES_ATOL)
    np.testing.assert_array_equal(out[1][:8], base[:8])
    np.testing.assert_array_equal(out[1][32:], base[32:])
    assert float(np.abs(out[1][20] - base[20]).max()) > 1e-2


def test_post_process_motion_matches_jax(skels):
    """Keyframe IK, trajectory IK and grounding in one post_process_motion
    under JAX's flags (the grounding by foot plants), on
    `_stand_then_jump`."""
    sj, st = skels
    frames = _stand_then_jump(sj)
    steps = [types.SimpleNamespace(node_key=("walk", "leftStance"),
                                   start_frame=0, end_frame=59,
                                   action_name="walk")]
    cfg = default_config()
    cfg["activate_motion_grounding"] = True
    cfg["motion_grounding_settings"] = dict(PLANT_SETTINGS)
    pos = np.asarray(skj.fk_positions(sj, jnp.asarray(frames[45])))
    target = pos[sj.index_of("Head")] + [4.0, -3.0, 2.0]
    line = np.stack([pos[sj.index_of("Head")] + [6.0, 0.0, z]
                     for z in (-10.0, 0.0, 10.0)]).astype(np.float32)
    def run(pp, sp_mod, gr, skel, f, **kw):
        ik = [pp.IKConstraint(frame_idx=45, joint="Head", position=target)]
        traj = [pp.IKTrajectoryConstraint(
            joint="Head", spline=sp_mod.build(line), start_frame=40,
            end_frame=55)]
        return pp.post_process_motion(skel, f, steps, ik, cfg,
                                      scene=gr.SceneInterface(),
                                      ik_trajectories=traj, **kw)

    np.testing.assert_allclose(run(ppt, spt, grt, st, frames, device="cpu"),
                               run(ppj, spj, grj, sj, frames),
                               atol=FRAMES_ATOL)


DEFAULT_DEVICE_CALLS = {
    "move_to_ground": lambda s, f: grt.move_to_ground(s, f),
    "ground_stance_swing": lambda s, f: grt.ground_stance_swing(
        s, f, grt.MP_CONFIGURATIONS["leftStance"], 0, 4, 0.0),
    "detect_ground_contacts": lambda s, f: grt.detect_ground_contacts(s, f),
    "generate_foot_plant_constraints":
        lambda s, f: grt.generate_foot_plant_constraints(s, f),
    "apply_grounding_constraints": lambda s, f: grt.apply_grounding_constraints(
        s, f, [("LeftFoot", 0, 2, np.zeros(3))]),
    "ground_step": lambda s, f: grt.ground_step(s, f, "leftStance", 0, 4),
    "ground_motion": lambda s, f: grt.ground_motion(s, f, []),
    "apply_ik_constraints": lambda s, f: ppt.apply_ik_constraints(
        s, f, [ppt.IKConstraint(2, "LeftFoot", np.zeros(3))]),
    "apply_ik_trajectory_constraints":
        lambda s, f: ppt.apply_ik_trajectory_constraints(s, f, []),
    "post_process_motion": lambda s, f: ppt.post_process_motion(s, f, []),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CALLS))
def test_post_process_defaults_to_the_card(skels, name):
    """Every public post-process function runs on the CUDA device unless
    given device="cpu"; without a card the default raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    frames = np.tile(_rest_frame(skels[1]), (5, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DEFAULT_DEVICE_CALLS[name](skels[1], frames)
