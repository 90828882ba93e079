"""The port's general selection walk with the constraint families against
the JAX walk (constrained_walk_full_crowd with pallas_selection=False on
the same draws), and the walk's guards on the families."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.constraints import compiled as cj  # noqa: E402
from morphablegraphs_tpu.ops import spline_path as spj  # noqa: E402
from morphablegraphs_tpu.synthesis import constrained_walk as cwj  # noqa: E402
from morphablegraphs_tpu_torch.constraints import compiled as ct  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cwt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

N_CHARS, N_SAMPLES, MAX_FRAMES = 3, 24, 64
LOOK_AT = dict(joint="Head", target=(200.0, 150.0, -300.0), frame=20.0)


@pytest.fixture(scope="module")
def toy():
    skel_j, st_j, skel_t, st_t = tp.model("toy")
    paths_j = tp.stack_jax_paths(tp.rand_paths(N_CHARS, seed=3,
                                               seg_len=90.0))
    return dict(skel_j=skel_j, st_j=st_j, skel_t=skel_t, st_t=st_t,
                paths_j=paths_j, paths_t=tp.port_paths(paths_j),
                start=st_j.node_id(("walk", "beginLeftStance")))


def _steps(sc, n_steps: int):
    return jax.tree.map(lambda x: np.broadcast_to(
        np.asarray(x), (n_steps,) + np.shape(x)).copy(), sc)


def _draws(s, key, n_steps):
    st_j = s["st_j"]
    return tp.jax_walk_draws(key, N_CHARS, n_steps, N_SAMPLES,
                             st_j.gmm_weights.shape[-1],
                             st_j.gmm_means.shape[-1], st_j.n_nodes)


def _jax_walk(s, key, n_steps, scs_j, **kw):
    out = cwj.constrained_walk_full_crowd(
        s["skel_j"], key, s["st_j"], s["paths_j"], s["start"],
        n_chars=N_CHARS, n_steps=n_steps, step_scs=scs_j,
        pallas_selection=False, root_only=False, lm_frozen=False,
        return_pre_lm_err=True, max_step_frames=MAX_FRAMES,
        n_samples=N_SAMPLES, **kw)
    return tuple(np.asarray(a) for a in out)


def _teacher_forced(s, jax_out, n_steps, scs_t, draws, cfg):
    """Each port step from the JAX walk's state (node, previous last frame,
    travelled arc) and draws, held to the step bounds of
    tests/test_torch_walk_ee.py's general selection walk: frame counts
    exactly, the selection error before the LM to rtol 1e-4 plus atol
    2e-3, the error after it to rtol 1e-4 plus atol 1e-2 and the frames to
    atol 1e-3."""
    segs, nf, ids, errs, pre = jax_out
    skel_t, st_t, paths_t = s["skel_t"], s["st_t"], s["paths_t"]
    table = kernels.pack_path_table(paths_t, torch.as_tensor(
        skel_t.offsets[0]))
    closest = jax.jit(jax.vmap(lambda p, x, a: spj.closest_point(p, x, a)[1]))
    travelled = np.zeros(N_CHARS, np.float32)
    prev_last = np.zeros((N_CHARS, st_t.n_dim), np.float32)
    for t in range(n_steps):
        state = cwt.WalkState(
            node_id=torch.as_tensor(ids[:, t].copy()).long(),
            prev_last=torch.as_tensor(prev_last.copy()),
            travelled=torch.as_tensor(travelled.copy()),
            done=torch.zeros(N_CHARS, dtype=torch.bool))
        _, step = cwt.full_walk_step(
            skel_t, st_t, paths_t, table, state, t,
            cwt.step_constraints(scs_t, t, N_CHARS, "cpu"), draws(t), cfg,
            root_only=ct.step_scs_root_only(scs_t))
        np.testing.assert_array_equal(step.n_frames.numpy(), nf[:, t])
        np.testing.assert_allclose(step.pre_lm_error.numpy(), pre[:, t],
                                   rtol=1e-4, atol=2e-3)
        np.testing.assert_allclose(step.error.numpy(), errs[:, t],
                                   rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(step.frames.numpy(), segs[:, t],
                                   atol=1e-3)
        prev_last = segs[np.arange(N_CHARS), t, nf[:, t] - 1]
        travelled = np.asarray(closest(s["paths_j"],
                                       jnp.asarray(prev_last[:, :3]),
                                       jnp.asarray(travelled)))


def test_general_selection_look_at_matches_jax(toy):
    """A look-at slot (the reference action builder's) on the general
    selection path: the candidates are ranked with the look-at residual,
    as the JAX walk ranks them.  Without the LM over two steps, the same
    nodes and frame counts and the selection errors to rtol 1e-4 plus atol
    2e-3; with one exact LM iteration, each step from the JAX walk's state
    at the step bounds of `_teacher_forced`.  A port that scored the slot
    0 reports step-0 errors ~50 below the JAX walk's."""
    s = toy
    skel_j = s["skel_j"]
    base = cj.set_look_at_constraint(
        cj.empty_step_constraints(skel_j, 0), skel_j, LOOK_AT["joint"],
        np.asarray(LOOK_AT["target"], np.float32), LOOK_AT["frame"])
    n_steps = 2
    scs_j = _steps(base, n_steps)
    scs_t = ct.from_jax_numpy(scs_j, host=True)
    key = jax.random.PRNGKey(31)
    draws = tp.port_draws(_draws(s, key, n_steps))
    start = torch.full((N_CHARS,), s["start"])

    segs, nf, ids, errs, pre = _jax_walk(s, key, n_steps, scs_j, lm_iters=0)
    assert np.all(ids >= 0)
    out = cwt.constrained_walk_full_crowd(
        s["skel_t"], s["st_t"], s["paths_t"], start, n_steps, draws=draws,
        step_scs=scs_t, cfg=cwt.WalkConfig(
            max_step_frames=MAX_FRAMES, n_samples=N_SAMPLES, lm_iters=0,
            pallas_selection=False, return_pre_lm_err=True))
    np.testing.assert_array_equal(out[2].numpy(), ids)
    np.testing.assert_array_equal(out[1].numpy(), nf)
    np.testing.assert_allclose(out[4].numpy(), pre, rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(out[3].numpy(), errs, rtol=1e-4, atol=2e-3)

    kw = dict(lm_iters=1, lm_threshold=5.0)
    jax_out = _jax_walk(s, key, n_steps, scs_j, **kw)
    _teacher_forced(s, jax_out, n_steps, scs_t, draws, cwt.WalkConfig(
        max_step_frames=MAX_FRAMES, n_samples=N_SAMPLES,
        pallas_selection=False, return_pre_lm_err=True, **kw))


def _families_scs(skel_j, n_steps):
    """Every family on the toy skeleton (the Leg and the Head stand in for
    the hands), the transition pose at step 0 only."""
    frame = tp.prev_frame(skel_j.n_frame_params, 0.0, 0.0, seed=7)
    sc = tp.add_family(cj, spj, cj.empty_step_constraints(skel_j, 0),
                       skel_j, "toy", "all", frame)
    scs = _steps(jax.tree.map(np.asarray, sc), n_steps)
    pose = np.zeros(n_steps, np.float32)
    pose[0] = 1.0
    return scs.replace(pose_active=pose)


def test_families_walk_matches_jax(toy):
    """A walk with every family (look-at, relative transform, joint
    rotation, the pose at step 0, two CA slots, a trajectory set with an
    exhausted joint, an active range) and the half-step keyframe, through
    the general selection path and two iterations of the exact LM
    (use_ca, use_ts, use_half): the whole walk takes the JAX walk's nodes
    and frame counts, and each step from the JAX walk's state emits the
    JAX step within `_teacher_forced`'s bounds."""
    s = toy
    n_steps = 3
    scs_j = _families_scs(s["skel_j"], n_steps)
    scs_t = ct.from_jax_numpy(scs_j, host=True)
    key = jax.random.PRNGKey(5)
    draws = tp.port_draws(_draws(s, key, n_steps))
    kw = dict(lm_iters=2, lm_threshold=5.0, use_ca=True, use_ts=True,
              use_half=True)
    jax_out = _jax_walk(s, key, n_steps, scs_j, **kw)
    assert np.all(jax_out[2] >= 0)
    cfg = cwt.WalkConfig(max_step_frames=MAX_FRAMES, n_samples=N_SAMPLES,
                         pallas_selection=False, return_pre_lm_err=True,
                         **kw)
    out = cwt.constrained_walk_full_crowd(
        s["skel_t"], s["st_t"], s["paths_t"],
        torch.full((N_CHARS,), s["start"]), n_steps, draws=draws,
        step_scs=scs_t, cfg=cfg)
    np.testing.assert_array_equal(out[2].numpy(), jax_out[2])
    np.testing.assert_array_equal(out[1].numpy(), jax_out[1])
    _teacher_forced(s, jax_out, n_steps, scs_t, draws, cfg)


GUARDS = {
    # (the families set on every step, WalkConfig flags, the message)
    "half_with_kernels": (None, dict(use_half=True), "half-step"),
    "frozen_look_at": ("look_at", dict(pallas_selection=False,
                                       lm_frozen=True), "lm_frozen needs"),
    "frozen_ee_look_at": ("look_at", dict(pallas_selection=False,
                                          lm_frozen=True, frozen_ee="Head"),
                          "slot 2"),
    "ca_without_use_ca": ("ca", dict(pallas_selection=False),
                          "use_ca=True"),
    "ts_without_use_ts": ("traj_set", dict(pallas_selection=False,
                                           use_ca=True), "use_ts=True"),
    "look_at_with_kernels": ("look_at", {}, "locomotion family"),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_walk_guards_on_families(toy, case):
    """The crowd boundary refuses what the walk would get wrong: the half
    step on the selection kernels (JAX's guard), a family on the frozen LM
    outside its model (JAX's guards), a family slot whose flag is off (the
    JAX walk would score it 0) and a family slot on the selection
    kernels."""
    s = toy
    family, flags, msg = GUARDS[case]
    base = ct.empty_step_constraints(s["skel_t"], 0)
    if family is not None:
        base = tp.add_family(ct, tp.spt, base, s["skel_t"], "toy", family)
    cfg = cwt.WalkConfig(max_step_frames=MAX_FRAMES, n_samples=128,
                         lm_iters=0, **flags)
    with pytest.raises(ValueError, match=msg):
        cwt.constrained_walk_full_crowd(
            s["skel_t"], s["st_t"], s["paths_t"],
            torch.full((N_CHARS,), s["start"]), 1,
            draws=tp.port_draws(_draws(s, jax.random.PRNGKey(0), 1)),
            step_scs=cwt.stack_steps(base, 1), cfg=cfg)
