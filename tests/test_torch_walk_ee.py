"""Parity of the port's end-effector crowd walk with the JAX package
(constrained_walk_full with pallas_selection + pallas_ee, and the frozen-ee
or the exact LM), driven by the same random draws, and the walk's contract
guards."""

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

N_CHARS, N_STEPS, N_SAMPLES, MAX_FRAMES = 3, 3, 128, 64
JOINT = "Head"
# JAX's toy-model ee test: a y-masked Head target on canonical frame 30
TARGET, FRAME, WEIGHT = [5.0, np.nan, 30.0], 30.0, 1.2
WALK_KW = dict(max_step_frames=MAX_FRAMES, n_samples=N_SAMPLES, lm_iters=3,
               lm_threshold=5.0)
FLAGS = {  # port WalkConfig flags -> the JAX walk's
    "ee_frozen": dict(pallas_ee=JOINT, lm_frozen=True, frozen_ee=JOINT),
    "ee_exact": dict(pallas_ee=JOINT, lm_frozen=False),
}


@pytest.fixture(scope="module")
def walk_setup():
    skel_j, st_j, skel_t, st_t = tp.model("toy")
    paths_j = tp.stack_jax_paths(tp.rand_paths(N_CHARS, seed=3,
                                               seg_len=90.0))
    scs_j, scs_t = tp.ee_step_scs(skel_j, JOINT, FRAME, TARGET, N_STEPS,
                                  weight=WEIGHT)
    start = st_j.node_id(("walk", "beginLeftStance"))
    key = jax.random.PRNGKey(17)
    draws = tp.jax_walk_draws(key, N_CHARS, N_STEPS, N_SAMPLES,
                              st_j.gmm_weights.shape[-1],
                              st_j.gmm_means.shape[-1], st_j.n_nodes)
    return dict(skel_j=skel_j, st_j=st_j, skel_t=skel_t, st_t=st_t,
                paths_j=paths_j, paths_t=tp.port_paths(paths_j),
                scs_j=scs_j, scs_t=scs_t, start=start, key=key, draws=draws)


def _jax_walk(s, flags):
    out = cwj.constrained_walk_full_crowd(
        s["skel_j"], s["key"], s["st_j"], s["paths_j"], s["start"],
        n_chars=N_CHARS, n_steps=N_STEPS, step_scs=s["scs_j"],
        pallas_selection=True, root_only=False, **flags, **WALK_KW)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("variant", ["ee_frozen", "ee_exact"])
def test_ee_walk_matches_jax(walk_setup, variant):
    """The port's ee crowd walk (B3's twin ranks the candidates with the
    Head keyframe; the frozen-ee closed LM, or the exact LM over the dense
    FK residuals) on the JAX draws.

    Each step, run teacher-forced from the JAX walk's state, emits the JAX
    step within the step bounds of tests/test_torch_walk.py: frame counts
    exactly, errors to rtol 1e-4 plus atol 1e-2, frames to atol 1e-3
    (measured: 9.3e-3 and 7.7e-4).  The whole walk takes the same nodes
    and frame counts; its errors and frames are held to the bounds of the
    JAX package's own comparison of two walks that differ only in rounding
    (test_full_walk_frozen_closed_matches_linearize_walk: errors atol 5e-2
    plus rtol 5e-3, under 1% of frame elements beyond 2e-2).  The tighter
    whole-walk bounds of tests/test_torch_walk.py do not hold here: each
    step starts from the port's own carried frame, ~1e-4 off after the
    first step, and the LM pulling the Head toward its keyframe amplifies
    that to 3e-3 after two steps and 2.5e-2 (errors 0.1-0.2 of ~60) after
    three."""
    s = walk_setup
    segs, nf, ids, errs = _jax_walk(s, FLAGS[variant])
    assert np.all(ids >= 0), "the JAX walk must not end inside the test"
    cfg = cwt.WalkConfig(**WALK_KW, **FLAGS[variant])
    out = cwt.constrained_walk_full_crowd(
        s["skel_t"], s["st_t"], s["paths_t"],
        torch.full((N_CHARS,), s["start"]), N_STEPS,
        draws=tp.port_draws(s["draws"]), step_scs=s["scs_t"], cfg=cfg)
    t_segs, t_nf, t_ids, t_errs = (a.numpy() for a in out)
    np.testing.assert_array_equal(t_ids, ids)
    np.testing.assert_array_equal(t_nf, nf)
    np.testing.assert_allclose(t_errs, errs, rtol=5e-3, atol=5e-2)
    mask = nf > 0
    assert float((np.abs(t_segs[mask] - segs[mask]) > 2e-2).mean()) < 1e-2

    # teacher-forced: each step from the JAX walk's state
    skel_t, st_t, paths_t = s["skel_t"], s["st_t"], s["paths_t"]
    table = kernels.pack_path_table(paths_t, torch.as_tensor(
        skel_t.offsets[0]))
    idx, const = kernels.pack_ee_chain(skel_t, JOINT)
    chain = (idx, torch.as_tensor(const))
    closest = jax.jit(jax.vmap(lambda p, x, a: spj.closest_point(p, x, a)[1]))
    draws = tp.port_draws(s["draws"])
    travelled = np.zeros(N_CHARS, np.float32)
    prev_last = np.zeros((N_CHARS, st_t.n_dim), np.float32)
    for t in range(N_STEPS):
        state = cwt.WalkState(
            node_id=torch.as_tensor(ids[:, t]).long(),
            prev_last=torch.as_tensor(prev_last),
            travelled=torch.as_tensor(travelled),
            done=torch.zeros(N_CHARS, dtype=torch.bool))
        _, step = cwt.full_walk_step(
            skel_t, st_t, paths_t, table, state, t,
            cwt.step_constraints(s["scs_t"], t, N_CHARS, "cpu"), draws(t),
            cfg, root_only=False, ee_chain=chain)
        np.testing.assert_array_equal(step.n_frames.numpy(), nf[:, t])
        np.testing.assert_allclose(step.error.numpy(), errs[:, t],
                                   rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(step.frames.numpy(), segs[:, t],
                                   atol=1e-3)
        prev_last = segs[np.arange(N_CHARS), t, nf[:, t] - 1]
        travelled = np.asarray(closest(s["paths_j"],
                                       jnp.asarray(prev_last[:, :3]),
                                       jnp.asarray(travelled)))


def test_general_selection_walk_matches_jax(walk_setup):
    """A walk the selection kernels cannot rank: a Head keyframe with an
    orientation in slot 2 and a Leg keyframe in slot 3, 24 candidates a
    step.  With pallas_selection the crowd boundary refuses it; without,
    the exact evaluator ranks the candidates as the JAX walk's vmapped
    stacked_error does (pallas_selection=False, root_only=False, the exact
    LM at one iteration).  Each step fed the JAX walk's state and draws:
    frame counts exactly, the selection error before the LM to rtol 1e-4
    plus atol 2e-3, the error after it and the frames to the ee step
    bounds above (atol 1e-2, 1e-3)."""
    s = walk_setup
    skel_j, skel_t, st_t, paths_t = (s["skel_j"], s["skel_t"], s["st_t"],
                                     s["paths_t"])
    n_samples, n_steps = 24, 2
    half = np.deg2rad(25.0) / 2
    base = cj.set_keyframe_constraint(
        cj.empty_step_constraints(skel_j, 0), 2, skel_j, JOINT, FRAME,
        position=np.asarray(TARGET, np.float32),
        quat_wxyz=np.asarray([np.cos(half), 0.0, np.sin(half), 0.0],
                             np.float32), weight=WEIGHT)
    base = cj.set_keyframe_constraint(
        base, 3, skel_j, "Leg", 12.0,
        position=np.asarray([3.0, 40.0, 10.0], np.float32))
    scs_j = jax.tree.map(lambda x: np.broadcast_to(
        np.asarray(x), (n_steps,) + np.shape(x)).copy(), base)
    scs_t = ct.from_jax_numpy(scs_j, host=True)
    kw = dict(max_step_frames=MAX_FRAMES, n_samples=n_samples, lm_iters=1,
              lm_threshold=5.0)
    key = jax.random.PRNGKey(29)
    st_j = s["st_j"]
    draws = tp.port_draws(tp.jax_walk_draws(
        key, N_CHARS, n_steps, n_samples, st_j.gmm_weights.shape[-1],
        st_j.gmm_means.shape[-1], st_j.n_nodes))
    start = torch.full((N_CHARS,), s["start"])
    with pytest.raises(ValueError, match="locomotion family"):
        cwt.constrained_walk_full_crowd(
            skel_t, st_t, paths_t, start, n_steps, draws=draws,
            step_scs=scs_t, cfg=cwt.WalkConfig(**dict(kw, n_samples=128)))
    with pytest.raises(ValueError, match="pallas_ee requires"):
        cwt.constrained_walk_full_crowd(
            skel_t, st_t, paths_t, start, n_steps, draws=draws,
            step_scs=scs_t, cfg=cwt.WalkConfig(
                **kw, pallas_selection=False, pallas_ee=JOINT))

    out = cwj.constrained_walk_full_crowd(
        skel_j, key, st_j, s["paths_j"], s["start"], n_chars=N_CHARS,
        n_steps=n_steps, step_scs=scs_j, pallas_selection=False,
        root_only=False, lm_frozen=False, return_pre_lm_err=True, **kw)
    segs, nf, ids, errs, pre = (np.asarray(a) for a in out)
    assert np.all(ids >= 0)
    cfg = cwt.WalkConfig(**kw, pallas_selection=False,
                         return_pre_lm_err=True)
    whole = cwt.constrained_walk_full_crowd(
        skel_t, st_t, paths_t, start, n_steps, draws=draws, step_scs=scs_t,
        cfg=cfg)
    np.testing.assert_array_equal(whole[2].numpy(), ids)
    np.testing.assert_array_equal(whole[1].numpy(), nf)
    np.testing.assert_allclose(whole[4][:, 0].numpy(), pre[:, 0], rtol=1e-4,
                               atol=2e-3)

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
            root_only=False)
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


def test_general_selection_chunks_agree(walk_setup, monkeypatch):
    """Ranking in chunks of candidates (a crowd too large for one pass of
    the exact evaluator) gives the errors of one pass."""
    s = walk_setup
    skel_t, st_t = s["skel_t"], s["st_t"]
    cfg = cwt.WalkConfig(max_step_frames=MAX_FRAMES, n_samples=N_SAMPLES,
                         lm_iters=0, pallas_selection=False)
    args = (skel_t, st_t, s["paths_t"], torch.full((N_CHARS,), s["start"]), 1)
    kw = dict(draws=tp.port_draws(s["draws"]), step_scs=s["scs_t"], cfg=cfg)
    one = cwt.constrained_walk_full_crowd(*args, **kw)
    monkeypatch.setattr(cwt, "MAX_EXACT_ROWS", 5 * N_CHARS)
    chunked = cwt.constrained_walk_full_crowd(*args, **kw)
    for a, b in zip(one, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_walk_guards_raise_as_jax(walk_setup):
    """The crowd boundary refuses what the kernels and the frozen model
    would get wrong, with JAX's messages (test_constrained_walk_full.py
    :717-733): ee slots without pallas_ee, another family beside the ee
    slot, the frozen LM on non-root slots without frozen_ee, and frozen_ee
    on a set with a slot on another joint."""
    s = walk_setup
    skel_t, skel_j = s["skel_t"], s["skel_j"]

    def run(scs, **flags):
        cwt.constrained_walk_full_crowd(
            skel_t, s["st_t"], s["paths_t"],
            torch.full((N_CHARS,), s["start"]), N_STEPS,
            draws=tp.port_draws(s["draws"]), step_scs=scs,
            cfg=cwt.WalkConfig(**dict(WALK_KW, lm_iters=0), **flags))

    with pytest.raises(ValueError, match="locomotion family"):
        run(s["scs_t"])
    base_j = jax.tree.map(lambda x: np.asarray(x)[0], s["scs_j"])
    bad_j = cj.set_look_at_constraint(base_j, skel_j, JOINT, np.zeros(3),
                                      0.0)
    bad_t = cwt.stack_steps(ct.from_jax_numpy(bad_j, host=True), N_STEPS)
    with pytest.raises(ValueError, match="slot 2"):
        run(bad_t, pallas_ee=JOINT)
    with pytest.raises(ValueError, match="frozen_ee"):
        run(s["scs_t"], pallas_ee=JOINT, lm_frozen=True)
    other = cwt.stack_steps(ct.set_keyframe_constraint(
        ct.empty_step_constraints(skel_t, 0), 2, skel_t, "Leg", FRAME,
        position=[1.0, 2.0, 3.0]), N_STEPS)
    with pytest.raises(ValueError, match="slot 2"):
        run(other, pallas_ee="Leg", lm_frozen=True, frozen_ee=JOINT)
