"""Parity of the port's random walks, frame appending, boundary-row
constrained walk and single-device crowd entry points with the JAX package,
each driven by the JAX walk's own random draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.models import graph as gj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.ops import align as alj  # noqa: E402
from morphablegraphs_tpu.serve import batch as batch_j  # noqa: E402
from morphablegraphs_tpu.synthesis import constrained_walk as cwj  # noqa: E402
from morphablegraphs_tpu.synthesis import walk as wj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as gt  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.ops import align as alt  # noqa: E402
from morphablegraphs_tpu_torch.parallel import crowd as pct  # noqa: E402
from morphablegraphs_tpu_torch.serve import batch as batch_t  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cwt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import walk as wt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

MAX_FRAMES = 64
# frames: fp32 back-projection of ~100-cm root channels (B6's twin against
# JAX's HIGHEST-precision matmuls) through the chained alignment; measured
# max 6e-5 over 5 steps
FRAMES_ATOL = 1e-3


@pytest.fixture(scope="module")
def toy():
    skel_j, st_j, skel_t, st_t = tp.model("toy")
    return dict(skel_j=skel_j, st_j=st_j, skel_t=skel_t, st_t=st_t,
                start=st_j.node_id(("walk", "beginLeftStance")))


def _draws(st_j, keys, n_steps):
    return tp.jax_random_walk_draws(keys, n_steps, st_j.gmm_weights.shape[-1],
                                    st_j.gmm_means.shape[-1], st_j.n_nodes)


def _assert_buffers(buf_j, nv_j, buf_t, nv_t):
    nv_j = np.asarray(nv_j).reshape(-1)
    np.testing.assert_array_equal(nv_t.numpy(), nv_j)
    buf_j = np.asarray(buf_j).reshape(buf_t.shape)
    for c, n in enumerate(nv_j):
        np.testing.assert_allclose(buf_t[c, :n].numpy(), buf_j[c, :n],
                                   atol=FRAMES_ATOL)


@pytest.mark.parametrize("seed", [0, 2])
def test_random_walk_matches_jax(toy, seed):
    """One JAX random_walk and the port's on the replayed draws (its key is
    the walk's state key): node ids and n_valid exactly, the valid frames
    within FRAMES_ATOL, the latents to 1e-5."""
    key = jax.random.PRNGKey(seed)
    buf, nv, ids, lat = wj.random_walk(key, toy["st_j"], toy["start"],
                                       n_steps=5, max_step_frames=MAX_FRAMES)
    draws = tp.port_random_draws(_draws(toy["st_j"], key[None], 5))
    b_t, nv_t, ids_t, lat_t = wt.random_walk(
        toy["st_t"], torch.tensor([toy["start"]]), 5, draws,
        max_step_frames=MAX_FRAMES)
    np.testing.assert_array_equal(ids_t[0].numpy(), np.asarray(ids))
    _assert_buffers(buf, nv, b_t, nv_t)
    np.testing.assert_allclose(lat_t[0].numpy(), np.asarray(lat), atol=1e-5)


@pytest.mark.parametrize("use_time", [True, False])
def test_random_walk_crowd_matches_jax(toy, use_time):
    """random_walk_crowd (keys split over the characters) with and without
    the time warp: node ids and n_valid exactly, frames within
    FRAMES_ATOL."""
    key = jax.random.PRNGKey(1)
    n_chars, n_steps = 4, 4
    buf, nv, ids, _ = wj.random_walk_crowd(
        key, toy["st_j"], toy["start"], n_chars=n_chars, n_steps=n_steps,
        max_step_frames=MAX_FRAMES, use_time=use_time)
    draws = tp.port_random_draws(_draws(
        toy["st_j"], jax.random.split(key, n_chars), n_steps))
    b_t, nv_t, ids_t, _ = wt.random_walk_crowd(
        toy["st_t"], toy["start"], n_chars, n_steps, draws,
        max_step_frames=MAX_FRAMES, use_time=use_time)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids))
    _assert_buffers(buf, nv, b_t, nv_t)


def test_random_walk_segments_matches_jax(toy):
    """The segment-form walk against vmapped JAX random_walk_segments: node
    ids and frame counts exactly, each segment's valid frames within
    FRAMES_ATOL; flattened, it equals the port's concatenating walk on the
    same draws (to 1e-5, as the JAX package holds its two forms)."""
    key = jax.random.PRNGKey(3)
    n_chars, n_steps = 3, 5
    keys = jax.random.split(key, n_chars)
    segs, nf, ids, _ = jax.vmap(lambda k: wj.random_walk_segments(
        k, toy["st_j"], jnp.asarray(toy["start"], jnp.int32),
        n_steps=n_steps, max_step_frames=MAX_FRAMES))(keys)
    draws = tp.port_random_draws(_draws(toy["st_j"], keys, n_steps))
    start = torch.full((n_chars,), toy["start"])
    s_t, nf_t, ids_t, _ = wt.random_walk_segments(
        toy["st_t"], start, n_steps, draws, max_step_frames=MAX_FRAMES)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(nf_t.numpy(), np.asarray(nf))
    segs = np.asarray(segs)
    for c in range(n_chars):
        for t in range(n_steps):
            n = int(nf[c, t])
            np.testing.assert_allclose(s_t[c, t, :n].numpy(),
                                       segs[c, t, :n], atol=FRAMES_ATOL)
    buf, nv, _, _ = wt.random_walk(toy["st_t"], start, n_steps, draws,
                                   max_step_frames=MAX_FRAMES)
    for c in range(n_chars):
        flat = wt.flatten_segments(s_t[c].numpy(), nf_t[c].numpy())
        assert len(flat) == int(nv[c])
        np.testing.assert_allclose(flat, buf[c, : int(nv[c])].numpy(),
                                   atol=1e-5)


def _clip(rng, s, d, x, z, yaw):
    f = np.zeros((s, d), np.float32)
    f[:, 0] = x + np.arange(s)
    f[:, 1] = 90.0
    f[:, 2] = z + 0.5 * np.arange(s)
    q = rng.standard_normal((s, (d - 3) // 4, 4)) * 0.1
    q[..., 0] += 1.0
    q[:, 0] = [np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0]
    f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(s, -1)
    return f


def test_append_frames_matches_jax():
    """Two appends of a batch of clips (the first unaligned, the second
    aligned and smoothed at offset n_valid) against vmapped JAX
    append_frames, buffers to 1e-4; then a clip whose whole slab would
    pass the buffer's end is dropped (n_valid and buffer unchanged) for
    the characters it would overrun, and a character outside `active`
    keeps its buffer."""
    rng = np.random.default_rng(0)
    c, d, s, max_t = 3, 11, 16, 40
    app_j = jax.vmap(lambda b, n, f, k: alj.append_frames(b, n, f, k,
                                                          window=4))
    buf_j = jnp.zeros((c, max_t, d))
    nv_j = jnp.zeros(c, jnp.int32)
    buf_t = torch.zeros((c, max_t, d))
    nv_t = torch.zeros(c, dtype=torch.int32)
    for n_new in ([10, 12, 16], [12, 16, 8]):
        clips = np.stack([_clip(rng, s, d, 30.0 * i, -10.0, 0.3 * i + 0.2)
                          for i in range(c)])
        n_new = np.asarray(n_new, np.int32)
        buf_j, nv_j = app_j(buf_j, nv_j, jnp.asarray(clips),
                            jnp.asarray(n_new))
        buf_t, nv_t = alt.append_frames(buf_t, nv_t, torch.as_tensor(clips),
                                        torch.as_tensor(n_new), window=4)
        np.testing.assert_array_equal(nv_t.numpy(), np.asarray(nv_j))
        np.testing.assert_allclose(buf_t.numpy(), np.asarray(buf_j),
                                   atol=1e-4)
    # n_valid is now [22, 28, 24]: 16 more rows fit for characters 0 and 2
    # (n_valid + 16 <= 40), not for 1; character 2 is inactive
    clips = np.stack([_clip(rng, s, d, 0.0, 0.0, 0.1) for _ in range(c)])
    before = buf_t.clone()
    buf_j, nv_j = app_j(buf_j, nv_j, jnp.asarray(clips),
                        jnp.full((c,), 16, jnp.int32))
    buf_t, nv_t = alt.append_frames(
        buf_t, nv_t, torch.as_tensor(clips), torch.full((c,), 16,
                                                        dtype=torch.int32),
        window=4, active=torch.tensor([True, True, False]))
    np.testing.assert_array_equal(nv_t.numpy(), [38, 28, 24])
    np.testing.assert_array_equal(np.asarray(nv_j), [38, 28, 40])
    np.testing.assert_allclose(buf_t[0].numpy(), np.asarray(buf_j)[0],
                               atol=1e-4)
    assert torch.equal(buf_t[1:], before[1:])


def test_boundary_row_walk_matches_jax(toy):
    """The boundary-row constrained_walk_crowd on the JAX walk's draws
    (64 candidates a step): node ids and frame counts exactly, frames to
    1e-3, errors to rtol 1e-4 + atol 2e-3 (the heading error is the arccos
    of a cosine near 1, which resolves ~1e-3 degrees in fp32, as in the
    full walk's step test)."""
    n_chars, n_steps, n_samples = 3, 4, 64
    st_j = toy["st_j"]
    paths_j = tp.stack_jax_paths(tp.rand_paths(n_chars, seed=1,
                                               seg_len=90.0))
    key = jax.random.PRNGKey(5)
    draws = tp.jax_walk_draws(key, n_chars, n_steps, n_samples,
                              st_j.gmm_weights.shape[-1],
                              st_j.gmm_means.shape[-1], st_j.n_nodes)
    segs, nf, ids, errs = cwj.constrained_walk_crowd(
        key, st_j, paths_j, toy["start"], n_chars=n_chars, n_steps=n_steps,
        max_step_frames=MAX_FRAMES, n_samples=n_samples)
    out = cwt.constrained_walk_crowd(
        toy["st_t"], tp.port_paths(paths_j), toy["start"], n_chars, n_steps,
        tp.port_draws(draws), max_step_frames=MAX_FRAMES)
    s_t, nf_t, ids_t, e_t = (a.numpy() for a in out)
    np.testing.assert_array_equal(ids_t, np.asarray(ids))
    np.testing.assert_array_equal(nf_t, np.asarray(nf))
    np.testing.assert_allclose(e_t, np.asarray(errs), rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(s_t, np.asarray(segs), atol=1e-3)


def test_single_device_crowds_pass_through(toy):
    """On one device both crowd entry points return exactly what the crowd
    functions return on the same draws."""
    st_t, start = toy["st_t"], toy["start"]
    gen = torch.Generator().manual_seed(0)
    draws = [wt.torch_sampler(gen, st_t, 5, 1)(t) for t in range(3)]
    direct = wt.random_walk_crowd(st_t, start, 5, 3, draws.__getitem__,
                                  max_step_frames=MAX_FRAMES)
    via = pct.crowd_walk_sharded(["cpu"], st_t, start, 5, draws.__getitem__,
                                 n_steps=3, max_step_frames=MAX_FRAMES)
    for a, b in zip(direct, via):
        assert torch.equal(a, b)

    paths = tp.port_paths(tp.stack_jax_paths(tp.rand_paths(3, seed=2)))
    gen = torch.Generator().manual_seed(1)
    draws = [wt.torch_sampler(gen, st_t, 3, 128)(t) for t in range(2)]
    cfg = cwt.WalkConfig(max_step_frames=MAX_FRAMES, lm_iters=1,
                         lm_frozen=True)
    ids = torch.full((3,), start)
    direct = cwt.constrained_walk_full_crowd(
        toy["skel_t"], st_t, paths, ids, 2, draws.__getitem__, cfg=cfg)
    via = pct.constrained_crowd_sharded(
        [torch.device("cpu")], toy["skel_t"], st_t, paths, ids, 2,
        draws.__getitem__, cfg=cfg)
    for a, b in zip(direct, via):
        assert torch.equal(a, b)


def test_crowds_refuse_more_than_one_device(toy):
    """Two devices in one process are refused, not run on one, and the
    message names the process group; the walk's contract guard still
    comes first."""
    st_t, start = toy["st_t"], toy["start"]
    gen = torch.Generator().manual_seed(0)
    draws = wt.torch_sampler(gen, st_t, 4, 1)
    with pytest.raises(NotImplementedError, match="process group"):
        pct.crowd_walk_sharded(["cpu", "cpu"], st_t, start, 4, draws,
                               n_steps=2)
    paths = tp.port_paths(tp.stack_jax_paths(tp.rand_paths(2, seed=2)))
    ids = torch.full((2,), start)
    with pytest.raises(NotImplementedError, match="process group"):
        pct.constrained_crowd_sharded(["cpu", "cpu"], toy["skel_t"], st_t,
                                      paths, ids, 2, draws)
    scs = cwt.default_step_scs(toy["skel_t"], 2)
    kf = np.array(scs.kf_active)
    kf[:, 2] = 1.0
    scs.kf_active = kf
    with pytest.raises(ValueError, match="locomotion family"):
        pct.constrained_crowd_sharded(["cpu", "cpu"], toy["skel_t"], st_t,
                                      paths, ids, 2, draws, step_scs=scs)


# ---------------------------------------------------------------------------
# Serving: the boundary-row switch, and the way through parallel/
# ---------------------------------------------------------------------------

def _traj_request(end_x, end_z):
    return {
        "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
        "elementaryActions": [{
            "action": "walk",
            "constraints": [{"joint": "Hips", "trajectoryConstraints": [
                {"position": [0, None, 0]},
                {"position": [end_x / 2, None, end_z / 2]},
                {"position": [end_x, None, end_z]}]}],
        }],
    }


def _generators(**kw):
    """The JAX BatchedGenerator and the port's on the toy model, the port's
    carrying the JAX stacked graph's leaves (its step statistics too)."""
    graph_j = gj.build_graph_from_dict(synj.make_graph_dict())
    graph_j.skeleton, _ = skj.load_bvh(synj.TEST_BVH)
    graph_t = gt.build_graph_from_dict(synj.make_graph_dict())
    graph_t.skeleton, _ = skt.load_bvh(synj.TEST_BVH)
    bg_j = batch_j.BatchedGenerator(graph_j, **kw)
    bg_t = batch_t.BatchedGenerator(graph_t, device="cpu", **kw)
    bg_t.stacked = gt.from_jax_numpy(tp.to_numpy(bg_j.stacked))
    return bg_j, bg_t


def test_serving_boundary_rows_matches_jax(monkeypatch):
    """BatchedGenerator(full_constraints=False) serves through the
    boundary-row walk as the JAX package's does: n_samples is not rounded
    up to the selection kernel's tile, and on the JAX batch's own draws
    (PRNGKey(seed) split over the requests) every request's frames agree:
    equal lengths, values to 1e-3 (the boundary-row walk's bound above)."""
    kw = dict(n_steps=4, n_samples=24, max_step_frames=MAX_FRAMES,
              full_constraints=False)
    bg_j, bg_t = _generators(**kw)
    assert bg_t.n_samples == 24 and not bg_t.full_constraints
    reqs = [_traj_request(20, 100), _traj_request(-20, 100),
            _traj_request(0, 120)]
    outs_j = bg_j.generate_batch(reqs, seed=11)
    st_j = bg_j.stacked
    draws = tp.port_draws(tp.jax_walk_draws(
        jax.random.PRNGKey(11), len(reqs), kw["n_steps"], kw["n_samples"],
        st_j.gmm_weights.shape[-1], st_j.gmm_means.shape[-1], st_j.n_nodes))
    seen = {}

    def sampler(gen, g, n_chars, n_samples):
        seen.update(n_chars=n_chars, n_samples=n_samples)
        return draws

    monkeypatch.setattr(batch_t.walk_mod, "torch_sampler", sampler)
    outs_t = bg_t.generate_batch(reqs, seed=11)
    assert seen == dict(n_chars=3, n_samples=24)
    assert len(outs_t) == len(outs_j) == 3
    for f_t, f_j in zip(outs_t, outs_j):
        assert f_t.shape == np.asarray(f_j).shape and f_t.shape[0] > 30
        np.testing.assert_allclose(f_t, np.asarray(f_j), atol=1e-3)


def test_serving_goes_through_parallel(monkeypatch):
    """`generate_batch` reaches the crowd walk through
    `parallel.constrained_crowd_sharded` on the generator's one device (no
    process group unless it was given one), with
    the selection kernels asked for exactly when the constraint sets carry
    the locomotion family only (JAX's `use_pallas` on one device), and
    returns what the crowd walk returns on the same draws."""
    _, bg = _generators(n_steps=2, n_samples=16, max_step_frames=MAX_FRAMES,
                        lm_iters=1)
    assert bg.n_samples == 128 and bg.full_constraints
    reqs = [_traj_request(20, 100), _traj_request(-20, 100)]
    seen = {}
    real = batch_t.parallel.constrained_crowd_sharded

    def spy(devices, skel, g, paths, start_ids, n_steps, draws,
            step_scs=None, cfg=None, group=None):
        seen.update(devices=list(devices), cfg=cfg, n_steps=n_steps,
                    scs=step_scs, group=group)
        out = real(devices, skel, g, paths, start_ids, n_steps, draws,
                   step_scs=step_scs, cfg=cfg)
        seen["out"] = out
        return out

    monkeypatch.setattr(batch_t.parallel, "constrained_crowd_sharded", spy)
    outs = bg.generate_batch(reqs, seed=3)
    assert seen["devices"] == [torch.device("cpu")] and seen["n_steps"] == 2
    assert seen["group"] is None  # a generator without a process group
    assert seen["cfg"] == bg.walk_config() and seen["cfg"].pallas_selection
    assert seen["scs"] is not None
    segs, n_frames = (a.numpy() for a in seen["out"][:2])
    for c, frames in enumerate(outs):
        np.testing.assert_array_equal(
            frames, wt.flatten_segments(segs[c], n_frames[c]))
