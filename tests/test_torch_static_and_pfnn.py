"""Parity of the port's primitive loading and sampling, static primitives,
PFNN runtime and retargeting with the JAX package on the same seeded
inputs.

Tolerances: loaded primitive tensors exactly (both cast the same float64
numpy to float32); back-projected frames to rtol 1e-4 + atol 1e-3 (fp32
sums of ~30 products of values up to ~100); static-primitive fits to
rtol 1e-4 of the coefficients' scale, and the clip back within the JAX
tests' 0.1 / 0.05; PFNN outputs to atol 1e-5 (three fp32 layers of width
8, outputs of order 1; the port blends the control points' layer outputs,
JAX the control points' weights); retargeted frames to atol 1e-5 and
their FK positions to 1e-3 cm, the JAX test's bound."""

import dataclasses
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.models import pfnn as pfj  # noqa: E402
from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.models import retarget as rtj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.models import static_primitive as stj  # noqa: E402
from morphablegraphs_tpu.models.zip_writer import \
    write_graph_zip as write_zip_j  # noqa: E402
from morphablegraphs_tpu.synthesis import state_planner as spj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.models import pfnn as pft  # noqa: E402
from morphablegraphs_tpu_torch.models import primitive as prt  # noqa: E402
from morphablegraphs_tpu_torch.models import retarget as rtt  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.models import static_primitive as stt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import state_planner as spt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

PRIM_FIELDS = ("eigen_s", "mean_s", "knots_s", "mean_t_d", "eigen_t_d")
STATIC_FIELDS = ("name", "n_basis", "n_dim", "n_canonical_frames",
                 "n_spatial", "n_time", "has_time", "animated_joints",
                 "keyframes")


def _assert_prims_equal(p_t, p_j):
    for f in PRIM_FIELDS:
        np.testing.assert_array_equal(getattr(p_t, f).numpy(),
                                      np.asarray(getattr(p_j, f)))
    for f in ("weights", "means", "cov_chol", "prec_chol"):
        np.testing.assert_array_equal(getattr(p_t.gmm, f).numpy(),
                                      np.asarray(getattr(p_j.gmm, f)))
    for f in STATIC_FIELDS:
        assert getattr(p_t, f) == getattr(p_j, f), f


@pytest.mark.parametrize("schema", ["legacy", "v3"])
def test_load_primitive_and_sample_frames_match_jax(schema, tmp_path):
    data = synj.make_legacy_model_json(seed=3, n_joints=4)
    if schema == "v3":
        data = synj.to_v3_json(data)
    path = str(tmp_path / "walk_leftStance_mm.json")
    with open(path, "w") as f:
        json.dump(data, f)
    p_j, p_t = prj.load_primitive(path), prt.load_primitive(path,
                                                              device="cpu")
    _assert_prims_equal(p_t, p_j)
    for use_time in (True, False):
        f_t, n_t, tf_t = prt.sample_frames(torch.Generator().manual_seed(5),
                                           p_t, 96, use_time=use_time)
        s = prt.sample_latent(torch.Generator().manual_seed(5), p_t, 1)[0]
        f_j, n_j, tf_j = prj.back_project(p_j, jnp.asarray(s.numpy()), 96,
                                          use_time=use_time)
        assert int(n_t) == int(n_j)
        np.testing.assert_allclose(tf_t.numpy(), np.asarray(tf_j),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-4,
                                   atol=1e-3)


def _clip(t, d, seed):
    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 2 * np.pi, t)[:, None]
    frames = np.sin(ts + rng.uniform(0, np.pi, d)[None, :]).astype(np.float32)
    frames[:, 2] = np.linspace(0, 20, t)
    return frames


@pytest.mark.parametrize("t,d,n_basis,bound", [(40, 19, 16, 0.1),
                                               (10, 7, 16, 0.05)])
def test_static_primitive_matches_jax(t, d, n_basis, bound):
    """make_static_model_json's fit and the loaded static primitive (the
    JAX json into both loaders) agree; a draw reproduces the clip."""
    frames = _clip(t, d, seed=t)
    data_j = stj.make_static_model_json(frames, n_basis=n_basis, name="idle")
    data_t = stt.make_static_model_json(frames, n_basis=n_basis, name="idle")
    assert {k: v for k, v in data_t.items() if k != "spatial_coeffs"} == \
        {k: v for k, v in data_j.items() if k != "spatial_coeffs"}
    c_j = np.asarray(data_j["spatial_coeffs"])
    np.testing.assert_allclose(np.asarray(data_t["spatial_coeffs"]), c_j,
                               rtol=1e-4, atol=1e-4 * np.abs(c_j).max())
    p_j = prj.load_primitive_json(data_j)
    p_t = prt.load_primitive_json(data_j)  # dispatches to the static loader
    _assert_prims_equal(p_t, p_j)
    f_t, n_t, _ = prt.sample_frames(torch.Generator().manual_seed(0), p_t,
                                    max_frames=64)
    f_j, n_j, _ = prj.sample_frames(jax.random.PRNGKey(0), p_j,
                                    max_frames=64)
    assert int(n_t) == int(n_j) == t
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-4)
    assert np.abs(f_t.numpy()[:t] - frames).max() < bound
    with pytest.raises(ValueError):
        stt.make_static_model_json(np.ones((2, 7), np.float32))


def _pfnn_arrays(p, h, x_dim, y_dim, seed):
    rng = np.random.default_rng(seed)
    weights = {"W0": rng.standard_normal(p * h * x_dim) * 0.1,
               "W1": rng.standard_normal(p * h * h) * 0.1,
               "W2": rng.standard_normal(p * y_dim * h) * 0.1,
               "b0": rng.standard_normal(p * h) * 0.1,
               "b1": rng.standard_normal(p * h) * 0.1,
               "b2": rng.standard_normal(p * y_dim) * 0.1}
    means = {"Xmean": rng.standard_normal(x_dim) * 0.1,
             "Xstd": rng.uniform(0.5, 2.0, x_dim),
             "Ymean": rng.standard_normal(y_dim) * 0.1,
             "Ystd": rng.uniform(0.5, 2.0, y_dim)}
    return ({k: v.astype(np.float32) for k, v in weights.items()},
            {k: v.astype(np.float32) for k, v in means.items()})


@pytest.mark.parametrize("n_controls", [4, 3])
def test_pfnn_forward_matches_jax(n_controls):
    h, x_dim, y_dim = 8, 6, 5
    w, m = _pfnn_arrays(n_controls, h, x_dim, y_dim, seed=n_controls)
    m_j = pfj.load_from_arrays(w, m, n_controls=n_controls, hidden=h)
    m_t = pft.load_from_arrays(w, m, n_controls=n_controls, hidden=h)
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((9, x_dim)).astype(np.float32)
    phases = np.array([0.0, 0.1, 0.25, 0.5, 0.6, 0.74, 0.75, 0.999, 0.001],
                      np.float32)
    y_t = pft.forward_crowd(m_t, torch.as_tensor(xs),
                            torch.as_tensor(phases)).numpy()
    y_j = np.asarray(pfj.forward_crowd(m_j, jnp.asarray(xs),
                                       jnp.asarray(phases)))
    np.testing.assert_allclose(y_t, y_j, atol=1e-5)
    for x, ph in zip(xs[:3], phases[:3]):
        np.testing.assert_allclose(
            pft.forward(m_t, torch.as_tensor(x), float(ph)).numpy(),
            np.asarray(pfj.forward(m_j, jnp.asarray(x), jnp.asarray(ph))),
            atol=1e-5)
    # the phase matters, and the weights wrap continuously at 1
    assert not np.allclose(y_t[1], pft.forward(
        m_t, torch.as_tensor(xs[1]), 0.6).numpy())
    ya = pft.forward(m_t, torch.as_tensor(xs[0]), 0.9999).numpy()
    yb = pft.forward(m_t, torch.as_tensor(xs[0]), 0.0).numpy()
    assert np.abs(ya - yb).max() < 1e-2


def test_pfnn_zip_sections(tmp_path):
    """read_pfnn_arrays / read_pfnn_from_zip on a zip the JAX package
    wrote: the arrays exactly, the model's layers; None without a
    section; a partial section raises."""
    skel, _ = skj.load_bvh(synj.TEST_BVH)
    w, m = _pfnn_arrays(4, 8, 6, 5, seed=0)
    gd = synj.make_graph_dict()
    actions = {"walk": {"nodes": {mp: n["mm"] for mp, n in
                                  gd["subgraphs"]["walk"]["nodes"].items()}}}
    path = write_zip_j(str(tmp_path / "p"), skel, actions, gd["transitions"],
                       pfnn_data={"weights": w, "means": m})
    with zipfile.ZipFile(path) as zf:
        arr_t, arr_j = pft.read_pfnn_arrays(zf), pfj.read_pfnn_arrays(zf)
    for part in ("weights", "means"):
        for k, v in arr_j[part].items():
            np.testing.assert_array_equal(arr_t[part][k], v)
    model = pft.read_pfnn_from_zip(path, n_controls=4, hidden=8,
                                   device="cpu")
    np.testing.assert_array_equal(model.w1.numpy(),
                                  w["W1"].reshape(4, 8, 8))
    if not torch.cuda.is_available():  # the card by default, else raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pft.read_pfnn_from_zip(path, n_controls=4, hidden=8)
    bare = write_zip_j(str(tmp_path / "bare"), skel, actions,
                       gd["transitions"])
    assert pft.read_pfnn_from_zip(bare) is None
    with zipfile.ZipFile(bare, "a") as zf:
        zf.writestr("pfnn/weights/W0.bin", b"\x00\x00\x80\x3f")
    with pytest.raises(ValueError, match="incomplete pfnn"):
        pft.read_pfnn_from_zip(bare)


def _encode(wrapper, target_dir):
    wrapper.target = target_dir
    return np.concatenate([wrapper.position * 0.01, target_dir,
                           [np.sin(2 * np.pi * wrapper.phase), 1.0, 0.0]])


def _decoder(d):
    def decode(y, wrapper):
        pos = wrapper.position + 2.0 * wrapper.target + 0.05 * np.tanh(
            np.array([y[0], 0.0, y[2]]))
        frame = np.zeros(d, np.float32)
        frame[:3] = pos
        q = np.array([1.0, 0.1 * y[3], 0.1 * y[4], 0.0])
        frame[3:] = np.tile(q / np.linalg.norm(q), (d - 3) // 4)
        return frame, pos, 0.05 + 0.01 / (1.0 + np.exp(-y[1]))
    return decode


def test_pfnn_wrapper_drives_the_planner():
    """The port's PFNNWrapper around a seeded network drives the port's
    MGStatePlanner's PFNN locomotion as the JAX wrapper drives the JAX
    planner: the same states, frames within 1e-4."""
    g_j, g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)
    d = g_t.skeleton.n_frame_params
    w, m = _pfnn_arrays(4, 8, 9, 5, seed=2)
    settings = dict(min_pfnn_target_distance=5.0,
                    min_pfnn_primitive_steps=10, max_pfnn_frames=200)
    queues = []
    for p in (spj.MGStatePlanner(g_j, spj.MGStatePlanningSettings(
                  **settings), pfnn_wrapper=pfj.PFNNWrapper(
                  pfj.load_from_arrays(w, m, hidden=8), _encode,
                  _decoder(d))),
              spt.MGStatePlanner(g_t, spt.MGStatePlanningSettings(
                  **settings), device="cpu", pfnn_wrapper=pft.PFNNWrapper(
                  pft.load_from_arrays(w, m, hidden=8), _encode,
                  _decoder(d)))):
        p.use_pfnn = True
        p.generate_locomotion("walk", np.array([[0.0, 0, 30],
                                                [10.0, 0, 60]]))
        queues.append(list(p.state_queue._queue))
    assert len(queues[1]) == len(queues[0]) >= 2
    for e_j, e_t in zip(*queues):
        assert e_t.node_key == e_j.node_key
        assert e_t.state.frames.shape == e_j.state.frames.shape
        np.testing.assert_allclose(e_t.state.frames, e_j.state.frames,
                                   atol=1e-4)


def _stepping_motion(skel, n=8):
    """tests/test_aux_components.py's stepping motion: alternate leg
    swings of up to 20 degrees, the root moving forward."""
    frames = np.zeros((n, skel.n_frame_params), np.float32)
    frames[:, 1] = -5.0
    frames[:, 3::4] = 1.0
    li = skel.animated_index_of("LeftUpLeg")
    ri = skel.animated_index_of("RightUpLeg")
    for i in range(n):
        swing = li if (i // 15) % 2 == 0 else ri
        ang = np.deg2rad(20 * np.sin(np.pi * (i % 15) / 15) + 5 * i)
        frames[i, 3 + 4 * swing: 7 + 4 * swing] = [
            np.cos(ang / 2), np.sin(ang / 2), 0, 0]
        frames[i, 2] = i * 0.8
    return frames


def test_retarget_matches_jax(tmp_path):
    """Identity map, a renamed rig with doubled offsets, a partial map:
    the port's frames equal JAX's; positions reproduce the source's."""
    skel_j, _ = skj.load_bvh(synj.WALK_BVH)
    skel_t, _ = skt.load_bvh(synj.WALK_BVH)
    frames = _stepping_motion(skel_t)
    renamed_t = dataclasses.replace(
        skel_t, node_names=tuple(n + "_t" for n in skel_t.node_names),
        animated_joints=tuple(n + "_t" for n in skel_t.animated_joints),
        offsets=np.asarray(skel_t.offsets) * 2.0)
    renamed_j = dataclasses.replace(
        skel_j, node_names=renamed_t.node_names,
        animated_joints=renamed_t.animated_joints,
        offsets=renamed_t.offsets)
    jm = {n: n + "_t" for n in skel_t.animated_joints}
    cases = ((skel_t, skel_j, None, 1.0),
             (renamed_t, renamed_j, jm, 2.0),
             (renamed_t, renamed_j, {"Hips": "Hips_t", "Spine": "Spine_t"},
              1.0))
    p_src = skt.fk_positions(skel_t, torch.as_tensor(frames)).numpy()
    for dst_t, dst_j, m, scale in cases:
        out_t = rtt.retarget_frames(skel_t, frames, dst_t, m, scale,
                                    device="cpu")
        out_j = rtj.retarget_frames(skel_j, frames, dst_j, m, scale)
        np.testing.assert_allclose(out_t, out_j, atol=1e-5)
        if m is None or len(m) > 2:
            p_dst = skt.fk_positions(dst_t, torch.as_tensor(out_t)).numpy()
            assert np.abs(p_src * scale - p_dst).max() < 1e-3
    path = str(tmp_path / "ref.bvh")
    with open(path, "w") as f:
        f.write(synj.REF_BVH)
    s_t = rtt.load_target_skeleton(path, 2.0)
    np.testing.assert_array_equal(s_t.offsets,
                                  rtj.load_target_skeleton(path, 2.0).offsets)
    assert rtt.GAME_ENGINE_TO_ROCKETBOX_MAP == rtj.GAME_ENGINE_TO_ROCKETBOX_MAP
