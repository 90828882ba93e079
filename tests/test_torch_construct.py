"""Parity of the port's offline construction (construct/dtw, fpca,
constructor, scaled_fpca, preprocessing, motion_analysis,
feature_point_model) with the JAX package's, on the CPU.

Tolerances: the point-cloud distance and its grids to 1e-5 (float32 in
both); DTW paths and warping functions exactly on well-separated clouds
(the DP runs in host float64 numpy in both; a near-equal cell could move
`find_path`, so the clips are far from ties); windows exactly; the fPCA
fields to 1e-4 relative (the B-spline fits in float32, the SVD in host
float64 in both, so the eigenvectors keep JAX's signs); the constructor's
JSON in schema versions 1-3 on the same clips with the same K and its
spatial, temporal and knot arrays to 1e-4 relative, the GMM (float64 EM
in the port, float32 in JAX) by K and its means and weights to 1e-3;
`sfpca_objective` and 20 Adam steps to 1e-4 relative; preprocessing bit
vectors, keyframes and sections exactly, speeds to 1e-4; the motion
analysis' curves to 1e-4 (degrees to 1e-3); the feature-point models'
scores to 1e-3 relative."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.construct import constructor as cj  # noqa: E402
from morphablegraphs_tpu.construct import dtw as dj  # noqa: E402
from morphablegraphs_tpu.construct import feature_point_model as fpj  # noqa: E402
from morphablegraphs_tpu.construct import fpca as fj  # noqa: E402
from morphablegraphs_tpu.construct import motion_analysis as maj  # noqa: E402
from morphablegraphs_tpu.construct import preprocessing as ppj  # noqa: E402
from morphablegraphs_tpu.construct import scaled_fpca as sfj  # noqa: E402
from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.ops import bspline as bsj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.construct import constructor as ct  # noqa: E402
from morphablegraphs_tpu_torch.construct import dtw as dt  # noqa: E402
from morphablegraphs_tpu_torch.construct import \
    feature_point_model as fpt  # noqa: E402
from morphablegraphs_tpu_torch.construct import fpca as ft  # noqa: E402
from morphablegraphs_tpu_torch.construct import gmm_trainer as gtt  # noqa: E402
from morphablegraphs_tpu_torch.construct import motion_analysis as mat  # noqa: E402
from morphablegraphs_tpu_torch.construct import preprocessing as ppt  # noqa: E402
from morphablegraphs_tpu_torch.construct import scaled_fpca as sft  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.models import transition_model as tmt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

CPU = "cpu"


@pytest.fixture(scope="module")
def skels():
    return skj.load_bvh(synj.TEST_BVH)[0], skt.load_bvh(synj.TEST_BVH)[0]


@pytest.fixture(scope="module")
def clips():
    """Twelve clips sampled from a known toy model (JAX's draws, as
    tests/test_construct.py makes them), unit joint quaternions."""
    src = prj.load_primitive_json(synj.make_legacy_model_json(seed=9,
                                                              n_joints=4))
    key = jax.random.PRNGKey(0)
    motions = {}
    for i in range(12):
        key, sub = jax.random.split(key)
        s = prj.sample_latent(sub, src, 1)[0]
        frames, n, _ = prj.back_project(src, s, 96, use_time=True)
        f = np.asarray(frames)[: int(n)].astype(np.float64)
        q = f[:, 3:].reshape(len(f), -1, 4)
        f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
            len(f), -1)
        motions[f"clip{i}"] = f.astype(np.float32)
    return motions


def test_gmm_trainer_runs_on_the_card_by_default(monkeypatch):
    """fit_gmm, train and fit_transition_model on numpy rows with no
    device run on the CUDA device, so without one they raise; a tensor
    keeps its own device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).standard_normal((40, 3))
    for call in (lambda: gtt.fit_gmm(x, 2), lambda: gtt.train(x, max_k=2),
                 lambda: tmt.fit_transition_model(x[:, :2], x[:, 2:],
                                                  n_components=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    w, _, _, ll = gtt.fit_gmm(torch.as_tensor(x), 2)
    assert np.isfinite(ll) and w.shape == (2,)


# ---------------------------------------------------------------------------
# DTW
# ---------------------------------------------------------------------------

def test_pair_distance_and_grids_match_jax():
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((7, 6, 3)) * 5).astype(np.float32)
    b = (rng.standard_normal((9, 6, 3)) * 5).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    np.testing.assert_allclose(
        dt.pair_distance(at[:, None], bt[None]).numpy(),
        np.asarray(dj.pair_distance(jnp.asarray(a)[:, None],
                                    jnp.asarray(b)[None])),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        dt.pair_distance(at[0], bt[0], torch.as_tensor(w)).numpy(),
        np.asarray(dj.pair_distance(jnp.asarray(a[0]), jnp.asarray(b[0]),
                                    jnp.asarray(w))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        dt.distance_grid(at, bt).numpy(),
        np.asarray(dj.distance_grid(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    # rotation about Y and an XZ offset are factored out
    theta = 1.1
    rot = np.array([[np.cos(theta), 0, np.sin(theta)], [0, 1, 0],
                    [-np.sin(theta), 0, np.cos(theta)]])
    b2 = a[0] @ rot.T + np.array([7.0, 0.0, -3.0])
    assert float(dt.pair_distance(at[0], torch.as_tensor(
        b2, dtype=torch.float32))) < 1e-3


def _separated_clouds(seed, lengths):
    rng = np.random.default_rng(seed)
    clouds = {}
    for i, t in enumerate(lengths):
        base = rng.standard_normal((1, 4, 3)) * 5
        walkline = np.linspace(0, 10, t)[:, None, None]
        clouds[f"m{i}"] = base + walkline + 0.2 * rng.standard_normal(
            (t, 4, 3))
    return clouds


@pytest.mark.parametrize("mean_key", [None, "m1"])
def test_find_optimal_dtw_paths_match_jax(mean_key):
    clouds = _separated_clouds(11, [14, 19, 25])
    got = dt.find_optimal_dtw(clouds, mean_key, device=CPU)
    assert got == dj.find_optimal_dtw(clouds, mean_key)
    for k in clouds:
        assert dt.get_warping_function(got[k]) == \
            dj.get_warping_function(got[k])
    stats = {}
    dt.find_optimal_dtw(clouds, mean_key, device=CPU, stats=stats)
    assert set(stats) == {"dtw_grids", "dtw_dp", "dtw_cost"}
    ref = mean_key or min(clouds, key=lambda r: sum(
        dj.run_dtw(clouds[r], clouds[k])[1][-1, -1] for k in clouds))
    np.testing.assert_allclose(stats["dtw_cost"], sum(
        dj.run_dtw(clouds[ref], clouds[k])[1][-1, -1] for k in clouds),
        rtol=1e-6)


@pytest.mark.parametrize("window", ["none", "sakoechiba", "slantedband",
                                    "itakura"])
def test_windows_match_jax(window):
    for n, m, band in ((40, 40, 3), (20, 40, 2), (30, 17, None)):
        np.testing.assert_array_equal(dt.window_mask(n, m, window, band),
                                      dj.window_mask(n, m, window, band))
    rng = np.random.default_rng(0)
    base = rng.standard_normal((30, 4, 3)).astype(np.float32)
    slow = np.repeat(base, 2, axis=0)[:40]
    path_t, d_t = dt.run_dtw(base, slow, window=window, device=CPU)
    path_j, d_j = dj.run_dtw(base, slow, window=window)
    assert path_t == path_j
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        dt.window_mask(5, 5, "bogus")


# ---------------------------------------------------------------------------
# fPCA
# ---------------------------------------------------------------------------

def test_fpca_fields_match_jax():
    rng = np.random.default_rng(6)
    n_samples, t, d, n_basis = 12, 40, 11, 8
    knots = bsj.clamped_knots(n_basis, t)
    true_mean = rng.standard_normal((n_basis, d)) * 2
    true_mean[:, 3:] += 8.0
    modes = rng.standard_normal((3, n_basis, d))
    motions = np.stack([np.asarray(bsj.evaluate(
        jnp.asarray(true_mean + np.tensordot(rng.standard_normal(3), modes,
                                             axes=1), jnp.float32),
        jnp.asarray(knots, jnp.float32), jnp.arange(t, dtype=jnp.float32)))
        for _ in range(n_samples)])
    motions[3, :, 7:11] *= -1.0  # one hemisphere flip at frame 0
    np.testing.assert_allclose(
        ft.fit_functional_data(motions, n_basis, CPU),
        fj.fit_functional_data(motions, n_basis), rtol=1e-4, atol=1e-4)
    a = ft.fpca_spatial(motions, n_basis, fraction=0.999, device=CPU)
    b = fj.fpca_spatial(motions, n_basis, fraction=0.999)
    assert a.eigenvectors.shape == b.eigenvectors.shape
    for f in ("eigenvectors", "mean", "parameters"):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_allclose(x, y, rtol=1e-4,
                                   atol=1e-4 * np.abs(y).max())
    assert (a.n_basis, a.n_dim, a.scale_vec) == (b.n_basis, b.n_dim,
                                                 b.scale_vec)
    warps = [np.cumsum(np.exp(rng.standard_normal(n) * 0.2)) - 1.0
             for n in (50, 50, 44, 50, 57, 50, 50, 50, 50, 50)]
    a = ft.fpca_temporal(warps, n_basis=8, n_components=3, device=CPU)
    b = fj.fpca_temporal(warps, n_basis=8, n_components=3)
    for f in ("eigenvectors", "mean", "parameters"):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_allclose(x, y, rtol=1e-4,
                                   atol=1e-4 * np.abs(y).max())
    for w in ([0.0, 0.0, 0.0, 0.005], [0.0, 0.5, 0.2, -1.0],
              [0, 1, 1, 1, 2, 5, 5, 6]):
        np.testing.assert_array_equal(ft.monotonic_indices(np.array(w)),
                                      fj.monotonic_indices(np.array(w)))
    pca_t = ft.run_pca(motions[:, 0], 0.9)
    pca_j = fj.run_pca(motions[:, 0], 0.9)
    np.testing.assert_array_equal(pca_t.eigenvectors, pca_j.eigenvectors)


# ---------------------------------------------------------------------------
# The constructor
# ---------------------------------------------------------------------------

def _gmm_fields(model: dict, version: int):
    if version == 3:
        g = model["gmm"]
        return g["weights"], g["means"]
    return model["gmm_weights"], model["gmm_means"]


@pytest.mark.parametrize("version", [1, 2, 3])
def test_constructor_json_matches_jax(skels, clips, version):
    # 3 spatial and 2 temporal components over 12 clips: each mixture
    # component keeps a covariance of full rank, so JAX's float32 EM and
    # the port's float64 EM take the same path
    cfg = {"max_gmm_components": 2, "npc_temporal": 2, "n_components": 3}
    m_t = ct.MotionModelConstructor(skels[1], cfg, device=CPU)
    m_t.set_motions(clips)
    j_t = m_t.construct_model("walk", version=version)
    m_j = cj.MotionModelConstructor(skels[0], cfg)
    m_j.set_motions(clips)
    j_j = m_j.construct_model("walk", version=version)
    gmm_keys = {"gmm_weights", "gmm_means", "gmm_covars", "gmm"}
    tp.assert_model_json_close(j_t, j_j, gmm_keys)
    (w_t, mu_t), (w_j, mu_j) = _gmm_fields(j_t, version), _gmm_fields(
        j_j, version)
    assert len(w_t) == len(w_j)
    order_t, order_j = np.argsort(np.asarray(mu_t)[:, 0]), np.argsort(
        np.asarray(mu_j)[:, 0])
    np.testing.assert_allclose(np.asarray(w_t)[order_t],
                               np.asarray(w_j)[order_j], atol=1e-3)
    np.testing.assert_allclose(np.asarray(mu_t)[order_t],
                               np.asarray(mu_j)[order_j], rtol=1e-3,
                               atol=1e-3)
    assert set(m_t.timings) == {"spatial_alignment", "dtw_grids", "dtw_dp",
                                "fpca", "gmm"}
    # both packages' loaders read the port's JSON
    prj.load_primitive_json(json.loads(json.dumps(j_t)))
    from morphablegraphs_tpu_torch.models import primitive as prt
    prt.load_primitive_json(j_t)


def test_spatial_alignment_matches_jax(clips):
    a = ct.align_frames_spatially(clips, device=CPU)
    b = cj.align_frames_spatially(clips)
    for k in clips:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        ppt.normalize_motion(clips["clip1"], zero_height=False, device=CPU),
        ppj.normalize_motion(clips["clip1"], zero_height=False),
        rtol=1e-5, atol=1e-4)


def _sectioned(skels, n=3, seed=13):
    src = prj.load_primitive_json(synj.make_legacy_model_json(seed=seed,
                                                              n_joints=4))
    key = jax.random.PRNGKey(seed)
    motions, sections = {}, {}
    for i in range(n):
        parts, bounds = [], [0]
        for j in range(2):
            key, sub = jax.random.split(key)
            s = prj.sample_latent(sub, src, 1)[0]
            frames, nf, _ = prj.back_project(src, s, 96, use_time=True)
            f = np.asarray(frames)[: int(nf)][:: (1 + (i + j) % 2)]
            parts.append(f)
            bounds.append(bounds[-1] + len(f))
        motions[f"clip{i}"] = np.concatenate(parts, axis=0)
        sections[f"clip{i}"] = [
            {"start_idx": bounds[0], "end_idx": bounds[1]},
            {"start_idx": bounds[1], "end_idx": bounds[2]}]
    return motions, sections


def test_split_dtw_matches_jax(skels, tmp_path):
    motions, sections = _sectioned(skels)
    keyframes = {k: s[0]["end_idx"] for k, s in sections.items()}
    built = ct.define_sections_from_keyframes(motions, keyframes)
    assert built == cj.define_sections_from_keyframes(motions, keyframes)
    w_t, f_t, kf_t = ct.align_frames_temporally_split(skels[1], motions,
                                                      built, device=CPU)
    w_j, f_j, kf_j = cj.align_frames_temporally_split(skels[0], motions,
                                                      built)
    assert kf_t == kf_j
    for k in motions:
        np.testing.assert_array_equal(f_t[k], f_j[k])
        np.testing.assert_array_equal(w_t[k], w_j[k])
    (tmp_path / "clip0_sections.json").write_text(json.dumps(
        {"semantic_annotation": {"b": [30, 40, 12], "a": [0, 5]}}))
    a = ct.define_sections_from_annotations(str(tmp_path), motions)
    b = cj.define_sections_from_annotations(str(tmp_path), motions)
    assert a[1] == b[1] and list(a[0]) == list(b[0]) == ["clip0"]


# ---------------------------------------------------------------------------
# scaled fPCA
# ---------------------------------------------------------------------------

def test_sfpca_objective_and_adam_match_jax(skels):
    rng = np.random.default_rng(9)
    d = skels[0].n_frame_params
    knots = bsj.clamped_knots(6, 30)
    coeffs = rng.standard_normal((10, 6, d)).astype(np.float32) * 0.1
    coeffs[..., 3::4] += 1.0
    coeffs[..., :3] *= 50.0
    npc = 3
    init_t = sft.heuristic_initialization(coeffs, knots, skels[1], npc, CPU)
    init_j = sfj.heuristic_initialization(coeffs, knots, skels[0], npc)
    np.testing.assert_allclose(init_t, init_j, rtol=1e-6)
    for w in (init_j, np.linspace(0.5, 2.0, len(init_j))):
        e_t = float(sft.sfpca_objective(
            torch.as_tensor(w, dtype=torch.float32), torch.as_tensor(coeffs),
            torch.as_tensor(knots, dtype=torch.float32), skels[1], npc))
        e_j = float(sfj.sfpca_objective(
            jnp.asarray(w, jnp.float32), jnp.asarray(coeffs),
            jnp.asarray(knots, jnp.float32), skels[0], npc))
        np.testing.assert_allclose(e_t, e_j, rtol=1e-4)
    w_t, e_t = sft.optimize_weights(coeffs, knots, skels[1], npc, n_iters=20,
                                    init=init_j, device=CPU)
    w_j, e_j = sfj.optimize_weights(coeffs, knots, skels[0], npc, n_iters=20,
                                    init=init_j)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4)
    m_t = sft.ScaledFunctionalPCA(coeffs, knots, skels[1], npc, device=CPU)
    m_j = sfj.ScaledFunctionalPCA(coeffs, knots, skels[0], npc)
    m_t.initialize_weights(w_j)
    m_j.initialize_weights(w_j)
    _, r_t = m_t.fit()
    _, r_j = m_j.fit()
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4,
                               atol=1e-4 * np.abs(r_j).max())


# ---------------------------------------------------------------------------
# Preprocessing, motion analysis, feature-point models
# ---------------------------------------------------------------------------

def test_preprocessing_matches_jax(skels, clips):
    frames = np.concatenate(list(clips.values()))
    feet = ("LeftFoot", "RightFoot")
    sk_j, sk_t = skels
    for thr in (0.05, 0.2, 1.0):
        a = ppt.calc_contact_bitvector(sk_t, frames, feet, thr, device=CPU)
        b = ppj.calc_contact_bitvector(sk_j, frames, feet, thr)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert ppt.detect_walking_keyframes(sk_t, frames, feet, thr,
                                            device=CPU) == \
            ppj.detect_walking_keyframes(sk_j, frames, feet, thr)
        assert ppt.split_walk_motion(sk_t, frames, feet, thr, device=CPU) \
            == ppj.split_walk_motion(sk_j, frames, feet, thr)
    joints = [n for n in sk_t.node_names[:3]]
    a = ppt.planar_joint_speed(sk_t, frames, joints, device=CPU)
    b = ppj.planar_joint_speed(sk_j, frames, joints)
    for j in joints:
        np.testing.assert_allclose(a[j], b[j], rtol=1e-4, atol=1e-4)
    two = dict(list(clips.items())[:2])
    for action, mp in (("walk", "leftStance"), ("walk", "rightStance"),
                       ("walk", "sideStep"), ("pickRight", "first"),
                       ("placeBoth", "second"), ("screw", "x")):
        names = (sk_t.node_names[1], sk_t.node_names[2])
        assert ppt.create_semantic_annotation(action, mp, sk_t, two, names,
                                              device=CPU) == \
            ppj.create_semantic_annotation(action, mp, sk_j, two, names)
    dup = dict(clips, copy=clips["clip2"].copy())
    assert ppt.find_duplicates(dup) == ppj.find_duplicates(dup) == \
        [["clip2", "copy"]]
    assert ppt.hash_motions(clips) == ppj.hash_motions(clips)


def test_keyframes_by_pose_distance_match_jax(skels):
    sk_j, sk_t = skels
    rest = np.zeros(sk_t.n_frame_params, np.float32)
    rest[3::4] = 1.0
    frames = np.tile(rest, (80, 1))
    ang = np.full(80, 60.0)
    ang[:41] = np.abs(np.arange(41) - 20) * 3.0
    ang[41:] = 20.0 + np.abs(np.arange(41, 80) - 60) * 2.0
    half = np.deg2rad(ang) / 2
    frames[:, sk_t.quat_slice("Spine")] = np.stack(
        [np.cos(half), np.zeros(80), np.zeros(80), np.sin(half)], axis=1)
    for n in (1, 2, 3):
        got = ppt.detect_keyframes_by_pose_distance(sk_t, frames, rest, n,
                                                    device=CPU)
        assert got == ppj.detect_keyframes_by_pose_distance(sk_j, frames,
                                                            rest, n)
    assert abs(got[0] - 20) <= 2 and abs(got[1] - 60) <= 2


def test_motion_analysis_matches_jax(skels):
    """BVHAnalyzer's feature curves and accessors on the reference-scale
    skeleton (hands, feet, knees, elbows, spine), and Plane."""
    sk_j = skj.load_bvh(synj.REF_BVH)[0]
    sk_t = skt.load_bvh(synj.REF_BVH)[0]
    rng = np.random.default_rng(3)
    t = 12
    frames = np.zeros((t, sk_t.n_frame_params), np.float32)
    frames[:, :3] = np.cumsum(rng.standard_normal((t, 3)), axis=0)
    q = rng.standard_normal((t, sk_t.n_animated, 4)) * 0.3
    q[..., 0] += 1.0
    frames[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
        t, -1)
    a, b = mat.BVHAnalyzer(sk_t, frames, device=CPU), maj.BVHAnalyzer(sk_j,
                                                                      frames)
    fa, fb = a.feature_vector(), b.feature_vector()
    assert fa.keys() == fb.keys() and len(fa) > 10
    for k in fa:
        if fa[k].dtype == bool:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            np.testing.assert_allclose(fa[k], fb[k], rtol=1e-4, atol=1e-3,
                                       err_msg=k)
    for side in ("Left", "Right"):
        np.testing.assert_array_equal(a.toe_before_leg(side),
                                      b.toe_before_leg(side))
        np.testing.assert_array_equal(a.foot_behind_other_leg(side),
                                      b.foot_behind_other_leg(side))
        # the body plane's normal is an SVD's last singular vector, whose
        # sign is arbitrary in both packages: compare the distances' sizes
        np.testing.assert_allclose(
            np.abs(a.joint_distance_to_body(f"{side}Hand")),
            np.abs(b.joint_distance_to_body(f"{side}Hand")), rtol=1e-4,
            atol=1e-3)
    hand = "RightHand"
    assert a.get_joint_chain(hand) == b.get_joint_chain(hand)
    np.testing.assert_allclose(a.get_relative_joint_position(hand, 3),
                               b.get_relative_joint_position(hand, 3),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(a.joint_acceleration(hand),
                               b.joint_acceleration(hand), rtol=1e-4,
                               atol=1e-3)
    pts = rng.standard_normal((20, 3))
    pa, pb = mat.Plane.fit(pts), maj.Plane.fit(pts)
    np.testing.assert_allclose(pa.normal, pb.normal)
    assert pa.is_before(pts[0]) == pb.is_before(pts[0])


def test_feature_point_models_match_jax(skels, clips):
    sk_j, sk_t = skels
    motions = list(clips.values())
    joint = sk_t.node_names[-1]
    # one component: twelve points in 3D leave a second one singular, where
    # JAX's float32 EM and the port's float64 EM part ways
    m_t = fpt.FeaturePointModel(sk_t, joint, device=CPU).fit(motions,
                                                             max_k=1)
    m_j = fpj.FeaturePointModel(sk_j, joint).fit(motions, max_k=1)
    assert m_t.gmm.weights.shape == m_j.gmm.weights.shape
    for target in ([0.0, 10.0, 0.0], np.asarray(m_j.gmm.means[0])):
        np.testing.assert_allclose(m_t.score_target(target),
                                   m_j.score_target(target), rtol=1e-3)
    assert m_t.sample(torch.Generator().manual_seed(0), 5).shape == (5, 3)
    rng = np.random.default_rng(8)
    data = {"a": rng.standard_normal((30, 3)) + 4,
            "b": rng.standard_normal((30, 3)) - 4}
    s_t = fpt.SemanticStatisticalModel(device=CPU).fit(data, max_k=2)
    s_j = fpj.SemanticStatisticalModel().fit(data, max_k=2)
    for x in (np.full(3, 3.5), np.full(3, -4.2), np.zeros(3)):
        assert s_t.classify(x) == s_j.classify(x)
        for label in data:
            np.testing.assert_allclose(s_t.score(label, x),
                                       s_j.score(label, x), rtol=1e-3)
    assert s_t.sample(torch.Generator().manual_seed(1), "a", 4).shape == \
        (4, 3)
