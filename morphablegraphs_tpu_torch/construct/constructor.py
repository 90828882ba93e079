"""Motion model constructor: aligned clips -> motion-primitive model JSON
(port of morphablegraphs_tpu.construct.constructor).

Spatial alignment (heading onto [0, -1], root start at the origin) and the
FK point clouds run on the card; temporal alignment is DTW against the
motion closest to the mean length (grids on the card, the DP on the host);
then spatial and temporal fPCA, the GMM's EM with its BIC scan on the card,
and the JSON export in all three schema versions (what
`models.primitive.load_primitive_json` of either package loads).  Every
step runs on the constructor's device, CUDA unless it is given another.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.skeleton import Skeleton, fk_point_cloud
from ..ops import bspline, quat as quat_ops
from ..utils import device as device_mod
from . import dtw as dtw_mod
from . import fpca as fpca_mod
from . import gmm_trainer

DEFAULT_CONFIG = {
    # reference run_construction.py:52-61 defaults
    "n_spatial_basis_factor": 0.2,
    "n_basis_functions_temporal": 8,
    "npc_temporal": 3,
    "n_components": None,
    "fraction": 0.95,
    "max_gmm_components": 40,
}


def align_frames_spatially(motions: Dict[str, np.ndarray],
                           ref_orientation=(0.0, -1.0),
                           device=None) -> Dict[str, np.ndarray]:
    """Rotate each clip's first-frame heading onto ref ([0, -1] in (x, z):
    facing -z) and move its root start to the origin (reference
    motion_model_constructor.py:244-264), in float32 on `device`."""
    dev = device_mod.resolve(device, "align_frames_spatially")
    ref = np.asarray(ref_orientation, np.float64)
    ref = ref / np.linalg.norm(ref)
    out = {}
    for key, m in motions.items():
        m_t = torch.as_tensor(np.asarray(m, np.float32), device=dev)
        heading = quat_ops.rotate_vec(
            quat_ops.normalize(m_t[0, 3:7]),
            torch.tensor([0.0, 0.0, 1.0], device=dev)).cpu().numpy()
        cur = np.array([heading[0], heading[2]], np.float64)
        cur /= max(np.linalg.norm(cur), 1e-10)
        # the signed angle from the current heading to ref about Y
        theta = np.arctan2(cur[0], cur[1]) - np.arctan2(ref[0], ref[1])
        q_y = quat_ops.about_y(torch.tensor(-theta, dtype=torch.float32,
                                            device=dev))
        rotated = _rotate_frames(m_t, q_y).cpu().numpy()
        rotated[:, :3] -= rotated[0, :3].copy()
        out[key] = rotated
    return out


def _rotate_frames(frames: torch.Tensor, q_y: torch.Tensor) -> torch.Tensor:
    """Rotate the root translation and root quaternion of every frame
    (reference construction/utils.py:150-159 rotate_frames)."""
    root_pos = quat_ops.rotate_vec(q_y[None], frames[:, :3])
    root_q = quat_ops.multiply(q_y[None], frames[:, 3:7])
    return torch.cat([root_pos, root_q, frames[:, 7:]], dim=-1)


def _mean_length_key(motions: Dict[str, np.ndarray]):
    lengths = {k: len(m) for k, m in motions.items()}
    mean = np.mean(list(lengths.values()))
    return min(lengths, key=lambda k: abs(lengths[k] - mean))


def align_frames_temporally(skeleton: Skeleton,
                            motions: Dict[str, np.ndarray], mean_key=None,
                            device=None, stats: Optional[dict] = None):
    """DTW every motion against the reference motion (the one closest to
    the mean length, reference :266-301), its FK point clouds and grids on
    `device`; `stats` as `dtw.find_optimal_dtw`'s.  When a
    torch.distributed default group of more than one rank is initialized,
    the pair grids are split over its ranks (each rank's `device`), as the
    JAX package splits them over every visible device.  -> (warped {key:
    frames}, warping functions {key: [int]})."""
    dev = device_mod.resolve(device, "align_frames_temporally")
    point_clouds = {
        key: fk_point_cloud(skeleton, torch.as_tensor(
            np.asarray(m, np.float32), device=dev)).cpu().numpy()
        for key, m in motions.items()}
    if mean_key is None:
        mean_key = _mean_length_key(motions)
    group = (dist.group.WORLD if dist.is_available() and dist.is_initialized()
             and dist.get_world_size() > 1 else None)
    results = dtw_mod.find_optimal_dtw(point_clouds, mean_key, device=dev,
                                       stats=stats, group=group)
    warped, warps = {}, {}
    for key, m in motions.items():
        wf = dtw_mod.get_warping_function(results[key])
        warped[key] = dtw_mod.warp_motion(m, wf)
        warps[key] = wf
    return warped, warps


def define_sections_from_keyframes(motions: Dict[str, np.ndarray],
                                   keyframes: Dict[str, int]):
    """{motion name: split frame} -> per-motion two-section lists
    (reference run_construction.py:77-97: [0, keyframe) and [keyframe,
    end)).  Motions without a keyframe are left out (reference :169-174).
    -> {name: [{"start_idx", "end_idx"}, ...]}, or None when no motion has
    a keyframe."""
    sections = {}
    for key, m in motions.items():
        if key not in keyframes:
            continue
        kf = int(keyframes[key])
        sections[key] = [{"start_idx": 0, "end_idx": kf},
                         {"start_idx": kf, "end_idx": len(m)}]
    return sections or None


def define_sections_from_annotations(motion_folder: str,
                                     motions: Dict[str, np.ndarray]):
    """Per-motion `<name>_sections.json` files of
    {"semantic_annotation": {label: [frame indices...]}} -> ordered
    section lists (reference run_construction.py:106-130): each label
    gives a section [min(frames), max(frames)], ordered by start.  When at
    least one motion has a sections file, motions without one are left
    out.  -> (motions, sections dict or None)."""
    sections = {}
    filtered = {}
    for key, m in motions.items():
        path = os.path.join(motion_folder, f"{key}_sections.json")
        if not os.path.isfile(path):
            continue
        with open(path) as f:
            annotations = json.load(f)["semantic_annotation"]
        secs = []
        for label, frames in annotations.items():
            frames = sorted(frames)
            secs.append({"start_idx": int(frames[0]),
                         "end_idx": int(frames[-1])})
        secs.sort(key=lambda s: s["start_idx"])
        sections[key] = secs
        filtered[key] = m
    if sections:
        return filtered, sections
    return motions, None


def align_frames_temporally_split(skeleton: Skeleton,
                                  motions: Dict[str, np.ndarray],
                                  sections=None, mean_key=None, device=None,
                                  stats: Optional[dict] = None):
    """Per-section DTW (reference motion_model_constructor.py:304-355
    `_align_frames_temporally_split`): every motion split at its section
    boundaries, each section DTWed against the reference motion's
    matching section, the warped frames and warping functions
    concatenated.  Each section's warp is offset by its start index, so
    the combined warp stays a monotone map into the ORIGINAL clip (the
    reference concatenates section-local warps), as the temporal fPCA's
    z-transform requires.

    -> (warped {key: frames}, warping functions {key: [int]}, canonical
    keyframes {"contact<i>": frame}: the canonical section ends)."""
    if mean_key is None:
        mean_key = _mean_length_key(motions)
    if sections is None:
        warped, warps = align_frames_temporally(skeleton, motions, mean_key,
                                                device, stats)
        return warped, warps, {}

    n_sections = {len(s) for s in sections.values()}
    assert len(n_sections) == 1, f"inconsistent section counts: {n_sections}"
    n_sections = n_sections.pop()

    def bounds(key, si):
        s = sections[key][si]
        end = s["end_idx"]
        if end is None or end < 0:
            end = len(motions[key])
        return int(s["start_idx"]), int(end)

    results = []
    for si in range(n_sections):
        sub = {}
        for key in motions:
            lo, hi = bounds(key, si)
            sub[key] = motions[key][lo:hi]
        results.append(align_frames_temporally(skeleton, sub, mean_key,
                                               device, stats))

    warped, warps = {}, {}
    for key in motions:
        w_frames, w_fns = [], []
        for si, (sec_warped, sec_warps) in enumerate(results):
            lo, _ = bounds(key, si)
            w_frames.append(np.asarray(sec_warped[key]))
            w_fns.append(np.asarray(sec_warps[key]) + lo)
        warped[key] = np.concatenate(w_frames, axis=0)
        warps[key] = np.concatenate(w_fns, axis=0)

    # the canonical section ends: cumulative canonical section lengths
    # (the reference motion's warp is the identity, so these are its
    # end_idx, as the reference records them)
    keyframes = {}
    acc = 0
    for si, (sec_warped, _) in enumerate(results):
        acc += len(sec_warped[mean_key])
        keyframes[f"contact{si}"] = acc
    return warped, warps, keyframes


class MotionModelConstructor:
    """The reference's MotionModelConstructor facade (:163-215), on
    `device` (CUDA unless named).  `timings` holds the seconds of each
    stage of the last construct_model: "spatial_alignment", "dtw_grids"
    (point clouds and grids), "dtw_dp" (the host DP), "fpca" and "gmm";
    `dtw_cost` its DTW's total path cost (summed over sections)."""

    def __init__(self, skeleton: Skeleton, config: Optional[dict] = None,
                 device=None):
        self.skeleton = skeleton
        self.device = device_mod.resolve(device, "MotionModelConstructor")
        self.config = dict(DEFAULT_CONFIG)
        if config:
            self.config.update(config)
        self._input_motions: Dict[str, np.ndarray] = {}
        self._aligned_frames = None
        self._temporal_data = None
        self._spatial = None
        self._temporal = None
        self._gmm = None
        self._keyframes: dict = {}
        self._sections = None
        self.timings: dict = {}
        self.dtw_cost = 0.0

    def set_motions(self, motions):
        if isinstance(motions, dict):
            self._input_motions = {k: np.asarray(v)
                                   for k, v in motions.items()}
        else:
            self._input_motions = {i: np.asarray(m)
                                   for i, m in enumerate(motions)}

    def set_dtw_sections(self, sections):
        """Per-motion section lists for the split temporal alignment
        (reference set_dtw_sections); None: whole-clip DTW."""
        self._sections = sections

    def set_timewarping(self, temporal_data: dict):
        self._temporal_data = dict(temporal_data)

    def align(self, mean_key=None):
        """The spatial alignment, then the temporal one unless a time
        warping was set (over the ranks of a default process group of
        several, `align_frames_temporally`); construct_model's first
        stages."""
        t0 = time.perf_counter()
        aligned = align_frames_spatially(self._input_motions,
                                         device=self.device)
        self.timings["spatial_alignment"] = time.perf_counter() - t0
        if self._temporal_data is None:
            t0 = time.perf_counter()
            dtw_t = {}
            (self._aligned_frames, self._temporal_data,
             contact_kf) = align_frames_temporally_split(
                self.skeleton, aligned, self._sections, mean_key,
                self.device, dtw_t)
            self._keyframes.update(contact_kf)
            self.dtw_cost = dtw_t.get("dtw_cost", 0.0)
            # the point clouds and the warps count with the grids
            self.timings["dtw_dp"] = dtw_t.get("dtw_dp", 0.0)
            self.timings["dtw_grids"] = (time.perf_counter() - t0
                                         - self.timings["dtw_dp"])
        else:
            self._aligned_frames = aligned

    def construct_model(self, name: str, version: int = 3, mean_key=None,
                        align_frames: bool = True) -> dict:
        self.timings = {}
        if align_frames or self._aligned_frames is None:
            self.align(mean_key)
        t0 = time.perf_counter()
        self._run_dimension_reduction()
        t1 = time.perf_counter()
        self._learn_statistical_model()
        self.timings.update(fpca=t1 - t0, gmm=time.perf_counter() - t1)
        return self._to_json(name, version)

    # ------------------------------------------------------------------
    def _run_dimension_reduction(self):
        frames = np.stack([np.asarray(m)
                           for m in self._aligned_frames.values()])
        n_frames = frames.shape[1]
        n_basis = max(4, int(round(
            n_frames * self.config["n_spatial_basis_factor"])))
        self._spatial = fpca_mod.fpca_spatial(
            frames, n_basis, fraction=self.config["fraction"],
            n_components=self.config["n_components"], device=self.device)
        self._temporal = fpca_mod.fpca_temporal(
            list(self._temporal_data.values()),
            n_basis=self.config["n_basis_functions_temporal"],
            n_components=self.config["npc_temporal"], device=self.device)

    def _learn_statistical_model(self):
        params = np.concatenate([self._spatial.parameters,
                                 self._temporal.parameters], axis=1)
        self._gmm = gmm_trainer.train(
            params, max_k=self.config["max_gmm_components"],
            device=self.device)

    def _to_json(self, name: str, version: int) -> dict:
        """reference convert_motion_model_to_json (:431-523), all
        versions."""
        key = next(iter(self._aligned_frames))
        n_frames = len(self._aligned_frames[key])
        sp, tp = self._spatial, self._temporal
        spatial_knots = bspline.clamped_knots(sp.n_basis, n_frames).tolist()
        temporal_knots = bspline.clamped_knots(tp.n_basis,
                                               n_frames).tolist()
        base = dict(self._gmm)
        if version == 1:
            data = {**base, "name": name,
                    "eigen_vectors_spatial": sp.eigenvectors.tolist(),
                    "mean_spatial_vector": sp.mean.tolist(),
                    "n_canonical_frames": n_frames,
                    "translation_maxima": sp.scale_vec,
                    "n_basis_spatial": sp.n_basis,
                    "npc_spatial": len(sp.eigenvectors),
                    "eigen_vectors_temporal_semantic":
                        tp.eigenvectors.tolist(),
                    "mean_temporal_semantic_vector": tp.mean.tolist(),
                    "n_dim_spatial": sp.n_dim,
                    "n_basis_temporal_semantic": tp.n_basis,
                    "b_spline_knots_spatial": spatial_knots,
                    "b_spline_knots_temporal_semantic": temporal_knots,
                    "npc_temporal_semantic": tp.eigenvectors.shape[1],
                    "semantic_annotation": {},
                    "n_dim_temporal_semantic": 1}
        elif version == 2:
            data = {**base, "name": name,
                    "eigen_vectors_spatial": sp.eigenvectors.tolist(),
                    "mean_spatial_vector": sp.mean.tolist(),
                    "n_canonical_frames": n_frames,
                    "translation_maxima": sp.scale_vec,
                    "n_basis_spatial": sp.n_basis,
                    "eigen_vectors_time": tp.eigenvectors.tolist(),
                    "mean_time_vector": tp.mean.tolist(),
                    "n_dim_spatial": sp.n_dim,
                    "n_basis_time": tp.n_basis,
                    "b_spline_knots_spatial": spatial_knots,
                    "b_spline_knots_time": temporal_knots}
        else:
            covars = np.asarray(self._gmm["gmm_covars"])
            data = {
                "sspm": {"eigen": sp.eigenvectors.tolist(),
                         "mean": sp.mean.tolist(),
                         "n_coeffs": sp.n_basis, "n_dims": sp.n_dim,
                         "knots": spatial_knots,
                         "animated_joints": list(
                             self.skeleton.animated_joints),
                         "degree": 3},
                "tspm": {"eigen": tp.eigenvectors.tolist(),
                         "mean": tp.mean.tolist(),
                         "n_coeffs": tp.n_basis, "n_dims": 1,
                         "knots": temporal_knots, "degree": 3,
                         "semantic_labels": {},
                         "frame_time": self.skeleton.frame_time},
                "gmm": {"weights": self._gmm["gmm_weights"],
                        "means": self._gmm["gmm_means"],
                        "covars": self._gmm["gmm_covars"],
                        "eigen": gen_gaussian_eigen(covars).tolist()},
            }
        data["keyframes"] = dict(self._keyframes)
        return data


def gen_gaussian_eigen(covars: np.ndarray) -> np.ndarray:
    """Square roots of covariances by eigh, in host float64 (reference
    construction/utils.py:201-210)."""
    covars = np.asarray(covars)
    out = np.empty_like(covars)
    for i, cov in enumerate(covars):
        s, u = np.linalg.eigh(cov)
        s = np.sqrt(np.clip(s, 0, None))
        out[i] = (u * s).T
    return out
