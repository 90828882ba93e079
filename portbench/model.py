"""The benchmark's model inputs: a frozen numpy copy of the port's synthetic
builders (`utils/synthetic.py`: `make_legacy_model_json`, `make_graph_dict`,
the 19-joint `REF_BVH`), sized by a configuration file and seeded by the
run's seed.

The graph dict is an input: the program builds its graph from it
(`models.graph.build_graph_from_dict`) and the plain reference reads the
same dict.  Two changes from the synthetic builders, both listed under the
configuration's `assumed`:

* joint quaternions near unit length, as a trained model's are (the recipe
  of `chip_smoke._planner_graph`): the mean's quaternions normalised, the
  eigenvectors' quaternion rows scaled by `quat_eigen_scale`;
* packaged step statistics (`stats.average_step_length`): the root path
  length of each node's mean clip, so that neither side draws them."""

from __future__ import annotations

import numpy as np

DEGREE = 3

_REF_TREE = (
    "Hips", (0.0, 90.0, 0.0), [
        ("Spine", (0.0, 10.0, 0.0), [
            ("Spine1", (0.0, 12.0, 0.0), [
                ("Neck", (0.0, 12.0, 0.0), [
                    ("Head", (0.0, 8.0, 0.0), []),
                ]),
                ("LeftArm", (18.0, 8.0, 0.0), [
                    ("LeftForeArm", (0.0, -28.0, 0.0), [
                        ("LeftHand", (0.0, -25.0, 0.0), []),
                    ]),
                ]),
                ("RightArm", (-18.0, 8.0, 0.0), [
                    ("RightForeArm", (0.0, -28.0, 0.0), [
                        ("RightHand", (0.0, -25.0, 0.0), []),
                    ]),
                ]),
            ]),
        ]),
        ("LeftUpLeg", (9.0, -5.0, 0.0), [
            ("LeftLeg", (0.0, -40.0, 0.0), [
                ("LeftFoot", (0.0, -40.0, 0.0), [
                    ("LeftToeBase", (0.0, -5.0, 12.0), []),
                ]),
            ]),
        ]),
        ("RightUpLeg", (-9.0, -5.0, 0.0), [
            ("RightLeg", (0.0, -40.0, 0.0), [
                ("RightFoot", (0.0, -40.0, 0.0), [
                    ("RightToeBase", (0.0, -5.0, 12.0), []),
                ]),
            ]),
        ]),
    ])


def _bvh_from_tree(tree) -> str:
    """BVH text of a (name, offset, children) tree: 6 channels on the root,
    3 rotations on every other joint, one rest frame."""
    lines = ["HIERARCHY"]

    def walk(node, depth, is_root):
        name, off, children = node
        pad = "  " * depth
        lines.append(f"{pad}{'ROOT' if is_root else 'JOINT'} {name}")
        lines.append(pad + "{")
        lines.append(f"{pad}  OFFSET {off[0]} {off[1]} {off[2]}")
        if is_root:
            lines.append(f"{pad}  CHANNELS 6 Xposition Yposition Zposition "
                         "Xrotation Yrotation Zrotation")
        else:
            lines.append(f"{pad}  CHANNELS 3 Xrotation Yrotation Zrotation")
        for c in children:
            walk(c, depth + 1, False)
        if not children:
            lines.extend([f"{pad}  End Site", pad + "  {",
                          f"{pad}    OFFSET 0.0 5.0 0.0", pad + "  }"])
        lines.append(pad + "}")

    walk(tree, 0, True)
    n_channels = 6 + 3 * (_count_joints(tree) - 1)
    lines += ["MOTION", "Frames: 1", "Frame Time: 0.033333",
              " ".join(["0"] * n_channels)]
    return "\n".join(lines) + "\n"


def _count_joints(node) -> int:
    return 1 + sum(_count_joints(c) for c in node[2])


REF_BVH = _bvh_from_tree(_REF_TREE)
ROOT_OFFSET = _REF_TREE[1]


def clamped_knots(n_basis: int, n_frames: int) -> np.ndarray:
    """Clamped cubic knots over [0, n_frames - 1] with n_basis
    coefficients."""
    knots = np.zeros(n_basis + DEGREE + 1)
    knots[DEGREE: -DEGREE] = np.linspace(0, n_frames - 1, n_basis - 2)
    knots[-DEGREE:] = n_frames - 1
    return knots


def basis_np(knots: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Cox-de Boor cubic basis [Q, n_basis] at times t [Q] (clamped to the
    knot range, the last span closed)."""
    n_basis = len(knots) - DEGREE - 1
    tc = np.clip(np.asarray(t, np.float64), knots[0], knots[-1])[:, None]
    left, right = knots[:-1][None], knots[1:][None]
    last = right >= knots[-1]
    n = np.where(last, (tc >= left) & (tc <= right) & (left < right),
                 (tc >= left) & (tc < right)).astype(np.float64)
    for k in range(1, DEGREE + 1):
        d1 = knots[k:-1] - knots[:-k - 1]
        d2 = knots[k + 1:] - knots[1:-k]
        w1 = np.where(d1 > 0, (tc - knots[:-k - 1]) / np.where(d1 > 0, d1, 1),
                      0.0)
        w2 = np.where(d2 > 0, (knots[k + 1:] - tc) / np.where(d2 > 0, d2, 1),
                      0.0)
        n = w1 * n[:, :-1] + w2 * n[:, 1:]
    return n[:, :n_basis]


def legacy_model_json(seed: int, n_canonical_frames: int, n_basis: int,
                      n_joints: int, k_s: int, k_t: int, n_components: int,
                      n_basis_time: int) -> dict:
    """A random-but-valid legacy model JSON (the schema of the reference's
    motion_primitive.py), drawn as the synthetic builder draws it."""
    rng = np.random.default_rng(seed)
    n_dim = 3 + 4 * n_joints
    mean = np.zeros((n_basis, n_dim))
    mean[:, 2] = np.linspace(0, 30, n_basis)  # root z advance
    mean[:, 1] = 90.0  # hip height
    for j in range(n_joints):
        mean[:, 3 + 4 * j] = 1.0
        mean[:, 4 + 4 * j: 7 + 4 * j] = rng.standard_normal((n_basis, 3)) * 0.1
    eigen = rng.standard_normal((k_s, n_basis * n_dim)) * 0.3
    t_eigen = rng.standard_normal((n_basis_time, k_t)) * 0.05
    t_mean = rng.standard_normal(n_basis_time) * 0.03
    d_latent = k_s + k_t
    w = rng.random(n_components)
    w /= w.sum()
    means_g = rng.standard_normal((n_components, d_latent)) * 0.8
    covars = []
    for _ in range(n_components):
        a = rng.standard_normal((d_latent, d_latent)) * 0.2
        covars.append(a @ a.T + np.eye(d_latent) * 0.3)
    return {
        "gmm_weights": w, "gmm_means": means_g, "gmm_covars": np.stack(covars),
        "eigen_vectors_spatial": eigen,
        "mean_spatial_vector": mean.reshape(-1),
        "n_canonical_frames": n_canonical_frames,
        "translation_maxima": [1.0, 1.0, 1.0], "n_basis_spatial": n_basis,
        "n_dim_spatial": n_dim,
        "b_spline_knots_spatial": clamped_knots(n_basis, n_canonical_frames),
        "keyframes": {"start": 0, "middle": n_canonical_frames // 2,
                      "end": n_canonical_frames - 1},
        "eigen_vectors_time": t_eigen, "mean_time_vector": t_mean,
        "b_spline_knots_time": clamped_knots(n_basis_time,
                                             n_canonical_frames),
        "n_basis_time": n_basis_time,
    }


def near_unit_quaternions(mm: dict, eigen_scale: float) -> None:
    """In place: the mean's joint quaternions normalised, the eigenvectors'
    quaternion rows scaled by eigen_scale (the root translation rows keep
    their scale)."""
    n_dim = mm["n_dim_spatial"]
    eigen = mm["eigen_vectors_spatial"].reshape(
        len(mm["eigen_vectors_spatial"]), -1, n_dim).copy()
    eigen[..., 3:] *= eigen_scale
    mm["eigen_vectors_spatial"] = eigen.reshape(len(eigen), -1)
    mean = mm["mean_spatial_vector"].reshape(-1, n_dim).copy()
    q = mean[:, 3:].reshape(len(mean), -1, 4)
    mean[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
        len(mean), -1)
    mm["mean_spatial_vector"] = mean.reshape(-1)


def mean_step_length(mm: dict) -> float:
    """Root path length of the mean clip at its canonical frames."""
    n_dim, nb = mm["n_dim_spatial"], mm["n_basis_spatial"]
    coeffs = mm["mean_spatial_vector"].reshape(nb, n_dim)[:, :3]
    b = basis_np(mm["b_spline_knots_spatial"],
                 np.arange(mm["n_canonical_frames"]))
    root = b @ coeffs
    return float(np.linalg.norm(root[1:] - root[:-1], axis=-1).sum())


WALK_STATES = ("beginLeftStance", "leftStance", "rightStance",
               "endRightStance")


def graph_dict(config: dict, seed: int) -> dict:
    """The walk graph of a configuration (beginLeftStance -> the
    leftStance / rightStance cycle -> endRightStance), its weights drawn
    from `seed`; node i has n_canonical_frames + frames_step * i frames.
    Arrays stay numpy (`build_graph_from_dict` and the reference read them
    alike)."""
    prims = {}
    for i, name in enumerate(WALK_STATES):
        mm = legacy_model_json(
            seed=(seed + i) % 2 ** 63,
            n_canonical_frames=(config["n_canonical_frames"]
                                + config["frames_step"] * i),
            n_basis=config["n_basis_spatial"], n_joints=config["n_joints"],
            k_s=config["k_s"], k_t=config["k_t"],
            n_components=config["n_components"],
            n_basis_time=config["n_basis_time"])
        near_unit_quaternions(mm, config["quat_eigen_scale"])
        mm["name"] = f"walk_{name}"
        prims[name] = {"name": f"walk_{name}", "mm": mm,
                       "stats": {"average_step_length": mean_step_length(mm),
                                 "n_standard_transitions": 1}}
    return {
        "formatVersion": 2.0,
        "subgraphs": {"walk": {
            "name": "walk",
            "info": {"start_states": ["beginLeftStance"],
                     "end_states": ["endRightStance"]},
            "nodes": prims}},
        "transitions": {
            "walk_beginLeftStance": ["walk_rightStance"],
            "walk_leftStance": ["walk_rightStance", "walk_endRightStance"],
            "walk_rightStance": ["walk_leftStance", "walk_endRightStance"],
        },
        "startNode": ["walk", "beginLeftStance"],
    }
