"""The PFNN configuration's model inputs: the network's weights and its
input and output normalisation, drawn from the run's seed at the
configuration's widths, and the 31-joint skeleton they drive.  Frozen,
numpy only; the program loads the arrays as a graph zip's pfnn/ section
and the plain reference reads the same arrays.

The weights are Holden's initialisation, uniform in +-sqrt(6 / (fan_in +
fan_out)), one set per phase control point; the biases are uniform in
+-bias_half_width.  Xmean / Ymean describe a character walking straight
ahead at `step_cm` a frame in the rest pose (phase 1/60 a frame), and the
standard deviations are the configuration's `scales`: the fed-back outputs'
Ystd over their inputs' Xstd is at most 0.25, so the closed loop of random
weights stays bounded.  The layout is the controller's (the docstring of
`morphablegraphs_tpu_torch.models.pfnn`, and `reference/pfnn.py`)."""

from __future__ import annotations

import numpy as np

from .generate import stream_seed

# name, parent, offset (cm): the demo's CMU joints (offsets assumed)
JOINTS = (
    ("Hips", -1, (0.0, 0.0, 0.0)),
    ("LHipJoint", 0, (0.0, 0.0, 0.0)),
    ("LeftUpLeg", 1, (9.0, -8.0, 1.5)),
    ("LeftLeg", 2, (0.0, -42.0, 0.0)),
    ("LeftFoot", 3, (0.0, -40.0, -2.0)),
    ("LeftToeBase", 4, (0.0, -4.0, 13.0)),
    ("RHipJoint", 0, (0.0, 0.0, 0.0)),
    ("RightUpLeg", 6, (-9.0, -8.0, 1.5)),
    ("RightLeg", 7, (0.0, -42.0, 0.0)),
    ("RightFoot", 8, (0.0, -40.0, -2.0)),
    ("RightToeBase", 9, (0.0, -4.0, 13.0)),
    ("LowerBack", 0, (0.0, 2.0, -1.0)),
    ("Spine", 11, (0.0, 11.0, 0.0)),
    ("Spine1", 12, (0.0, 11.0, 0.5)),
    ("Neck", 13, (0.0, 12.0, 0.0)),
    ("Neck1", 14, (0.0, 5.0, 0.5)),
    ("Head", 15, (0.0, 6.0, 1.0)),
    ("LeftShoulder", 13, (2.0, 9.0, 0.0)),
    ("LeftArm", 17, (15.0, 0.0, 0.0)),
    ("LeftForeArm", 18, (28.0, 0.0, 0.0)),
    ("LeftHand", 19, (25.0, 0.0, 0.0)),
    ("LeftFingerBase", 20, (3.0, 0.0, 0.0)),
    ("LeftHandIndex1", 21, (4.0, 0.0, 0.0)),
    ("LThumb", 20, (2.0, 0.0, 2.5)),
    ("RightShoulder", 13, (-2.0, 9.0, 0.0)),
    ("RightArm", 24, (-15.0, 0.0, 0.0)),
    ("RightForeArm", 25, (-28.0, 0.0, 0.0)),
    ("RightHand", 26, (-25.0, 0.0, 0.0)),
    ("RightFingerBase", 27, (-3.0, 0.0, 0.0)),
    ("RightHandIndex1", 28, (-4.0, 0.0, 0.0)),
    ("RThumb", 27, (-2.0, 0.0, 2.5)),
)
# a five-joint chain for the small CPU tests (X 186, Y 77)
SMALL_JOINTS = (
    ("Hips", -1, (0.0, 0.0, 0.0)),
    ("LeftUpLeg", 0, (9.0, -8.0, 0.0)),
    ("LeftFoot", 1, (0.0, -82.0, 0.0)),
    ("Spine", 0, (0.0, 20.0, 0.0)),
    ("Head", 3, (0.0, 40.0, 2.0)),
)
TRAJECTORY, SAMPLES, GAITS = 120, 12, 6


def joints(config: dict) -> tuple:
    n = config["n_joints"]
    table = {len(JOINTS): JOINTS, len(SMALL_JOINTS): SMALL_JOINTS}
    if n not in table:
        raise ValueError(f"no skeleton of {n} joints; have {sorted(table)}")
    return table[n]


def rest(config: dict) -> np.ndarray:
    """[J, 3] rest positions relative to the root on the ground (the lowest
    joint at height 0)."""
    table = joints(config)
    pos = np.zeros((len(table), 3))
    for i, (_, p, off) in enumerate(table):
        pos[i] = np.asarray(off) + (pos[p] if p >= 0 else 0.0)
    pos[:, 1] -= pos[:, 1].min()
    return pos


def _normalisation(config: dict):
    j, sc = config["n_joints"], config["scales"]
    xs, ys, step = sc["x_std"], sc["y_std"], sc["step_cm"]
    r = rest(config).reshape(-1)
    ahead = (np.arange(SAMPLES) * 10 - 60) * step
    x_mean = np.concatenate([
        np.zeros(SAMPLES), ahead, np.zeros(SAMPLES), np.ones(SAMPLES),
        np.zeros(GAITS * SAMPLES), r, np.zeros(3 * j), np.zeros(3 * SAMPLES)])
    x_std = np.concatenate([
        np.full(SAMPLES, xs["traj_x_cm"]), np.full(SAMPLES, xs["traj_z_cm"]),
        np.full(2 * SAMPLES, xs["traj_dir"]),
        np.full(GAITS * SAMPLES, xs["gait"]),
        np.full(3 * j, xs["joint_pos_cm"]), np.full(3 * j, xs["joint_vel_cm"]),
        np.full(3 * SAMPLES, xs["height_cm"])])
    future = (np.arange(6) + 1) * 10 * step
    y_mean = np.concatenate([
        [0.0, step, 0.0, 1.0 / 60.0], np.full(4, 0.5), np.zeros(6), future,
        np.zeros(6), np.ones(6), r, np.zeros(3 * j), np.zeros(3 * j)])
    y_std = np.concatenate([
        np.full(2, ys["root_vel_cm"]), [ys["root_turn_rad"], ys["phase"]],
        np.full(4, ys["contact"]), np.full(12, ys["future_pos_cm"]),
        np.full(12, ys["future_dir"]), np.full(3 * j, ys["joint_pos_cm"]),
        np.full(3 * j, ys["joint_vel_cm"]), np.full(3 * j, ys["joint_rot"])])
    assert x_mean.size == x_std.size == config["x_dim"]
    assert y_mean.size == y_std.size == config["y_dim"]
    f = np.float32
    return dict(Xmean=x_mean.astype(f), Xstd=x_std.astype(f),
                Ymean=y_mean.astype(f), Ystd=y_std.astype(f))


def arrays(config: dict, seed: int) -> dict:
    """{"weights": W0..W2 [P, out, in], b0..b2 [P, out]; "means": Xmean,
    Xstd, Ymean, Ystd}, float32, the pfnn/ section's arrays (flattened
    there)."""
    rng = np.random.default_rng(stream_seed(seed, 3))
    p, x, h, y = (config["n_controls"], config["x_dim"], config["hidden"],
                  config["y_dim"])
    half = config["scales"]["bias_half_width"]
    weights = {}
    for k, (o, i) in enumerate(((h, x), (h, h), (y, h))):
        bound = np.sqrt(6.0 / (i + o))
        weights[f"W{k}"] = rng.uniform(-bound, bound, (p, o, i)).astype(
            np.float32)
        weights[f"b{k}"] = rng.uniform(-half, half, (p, o)).astype(
            np.float32)
    return {"weights": weights, "means": _normalisation(config)}
