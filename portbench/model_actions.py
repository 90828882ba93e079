"""The action configuration's model inputs: `model.py`'s walk graph plus the
reference's pick -> carry -> place actions (a frozen numpy copy of
`utils/synthetic.make_multi_action_graph_dict`'s layout), at a
configuration's widths and seeded by the run's seed.

Each action is one primitive that is both its action's start and end state
(`reach` for pickRight and placeRight, `locomotion` for carryRight), drawn
by `model.legacy_model_json` with the walk's widths and near-unit
quaternions.  The reach primitives carry their contact label
(`start_contact`, `end_contact`) at the middle canonical frame.  Walk's end
state leads to every action; pickRight leads to carryRight, carryRight to
placeRight.

The skeleton follows the configuration's joint count: `model.REF_BVH` at
19 joints, a four-joint arm (Hips, Spine, RightArm, RightHand) for the
small CPU tests."""

from __future__ import annotations

from . import model

ARM_TREE = (
    "Hips", (0.0, 90.0, 0.0), [
        ("Spine", (0.0, 20.0, 0.0), [
            ("RightArm", (-18.0, 15.0, 0.0), [
                ("RightHand", (0.0, -45.0, 0.0), []),
            ]),
        ]),
    ])

TREES = {19: model._REF_TREE, 4: ARM_TREE}


def tree(config: dict):
    """The (name, offset, children) tree of the configuration's skeleton."""
    n = config["n_joints"]
    if n not in TREES:
        raise ValueError(f"no skeleton of {n} joints; have {sorted(TREES)}")
    return TREES[n]


def bvh(config: dict) -> str:
    return model._bvh_from_tree(tree(config))


def graph_dict(config: dict, seed: int) -> dict:
    """The walk graph of `model.graph_dict` and the configuration's
    `actions` (each {action, primitive, label, frames_offset}): action i is
    drawn from seed + 100 + i with n_canonical_frames + frames_offset
    canonical frames."""
    gd = model.graph_dict(config, seed)
    for i, spec in enumerate(config["actions"]):
        action, mp = spec["action"], spec["primitive"]
        mm = model.legacy_model_json(
            seed=(seed + 100 + i) % 2 ** 63,
            n_canonical_frames=(config["n_canonical_frames"]
                                + spec["frames_offset"]),
            n_basis=config["n_basis_spatial"], n_joints=config["n_joints"],
            k_s=config["k_s"], k_t=config["k_t"],
            n_components=config["n_components"],
            n_basis_time=config["n_basis_time"])
        model.near_unit_quaternions(mm, config["quat_eigen_scale"])
        mm["name"] = f"{action}_{mp}"
        if spec["label"]:
            mm["keyframes"][spec["label"]] = mm["n_canonical_frames"] // 2
        gd["subgraphs"][action] = {
            "name": action,
            "info": {"start_states": [mp], "end_states": [mp]},
            "nodes": {mp: {"name": f"{action}_{mp}", "mm": mm,
                           "stats": {"average_step_length":
                                     model.mean_step_length(mm),
                                     "n_standard_transitions": 0}}}}
        gd["transitions"].setdefault("walk_endRightStance", []).append(
            f"{action}_{mp}")
    names = [f"{s['action']}_{s['primitive']}" for s in config["actions"]]
    for a, b in zip(names, names[1:]):
        gd["transitions"][a] = [b]
    return gd
