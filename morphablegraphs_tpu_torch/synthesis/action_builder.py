"""Action + per-step constraint assembly (port of
morphablegraphs_tpu.synthesis.action_builder).

Host side: turns parsed input specs into arc-length-parameterized
trajectory splines (PathSplines of CPU tensors) and per-step constraint
sets with numpy leaves, through the port's `compiled.set_*` builders.
With defer_locomotion the goal and direction slots are filled later on the
set's device (`compiled.fill_locomotion_slots`) from a host-side LocoSpec of
numpy scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..constraints import compiled
from ..constraints.input_reader import KeyframeConstraintSpec, MGInput
from ..models.graph import MotionStateGraph
from ..models.skeleton import Skeleton
from ..ops import spline_path

ALIGNING_ROOT_JOINT = "Hips"  # anim_utils skeleton.aligning_root_node default


@dataclasses.dataclass
class ActionConstraintSet:
    """Per-action constraints (reference ActionConstraints record,
    action_constraints.py:26-68)."""

    action_name: str
    root_trajectory: Optional[spline_path.PathSpline] = None
    root_unconstrained_dims: tuple = ()
    # mp_name -> list of specs (ordered per reference keyframe reader)
    keyframe_constraints: Dict[str, List[KeyframeConstraintSpec]] = dataclasses.field(default_factory=dict)
    annotations: dict = dataclasses.field(default_factory=dict)
    start_pose_position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    start_pose_orientation_y: float = 0.0
    cycled_next: bool = False
    contains_two_hands_constraints: bool = False  # Left+Right tool on one label
    contains_user_constraints: bool = False
    ca_trajectories: list = dataclasses.field(default_factory=list)  # non-root joints
    # host-cached trajectory scalars (avoid a device pull per planner query)
    _full_arc: Optional[float] = None
    _last_cp: Optional[np.ndarray] = None

    @property
    def full_arc_length(self) -> float:
        if self._full_arc is None and self.root_trajectory is not None:
            object.__setattr__(self, "_full_arc", float(
                self.root_trajectory.full_arc_length))
        return self._full_arc if self._full_arc is not None else 0.0

    @property
    def last_control_point(self) -> np.ndarray:
        if self._last_cp is None and self.root_trajectory is not None:
            tr = self.root_trajectory
            object.__setattr__(self, "_last_cp", np.asarray(
                tr.points[int(tr.n_points)]))
        return self._last_cp

    def check_end_condition(self, prev_root_pos, travelled_arc_length,
                            arc_length_offset, full_arc_length,
                            last_control_point) -> bool:
        """reference action_constraints.py:53-68: end when close to the end
        point or nearly the whole path travelled."""
        distance_to_end = float(np.linalg.norm(last_control_point - prev_root_pos))
        keep_going = (distance_to_end > arc_length_offset / 2 and
                      travelled_arc_length < full_arc_length - arc_length_offset)
        return not keep_going


def _point_and_dir(path: spline_path.PathSpline, arc: float):
    """(position [3], 2D direction [2]) at one arc length, as float32
    numpy arrays."""
    pos, d = spline_path.point_and_dir_at_arc_length(
        path, torch.tensor(arc, dtype=torch.float32))
    return pos.numpy(), d.numpy()


def _aligning_joint(skeleton: Skeleton) -> str:
    if ALIGNING_ROOT_JOINT in skeleton.node_names:
        return ALIGNING_ROOT_JOINT
    return skeleton.animated_joints[0]


def build_action_constraints(graph: MotionStateGraph, mg_input: MGInput,
                             config: dict) -> List[ActionConstraintSet]:
    """reference ActionConstraintsBuilder.build_list_from_input_file:75."""
    skeleton = graph.skeleton
    root_joint = _aligning_joint(skeleton)
    # arc-table resolution from the trajectory-following settings (reference
    # action_constraints_builder.py:67 -> parameterized_spline.py:54-66;
    # spline_super_sampling_factor is superseded: it densified a discrete
    # tangent extraction the analytic Catmull-Rom tangent does not need)
    granularity = int(config.get("trajectory_following_settings", {})
                      .get("arc_length_granularity", spline_path.GRANULARITY))
    out = []
    names = [a.name for a in mg_input.actions]
    unknown = sorted({n for n in names if n not in graph.node_groups})
    if unknown:
        # validate at the input boundary: a bare KeyError from deep inside
        # the step loop names the action but not the fix
        from ..utils.exceptions import ConstraintError
        raise ConstraintError(
            f"unknown elementary action(s) {unknown}; this graph defines "
            f"{sorted(graph.node_groups)}", bad_constraints=unknown)
    for idx, spec in enumerate(mg_input.actions):
        acs = ActionConstraintSet(action_name=spec.name)
        acs.annotations = dict(spec.annotations)
        # cycles require the group to HAVE cycle states (reference
        # _detect_action_cycles, action_constraints_builder.py:89-100) —
        # mere name repetition (walk -> walk, each with its own trajectory)
        # must NOT truncate the first action to one step
        group = graph.node_groups.get(spec.name)
        has_cycle_states = bool(group and group.cycle_states)
        acs.cycled_next = (has_cycle_states and idx + 1 < len(names)
                           and names[idx + 1] == spec.name)
        acs.start_pose_position = np.asarray(mg_input.start_pose_position, np.float32)

        # root trajectory: the entry for the aligning root joint (reference
        # action_constraints_builder.py:275-321); other joints' trajectories
        # become CA/annotated constraints
        for traj in spec.trajectories:
            if (traj.joint in (root_joint, "Hips") and not traj.annotated
                    and acs.root_trajectory is None):
                # a CA-ANNOTATED root trajectory is an avoidance region,
                # not the walking path (matches serve/batch._root_trajectory
                # and the reference's CA-vs-root split); a second root
                # trajectory never overwrites the first
                acs.root_trajectory = spline_path.build(
                    traj.control_points,
                    max_points=spline_path.MAX_PATH_POINTS,
                    unconstrained_dims=traj.unconstrained_dims,
                    granularity=granularity)
                acs.root_unconstrained_dims = traj.unconstrained_dims
            else:
                acs.ca_trajectories.append(traj)

        # start orientation: explicit or estimated from trajectory tangent
        # (reference action_constraints_builder.py estimates from tangent)
        if mg_input.start_pose_orientation is not None:
            acs.start_pose_orientation_y = float(mg_input.start_pose_orientation[1])
        elif acs.root_trajectory is not None:
            _, d = _point_and_dir(acs.root_trajectory, 0.0)
            acs.start_pose_orientation_y = float(np.degrees(np.arctan2(d[0], d[1])))

        # keyframe constraints ordered by motion primitive via label maps
        # (reference keyframe_constraint_reader.py:89-127)
        group = graph.node_groups.get(spec.name)
        if group is not None:
            for kc in spec.keyframe_constraints:
                mp_names = group.label_to_motion_primitive_map.get(kc.keyframe_label, [])
                for mp_name in mp_names:
                    acs.keyframe_constraints.setdefault(mp_name, []).append(kc)
                acs.contains_user_constraints = True
        # two-hand detection (reference _merge_two_hand_constraints,
        # action_constraints_builder.py:159-220: Left+Right tool joints on
        # the same label form a TwoHandConstraintSet; in the compiled form
        # both occupy keyframe slots whose errors sum — the same total)
        by_label = {}
        for kc in spec.keyframe_constraints:
            by_label.setdefault(kc.keyframe_label, set()).add(kc.joint)
        hand_joints = ("LeftHand", "LeftToolEndSite", "RightHand",
                       "RightToolEndSite")
        for joints in by_label.values():
            sides = {"Left" if j.startswith("Left") else "Right"
                     for j in joints if j.startswith(hand_joints)}
            if {"Left", "Right"} <= sides:  # BOTH hands on one label
                acs.contains_two_hands_constraints = True
        out.append(acs)
    return out


def build_step_constraints(graph: MotionStateGraph, acs: ActionConstraintSet,
                           node_key, travelled_arc_length: float,
                           prev_frames: Optional[np.ndarray],
                           is_last_step: bool,
                           config: dict,
                           defer_locomotion: bool = False):
    """Per-step constraint assembly (reference
    motion_primitive_constraints_builder.py:98-220 +
    locomotion_constraints_builder.py:54-120).

    With defer_locomotion the goal/direction slots are only RESERVED here
    and filled on device inside the selection kernel (no host round-trip
    per step); returns (sc, LocoSpec-or-None, (use_pos, use_dir, use_half)).
    """
    skeleton = graph.skeleton
    node = graph.nodes[node_key]
    prim = node.primitive
    n_canonical = prim.n_canonical_frames
    tf = config["trajectory_following_settings"]

    sc = compiled.empty_step_constraints(skeleton, n_canonical)
    slot = 0
    loco = None
    loco_flags = (False, False, False)

    # ---- locomotion constraints from the root trajectory
    if acs.root_trajectory is not None:
        if not is_last_step:
            step_length = node.average_step_length * tf["heuristic_step_length_factor"]
            goal_arc_length = travelled_arc_length + step_length
        else:
            goal_arc_length = acs.full_arc_length
        use_pos = tf["position_constraint_factor"] > 0.0
        use_dir = tf["dir_constraint_factor"] > 0.0
        use_half = bool(tf.get("generate_half_step_constraint", False))
        root_joint = _aligning_joint(skeleton)
        end_kf = _label_keyframe(graph, node_key, "end", n_canonical)
        mid_kf = _label_keyframe(graph, node_key, "middle", n_canonical)
        dim_mask = np.ones(3, np.float32)
        for d_ in acs.root_unconstrained_dims:
            dim_mask[d_] = 0.0
        # foot-plant mode: stance/swing-foot goals on the path REPLACE the
        # root goal constraint (reference locomotion_constraints_builder.py
        # :65-68 + foot_step_constraints_builder.py:50-88); the direction
        # constraint is still added
        foot_specs = []
        if use_pos and tf.get("generate_foot_plant_constraints", False):
            foot_specs = _foot_plant_specs(skeleton, node_key[1],
                                           travelled_arc_length,
                                           goal_arc_length, end_kf)
            use_pos = not foot_specs
        if defer_locomotion:
            loco = compiled.LocoSpec(
                goal_arc=np.float32(goal_arc_length),
                half_arc=np.float32(0.5 * travelled_arc_length
                                    + 0.5 * goal_arc_length),
                node=np.int32(skeleton.index_of(root_joint)),
                end_kf=np.float32(end_kf), mid_kf=np.float32(mid_kf),
                dim_mask=dim_mask,
                pos_weight=np.float32(tf["position_constraint_factor"]),
                dir_weight=np.float32(tf["dir_constraint_factor"]))
            loco_flags = (use_pos, use_dir, use_half)
            slot += int(use_pos) + int(use_half)  # reserve the slots
            # foot-plant slots fill on the host (opt-in mode; the device
            # fill keeps writing goal/half at its fixed slots 0/1)
            sc, slot = _fill_foot_plant_slots(
                sc, slot, skeleton, acs, foot_specs, dim_mask,
                tf["position_constraint_factor"])
        else:
            goal, goal_dir = _point_and_dir(acs.root_trajectory,
                                            goal_arc_length)
            goal = np.asarray(goal, np.float64)
            for d in acs.root_unconstrained_dims:
                goal[d] = np.nan
            if use_pos:
                sc = compiled.set_keyframe_constraint(
                    sc, slot, skeleton, root_joint, end_kf, position=goal,
                    weight=tf["position_constraint_factor"], generated=True)
                slot += 1
            if use_dir:
                d = np.asarray(goal_dir, np.float32)
                sc = compiled.set_direction_constraint(
                    sc, d, end_kf, weight=tf["dir_constraint_factor"])
            if use_half:
                half_arc = 0.5 * travelled_arc_length + 0.5 * goal_arc_length
                half_goal, _ = _point_and_dir(acs.root_trajectory, half_arc)
                half_goal = np.asarray(half_goal, np.float64)
                for d_ in acs.root_unconstrained_dims:
                    half_goal[d_] = np.nan
                sc = compiled.set_keyframe_constraint(
                    sc, slot, skeleton, root_joint, mid_kf,
                    position=half_goal,
                    weight=tf["position_constraint_factor"], generated=True)
                slot += 1
            sc, slot = _fill_foot_plant_slots(
                sc, slot, skeleton, acs, foot_specs, dim_mask,
                tf["position_constraint_factor"])
        # transition pose constraint
        if (tf.get("use_transition_constraint", False)
                and tf["transition_pose_constraint_factor"] > 0.0
                and prev_frames is not None and len(prev_frames) > 0):
            sc = compiled.set_pose_constraint(
                sc, skeleton, prev_frames[-1],
                weight=tf["transition_pose_constraint_factor"])
        # trajectory-following residuals over the whole step
        sc = compiled.set_trajectory_constraint(
            sc, skeleton, acs.root_trajectory, _aligning_joint(skeleton),
            min_arc_length=travelled_arc_length, weight=1.0)

    # ---- user keyframe constraints for this primitive
    mp_name = node_key[1]
    for kc in acs.keyframe_constraints.get(mp_name, []):
        if slot >= compiled.MAX_KF:
            break
        kf = _label_keyframe(graph, node_key, kc.keyframe_label, n_canonical)
        if kf is None:
            continue
        if getattr(kc, "look_at", False):
            # directionConstraints: position is the LOOK-AT target for the
            # head joint (reference keyframe_constraint_reader.py:185-188 +
            # LookAtConstraint joint_name='Head', look_at_constraint.py:43)
            head = "Head" if "Head" in skeleton.node_names else kc.joint
            if head in skeleton.node_names and not np.any(np.isnan(kc.position)):
                sc = compiled.set_look_at_constraint(
                    sc, skeleton, head, kc.position, kf)
            continue
        if kc.joint not in skeleton.node_names:
            # unknown joint (e.g. a ToolEndSite mapping on a skeleton
            # without tool joints): SKIP rather than silently constraining
            # the root to an end-effector target (postprocess
            # apply_ik_constraints skips likewise)
            continue
        joint = kc.joint
        quat_wxyz = None
        if not np.any(np.isnan(kc.orientation)):
            from ..models.skeleton import _np_from_euler
            quat_wxyz = _np_from_euler(kc.orientation, "rxyz")
        # user constraints get their own unit weight (reference keyframe
        # constraints default weight 1.0) — tying them to the locomotion
        # position factor would disable them under factor-0 presets
        sc = compiled.set_keyframe_constraint(
            sc, slot, skeleton, joint, kf,
            position=kc.position, quat_wxyz=quat_wxyz, weight=1.0)
        slot += 1
        # pose constraint on last step with user constraints (reference
        # motion_primitive_constraints_builder.py:157-160)
        if (is_last_step and tf["transition_pose_constraint_factor"] > 0.0
                and prev_frames is not None and len(prev_frames) > 0
                and float(np.asarray(sc.pose_active)) == 0.0):
            sc = compiled.set_pose_constraint(
                sc, skeleton, prev_frames[-1],
                weight=tf["transition_pose_constraint_factor"])

    # ---- collision-avoidance constraints from non-root trajectories
    # (reference _add_trajectory_constraints + GlobalTransformCAConstraint:
    # keep the joint's minimum distance to the CA target small)
    ca_slot = 0
    for traj in acs.ca_trajectories:
        if traj.joint in skeleton.node_names and ca_slot < compiled.MAX_CA:
            target = traj.control_points[-1].astype(np.float64).copy()
            for d_ in traj.unconstrained_dims:
                target[d_] = np.nan
            sc = compiled.set_ca_constraint(sc, skeleton, traj.joint, target,
                                            slot=ca_slot)
            ca_slot += 1

    # ---- feet constraint for pickBoth/placeBoth reach (reference
    # motion_primitive_constraints_builder.py:178-190 _add_feet_constraint:
    # keep both feet where the previous frame left them, weight 2.0)
    if (acs.action_name in ("pickBoth", "placeBoth") and mp_name == "reach"
            and prev_frames is not None and len(prev_frames) > 0):
        from ..models.skeleton import fk_positions
        pos = fk_positions(skeleton, torch.as_tensor(
            np.asarray(prev_frames[-1], np.float32))).numpy()
        end_kf2 = _label_keyframe(graph, node_key, "end", n_canonical)
        for foot in ("LeftFoot", "RightFoot"):
            if foot in skeleton.node_names and slot < compiled.MAX_KF:
                sc = compiled.set_keyframe_constraint(
                    sc, slot, skeleton, foot, end_kf2,
                    position=pos[skeleton.index_of(foot)], weight=2.0)
                slot += 1

    # ---- alignment state
    if prev_frames is not None and len(prev_frames) > 0:
        sc = compiled.set_alignment_from_prev(sc, prev_frames[-1])
    else:
        sc = compiled.set_alignment_from_start_pose(
            sc, acs.start_pose_position, acs.start_pose_orientation_y)
    if defer_locomotion:
        return sc, loco, loco_flags
    return sc


# Lateral heel offsets in the path frame (reference
# foot_step_constraints_builder.py:29-31 FOOT_OFFSETS, cm units)
FOOT_OFFSET_X = 20.0


def _foot_plant_specs(skeleton, mp_name: str, start_arc: float,
                      goal_arc: float, end_kf: float):
    """(joint, arc, keyframe, side) tuples for the foot-plant mode
    (reference foot_step_constraints_builder.py:50-74
    generate_step_constraints: initial stance foot at the start arc on
    canonical frame 0, swing foot at the goal arc on the end keyframe;
    'both' plants both feet).  Empty when the primitive has no step model
    or the skeleton has no feet (caller falls back to the root goal)."""
    from .grounding import LEFT_FOOT, RIGHT_FOOT, MP_CONFIGURATIONS
    cfg = MP_CONFIGURATIONS.get(mp_name)
    joints = {"left": LEFT_FOOT, "right": RIGHT_FOOT}
    if cfg is None or any(j not in skeleton.node_names
                          for j in joints.values()):
        return []
    specs = []
    init, final = cfg["stance_foot"], cfg["swing_foot"]
    for side in (("left", "right") if init == "both" else (init,)):
        specs.append((joints[side], start_arc, 0.0, side))
    for side in (("left", "right") if final == "both" else (final,)):
        specs.append((joints[side], goal_arc, end_kf, side))
    return specs


def _fill_foot_plant_slots(sc, slot: int, skeleton, acs, foot_specs,
                           dim_mask, weight: float):
    """Fill keyframe slots with path-frame foot targets: point on the path
    plus the lateral heel offset rotated into the tangent frame (reference
    foot_step_constraints_builder.py:75-88 _create_foot_constraint;
    REF_VECTOR [0,0,-1] -> lateral = [-dz, 0, dx]).  Unconstrained path
    dims stay masked (the reference constrains them to 0 through the
    spline's zero-fill — masking is the aligned behavior for e.g. height).
    """
    if not foot_specs:
        return sc, slot
    queries = [_point_and_dir(acs.root_trajectory, a)
               for _, a, _, _ in foot_specs]
    pos = [q[0] for q in queries]
    dirs = [q[1] for q in queries]
    for i, (joint, _, kf, side) in enumerate(foot_specs):
        if slot >= compiled.MAX_KF:
            break
        dx, dz = float(dirs[i][0]), float(dirs[i][1])
        lateral = np.array([-dz, 0.0, dx], np.float64)
        nrm = np.linalg.norm(lateral)
        if nrm > 1e-8:
            lateral /= nrm
        sign = 1.0 if side == "right" else -1.0
        target = np.asarray(pos[i], np.float64) + sign * FOOT_OFFSET_X * lateral
        target = np.where(dim_mask > 0, target, np.nan)
        sc = compiled.set_keyframe_constraint(sc, slot, skeleton, joint, kf,
                                              position=target, weight=weight,
                                              generated=True)
        slot += 1
    return sc, slot


def build_option_eval_constraints(graph: MotionStateGraph,
                                  acs: ActionConstraintSet, node_key,
                                  travelled_arc_length: float,
                                  prev_frames: Optional[np.ndarray],
                                  config: dict, add_orientation: bool):
    """Planner option-evaluation constraints (reference
    graph_walk_planner.py:156-188 _generate_node_evaluation_constraints).

    Distinct from step constraints: the goal sits at
    travelled + look_ahead_distance on the root trajectory (NOT at the
    node's heuristic step length), weights are fixed at 1.0, and the
    orientation (trajectory tangent at the goal arc) is added only when the
    caller's constrain_start_orientation / constrain_transition_orientation
    flag is set (reference :56-64, :93, :121).  generate_half_step_constraint
    adds a middle-keyframe goal at half the look-ahead (:178-180)."""
    skeleton = graph.skeleton
    n_canonical = graph.nodes[node_key].primitive.n_canonical_frames
    tf = config["trajectory_following_settings"]
    look_ahead = float(tf.get("look_ahead_distance", 100.0))
    sc = compiled.empty_step_constraints(skeleton, n_canonical)
    root_joint = _aligning_joint(skeleton)
    end_kf = _label_keyframe(graph, node_key, "end", n_canonical)
    goal_arc = travelled_arc_length + look_ahead
    goal, goal_dir = _point_and_dir(acs.root_trajectory, goal_arc)
    goal = np.asarray(goal, np.float64)
    for d in acs.root_unconstrained_dims:
        goal[d] = np.nan
    sc = compiled.set_keyframe_constraint(sc, 0, skeleton, root_joint,
                                          end_kf, position=goal, weight=1.0)
    slot = 1
    if add_orientation:
        sc = compiled.set_direction_constraint(
            sc, np.asarray(goal_dir, np.float32), end_kf, weight=1.0)
    if tf.get("generate_half_step_constraint", False):
        mid_kf = _label_keyframe(graph, node_key, "middle", n_canonical)
        half_goal, _ = _point_and_dir(
            acs.root_trajectory, travelled_arc_length + 0.5 * look_ahead)
        half_goal = np.asarray(half_goal, np.float64)
        for d in acs.root_unconstrained_dims:
            half_goal[d] = np.nan
        sc = compiled.set_keyframe_constraint(
            sc, slot, skeleton, root_joint, mid_kf, position=half_goal,
            weight=1.0)
    if prev_frames is not None and len(prev_frames) > 0:
        sc = compiled.set_alignment_from_prev(sc, prev_frames[-1])
    else:
        sc = compiled.set_alignment_from_start_pose(
            sc, acs.start_pose_position, acs.start_pose_orientation_y)
    return sc


def _label_keyframe(graph: MotionStateGraph, node_key, label: str,
                    n_canonical: int):
    """Label -> canonical keyframe via group annotations, model keyframes or
    the start/middle/end defaults (reference action_meta_info.py:134-155)."""
    group = graph.node_groups[node_key[0]]
    kf = group.map_label_to_keyframe(node_key[1], label, n_canonical)
    if kf is None:
        prim_kf = graph.nodes[node_key].primitive.keyframe_for_label(label)
        if prim_kf is not None:
            kf = prim_kf
    if kf is None:
        if label == "start":
            kf = 0
        elif label == "middle":
            kf = n_canonical // 2
        elif label in ("end", "lastFrame"):
            kf = n_canonical - 1
    return kf
