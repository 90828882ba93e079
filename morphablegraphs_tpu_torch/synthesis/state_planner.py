"""Interactive/streaming planner: direction- and target-driven locomotion
(port of morphablegraphs_tpu.synthesis.state_planner).

Replaces the core of reference motion_generator/mg_state_planner.py:191-1189
(used by the external mg_server / Unity bridge): an action-sequence consumer
that walks the node-type FSM (idle -> start -> standard -> end -> idle),
generates constrained steps toward control points or a steering direction,
and feeds aligned states into the MGStateQueue, which an engine drains
frame by frame.  The upper-body gesture overlay (:817) splices upper-body
joint quaternions from a second primitive.

A constrained step selects its latent with
`generator.generate_constrained_sample` (the LM solves through kernel B2
and takes its naturalness term from kernel B5 on a CUDA device) and
back-projects through the frame-emit kernel (`kernels.emit_frames`, B6's
source); the look-at, joint-limit, CCD and IK edits run batched over the
step's frames on the same device.  Everything runs on the CUDA device
unless the planner is given device="cpu" (the kernels' twins).

Random draws come from a sampler hook, sampler(node_key, n) -> [n, L],
called where the JAX package calls `self._next_key()`: the unconstrained
step's single draw, the constrained step's pool, the gesture's draw.  The
default draws from a torch.Generator seeded with `seed`; host noise (walk
jitter, gesture noise) comes from np.random.default_rng(seed), as in the
JAX package.

Under constrained_sampling_mode="cluster_tree_search" a constrained
step's pool is its node's cluster-tree data; the JAX package takes a key
there and draws nothing, and the planner calls sampler(node_key, 0),
whose result it does not read.  A node without a tree samples its
mixture.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from ..constraints import compiled
from ..models import primitive as prim_mod
from ..models import skeleton_models
from ..models.graph import (MotionStateGraph, NODE_TYPE_END, NODE_TYPE_IDLE,
                            NODE_TYPE_START, NODE_TYPE_STANDARD)
from ..models.skeleton import fk_global, fk_positions
from ..ops import align, ik
from ..ops import quat as quat_ops
from ..utils import device as device_mod
from ..utils.config import default_config
from . import generator, postprocess
from .state_queue import MGStateQueue

UPPER_BODY_JOINTS = skeleton_models.UPPER_BODY_JOINTS


@dataclasses.dataclass
class MGStatePlanningSettings:
    """The reference's planner settings (mg_state_planner.py:191-235).
    Every behavior-relevant knob is implemented or explicitly dispositioned
    — see PARITY.md's per-setting table for the full 44-knob accounting."""

    blend_window: int = 20
    buffer_size: int = 100  # reference default (look_back_range reads it)
    step_target_threshold: float = 10.0  # target switching distance
    overstepping_range: float = 50.0  # reference default
    direction_constraint_weight: float = 0.8
    position_constraint_weight: float = 1.0
    n_samples: int = 30
    use_optimization: bool = False
    max_steps_per_target: int = 50
    activate_upper_body_overlay: bool = False
    collision_check_step: float = 10.0  # sampling step along the checked ray
    # constrained-sampling gates (reference :214-215, :229 and
    # generate_constrained_motion_primitive :1003-1012)
    use_constrained_sampling: bool = True
    add_transition_constraint: bool = False
    # end-target enforcement (reference :357-380): after a successful
    # locomotion run to the last control point, blend the newest state's
    # root toward the exact target/heading when it stopped short
    force_walk_end_targets: bool = False
    min_end_distance: float = 10.0
    end_target_blend_range: int = 50
    # idle states keep their own heading (reference ignore_idle_rotation)
    ignore_idle_rotation: bool = False
    # worker-thread pacing between generated steps (reference sleep_time)
    sleep_time: float = 0.0
    # direction extraction / target switching (reference :191-235 defaults)
    min_target_distance: float = 20.0
    min_dir_distance: float = 50.0
    max_step_length: float = 60.0
    max_begin_step_length: float = 30.0
    look_back_range: int = 100
    walk_noise_eps: float = 0.1
    # per-step look-at / IK edits
    look_at_window: int = 40
    orient_spine: bool = False
    n_max_ik_iter: int = 10
    # clamp joint twists to the skeleton's limit table after look-at/spine
    # edits (reference :230 activate_joint_constraints=True, applied :814)
    activate_joint_constraints: bool = True
    # gesture-parameter edits on the upper-body overlay (reference :228-229
    # enable_gesture_parameters/gesture_ik_max_iter, consumed :683-697):
    # noise/distance-to-head modulation of the wrist trajectory, reproduced
    # with a bounded CCD chain up to the shoulder
    enable_gesture_parameters: bool = False
    gesture_ik_max_iter: int = 1
    # blend frame-constrained actions back to their start position when the
    # sequence ends (reference :224 prevent_action_drift=True, applied
    # :405-408 after generate_action_from_motion_primitives)
    prevent_action_drift: bool = True
    # exact IK enforcement of streaming frame constraints after generation
    # (reference :213 activate_ik=True, applied via apply_ik_constraints
    # :1023-1060 when the step carries frame constraints)
    activate_ik: bool = True
    # PFNN locomotion (reference mg_state_planner.py:219-224)
    pfnn_blend_bias: float = 0.5  # forwarded to the controller's trajectory
    min_pfnn_target_distance: float = 8.0
    min_pfnn_primitive_steps: int = 100
    split_pfnn_primitives: bool = True
    pfnn_n_target_averaging: int = 1
    max_pfnn_frames: int = 2000  # hard bound (the reference loops unbounded)
    # cubic control-point upsampling factor before PFNN locomotion; 0 = off,
    # the reference uses 0.1 (mg_state_planner.py:874 stretch_points)
    pfnn_stretch_scale: float = 0.0


def stretch_points(points, scale: float) -> np.ndarray:
    """Cubic resampling of a control-point sequence at parameter step
    `scale` (reference mg_state_planner.py:78-90 stretch_points, built on
    anim_utils CubicMotionSpline.fit_frames): interpolating cubic spline over
    times 0..n-1 evaluated at arange(0, n-1, scale)."""
    from scipy.interpolate import CubicSpline
    points = np.asarray(points, np.float64)
    times = np.arange(len(points))
    spline = CubicSpline(times, points, axis=0)
    return spline(np.arange(0.0, float(len(points) - 1), scale))


class MGStatePlanner:
    """reference mg_state_planner.py:237-1189 core loop (functional subset).
    MGStatePlanner(graph, settings=None, config=None, seed=0, device=None,
    sampler=None, collision_boundary=None, pfnn_wrapper=None,
    hand_collision_boundary=None)."""

    def __init__(self, graph: MotionStateGraph,
                 settings: Optional[MGStatePlanningSettings] = None,
                 config: Optional[dict] = None, seed: int = 0,
                 device=None, sampler: Optional[Callable] = None,
                 collision_boundary=None, pfnn_wrapper=None,
                 hand_collision_boundary=None):
        self.graph = graph
        self.device = device_mod.resolve(device, "MGStatePlanner")
        # optional PFNN controller with reset(pos, phase, dir) and
        # get_next_frame(target_dir) -> quaternion frame; the reference takes
        # it from outside too (mg_state_planner.py:238, pfnn_wrapper param)
        self.pfnn_wrapper = pfnn_wrapper
        self.use_pfnn = False  # reference :268 default
        # optional callable (x, z) -> bool blocked (reference checks an
        # external collision-avoidance service / scene boundary,
        # mg_state_planner.py:672-704 collision_boundary.check_trajectory)
        self.collision_boundary = collision_boundary
        # optional per-joint collision boundary for CCD avoidance edits
        # (reference handle_collision :1135-1157): object with attributes
        # joint_name and check_trajectory(points, dt) ->
        # (frame_idx, position, normal); frame_idx <= 0 means no collision
        self.hand_collision_boundary = hand_collision_boundary
        self.settings = settings or MGStatePlanningSettings()
        # copy before overriding: mutating a shared config dict would
        # clobber other components' sample counts
        self.config = dict(config or default_config())
        self.config["n_random_samples"] = self.settings.n_samples
        frame_time = graph.skeleton.frame_time if graph.skeleton else 1.0 / 30
        self.state_queue = MGStateQueue(graph.skeleton, frame_time,
                                        self.settings.blend_window,
                                        self.settings.buffer_size,
                                        device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.sampler = sampler or self._gmm_sampler
        self._prims = {}  # node key -> its primitive on the device
        # host-side rng for cheap scalar noise (walk jitter): seeded with
        # the same seed so planner runs are reproducible end to end
        self._np_rng = np.random.default_rng(seed)
        self.stop_thread = False
        self._thread: Optional[threading.Thread] = None
        # joint-limit source for post-IK clamping (reference :262-266:
        # skeleton_model["joint_constraints"] else the shared default table);
        # override before use, the array table compiles lazily
        self.joint_constraints = skeleton_models.JOINT_CONSTRAINTS
        self._limit_table = None

    def _prim(self, node_key):
        if node_key not in self._prims:
            self._prims[node_key] = self.graph.nodes[node_key].primitive.to(
                self.device)
        return self._prims[node_key]

    def _gmm_sampler(self, node_key, n: int) -> torch.Tensor:
        if n == 0:  # a cluster-tree step's key: nothing is drawn
            return torch.empty((0, self._prim(node_key).n_latent),
                               device=self.device)
        return prim_mod.sample_latent(self.generator, self._prim(node_key),
                                      n)

    def _draw(self, node_key, n: int) -> torch.Tensor:
        """One sampler call, where the JAX package takes `_next_key()`."""
        return torch.as_tensor(self.sampler(node_key, n),
                               dtype=torch.float32, device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _joint_limit_table(self):
        """(axes, mins, maxs, mask) of the limit table on the device."""
        if self._limit_table is None:
            self._limit_table = tuple(
                self._tensor(a) for a in skeleton_models.build_limit_table(
                    self.graph.skeleton, self.joint_constraints))
        return self._limit_table

    # -- node type FSM (reference get_next_node_type :537-560) ----------
    def get_next_node_type(self, current_type: str, reached_target: bool) -> str:
        if current_type == NODE_TYPE_IDLE:
            return NODE_TYPE_START
        if current_type == NODE_TYPE_START:
            return NODE_TYPE_END if reached_target else NODE_TYPE_STANDARD
        if current_type == NODE_TYPE_STANDARD:
            return NODE_TYPE_END if reached_target else NODE_TYPE_STANDARD
        if current_type == NODE_TYPE_END:
            return NODE_TYPE_IDLE
        return NODE_TYPE_START

    def _pick_node(self, prev_key, node_type: str, action: str):
        if prev_key is None:
            group = self.graph.node_groups[action]
            candidates = ([s for s in group.idle_states] or
                          [s for s in group.start_states] or
                          [k[1] for k in group.node_keys])
            return (action, candidates[0])
        edges = self.graph.nodes[prev_key].edges_of_type(node_type)
        if not edges:
            for t in (NODE_TYPE_STANDARD, NODE_TYPE_END, NODE_TYPE_IDLE):
                edges = self.graph.nodes[prev_key].edges_of_type(t)
                if edges:
                    break
        return edges[0] if edges else None

    # -- step generation (reference generate_locomotion_step :772) ------
    def generate_step(self, node_key, pose_buffer, target_pos=None,
                      target_dir=None, upper_body_state=None,
                      body_orientation_targets=None, action=None,
                      keyframe_constraints=None):
        """One constrained step toward a position and/or heading, with the
        in-loop edits of reference generate_locomotion_step (:772-816):
        upper-body gesture splice, look-at/spine orientation edit, CCD
        collision avoidance.  Returns the aligned state-queue entry.

        keyframe_constraints: optional frame-constraint descs for this node
        (the streaming action path, reference generate_constrained_frames
        :500-535 via ConstraintBuilder): dicts with `joint`, `position`
        [3] (NaN = unconstrained component), optional `orientation` [4]
        wxyz, optional `weight`, and either `keyframe` (canonical index)
        or `keyframeLabel` resolved through the node group's meta info."""
        skel = self.graph.skeleton
        node = self.graph.nodes[node_key]
        prim = node.primitive
        sc = compiled.empty_step_constraints(skel, prim.n_canonical_frames)
        slot = 0
        if target_pos is not None:
            pos = np.asarray(target_pos, np.float64)
            pos_c = np.array([pos[0], np.nan, pos[2]])
            sc = compiled.set_keyframe_constraint(
                sc, slot, skel, skel.animated_joints[0],
                prim.n_canonical_frames - 1, position=pos_c,
                weight=self.settings.position_constraint_weight)
            slot += 1
        resolved_kf = []
        step_events: dict = {}
        hold_frames: set = set()
        for c in keyframe_constraints or []:
            if slot >= compiled.MAX_KF:
                break
            kf = c.get("keyframe")
            if kf is None:
                group = self.graph.node_groups.get(node_key[0])
                label = c.get("keyframeLabel", "end")
                kf = (group.map_label_to_keyframe(
                    node_key[1], label, prim.n_canonical_frames)
                    if group is not None else None)
                if kf is None:
                    kf = prim.n_canonical_frames - 1
            rel = c.get("relativeJoint", c.get("relative_joint_name"))
            if rel and rel in skel.node_names:
                # keepOffsetBetweenBones: constrain the joint at an offset
                # in the relative bone's space via the rt slot (reference
                # :339 relativeBoneName -> RelativeTransformConstraint,
                # constraint_builder.py:160)
                sc = compiled.set_relative_transform_constraint(
                    sc, skel, c["joint"], rel,
                    c.get("position") or (0.0, 0.0, 0.0), kf,
                    weight=float(c.get("weight", 1.0)))
                continue
            sc = compiled.set_keyframe_constraint(
                sc, slot, skel, c["joint"], kf,
                position=c.get("position"), quat_wxyz=c.get("orientation"),
                weight=float(c.get("weight", 1.0)))
            resolved_kf.append((c["joint"], int(kf), c.get("position"),
                                c.get("mirrorJoint"), c.get("offset")))
            # engine-facing metadata (reference generate_constrained_frames
            # :528-535): keyframe events grouped by frame, hold flags
            if c.get("keyframeEvents"):
                step_events.setdefault(int(kf), []).extend(
                    c["keyframeEvents"])
            if c.get("holdFrame"):
                hold_frames.add(int(kf))
            slot += 1
            # region constraints (reference constraint_builder.py:323-345
            # constrainPositionInRegion/endKeyframe; the reference's IK
            # builder enacts the constraint on EVERY frame of [keyframe,
            # end keyframe]): resolve the end label and compile the span
            # to sampled slots — midpoint + end — with the region-gated
            # components, so both the latent solve and the exact IK snap
            # hold the pose across the range, not just at the keyframe.
            end_label = c.get("endKeyframeLabel")
            if end_label:
                group = self.graph.node_groups.get(node_key[0])
                end_kf = (group.map_label_to_keyframe(
                    node_key[1], end_label, prim.n_canonical_frames)
                    if group is not None else None)
                if end_kf is None:
                    end_kf = prim.n_canonical_frames - 1
                end_kf = int(end_kf)
                if end_kf > int(kf):
                    pos_r = (c.get("position")
                             if c.get("constrainPositionInRegion") else None)
                    ori_r = (c.get("orientation")
                             if c.get("constrainOrientationInRegion")
                             else None)
                    span = sorted({(int(kf) + end_kf) // 2, end_kf}
                                  - {int(kf)})
                    if pos_r is None and ori_r is None:
                        span = []
                    for extra_kf in span:
                        if slot >= compiled.MAX_KF:
                            break
                        sc = compiled.set_keyframe_constraint(
                            sc, slot, skel, c["joint"], extra_kf,
                            position=pos_r, quat_wxyz=ori_r,
                            weight=float(c.get("weight", 1.0)))
                        if pos_r is not None:
                            resolved_kf.append(
                                (c["joint"], extra_kf, pos_r,
                                 c.get("mirrorJoint"), c.get("offset")))
                        slot += 1
                    if c.get("holdFrame"):
                        hold_frames.update(range(int(kf), end_kf + 1))
        if target_dir is not None:
            sc = compiled.set_direction_constraint(
                sc, np.asarray(target_dir, np.float32),
                prim.n_canonical_frames - 1,
                weight=self.settings.direction_constraint_weight)
        if pose_buffer:
            sc = compiled.set_alignment_from_prev(sc, np.asarray(pose_buffer[-1]))
            if self.settings.add_transition_constraint:
                # transition pose constraint at the step's first frame
                # (reference generate_transition_constraint,
                # constraint_builder.py:404-406 + :434-436: the previous
                # buffer pose as a PoseConstraint so the chosen candidate
                # starts where the buffer ended)
                sc = compiled.set_pose_constraint(
                    sc, skel, np.asarray(pose_buffer[-1], np.float32))
        else:
            sc = compiled.set_alignment_from_start_pose(sc, np.zeros(3), 0.0)

        prim_d = self._prim(node_key)
        unconstrained = (target_pos is None and target_dir is None
                         and not keyframe_constraints)
        if unconstrained or not self.settings.use_constrained_sampling:
            # reference :1003-1012: use_constrained_sampling=False always
            # takes a plain GMM sample
            s = self._draw(node_key, 1)[0]
        else:
            pool = generator.cluster_pool(self.config,
                                          self.graph.nodes[node_key],
                                          self.device)
            if pool is None:
                pool = self._draw(node_key, self.settings.n_samples)
            else:
                self._draw(node_key, 0)
            s, _ = generator.generate_constrained_sample(
                skel, prim_d, generator.device_constraints(sc, self.device),
                pool, generator.selection_params(skel, sc, self.config))

        frames, n, _ = prim_mod.back_project(
            prim_d, s, max_frames=_pad(prim.n_canonical_frames),
            use_time=False)
        frames = frames[: int(n)].cpu().numpy()
        if upper_body_state is not None:
            frames = self.combine_frames_with_upper_body(frames,
                                                         upper_body_state)
        if body_orientation_targets is not None:
            frames = self.apply_body_orientation_targets(
                frames, pose_buffer, body_orientation_targets)
        if resolved_kf and self.settings.activate_ik:
            # exact IK enforcement of the frame constraints on the generated
            # frames (reference generate_constrained_frames :513-519 ->
            # apply_ik_constraints :1023-1060: the latent solve gets close,
            # the IK snap hits the target)
            frames = self._snap_keyframe_constraints(frames, pose_buffer,
                                                     resolved_kf)
        if self.hand_collision_boundary is not None:
            frames = self.handle_collision(frames, action or node_key[0])
        node_type = node.node_type
        if node_type == NODE_TYPE_IDLE and self.settings.ignore_idle_rotation:
            # idle clips keep their own heading (translation-only alignment,
            # reference ignore_idle_rotation)
            return self.state_queue.generate_idle_state(
                frames, pose_buffer, node_key=node_key, ignore_rotation=True)
        return self.state_queue.add_state(node_key, node_type, frames,
                                          pose_buffer, events=step_events,
                                          hold_frames=sorted(hold_frames))

    # -- upper-body gesture overlay (reference :568-604 + :817-828) ------
    def generate_upper_body_state(self, gesture_desc):
        """Sample the gesture primitive once and wrap it in a cycling
        overlay state (reference generate_upper_body_state :680-704):
        {"frames": [T, D], "frame_idx": int}.

        gesture_desc: {"action": name, "primitive": optional name,
        "velocityFactor": playback speed (resamples the canonical spline on
        a uniform grid, reference sample.get_motion_vector(velocity_factor)
        :677), "noiseFactor"/"distanceToHeadFactor": wrist-trajectory
        modulation when `enable_gesture_parameters` is set (:683-697).
        The action key is "action" (native) or "name" (the reference's
        upperBodyGesture message format, :655)."""
        action = gesture_desc.get("action", gesture_desc.get("name"))
        if action is None:
            return None
        group = self.graph.node_groups.get(action)
        if group is None:
            return None
        mp = gesture_desc.get("primitive")
        if mp is None:
            keys = group.node_keys
            mp = keys[0][1]
        node_key = (action, mp)
        prim = self._prim(node_key)
        s = self._draw(node_key, 1)[0]
        velocity_factor = max(float(gesture_desc.get("velocityFactor", 1.0)),
                              0.0)
        if velocity_factor > 0 and velocity_factor != 1.0:
            # uniform canonical resampling: > 1 plays faster (fewer frames)
            n_out = max(int(round(prim.n_canonical_frames / velocity_factor)),
                        2)
            t = torch.linspace(0.0, prim.n_canonical_frames - 1.0, n_out,
                               device=self.device)
            frames = prim_mod.evaluate_at(prim, s, t).cpu().numpy()
        else:
            frames, n, _ = prim_mod.back_project(
                prim, s, max_frames=_pad(prim.n_canonical_frames),
                use_time=False)
            frames = frames[: int(n)].cpu().numpy()
        noise = max(float(gesture_desc.get("noiseFactor", 0.0)), 0.0)
        dist = max(float(gesture_desc.get("distanceToHeadFactor", 0.0)), 0.0)
        if (self.settings.enable_gesture_parameters
                and len(frames) > 0 and (noise > 0 or dist > 0)):
            frames = self._apply_gesture_parameters(frames, noise, dist)
        return {"frames": frames, "frame_idx": 0}

    def _apply_gesture_parameters(self, frames, noise_factor: float,
                                  distance_factor: float):
        """Gesture modulation (reference :683-697): take the right wrist's
        FK trajectory, (1) jitter each point by velocity-scaled noise
        (get_joint_trajectory :131-147: p_i + rand(3) * noise * |p_i -
        p_{i-1}|, a per-frame perturbation — no recurrence, so one batched
        FK + one vectorized update), (2) push it away from the neck along
        the wrist-neck direction by `distance_factor` (move_distance_to_head
        :178-188), then reproduce the new trajectory with a CCD chain
        bounded at the shoulder (reproduce_trajectory :149-156), one CCD
        over all frames at once."""
        skel = self.graph.skeleton
        wrist, shoulder, neck = "RightHand", "RightArm", "Neck"
        if (wrist not in skel.animated_joints
                or shoulder not in skel.animated_joints):
            return frames
        frames = np.asarray(frames, np.float32)
        frames_d = self._tensor(frames)
        pos = fk_positions(skel, frames_d).cpu().numpy()
        wrist_node = skel.index_of(wrist)
        traj = pos[:, wrist_node].astype(np.float64).copy()
        if noise_factor > 0 and len(traj) > 1:
            delta = np.diff(traj, axis=0)
            mag = np.linalg.norm(delta, axis=-1, keepdims=True)
            traj[1:] += self._np_rng.random(delta.shape) * noise_factor * mag
        if distance_factor > 0 and neck in skel.node_names:
            dirs = pos[:, wrist_node] - pos[:, skel.index_of(neck)]
            norms = np.maximum(
                np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-10)
            traj += dirs / norms * distance_factor
        chain = _ccd_chain(skel, wrist, max_len=8, stop_at=shoulder)
        if not chain:
            return frames
        return ik.run_ccd(skel, chain, wrist_node, frames_d,
                          self._tensor(traj),
                          n_iters=self.settings.gesture_ik_max_iter
                          ).cpu().numpy()

    def combine_frames_with_upper_body(self, frames, upper_body_state):
        """Splice upper-body joint quats from the cycling gesture state
        (reference combine_frames_with_other_motion_primitive :817-828:
        per output frame take the NEXT gesture frame, wrapping around)."""
        skel = self.graph.skeleton
        gesture = np.asarray(upper_body_state["frames"], np.float32)
        idx = upper_body_state["frame_idx"]
        out = np.asarray(frames, np.float32).copy()
        cols = np.concatenate([np.arange(3 + 4 * skel.animated_index_of(j),
                                         7 + 4 * skel.animated_index_of(j))
                               for j in UPPER_BODY_JOINTS
                               if j in skel.animated_joints]).astype(int)
        rows = (idx + np.arange(len(out))) % len(gesture)
        if len(cols):
            out[:, cols] = gesture[rows][:, cols]
        upper_body_state["frame_idx"] = int(
            (idx + len(out)) % len(gesture))
        return out

    def _inverse_alignment(self, pose_buffer, first_frame):
        """(q_inv [4], delta [3]) on the device: the inverse of the
        aligning transform the queue will apply to the step (frames are
        still primitive-local here), identity without a pose buffer."""
        if pose_buffer:
            q_y, delta = align.node_aligning_2d_transform(
                self._tensor(pose_buffer[-1]), self._tensor(first_frame))
            return quat_ops.conjugate(q_y), delta
        return (self._tensor([1.0, 0.0, 0.0, 0.0]),
                torch.zeros(3, device=self.device))

    def _snap_keyframe_constraints(self, frames, pose_buffer, resolved_kf):
        """IK-snap each (joint, canonical keyframe, world position) triple
        on the still-primitive-local frames (reference apply_ik_constraints
        :1023-1060; the blend reuses postprocess.apply_ik_constraints).
        World targets transform by the inverse aligning transform — a
        y-rotation + ground translation, so NaN (unconstrained) y
        components survive the transform exactly and are filled from the
        joint's current position inside the solver."""
        skel = self.graph.skeleton
        q_inv, delta = self._inverse_alignment(
            pose_buffer, np.asarray(frames[0], np.float32))
        iks = []
        for joint, kf, position, *rest in resolved_kf:
            mirror = rest[0] if len(rest) > 0 else None
            offset = rest[1] if len(rest) > 1 else None
            if position is None or joint not in skel.node_names:
                continue
            p = np.asarray(position, np.float64)
            nan = np.isnan(p)
            w = np.where(nan, 0.0, p)
            local = quat_ops.rotate_vec(q_inv, self._tensor(w) - delta
                                        ).cpu().numpy().astype(np.float64)
            local[nan] = np.nan
            pins = (mirror,) if mirror else ()
            iks.append(postprocess.IKConstraint(frame_idx=kf, joint=joint,
                                                position=local,
                                                pin_joints=pins,
                                                offset=offset))
        if not iks:
            return frames
        window = min(self.settings.blend_window * 2, len(frames))
        return postprocess.apply_ik_constraints(
            skel, np.asarray(frames, np.float32), iks,
            interpolation_window=window,
            n_iters=self.settings.n_max_ik_iter, device=self.device)

    # -- look-at / spine edits (reference :795-815 + apply_ik_constraints
    #    :1023-1060) ----------------------------------------------------
    def apply_body_orientation_targets(self, frames, pose_buffer, targets):
        """Orient the head (and optionally a spine joint) toward world-space
        targets: (look_at_target, spine_target).  Targets are transformed by
        the INVERSE of the step's aligning transform, because the frames are
        still primitive-local at this point (the reference does the same,
        :802-810), then the look-at edit (ops/ik.look_at) runs over the
        configured window's frames at once, and the joint-limit clamp
        after it."""
        look_target, spine_target = targets
        if look_target is None and spine_target is None:
            return frames
        skel = self.graph.skeleton
        frames = np.asarray(frames, np.float32).copy()
        q_inv, delta = self._inverse_alignment(pose_buffer, frames[0])

        def to_local(p):
            return quat_ops.rotate_vec(q_inv, self._tensor(p) - delta)

        n = len(frames)
        window = min(self.settings.look_at_window, n)
        lo = max(0, n - window) if window < n else 0
        edited = self._tensor(frames[lo:])
        if look_target is not None and "Head" in skel.animated_joints:
            edited = ik.look_at(skel, skel.animated_index_of("Head"), edited,
                                to_local(look_target))
        if (spine_target is not None and self.settings.orient_spine):
            for jname in ("Spine1", "Spine"):
                if jname in skel.animated_joints:
                    edited = ik.look_at(skel, skel.animated_index_of(jname),
                                        edited, to_local(spine_target))
                    break
        if self.settings.activate_joint_constraints:
            # clamp twists the edits may have pushed past the limit table
            # (reference apply_joint_constraints over the look-at range, :814)
            edited = ik.apply_joint_limits(edited, *self._joint_limit_table())
        frames[lo:] = edited.cpu().numpy()
        return frames

    # -- CCD collision avoidance (reference handle_collision :1135) ------
    def handle_collision(self, frames, action_name, dt: float = 1e-4,
                         push_distance: float = 20.0):
        """Check the collision-boundary joint's trajectory; on a hit, push
        the joint out along the contact normal with a CCD edit at the
        colliding frame (reference :1135-1157: target = contact position -
        normal * 20, edit_motion_using_ccd with n_max_ik_iter)."""
        boundary = self.hand_collision_boundary
        if boundary is None:
            return frames
        skel = self.graph.skeleton
        joint = boundary.joint_name
        if joint not in skel.node_names:
            return frames
        frames = np.asarray(frames, np.float32)
        node_idx = skel.index_of(joint)
        points = fk_positions(skel, self._tensor(frames))[:, node_idx]
        frame_idx, pos, normal = boundary.check_trajectory(
            points.cpu().numpy(), dt)
        if frame_idx is None or frame_idx <= 0:
            return frames
        target = np.asarray(pos, np.float64) - np.asarray(normal, np.float64) * push_distance
        chain = _ccd_chain(skel, joint)
        if not chain:
            return frames
        frames = frames.copy()
        frames[frame_idx] = ik.run_ccd(
            skel, chain, node_idx, self._tensor(frames[frame_idx]),
            self._tensor(target),
            n_iters=self.settings.n_max_ik_iter).cpu().numpy()
        return frames

    def handle_collision2(self, frames, action_name, joint_names,
                          dt: float = 1e-4):
        """Multi-joint variant (reference handle_collision2 :1158-1189):
        the boundary reports per-frame displacement deltas for each checked
        joint (`get_delta_trajectory(points, dt) -> (has_collision,
        {frame_idx: delta})`); every colliding frame gets a one-iteration
        CCD reach toward position + delta per joint, in the order of
        joint_names.  The frames a joint edits are edited in one batch."""
        boundary = self.hand_collision_boundary
        if boundary is None:
            return frames
        skel = self.graph.skeleton
        frames = np.asarray(frames, np.float32)
        all_pos = fk_positions(skel, self._tensor(frames)).cpu().numpy()
        per_joint = []
        for joint in joint_names:
            if joint not in skel.node_names:
                continue
            node_idx = skel.index_of(joint)
            has, deltas = boundary.get_delta_trajectory(
                all_pos[:, node_idx], dt)
            if not has:
                continue
            hits = {}
            for fi, delta in deltas.items():
                fi = int(fi)
                if 0 <= fi < len(frames):
                    hits[fi] = all_pos[fi, node_idx] + np.asarray(
                        delta, np.float64)
            if hits:
                per_joint.append((joint, hits))
        if not per_joint:
            return frames
        frames = frames.copy()
        for joint, hits in per_joint:
            chain = _ccd_chain(skel, joint)
            if not chain:
                continue
            rows = np.array(sorted(hits))
            frames[rows] = ik.run_ccd(
                skel, chain, skel.index_of(joint), self._tensor(frames[rows]),
                self._tensor(np.stack([hits[r] for r in rows])),
                n_iters=1).cpu().numpy()
        return frames

    # -- direction extraction (reference get_direction_from_control_points
    #    :706-770) -------------------------------------------------------
    def get_direction_from_control_points(self, control_points, node_type,
                                          path_state, pose_buffer,
                                          end_direction=None,
                                          add_noise=False):
        """Pop reached/overstepped targets and return the steering vector +
        step distance.  Mirrors the reference's semantics:

          * overstepping abort: when already inside overstepping_range of
            the FINAL target and the distance starts GROWING, drop the last
            generated state and keep the previous direction;
          * look-back check: a target counts as reached if any recent
            buffered pose (look_back_range) came within min_target_distance;
          * end_direction override near the final target (min_dir_distance);
          * step distance capped by max_begin_step_length from idle,
            max_step_length otherwise.

        Mutates `control_points` (a list) and path_state; returns
        (direction_vector [3] or None, step_distance, pose_buffer)."""
        s = self.settings
        direction = None
        path_state["current_position"] = np.array(pose_buffer[-1][:3]) \
            if pose_buffer else np.zeros(3)
        found = False
        in_target_range = False
        distance = 0.0
        while not found and control_points and not self.stop_thread:
            direction = np.asarray(control_points[0], np.float64) \
                - path_state["current_position"]
            direction[1] = 0.0
            distance = float(np.linalg.norm(direction))
            if len(control_points) == 1 and distance < s.overstepping_range:
                in_target_range = True
            if (distance > path_state["prev_distance"]
                    and len(control_points) == 1 and in_target_range):
                # overstepping: drop the offending state, restore buffer
                self.state_queue.pop_last_state()
                last = self.state_queue.get_last_state()
                if last is not None:
                    pose_buffer = last.pose_buffer
                direction = path_state["prev_direction_vector"]
                distance = 0.0
                path_state["prev_target"] = control_points.pop(0)
            elif distance > s.min_target_distance:
                # look-back: did a recent pose already pass the target?
                if pose_buffer:
                    pts = [np.asarray(f[:3]) for f in
                           pose_buffer[-s.look_back_range:]]
                    min_d = min(float(np.linalg.norm(
                        (p - np.asarray(control_points[0]))
                        * np.array([1.0, 0.0, 1.0]))) for p in pts)
                else:
                    min_d = distance
                if min_d > s.min_target_distance:
                    direction = direction / distance
                    found = True
                else:
                    direction = None
                    path_state["distance"] = np.inf
                    path_state["prev_target"] = control_points.pop(0)
            else:
                direction = None
                path_state["distance"] = np.inf
                path_state["prev_target"] = control_points.pop(0)

        if direction is None:
            distance = 0.0
            direction = path_state["prev_direction_vector"]
        if (end_direction is not None and len(control_points) <= 1
                and distance < s.min_dir_distance):
            d = np.asarray(end_direction, np.float64)
            direction = d / max(np.linalg.norm(d), 1e-10)
        if node_type == NODE_TYPE_IDLE:
            step_distance = min(distance, s.max_begin_step_length)
        else:
            step_distance = min(distance, s.max_step_length)
        step_distance = max(0.0, step_distance)
        if direction is not None and add_noise:
            # seeded + zero-centered: uniform [0, eps) from the global
            # np.random both broke determinism and biased long noisy walks
            # toward +x/+z
            noise = self._np_rng.uniform(-0.5, 0.5, 3) * s.walk_noise_eps
            noise[1] = 0.0
            direction = np.asarray(direction, np.float64) + noise
        path_state["distance"] = distance
        return direction, step_distance, pose_buffer

    # -- locomotion loops ----------------------------------------------
    def generate_locomotion_from_pfnn(self, pose_buffer, control_points):
        """Frame-by-frame PFNN locomotion toward the control points."""
        scale = float(getattr(self.settings, "pfnn_stretch_scale", 0.0))
        if scale > 0.0:
            control_points = stretch_points(control_points, scale)
        return self._generate_locomotion_from_pfnn(pose_buffer, control_points)

    def _generate_locomotion_from_pfnn(self, pose_buffer, control_points):
        """Frame-by-frame PFNN locomotion toward the control points
        (reference generate_locomotion_from_pfnn :855-930): reset the
        controller at the current position, pull frames until the final
        target is within min_pfnn_target_distance, and split the stream into
        state-queue entries every min_pfnn_primitive_steps frames.  The
        controller is the caller's object, e.g. a models/pfnn.PFNNWrapper
        around a graph zip's network."""
        control_points = np.asarray(control_points, np.float64)
        cur = (np.asarray(pose_buffer[-1][:3], np.float64) if pose_buffer
               else np.zeros(3))
        # forward the blend bias to the controller's trajectory when it
        # exposes one (reference :861 pfnn_wrapper.controller.traj.blend_bias)
        traj = getattr(getattr(self.pfnn_wrapper, "controller", None),
                       "traj", None)
        if traj is not None and hasattr(traj, "blend_bias"):
            traj.blend_bias = self.settings.pfnn_blend_bias
        self.pfnn_wrapper.reset(cur, 0, np.array([0.0, 0.0, 1.0]))
        new_frames = []
        target_idx = 0
        success = False
        for _ in range(self.settings.max_pfnn_frames):
            if self.stop_thread:
                break
            # average the next k control points for a smoother target
            # (reference :846-853 pfnn_n_target_averaging)
            k = max(1, min(self.settings.pfnn_n_target_averaging,
                           len(control_points) - target_idx))
            target = control_points[target_idx: target_idx + k].mean(axis=0)
            to_target = target - cur
            to_target[1] = 0.0
            distance = float(np.linalg.norm(to_target))
            if distance < self.settings.min_pfnn_target_distance:
                if target_idx >= len(control_points) - 1:
                    success = True
                    break
                target_idx += 1
                continue
            frame = np.asarray(
                self.pfnn_wrapper.get_next_frame(to_target / distance))
            new_frames.append(frame)
            cur = frame[:3].astype(np.float64)
            if (self.settings.split_pfnn_primitives and
                    len(new_frames) >= self.settings.min_pfnn_primitive_steps):
                entry = self.state_queue.add_state(
                    ("pfnn", "locomotion"), NODE_TYPE_STANDARD,
                    np.stack(new_frames), pose_buffer)
                pose_buffer = entry.pose_buffer
                new_frames = []
        if new_frames:
            entry = self.state_queue.add_state(
                ("pfnn", "locomotion"), NODE_TYPE_STANDARD,
                np.stack(new_frames), pose_buffer)
            pose_buffer = entry.pose_buffer
        return pose_buffer, success

    def generate_locomotion(self, action: str, control_points: np.ndarray,
                            pose_buffer=None, end_direction=None,
                            body_orientation_targets=None,
                            upper_body_gesture=None, add_noise=False):
        """Walk through control points until the last is reached (reference
        generate_locomotion_from_motion_primitives :562-660): per iteration
        the steering direction + step distance come from
        get_direction_from_control_points (target switching, overstepping
        abort, look-back), steps optionally carry look-at targets and an
        upper-body gesture overlay, and the straight-line segment ahead is
        collision-checked."""
        if self.use_pfnn and self.pfnn_wrapper is not None:
            # reference :363-365 routes locomotion through the PFNN wrapper
            pose_buffer, _ = self.generate_locomotion_from_pfnn(
                pose_buffer, control_points)
            return pose_buffer
        control_points = [np.asarray(p, np.float64) for p in control_points]
        n_targets = max(len(control_points), 1)
        upper_body_state = (self.generate_upper_body_state(upper_body_gesture)
                           if upper_body_gesture is not None else None)
        path_state = {"distance": np.inf, "prev_distance": np.inf,
                      "prev_direction_vector": None,
                      "prev_target": control_points[0] if control_points else None,
                      "current_position": np.zeros(3)}
        node_key = None
        node_type = NODE_TYPE_IDLE
        steps = 0
        while (control_points and not self.stop_thread
               and steps < self.settings.max_steps_per_target * n_targets):
            direction, step_distance, pose_buffer = \
                self.get_direction_from_control_points(
                    control_points, node_type, path_state, pose_buffer,
                    end_direction, add_noise)
            if direction is None:
                continue  # target list advanced; re-evaluate
            cur = path_state["current_position"]
            if (self.collision_boundary is not None and step_distance > 0
                    and self._path_blocked(cur, cur + np.asarray(direction)
                                           * step_distance)):
                # abort the segment on a boundary hit (reference :592-604
                # clears the remaining control points and drops the state).
                # Only pop a state THIS loop generated — on a first-step
                # block the newest queued state belongs to the previous
                # action (or is the idle state) and must survive.
                if steps > 0:
                    self.state_queue.pop_last_state()
                    last = self.state_queue.get_last_state()
                    if last is not None:
                        pose_buffer = last.pose_buffer
                break
            reached_soon = (len(control_points) <= 1 and
                            path_state["distance"]
                            < self.settings.step_target_threshold * 2)
            node_type = self.get_next_node_type(node_type, reached_soon)
            node_key = self._pick_node(node_key, node_type, action)
            if node_key is None:
                break
            target_pos = cur + np.asarray(direction) * step_distance
            last_target = len(control_points) <= 1
            entry = self.generate_step(
                node_key, pose_buffer,
                target_pos=target_pos if last_target else None,
                target_dir=[direction[0], direction[2]],
                upper_body_state=upper_body_state,
                body_orientation_targets=body_orientation_targets,
                action=action)
            pose_buffer = entry.pose_buffer
            node_type = self.graph.nodes[node_key].node_type
            path_state["prev_direction_vector"] = direction
            path_state["prev_distance"] = path_state["distance"]
            steps += 1
            if self.settings.sleep_time > 0:
                # worker-thread pacing so a streaming consumer can keep up
                # (reference sleep_time, mg_state_planner.py:608)
                import time as _time
                _time.sleep(self.settings.sleep_time)
        # end-target enforcement (reference :357-380 force_walk_end_targets):
        # when the loop consumed every control point but stopped short of the
        # exact target, blend the newest state's root onto it and orient it
        # toward end_direction (or the last steering direction)
        if (self.settings.force_walk_end_targets and not control_points
                and not self.stop_thread
                and path_state["prev_target"] is not None and pose_buffer):
            target = np.asarray(path_state["prev_target"], np.float64)
            end_pos = np.asarray(pose_buffer[-1][:3], np.float64)
            end_distance = float(np.linalg.norm(
                (target - end_pos) * np.array([1.0, 0.0, 1.0])))
            window = self.settings.end_target_blend_range
            if end_distance > self.settings.min_end_distance:
                self.state_queue.correct_last_state_end_pos(target, window)
            end_dir = end_direction
            if end_dir is None:
                end_dir = path_state["prev_direction_vector"]
            if end_dir is not None:
                d = np.asarray(end_dir, np.float64)
                d_xz = np.array([d[0], d[2]] if len(d) == 3 else d[:2])
                n = np.linalg.norm(d_xz)
                if n > 1e-10:
                    self.state_queue.correct_last_state_end_dir(d_xz / n,
                                                                window)
            last = self.state_queue.get_last_state()
            if last is not None:
                pose_buffer = last.pose_buffer
        return pose_buffer

    @staticmethod
    def _normalize_action_desc(a: dict) -> dict:
        """Accept the reference's snake_case message keys alongside the
        native camelCase ones (reference action_desc schema :319/:337/:354:
        action_name, control_points, end_direction, n_steps,
        upper_body_gesture, frame_constraints, n_cycles,
        body_orientation_targets)."""
        a = dict(a)
        for ref_key, key in (("action_name", "action"),
                             ("control_points", "controlPoints"),
                             ("end_direction", "endDirection"),
                             ("n_steps", "nSteps"),
                             ("upper_body_gesture", "upperBodyGesture"),
                             ("frame_constraints", "frameConstraints"),
                             ("n_cycles", "nCycles")):
            if ref_key in a and key not in a:
                a[key] = a[ref_key]
        bt = a.get("body_orientation_targets")
        if bt is not None and "lookAtTarget" not in a and len(bt) == 2:
            a["lookAtTarget"], a["spineTarget"] = bt[0], bt[1]
        return a

    def generate_motion_states_from_action_sequence(self, actions: List[dict],
                                                    pose_buffer=None):
        """reference :316-350: locomotion per desc (control points or
        direction + n_steps), then non-walk actions play their
        action-definition node sequence with frame constraints."""
        for a in actions:
            if self.stop_thread:
                break
            a = self._normalize_action_desc(a)
            name = a["action"]
            body_targets = None
            if "lookAtTarget" in a or "spineTarget" in a:
                body_targets = (a.get("lookAtTarget"), a.get("spineTarget"))
            # the reference gates on len > 1 (:337) because its engine always
            # sends the current position as point 0; a single target is a
            # valid native request, so only an EMPTY list falls through
            if a.get("controlPoints") is not None and len(a["controlPoints"]) > 0:
                pose_buffer = self.generate_locomotion(
                    name, np.asarray(a["controlPoints"], np.float32),
                    pose_buffer, end_direction=a.get("endDirection"),
                    body_orientation_targets=body_targets,
                    upper_body_gesture=a.get("upperBodyGesture"))
            elif a.get("direction") is not None:
                # direction walk (reference generate_locomotion_from_motion_
                # primitives_using_direction :612-653): carries the same
                # overlay/orientation edits as the control-point branch
                n_steps = int(a.get("nSteps", 1))
                # the message direction is a 3D world vector (reference
                # :615); the constraint slot takes the ground-plane form
                direction = np.asarray(a["direction"], np.float32)
                if direction.shape[-1] == 3:
                    direction = direction[[0, 2]]
                gesture = a.get("upperBodyGesture")
                upper_body_state = (self.generate_upper_body_state(gesture)
                                    if gesture is not None else None)
                node_key = None
                node_type = NODE_TYPE_IDLE
                for _ in range(n_steps):
                    node_type = self.get_next_node_type(node_type, False)
                    node_key = self._pick_node(node_key, node_type, name)
                    if node_key is None:
                        break
                    entry = self.generate_step(
                        node_key, pose_buffer, target_dir=direction,
                        upper_body_state=upper_body_state,
                        body_orientation_targets=body_targets,
                        action=name)
                    pose_buffer = entry.pose_buffer
                    node_type = self.graph.nodes[node_key].node_type
            if (name != "walk"
                    and name in self.graph.action_definitions
                    and not self.stop_thread):
                # non-walk actions play their node sequence with frame
                # constraints (reference generate_motion_states_from_action
                # :340-342 -> generate_action_motion)
                pose_buffer = self.generate_action_motion(a, pose_buffer)
        return pose_buffer

    # -- streaming non-walk actions (reference generate_action_motion
    #    :384-520) -------------------------------------------------------
    def generate_action_node_queue(self, action: str, start_node_key=None,
                                   start_node_type: str = NODE_TYPE_IDLE,
                                   n_cycles: int = 0) -> List[tuple]:
        """Node playback queue from the graph's action definitions
        (reference :410-421 / cycles variant :446-464): finish a walk in
        progress first, then the node_sequence (or cycle_start/cycle_node/
        cycle_end for cyclic actions), then an idle tail."""
        defs = self.graph.action_definitions.get(action, {})
        queue: List[tuple] = []
        walk_end = ("walk", "endRightStance")  # reference WALK_END_STATE :75
        if (start_node_key is not None and start_node_key[0] == "walk"
                and walk_end in self.graph.nodes
                and start_node_type not in (NODE_TYPE_IDLE, NODE_TYPE_END)):
            queue.append((walk_end, NODE_TYPE_END))
        if n_cycles > 0 and "cycle_start" in defs:
            name, ntype = defs["cycle_start"]
            queue.append(((action, name), ntype))
            for _ in range(max(n_cycles - 2, 0)):
                name, ntype = defs["cycle_node"]
                queue.append(((action, name), ntype))
            if n_cycles > 1 and "cycle_end" in defs:
                name, ntype = defs["cycle_end"]
                queue.append(((action, name), ntype))
        else:
            for name, ntype in defs.get("node_sequence", []):
                queue.append(((action, name), ntype))
        if action != "idle":
            idle = self.graph.start_node
            if idle is not None and idle in self.graph.nodes:
                queue.append((idle, NODE_TYPE_IDLE))
        return queue

    @staticmethod
    def map_frame_constraints_to_nodes(frame_constraints) -> dict:
        """Group constraint descs by (node primitive name, cycle)
        (reference map_frame_constraints_to_nodes :423-443)."""
        node_constraints: dict = {}
        for c in frame_constraints or []:
            key = (c.get("node"), int(c.get("cycle", 0)))
            node_constraints.setdefault(key, []).append(c)
        return node_constraints

    def resolve_engine_frame_constraints(self, action: str,
                                         descs: List[dict]) -> List[dict]:
        """Engine (Unity) constraint descs -> planner frame-constraint
        dicts (reference ConstraintBuilder.generate_frame_constraint
        :288-345): the desc names a keyframe LABEL; the action definition's
        constraint_slots[label] resolves the target node (per-cycle via
        cycle_nodes) and a default joint; coordinates convert handedness
        like server_builder.parse_unity_constraints (x negated; orientation
        w,x negated)."""
        slots = self.graph.action_definitions.get(action, {}).get(
            "constraint_slots", {})
        out = []
        for d in descs:
            label = d.get("keyframe", d.get("keyframeLabel"))
            slot = slots.get(label, {})
            cycle = int(d.get("cycle", 0))
            if "cycle_nodes" in slot:
                nodes = slot["cycle_nodes"]
                mp = nodes[cycle] if cycle < len(nodes) else nodes[-1]
            else:
                mp = slot.get("node", d.get("node"))
            joint = d.get("joint") or slot.get("joint")
            pos = d.get("position")
            if isinstance(pos, dict):
                pos = [-float(pos["x"]), float(pos["y"]), float(pos["z"])]
            ori = (d.get("orientation")
                   if d.get("constrainOrientation", "orientation" in d)
                   else None)
            if isinstance(ori, dict):
                ori = [-float(ori["w"]), -float(ori["x"]),
                       float(ori["y"]), float(ori["z"])]
            # region constraints (reference constraint_builder.py:323-345):
            # constrainPositionInRegion/-OrientationInRegion + endKeyframe
            # enact the constraint from the resolved keyframe to the end
            # keyframe, not just at one frame (generate_state expands the
            # span to sampled slots + IK snaps)
            in_region = bool(d.get("constrainPositionInRegion")
                             or d.get("constrainOrientationInRegion"))
            end_label = (d.get("endKeyframe") or None) if in_region else None
            out.append({"node": mp, "cycle": cycle, "joint": joint,
                        "position": pos, "orientation": ori,
                        "keyframeLabel": label,
                        "endKeyframeLabel": end_label,
                        "constrainPositionInRegion":
                            bool(d.get("constrainPositionInRegion", False)),
                        "constrainOrientationInRegion":
                            bool(d.get("constrainOrientationInRegion",
                                       False)),
                        "offset": self._resolve_tool_offset(d, joint),
                        "holdFrame": bool(d.get("hold",
                                                d.get("holdFrame", False))),
                        "keyframeEvents": d.get("keyframeEvents", []),
                        # keepOffsetBetweenBones (reference :338-339)
                        "relativeJoint": (d.get("relativeBoneName")
                                          if d.get("keepOffsetBetweenBones")
                                          else d.get("relativeJoint")),
                        # keepMirrorBoneStatic (reference :340-343): pin the
                        # mirror joint at its current position during IK
                        "mirrorJoint": (
                            skeleton_models.STANDARD_MIRROR_MAP.get(joint)
                            if d.get("keepMirrorBoneStatic")
                            else d.get("mirrorJoint"))})
        return out

    def _resolve_tool_offset(self, d: dict, joint: str):
        """Local tool offset for an engine constraint desc (reference
        extract_tool_offset, constraint_builder.py:242-260): the declared
        `offset` applies when `applyOffset` is set; when the desc also
        carries `toolEndPoint` + `currentPose`, the offset is recomputed as
        the tool end point expressed in the joint's local frame at the
        engine's current pose, so the TOOL TIP (not the joint origin) hits
        the constraint target."""
        if not d.get("applyOffset") or d.get("offset") is None:
            return None
        offset = [float(v) for v in d["offset"]]
        tp, pose = d.get("toolEndPoint"), d.get("currentPose")
        skel = self.graph.skeleton
        if tp is not None and pose is not None and joint in skel.node_names:
            from ..constraints.server_builder import unity_frame_to_mg_frame
            frame = unity_frame_to_mg_frame(skel, pose)
            pos, ori = fk_global(skel, self._tensor(frame))
            ni = skel.index_of(joint)
            tp_mg = self._tensor([-float(tp[0]), float(tp[1]), float(tp[2])])
            q = quat_ops.normalize(ori[ni])
            offset = quat_ops.rotate_vec(
                quat_ops.conjugate(q), tp_mg - pos[ni]
            ).cpu().numpy().astype(np.float64).tolist()
        return offset

    def generate_action_motion(self, action_desc: dict, pose_buffer=None):
        """Play a non-walk action's node sequence with per-node frame
        constraints (reference generate_action_motion :384-408 +
        generate_action_from_motion_primitives :467-498): resolve the node
        queue, attach each constraint to its (node, cycle), generate the
        steps, and optionally correct end drift back to the action's start
        pose (prevent_action_drift)."""
        a = self._normalize_action_desc(action_desc)
        action = a["action"]
        last = self.state_queue.get_last_state()
        start_key = last.node_key if last is not None else None
        start_type = last.node_type if last is not None else NODE_TYPE_IDLE
        if last is not None:
            pose_buffer = last.pose_buffer
        n_cycles = int(a.get("nCycles", 0))
        queue = self.generate_action_node_queue(action, start_key, start_type,
                                                n_cycles)
        fcs = a.get("frameConstraints") or []
        if any("node" not in c or isinstance(c.get("position"), dict)
               for c in fcs):
            # engine-format descs name a keyframe label only; resolve them
            # through the action definition's constraint_slots
            fcs = self.resolve_engine_frame_constraints(action, fcs)
        node_constraints = self.map_frame_constraints_to_nodes(fcs)
        body_targets = None
        if "lookAtTarget" in a or "spineTarget" in a:
            body_targets = (a.get("lookAtTarget"), a.get("spineTarget"))
        start_pos = (np.asarray(pose_buffer[-1][:3], np.float32).copy()
                     if pose_buffer else None)
        cycle_count = 0
        cycle_nodes = self.graph.action_definitions.get(action, {}).get(
            "cycle_nodes", ())
        for node_key, node_type in queue:
            if self.stop_thread:
                break
            if node_key not in self.graph.nodes:
                # an action definition may reference nodes a trimmed graph
                # does not carry; skip instead of KeyError-ing mid-stream
                from ..utils import log
                log.write_message_to_log(
                    f"action node {node_key} not in graph; skipped",
                    log.LOG_MODE_ERROR)
                continue
            constraints = node_constraints.get((node_key[1], cycle_count), [])
            # look-at constraints aim the head at the frame-constraint
            # target (reference :438-442)
            targets = body_targets
            if constraints and a.get("lookAtConstraints") and targets is None:
                targets = (np.asarray(constraints[0]["position"], np.float32),
                           None)
            entry = self.generate_step(node_key, pose_buffer,
                                       body_orientation_targets=targets,
                                       action=action,
                                       keyframe_constraints=constraints)
            pose_buffer = entry.pose_buffer
            if node_key[1] in cycle_nodes:
                cycle_count += 1
        if self.settings.prevent_action_drift and start_pos is not None:
            # blend the newest state's root back to the action's start
            # position (reference :405-408)
            self.state_queue.correct_last_state_end_pos(start_pos)
            last = self.state_queue.get_last_state()
            if last is not None:
                pose_buffer = last.pose_buffer
        return pose_buffer

    def start(self, actions: List[dict]):
        """Run the planner on a worker thread feeding the state queue
        (reference worker-thread structure, :307-350).  The kernels launch
        on the worker's current stream of the planner's device."""
        self.stop_thread = False
        self._thread = threading.Thread(
            target=self.generate_motion_states_from_action_sequence,
            args=(actions,), daemon=True)
        self._thread.start()
        return self._thread

    def stop(self):
        self.stop_thread = True
        if self._thread is not None:
            self._thread.join(timeout=10)

    def _path_blocked(self, cur, target) -> bool:
        """Sample the straight line to the target against the collision
        boundary (reference check_trajectory semantics)."""
        cur = np.asarray(cur, np.float64)
        target = np.asarray(target, np.float64)
        d = float(np.linalg.norm((target - cur) * np.array([1, 0, 1])))
        n = max(int(d / max(self.settings.collision_check_step, 1e-3)), 1)
        for i in range(1, n + 1):
            p = cur + (target - cur) * (i / n)
            if self.collision_boundary(float(p[0]), float(p[2])):
                return True
        return False

    # -- upper body overlay (reference :817-930) ------------------------
    def overlay_upper_body(self, base_frames: np.ndarray,
                           gesture_frames: np.ndarray) -> np.ndarray:
        """Splice upper-body joint quaternions from a gesture clip onto the
        locomotion frames (lengths matched by linear resampling)."""
        skel = self.graph.skeleton
        base = np.asarray(base_frames, np.float32).copy()
        gesture = np.asarray(gesture_frames, np.float32)
        idx = np.linspace(0, len(gesture) - 1, len(base)).round().astype(int)
        resampled = gesture[idx]
        for joint in UPPER_BODY_JOINTS:
            if joint in skel.animated_joints:
                sl = skel.quat_slice(joint)
                base[:, sl] = resampled[:, sl]
        return base


def _pad(n: int, multiple: int = 32) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _ccd_chain(skel, joint_name: str, max_len: int = 3,
               stop_at: str = None) -> tuple:
    """Animated-joint chain child -> root for CCD, ending before the root
    (reference edit_motion_using_ccd walks the parent chain).  `stop_at`
    bounds the chain at a named ancestor inclusively (the reference's
    chain_end_joint, e.g. the shoulder for gesture wrist edits)."""
    chain = []
    idx = skel.index_of(joint_name)
    while idx >= 0 and len(chain) < max_len:
        name = skel.node_names[idx]
        if name in skel.animated_joints and name != skel.animated_joints[0]:
            chain.append(skel.animated_index_of(name))
        if stop_at is not None and name == stop_at:
            break
        idx = skel.parents[idx]
    return tuple(chain)
