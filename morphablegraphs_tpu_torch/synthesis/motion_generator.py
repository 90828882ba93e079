"""Sequential constrained synthesis: one request -> quaternion frames (port
of morphablegraphs_tpu.synthesis.motion_generator).

A host loop plans each action's walk (start node, then transitions scored
by best-of-K samples), runs each step's selection, LM and epilogue on the
generator's device (`synthesis.generator`), refines each action's last
steps jointly (`global_opt`, global_spatial_optimization_mode) and its
collision-avoidance steps again (optimize_collision_avoidance_constraints_
extra), moves timed keyframes onto their times (`global_opt`,
use_global_time_optimization), re-projects every step with its time warp
and post-processes the motion: keyframe IK, trajectory IK (the "ik"
collision-avoidance mode) and grounding (activate_motion_grounding).  It
runs on the CUDA device unless given device="cpu" (the kernels' twins).

Random draws come from a sampler hook, sampler(node_key, n) -> [n, L],
called where the JAX package calls `sample_latent(self._next_key(), prim,
n)`: once per planner option, once per constrained step (the pool), once
per unconstrained step.  With use_transition_model, a step whose previous
node's edge carries a transition model draws from the mixture conditioned
on the previous step's latent instead, as sampler(node_key, n, gmm=...)
(the pool, or one latent in an unconstrained step), where the JAX package
calls `predict_parameters(self._next_key(), ...)`; a sampler of two
arguments serves every request without transition models.  The default
draws with `ops.gmm.sample` from a torch.Generator seeded with `seed` on
the device; threefry's stream is not reproduced, so parity runs hand in
the JAX package's draws.

Under constrained_sampling_mode="cluster_tree_search" a constrained
step's pool is its node's cluster-tree data (10,000 latents of a
reference tree, kept on the device by the tree), after a transition
model's draws and before the mixture's, as in the JAX package; there the
JAX package takes a key and draws nothing, and the port calls
sampler(node_key, 0), whose result it does not read.  A node without a
tree samples its mixture.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..constraints import compiled
from ..constraints.input_reader import read_input
from ..models import primitive as prim_mod
from ..models.graph import (MotionStateGraph, NODE_TYPE_CYCLE_END,
                            NODE_TYPE_END, NODE_TYPE_SINGLE,
                            NODE_TYPE_STANDARD)
from ..ops import align, gmm as gmm_ops, spline_path, timewarp
from ..utils import device as device_mod
from ..utils import profiling
from ..utils.config import default_config
from . import action_builder, generator


@dataclasses.dataclass
class GraphWalkEntry:
    """One synthesis step."""

    node_key: tuple
    parameters: np.ndarray
    arc_length: float
    start_frame: int
    end_frame: int
    error: float = 0.0
    step_constraints: object = None  # the step's filled constraint set
    time_constraints: tuple = ()  # ((canonical_keyframe, desired_time_s), ...)
    # ((joint, position[3], canonical_keyframe, orientation_quat_or_None), ...)
    user_constraints: tuple = ()
    action_name: str = ""


@dataclasses.dataclass
class MotionResult:
    frames: np.ndarray  # [T, D] quaternion frames (time-warped)
    steps: List[GraphWalkEntry]
    action_ranges: List[tuple]  # (action_name, start_frame, end_frame)
    stats: dict


class MotionGenerator:
    """MotionGenerator(graph, config=None, seed=0, device=None,
    sampler=None).generate_motion(mg_input) -> MotionResult."""

    def __init__(self, graph: MotionStateGraph, config: Optional[dict] = None,
                 seed: int = 0, device=None,
                 sampler: Optional[Callable] = None):
        self.graph = graph
        self.config = config or default_config()
        if self.config.get("verbose"):
            from ..utils.log import LOG_MODE_DEBUG, set_log_mode
            set_log_mode(LOG_MODE_DEBUG)
        self.device = device_mod.resolve(device, "MotionGenerator")
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        self.sampler = sampler or self._gmm_sampler
        self._prims = {}  # node key -> its primitive on the device
        self._start_transform = None  # (q_y, delta) placing step one
        self._objective_evaluations = 0
        self._step_times: List[float] = []
        # the last step's latent and node: the transition models' condition
        self._prev_latent = None
        self._prev_node_key = None
        from .grounding import SceneInterface
        self.scene_interface = SceneInterface()

    def _prim(self, node_key):
        if node_key not in self._prims:
            self._prims[node_key] = self.graph.nodes[node_key].primitive.to(
                self.device)
        return self._prims[node_key]

    def _gmm_sampler(self, node_key, n: int, gmm=None) -> torch.Tensor:
        if n == 0:  # a cluster-tree step's key: nothing is drawn
            return torch.empty((0, self._prim(node_key).n_latent),
                               device=self.device)
        if gmm is not None:
            return gmm_ops.sample(self.generator, gmm, n)
        return prim_mod.sample_latent(self.generator, self._prim(node_key),
                                      n)

    def _draw(self, node_key, n: int, gmm=None) -> torch.Tensor:
        """n latents of node_key: from its mixture, or from `gmm` (a
        transition model's conditioned mixture)."""
        out = (self.sampler(node_key, n) if gmm is None
               else self.sampler(node_key, n, gmm=gmm))
        return torch.as_tensor(out, dtype=torch.float32, device=self.device)

    def _pool(self, node_key, n: int, tm_gmm) -> torch.Tensor:
        """A constrained step's candidates, in the JAX package's order: n
        draws of a transition model's conditioned mixture, else the node's
        cluster-tree data under cluster_tree_search, else n draws of the
        node's mixture."""
        if tm_gmm is None:
            tree_pool = generator.cluster_pool(
                self.config, self.graph.nodes[node_key], self.device)
            if tree_pool is not None:
                self._draw(node_key, 0)
                return tree_pool
        return self._draw(node_key, n, tm_gmm)

    def _transition_gmm(self, node_key):
        """The mixture over node_key's latent conditioned on the previous
        step's latent, when use_transition_model is set and the previous
        node's edge to node_key carries a model; else None."""
        if not (self.config.get("use_transition_model")
                and self._prev_latent is not None
                and self._prev_node_key in self.graph.nodes):
            return None
        models = self.graph.nodes[self._prev_node_key].transition_models
        if node_key not in models:
            return None
        from ..models import transition_model as tm
        return tm.predict(models[node_key].to(self.device),
                          torch.as_tensor(self._prev_latent,
                                          device=self.device))

    # ------------------------------------------------------------------
    @profiling.span("generate", ranged=False)
    def generate_motion(self, mg_input: dict, complete_motion_vector: bool = True,
                        activate_joint_mapping: bool = False,
                        activate_coordinate_transform: bool = False,
                        scale_factor: float = 1.0) -> MotionResult:
        t_start = time.time()
        self._step_times = []
        self._prev_latent = None  # a fresh request: no transition context
        self._prev_node_key = None
        # per action with collision-avoidance trajectories in the "ik"
        # mode: (trajectories, first step, end step), for _post_process
        self._ca_ik_spans = []
        parsed = read_input(mg_input,
                            activate_coordinate_transform=activate_coordinate_transform,
                            activate_joint_mapping=activate_joint_mapping,
                            scale_factor=scale_factor,
                            control_point_filter_threshold=float(
                                self.config["trajectory_following_settings"]
                                .get("control_point_filter_threshold", 0)))
        action_sets = action_builder.build_action_constraints(
            self.graph, parsed, self.config)

        steps: List[GraphWalkEntry] = []
        frames: Optional[np.ndarray] = None
        action_step_spans = []  # (action, first step idx, last step idx + 1)
        prev_node_key = None
        for acs in action_sets:
            first_step = len(steps)
            frames, prev_node_key = self._generate_action(
                acs, frames, steps, prev_node_key)
            action_step_spans.append((acs.action_name, first_step, len(steps)))

        self._maybe_optimize_time(steps, action_step_spans)
        with profiling.span("request.convert"):
            warped = self._convert_with_time_warp(
                steps, complete_motion_vector=complete_motion_vector)
        action_ranges = [
            (name, steps[i0].start_frame if i1 > i0 else 0,
             steps[i1 - 1].end_frame + 1 if i1 > i0 else 0)
            for name, i0, i1 in action_step_spans]
        warped = self._post_process(warped, steps)

        stats = {
            "n_steps": len(steps),
            "time": time.time() - t_start,
            "average_error": float(np.mean([s.error for s in steps])) if steps else 0.0,
            "objective_evaluations": self._objective_evaluations,
            "p50_step_latency": float(np.median(self._step_times)) if self._step_times else 0.0,
        }
        from ..utils.log import write_message_to_log
        write_message_to_log(
            "generated motion in {time:.3f}s: {n_steps} steps, "
            "avg constraint error {average_error:.3f}, "
            "{objective_evaluations} objective evaluations".format(**stats))
        return MotionResult(frames=warped, steps=steps,
                            action_ranges=action_ranges, stats=stats)

    # ------------------------------------------------------------------
    def _generate_action(self, acs, frames, steps, prev_node_key,
                         max_steps: int = 100):
        """One action's walk: the start node, then transitions until an end
        state; then the global spatial optimization and the extra
        collision-avoidance pass over its steps."""
        graph = self.graph
        first_idx = len(steps)
        travelled = 0.0
        full_arc = acs.full_arc_length
        arc_of_end = self._end_step_arc_length(acs)

        with profiling.span("request.plan"):
            node_key = self._best_start_node(acs, frames, prev_node_key)
        frames, travelled, _ = self._generate_step(
            acs, node_key, frames, steps, travelled, is_last_step=False)
        node_type = graph.nodes[node_key].node_type

        n = 0
        while not self._is_end_state(node_type, acs, frames, travelled,
                                     arc_of_end, full_arc,
                                     len(steps)) and n < max_steps:
            with profiling.span("request.plan"):
                next_key, next_type = self._best_transition_node(
                    acs, node_key, frames, travelled, arc_of_end)
            if next_key is None:
                break  # keep node_key: the next action links from it
            node_key = next_key
            frames, travelled, _ = self._generate_step(
                acs, node_key, frames, steps, travelled,
                is_last_step=(next_type == NODE_TYPE_END))
            node_type = graph.nodes[node_key].node_type
            n += 1
        frames = self._maybe_optimize_globally(steps, frames, acs)
        frames = self._maybe_optimize_ca_extra(steps, frames, acs, first_idx)
        if (self.config.get("collision_avoidance_constraints_mode",
                            "direct_connection") == "ik"
                and acs.ca_trajectories and len(steps) > first_idx):
            self._ca_ik_spans.append(
                (list(acs.ca_trajectories), first_idx, len(steps)))
        return frames, node_key

    def _maybe_optimize_ca_extra(self, steps, frames, acs, first_idx: int):
        """With optimize_collision_avoidance_constraints_extra and CA
        trajectories on the action: re-optimize every step of the action
        by the LM against the trajectory-set slots of those trajectories
        alone (each joint's start arc the closest point of its position in
        the last rebuilt frame), rebuilding the motion from the action's
        first step as it goes.  Returns the rebuilt motion."""
        if not self.config.get(
                "optimize_collision_avoidance_constraints_extra", False):
            return frames
        skel = self.graph.skeleton
        ca = [t for t in acs.ca_trajectories
              if t.joint in skel.node_names][:compiled.MAX_TS_JOINTS]
        if not ca or first_idx >= len(steps):
            return frames
        from ..models.skeleton import fk_positions
        dev = self.device
        joints = [t.joint for t in ca]
        trajs = [spline_path.build(t.control_points,
                                   max_points=spline_path.MAX_PATH_POINTS,
                                   unconstrained_dims=t.unconstrained_dims)
                 for t in ca]
        trajs_dev = [sp.to(dev) for sp in trajs]
        settings = self.config["local_optimization_settings"]
        n_iters = int(self.config.get("lm_iterations", 10))
        prefix = (frames[:steps[first_idx].start_frame]
                  if frames is not None else None)
        rebuilt = prefix if prefix is not None and len(prefix) else None
        with profiling.span("request.ca_extra"):
            for step in steps[first_idx:]:
                prim = self._prim(step.node_key)
                sc = compiled.empty_step_constraints(skel,
                                                     prim.n_canonical_frames)
                if rebuilt is not None:
                    pts = fk_positions(skel, torch.as_tensor(
                        rebuilt[-1], dtype=torch.float32, device=dev))
                    zero = torch.zeros((), device=dev)
                    arc0 = [float(spline_path.closest_point(
                        sp, pts[skel.index_of(j)], zero)[1])
                        for j, sp in zip(joints, trajs_dev)]
                    sc = compiled.set_alignment_from_prev(sc, rebuilt[-1])
                else:
                    arc0 = [0.0] * len(joints)
                    sc = compiled.set_alignment_from_start_pose(
                        sc, acs.start_pose_position,
                        acs.start_pose_orientation_y)
                sc = compiled.set_trajectory_set_constraint(
                    sc, skel, joints, trajs, arc0=arc0)
                s_opt, _ = generator.refine_lm(
                    skel, prim, generator.device_constraints(sc, dev),
                    torch.as_tensor(step.parameters, device=dev)[None],
                    n_iters=n_iters,
                    error_scale=float(settings.get("error_scale_factor",
                                                   1.0)),
                    quality_scale=float(settings.get("quality_scale_factor",
                                                     0.1)),
                    use_traj=False, use_ca=False, use_ts=True)
                step.parameters = s_opt[0].cpu().numpy()
                self._objective_evaluations += 2 * n_iters
                rebuilt = self._rebuild_step(rebuilt, step)
        return rebuilt

    def _maybe_optimize_globally(self, steps, frames, acs):
        """The global spatial optimization of the action's last max_steps
        steps (global_spatial_optimization_mode): "all" on actions with
        user constraints, "two_hands" on two-hand actions, "trajectory_end"
        on actions with a root trajectory; skipped below two steps or
        below start_error_threshold average error.  The window's weights
        are adapted (`global_opt.adapt_constraint_weights`), its spatial
        latents refined jointly, and the motion rebuilt from them."""
        cfg = self.config
        mode = cfg.get("global_spatial_optimization_mode", "none")
        if mode == "none":
            return frames
        if mode == "all" and not acs.contains_user_constraints:
            return frames
        if mode == "two_hands" and not acs.contains_two_hands_constraints:
            return frames
        if mode == "trajectory_end" and acs.root_trajectory is None:
            return frames
        settings = cfg["global_spatial_optimization_settings"]
        window = [s for s in steps if s.step_constraints is not None][
            -int(settings["max_steps"]):]
        if len(window) < 2:
            return frames
        avg_err = float(np.mean([s.error for s in window]))
        if avg_err < float(settings.get("start_error_threshold", 0.0)):
            return frames
        from . import global_opt
        scs = global_opt.adapt_constraint_weights(
            [s.step_constraints for s in window], mode,
            float(settings.get("position_weight", 1000.0)),
            float(settings.get("orientation_weight", 1000.0)))
        new_params, _ = global_opt.optimize_spatial_over_steps(
            self.graph.skeleton, [self._prim(s.node_key) for s in window],
            scs, [s.parameters for s in window],
            quality_scale=float(settings.get("quality_scale_factor", 100.0))
            * 1e-6, device=self.device)
        for s, p in zip(window, new_params):
            s.parameters = p
        frames = None
        for step in steps:
            frames = self._rebuild_step(frames, step)
        return frames

    def _rebuild_step(self, frames, step):
        """Append step's clip, re-projected on the canonical timeline from
        its latent (the frame-emit kernel on a CUDA device), to the motion
        frames (None: place it at the start pose), and point the step at
        its rows."""
        prim = self._prim(step.node_key)
        f, n, _ = prim_mod.back_project(
            prim, torch.as_tensor(step.parameters, device=self.device),
            max_frames=_pad_frames(prim.n_canonical_frames), use_time=False)
        n = int(n)
        frames = self._append_padded(frames, f, n, self._smoothing_window())
        step.start_frame = len(frames) - n
        step.end_frame = len(frames) - 1
        return frames

    def _is_end_state(self, node_type, acs, frames, travelled, arc_of_end,
                      full_arc, n_total_steps):
        """The last node type, a cycled action (one step), the debug step
        cap, or the path consumed."""
        if node_type in (NODE_TYPE_END, NODE_TYPE_SINGLE):
            return True
        if acs.cycled_next:
            return True
        debug_max_step = int(self.config.get("debug_max_step", -1))
        if debug_max_step > -1 and n_total_steps > debug_max_step:
            return True
        if acs.root_trajectory is not None and travelled >= full_arc:
            return True
        return False

    def _end_step_arc_length(self, acs) -> float:
        """Average step length of the action's end states times
        end_step_length_factor."""
        group = self.graph.node_groups[acs.action_name]
        lengths = [self.graph.nodes[(acs.action_name, s)].average_step_length
                   for s in group.end_states
                   if (acs.action_name, s) in self.graph.nodes]
        factor = self.config["trajectory_following_settings"]["end_step_length_factor"]
        return float(np.mean(lengths)) * factor if lengths else 0.0

    def _smoothing_window(self) -> int:
        """Seam-smoothing window; 0 when spatial_smoothing is off."""
        ss = self.config["smoothing_settings"]
        if not ss.get("spatial_smoothing", True):
            return 0
        return int(ss["spatial_smoothing_window"])

    def _closest_point_refine_iters(self, acs) -> int:
        """Ternary-refinement budget of the travelled-arc search from the
        closest-point settings."""
        tf = self.config["trajectory_following_settings"]
        return spline_path.refine_iters_for_accuracy(
            acs.full_arc_length,
            accuracy=float(tf.get("closest_point_search_accuracy", 1e-3)),
            max_iterations=int(tf.get("closest_point_search_max_iterations",
                                      5000)),
            granularity=int(tf.get("arc_length_granularity",
                                   spline_path.GRANULARITY)))

    def _path(self, acs):
        """The action's root trajectory on the device with a leading [1]
        axis (built once per action)."""
        if getattr(acs, "device_path", None) is None:
            acs.device_path = spline_path.map_leaves(
                acs.root_trajectory, lambda a: a[None].to(self.device))
        return acs.device_path

    # -- planner -------------------------------------------------------
    def _best_start_node(self, acs, frames, prev_node_key):
        """The action's start node: one start state linked from the
        previous node, else the best-scoring option."""
        group = self.graph.node_groups[acs.action_name]
        options = [(acs.action_name, s) for s in group.start_states
                   if (acs.action_name, s) in self.graph.nodes]
        if prev_node_key is not None:
            edges = self.graph.nodes[prev_node_key].outgoing_edges
            linked = [o for o in options if o in edges]
            if linked:
                options = linked
        if not options:
            options = list(group.node_keys)
        if len(options) == 1:
            return options[0]
        add_orientation = bool(self.config["trajectory_following_settings"]
                               .get("constrain_start_orientation", True))
        return self._select_best_option(acs, options, frames, travelled=0.0,
                                        add_orientation=add_orientation)

    def _best_transition_node(self, acs, prev_key, frames, travelled,
                              arc_of_end):
        """The transition type from the trajectory's end condition (or the
        node's standard edges), then the best-scoring option."""
        graph = self.graph
        if acs.root_trajectory is not None:
            root_pos = frames[-1][:3]
            ended = acs.check_end_condition(
                root_pos, travelled, arc_of_end,
                acs.full_arc_length, acs.last_control_point)
            next_type = NODE_TYPE_END if ended else NODE_TYPE_STANDARD
        else:
            n_std = self.graph.nodes[prev_key].edges_of_type(NODE_TYPE_STANDARD)
            next_type = NODE_TYPE_STANDARD if n_std else NODE_TYPE_END
            if acs.cycled_next and next_type == NODE_TYPE_END:
                next_type = NODE_TYPE_CYCLE_END
        options = graph.nodes[prev_key].edges_of_type(next_type)
        if not options:
            for t in (NODE_TYPE_STANDARD, NODE_TYPE_END):
                options = graph.nodes[prev_key].edges_of_type(t)
                if options:
                    next_type = t
                    break
        if not options:
            return None, None
        if len(options) == 1:
            return options[0], next_type
        add_orientation = bool(self.config["trajectory_following_settings"]
                               .get("constrain_transition_orientation", True))
        best = self._select_best_option(acs, options, frames, travelled,
                                        add_orientation=add_orientation)
        return best, next_type

    def _select_best_option(self, acs, options, frames, travelled,
                            add_orientation=False):
        """Score each option by the best of K samples under the planner's
        own evaluation set (with a root trajectory: a unit goal at
        travelled + look_ahead_distance and optionally the tangent), else
        under the step constraints; the lowest error wins, NaN never."""
        k = int(self.config.get("planner_samples_per_option", 10))
        errs = []
        for option in options:
            prim = self._prim(option)
            if acs.root_trajectory is not None:
                sc = action_builder.build_option_eval_constraints(
                    self.graph, acs, option, travelled, frames,
                    self.config, add_orientation)
            else:
                sc = action_builder.build_step_constraints(
                    self.graph, acs, option, travelled,
                    frames, is_last_step=False, config=self.config)
            _, err = generator.best_of_n(
                self.graph.skeleton, self._draw(option, k), prim,
                generator.device_constraints(sc, self.device),
                **generator.families(self.graph.skeleton, sc))
            errs.append(err)
            self._objective_evaluations += k
        errs = np.nan_to_num(torch.stack(errs).cpu().numpy().astype(
            np.float64), nan=np.inf)
        return options[int(np.argmin(errs))]

    def _count_constrained_step_evals(self):
        """Objective evaluations of a constrained step: the pool, plus the
        LM's residual and probe evaluations when local optimization is on."""
        self._objective_evaluations += int(self.config.get("n_random_samples", 100))
        if self.config.get("local_optimization_mode", "all") != "none":
            self._objective_evaluations += 2 * int(self.config.get("lm_iterations", 10))

    # -- step ----------------------------------------------------------
    def _generate_step(self, acs, node_key, frames, steps, travelled,
                       is_last_step):
        """Select, refine and emit one step, and record it."""
        t_step = time.time()
        profiling.count("request.steps")
        graph = self.graph
        prim = self._prim(node_key)
        skel = graph.skeleton
        use_traj = acs.root_trajectory is not None
        window = self._smoothing_window()
        max_frames = _pad_frames(prim.n_canonical_frames)
        n_samples = int(self.config.get("n_random_samples", 100))
        # with a transition model on the edge, the pool (or an
        # unconstrained step's one latent) comes from its mixture
        tm_gmm = self._transition_gmm(node_key)
        if use_traj:
            sc, loco, loco_flags = action_builder.build_step_constraints(
                graph, acs, node_key, travelled, frames, is_last_step,
                self.config, defer_locomotion=True)
            tf = self.config["trajectory_following_settings"]
            has_prev = float(sc.has_prev) > 0
            scd = generator.device_constraints(sc, self.device)
            common = dict(look_ahead=float(np.float32(
                tf["look_ahead_distance"])),
                n_refine=self._closest_point_refine_iters(acs))
            if not self.config.get("use_constraints", True):
                # every step a plain GMM sample; the arc still advances
                s = self._draw(node_key, 1)[0]
                new_frames, n_frames, new_arc = generator.finalize_step(
                    prim, s, scd, has_prev, self._path(acs), travelled,
                    max_frames, window, use_traj=True, **common)
                err = torch.zeros((), device=self.device)
            else:
                p = generator.selection_params(skel, sc, self.config,
                                               use_dir=loco_flags[1])
                s, err, scd, new_frames, n_frames, new_arc = \
                    generator.generate_step(
                        skel, prim, scd, has_prev,
                        self._pool(node_key, n_samples, tm_gmm), p,
                        travelled, max_frames, window, path=self._path(acs),
                        loco=self._device_loco(loco), loco_flags=loco_flags,
                        **common)
                self._count_constrained_step_evals()
        else:
            sc = action_builder.build_step_constraints(
                graph, acs, node_key, travelled, frames, is_last_step,
                self.config)
            has_prev = float(sc.has_prev) > 0
            scd = generator.device_constraints(sc, self.device)
            has_constraints = (float(np.asarray(sc.kf_active).sum())
                               + float(np.asarray(sc.dir_active))
                               + float(np.asarray(sc.traj_active))
                               + float(np.asarray(sc.ca_active).sum())
                               + float(np.asarray(sc.ts_active))
                               + float(np.asarray(sc.pose_active))) > 0
            has_constraints &= bool(self.config.get("use_constraints", True))
            if has_constraints:
                p = generator.selection_params(skel, sc, self.config)
                s, err, scd, new_frames, n_frames, new_arc = \
                    generator.generate_step(
                        skel, prim, scd, has_prev,
                        self._pool(node_key, n_samples, tm_gmm), p,
                        travelled, max_frames, window)
                self._count_constrained_step_evals()
            else:
                s, new_frames, n_frames, new_arc = \
                    generator.unconstrained_step(
                        prim, self._draw(node_key, 1, tm_gmm)[0], scd,
                        has_prev, travelled, max_frames, window)
                err = torch.zeros((), device=self.device)
        s_np = s.cpu().numpy()
        self._prev_latent = s_np
        self._prev_node_key = node_key
        err = float(err)
        n_frames = int(n_frames)
        new_frames = new_frames[:n_frames].cpu().numpy()
        if use_traj:
            travelled = float(new_arc)

        start_frame = 0 if frames is None else len(frames)
        if frames is None or len(frames) == 0:
            self._start_transform = (np.asarray(sc.start_q),
                                     np.asarray(sc.start_delta))
            frames = new_frames
        else:
            frames = np.concatenate([frames, new_frames], axis=0)

        time_cs = []
        user_cs = []
        for kc in acs.keyframe_constraints.get(node_key[1], []):
            kf = action_builder._label_keyframe(graph, node_key,
                                                kc.keyframe_label,
                                                prim.n_canonical_frames)
            if kf is None:
                continue
            if kc.time is not None:
                time_cs.append((int(kf), float(kc.time)))
            if kc.joint in skel.node_names and not np.all(np.isnan(kc.position)):
                quat_wxyz = None
                if not np.any(np.isnan(kc.orientation)):
                    from ..models.skeleton import _np_from_euler
                    quat_wxyz = tuple(
                        np.asarray(_np_from_euler(kc.orientation, "rxyz"),
                                   np.float64))
                user_cs.append((kc.joint, tuple(np.asarray(kc.position, np.float64)),
                                int(kf), quat_wxyz))
        steps.append(GraphWalkEntry(node_key=node_key, parameters=s_np,
                                    arc_length=travelled,
                                    start_frame=start_frame,
                                    end_frame=len(frames) - 1, error=err,
                                    step_constraints=scd,
                                    time_constraints=tuple(time_cs),
                                    user_constraints=tuple(user_cs),
                                    action_name=acs.action_name))
        self._step_times.append(time.time() - t_step)
        return frames, travelled, err

    def _device_loco(self, loco) -> compiled.LocoSpec:
        """A host LocoSpec (numpy scalars) -> tensors with the set's
        leading [1] axis on the device."""
        def row(v):
            return torch.tensor([float(v)], dtype=torch.float32,
                                device=self.device)
        return compiled.LocoSpec(
            goal_arc=row(loco.goal_arc), half_arc=row(loco.half_arc),
            node=int(loco.node), end_kf=row(loco.end_kf),
            mid_kf=row(loco.mid_kf),
            dim_mask=torch.as_tensor(np.asarray(loco.dim_mask, np.float32),
                                     device=self.device),
            pos_weight=float(loco.pos_weight),
            dir_weight=float(loco.dir_weight))

    def _maybe_optimize_time(self, steps, action_spans):
        """The global time optimization (use_global_time_optimization) of
        steps carrying keyframe times: once per action, over the window of
        its last optimized_actions actions; the steps before the window
        count as their fixed warped frames, and each window sees the
        gammas earlier windows set."""
        if not self.config.get("use_global_time_optimization", True):
            return
        if not any(s.time_constraints for s in steps):
            return
        from . import global_opt
        skel = self.graph.skeleton
        frame_time = skel.frame_time if skel is not None else 1.0 / 30
        settings = self.config["global_time_optimization_settings"]
        n_actions = max(int(settings.get("optimized_actions", 2)), 1)

        def warped_len(step) -> float:
            prim = self._prim(step.node_key)
            gamma = torch.as_tensor(step.parameters[prim.n_spatial:],
                                    device=self.device)
            t_can = timewarp.canonical_time_function(
                prim.mean_t_d, prim.eigen_t_d, gamma)
            return float(t_can[-2] + 2.0)

        for idx, span in enumerate(action_spans):
            lo = action_spans[max(idx - (n_actions - 1), 0)][1]
            window = steps[lo: span[2]]
            constrained = [(i, kf, t) for i, s in enumerate(window)
                           for kf, t in s.time_constraints]
            if not constrained:
                continue
            start_frames = float(sum(warped_len(s) for s in steps[:lo]))
            new_params = global_opt.optimize_time_over_steps(
                [self._prim(s.node_key) for s in window],
                [s.parameters for s in window], constrained, frame_time,
                quality_scale=float(settings.get("quality_scale_factor",
                                                 1e-4)),
                start_frames=start_frames, device=self.device)
            for s, p in zip(window, new_params):
                s.parameters = p

    def _append_padded(self, frames, f, n: int, window: int):
        """Align a padded clip f [M, D] to the motion so far (or place it
        at the start pose) and append its first n rows.  "blending" aligns
        without the offset decay and ramps the seam on the host;
        apply_foot_alignment matches the mean foot XZ across the seam."""
        ss = self.config["smoothing_settings"]
        f = torch.as_tensor(f, dtype=torch.float32, device=self.device)
        if frames is None:
            if self._start_transform is not None:
                q, d = (torch.as_tensor(a, device=self.device)
                        for a in self._start_transform)
                f = align.transform_frames(f, q, d)
            return f[:n].cpu().numpy()
        method = ss.get("spatial_smoothing_method", "smoothing")
        aligned = align.align_clip(
            torch.as_tensor(frames[-1], dtype=torch.float32,
                            device=self.device), f,
            0 if method == "blending" else window)[:n].cpu().numpy()
        if ss.get("apply_foot_alignment", False):
            aligned = self._foot_align(frames[-1], aligned)
        if method == "blending" and window > 0:
            frames, aligned = align.blend_seam_np(frames, aligned, window)
        return np.concatenate([frames, aligned], axis=0)

    def _foot_align(self, prev_last, aligned):
        """Shift the new clip in XZ so its first-frame mean foot position
        matches the previous frame's."""
        from ..models import skeleton as sk
        from .grounding import LEFT_FOOT, RIGHT_FOOT
        skel = self.graph.skeleton
        if skel is None:
            return aligned
        feet = [j for j in (LEFT_FOOT, RIGHT_FOOT) if j in skel.node_names]
        if not feet or prev_last.shape[-1] != skel.n_frame_params \
                or aligned.shape[-1] != skel.n_frame_params:
            return aligned
        idx = [skel.index_of(j) for j in feet]
        pts = sk.fk_positions(skel, torch.as_tensor(
            np.stack([prev_last, aligned[0]]), dtype=torch.float32,
            device=self.device)).cpu().numpy()
        delta = (pts[0][idx].mean(axis=0) - pts[1][idx].mean(axis=0))
        aligned = aligned.copy()
        aligned[:, 0] += delta[0]
        aligned[:, 2] += delta[2]
        return aligned

    def _post_process(self, frames, steps):
        """The keyframe IK edits of the steps' user constraints, the
        trajectory IK edits of the "ik" mode's collision-avoidance
        trajectories over their actions' output frames, and grounding."""
        if frames is None or len(frames) == 0:
            return frames
        from . import postprocess
        ik_settings = self.config.get("inverse_kinematics_settings", {})
        constraint_specs = {}
        for i, step in enumerate(steps):
            if step.user_constraints:
                constraint_specs[i] = [
                    (joint, np.asarray(pos), kf,
                     None if ori is None else np.asarray(ori))
                    for joint, pos, kf, ori in step.user_constraints]
        ik_constraints = postprocess.create_ik_constraints(
            self.graph, steps, constraint_specs,
            constrain_place_orientation=bool(
                ik_settings.get("constrain_place_orientation", False))
        ) if constraint_specs else []
        skel = self.graph.skeleton
        ik_trajectories = []
        for trajs, i0, i1 in self._ca_ik_spans:
            sf, ef = steps[i0].start_frame, steps[i1 - 1].end_frame
            ik_trajectories += [postprocess.IKTrajectoryConstraint(
                joint=t.joint, spline=spline_path.build(
                    t.control_points, max_points=spline_path.MAX_PATH_POINTS,
                    unconstrained_dims=t.unconstrained_dims),
                start_frame=sf, end_frame=ef, fixed_range=False,
                unconstrained_dims=tuple(t.unconstrained_dims))
                for t in trajs if t.joint in skel.node_names]
        return postprocess.post_process_motion(
            skel, frames, steps, ik_constraints, self.config,
            scene=self.scene_interface, ik_trajectories=ik_trajectories,
            device=self.device)

    # -- final conversion ----------------------------------------------
    def _convert_with_time_warp(self, steps,
                                complete_motion_vector: bool = False) -> np.ndarray:
        """Re-project every step with its time warp (the frame-emit kernel
        on a CUDA device), expand it to the full skeleton with
        complete_motion_vector, and re-concatenate; each step's frame
        range is remapped onto the warped buffer."""
        from ..models.skeleton import add_fixed_joint_parameters_to_motion
        skel = self.graph.skeleton
        frames = None
        ss = self.config["smoothing_settings"]
        smooth_time = bool(ss.get("time_smoothing", False)
                           or self.config.get("smooth_time_parameters", False))
        time_window = int(ss.get("time_smoothing_window", 15))
        use_time = bool(self.config.get("activate_time_variation", True))
        window = self._smoothing_window()
        for step in steps:
            prim = self._prim(step.node_key)
            max_frames = _pad_frames(prim.n_canonical_frames * 2)
            s = torch.as_tensor(step.parameters, device=self.device)
            f, n, t_fn = prim_mod.back_project(prim, s, max_frames=max_frames,
                                               use_time=use_time)
            n = int(n)
            if use_time and smooth_time and prim.has_time:
                # savgol-filter the sampled time function, then evaluate
                # the spatial spline at the smoothed times (padded with the
                # last time to the static length)
                t_s = timewarp.smooth_time_function_np(
                    t_fn.cpu().numpy()[:n], window=time_window)
                t_pad = np.concatenate(
                    [t_s, np.full(max_frames - n, t_s[-1], t_s.dtype)])
                f = prim_mod.evaluate_at(prim, s, torch.as_tensor(
                    t_pad, dtype=torch.float32, device=self.device))
            if (complete_motion_vector and skel is not None
                    and f.shape[-1] < skel.n_frame_params):
                f = add_fixed_joint_parameters_to_motion(
                    skel, f.cpu().numpy(), prim.animated_joints or None)
            frames = self._append_padded(frames, f, n, window)
            step.start_frame = len(frames) - n
            step.end_frame = len(frames) - 1
        if frames is None:
            return np.zeros((0, 0), np.float32)
        root_window = int(ss.get("root_filter_window", 0))
        if root_window > 1:
            frames = align.filter_root_np(frames, root_window)
        return frames


def _pad_frames(n: int, multiple: int = 32) -> int:
    """Round a frame count up to a multiple (the JAX package's buffer
    sizes, kept so frames and time functions match it row for row)."""
    return ((n + multiple - 1) // multiple) * multiple
