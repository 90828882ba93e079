"""Algorithm configuration schema + defaults.

Mirrors the reference's two-tier config (SURVEY.md §5 "Config / flag system"):
`DEFAULT_ALGORITHM_CONFIG` keys/values match reference
motion_generator/algorithm_configuration.py:141-257 so the reference's preset
files (examples/config/*_algorithm.config) load unchanged.
"""

from __future__ import annotations

import copy
import json


DEFAULT_ALGORITHM_CONFIG = {
    "smoothing_settings": {
        "spatial_smoothing": True,
        "time_smoothing": False,
        "spatial_smoothing_method": "smoothing",
        "spatial_smoothing_window": 20,
        "time_smoothing_window": 15,
        "apply_foot_alignment": False,
        "root_filter_window": 0,
    },
    "trajectory_following_settings": {
        "spline_type": 0,
        "control_point_filter_threshold": 0,
        "dir_constraint_factor": 0.8,
        "heuristic_step_length_factor": 1.0,
        "position_constraint_factor": 1.0,
        "step_length_approx_method": "arc_length",
        "transition_pose_constraint_factor": 0.6,
        "closest_point_search_accuracy": 0.001,
        "closest_point_search_max_iterations": 5000,
        "look_ahead_distance": 100,
        "end_step_length_factor": 1.0,
        "max_distance_to_path": 500,
        "arc_length_granularity": 1000,
        "use_transition_constraint": False,
        "spline_super_sampling_factor": 20,
        "constrain_start_orientation": True,
        "constrain_transition_orientation": True,
        "generate_half_step_constraint": False,
        "generate_foot_plant_constraints": False,
    },
    "local_optimization_settings": {
        "start_error_threshold": 0.0,
        "error_scale_factor": 1.0,
        "spatial_epsilon": 0.0,
        "quality_scale_factor": 0.1,
        "tolerance": 0.05,
        "method": "leastsq",
        "max_iterations": 500,
        "verbose": False,
        "diff_eps": 1.0,
    },
    "global_spatial_optimization_settings": {
        "max_steps": 3,
        "start_error_threshold": 4.0,
        "error_scale_factor": 1.0,
        "quality_scale_factor": 100.0,
        "tolerance": 0.05,
        "method": "leastsq",
        "max_iterations": 500,
        "position_weight": 1000.0,
        "orientation_weight": 1000.0,
        "verbose": False,
        "diff_eps": 2.0,
    },
    "global_time_optimization_settings": {
        "error_scale_factor": 1.0,
        "quality_scale_factor": 0.0001,
        "tolerance": 0.05,
        "method": "L-BFGS-B",
        "max_iterations": 500,
        "optimized_actions": 2,
        "verbose": False,
        "diff_eps": 1.0,
    },
    "inverse_kinematics_settings": {
        "tolerance": 0.05,
        "optimization_method": "L-BFGS-B",
        "max_iterations": 1000,
        "interpolation_window": 120,
        "transition_window": 60,
        "use_euler_representation": False,
        "solving_method": "unconstrained",
        "activate_look_at": True,
        "max_retries": 5,
        "success_threshold": 5.0,
        "optimize_orientation": True,
        "elementary_action_max_iterations": 5,
        "elementary_action_optimization_eps": 1.0,
        "adapt_hands_during_carry_both": True,
        "constrain_place_orientation": False,
        "activate_blending": True,
    },
    "motion_grounding_settings": {
        "activate_blending": True,
        "generate_foot_plant_constraints": True,
        "foot_lift_search_window": 40,
        "foot_lift_tolerance": 3.0,
        "graph_walk_grounding_window": 4,
        "contact_tolerance": 1.0,
        "constraint_range": 10,
        "smoothing_constraints_window": 8,
        "damp_angle": 0.01,
        "damp_factor": 1.0,
    },
    "n_random_samples": 100,
    "average_elementary_action_error_threshold": 500,
    "constrained_sampling_mode": "random_discrete",
    "activate_inverse_kinematics": True,
    "activate_motion_grounding": False,
    "n_cluster_search_candidates": 4,
    "use_transition_model": False,
    "local_optimization_mode": "all",
    "activate_parameter_check": False,
    "use_global_time_optimization": True,
    "global_spatial_optimization_mode": "none",
    "collision_avoidance_constraints_mode": "direct_connection",
    "optimize_collision_avoidance_constraints_extra": False,
    "use_constrained_gmm": False,
    "use_constraints": True,
    "use_local_coordinates": False,
    "use_semantic_annotation_with_mgrd": False,
    "activate_time_variation": True,
    "debug_max_step": -1,
    "verbose": False,
    # TPU-specific knobs (not in the reference)
    "lm_iterations": 10,
    "planner_samples_per_option": 10,
    # multi-start local optimization: refine the k best pool candidates
    # with ONE vmapped LM and keep the best converged latent.  1 preserves
    # the reference's refine-the-single-best semantics
    # (motion_primitive_generator.py:149-155); >1 is a TPU-native quality
    # extension (batched starts are nearly free on the vector units) that
    # de-noises the pool-luck dependence of the converged error.
    "n_lm_starts": 1,
}


# Accepted-but-inert keys: setting these changes nothing in this package.
# Each entry carries its disposition (the full per-key audit, including the
# reference consumption site for every key, lives in PARITY.md "Algorithm
# config audit").  load_config warns when a preset sets one of these to a
# non-default value so a user porting a reference config is never silently
# surprised.  Dispositions: "dead-in-reference" = the reference loads but
# never consumes it either; "superseded" = the repo's design makes the knob
# meaningless (reason given); "pending" = real reference behavior not yet
# implemented here.
INERT_KEYS = {
    "smoothing_settings.apply_foot_alignment": None,  # wired (live)
    "trajectory_following_settings.spline_type":
        "superseded: single Catmull-Rom spline family (reference "
        "action_constraints_builder.py:66 selects a b-spline degree)",
    "trajectory_following_settings.step_length_approx_method":
        "dead-in-reference",
    "trajectory_following_settings.max_distance_to_path":
        "dead-in-reference",
    "trajectory_following_settings.spline_super_sampling_factor":
        "superseded: analytic Catmull-Rom tangents need no discrete "
        "super-sampling (reference parameterized_spline.py:41-76)",
    "trajectory_following_settings.generate_foot_plant_constraints":
        None,  # wired (live): foot goals replace the root goal
    "local_optimization_settings.spatial_epsilon": "dead-in-reference",
    "local_optimization_settings.tolerance":
        "superseded: fixed-iteration exact-Jacobian LM (lm_iterations)",
    "local_optimization_settings.method":
        "superseded: jacfwd-LM replaces scipy leastsq/BFGS",
    "local_optimization_settings.max_iterations":
        "superseded: budget knob is lm_iterations",
    "local_optimization_settings.verbose": "cosmetic (use top-level verbose)",
    "local_optimization_settings.diff_eps":
        "superseded: exact gradients, no finite differences",
    "global_spatial_optimization_settings.tolerance":
        "superseded: fixed-iteration LM",
    "global_spatial_optimization_settings.method":
        "superseded: jacfwd-LM replaces scipy",
    "global_spatial_optimization_settings.max_iterations":
        "superseded: fixed-iteration LM",
    "global_spatial_optimization_settings.orientation_weight":
        None,  # wired (live): trajectory_end-mode dir-slot weight
        # (global_opt.adapt_constraint_weights)
    "global_spatial_optimization_settings.verbose": "cosmetic",
    "global_spatial_optimization_settings.diff_eps":
        "superseded: exact gradients",
    "global_time_optimization_settings.tolerance":
        "superseded: fixed-iteration optimizer",
    "global_time_optimization_settings.method":
        "superseded: native optimizer replaces scipy L-BFGS-B",
    "global_time_optimization_settings.max_iterations":
        "superseded: fixed-iteration optimizer",
    "global_time_optimization_settings.optimized_actions":
        None,  # wired (live): per-action time-opt window
        # (MotionGenerator._maybe_optimize_time)
    "global_time_optimization_settings.verbose": "cosmetic",
    "global_time_optimization_settings.diff_eps":
        "superseded: exact gradients",
    "inverse_kinematics_settings.tolerance":
        "superseded: fixed-budget DLS-IK",
    "inverse_kinematics_settings.optimization_method":
        "superseded: DLS/CCD replaces scipy minimize",
    "inverse_kinematics_settings.use_euler_representation":
        "dead-in-reference (legacy)",
    "inverse_kinematics_settings.solving_method":
        "superseded: DLS/CCD replaces scipy minimize",
    "inverse_kinematics_settings.activate_look_at":
        "covered by the streaming planner settings (state_planner)",
    "inverse_kinematics_settings.max_retries":
        "superseded: deterministic DLS needs no restarts",
    "inverse_kinematics_settings.success_threshold":
        "superseded: deterministic DLS needs no restarts",
    "inverse_kinematics_settings.optimize_orientation":
        None,  # wired (live): gates orientation application in
        # postprocess.apply_ik_constraints
    "inverse_kinematics_settings.elementary_action_max_iterations":
        "superseded: single-pass IK edit",
    "inverse_kinematics_settings.elementary_action_optimization_eps":
        "superseded: single-pass IK edit",
    "inverse_kinematics_settings.adapt_hands_during_carry_both":
        "covered by hand_pose carry handling",
    "inverse_kinematics_settings.constrain_place_orientation":
        None,  # wired (live): place/insert/screw actions drop IK
        # orientation unless set (MotionGenerator._post_process)
    # motion_grounding_settings keys are wired (live) into
    # synthesis/grounding.py's footplant constraint generation:
    # detect_ground_contacts (contact_tolerance, foot_lift_tolerance,
    # foot_lift_search_window, smoothing_constraints_window),
    # generate_foot_plant_constraints (constraint_range,
    # graph_walk_grounding_window) and apply_grounding_constraints
    # (activate_blending); generate_foot_plant_constraints toggles the
    # detector vs the stance-table path in ground_motion.
    "motion_grounding_settings.damp_angle":
        "superseded: DLS damping is fixed per kernel",
    "motion_grounding_settings.damp_factor":
        "superseded: DLS damping is fixed per kernel",
    "average_elementary_action_error_threshold": "dead-in-reference",
    "n_cluster_search_candidates":
        "superseded: exact vmapped cluster-data argmin (no beam)",
    "activate_parameter_check": "dead-in-reference",
# collision_avoidance_constraints_mode is LIVE since round 5: CA slots
# always evaluate inline during selection/LM (reference behavior is
# likewise mode-independent there), and mode "ik" ADDITIONALLY converts
# each action's CA trajectories to IK trajectory constraints solved in
# the post-pass (reference graph_walk.py:247-248 + :277-297;
# synthesis/postprocess.apply_ik_trajectory_constraints).
    "use_constrained_gmm": "dead-in-reference (set, never read)",
    "use_local_coordinates":
        "superseded: per-candidate aligning transform inside evaluation",
    "use_semantic_annotation_with_mgrd": "n/a: mgrd-only",
}
INERT_KEYS = {k: v for k, v in INERT_KEYS.items() if v is not None}


def default_config() -> dict:
    return copy.deepcopy(DEFAULT_ALGORITHM_CONFIG)


def _lookup(d: dict, dotted: str):
    cur = d
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None, False
        cur = cur[part]
    return cur, True


def warn_inert_keys(preset: dict, source: str = "config") -> list:
    """Log every accepted-but-inert key (INERT_KEYS) that a preset sets to
    a value other than its default.  -> the (dotted key, disposition)
    pairs that fired."""
    from .log import write_message_to_log
    fired = []
    for dotted, why in INERT_KEYS.items():
        val, present = _lookup(preset, dotted)
        if not present:
            continue
        default, _ = _lookup(DEFAULT_ALGORITHM_CONFIG, dotted)
        if val != default:
            fired.append((dotted, why))
            write_message_to_log(
                f"{source}: '{dotted}' = {val!r} is accepted but has no "
                f"effect ({why})")
    return fired


def load_config(path: str) -> dict:
    """A preset file (the reference's `*_algorithm.config` JSON) merged over
    the defaults, nested dicts key by key (reference mg_rest_interface.py
    `load_algorithm_settings`); the inert keys it sets are logged."""
    cfg = default_config()
    with open(path) as f:
        preset = json.load(f)
    warn_inert_keys(preset, source=path)
    _merge(cfg, preset)
    return cfg


def _merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
