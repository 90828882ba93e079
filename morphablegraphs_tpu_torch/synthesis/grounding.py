"""Foot grounding (port of morphablegraphs_tpu.synthesis.grounding, the
part the request path reads): the foot joint names, the stance/swing model
per walk primitive (`MP_CONFIGURATIONS`, read by the foot-plant
constraints) and the height query adapter.  `ground_motion` is not ported:
`MotionGenerator` refuses activate_motion_grounding."""

from __future__ import annotations

from typing import Callable, Dict, Optional

LEFT_FOOT = "LeftFoot"
RIGHT_FOOT = "RightFoot"
LEFT_TOE = "LeftToeBase"
RIGHT_TOE = "RightToeBase"

# Stance/swing model per walk primitive
# (reference motion_primitive_grounding.py:43-120)
MP_CONFIGURATIONS: Dict[str, dict] = {
    "leftStance": {"start_stance_foot": "right", "stance_foot": "right",
                   "swing_foot": "left", "end_stance_foot": "left",
                   "stance_mode": "toe", "start_window_size": 10,
                   "end_window_size": 10},
    "rightStance": {"start_stance_foot": "left", "stance_foot": "left",
                    "swing_foot": "right", "end_stance_foot": "right",
                    "stance_mode": "toe", "start_window_size": 10,
                    "end_window_size": 10},
    "beginLeftStance": {"start_stance_foot": "both", "stance_foot": "right",
                        "swing_foot": "left", "end_stance_foot": "left",
                        "stance_mode": "toe", "start_window_size": 10,
                        "end_window_size": 10},
    "beginRightStance": {"start_stance_foot": "both", "stance_foot": "left",
                         "swing_foot": "right", "end_stance_foot": "right",
                         "stance_mode": "toe", "start_window_size": 10,
                         "end_window_size": 10},
    "endRightStance": {"start_stance_foot": "left", "stance_foot": "left",
                       "swing_foot": "right", "end_stance_foot": "both",
                       "stance_mode": "none", "start_window_size": 10,
                       "end_window_size": 10},
    "endLeftStance": {"start_stance_foot": "right", "stance_foot": "right",
                      "swing_foot": "left", "end_stance_foot": "both",
                      "stance_mode": "none", "start_window_size": 10,
                      "end_window_size": 10},
    "turnLeftRightStance": {"start_stance_foot": "both", "stance_foot": "left",
                            "swing_foot": "right", "end_stance_foot": "right",
                            "stance_mode": "none", "start_window_size": 20,
                            "end_window_size": 20},
    "turnRightLeftStance": {"start_stance_foot": "both", "stance_foot": "right",
                            "swing_foot": "left", "end_stance_foot": "left",
                            "stance_mode": "none", "start_window_size": 20,
                            "end_window_size": 20},
}


class SceneInterface:
    """Height query adapter (reference motion_generator/scene_interface.py)."""

    def __init__(self, height_fn: Optional[Callable] = None,
                 constant_height: float = 0.0):
        self.height_fn = height_fn
        self.constant_height = constant_height
        self.offset = [0.0, 0.0]

    def set_scene(self, scene) -> None:
        """Install a height source: anything with .get_height(x, z) or a
        plain callable (reference scene_interface.py set_scene)."""
        self.height_fn = getattr(scene, "get_height", scene)

    def set_offset(self, x: float, z: float) -> None:
        self.offset = [float(x), float(z)]

    def get_height(self, x: float, z: float) -> float:
        x += self.offset[0]
        z += self.offset[1]
        if self.height_fn is not None:
            return float(self.height_fn(x, z))
        return self.constant_height
