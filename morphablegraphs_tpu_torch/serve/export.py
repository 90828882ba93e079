"""Result export: BVH, Unity JSON, annotations and events (port of
morphablegraphs_tpu.serve.export).

Replaces reference motion_generator/annotated_motion_vector.py:31-129 and
keyframe_event_list.py:31-239.  Host code on the result's numpy frames;
the collision-avoidance visualization's FK runs on the card unless it is
given another device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from ..models.skeleton import Skeleton, fk_positions, write_bvh
from ..utils import device as device_mod


@dataclasses.dataclass
class KeyframeEvent:
    """Event attached to an output keyframe (reference
    constraints/keyframe_event.py:26-78)."""

    keyframe: int
    event: str  # attach / detach / transfer / ...
    parameters: dict


# Actions whose placed object is rotated by the engine after detach
# (reference graph_walk.py:41 DEFAULT_PLACE_ACTION_LIST — semantic constant,
# shared with the IK-orientation gate in synthesis/postprocess.py)
from ..synthesis.postprocess import PLACE_ACTION_LIST as DEFAULT_PLACE_ACTION_LIST


class AnnotatedMotion:
    """Final synthesis product: frames + events + annotations (reference
    AnnotatedMotionVector)."""

    def __init__(self, skeleton: Skeleton, frames: np.ndarray,
                 action_ranges: Optional[List[tuple]] = None,
                 events: Optional[List[KeyframeEvent]] = None,
                 mg_input: Optional[dict] = None,
                 collision_content: Optional[dict] = None):
        self.skeleton = skeleton
        self.frames = np.asarray(frames)
        self.action_ranges = action_ranges or []
        self.events = events or []
        self.mg_input = mg_input
        # CA visualization payload (reference keyframe_event_list.py:47-49)
        self.collision_content = collision_content

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    # -- BVH -----------------------------------------------------------
    def generate_bvh_string(self) -> str:
        return write_bvh(self.skeleton, self.frames)

    def export(self, output_filename: str):
        """BVH + annotation sidecar files (reference export, :43-56:
        <name>.bvh, <name>_annotations.json, <name>_actions.json)."""
        write_bvh(self.skeleton, self.frames, output_filename + ".bvh")
        with open(output_filename + "_annotations.json", "w") as f:
            json.dump(self.frame_annotation(), f, indent=1)
        with open(output_filename + "_actions.json", "w") as f:
            json.dump(self.keyframe_events_dict(), f, indent=1)
        if self.mg_input is not None:
            with open(output_filename + ".json", "w") as f:
                json.dump(self.mg_input, f, indent=1)

    # -- annotations (reference keyframe_event_list.py) ----------------
    def frame_annotation(self) -> dict:
        seq = [{"elementaryAction": name, "startFrame": start, "endFrame": end}
               for name, start, end in self.action_ranges]
        return {"elementaryActionSequence": seq}

    def keyframe_events_dict(self) -> dict:
        events: dict = {}
        for e in self.events:
            events.setdefault(str(e.keyframe), []).append(
                {"event": e.event, "parameters": e.parameters})
        out = {"events": events,
               "elementaryActionSequence":
                   self.frame_annotation()["elementaryActionSequence"]}
        if self.collision_content is not None:
            # reference update_events: keyframe_events_dict["collisionContent"]
            out["collisionContent"] = self.collision_content
        return out

    # -- Unity JSON (reference to_unity_format, :69-112) ---------------
    def to_unity_format(self, scale: float = 1.0) -> dict:
        skel = self.skeleton
        animated = [n for n in skel.node_names if not n.endswith("_EndSite")]
        # frame-invariant joint -> quat-slot table, computed ONCE (an
        # index()/membership scan per frame per joint is O(T*J^2) host work)
        anim_idx = {n: i for i, n in enumerate(skel.animated_joints)}
        slots = [anim_idx.get(name, -1) for name in animated]
        unity_frames = []
        for frame in self.frames:
            rotations = []
            t = frame[:3] * scale
            # right-handed -> Unity left-handed: negate x
            root_t = {"x": float(-t[0]), "y": float(t[1]), "z": float(t[2])}
            for i in slots:
                if i >= 0:
                    r = frame[3 + 4 * i: 7 + 4 * i]
                    rotations.append({"x": float(-r[1]), "y": float(r[2]),
                                      "z": float(r[3]), "w": float(-r[0])})
                else:
                    rotations.append({"x": 0.0, "y": 0.0, "z": 0.0, "w": -1.0})
            unity_frames.append({"rotations": rotations, "rootTranslation": root_t})
        out = {"frames": unity_frames,
               "frameTime": skel.frame_time,
               "jointSequence": animated}
        if self.events:
            out["events"] = [{"eventName": e.event,
                              "eventTarget": e.parameters.get("target"),
                              "keyframe": e.keyframe} for e in self.events]
        return out


def events_from_result(graph, result, annotations_per_action,
                       add_rotate_events: bool = False,
                       constraints_per_action=None) -> List[KeyframeEvent]:
    """Map keyframe annotations (attach/detach, reference
    keyframe_event_list._create_events_from_keyframe_constraints) onto output
    frame indices via each step's frame range.

    With add_rotate_events (reference keyframe_event_list.py:110-142
    _add_empty_rotate_events_for_detach, gated there on NOT
    constrain_place_orientation): every detach event of a place action whose
    source keyframe constraint carries an orientation gets a paired 'rotate'
    event one frame earlier with an empty relativeOrientation the engine
    fills after IK.  (The reference's attach branch at :134 is dead code —
    the outer loop admits detach events only.)  constraints_per_action:
    per-action list of parsed KeyframeConstraintSpec (input_reader) used to
    look up the constraint orientation by keyframe label."""
    events: List[KeyframeEvent] = []
    for action_idx, ((action_name, start_f, end_f), annotations) in enumerate(
            zip(result.action_ranges, annotations_per_action)):
        action_steps = [s for s in result.steps
                        if s.node_key[0] == action_name
                        and start_f <= s.start_frame < max(end_f, start_f + 1)]
        for label, ann in annotations.items():
            # find the step whose primitive carries this label
            target_step = None
            keyframe = None
            for s in action_steps:
                group = graph.node_groups[s.node_key[0]]
                prim = graph.nodes[s.node_key].primitive
                kf = group.map_label_to_keyframe(s.node_key[1], label,
                                                 prim.n_canonical_frames)
                if kf is None:
                    kf = prim.keyframe_for_label(label)
                if kf is not None:
                    target_step, keyframe = s, kf
                    break
            if target_step is None:
                continue
            prim = graph.nodes[target_step.node_key].primitive
            n_can = max(prim.n_canonical_frames - 1, 1)
            span = target_step.end_frame - target_step.start_frame
            out_frame = target_step.start_frame + int(round(keyframe / n_can * span))
            for a in ann.get("annotations", []):
                ev = KeyframeEvent(keyframe=out_frame,
                                   event=a.get("event", ""),
                                   parameters=a.get("parameters", {}))
                events.append(ev)
                if (add_rotate_events and ev.event == "detach"
                        and action_name in DEFAULT_PLACE_ACTION_LIST):
                    rot = _rotate_event_for_detach(
                        ev, label,
                        (constraints_per_action[action_idx]
                         if constraints_per_action else []))
                    if rot is not None:
                        events.append(rot)
    return events


def _rotate_event_for_detach(detach: KeyframeEvent, label: str,
                             constraint_specs) -> Optional[KeyframeEvent]:
    """'rotate' twin of a detach event (reference keyframe_event_list.py
    :110-142): requires a source constraint with a set orientation; the
    payload carries the global orientation, an empty relative orientation
    and the detach keyframe as reference."""
    orientation = None
    for spec in constraint_specs:
        if (spec.keyframe_label == label
                and not np.all(np.isnan(spec.orientation))):
            orientation = [None if np.isnan(v) else float(v)
                           for v in spec.orientation]
            break
    if orientation is None:
        return None
    return KeyframeEvent(
        keyframe=max(detach.keyframe - 1, 0), event="rotate",
        parameters={"target": detach.parameters.get("target"),
                    "joint": detach.parameters.get("joint"),
                    "globalOrientation": orientation,
                    "relativeOrientation": [None, None, None],
                    "referenceKeyframe": int(detach.keyframe)})


def collision_vis_data_from_result(skeleton: Skeleton, result,
                                   device=None) -> dict:
    """CA visualization payload (reference keyframe_event_list.py:219-239
    _create_collision_data_from_ca_constraints): for every active CA slot of
    every step, the output keyframe where the constrained joint passes
    closest to the CA target, mapped to the joint names at that keyframe.
    One batched FK per step on `device` (CUDA unless named) instead of the
    reference's per-frame get_global_position loop."""
    dev = device_mod.resolve(device, "collision_vis_data_from_result")
    out: dict = {}
    for step in result.steps:
        sc = step.step_constraints
        if sc is None:
            continue
        ca_active = np.asarray(sc.ca_active)
        if ca_active.sum() <= 0:
            continue
        fr = result.frames[step.start_frame:step.end_frame + 1]
        if len(fr) == 0 or fr.shape[-1] != skeleton.n_frame_params:
            continue
        pts = fk_positions(skeleton, torch.as_tensor(
            np.asarray(fr, np.float32), device=dev)).cpu().numpy()
        nodes = np.asarray(sc.ca_node)
        targets = np.asarray(sc.ca_pos)
        masks = np.asarray(sc.ca_pos_mask)
        for slot in range(len(ca_active)):
            if ca_active[slot] <= 0:
                continue
            d = (pts[:, int(nodes[slot])] - targets[slot]) * masks[slot]
            kf = step.start_frame + int(np.argmin(np.sum(d * d, axis=-1)))
            out.setdefault(kf, []).append(
                skeleton.node_names[int(nodes[slot])])
    return out
