"""Thread-safe motion state queue for interactive/streaming synthesis (port
of morphablegraphs_tpu.synthesis.state_queue).

Replaces reference motion_generator/mg_state_queue.py:48-301: the planner
thread pushes aligned motion states, the consumer (a game engine bridge)
pops them and streams frames.  Entries hold numpy frames, since the
consumer is on the host; a state is aligned to the pose buffer on the
queue's device (`align.align_clip`) and copied to the host once.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np
import torch

from ..models.skeleton import Skeleton
from ..ops import align, quat
from ..utils import device as device_mod


@dataclasses.dataclass
class MotionState:
    """Playback buffer (anim_utils MotionState subset used by the server)."""

    frames: np.ndarray
    frame_time: float
    frame_idx: int = 0

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def update(self, dt: float) -> bool:
        """Advance playback; returns False when finished."""
        self.frame_idx += max(int(round(dt / self.frame_time)), 1)
        return self.frame_idx < self.n_frames

    def get_pose(self) -> np.ndarray:
        return self.frames[min(self.frame_idx, self.n_frames - 1)]


@dataclasses.dataclass
class StateQueueEntry:
    """reference mg_state_queue.py:48-58.

    events / hold_frames carry engine-facing metadata from streaming frame
    constraints (reference generate_constrained_frames :528-535: keyframe
    events grouped by frame index, plus the frames a held joint pins)."""

    node_key: tuple
    node_type: str
    state: MotionState
    pose_buffer: List[np.ndarray]
    events: dict = dataclasses.field(default_factory=dict)
    hold_frames: tuple = ()


class MGStateQueue:
    """reference mg_state_queue.py:59-160 (mutex-guarded deque).  It
    aligns states on the CUDA device unless given device="cpu"."""

    def __init__(self, skeleton: Skeleton, frame_time: float,
                 blend_window: int = 20, buffer_size: int = 10,
                 device=None):
        self.skeleton = skeleton
        self.frame_time = frame_time
        self.blend_window = blend_window
        self.buffer_size = buffer_size
        self.device = device_mod.resolve(device, "MGStateQueue")
        self._queue: List[StateQueueEntry] = []
        self._mutex = threading.Lock()

    # -- queue ops -----------------------------------------------------
    def append(self, entry: StateQueueEntry):
        with self._mutex:
            self._queue.append(entry)

    def pop(self, keep: int = 0) -> Optional[StateQueueEntry]:
        """The oldest entry, or None while no more than `keep` are queued.
        A consumer streaming alongside the planner's worker pops with
        keep=1: the planner reads the newest entry (the next action
        starts from it, the end corrections edit it), and a queue the
        consumer drained would change what the planner generates."""
        with self._mutex:
            if len(self._queue) > keep:
                return self._queue.pop(0)
        return None

    def peek(self) -> Optional[StateQueueEntry]:
        with self._mutex:
            return self._queue[0] if self._queue else None

    def __len__(self):
        with self._mutex:
            return len(self._queue)

    def clear(self):
        with self._mutex:
            self._queue.clear()

    def pop_last_state(self) -> Optional[StateQueueEntry]:
        """Remove and return the NEWEST entry (reference pop_last_state —
        used by the planner's overstepping abort)."""
        with self._mutex:
            if self._queue:
                return self._queue.pop()
        return None

    def get_last_state(self) -> Optional[StateQueueEntry]:
        with self._mutex:
            return self._queue[-1] if self._queue else None

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -- state construction (reference build_state :108-130) -----------
    def build_state(self, frames: np.ndarray,
                    pose_buffer: Optional[List[np.ndarray]],
                    ignore_rotation: bool = False) -> MotionState:
        frames = np.asarray(frames, np.float32)
        if pose_buffer:
            prev_last = np.asarray(pose_buffer[-1], np.float32).copy()
            if ignore_rotation:
                # skip ROTATIONAL alignment (translation-only): make the
                # aligning heading delta zero by giving prev the new clip's
                # own root orientation — an identity prev quat would instead
                # ROTATE the clip to world heading zero
                prev_last[3:7] = frames[0][3:7]
            aligned = align.align_clip(self._tensor(prev_last),
                                       self._tensor(frames),
                                       self.blend_window).cpu().numpy()
        else:
            aligned = frames
        return MotionState(frames=aligned, frame_time=self.frame_time)

    def add_state(self, node_key: tuple, node_type: str, frames: np.ndarray,
                  pose_buffer: Optional[List[np.ndarray]],
                  ignore_rotation: bool = False, events: Optional[dict] = None,
                  hold_frames: tuple = ()):
        state = self.build_state(frames, pose_buffer,
                                 ignore_rotation=ignore_rotation)
        new_buffer = (list(pose_buffer) if pose_buffer else []) + list(state.frames)
        new_buffer = new_buffer[-self.buffer_size:]
        entry = StateQueueEntry(node_key, node_type, state, new_buffer,
                                events=dict(events or {}),
                                hold_frames=tuple(hold_frames))
        self.append(entry)
        return entry

    # -- corrections (reference :198-260) -------------------------------
    def apply_end_orientation_correction(self, frames: np.ndarray,
                                         target_dir_xz: np.ndarray,
                                         window: Optional[int] = None) -> np.ndarray:
        """Slerp-blend the root orientation toward a target heading over the
        final `window` frames, all of them in one batched pass."""
        frames = np.asarray(frames, np.float32).copy()
        n = len(frames)
        # clamp to the state's frame count (reference :206 blend_range =
        # min(end_target_blend_range, n_frames)) — an unclamped window
        # would shift frame 0 and pop the seam with the previous state
        window = min(window or self.blend_window, n)
        target_angle = float(np.arctan2(target_dir_xz[0], target_dir_xz[1]))
        lo = max(n - window, 0)
        if lo >= n:
            return frames
        t = np.array([(i - (n - window)) / max(window - 1, 1)
                      for i in range(lo, n)], np.float32)
        cur_q = self._tensor(frames[lo:, 3:7])
        # the heading difference is taken in float64 from the float32
        # heading, as the JAX package's host loop does
        cur_angle = align.heading_angle(cur_q).double()
        dq = quat.about_y((target_angle - cur_angle).float())
        target_q = quat.multiply(dq, cur_q)
        frames[lo:, 3:7] = quat.slerp(cur_q, target_q,
                                      self._tensor(t)).cpu().numpy()
        return frames

    def apply_end_pos_correction(self, frames: np.ndarray,
                                 target_pos: np.ndarray,
                                 window: Optional[int] = None) -> np.ndarray:
        """Linear-blend the root XZ position toward a target over the final
        window (reference :228-260)."""
        frames = np.asarray(frames, np.float32).copy()
        n = len(frames)
        # reference :238: blend_range = min(end_target_blend_range, n_frames)
        window = min(window or self.blend_window, n)
        delta = np.asarray(target_pos, np.float32) - frames[-1, :3]
        delta[1] = 0.0
        for i in range(max(n - window, 0), n):
            t = (i - (n - window)) / max(window - 1, 1)
            frames[i, :3] += delta * t
        return frames

    def generate_idle_state(self, idle_frames: np.ndarray,
                            pose_buffer: Optional[List[np.ndarray]],
                            node_key=("walk", "idle"),
                            ignore_rotation: bool = False) -> StateQueueEntry:
        """reference :160-197: hold an idle clip aligned to the buffer.
        ignore_rotation mirrors the reference's `ignore_idle_rotation`
        setting: idle clips keep their own heading (translation-only
        alignment)."""
        return self.add_state(node_key, "idle", idle_frames, pose_buffer,
                              ignore_rotation=ignore_rotation)

    # -- end-target corrections on the NEWEST queued state (reference
    #    apply_end_pos_correction :228-253 / apply_end_orientation_by_
    #    direction :256-267, driven by force_walk_end_targets) -----------
    def _refresh_last_entry(self, entry: StateQueueEntry,
                            frames: np.ndarray) -> None:
        """Write edited frames back into the entry and its pose buffer tail
        (the buffer's newest frames ARE the state's frames)."""
        entry.state.frames = frames
        n = min(len(frames), len(entry.pose_buffer))
        if n > 0:
            entry.pose_buffer[-n:] = list(frames[-n:])

    def correct_last_state_end_pos(self, target_pos,
                                   window: Optional[int] = None) -> bool:
        """Linear-blend the newest state's root XZ toward `target_pos` over
        the final `window` frames (reference apply_end_pos_correction;
        window <= 0 snaps only the last frame).  The fetch-edit-write runs
        under the queue mutex so the consumer thread can never stream a
        half-corrected state."""
        with self._mutex:
            if not self._queue:
                return False
            entry = self._queue[-1]
            frames = np.asarray(entry.state.frames, np.float32).copy()
            if window is not None and window <= 0:
                delta = np.asarray(target_pos, np.float32) - frames[-1, :3]
                delta[1] = 0.0
                frames[-1, :3] += delta
            else:
                frames = self.apply_end_pos_correction(frames, target_pos,
                                                       window=window)
            self._refresh_last_entry(entry, frames)
        return True

    def correct_last_state_end_dir(self, target_dir_xz,
                                   window: Optional[int] = None) -> bool:
        """Slerp the newest state's root heading toward the XZ direction
        over the final `window` frames (reference
        apply_end_orientation_by_direction -> correction).  Mutex-held like
        correct_last_state_end_pos."""
        with self._mutex:
            if not self._queue:
                return False
            entry = self._queue[-1]
            frames = np.asarray(entry.state.frames, np.float32).copy()
            frames = self.apply_end_orientation_correction(
                frames, target_dir_xz, window=window)
            self._refresh_last_entry(entry, frames)
        return True
