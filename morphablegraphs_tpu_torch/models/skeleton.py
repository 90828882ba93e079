"""Skeleton topology, BVH and skeleton.json I/O and forward kinematics
(port of morphablegraphs_tpu.models.skeleton).

Frame layout: [root_tx, root_ty, root_tz, q_joint0 (w,x,y,z), q_joint1, ...]
for the animated joints in skeleton order; length 3 + 4 * n_animated.
"""

from __future__ import annotations

import dataclasses
import functools
import io
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import consts, quat


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """Static skeleton description (host side, hashable)."""

    node_names: tuple  # all nodes incl. end sites, depth-first BVH order
    parents: tuple  # parent index per node (-1 for root)
    offsets: np.ndarray  # [n_nodes, 3] local offsets
    node_channels: tuple  # per node: tuple of BVH channel names (may be empty)
    animated_joints: tuple  # names of joints carrying quaternions in frames
    frame_time: float = 1.0 / 30
    # per-animated-joint importance weights (anim_utils skeleton
    # joint_weight_map, consumed by pose constraints); empty = all 1.0
    joint_weights: tuple = ()
    # per-node REST rotations (wxyz tuples) from skeleton.json 'rotation'
    # fields: FK applies them as the local rotation of NON-animated joints
    # (animated joints' frames carry the full rotation).  Empty = identity.
    rest_rotations: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "offsets", np.asarray(self.offsets, np.float32))

    def __hash__(self):
        return hash((self.node_names, self.parents, self.animated_joints,
                     self.rest_rotations))

    def __eq__(self, other):
        return (isinstance(other, Skeleton)
                and self.node_names == other.node_names
                and self.parents == other.parents
                and np.array_equal(self.offsets, other.offsets)
                and self.animated_joints == other.animated_joints
                and self.rest_rotations == other.rest_rotations)

    @property
    def n_nodes(self) -> int:
        return len(self.node_names)

    @property
    def n_animated(self) -> int:
        return len(self.animated_joints)

    @property
    def n_frame_params(self) -> int:
        return 3 + 4 * self.n_animated

    def index_of(self, name: str) -> int:
        return self.node_names.index(name)

    def animated_index_of(self, name: str) -> int:
        return self.animated_joints.index(name)

    def quat_slice(self, joint_name: str) -> slice:
        """Slice into a quaternion frame for a joint's 4 quaternion params."""
        i = self.animated_index_of(joint_name)
        return slice(3 + 4 * i, 3 + 4 * i + 4)

    @property
    def joint_weight_map(self) -> dict:
        """animated joint name -> weight (anim_utils joint_weight_map)."""
        w = self.joint_weights or (1.0,) * self.n_animated
        return dict(zip(self.animated_joints, w))



def add_fixed_joint_parameters_to_motion(skel: Skeleton, frames: np.ndarray,
                                         animated_subset=None) -> np.ndarray:
    """Expand host frames [T, 3 + 4 * len(animated_subset)] animated over a
    joint subset to the skeleton's full animated set: joints the subset
    lacks get their rest rotation (identity when unset).  animated_subset
    defaults to the first joints of the skeleton's animated set."""
    frames = np.asarray(frames)
    if animated_subset is None:
        n_sub = (frames.shape[-1] - 3) // 4
        animated_subset = skel.animated_joints[:n_sub]
    if tuple(animated_subset) == skel.animated_joints:
        return frames
    out = np.zeros((frames.shape[0], skel.n_frame_params), frames.dtype)
    out[:, :3] = frames[:, :3]
    out[:, 3::4] = 1.0  # identity w components
    rests = skel.rest_rotations or ()
    sub_index = {name: i for i, name in enumerate(animated_subset)}
    for j, name in enumerate(skel.animated_joints):
        i = sub_index.get(name)
        if i is not None:
            out[:, 3 + 4 * j: 7 + 4 * j] = frames[:, 3 + 4 * i: 7 + 4 * i]
        else:
            ni = skel.index_of(name)
            if ni < len(rests):
                out[:, 3 + 4 * j: 7 + 4 * j] = rests[ni]
    return out


def _np_from_euler(angles_deg: np.ndarray, order: str) -> np.ndarray:
    """Host-side euler (degrees) -> quaternion (w first) in scipy's
    intrinsic convention, the rotating-frame composition BVH uses."""
    from scipy.spatial.transform import Rotation
    r = Rotation.from_euler(order[1:].upper(), angles_deg, degrees=True)
    return np.roll(r.as_quat(), 1, axis=-1)


_CHANNEL_NAMES = {"Xposition", "Yposition", "Zposition",
                  "Xrotation", "Yrotation", "Zrotation"}


def _parse_bvh(text: str):
    tokens = text.replace("\t", " ").split()
    pos = 0

    def peek():
        return tokens[pos]

    def take(expect: Optional[str] = None):
        nonlocal pos
        tok = tokens[pos]
        pos += 1
        if expect is not None and tok != expect:
            raise ValueError(f"BVH parse error: expected {expect}, got {tok}")
        return tok

    node_names: List[str] = []
    parents: List[int] = []
    offsets: List[List[float]] = []
    node_channels: List[tuple] = []

    take("HIERARCHY")

    def parse_node(parent_idx: int, kind: str):
        if kind == "End":
            take("Site")
            # unique name for end sites
            name = node_names[parent_idx] + "_EndSite"
        else:
            name = take()
        idx = len(node_names)
        node_names.append(name)
        parents.append(parent_idx)
        take("{")
        take("OFFSET")
        offsets.append([float(take()), float(take()), float(take())])
        chans: tuple = ()
        if peek() == "CHANNELS":
            take()
            n = int(take())
            chans = tuple(take() for _ in range(n))
            for c in chans:
                if c not in _CHANNEL_NAMES:
                    raise ValueError(f"unknown BVH channel {c}")
        node_channels.append(chans)
        while peek() in ("JOINT", "End"):
            kind2 = take()
            parse_node(idx, kind2)
        take("}")

    take("ROOT")
    parse_node(-1, "ROOT")

    take("MOTION")
    take("Frames:")
    n_frames = int(take())
    take("Frame")
    take("Time:")
    frame_time = float(take())
    values = np.array([float(t) for t in tokens[pos:]], dtype=np.float64)
    n_ch = sum(len(c) for c in node_channels)
    if values.size != n_frames * n_ch:
        raise ValueError(f"BVH motion size mismatch: {values.size} != {n_frames}x{n_ch}")
    frames = values.reshape(n_frames, n_ch)
    return node_names, parents, offsets, node_channels, frames, frame_time


def load_bvh(path_or_text: str):
    """Read a BVH file (path or raw string).

    Returns (skeleton, euler_frames [n_frames, n_channels]) where the euler
    frames are the raw BVH channel values.
    """
    if "\nMOTION" in path_or_text or "HIERARCHY" in path_or_text[:64]:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    names, parents, offsets, channels, frames, frame_time = _parse_bvh(text)
    animated = tuple(n for n, c in zip(names, channels)
                     if any(ch.endswith("rotation") for ch in c))
    skel = Skeleton(tuple(names), tuple(parents), np.asarray(offsets, np.float32),
                    tuple(channels), animated, frame_time)
    return skel, frames



def load_skeleton_json(data: dict) -> Skeleton:
    """A Skeleton from a package's skeleton.json form: {"root", "frame_time",
    "animated_joints", "nodes": {name: {"offset", "children", "channels"
    (optional), "rotation" (optional rest rotation, w first)}}}.  Without a
    root, the node no other lists as a child; without channels, a root
    gets positions and rotations, an animated joint rotations."""
    nodes = data["nodes"]
    root = data.get("root")
    if root is None:
        children = {c for nd in nodes.values() for c in nd.get("children", ())}
        root = next(n for n in nodes if n not in children)
    names: List[str] = []
    parents: List[int] = []
    offsets: List[list] = []
    channels: List[tuple] = []
    rests: List[tuple] = []
    animated = tuple(data.get("animated_joints", ()))

    def visit(name: str, parent_idx: int):
        nd = nodes[name]
        idx = len(names)
        names.append(name)
        parents.append(parent_idx)
        offsets.append(list(nd.get("offset", (0.0, 0.0, 0.0))))
        rot = nd.get("rotation")
        rests.append(tuple(float(v) for v in rot) if rot is not None
                     else (1.0, 0.0, 0.0, 0.0))
        chans = nd.get("channels")
        if chans is None:
            chans = (("Xposition", "Yposition", "Zposition",
                      "Xrotation", "Yrotation", "Zrotation")
                     if parent_idx < 0 else
                     ("Xrotation", "Yrotation", "Zrotation")
                     if not animated or name in animated else ())
        channels.append(tuple(chans))
        for child in nd.get("children", ()):
            if child in nodes:
                visit(child, idx)

    visit(root, -1)
    if not animated:
        animated = tuple(n for n, c in zip(names, channels)
                         if any(ch.endswith("rotation") for ch in c))
    else:
        animated = tuple(n for n in names if n in animated)  # DFS order
    identity = (1.0, 0.0, 0.0, 0.0)
    rest_tuple = tuple(rests) if any(r != identity for r in rests) else ()
    return Skeleton(tuple(names), tuple(parents),
                    np.asarray(offsets, np.float32), tuple(channels),
                    animated, float(data.get("frame_time", 1.0 / 30)),
                    rest_rotations=rest_tuple)


def _rotation_order(chans: Sequence[str]) -> str:
    return "r" + "".join(c[0].lower() for c in chans if c.endswith("rotation"))


def _np_to_euler(q_wxyz: np.ndarray, order: str) -> np.ndarray:
    """Host-side quaternion (w first) -> euler degrees, scipy's intrinsic
    convention (the inverse of `_np_from_euler`)."""
    from scipy.spatial.transform import Rotation
    r = Rotation.from_quat(np.roll(np.asarray(q_wxyz, np.float64), -1, axis=-1))
    return r.as_euler(order[1:].upper(), degrees=True)


def _np_fix_signs_sequential(quats: np.ndarray) -> np.ndarray:
    """Host-side twin of ops.quat.fix_signs_sequential over axis 0."""
    d = np.sum(quats[1:] * quats[:-1], axis=-1)
    run = np.cumprod(np.where(d < 0.0, -1.0, 1.0), axis=0)
    run = np.concatenate([np.ones((1,) + run.shape[1:], run.dtype), run],
                         axis=0)
    return quats * run[..., None]


def bvh_to_quat_frames(skel: Skeleton, euler_frames: np.ndarray) -> np.ndarray:
    """BVH channel rows [T, n_channels] -> quaternion frames [T, 3 + 4J]
    (float32 numpy): the root translation from the first position channels
    (mapped by channel letter), each animated joint's euler triplet in its
    channel order, signs aligned frame to frame."""
    euler_frames = np.asarray(euler_frames, np.float64)
    t = euler_frames.shape[0]
    root = np.zeros((t, 3), np.float32)
    col = 0
    root_seen = False
    quats_per_joint = []
    for name, chans in zip(skel.node_names, skel.node_channels):
        n = len(chans)
        if n == 0:
            continue
        vals = euler_frames[:, col: col + n]
        col += n
        pos_cols = [i for i, c in enumerate(chans) if c.endswith("position")]
        rot_cols = [i for i, c in enumerate(chans) if c.endswith("rotation")]
        if pos_cols and not root_seen:
            for ci in pos_cols:
                root[:, "XYZ".index(chans[ci][0].upper())] = vals[:, ci]
            root_seen = True
        if rot_cols and name in skel.animated_joints:
            quats_per_joint.append(_np_from_euler(vals[:, rot_cols],
                                                  _rotation_order(chans)))
    quats = _np_fix_signs_sequential(np.stack(quats_per_joint, axis=1))
    return np.concatenate([root, quats.reshape(t, -1)],
                          axis=1).astype(np.float32)


def _export_channels(skel: Skeleton) -> tuple:
    """Per-node channels for BVH export: a non-animated joint with a rest
    rotation gets rotation channels, so the written file carries the
    geometry FK computes (an OFFSET-only joint is identity to a reader)."""
    identity = (1.0, 0.0, 0.0, 0.0)
    rests = skel.rest_rotations or ()
    out = []
    for i, chans in enumerate(skel.node_channels):
        has_rot = any(c.endswith("rotation") for c in chans)
        rest = rests[i] if i < len(rests) else identity
        if (not has_rot and tuple(rest) != identity
                and not skel.node_names[i].endswith("_EndSite")):
            chans = tuple(chans) + ("Xrotation", "Yrotation", "Zrotation")
        out.append(tuple(chans))
    return tuple(out)


def quat_frames_to_bvh(skel: Skeleton, quat_frames: np.ndarray) -> np.ndarray:
    """Quaternion frames [T, 3 + 4J] -> BVH channel rows (float64 numpy),
    the inverse of `bvh_to_quat_frames`; fixed joints with a rest rotation
    write it as constant channels."""
    quat_frames = np.asarray(quat_frames)
    t = quat_frames.shape[0]
    cols = []
    rests = skel.rest_rotations or ()
    for ni, (name, chans) in enumerate(zip(skel.node_names,
                                           _export_channels(skel))):
        if len(chans) == 0:
            continue
        vals = np.zeros((t, len(chans)), np.float64)
        if name == skel.node_names[0]:
            for ci, c in enumerate(chans):
                if c.endswith("position"):
                    vals[:, ci] = quat_frames[:, "XYZ".index(c[0])]
        rot_idx = [i for i, c in enumerate(chans) if c.endswith("rotation")]
        if rot_idx:
            if name in skel.animated_joints:
                q = quat_frames[:, skel.quat_slice(name)]
            elif ni < len(rests):
                q = np.tile(np.asarray(rests[ni], np.float64), (t, 1))
            else:
                q = np.tile([1.0, 0, 0, 0], (t, 1))
            vals[:, rot_idx] = _np_to_euler(q, _rotation_order(chans))
        cols.append(vals)
    return np.concatenate(cols, axis=1)


def write_bvh(skel: Skeleton, quat_frames: np.ndarray,
              path: Optional[str] = None) -> str:
    """Quaternion frames [T, 3 + 4J] -> BVH text, written to `path` when
    given."""
    buf = io.StringIO()
    buf.write("HIERARCHY\n")
    export_chans = _export_channels(skel)
    children: Dict[int, List[int]] = {}
    for i, p in enumerate(skel.parents):
        children.setdefault(p, []).append(i)

    def emit(idx: int, depth: int):
        indent = "  " * depth
        name = skel.node_names[idx]
        if idx == 0:
            buf.write(f"{indent}ROOT {name}\n")
        elif name.endswith("_EndSite"):
            buf.write(f"{indent}End Site\n")
        else:
            buf.write(f"{indent}JOINT {name}\n")
        buf.write(f"{indent}{{\n")
        o = skel.offsets[idx]
        buf.write(f"{indent}  OFFSET {o[0]:.6f} {o[1]:.6f} {o[2]:.6f}\n")
        chans = export_chans[idx]
        if chans:
            buf.write(f"{indent}  CHANNELS {len(chans)} {' '.join(chans)}\n")
        for c in children.get(idx, []):
            emit(c, depth + 1)
        buf.write(f"{indent}}}\n")

    emit(0, 0)
    rows = quat_frames_to_bvh(skel, quat_frames)
    buf.write("MOTION\n")
    buf.write(f"Frames: {rows.shape[0]}\n")
    buf.write(f"Frame Time: {skel.frame_time:.6f}\n")
    for row in rows:
        buf.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    text = buf.getvalue()
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


# ---------------------------------------------------------------------------
# Forward kinematics
# ---------------------------------------------------------------------------
#
# Every function composes local transforms in the JAX package's order
# (pos = parent pos + rotate(parent ori, offset), ori = parent ori * local)
# with deliberately unnormalized quaternions, batches over any leading axes
# and writes nothing in place, so torch.func transforms run through it.

def _fk_tables(skel: Skeleton):
    """Per node, the index of its quaternion block in the frame vector, or
    -1 for a joint without rotation channels."""
    return tuple(skel.animated_joints.index(name)
                 if name in skel.animated_joints else -1
                 for name in skel.node_names)


def _rest_table(skel: Skeleton) -> np.ndarray:
    """[n_nodes, 4] rest quaternions (identity when unset); FK uses them as
    the local rotation of non-animated joints."""
    if not skel.rest_rotations:
        out = np.zeros((skel.n_nodes, 4), np.float32)
        out[:, 0] = 1.0
        return out
    return np.asarray(skel.rest_rotations, np.float32)


@functools.lru_cache(maxsize=None)
def _level_tables(skel: Skeleton):
    """The nodes grouped by depth for the level-batched FK: (order, the
    node indices level by level; levels, (start, stop) of each level's
    span in `order`; parent_pos, for each node of `order` past the root
    level, its parent's position in `order`; inverse, each node's position
    in `order`)."""
    depth = []
    for i in range(skel.n_nodes):
        d, j = 0, skel.parents[i]
        while j >= 0:
            d, j = d + 1, skel.parents[j]
        depth.append(d)
    order = sorted(range(skel.n_nodes), key=lambda i: (depth[i], i))
    where = {n: k for k, n in enumerate(order)}
    levels, k = [], 0
    for d in range(max(depth) + 1):
        n = sum(1 for x in depth if x == d)
        levels.append((k, k + n))
        k += n
    parent_pos = [where[skel.parents[n]] for n in order[levels[0][1]:]]
    inverse = [where[n] for n in range(skel.n_nodes)]
    return (np.asarray(order), tuple(levels), np.asarray(parent_pos),
            np.asarray(inverse))


@functools.lru_cache(maxsize=None)
def device_tables(skel: Skeleton, dtype: torch.dtype,
                  device: torch.device) -> dict:
    """The FK's host tables as tensors on `device`, their floats in `dtype`,
    made once per skeleton, dtype and device and shared by every later call
    (a host table copied to the card at each call is a synchronising copy,
    which a CUDA graph cannot capture); callers never write into them.
    Plain tensors even when first asked for inside a torch.func transform
    (`consts.plain`), so a kernel may read their storage.
    offsets [n_nodes, 3], rest [n_nodes, 4] and the root's offset0 [3] and
    rest0 [4]; fk_global's tables in its level order: level_offsets,
    level_rest, level_animated [n_nodes, 1] (bool), level_quat (each node's
    quaternion block, 0 where it has none), parent_pos and inverse
    (`_level_tables`)."""
    anim_idx = np.asarray(_fk_tables(skel))
    order, _, parent_pos, inverse = _level_tables(skel)
    animated = anim_idx[order] >= 0
    rest = _rest_table(skel)

    def tensor(a, dt=None):
        with consts.plain():
            return torch.as_tensor(a, dtype=dt, device=device)

    return dict(offsets=tensor(skel.offsets, dtype), rest=tensor(rest, dtype),
                offset0=tensor(skel.offsets[0], dtype),
                rest0=tensor(rest[0], dtype),
                level_offsets=tensor(skel.offsets[order], dtype),
                level_rest=tensor(rest[order], dtype),
                level_animated=tensor(animated[:, None]),
                level_quat=tensor(np.where(animated, anim_idx[order], 0)),
                parent_pos=tensor(parent_pos), inverse=tensor(inverse))


def fk_global(skel: Skeleton, frames: torch.Tensor):
    """Global transforms of every node.  frames [..., 3 + 4J] ->
    (positions [..., n_nodes, 3], orientations [..., n_nodes, 4]).
    The nodes of one depth are transformed together, each by the same
    per-node arithmetic as a node-by-node pass."""
    levels = _level_tables(skel)[1]
    tables = device_tables(skel, frames.dtype, frames.device)
    lead = frames.shape[:-1]
    quats = frames[..., 3:].reshape(lead + (skel.n_animated, 4))
    local_q = torch.where(tables["level_animated"],
                          quats[..., tables["level_quat"], :],
                          tables["level_rest"])
    offsets = tables["level_offsets"]
    r0, r1 = levels[0]
    pos = offsets[r0:r1] + frames[..., None, :3]
    ori = local_q[..., r0:r1, :]
    parent = tables["parent_pos"]
    for a, b in levels[1:]:
        p_idx = parent[a - r1: b - r1]
        p_pos, p_ori = pos[..., p_idx, :], ori[..., p_idx, :]
        pos = torch.cat([pos, p_pos + quat.rotate_vec(p_ori, offsets[a:b])],
                        dim=-2)
        ori = torch.cat([ori, quat.multiply(p_ori, local_q[..., a:b, :])],
                        dim=-2)
    inv = tables["inverse"]
    return pos[..., inv, :], ori[..., inv, :]


def fk_positions(skel: Skeleton, frames: torch.Tensor) -> torch.Tensor:
    """Global positions only: [..., n_nodes, 3]."""
    return fk_global(skel, frames)[0]


@functools.lru_cache(maxsize=None)
def _chain_tables(skel: Skeleton):
    """Per-node ancestor chains: (chain [n_nodes, depth] int32, ancestors
    root first and -1-padded after the node itself, and the max depth)."""
    chains = []
    for i in range(skel.n_nodes):
        chain, j = [], i
        while j >= 0:
            chain.append(j)
            j = skel.parents[j]
        chains.append(chain[::-1])
    depth = max(len(c) for c in chains)
    tbl = np.full((skel.n_nodes, depth), -1, np.int32)
    for i, c in enumerate(chains):
        tbl[i, : len(c)] = c
    return tbl, depth


def fk_node(skel: Skeleton, frames: torch.Tensor, node):
    """Global transform of one node per batch element through its ancestor
    chain.  frames [..., 3 + 4J] and node (int, [...]) broadcast jointly ->
    (pos [..., 3], ori [..., 4]); agrees with fk_global to rounding."""
    anim_idx = np.asarray(_fk_tables(skel), np.int64)
    tbl, depth = _chain_tables(skel)
    dev, dt = frames.device, frames.dtype
    node = torch.as_tensor(node, dtype=torch.long, device=dev)
    batch = torch.broadcast_shapes(frames.shape[:-1], node.shape)
    frames = frames.expand(batch + frames.shape[-1:])
    n_anim = skel.n_animated
    quats = frames[..., 3:].reshape(batch + (n_anim, 4))
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dt,
                            device=dev).expand(batch + (1, 4))
    quats_p = torch.cat([quats, identity], dim=-2)  # [..., n_anim+1, 4]
    q_of_node = torch.as_tensor(np.where(anim_idx >= 0, anim_idx, n_anim),
                                device=dev)
    animated = torch.as_tensor(anim_idx >= 0, device=dev)
    offsets = torch.as_tensor(skel.offsets, dtype=dt, device=dev)
    rest = torch.as_tensor(_rest_table(skel), dtype=dt, device=dev)
    chain = torch.as_tensor(tbl, dtype=torch.long, device=dev)[
        node.expand(batch)]  # [..., depth]
    pos, ori = fk_root(skel, frames)  # chain[..., 0] is the root
    for d in range(1, depth):
        nd = chain[..., d]
        valid = (nd >= 0)[..., None]
        nd = torch.clamp(nd, min=0)
        gi = q_of_node[nd][..., None, None].expand(batch + (1, 4))
        lq = torch.where(animated[nd][..., None],
                         torch.gather(quats_p, -2, gi)[..., 0, :], rest[nd])
        pos = torch.where(valid, pos + quat.rotate_vec(ori, offsets[nd]), pos)
        ori = torch.where(valid, quat.multiply(ori, lq), ori)
    return pos, ori


def fk_root(skel: Skeleton, frames: torch.Tensor):
    """Global transform of the root: pos = offset + root translation,
    ori = the root's channel quaternion (its rest rotation when it is not
    animated).  frames [..., D] -> (pos [..., 3], ori [..., 4])."""
    a = _fk_tables(skel)[0]
    tables = device_tables(skel, frames.dtype, frames.device)
    pos = tables["offset0"] + frames[..., :3]
    if a >= 0:
        ori = frames[..., 3 + 4 * a: 7 + 4 * a]
    else:
        ori = tables["rest0"].expand(frames.shape[:-1] + (4,))
    return pos, ori


def fk_point_cloud(skel: Skeleton, frames: torch.Tensor,
                   normalize: bool = False) -> torch.Tensor:
    """Every node's position per frame [..., n_nodes, 3], the point cloud
    of the pose distances.  normalize=True zeroes the root translation and
    (for an animated root) its rotation first; a non-animated root's rest
    rotation is the same for every frame and stays."""
    frames = torch.as_tensor(frames)
    if normalize:
        frames = frames.clone()
        frames[..., :3] = 0.0
        if skel.node_names[0] in skel.animated_joints:
            a = skel.animated_index_of(skel.node_names[0])
            frames[..., 3 + 4 * a: 7 + 4 * a] = torch.tensor(
                [1.0, 0.0, 0.0, 0.0], dtype=frames.dtype,
                device=frames.device)
    return fk_positions(skel, frames)
