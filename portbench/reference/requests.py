"""The plain reference of the service's sequential request path
(`POST /run_morphablegraphs` under the standard settings), stage by stage,
for graphs whose planner never has to choose between options (every
start state and transition the request reaches has one option, as in
the walk graph with its pick -> carry -> place actions):

* planning: an action's start node (the start state linked from the
  previous node), then after each step the end condition on the path
  (the root's distance to the path's last control point, the travelled
  arc) and the transition of that type (`next_node`);
* the step's constraint set (`step_set`): with a root path, the goal one
  average step along it (the path's end at an end step) with its ground
  direction and the path as a trajectory of 16 samples; the action's
  keyframes on the node's labelled canonical frame; the alignment to the
  previous frame or the start pose;
* selection: the exact error of every candidate of the step's pool
  (`error`), the best taken as the LM's start;
* the exact Levenberg-Marquardt refinement of that start (`lm`): every
  active residual plus the mixture's weighted negative log-likelihood,
  damped normal equations with a relative floor and a trust radius, the
  refinement kept where it lowers the exact error;
* emission (`emit`): the latent on the canonical timeline, aligned and
  seam-blended onto the previous frame, and the travelled arc's update by
  the bounded closest point of the clip's last root position
  (`closest_point`);
* the conversion (`convert_clip`): each latent on its warped timeline,
  aligned and seam-blended onto the converted motion's last frame;
* the keyframe IK (`ik`): damped Gauss-Newton over every non-root joint's
  rotation vector with a prior toward the pose, and its linear blend over
  the interpolation window (`blend`).

`run_request` chains them: the reference in the program's place (the
control).  Written for the benchmark from the semantics of the reference's
motion synthesis; it imports neither the program nor JAX, and works in the
dtype of the model it is given (matrix products through `Model.einsum`)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import ops

TRAJ_SAMPLES = 16
XZ = (1.0, 0.0, 1.0)
START, STANDARD, END, SINGLE = "start", "standard", "end", "single"


@dataclasses.dataclass(frozen=True)
class Settings:
    """The service's standard settings (its default algorithm config) that
    the reference follows (the CPU tests make the first two smaller)."""

    n_random_samples: int = 100
    lm_iterations: int = 10
    init_lambda: float = 1e-3
    error_scale: float = 1.0
    quality_scale: float = 0.1
    window: int = 20  # spatial_smoothing_window
    position_weight: float = 1.0
    dir_weight: float = 0.8
    look_ahead: float = 100.0
    granularity: int = 1000  # arc_length_granularity
    search_accuracy: float = 1e-3  # closest_point_search_accuracy
    search_max_iterations: int = 5000
    step_length_factor: float = 1.0  # heuristic_step_length_factor
    end_step_length_factor: float = 1.0
    ik_iterations: int = 10  # inverse_kinematics max_iterations / 100
    ik_damping: float = 0.5
    ik_prior: float = 0.3
    interpolation_window: int = 120


def pad_frames(n: int, multiple: int = 32) -> int:
    return ((n + multiple - 1) // multiple) * multiple


# -- the skeleton ------------------------------------------------------------

class Skeleton:
    """A (name, offset, children) tree: every joint animated, in depth-first
    order (the frame's quaternion blocks); the root's position is its
    offset plus the frame's translation."""

    def __init__(self, tree, dtype, device):
        names, parents, offsets = [], [], []

        def visit(node, parent):
            i = len(names)
            names.append(node[0])
            parents.append(parent)
            offsets.append(node[1])
            for child in node[2]:
                visit(child, i)

        visit(tree, -1)
        self.names, self.parents = names, parents
        self.offsets = torch.tensor(offsets, dtype=dtype, device=device)

    @property
    def n_joints(self) -> int:
        return len(self.names)

    def chain(self, joint: str) -> list:
        i, out = self.names.index(joint), []
        while i >= 0:
            out.append(i)
            i = self.parents[i]
        return out[::-1]

    def joint(self, frames, joint: str):
        """(position [..., 3], orientation [..., 4]) of `joint` in frames
        [..., D]: p_child = p + q_rotate(q, offset), q_child = q * q_local,
        the quaternions as they are (not normalised)."""
        chain = self.chain(joint)
        pos = self.offsets[0] + frames[..., :3]
        ori = frames[..., 3:7]
        for i in chain[1:]:
            pos = pos + ops.q_rotate(ori, self.offsets[i].expand(pos.shape))
            ori = ops.q_multiply(ori, frames[..., 3 + 4 * i: 7 + 4 * i])
        return pos, ori


# -- the request -------------------------------------------------------------

@dataclasses.dataclass
class Action:
    name: str
    points: np.ndarray | None  # the root path's control points [P, 3]
    free_dims: tuple  # the path's unconstrained dims
    keyframes: list  # [(joint, position [3] with NaN free, label)]


def parse(mg_input: dict):
    """-> (start position [3], start heading in degrees, [Action]): the
    request's schema without the coordinate transform, None components of
    a path free, control points nearer than 1e-3 to the last kept one
    dropped."""
    sp = mg_input.get("startPose", {"position": [0, 0, 0],
                                    "orientation": [0, 0, 0]})
    pos = np.array([0.0 if v is None else float(v) for v in sp["position"]],
                   np.float32)
    heading = float(sp["orientation"][1])
    actions = []
    for entry in mg_input["elementaryActions"]:
        points, free, kfs = None, (), []
        for c in entry.get("constraints", []):
            joint = c.get("joint")
            for k in c.get("keyframeConstraints", []):
                p = np.array([np.nan if v is None else float(v)
                              for v in k.get("position", [None] * 3)],
                             np.float32)
                sem = k.get("semanticAnnotation", {})
                label = k.get("keyframeLabel") or next(
                    (n for n, v in sem.items() if v is True), "end")
                kfs.append((joint, p, label))
            traj = c.get("trajectoryConstraints")
            if traj and joint == "Hips" and points is None:
                kept, dims = [], set()
                for cp in traj:
                    p = np.array([np.nan if v is None else float(v)
                                  for v in cp["position"]])
                    dims |= {i for i in range(3) if np.isnan(p[i])}
                    p = np.where(np.isnan(p), 0.0, p)
                    if kept and np.linalg.norm(p - kept[-1]) < 1e-3:
                        continue
                    kept.append(p)
                points, free = np.asarray(kept, np.float32), tuple(
                    sorted(dims))
        actions.append(Action(entry["action"], points, free, kfs))
    return pos, heading, actions


# -- the graph ---------------------------------------------------------------

class Graph:
    """Node types, typed edges, step lengths and labelled keyframes of a
    graph dict, keyed (action, state) and indexed as `model.Model.keys`."""

    def __init__(self, graph_dict: dict, keys: tuple):
        self.keys = keys
        self.node_type, self.start_states, self.end_states = {}, {}, {}
        self.step_length, self.labels, self.n_canonical = {}, {}, {}
        for action, sub in graph_dict["subgraphs"].items():
            info = sub.get("info", {})
            self.start_states[action] = list(info.get("start_states", ()))
            self.end_states[action] = list(info.get("end_states", ()))
            for state, desc in sub["nodes"].items():
                key = (action, state)
                self.node_type[key] = (
                    SINGLE if len(sub["nodes"]) == 1 else
                    END if state in self.end_states[action] else
                    START if state in self.start_states[action] else
                    STANDARD)
                self.step_length[key] = float(
                    desc["stats"]["average_step_length"])
                self.labels[key] = dict(desc["mm"].get("keyframes", {}))
                self.n_canonical[key] = int(desc["mm"]["n_canonical_frames"])
        by_name = {f"{a}_{s}": (a, s) for a, s in self.node_type}
        self.edges = {k: {} for k in self.node_type}
        for src, dsts in graph_dict["transitions"].items():
            a = by_name[src]
            for dst in dsts:
                b = by_name[dst]
                t = self.node_type[b]
                self.edges[a][b] = ("action_transition" if a[0] != b[0] else
                                    t if t in (STANDARD, START) else END)

    def index(self, key) -> int:
        return self.keys.index(tuple(key))

    def start_node(self, action: str, prev_key):
        """The action's start state linked from prev_key (any start state
        when none is linked)."""
        options = [(action, s) for s in self.start_states[action]]
        if prev_key is not None:
            linked = [o for o in options if o in self.edges[tuple(prev_key)]]
            options = linked or options
        if not options:
            options = [k for k in self.node_type if k[0] == action]
        return _single(options)

    def next_node(self, key, ended: bool, has_path: bool):
        """(next node, its edge type) after `key`: with a path, an edge of
        type end once the path's end condition holds, else standard; without
        a path, standard while the node has such edges; either falls back to
        standard, then end.  (None, None) without edges."""
        edges = self.edges[tuple(key)]
        if has_path:
            want = END if ended else STANDARD
        else:
            want = STANDARD if any(t == STANDARD for t in edges.values()) \
                else END
        for t in (want, STANDARD, END):
            options = [k for k, tt in edges.items() if tt == t]
            if options:
                return _single(options), t
        return None, None

    def arc_of_end(self, action: str, s: Settings) -> float:
        ends = [self.step_length[(action, e)] for e in self.end_states[action]
                if (action, e) in self.step_length]
        return float(np.mean(ends)) * s.end_step_length_factor if ends \
            else 0.0


def _single(options):
    if len(options) != 1:
        raise ValueError(f"the reference plans single-option choices only; "
                         f"got {options}")
    return options[0]


def end_condition(root_pos, travelled: float, arc_of_end: float,
                  full_arc: float, last_point) -> tuple:
    """(ended, margin): the action's path ends when the root channels
    (3D, the hip height included) come within half the end step of the
    path's last control point or the travelled arc within the end step of
    its end; margin is how far the deciding comparison was from flipping."""
    dist = float(np.linalg.norm(np.asarray(last_point, np.float64)
                                - np.asarray(root_pos, np.float64)))
    a = dist - arc_of_end / 2.0
    b = (full_arc - arc_of_end) - travelled
    ended = not (a > 0 and b > 0)
    margin = max(-v for v in (a, b) if v <= 0) if ended else min(a, b)
    return ended, margin


# -- one step ----------------------------------------------------------------

@dataclasses.dataclass
class StepSet:
    """A step's constraints: node index, canonical frames, keyframe slots
    [(joint, target [3], mask [3], canonical frame, weight)], the
    direction (target [2], frame, weight) or None, the trajectory (path,
    floor arc) or None, and the alignment."""

    node: int
    n_canonical: int
    kfs: list
    direction: tuple | None
    traj: tuple | None
    prev_last: torch.Tensor | None
    start_q: torch.Tensor
    start_delta: torch.Tensor


def start_transform(position, heading_deg: float, dtype, device):
    q = ops.q_about_y(torch.tensor(math.radians(heading_deg), dtype=dtype,
                                   device=device))
    return q, torch.as_tensor(position, dtype=dtype, device=device)


def step_set(graph: Graph, action: Action, path, key, travelled,
             prev_last, is_last_step: bool, start, s: Settings,
             dtype, device) -> StepSet:
    key = tuple(key)
    n_can = graph.n_canonical[key]
    labels = graph.labels[key]
    kfs, direction, traj = [], None, None

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    if path is not None:
        mask = t(XZ if action.free_dims == (1,) else
                 [0.0 if i in action.free_dims else 1.0 for i in range(3)])
        goal_arc = (path.full_arc if is_last_step else
                    t([travelled + graph.step_length[key]
                       * s.step_length_factor]))
        goal, goal_dir = path.point_and_dir(goal_arc.reshape(1))
        end_kf = labels.get("end", n_can - 1)
        kfs.append(("Hips", goal[0] * mask, mask, float(end_kf),
                    s.position_weight))
        direction = (goal_dir[0], float(end_kf), s.dir_weight)
        traj = (path, t([travelled]))
    for joint, pos, label in action.keyframes:
        if label not in labels:
            continue
        p = t(np.where(np.isnan(pos), 0.0, pos))
        kfs.append((joint, p, t((~np.isnan(pos)).astype(np.float64)),
                    float(labels[label]), 1.0))
    return StepSet(graph.index(key), n_can, kfs, direction, traj, prev_last,
                   *start)


def _aligned_coeffs(m, st: StepSet, alpha):
    c = m.mean[st.node] + m.einsum("bdk,...k->...bd", m.eigen[st.node],
                                   alpha)
    first = c[..., 0, :]
    if st.prev_last is not None:
        q_y, delta = ops.aligning_transform(
            st.prev_last.expand(first.shape), first)
    else:
        q_y = st.start_q.expand(first.shape[:-1] + (4,))
        delta = st.start_delta.expand(first.shape[:-1] + (3,))
    return ops.transform_frames(c, q_y, delta)


def residual_rows(m, skel: Skeleton, st: StepSet, s):
    """(keyframe rows [..., n_kf], direction row [...] or None, the
    trajectory's 16 distances [..., 16] or None) of latents s [..., L]."""
    dt, dev = s.dtype, s.device
    c = _aligned_coeffs(m, st, s[..., : m.k_s])
    times = [f for _, _, _, f, _ in st.kfs]
    if st.direction is not None:
        times.append(st.direction[1])
    times = torch.tensor(times, dtype=dt, device=dev)
    if st.traj is not None:
        lin = torch.linspace(0.0, 1.0, TRAJ_SAMPLES, dtype=dt, device=dev)
        times = torch.cat([times, lin * max(st.n_canonical - 1.0, 1.0)])
    rows = m.einsum("qb,...bd->...qd",
                    ops.basis_matrix(m.knots[st.node], times), c)
    kf = []
    for i, (joint, target, mask, _, w) in enumerate(st.kfs):
        p, _ = skel.joint(rows[..., i, :], joint)
        kf.append(w * torch.sqrt(torch.clamp(
            (((p - target) * mask) ** 2).sum(-1), min=1e-12)))
    kf = torch.stack(kf, -1)
    n = len(st.kfs)
    d_row = None
    if st.direction is not None:
        target, _, w = st.direction
        x, z = ops.forward_xz(rows[..., n, 3:7])
        nrm = torch.clamp(torch.sqrt(x * x + z * z), min=1e-10)
        cos = torch.clamp((target[0] * x + target[1] * z) / nrm, -1.0, 1.0)
        d_row = w * torch.rad2deg(torch.arccos(cos))
        n += 1
    tr = None
    if st.traj is not None:
        path, floor = st.traj
        pts = skel.offsets[0] + rows[..., n:, :3]
        lead = pts.shape[:-2]
        dist, _, _ = path.closest_points_advancing(
            pts.reshape((1, -1) + pts.shape[-2:]), floor)
        tr = dist.reshape(lead + (TRAJ_SAMPLES,))
    return kf, d_row, tr


def error(m, skel, st: StepSet, s):
    """The exact constraint error [...] of latents s [..., L]: the keyframe
    rows, the direction and the trajectory's mean distance (where any
    sample is off the path)."""
    kf, d_row, tr = residual_rows(m, skel, st, s)
    out = kf.sum(-1)
    if d_row is not None:
        out = out + d_row
    if tr is not None:
        out = out + (tr > 0).any(-1).to(tr.dtype) * tr.mean(-1)
    return out


def _nll(m, st, s):
    return ops.gmm_neg_log_prob(s, m.weights[st.node], m.means[st.node],
                                m.prec_chol[st.node], m.einsum)


def _jacobian(fn, x):
    """d fn / d x [R, N] of fn: [N] -> [R], by reverse mode (its gradients
    keep the input's dtype; forward mode through a clamp to a Python float
    turns float32 tangents into float64 ones)."""
    return torch.autograd.functional.jacobian(fn, x, vectorize=True)


def lm(m, skel, st: StepSet, s0, s: Settings):
    """The exact LM from s0 [L] -> the refined latent [L]: residuals
    error_scale * r + quality_scale * (-log p(s)) on every active row, their
    exact jacobians."""

    def fn(x):
        kf, d_row, tr = residual_rows(m, skel, st, x)
        parts = [kf] + ([d_row[..., None]] if d_row is not None else []) \
            + ([tr] if tr is not None else [])
        return s.error_scale * torch.cat(parts, -1) \
            + s.quality_scale * _nll(m, st, x)[..., None]

    x, lam, radius = s0, s.init_lambda, 1.0
    for _ in range(s.lm_iterations):
        r = fn(x)
        j = _jacobian(fn, x)  # [R, L]
        jtj = m.einsum("rl,rk->lk", j, j)
        dg = torch.diagonal(jtj)
        floor = torch.clamp(1e-2 * dg.max(), min=1e-6)
        damp = torch.diag(torch.maximum(dg, floor))
        delta = torch.linalg.solve(jtj + lam * damp, m.einsum("rl,r->l", j,
                                                              r))
        nrm = float(torch.linalg.vector_norm(delta))
        delta = delta * min(radius / max(nrm, 1e-10), 1.0)
        x_new = x - delta
        better = float((fn(x_new) ** 2).sum()) < float((r * r).sum())
        if better:
            x, lam, radius = x_new, max(lam * 0.1, 1e-6), min(radius * 2.0,
                                                              16.0)
        else:
            lam = lam * 10.0
    return x


def refine(m, skel, st, s0, s: Settings):
    """The gated refinement as the request path keeps it -> (the emitted
    latent, the LM's refined latent, the start's exact error, the refined
    latent's)."""
    e0 = error(m, skel, st, s0)
    s_opt = lm(m, skel, st, s0, s)
    e_opt = error(m, skel, st, s_opt)
    return (s_opt if float(e_opt) < float(e0) else s0), s_opt, e0, e_opt


def pool(m, node: int, comp, z):
    """The step's candidates from their components [n] and standard normals
    [n, L]."""
    return m.means[node][comp] + m.einsum(
        "nij,nj->ni", m.cov_chol[node][comp], z.to(m.means.dtype))


# -- frames ------------------------------------------------------------------

def coeffs(m, node: int, s):
    return m.mean[node] + m.einsum("bdk,k->bd", m.eigen[node], s[: m.k_s])


def canonical_times(n_can: int, max_frames: int, dtype, device):
    """The canonical timeline: i * F / (F - 1), clamped at F - 1."""
    i = torch.arange(max_frames, dtype=dtype, device=device)
    return torch.clamp(i * (float(n_can) / max(n_can - 1, 1)),
                       max=float(n_can - 1))


def place(frames, prev_last, start, window: int):
    """frames [T, D] aligned and seam-blended onto prev_last, or placed at
    the start pose (q_y, delta) without one."""
    if prev_last is None:
        return ops.transform_frames(frames, *start)
    q_y, delta = ops.aligning_transform(prev_last, frames[0])
    return ops.seam_blend(prev_last, ops.transform_frames(frames, q_y, delta),
                          window)


def emit(m, st: StepSet, s, window: int):
    """The step's clip [F, D] of latent s on the canonical timeline."""
    f = st.n_canonical
    times = canonical_times(f, pad_frames(f), s.dtype, s.device)
    frames = m.einsum("tb,bd->td", ops.basis_matrix(m.knots[st.node], times),
                      coeffs(m, st.node, s))
    return place(frames, st.prev_last, (st.start_q, st.start_delta),
                 window)[:f]


def convert_clip(m, node: int, s, prev_last, start, window: int):
    """The conversion's clip of latent s on its warped timeline ->
    (frames [n, D], n, the unrounded end time that set n)."""
    f = int(m.n_canonical[node])
    times, n, t_end = ops.warped_times(
        m.mean_t[node][None], m.eigen_t[node][None], s[None, m.k_s:],
        m.n_canonical[node][None], pad_frames(2 * f), m.einsum)
    frames = m.einsum("tb,bd->td", ops.basis_matrix(m.knots[node], times[0]),
                      coeffs(m, node, s))
    n = int(n[0])
    return place(frames, prev_last, start, window)[:n], n, float(t_end[0])


def closest_point(path, point, floor: float, ceiling: float,
                  full_arc: float, s: Settings) -> float:
    """The travelled arc's update: the closest table sample in XZ within
    [floor, ceiling], ternary refinement between its neighbours to the
    search's accuracy, then the clamp into the window."""
    dt = path.table_arc.dtype
    d2 = (((path.table_pts[0] - point) * path.mask) ** 2).sum(-1)
    arc = path.table_arc[0]
    valid = (arc >= floor - 1e-6) & (arc <= ceiling + 1e-6)
    g = path.g
    i = int(torch.where(valid, d2, torch.full_like(d2, math.inf)).argmin()) \
        if bool(valid.any()) else g
    lo = torch.tensor(max(i - 1, 0) / g, dtype=dt, device=d2.device)
    hi = torch.tensor(min(i + 1, g) / g, dtype=dt, device=d2.device)

    def dist(u):
        p = path.eval_u(u.reshape(1, 1))[0, 0]
        return float((((p - point) * path.mask) ** 2).sum())

    bracket = 2.0 * max(full_arc, 1e-6) / g
    n = (4 if s.search_accuracy >= bracket else
         math.ceil(math.log(s.search_accuracy / bracket) / math.log(2 / 3)))
    n = min(-(-max(4, min(n, 32)) // 4) * 4, 32)
    for _ in range(max(1, min(n, s.search_max_iterations))):
        m1, m2 = lo + (hi - lo) / 3.0, hi - (hi - lo) / 3.0
        if dist(m1) < dist(m2):
            hi = m2
        else:
            lo = m1
    out = float(path.arc_at_u((0.5 * (lo + hi)).reshape(1, 1))[0, 0])
    return min(max(out, floor), max(ceiling, floor))


# -- the keyframe IK ----------------------------------------------------------

def _apply_deltas(frame, deltas):
    """q_j <- exp(delta_j / 2) * q_j for every joint but the root."""
    half = 0.5 * deltas
    angle = torch.sqrt((half * half).sum(-1, keepdim=True) + 1e-16)
    dq = torch.cat([torch.cos(angle), half * torch.sin(angle) / angle], -1)
    q = frame[3:].reshape(-1, 4)
    moved = ops.q_multiply(dq, q)
    q = torch.cat([q[:1], moved[1:]], 0)
    return torch.cat([frame[:3], q.reshape(-1)])


def ik(skel: Skeleton, frame, joint: str, target, s: Settings):
    """The frame [D] with `joint` moved toward target [3]: ik_iterations
    steps of (J^T J + (damping + prior) I) d = J^T r + prior * deltas from
    deltas of 0.02, r = tip - target."""
    deltas = torch.full((3 * skel.n_joints,), 0.02, dtype=frame.dtype,
                        device=frame.device)
    eye = torch.eye(deltas.shape[0], dtype=frame.dtype, device=frame.device)

    def tip(d):
        return skel.joint(_apply_deltas(frame, d.reshape(-1, 3)), joint)[0] \
            - target

    for _ in range(s.ik_iterations):
        r = tip(deltas)
        j = _jacobian(tip, deltas)
        a = j.T @ j + (s.ik_damping + s.ik_prior) * eye
        deltas = deltas - torch.linalg.solve(a, j.T @ r
                                             + s.ik_prior * deltas)
    return _apply_deltas(frame, deltas.reshape(-1, 3))


def blend(frames, fi: int, delta, window: int):
    """frames [T, D] with delta added at fi and linearly less over the
    window // 2 frames on each side (factor 1 - |off| / (w + 1))."""
    w = window // 2
    out = frames.clone()
    for off in range(-w, w + 1):
        k = fi + off
        if 0 <= k < len(frames):
            out[k] = out[k] + delta * (1.0 - abs(off) / (w + 1))
    return out


def ik_targets(graph: Graph, actions, steps) -> list:
    """The IK constraints of a request's keyframes: (output frame, joint,
    position [3] with NaN free) per keyframe of each step's node, in step
    order; steps [(key, start frame, end frame)]."""
    out, a = [], -1
    names = [x.name for x in actions]
    seen = None
    for key, start, end in steps:
        if key[0] != seen:  # the next action of the request
            a = names.index(key[0], a + 1)
            seen = key[0]
        labels = graph.labels[tuple(key)]
        n_can = max(graph.n_canonical[tuple(key)] - 1, 1)
        for joint, pos, label in actions[a].keyframes:
            if label in labels:
                fi = start + int(round(labels[label] / n_can * (end - start)))
                out.append((fi, joint, pos))
    return out


# -- the whole request: the reference in the program's place ------------------

def run_request(m, skel: Skeleton, graph: Graph, mg_input: dict, draw,
                s: Settings) -> dict:
    """One request -> what the judge reads of the program: the steps
    [(key, latent, start frame, end frame)], each step's LM start, its
    canonical clip [F, D], the converted frames before the IK, and the
    frames after it.  draw(key, n) -> (components [n], normals [n, L]),
    the pools' noise in the program's order."""
    dt, dev = m.mean.dtype, m.mean.device
    start_pos, heading, actions = parse(mg_input)
    start = start_transform(start_pos, heading, dt, dev)
    steps, starts, clips, draws = [], [], [], []
    prev_key, prev_last = None, None
    for action in actions:
        path = (None if action.points is None else ops.Path(
            torch.as_tensor(action.points[None], dtype=dt, device=dev),
            s.granularity))
        full = None if path is None else float(path.full_arc[0])
        key, travelled, is_last = graph.start_node(action.name, prev_key), \
            0.0, False
        while True:
            st = step_set(graph, action, path, key, travelled, prev_last,
                          is_last, start, s, dt, dev)
            comp, z = draw(key, s.n_random_samples)
            draws.append((key, comp, z))
            cand = pool(m, st.node, comp, z)
            e = error(m, skel, st, cand)
            s0 = cand[int(e.argmin())]
            latent = refine(m, skel, st, s0, s)[0]
            clip = emit(m, st, latent, s.window)
            starts.append(s0)
            clips.append(clip)
            steps.append((key, latent))
            prev_last, prev_key = clip[-1], key
            if path is not None:
                travelled = closest_point(path, clip[-1, :3], travelled,
                                          travelled + s.look_ahead, full, s)
            if graph.node_type[key] in (END, SINGLE) or (
                    path is not None and travelled >= full):
                break
            ended = path is not None and end_condition(
                clip[-1, :3].cpu().numpy(), travelled,
                graph.arc_of_end(action.name, s), full,
                action.points[-1])[0]
            key, kind = graph.next_node(key, ended, path is not None)
            if key is None:
                key = prev_key
                break
            is_last = kind == END
    # the conversion, then the keyframe IK
    frames, ranges = None, []
    for key, latent in steps:
        prev = None if frames is None else frames[-1]
        clip, n, _ = convert_clip(m, graph.index(key), latent, prev, start,
                                  s.window)
        frames = clip if frames is None else torch.cat([frames, clip])
        ranges.append((key, len(frames) - n, len(frames) - 1))
    pre_ik, final = frames, frames.clone()
    for fi, joint, pos in ik_targets(graph, actions, ranges):
        fi = min(max(fi, 0), len(final) - 1)
        cur, _ = skel.joint(final[fi], joint)
        target = torch.where(torch.isnan(torch.as_tensor(pos, device=dev)),
                             cur, torch.as_tensor(pos, dtype=dt, device=dev))
        solved = ik(skel, final[fi], joint, target, s)
        final = blend(final, fi, solved - final[fi], s.interpolation_window)
    return {"steps": [(k, lat, a, b) for (k, lat), (_, a, b) in
                      zip(steps, ranges)],
            "starts": starts, "clips": clips, "draws": draws,
            "pre_ik": pre_ik, "final": final}
