"""The REST service's sequential path: `serve.rest.make_app(MGContext(...))`
on `POST /run_morphablegraphs`, one request after another (a closed loop,
one request in flight, as the service answers one at a time), the
dispatcher called in process with no socket.  Each request is parsed,
generated, post-processed, its events built and its motion exported to
BVH; the frames of a request are those of the BVH it answered.

The mix (`request`): requests in pairs, one walk and one action request
each, their order drawn from the seed.  Every path starts at a heading
within +-`heading0` and turns by up to +-`turn` at each control point
after the first (the crowd's paths, `traffic/crowd_root.json`).  A walk
request follows a Hips path of `walk_points` control points over
`walk_cm`; an action request walks straight for `action_walk_cm`, picks
with a RightHand `start_contact` keyframe `contact_side_cm` to the right
of the walk's end and `contact_height_cm` above the model's ground
(`ground`), carries straight along `carry_cm` and places with an
`end_contact` keyframe placed the same way beside the point one carry step
along the carry path.  The carry action is one step of its one primitive
(start and end state at once), so the place stands there, and `carry_cm`
sets only the path that step heads along.  No keyframe has a time.
Warm-up request -1 is a walk request, -2 an action request.  The service
runs its standard settings (`utils.config.default_config`: 100 samples,
10 LM iterations); the CPU tests make them smaller on the driver they
build (`ctx.configure`, `settings`).

The pools are drawn from the seed through the context's `sampler` hook:
per request a generator seeded from the seed and the request's index
draws each pool's components (Gumbel) and standard normals, and the
pool is worked out from the mixture in float64 (`reference.requests.
pool`) and handed over in float32, so the reference knows every pool.

To judge the request stage by stage, the driver keeps, in the judged
request alone, the pools' noise, each step's LM start (the `starts`
argument of `generator._refine_starts`), its canonical clip (what
`generator.finalize_step` returns) and the converted frames before the
keyframe IK (the `frames` argument of `postprocess.post_process_motion`),
references to what those calls are handed or return, which costs no
launch; and reads the service's `MGContext.last_result`.  A program whose
service has no `last_result` cannot be judged: the driver stops at once
(exit code 1)."""

from __future__ import annotations

import contextlib
import json
import math
import re

import numpy as np
import torch

from .. import generate, model, model_actions
from ..reference import judge_requests
from ..reference import model as ref_model
from ..reference import ops as ref_ops
from ..reference import requests as rq
from . import common

KINDS = ("walk", "action")


def _polyline(rng, start, heading, n_points, length, turn):
    """n_points control points from start, length / (n_points - 1) apart,
    the heading turning by up to +-turn at each -> (points, the last
    segment's heading)."""
    pts, p = [np.asarray(start, np.float64)], np.asarray(start, np.float64)
    seg = length / (n_points - 1)
    for i in range(1, n_points):
        if i > 1:
            heading += rng.uniform(-turn, turn)
        p = p + seg * np.array([math.sin(heading), 0.0, math.cos(heading)])
        pts.append(p)
    return pts, heading


def _path_json(pts):
    return [{"position": [float(p[0]), None, float(p[2])]} for p in pts]


def _contact(rng, tr, point, heading, ground):
    """A hand target beside `point` on the right of a path heading
    `heading`, above the ground."""
    right = np.array([-math.cos(heading), 0.0, math.sin(heading)])
    target = point + rng.uniform(*tr["contact_side_cm"]) * right
    target[1] = ground + rng.uniform(*tr["contact_height_cm"])
    return [float(v) for v in target]


def ground(m) -> float:
    """The height of the model's ground above the path's plane: the
    skeleton's rest pose stands on y = 0 (`REF_BVH`'s root offset is its
    legs), so its feet stand where the model lifts its root, the mean root
    height of the mean clip of the walk's first node."""
    i = m.keys.index(("walk", model.WALK_STATES[0]))
    f = int(m.n_canonical[i])
    times = rq.canonical_times(f, f, m.mean.dtype, m.mean.device)
    return float((ref_ops.basis_matrix(m.knots[i], times)
                  @ m.mean[i][:, 1]).mean())


def request(seed: int, index: int, tr: dict, carry_step: float,
            ground_cm: float):
    """(kind, the request JSON) of request `index` of a run."""
    if index < 0:
        kind = KINDS[(-index - 1) % 2]
    else:
        pair = np.random.default_rng(generate.stream_seed(
            seed, 2 ** 31 + index // 2))
        kind = KINDS[(index + int(pair.integers(2))) % 2]
    rng = np.random.default_rng(generate.stream_seed(seed, 2 ** 30 + index))
    h0 = rng.uniform(-tr["heading0"], tr["heading0"])
    pose = {"position": [0.0, 0.0, 0.0],
            "orientation": [0.0, math.degrees(h0), 0.0]}

    def path(start, heading, points, cm):
        n = int(rng.integers(points[0], points[1] + 1))
        return _polyline(rng, start, heading, n, rng.uniform(*cm),
                         tr["turn"])

    if kind == "walk":
        pts, _ = path(np.zeros(3), h0, tr["walk_points"], tr["walk_cm"])
        actions = [{"action": "walk", "constraints": [{
            "joint": "Hips", "trajectoryConstraints": _path_json(pts)}]}]
        return kind, {"startPose": pose, "elementaryActions": actions}
    walk, h = path(np.zeros(3), h0, (2, 2), tr["action_walk_cm"])
    pick = _contact(rng, tr, walk[-1], h, ground_cm)
    carry, h = path(walk[-1], h + rng.uniform(-tr["turn"], tr["turn"]),
                    (2, 2), tr["carry_cm"])
    first = (carry[1] - carry[0]) / np.linalg.norm(carry[1] - carry[0])
    place = _contact(rng, tr, carry[0] + carry_step * first, h, ground_cm)

    def keyframe(joint, pos, label):
        return {"joint": joint, "keyframeConstraints": [{
            "position": pos, "semanticAnnotation": {label: True}}]}

    actions = [
        {"action": "walk", "constraints": [{
            "joint": "Hips", "trajectoryConstraints": _path_json(walk)}]},
        {"action": "pickRight", "constraints": [
            keyframe("RightHand", pick, "start_contact")]},
        {"action": "carryRight", "constraints": [{
            "joint": "Hips", "trajectoryConstraints": _path_json(carry)}]},
        {"action": "placeRight", "constraints": [
            keyframe("RightHand", place, "end_contact")]}]
    return kind, {"startPose": pose, "elementaryActions": actions}


class Driver(common.Driver):
    # the benchmark's frame rate split by cell; a service cell reports it
    # under the crowd's name and bound until the benchmark splits it anew
    RATE = "frames_per_s.crowd"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from morphablegraphs_tpu_torch.serve import rest
        if not hasattr(rest.MGContext, "last_result"):
            raise SystemExit(
                "portbench: this program's service hands out no "
                "MotionResult (MGContext.last_result): its requests cannot "
                "be judged")
        from morphablegraphs_tpu_torch.models import graph as graph_mod
        from morphablegraphs_tpu_torch.models import skeleton as sk
        from morphablegraphs_tpu_torch.utils.config import default_config
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.graph_dict = model_actions.graph_dict(config, seed)
        graph = graph_mod.build_graph_from_dict(self.graph_dict)
        graph.skeleton, _ = sk.load_bvh(model_actions.bvh(config))
        algorithm = default_config()
        self.settings = rq.Settings(**{
            k: algorithm[k] for k in ("n_random_samples", "lm_iterations")})
        self.ctx = rest.MGContext(graph, algorithm, device=device,
                                  sampler=self._sample)
        self.app = rest.make_app(self.ctx)
        # the pools' mixtures, in float64 on the device
        self.m = ref_model.build(self.graph_dict, torch.float64, device)
        self.log_w = torch.log(torch.clamp(self.m.weights, min=1e-30))
        carry = [a for a in config["actions"]
                 if a["action"] == "carryRight"][0]
        self.carry_step = self.graph_dict["subgraphs"]["carryRight"][
            "nodes"][carry["primitive"]]["stats"]["average_step_length"]
        self.ground = ground(self.m)
        self._gen, self._draws = None, None
        self.kept = None
        # the frames answered by requests 0, 1, ...
        self.done = []

    # -- one request -------------------------------------------------------
    def request(self, index: int):
        return request(self.seed, index, self.traffic, self.carry_step,
                       self.ground)

    def _generator(self, index: int):
        return torch.Generator(device=self.device).manual_seed(
            generate.stream_seed(self.seed, 2 ** 21 + index))

    def _noise(self, gen, node_key, n: int):
        """A pool's components [n] and standard normals [n, L]."""
        i = self.m.keys.index(tuple(node_key))
        tiny = torch.finfo(torch.float64).tiny
        u = torch.rand((n, self.log_w.shape[-1]), generator=gen,
                       dtype=torch.float64, device=self.device)
        gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
        comp = torch.argmax(self.log_w[i] + gumbel, -1)
        z = torch.randn((n, self.m.means.shape[-1]), generator=gen,
                        dtype=torch.float64, device=self.device)
        return i, comp, z

    def _sample(self, node_key, n: int, gmm=None):
        if gmm is not None:
            raise ValueError("the service cell's graph has no transition "
                             "models")
        i, comp, z = self._noise(self._gen, node_key, n)
        if self._draws is not None:
            self._draws.append((tuple(node_key), comp, z))
        return rq.pool(self.m, i, comp, z).float()

    def walk(self, index: int, keep: bool = False) -> int:
        """Request `index` through the service -> the frames it answered;
        with keep (the judged request) its observations in `kept`."""
        kind, req = self.request(index)
        self._gen = self._generator(index)
        obs = {"starts": [], "clips": [], "pre_ik": None}
        self._draws = [] if keep else None
        self.ctx.last_result = None
        with self._observed(obs) if keep else contextlib.nullcontext():
            status, _, payload = self.app("POST", "/run_morphablegraphs",
                                          json.dumps(req).encode())
        if status != 200:
            raise RuntimeError(f"request {index} ({kind}) answered {status}: "
                               f"{payload[:2000]!r}")
        frames = int(re.search(rb"Frames: (\d+)", payload).group(1))
        res = self.ctx.last_result
        if index >= 0:
            self.done.append(frames)
        if keep:
            self.kept = dict(
                obs, kind=kind, request=req, draws=self._draws,
                steps=None if res is None else [
                    (s.node_key, s.parameters, s.start_frame, s.end_frame)
                    for s in res.steps],
                final=None if res is None else res.frames)
        self._draws = None
        return frames

    @contextlib.contextmanager
    def _observed(self, obs: dict):
        """Within: each step's LM start and canonical clip, and the frames
        the post-processing is handed, kept in obs."""
        from morphablegraphs_tpu_torch.synthesis import generator, postprocess
        refine = generator._refine_starts
        finalize = generator.finalize_step
        post = postprocess.post_process_motion

        def refine_spy(skeleton, prim, sc, starts, *a, **kw):
            obs["starts"].append(starts[0])
            return refine(skeleton, prim, sc, starts, *a, **kw)

        def finalize_spy(*a, **kw):
            out = finalize(*a, **kw)
            obs["clips"].append((out[0], out[1]))
            return out

        def post_spy(skeleton, frames, *a, **kw):
            obs["pre_ik"] = np.array(frames, copy=True)
            return post(skeleton, frames, *a, **kw)

        generator._refine_starts = refine_spy
        generator.finalize_step = finalize_spy
        postprocess.post_process_motion = post_spy
        try:
            yield
        finally:
            generator._refine_starts = refine
            generator.finalize_step = finalize
            postprocess.post_process_motion = post

    # -- judging -----------------------------------------------------------
    def _reference(self, dtype, device, round_fn=None):
        m = ref_model.build(self.graph_dict, dtype, device, round_fn)
        return (m, rq.Skeleton(model_actions.tree(self.config), dtype,
                               device), rq.Graph(self.graph_dict, m.keys))

    def judge(self, kept, device) -> dict:
        """kept: the judged request's observations -> the numbers
        compared."""
        m, skel, graph = self._reference(torch.float64, device)

        def t(x):
            return torch.as_tensor(x, device=device).to(torch.float64)

        obs = dict(
            request=kept["request"],
            steps=None if kept["steps"] is None else [
                (tuple(k), t(lat), int(a), int(b))
                for k, lat, a, b in kept["steps"]],
            draws=[(k, c.to(device), t(z)) for k, c, z in kept["draws"]],
            starts=[t(x) for x in kept["starts"]],
            clips=[(t(f), int(n)) for f, n in kept["clips"]],
            pre_ik=None if kept["pre_ik"] is None else t(kept["pre_ik"]),
            final=None if kept["final"] is None else t(kept["final"]))
        out = judge_requests.request(m, skel, graph, obs, self.settings)
        out["kind"] = KINDS.index(kept["kind"])
        return out

    def reference_request(self, index: int, dtype, device, round_fn=None):
        """The reference in the program's place on request `index` -> its
        observations, as `walk` keeps the program's.  round_fn rounds the
        matrix products' operands in value only: the jacobians of its LM
        and IK pass through it unchanged."""
        if round_fn is not None:
            rounding = round_fn

            def round_fn(x):
                return x + (rounding(x) - x).detach()

        m, skel, graph = self._reference(dtype, device, round_fn)
        kind, req = self.request(index)
        gen = self._generator(index)

        def draw(key, n):
            _, comp, z = self._noise(gen, key, n)
            return comp, z

        out = rq.run_request(m, skel, graph, req, draw, self.settings)
        return dict(kind=kind, request=req, draws=out["draws"],
                    steps=[(k, lat, a, b) for k, lat, a, b in out["steps"]],
                    starts=out["starts"],
                    clips=[(c, len(c)) for c in out["clips"]],
                    pre_ik=out["pre_ik"], final=out["final"])

    # -- counts ------------------------------------------------------------
    def shapes(self) -> dict:
        """The request's widths and the mean frames a request answered over
        requests 0, 1, ... (`counts.request`; its steps and IK targets
        the readers take from the program's tracer)."""
        m, cfg = self.m, self.config
        return {"service": {"warm": self.traffic["warm_walks"]},
                "request": dict(
                    frames=sum(self.done) / max(len(self.done), 1),
                    n=self.settings.n_random_samples,
                    lm_iters=self.settings.lm_iterations,
                    ik_iters=self.settings.ik_iterations,
                    k=m.k_s, l_dim=m.means.shape[-1],
                    n_comp=m.weights.shape[-1], nb=m.n_basis, d=m.n_dim,
                    joints=cfg["n_joints"],
                    t=rq.pad_frames(cfg["n_canonical_frames"]),
                    g1=self.settings.granularity + 1)}
