"""The constrained crowd: `synthesis.constrained_walk.
constrained_walk_full_crowd`, one crowd walk after another.

Reads from the traffic file: characters, steps, candidates,
max_step_frames, lm_iters, lm_threshold, window, path_granularity, the
path's shape (`generate.paths`), start (the start state), judged (the
characters the reference judges).  The walks' noise comes from
`generate.walk_draws` through the entry's `draws=` hook.

To judge the walk stage by stage, the driver keeps the latent each step
emitted: in the judged walk alone it observes the step's end
(`constrained_walk._emit_step`, handed the chosen latents [C, L]) and
keeps a reference to that argument, which costs no launch.  Where the
program no longer makes that call, the walk's latents are missing and the
judge says so (`latents_missing`), so `correct` comes out false with that
reason rather than the run failing."""

from __future__ import annotations

import contextlib

import torch

from .. import generate, model
from ..reference import judge as judge_mod
from ..reference import model as ref_model
from ..reference import ops as ref_ops
from ..reference import walks as ref_walks
from . import common


class Driver(common.Driver):
    RATE = "frames_per_s.crowd"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        from morphablegraphs_tpu_torch.models import graph as graph_mod
        from morphablegraphs_tpu_torch.models import skeleton as sk
        from morphablegraphs_tpu_torch.ops import spline_path
        from morphablegraphs_tpu_torch.synthesis import constrained_walk
        self.cw = constrained_walk
        tr = traffic
        self.graph = graph_mod.build_graph_from_dict(self.graph_dict)
        self.skeleton, _ = sk.load_bvh(model.REF_BVH)
        self.graph.skeleton = self.skeleton
        self.stacked = graph_mod.stack_graph(self.graph, device=device)
        self.control_points = generate.paths(seed, tr["characters"], tr)
        # each path is built on the host and the stack moved to the card
        # in one copy a leaf, not in a thousand builds of small launches
        self.paths = spline_path.map_leaves(spline_path.stack_paths([
            spline_path.build(p, unconstrained_dims=(1,),
                              granularity=tr["path_granularity"],
                              device="cpu")
            for p in self.control_points]), lambda x: x.to(device))
        self.start = torch.full((tr["characters"],), self.stacked.node_id(
            ("walk", tr["start"])), dtype=torch.long, device=device)
        self.cfg = constrained_walk.WalkConfig(
            max_step_frames=tr["max_step_frames"],
            n_samples=tr["candidates"], lm_iters=tr["lm_iters"],
            lm_threshold=tr["lm_threshold"], lm_frozen=True,
            window=tr["window"])

    # -- one walk --------------------------------------------------------
    def draws(self, index: int):
        tr, st = self.traffic, self.stacked
        return generate.walk_draws(
            self.seed, index, tr["steps"], tr["characters"], tr["candidates"],
            st.gmm_weights.shape[-1], st.gmm_means.shape[-1], st.n_nodes,
            self.device)

    def run_walk(self, draws, observe: bool = False):
        seen = []
        with self._emitted(seen) if observe else contextlib.nullcontext():
            segs, n_frames, ids, _ = self.cw.constrained_walk_full_crowd(
                self.skeleton, self.stacked, self.paths, self.start,
                self.traffic["steps"], draws=lambda t: draws[t],
                cfg=self.cfg)
        latents = (torch.stack(seen, 1)
                   if len(seen) == self.traffic["steps"] else None)
        return segs, n_frames, ids, latents

    @contextlib.contextmanager
    def _emitted(self, into: list):
        """Within: each step's chosen latents [C, L], as the step's end is
        handed them, appended to `into`."""
        emit_step = getattr(self.cw, "_emit_step", None)
        if emit_step is None:
            yield
            return

        def spy(g, path, state, s, *a, **kw):
            into.append(s)
            return emit_step(g, path, state, s, *a, **kw)

        self.cw._emit_step = spy
        try:
            yield
        finally:
            self.cw._emit_step = emit_step

    @contextlib.contextmanager
    def selection_inputs(self, into: list):
        """Within: every selection launch's inputs (mop, alphas, table,
        cfg) appended to `into`."""
        kernels = self.cw.kernels
        score = kernels.score_locomotion_candidates

        def spy(mop, alphas, table, cfg, *a, **kw):
            into.append((mop, alphas, table, cfg))
            return score(mop, alphas, table, cfg, *a, **kw)

        kernels.score_locomotion_candidates = spy
        try:
            yield
        finally:
            kernels.score_locomotion_candidates = score

    # -- judging ---------------------------------------------------------
    def _config(self):
        tr = self.traffic
        return ref_walks.CrowdConfig(tr["candidates"], tr["max_step_frames"],
                                     tr["lm_iters"], tr["lm_threshold"],
                                     tr["window"])

    def judge(self, kept, device) -> dict:
        """kept: one walk's judged rows (frames, n_frames, node ids,
        latents, draws) -> the numbers compared."""
        frames, n_frames, ids, latents, draws = kept
        if latents is None:
            return judge_mod.missing_latents(self.traffic["steps"])
        m = ref_model.build(self.graph_dict, torch.float64, device)
        idx = self.judged_rows()
        path = ref_ops.Path(torch.as_tensor(
            self.control_points[idx.cpu().numpy()], dtype=torch.float64,
            device=device), self.traffic["path_granularity"])
        ids = common.relabel(ids, self.stacked.node_keys, m.keys)
        return judge_mod.crowd(
            m, path, self.root_offset(torch.float64, device),
            common.to(draws, device), frames.to(device), n_frames.to(device),
            ids.to(device), latents.to(device), self._config())

    def reference_walk(self, draws, dtype, device, round_fn=None):
        """The reference in the program's place, on the whole crowd ->
        (frames, n_frames, node ids in the program's labels, latents)."""
        m = ref_model.build(self.graph_dict, dtype, device, round_fn)
        path = ref_ops.Path(torch.as_tensor(self.control_points, dtype=dtype,
                                            device=device),
                            self.traffic["path_granularity"])
        start = torch.full((self.traffic["characters"],),
                           m.index(self.traffic["start"]), device=device)
        moved = common.to(draws, device)
        frames, n_frames, ids, lat = ref_walks.crowd_walk(
            m, path, start, self.traffic["steps"], lambda t: moved[t],
            self._config(), self.root_offset(dtype, device))
        return (frames, n_frames,
                common.relabel(ids, m.keys, self.stacked.node_keys), lat)

    def root_offset(self, dtype, device):
        return torch.tensor(model.ROOT_OFFSET, dtype=dtype, device=device)

    # -- counts ----------------------------------------------------------
    def shapes(self) -> dict:
        tr, st = self.traffic, self.stacked
        g8 = -(-(tr["path_granularity"] + 1) // 8) * 8
        common_shape = dict(c=tr["characters"], k=st.k_s_max, m=st.n_nodes,
                            nb=st.n_basis_max, d=st.n_dim,
                            t=tr["max_step_frames"])
        return {"emit": [dict(common_shape, has_prev=t > 0,
                              window=tr["window"])
                         for t in range(tr["steps"])],
                "walk": dict(c=tr["characters"], steps=tr["steps"],
                             n=tr["candidates"], k=st.k_s_max,
                             l_dim=st.gmm_means.shape[-1],
                             n_comp=st.gmm_weights.shape[-1],
                             nb=st.n_basis_max, d=st.n_dim, m=st.n_nodes,
                             t=tr["max_step_frames"],
                             g1=tr["path_granularity"] + 1,
                             lm_iters=tr["lm_iters"]),
                "b1_table_rows": g8}

