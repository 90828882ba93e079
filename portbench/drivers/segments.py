"""Random walks in segments: `synthesis.walk.random_walk_segments`, one
batch of walks after another.

Reads from the traffic file: characters, steps, max_step_frames, window,
start (the start state), judged (the characters the reference judges).
One draw a step per character, from `generate.walk_draws` through the
entry's `draws=` hook."""

from __future__ import annotations

import torch

from ..reference import judge as judge_mod
from ..reference import model as ref_model
from ..reference import walks as ref_walks
from .. import generate
from . import common


class Driver(common.Driver):
    RATE = "frames_per_s.segments"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        from morphablegraphs_tpu_torch.models import graph as graph_mod
        from morphablegraphs_tpu_torch.synthesis import walk
        self.walk_mod = walk
        self.graph = graph_mod.build_graph_from_dict(self.graph_dict)
        self.stacked = graph_mod.stack_graph(self.graph, device=device)
        self.start = torch.full((traffic["characters"],),
                                self.stacked.node_id(("walk",
                                                      traffic["start"])),
                                dtype=torch.long, device=device)

    def draws(self, index: int):
        tr, st = self.traffic, self.stacked
        return generate.walk_draws(
            self.seed, index, tr["steps"], tr["characters"], 1,
            st.gmm_weights.shape[-1], st.gmm_means.shape[-1], st.n_nodes,
            self.device)

    def run_walk(self, draws, observe: bool = False):
        tr = self.traffic
        frames, n_frames, ids, _ = self.walk_mod.random_walk_segments(
            self.stacked, self.start, tr["steps"], lambda t: draws[t],
            max_step_frames=tr["max_step_frames"], window=tr["window"],
            use_time=True)
        return frames, n_frames, ids, None

    def judge(self, kept, device) -> dict:
        frames, n_frames, ids, _, draws = kept
        m = ref_model.build(self.graph_dict, torch.float64, device)
        tr = self.traffic
        start = torch.full((frames.shape[0],), m.index(tr["start"]),
                           device=device)
        return judge_mod.segments(
            m, start, common.to(draws, device), frames.to(device),
            n_frames.to(device),
            common.relabel(ids.to(device), self.stacked.node_keys, m.keys),
            tr["max_step_frames"], tr["window"])

    def reference_walk(self, draws, dtype, device, round_fn=None):
        """The reference in the program's place, on the whole batch."""
        m = ref_model.build(self.graph_dict, dtype, device, round_fn)
        tr = self.traffic
        start = torch.full((tr["characters"],), m.index(tr["start"]),
                           device=device)
        moved = common.to(draws, device)
        frames, n_frames, ids, _ = ref_walks.random_segments(
            m, start, tr["steps"], lambda t: moved[t], tr["max_step_frames"],
            tr["window"])
        return frames, n_frames, common.relabel(ids, m.keys,
                                                self.stacked.node_keys), None

    def shapes(self) -> dict:
        tr, st = self.traffic, self.stacked
        return {"emit": [dict(c=tr["characters"], k=st.k_s_max,
                              m=st.n_nodes, nb=st.n_basis_max, d=st.n_dim,
                              t=tr["max_step_frames"], has_prev=False,
                              window=tr["window"])
                         for _ in range(tr["steps"])],
                "segments": dict(c=tr["characters"], steps=tr["steps"],
                                 k=st.k_s_max, k_t=st.k_t_max,
                                 l_dim=st.gmm_means.shape[-1],
                                 nb=st.n_basis_max, d=st.n_dim,
                                 m=st.n_nodes, t=tr["max_step_frames"],
                                 f=st.max_canonical, window=tr["window"])}
