"""constrained_sampling_mode="cluster_tree_search" in the port's two entry
points (`MotionGenerator`, `MGStatePlanner`) against the JAX package's, on
the CPU.

The trees are built by the JAX package (PRNG-key samples, 500 latents a
node) and carried across by `ClusterTree.save` / `load`; leftStance keeps
none, so it samples its mixture as in JAX.  A constrained step's pool is
the node's whole tree data, ranked by the exact evaluator; the draws that
remain (planning options, steps without a tree) are JAX's, replayed by
`torch_parity.jax_key_sampler`, which also takes the key JAX takes and
leaves unused at a cluster-tree step.  Tolerances: whole requests at
`torch_parity.assert_request_matches`' bounds at 2 LM iterations (as the
JAX package's own cluster-mode test runs them); a planner step at one LM
iteration to the planner tests' 1e-2 (`SEQ_ATOL_1` of
tests/test_torch_state_planner.py), the chosen tree row exactly."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.construct import space_partitioning as spj  # noqa: E402
from morphablegraphs_tpu.synthesis import state_planner as plj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402
from morphablegraphs_tpu_torch.construct import \
    space_partitioning as spt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import generator as gen_t  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import state_planner as plt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import (KEYFRAME_INPUT, WALK_INPUT,  # noqa: E402,F401
                          release_jax_executables)

NO_TREE = ("walk", "leftStance")
PLANNER_ATOL = 1e-2


@pytest.fixture(scope="module")
def tree_graphs(tmp_path_factory):
    g_j, g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)
    tmp = tmp_path_factory.mktemp("trees")
    key = jax.random.PRNGKey(0)
    for node_key, node in g_j.nodes.items():
        key, sub = jax.random.split(key)
        if node_key == NO_TREE:
            continue
        node.cluster_tree = spj.build_cluster_tree_for_primitive(
            sub, node.primitive, n_samples=500, max_level=2)
        prefix = str(tmp / "_".join(node_key))
        node.cluster_tree.save(prefix)
        g_t.nodes[node_key].cluster_tree = spt.ClusterTree.load(prefix,
                                                                device="cpu")
    return g_j, g_t


def _config(lm_iterations):
    cfg = default_config()
    cfg.update(constrained_sampling_mode="cluster_tree_search",
               lm_iterations=lm_iterations)
    return cfg


class _Picks:
    """Records, for every pool the port scores, its rows, its argmin and
    whether it is a tree's device copy of its data."""

    def __init__(self, monkeypatch, graph):
        self.rows = []
        trees = {n.cluster_tree.device_data("cpu").data_ptr()
                 for n in graph.nodes.values() if n.cluster_tree is not None}
        score = gen_t.score_pool

        def spy(skel, prim, sc, pool, *a, **kw):
            errors = score(skel, prim, sc, pool, *a, **kw)
            self.rows.append((pool.shape[0], int(torch.argmin(errors)),
                              pool.data_ptr() in trees))
            return errors
        monkeypatch.setattr(gen_t, "score_pool", spy)


@pytest.mark.parametrize("mg_input", [WALK_INPUT, KEYFRAME_INPUT],
                         ids=["trajectory", "keyframe"])
def test_motion_generator_cluster_mode_matches_jax(tree_graphs, mg_input,
                                                   monkeypatch):
    """Every constrained step of a node with a tree scores the tree's 500
    rows; leftStance's steps score a 100-draw pool; the request matches
    JAX's through the replayed keys."""
    picks = _Picks(monkeypatch, tree_graphs[1])
    cfg = _config(2)
    cfg["debug_max_step"] = 3
    res_j, res_t, counts = tp.request_both(tree_graphs, mg_input, cfg, 0)
    tp.assert_request_matches(res_j, res_t)
    steps = [(n, t) for n, _, t in picks.rows if n in (100, 500)]
    assert len(steps) == len(res_t.steps)
    for (n, from_tree), s in zip(steps, res_t.steps):
        assert (n, from_tree) == ((100, False) if s.node_key == NO_TREE
                                  else (500, True))


@pytest.mark.parametrize("lm", ["one_iteration", "none"])
def test_planner_cluster_mode_matches_jax(tree_graphs, monkeypatch, lm):
    """A constrained planner step on a node with a tree scores the tree's
    500 rows, on leftStance a 6-draw pool; the step matches JAX's at one LM
    iteration, and without the LM (the step is the chosen row itself) to
    1e-3, so the same row was chosen."""
    g_j, g_t = tree_graphs
    picks = _Picks(monkeypatch, g_t)
    cfg = _config(1)
    if lm == "none":
        cfg["local_optimization_mode"] = "none"
    settings = dict(n_samples=6)
    for node_key in (("walk", "rightStance"), NO_TREE):
        p_j = plj.MGStatePlanner(g_j, plj.MGStatePlanningSettings(**settings),
                                 config=dict(cfg), seed=0)
        p_t = plt.MGStatePlanner(g_t, plt.MGStatePlanningSettings(**settings),
                                 config=dict(cfg), seed=0, device="cpu",
                                 sampler=tp.jax_key_sampler(g_j, 0))
        buf = [tp.prev_frame(g_t.skeleton.n_frame_params, 3.0, 20.0, seed=7)]
        kw = dict(target_pos=[4.0, 0.0, 38.0], target_dir=[0.1, 1.0])
        e_j = p_j.generate_step(node_key, buf, **kw)
        e_t = p_t.generate_step(node_key, buf, **kw)
        assert e_t.node_key == e_j.node_key
        assert e_t.state.frames.shape == e_j.state.frames.shape
        np.testing.assert_allclose(
            e_t.state.frames, e_j.state.frames,
            atol=PLANNER_ATOL if lm == "one_iteration" else 1e-3)
        assert picks.rows[-1][0] == (6 if node_key == NO_TREE else 500)
        assert picks.rows[-1][2] == (node_key != NO_TREE)


def test_tree_pool_lives_on_the_generator_device(tree_graphs):
    """cluster_pool hands the tree's one device copy to the step (no copy
    per step), and None without the mode or without a tree."""
    g_t = tree_graphs[1]
    node = g_t.nodes[("walk", "rightStance")]
    cfg = _config(1)
    a = gen_t.cluster_pool(cfg, node, "cpu")
    assert a is gen_t.cluster_pool(cfg, node, "cpu")
    np.testing.assert_array_equal(a.numpy(), node.cluster_tree.data)
    assert gen_t.cluster_pool(default_config(), node, "cpu") is None
    assert gen_t.cluster_pool(cfg, g_t.nodes[NO_TREE], "cpu") is None
