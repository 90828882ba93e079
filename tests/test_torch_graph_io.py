"""The packaged-graph path of the port against the JAX package: zips
written by either package's zip_writer (format versions 1-4, underscore
action names, packaged statistics, transition models, hand poses, a pfnn/
section, skeleton.json) loaded by both `load_graph`s; random walks on the
JAX generator's replayed draws; and the cluster trees (native, reference
JSON and pickled), which both entry points search under
cluster_tree_search.

Node keys, node types, edges, statistics, joint weights and the skeleton
compare exactly, and so do the primitives' tensors (both cast the same
float64 numpy to float32) and the pfnn arrays; transition models through
their conditioned mixtures to rtol 1e-5 / atol 1e-5."""

import json
import logging
import random
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.construct.space_partitioning import \
    build_cluster_tree_for_primitive  # noqa: E402
from morphablegraphs_tpu.models import graph as gj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.models import transition_model as tmj  # noqa: E402
from morphablegraphs_tpu.models.zip_writer import \
    write_graph_zip as write_zip_j  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as gt  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.models import transition_model as tmt  # noqa: E402
from morphablegraphs_tpu_torch.models.zip_writer import \
    write_graph_zip as write_zip_t  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import state_planner as spt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis.motion_generator import \
    MotionGenerator  # noqa: E402
from morphablegraphs_tpu_torch.utils.config import default_config  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import WALK_INPUT, release_jax_executables  # noqa: E402,F401

WRITERS = {"jax": (write_zip_j, skj), "port": (write_zip_t, skt)}
HAND_POSES = {
    "status_change_map": {"attach": "pick", "release": "standard"},
    "right_hand_skeleton": {"joint_names": ["RightHand"]},
    "left_hand_skeleton": {"joint_names": ["LeftHand"]},
    "poses": {"pick": {"RightHand": [0.0, 1.0, 0.0, 0.0],
                       "LeftHand": [1.0, 0.0, 0.0, 0.0]}},
    "skeletonStrings": {"pick": "HIERARCHY"},
}


def _pfnn_data():
    rng = np.random.default_rng(0)
    return {"weights": {k: rng.standard_normal(8).astype(np.float32)
                        for k in ("W0", "W1", "W2", "b0", "b1", "b2")},
            "means": {k: rng.standard_normal(4).astype(np.float32)
                      for k in ("Xmean", "Ymean", "Xstd", "Ystd")}}


@pytest.fixture(scope="module")
def tm_entries():
    """JAX-fitted transition models of the toy graph's standard edges, as
    a zip's transition_models/ entries."""
    g = gj.build_graph_from_dict(synj.make_graph_dict())
    tmj.fit_transition_models_for_graph(g, n_pairs=100, n_components=1)
    return [{"from": f"{f[0]}_{f[1]}", "to": f"{t[0]}_{t[1]}",
             "model": tmj.to_json(m)}
            for f, node in g.nodes.items()
            for t, m in node.transition_models.items()]


def _write(writer, path, variant, tm_entries):
    write, sk = WRITERS[writer]
    skel, _ = sk.load_bvh(synj.TEST_BVH)
    gd = synj.make_graph_dict()
    nodes = {mp: n["mm"] for mp, n in gd["subgraphs"]["walk"]["nodes"].items()}
    info = dict(gd["subgraphs"]["walk"]["info"])
    action, trans = "walk", gd["transitions"]
    kw = dict(start_node=gd["startNode"])
    if variant != "no_stats":
        info["stats"] = {mp: {"average_step_length": 10.0 + i,
                              "n_standard_transitions": 7 + i}
                         for i, mp in enumerate(nodes)}
    if variant == "underscore":
        action = "pick_both"
        trans = {k.replace("walk_", "pick_both_"):
                 [v.replace("walk_", "pick_both_") for v in vs]
                 for k, vs in trans.items()}
        kw = {}
    if variant == "v4_full":
        kw.update(hand_pose_info=HAND_POSES, pfnn_data=_pfnn_data(),
                  transition_models=tm_entries)
    version = {"v1": 1.0, "v3": 3.0, "v4_full": 4.0}.get(variant, 2.0)
    path = write(path, skel, {action: {"nodes": nodes, "info": info}}, trans,
                 format_version=version, **kw)
    if variant == "v4_full":
        # a skeleton.json in place of skeleton.bvh, with explicit weights
        with zipfile.ZipFile(path) as zf:
            entries = {n: zf.read(n) for n in zf.namelist()
                       if n != "skeleton.bvh"}
        weights = [1.0, 0.5, 0.25, 0.75]
        sj = {"root": "Hips", "frame_time": 1 / 60,
              "animated_joints": list(skel.animated_joints),
              "joint_weights": weights,
              "nodes": {name: {"offset": skel.offsets[i].tolist(),
                               "children": [skel.node_names[c] for c, p in
                                            enumerate(skel.parents)
                                            if p == i]}
                        for i, name in enumerate(skel.node_names)}}
        entries["skeleton.json"] = json.dumps(sj).encode()
        with zipfile.ZipFile(path, "w") as zf:
            for n, b in entries.items():
                zf.writestr(n, b)
    return path


def _assert_graphs_equal(g_t, g_j, stats=True):
    assert set(g_t.nodes) == set(g_j.nodes)
    assert g_t.start_node == g_j.start_node
    for key, n_j in g_j.nodes.items():
        n_t = g_t.nodes[key]
        assert (n_t.node_type, n_t.outgoing_edges) == (n_j.node_type,
                                                        n_j.outgoing_edges)
        assert n_t.n_standard_transitions == n_j.n_standard_transitions
        if stats:
            assert n_t.average_step_length == n_j.average_step_length
        else:
            assert n_t.average_step_length > 0.0
        p_t, p_j = n_t.primitive, n_j.primitive
        for f in ("eigen_s", "mean_s", "knots_s", "mean_t_d", "eigen_t_d"):
            np.testing.assert_array_equal(getattr(p_t, f).cpu().numpy(),
                                          np.asarray(getattr(p_j, f)))
        np.testing.assert_array_equal(p_t.gmm.prec_chol.cpu().numpy(),
                                      np.asarray(p_j.gmm.prec_chol))
        assert set(n_t.transition_models) == set(n_j.transition_models)
        x = np.linspace(-1, 1, p_j.n_latent).astype(np.float32)
        for to_key in n_j.transition_models:
            a = n_t.predict_gmm(to_key, torch.as_tensor(x))
            b = n_j.predict_gmm(to_key, jnp.asarray(x))
            for f in ("weights", "means", "cov_chol"):
                np.testing.assert_allclose(getattr(a, f).numpy(),
                                           np.asarray(getattr(b, f)),
                                           rtol=1e-5, atol=1e-5)
    for action, grp in g_j.node_groups.items():
        grp_t = g_t.node_groups[action]
        assert (grp_t.node_keys, grp_t.start_states, grp_t.end_states) == (
            grp.node_keys, grp.start_states, grp.end_states)
    s_t, s_j = g_t.skeleton, g_j.skeleton
    assert (s_t.node_names, s_t.parents, s_t.animated_joints,
            s_t.joint_weights, s_t.frame_time) == (
        s_j.node_names, s_j.parents, s_j.animated_joints, s_j.joint_weights,
        s_j.frame_time)


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("variant", ["v1", "v2", "v3", "v4_full",
                                     "underscore", "no_stats"])
def test_load_graph_matches_jax(writer, variant, tmp_path, tm_entries):
    path = _write(writer, str(tmp_path / "g"), variant, tm_entries)
    g_j = gj.load_graph(path)
    g_t = gt.load_graph(path, device="cpu")
    _assert_graphs_equal(g_t, g_j, stats=variant != "no_stats")
    if variant == "v4_full":
        assert g_t.skeleton.joint_weights == (1.0, 0.5, 0.25, 0.75)
        for part in ("weights", "means"):
            for k, v in g_j.pfnn_data[part].items():
                np.testing.assert_array_equal(g_t.pfnn_data[part][k], v)
        hp = g_t.hand_pose_generator
        assert hp.status_change_map == g_j.hand_pose_generator\
            .status_change_map
        np.testing.assert_allclose(hp.pose_map["pick"].joint_quats[
            "RightHand"], [0.0, 1.0, 0.0, 0.0])
        assert len(tm_entries) == sum(len(n.transition_models)
                                      for n in g_t.nodes.values())


def test_zip_writers_write_the_same_entries(tmp_path, tm_entries):
    """Both writers give the same files with the same bytes."""
    contents = []
    for writer in sorted(WRITERS):
        path = _write(writer, str(tmp_path / writer), "v4_full", tm_entries)
        with zipfile.ZipFile(path) as zf:
            contents.append({n: zf.read(n) for n in zf.namelist()})
    assert contents[0] == contents[1]


def test_load_graph_rejects_partial_pfnn_and_logs_gpm(tmp_path, caplog):
    path = _write("port", str(tmp_path / "w"), "v2", [])
    g = gt.load_graph(path, device="cpu")
    w = g.skeleton.joint_weights  # depth-attenuated defaults
    assert len(w) == g.skeleton.n_animated and w[0] == 1.0 and min(w) < 1.0
    with zipfile.ZipFile(path, "a") as zf:
        zf.writestr("transition_models/walk_a_to_walk_b.GPM", b"\x80")
    with caplog.at_level(logging.INFO, logger="morphablegraphs_tpu"):
        gt.load_graph(path, device="cpu")
    assert "walk_a_to_walk_b.GPM" in caplog.text
    with zipfile.ZipFile(path, "a") as zf:
        zf.writestr("pfnn/weights/W0.bin", b"\x00\x00\x80\x3f")
    with pytest.raises(ValueError, match="incomplete pfnn"):
        gt.load_graph(path, device="cpu")


def test_load_graph_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = _write("port", str(tmp_path / "w"), "v2", [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gt.load_graph(path)


def test_packaged_stats_and_update_motion_stats():
    """Packaged statistics stand; the recount and the sampled lengths
    follow update_motion_stats' method and only_missing as in JAX."""
    gd = synj.make_graph_dict()
    node = gd["subgraphs"]["walk"]["nodes"]["leftStance"]
    node["stats"] = {"average_step_length": 123.5,
                     "n_standard_transitions": 7}
    node["mm"]["keyframes"] = {"contact_label": 11}
    gd["subgraphs"]["walk"]["info"]["annotations"] = {
        "leftStance": {"meta_label": 3}}
    g_j, g_t = gj.build_graph_from_dict(gd), gt.build_graph_from_dict(gd)
    key = ("walk", "leftStance")
    assert g_t.nodes[key].average_step_length == 123.5
    for k in g_j.nodes:  # another node lacked statistics: all recounted
        assert g_t.nodes[k].n_standard_transitions == \
            g_j.nodes[k].n_standard_transitions
    grp = g_t.node_groups["walk"]
    assert grp.map_label_to_keyframe("leftStance", "contact_label", 50) == 11
    assert grp.map_label_to_keyframe("leftStance", "meta_label", 3) == 3
    before = {k: n.average_step_length for k, n in g_t.nodes.items()}
    g_t.update_motion_stats(torch.Generator().manual_seed(0), n_samples=5,
                            method="mean", only_missing=True)
    assert {k: n.average_step_length for k, n in g_t.nodes.items()} == before
    g_t.update_motion_stats(torch.Generator().manual_seed(0), n_samples=5,
                            method="mean", only_missing=False)
    assert g_t.nodes[key].average_step_length != 123.5
    assert all(n.average_step_length > 0 for n in g_t.nodes.values())


def test_random_walk_matches_jax():
    """generate_random_walk: the same Python random.Random transitions and
    the JAX walk's latents through the replayed keys; with the port's own
    generator a walk of the same length, reproducible."""
    g_j, g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)
    walk_j = g_j.generate_random_walk(jax.random.PRNGKey(3), "walk", 3,
                                      random.Random(1))
    walk_t = g_t.generate_random_walk(None, "walk", 3, random.Random(1),
                                      sampler=tp.jax_key_sampler(g_j, 3))
    assert len(walk_t) == len(walk_j) == 5
    for a, b in zip(walk_j, walk_t):
        assert a["node_key"] == b["node_key"]
        np.testing.assert_array_equal(b["parameters"], a["parameters"])
    w1, w2 = (g_t.generate_random_walk(torch.Generator().manual_seed(0),
                                       "walk", 3, random.Random(1))
              for _ in range(2))
    assert [e["node_key"] for e in w1] == [e["node_key"] for e in walk_j]
    for a, b in zip(w1, w2):
        np.testing.assert_array_equal(a["parameters"], b["parameters"])
    assert g_t.nodes[("walk", "leftStance")].action_name == "walk"
    assert g_t.nodes[("walk", "leftStance")].name == "leftStance"


def _tree_graph_dict(tmp_path, kind):
    """make_graph_dict with a cluster tree on leftStance: the pair
    ClusterTree.save writes (made by the JAX package), or a legacy pickled
    tree over latents of the primitive's width (built as
    tests/test_graph.py builds one)."""
    gd = synj.make_graph_dict()
    node = gd["subgraphs"]["walk"]["nodes"]["leftStance"]
    prim = gj.build_graph_from_dict(gd).nodes[
        ("walk", "leftStance")].primitive
    if kind == "native":
        tree = build_cluster_tree_for_primitive(
            jax.random.PRNGKey(0), prim, n_samples=64, n_subdivisions=2,
            max_level=2)
        prefix = str(tmp_path / "walk_leftStance")
        tree.save(prefix)
        with open(prefix + "_cluster_tree.json") as f:
            node["space_partition_json"] = json.load(f)
        with open(prefix + "_cluster_tree.data", "rb") as f:
            node["space_partition_data"] = f.read()
    else:
        node["space_partition_pickle"], _ = tp.reference_pickle_tree(
            np.random.default_rng(4), n=64, dim=prim.n_latent)
    return gd


def _cluster_config():
    cfg = default_config()
    cfg.update(constrained_sampling_mode="cluster_tree_search",
               n_random_samples=4, lm_iterations=1)
    return cfg


def _pool_sizes(monkeypatch):
    """The row count of every pool the port's generator scores."""
    from morphablegraphs_tpu_torch.synthesis import generator
    sizes = []
    score = generator.score_pool

    def spy(skel, prim, sc, pool, *a, **kw):
        sizes.append(pool.shape[0])
        return score(skel, prim, sc, pool, *a, **kw)
    monkeypatch.setattr(generator, "score_pool", spy)
    return sizes


def test_planner_refuses_cluster_tree_search_on_a_packaged_tree(
        tmp_path, monkeypatch):
    """A graph dict whose leftStance carries a ClusterTree.save pair: the
    port loads JAX's tree, and the planner under cluster_tree_search
    scores its 64 rows (it refused the mode until ROADMAP item 15 was
    ported)."""
    gd = _tree_graph_dict(tmp_path, "native")
    key = ("walk", "leftStance")
    g = gt.build_graph_from_dict(gd)
    tp.assert_trees_equal(g.nodes[key].cluster_tree,
                          gj.build_graph_from_dict(gd).nodes[key]
                          .cluster_tree)
    g.skeleton = skt.load_bvh(synj.TEST_BVH)[0]
    sizes = _pool_sizes(monkeypatch)
    p = spt.MGStatePlanner(g, spt.MGStatePlanningSettings(n_samples=4),
                           config=_cluster_config(), device="cpu")
    e = p.generate_step(key, None, target_dir=[0, 1.0])
    assert sizes == [64] and np.all(np.isfinite(e.state.frames))


@pytest.mark.parametrize("kind", ["native", "pickle"])
def test_tree_dict_loads_logs_and_serves(tmp_path, caplog, monkeypatch,
                                         kind):
    """The native pair and a real pickled tree load equal to the JAX
    loader's trees, with no message (the loader logged and dropped them
    before ROADMAP item 15), and both entry points search them under
    cluster_tree_search: the request's leftStance steps and a planner step
    score the tree's rows, the other nodes 4 draws."""
    gd = _tree_graph_dict(tmp_path, kind)
    key = ("walk", "leftStance")
    with caplog.at_level(logging.INFO, logger="morphablegraphs_tpu"):
        g = gt.build_graph_from_dict(gd)
    assert "cluster tree" not in caplog.text
    tree = g.nodes[key].cluster_tree
    tp.assert_trees_equal(tree, gj.build_graph_from_dict(gd).nodes[key]
                          .cluster_tree)
    assert tree.data.shape == (64, g.nodes[key].primitive.n_latent)
    g.skeleton = skt.load_bvh(synj.TEST_BVH)[0]
    sizes = _pool_sizes(monkeypatch)
    res = MotionGenerator(g, _cluster_config(), device="cpu").generate_motion(
        WALK_INPUT)
    assert res.stats["n_steps"] >= 2 and np.all(np.isfinite(res.frames))
    n_tree_steps = sum(s.node_key == key for s in res.steps)
    assert sizes.count(64) == n_tree_steps > 0
    assert set(sizes) <= {4, 64}
    p = spt.MGStatePlanner(g, spt.MGStatePlanningSettings(n_samples=4),
                           config=_cluster_config(), device="cpu")
    e = p.generate_step(key, None, target_dir=[0, 1.0])
    assert sizes[-1] == 64 and np.all(np.isfinite(e.state.frames))


def test_transition_model_entries_with_unknown_nodes_are_skipped(caplog):
    gd = synj.make_graph_dict()
    w, mu, cov = [1.0], np.zeros((1, 14)), np.eye(14)[None]
    model = tmt.to_json(tmt.from_joint(w, mu, cov, n_in=7))
    gd["transition_models"] = [
        {"from": "walk_leftStance", "to": "walk_rightStance",
         "model": model},
        {"from": "walk_leftStance", "to": "walk_nowhere", "model": model}]
    with caplog.at_level(logging.INFO, logger="morphablegraphs_tpu"):
        g = gt.build_graph_from_dict(gd)
    node = g.nodes[("walk", "leftStance")]
    assert node.has_transition_model(("walk", "rightStance"))
    assert list(node.transition_models) == [("walk", "rightStance")]
    assert "walk_nowhere" in caplog.text
    # without a model on the edge, the node's own mixture
    assert node.predict_gmm(("walk", "endRightStance"),
                            torch.zeros(7)) is node.primitive.gmm
