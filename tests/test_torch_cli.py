"""The port's command line (serve/cli.py), result export (serve/export.py)
and config loading (utils/config.load_config) against the JAX package's,
on the CPU (every command with --device cpu).

Tolerances: `train` on the same BVH clips writes JAX's model JSON (the
same K, the spatial, temporal and knot arrays to 1e-4 relative, the GMM's
weights and means to 1e-3: float64 EM in the port, float32 in JAX), and
both packages' loaders read it; `cluster-trees` reads
space_partitioning.json's keys as JAX does and builds JAX's hierarchy on
its samples exactly; `run` writes the BVH and sidecars of a direct
`MotionGenerator` request with the same draws byte for byte, and the JAX
loader reads the port's package with its trees; AnnotatedMotion's files,
Unity JSON and events equal JAX's; `load_config` gives JAX's dict for
every configs/*.config; `serve` hands its arguments to the REST service,
and `set-config` POSTs the file (urlopen replaced: no socket opens)."""

import glob
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.construct import space_partitioning as spj  # noqa: E402
from morphablegraphs_tpu.models import graph as gj  # noqa: E402
from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.serve import cli as clij  # noqa: E402
from morphablegraphs_tpu.serve import export as exj  # noqa: E402
from morphablegraphs_tpu.utils import config as cfgj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.construct import \
    space_partitioning as spt  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as gt  # noqa: E402
from morphablegraphs_tpu_torch.models import primitive as prt  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.models.zip_writer import \
    write_graph_zip  # noqa: E402
from morphablegraphs_tpu_torch.serve import cli as clit  # noqa: E402
from morphablegraphs_tpu_torch.serve import export as ext  # noqa: E402
from morphablegraphs_tpu_torch.synthesis.motion_generator import \
    MotionGenerator  # noqa: E402
from morphablegraphs_tpu_torch.utils import config as cfgt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import WALK_INPUT, release_jax_executables  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.config")))


def _write_clips(folder, n, seed, step=1):
    """n BVH clips of the toy leftStance model (JAX draws, unit
    quaternions), every `step`-th frame of the odd ones."""
    os.makedirs(folder, exist_ok=True)
    src = prj.load_primitive_json(synj.make_legacy_model_json(seed=9,
                                                              n_joints=4))
    skel = skt.load_bvh(synj.TEST_BVH)[0]
    key = jax.random.PRNGKey(seed)
    lengths = {}
    for i in range(n):
        key, sub = jax.random.split(key)
        s = prj.sample_latent(sub, src, 1)[0]
        frames, nf, _ = prj.back_project(src, s, 96, use_time=True)
        f = np.asarray(frames)[: int(nf)].astype(np.float64)
        f = f[:: step if i % 2 else 1]
        q = f[:, 3:].reshape(len(f), -1, 4)
        f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
            len(f), -1)
        skt.write_bvh(skel, f, os.path.join(folder, f"clip{i:02d}.bvh"))
        lengths[f"clip{i:02d}"] = len(f)
    return lengths


def _gmm(model):
    g = model["gmm"]
    order = np.argsort(np.asarray(g["means"])[:, 0])
    return np.asarray(g["weights"])[order], np.asarray(g["means"])[order]


def test_train_writes_jax_model_json(tmp_path):
    """`train` over 12 clips (3 spatial components so the 2-component EM
    keeps full-rank covariances in both precisions), and with a
    keyframes.json over 3 clips (split DTW, one component)."""
    clips = str(tmp_path / "clips")
    _write_clips(clips, 12, seed=0)
    cfg = {"max_gmm_components": 2, "npc_temporal": 2, "n_components": 3}
    out_t = clit.train_model(clips, "walk_leftStance",
                             str(tmp_path / "t_mm.json"), config=cfg,
                             device="cpu")
    out_j = clij.train_model(clips, "walk_leftStance",
                             str(tmp_path / "j_mm.json"), config=cfg)
    m_t, m_j = json.load(open(out_t)), json.load(open(out_j))
    tp.assert_model_json_close(m_t, m_j, {"gmm"})
    (w_t, mu_t), (w_j, mu_j) = _gmm(m_t), _gmm(m_j)
    assert len(w_t) == len(w_j) == 2
    np.testing.assert_allclose(w_t, w_j, atol=1e-3)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-3, atol=1e-3)
    assert prj.load_primitive(out_t).n_spatial == 3
    assert prt.load_primitive(out_t, device="cpu").n_spatial == 3
    assert os.path.exists(str(tmp_path / "t_sample.bvh"))
    sample = skt.load_bvh(str(tmp_path / "t_sample.bvh"))[1]
    assert len(sample) > 10 and np.all(np.isfinite(sample))

    split = str(tmp_path / "split")
    lengths = _write_clips(split, 3, seed=1, step=2)
    keyframes = {k: n // 2 for k, n in lengths.items()}
    with open(os.path.join(split, "keyframes.json"), "w") as f:
        json.dump(keyframes, f)
    cfg = {"max_gmm_components": 1, "npc_temporal": 1, "n_components": 2}
    for pkg, out in ((clit, "t.json"), (clij, "j.json")):
        kw = {"device": "cpu"} if pkg is clit else {}
        pkg.train_model(split, "walk_split", str(tmp_path / out), config=cfg,
                        export_sample=False, **kw)
    m_t, m_j = (json.load(open(tmp_path / n)) for n in ("t.json", "j.json"))
    assert m_t["keyframes"] == m_j["keyframes"] and "contact0" in \
        m_t["keyframes"]
    tp.assert_model_json_close(m_t, m_j, {"gmm"})
    with pytest.raises(ValueError, match="no BVH"):
        clit.train_model(str(tmp_path / "empty"), "x", device="cpu")


def _model_dir(tmp_path):
    gd = synj.make_graph_dict()
    mdir = tmp_path / "models"
    mdir.mkdir()
    for mp, node in gd["subgraphs"]["walk"]["nodes"].items():
        (mdir / f"walk_{mp}_mm.json").write_text(json.dumps(node["mm"]))
    return gd, str(mdir)


def test_cluster_trees_command(tmp_path, capsys):
    """space_partitioning.json's keys (n_levels clamped to 8), one tree per
    model next to it, JAX's hierarchy on its samples; JAX's ClusterTree
    reads the files."""
    gd, mdir = _model_dir(tmp_path)
    sp = tmp_path / "space_partitioning.json"
    sp.write_text(json.dumps({"n_random_samples": 200, "n_levels": 20,
                              "n_subdivisions_per_level": 3,
                              "random_seed": 3,
                              "only_spatial_parameters": True}))
    clit.main(["cluster-trees", mdir, "--config", str(sp), "--device",
               "cpu"])
    printed = capsys.readouterr().out.split()
    assert len(printed) == 4 and all(p.endswith("_cluster_tree.json")
                                     for p in printed)
    prefix = os.path.join(mdir, "walk_leftStance")
    tree_j = spj.ClusterTree.load(prefix)
    assert (tree_j.n_subdivisions, tree_j.max_level) == (3, 8)
    assert tree_j.data.shape[0] == 200
    prim = prj.load_primitive(prefix + "_mm.json")
    ref = spj.ClusterTree(3, 8)
    ref.data = tree_j.data
    ref.root = spj._build_on_features(
        ref, np.random.default_rng(0), tree_j.data[:, :prim.n_spatial],
        np.arange(200), 0)
    tp.assert_trees_equal(spt.ClusterTree.load(prefix, device="cpu"), ref)


def test_run_command_writes_the_request(tmp_path, monkeypatch):
    """`run` on a package with native trees under a cluster-tree-search
    preset: the BVH and sidecars of a direct request with the same draws;
    JAX's loader reads the port's package and its trees."""
    gd, mdir = _model_dir(tmp_path)
    clit.main(["cluster-trees", mdir, "--samples", "150", "--device", "cpu"])
    walk = gd["subgraphs"]["walk"]
    trees = {mp: spt.ClusterTree.load(os.path.join(mdir, f"walk_{mp}"),
                                   device="cpu")
             for mp in walk["nodes"]}
    zip_path = write_graph_zip(
        str(tmp_path / "graph.zip"), skt.load_bvh(synj.TEST_BVH)[0],
        {"walk": {"nodes": {mp: n["mm"] for mp, n in walk["nodes"].items()},
                  "info": walk["info"], "cluster_trees": trees}},
        gd["transitions"], start_node=tuple(gd["startNode"]),
        format_version=4.0)
    g_j = gj.load_graph(zip_path)
    for mp, tree in trees.items():
        np.testing.assert_array_equal(
            g_j.nodes[("walk", mp)].cluster_tree.data, tree.data)
    preset = tmp_path / "cluster.config"
    preset.write_text(json.dumps({
        "constrained_sampling_mode": "cluster_tree_search",
        "lm_iterations": 2, "n_cluster_search_candidates": 4}))
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    (in_dir / "request.json").write_text(json.dumps(WALK_INPUT))

    def seeded(graph, config, device):
        return MotionGenerator(graph, config, seed=5, device=device)
    monkeypatch.setattr(clit, "MotionGenerator", seeded)
    bvh = clit.run_pipeline(zip_path, str(in_dir), str(tmp_path / "out"),
                            cfgt.load_config(str(preset)), device="cpu")
    clit.main(["run", zip_path, str(in_dir), str(tmp_path / "out2"),
               "--config", str(preset), "--device", "cpu"])
    g_t = gt.load_graph(zip_path, device="cpu")
    assert g_t.nodes[("walk", "leftStance")].cluster_tree is not None
    res = seeded(g_t, cfgt.load_config(str(preset)), "cpu").generate_motion(
        WALK_INPUT)
    ext.AnnotatedMotion(g_t.skeleton, res.frames, res.action_ranges).export(
        str(tmp_path / "direct"))
    for suffix in (".bvh", "_annotations.json", "_actions.json"):
        direct = (tmp_path / f"direct{suffix}").read_bytes()
        assert (tmp_path / "out" / f"output{suffix}").read_bytes() == direct
        assert (tmp_path / "out2" / f"output{suffix}").read_bytes() == direct
    assert bvh.endswith("output.bvh")
    (tmp_path / "no_input").mkdir()
    with pytest.raises(ValueError, match="no input JSON"):
        clit.run_pipeline(zip_path, str(tmp_path / "no_input"),
                          str(tmp_path / "o"), device="cpu")


def _frames(skel, n, seed):
    rng = np.random.default_rng(seed)
    f = np.zeros((n, skel.n_frame_params), np.float32)
    f[:, :3] = np.cumsum(rng.standard_normal((n, 3)), axis=0) + [0, 90, 0]
    q = rng.standard_normal((n, skel.n_animated, 4)) * 0.2
    q[..., 0] += 1.0
    f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(n, -1)
    return f


def test_annotated_motion_matches_jax(tmp_path):
    skel = skt.load_bvh(synj.TEST_BVH)[0]
    frames = _frames(skel, 6, 0)
    kw = dict(action_ranges=[("walk", 0, 3), ("pickRight", 3, 6)],
              mg_input={"elementaryActions": []},
              collision_content={"4": ["Head"]})
    ev_t = [ext.KeyframeEvent(2, "attach", {"joint": "RightHand",
                                            "target": "box"})]
    ev_j = [exj.KeyframeEvent(2, "attach", {"joint": "RightHand",
                                            "target": "box"})]
    a = ext.AnnotatedMotion(skel, frames, events=ev_t, **kw)
    b = exj.AnnotatedMotion(skel, frames, events=ev_j, **kw)
    assert a.generate_bvh_string() == b.generate_bvh_string()
    assert a.to_unity_format(2.0) == b.to_unity_format(2.0)
    assert a.keyframe_events_dict() == b.keyframe_events_dict()
    assert a.n_frames == b.n_frames == 6
    a.export(str(tmp_path / "t"))
    b.export(str(tmp_path / "j"))
    for suffix in (".bvh", "_annotations.json", "_actions.json", ".json"):
        assert (tmp_path / f"t{suffix}").read_bytes() == \
            (tmp_path / f"j{suffix}").read_bytes()


def test_events_and_collision_data_match_jax():
    """events_from_result (with a rotate event for a place action's
    detach) and the CA visualization payload on one result, through
    either package's functions."""
    g_j, g_t = (m.build_graph_from_dict(synj.make_graph_dict())
                for m in (gj, gt))
    g_j.skeleton = g_t.skeleton = skt.load_bvh(synj.TEST_BVH)[0]
    for g in (g_j, g_t):
        g.node_groups["walk"].labeled_frames.setdefault(
            "leftStance", {})["grab"] = 5
    skel = g_t.skeleton
    n_ca = 2
    sc = types.SimpleNamespace(
        ca_active=np.array([1.0, 0.0]), ca_node=np.array([2, 1]),
        ca_pos=np.array([[3.0, 80.0, 5.0], [0.0, 0.0, 0.0]]),
        ca_pos_mask=np.ones((n_ca, 3)))
    steps = [types.SimpleNamespace(node_key=("walk", "leftStance"),
                                   start_frame=0, end_frame=9,
                                   step_constraints=sc),
             types.SimpleNamespace(node_key=("walk", "rightStance"),
                                   start_frame=10, end_frame=19,
                                   step_constraints=None)]
    result = types.SimpleNamespace(
        steps=steps, frames=_frames(skel, 20, 1),
        action_ranges=[("walk", 0, 20)])
    annotations = [{"grab": {"annotations": [
        {"event": "detach", "parameters": {"joint": "RightHand",
                                           "target": "cup"}}]}}]
    spec = types.SimpleNamespace(keyframe_label="grab",
                                 orientation=np.array([0.0, np.nan, 1.0]))
    for name in ("walk", "placeRight"):
        result.action_ranges = [(name, 0, 20)]
        for s in steps:
            s.node_key = (name, s.node_key[1])
        g_j.node_groups[name] = g_j.node_groups["walk"]
        g_t.node_groups[name] = g_t.node_groups["walk"]
        for g in (g_j, g_t):
            for mp in ("leftStance", "rightStance"):
                g.nodes[(name, mp)] = g.nodes[("walk", mp)]
        e_t = ext.events_from_result(g_t, result, annotations, True, [[spec]])
        e_j = exj.events_from_result(g_j, result, annotations, True, [[spec]])
        assert [dataclass_tuple(e) for e in e_t] == \
            [dataclass_tuple(e) for e in e_j]
        assert len(e_t) == (2 if name == "placeRight" else 1)
    assert ext.collision_vis_data_from_result(skel, result, device="cpu") \
        == exj.collision_vis_data_from_result(skel, result)


def dataclass_tuple(e):
    return (e.keyframe, e.event, json.dumps(e.parameters, sort_keys=True))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_load_config_matches_jax(path):
    assert cfgt.load_config(path) == cfgj.load_config(path)
    with open(path) as f:
        preset = json.load(f)
    assert cfgt.warn_inert_keys(preset, path) == \
        cfgj.warn_inert_keys(preset, path)
    for dotted in cfgt.INERT_KEYS:
        assert cfgt._lookup(cfgt.DEFAULT_ALGORITHM_CONFIG, dotted)[1]


def test_serve_is_refused_and_set_config_posts(tmp_path, monkeypatch,
                                               capsys):
    """`serve` (refused until the REST service was ported; the name is
    kept) hands its graph, port and device to rest.main;
    tests/test_torch_rest.py serves through it."""
    from morphablegraphs_tpu_torch.serve import rest
    served = []
    monkeypatch.setattr(rest, "main", lambda *a, **kw: served.append((a, kw)))
    clit.main(["serve", "graph.zip", "--port", "0", "--device", "cpu"])
    assert served == [(("graph.zip", 0), {"device": "cpu"})]
    import urllib.request
    sent = {}

    class _Response:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read(self):
            return b"OK"

    def urlopen(req):
        sent.update(url=req.full_url, method=req.get_method(),
                    data=req.data)
        return _Response()
    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    cfg = tmp_path / "c.config"
    cfg.write_text('{"lm_iterations": 3}')
    clit.main(["set-config", str(cfg), "--url", "http://localhost:9/"])
    assert sent == {"url": "http://localhost:9/set_configuration",
                    "method": "POST", "data": b'{"lm_iterations": 3}'}
    assert capsys.readouterr().out.strip() == "OK"
