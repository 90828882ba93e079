"""Parity of the port's cluster trees (construct/space_partitioning.py)
with the JAX package's.

Tolerances: k-means labels and tree structure (every node's indices and
mean) exactly, on the same data and seed (host numpy in both packages);
beam search, k-NN blending and the exhaustive search against the JAX
package with one objective written in each framework (the distance to a
target latent), errors and samples to 1e-5; save/load both ways with equal
bytes; the reference's feature-tree JSON and legacy pickled trees to the
same tree; the restricted unpickler refuses what JAX's refuses."""

import io
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.construct import space_partitioning as spj  # noqa: E402
from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.construct import \
    space_partitioning as spt  # noqa: E402
from morphablegraphs_tpu_torch.models import primitive as prt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401


@pytest.fixture(scope="module")
def prims():
    model = synj.make_legacy_model_json(seed=0)
    return prj.load_primitive_json(model), prt.load_primitive_json(model)


@pytest.fixture(scope="module")
def jax_tree(prims):
    return spj.build_cluster_tree_for_primitive(
        jax.random.PRNGKey(0), prims[0], n_samples=400, max_level=3)


def _objectives(target):
    t_j = jnp.asarray(target, jnp.float32)
    t_t = torch.as_tensor(target, dtype=torch.float32)
    return (jax.jit(lambda x: jnp.linalg.norm(x - t_j, axis=-1)),
            lambda x: torch.linalg.norm(x - t_t, dim=-1))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_kmeans_labels_match_jax(k):
    rng = np.random.default_rng(k)
    x = np.concatenate([rng.standard_normal((60, 5)) * 0.3 + c
                        for c in rng.standard_normal((k, 5)) * 4])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(
        spt.kmeans(np.random.default_rng(7), x, k),
        spj.kmeans(np.random.default_rng(7), x, k))
    dup = np.tile(x[:1], (6, 1))  # duplicate rows: uniform fallback
    np.testing.assert_array_equal(spt.kmeans(np.random.default_rng(0), dup, 3),
                                  spj.kmeans(np.random.default_rng(0), dup, 3))


def test_tree_structure_matches_jax(prims, jax_tree):
    """The port's builder on JAX's sampled latents (spatial features) and
    `construct` on the same data give JAX's trees node for node."""
    t = spt.ClusterTree(jax_tree.n_subdivisions, jax_tree.max_level)
    t.data = jax_tree.data
    n_spatial = prims[0].n_spatial
    t.root = spt._build_on_features(t, np.random.default_rng(0),
                                    jax_tree.data[:, :n_spatial],
                                    np.arange(len(jax_tree.data)), 0)
    tp.assert_trees_equal(t, jax_tree)
    a, b = spt.ClusterTree(3, 2), spj.ClusterTree(3, 2)
    a.construct(jax_tree.data, seed=5, device="cpu")
    b.construct(jax_tree.data, seed=5)
    tp.assert_trees_equal(a, b)


def test_builder_samples_the_primitive(prims):
    """build_cluster_tree_for_primitive draws from a torch.Generator: the
    full latents are stored (float32, device copy on the primitive's
    device) and the hierarchy is JAX's on those latents."""
    tree = spt.build_cluster_tree_for_primitive(
        torch.Generator().manual_seed(3), prims[1], n_samples=300,
        n_subdivisions=2, max_level=3, seed=2)
    assert tree.data.shape == (300, prims[1].n_latent)
    assert tree.data.dtype == np.float32
    assert tree.device_data().device.type == "cpu"
    ref = spj.ClusterTree(2, 3)
    ref.data = tree.data
    ref.root = spj._build_on_features(
        ref, np.random.default_rng(2), tree.data[:, :prims[1].n_spatial],
        np.arange(300), 0)
    tp.assert_trees_equal(tree, ref)


@pytest.mark.parametrize("n_candidates", [1, 2, 4])
def test_beam_and_knn_search_match_jax(jax_tree, tmp_path, n_candidates):
    """JAX's tree carried across by save/load, searched in both packages
    with one objective: errors and samples to 1e-5."""
    prefix = str(tmp_path / "t")
    jax_tree.save(prefix)
    tree = spt.ClusterTree.load(prefix, device="cpu")
    for target in (jax_tree.data[17] + 0.05, np.full(
            jax_tree.data.shape[1], 0.3, np.float32)):
        obj_j, obj_t = _objectives(target)
        e_j, s_j = jax_tree.find_best_example(obj_j, n_candidates)
        e_t, s_t = tree.find_best_example(obj_t, n_candidates)
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s_t, s_j, atol=1e-5)
        e_j, s_j = jax_tree.find_best_example_knn(obj_j, n_candidates, k=8)
        e_t, s_t = tree.find_best_example_knn(obj_t, n_candidates, k=8)
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(s_t, s_j, atol=1e-5)


def test_exhaustive_and_knn_functions_match_jax():
    rng = np.random.default_rng(4)
    data = rng.standard_normal((200, 6)).astype(np.float32)
    obj_j, obj_t = _objectives(data[3] + 0.1)
    data_t = torch.as_tensor(data)
    e_j, s_j = spj.search_best_exhaustive(obj_j, jnp.asarray(data))
    e_t, s_t = spt.search_best_exhaustive(obj_t, data_t)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    for k in (1, 2, 10, 50):
        e_j, s_j = spj.knn_interpolation(obj_j, jnp.asarray(data), k=k)
        e_t, s_t = spt.knn_interpolation(obj_t, data_t, k=k)
        np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    # a zero best error: the weight mass degenerates to the best sample
    obj_j, obj_t = _objectives(data[9])
    _, s_t = spt.knn_interpolation(obj_t, data_t, k=5)
    np.testing.assert_array_equal(s_t.numpy(), data[9])


def test_save_load_bytes_both_ways(jax_tree, tmp_path, monkeypatch):
    """Both ways with equal bytes; the device copy goes to the card
    unless the caller names another device (without a card: an error)."""
    jax_tree.save(str(tmp_path / "j"))
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            spt.ClusterTree.load(str(tmp_path / "j"))
    port = spt.ClusterTree.load(str(tmp_path / "j"), device="cpu")
    tp.assert_trees_equal(port, jax_tree)
    port.save(str(tmp_path / "t"))
    back = spj.ClusterTree.load(str(tmp_path / "t"))
    tp.assert_trees_equal(back, jax_tree)
    for ext in ("_cluster_tree.json", "_cluster_tree.data"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    with open(tmp_path / "j_cluster_tree.json") as f:
        meta = json.load(f)
    del meta["n_dims"]
    raw = (tmp_path / "j_cluster_tree.data").read_bytes()
    with pytest.raises(ValueError, match="n_dims"):
        spt.ClusterTree.from_native_json(meta, raw)
    tp.assert_trees_equal(
        spt.ClusterTree.from_native_json(meta, raw, jax_tree.data.shape[1],
                                         device="cpu"),
        jax_tree)


def test_reference_feature_tree_json_matches_jax():
    rng = np.random.default_rng(5)
    data = rng.standard_normal((40, 4)).tolist()
    tree_json = {"data": data, "features": [], "options": {
        "n_subdivisions_per_level": 2, "n_levels": 3},
        "root": {"children": [
            {"indices": list(range(0, 25)), "children": []},
            {"indices": list(range(25, 40)), "children": [
                {"indices": [], "children": []}]}]}}
    tp.assert_trees_equal(spt.load_reference_feature_tree_json(tree_json,
                                                               "cpu"),
                          spj.load_reference_feature_tree_json(tree_json))


def test_pickle_tree_matches_jax():
    payload, data = tp.reference_pickle_tree(np.random.default_rng(4))
    tree = spt.load_reference_pickle_tree(payload, device="cpu")
    tp.assert_trees_equal(tree, spj.load_reference_pickle_tree(payload))
    got = np.sort(np.concatenate([c.indices for c in tree.root.children]))
    np.testing.assert_array_equal(got, np.arange(len(data)))
    obj_j, obj_t = _objectives(data[17].astype(np.float32))
    err, best = tree.find_best_example(obj_t, n_candidates=2)
    assert err <= 1e-6
    np.testing.assert_array_equal(best, data[17].astype(np.float32))


class _Evil:
    def __init__(self, func, arg):
        self.func, self.arg = func, arg

    def __reduce__(self):
        return self.func, (self.arg,)


@pytest.mark.parametrize("func", [eval, os.system, pickle.loads,
                                  io.FileIO])
def test_unpickler_refuses_like_jax(func):
    """builtins.eval, os.system and everything off the allowlist are
    refused by name, in both packages, before anything runs."""
    payload = pickle.dumps(_Evil(func, "0"), protocol=2)
    for load in (spt.load_reference_pickle_tree,
                 spj.load_reference_pickle_tree):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            load(payload)
