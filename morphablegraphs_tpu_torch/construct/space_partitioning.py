"""Latent-space search index: the cluster tree and brute-force search (port
of morphablegraphs_tpu.construct.space_partitioning).

Two search paths:
  * `search_best_exhaustive`: the batched objective over every stored
    sample and its argmin, one pass over the device copy of the data.
    It is what cluster-tree search runs in the request path (the pool is
    the node's whole tree data, ranked by the exact evaluator).
  * `ClusterTree`: the k-means hierarchy of the reference (4 subdivisions
    x 4 levels, leaves keep their sample indices) with beam search, each
    level's cluster means scored as one batch on the card; it also loads
    the reference's tree JSON and legacy pickles.

The k-means runs on the host with numpy's generator, as in the JAX
package, so the same data and seed give the same labels and the same tree.
`tree.data` stays float32 numpy; the tree keeps one device copy of it
(`to`, made when the tree is loaded or built: on the CUDA device unless
the caller names another), which the searches read.  Objectives take and
return tensors: [N, L] -> [N].
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional

import numpy as np
import torch

from ..utils import device as device_mod


# ---------------------------------------------------------------------------
# KMeans (the reference's sklearn KMeans)
# ---------------------------------------------------------------------------

def kmeans(rng: np.random.Generator, x: np.ndarray, k: int,
           n_iters: int = 25) -> np.ndarray:
    """Lloyd's algorithm with kmeans++ seeding; returns labels [N]."""
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(np.stack([np.sum((x - c) ** 2, axis=1)
                              for c in centers]), axis=0)
        total = d2.sum()
        if total <= 1e-12:  # duplicate rows: no distribution to draw from
            centers.append(x[rng.integers(n)])
            continue
        centers.append(x[rng.choice(n, p=d2 / total)])
    c = np.stack(centers).astype(np.float64)
    xs = np.asarray(x, np.float64)
    # host numpy, as in the JAX package: the labels must match its bit for
    # bit, and a node's subset is small
    labels = np.zeros(n, np.int64)
    for _ in range(n_iters):
        d = ((xs[:, None, :] - c[None]) ** 2).sum(-1)  # [N, K]
        labels = np.argmin(d, axis=-1)
        for j in range(k):
            m = labels == j
            if m.any():
                c[j] = xs[m].mean(axis=0)
    return labels


# ---------------------------------------------------------------------------
# Exhaustive search
# ---------------------------------------------------------------------------

def search_best_exhaustive(objective_batched: Callable, data: torch.Tensor):
    """The objective on every stored sample and its argmin.
    objective_batched: [N, L] -> [N].  -> (best error [], best sample [L])."""
    errors = objective_batched(data)
    i = torch.argmin(errors)
    return errors[i], data[i]


def knn_interpolation(objective_batched: Callable, data: torch.Tensor,
                      k: int = 50):
    """Blend the k best samples under the objective into a new sample
    (reference kdtree_wrapper_node.py:58-84): the first k-1 weighted by
    the normalized influence 1/e_i - 1/e_k.  Falls back to the single
    best sample when k == 1 or the weight mass degenerates (a zero best
    error, or all-equal errors).  -> (error [], blended sample [L])."""
    errors = objective_batched(data)
    if k <= 1 or data.shape[0] < 2:
        i = torch.argmin(errors)
        return errors[i], data[i]
    k = min(k, data.shape[0])
    neg_best, idx = torch.topk(-errors, k)  # ascending errors
    best = -neg_best
    pts = data[idx]
    safe = torch.clamp(best, min=1e-12)
    influence = 1.0 / safe[:-1] - 1.0 / safe[-1]
    total = torch.sum(influence)
    degenerate = (best[0] <= 1e-12) | (total <= 1e-12)
    weights = influence / torch.where(degenerate, torch.ones_like(total),
                                      total)
    blended = torch.where(degenerate, pts[0], weights @ pts[:-1])
    err = objective_batched(blended[None])[0]
    return err, blended


# ---------------------------------------------------------------------------
# Cluster tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TreeNode:
    mean: np.ndarray
    indices: np.ndarray  # indices into the data array
    children: List["TreeNode"]

    @property
    def is_leaf(self) -> bool:
        return not self.children


class ClusterTree:
    """Recursive-KMeans hierarchy (reference cluster_tree.py defaults:
    4 subdivisions x 4 levels; leaves keep their sample indices)."""

    def __init__(self, n_subdivisions: int = 4, max_level: int = 4):
        self.n_subdivisions = n_subdivisions
        self.max_level = max_level
        self.data: Optional[np.ndarray] = None
        self.root: Optional[TreeNode] = None
        self._data_t: Optional[torch.Tensor] = None

    def to(self, device=None) -> "ClusterTree":
        """Make the device copy of `data` the searches read, on `device`
        (CUDA unless named; an error without a card); -> self."""
        self._data_t = torch.tensor(
            np.asarray(self.data, np.float32),
            device=device_mod.resolve(device, "ClusterTree"))
        return self

    def device_data(self, device=None) -> torch.Tensor:
        """The device copy of `data` [N, L] (float32): the one there is,
        or a new one on `device` when that names another (with no copy
        yet, CUDA unless named)."""
        if self._data_t is None or (
                device is not None
                and self._data_t.device != torch.device(device)):
            self.to(device)
        return self._data_t

    # -- construction (reference cluster_tree_node_builder.py:37-209) -----
    def construct(self, data: np.ndarray, seed: int = 0, device=None):
        """The hierarchy over `data` [N, L] (k-means on all of it), its
        device copy on `device` (CUDA unless named)."""
        self.data = np.asarray(data, np.float32)
        rng = np.random.default_rng(seed)
        self.root = _build_on_features(self, rng, self.data,
                                       np.arange(len(self.data)), 0)
        self.to(device)

    # -- search (reference cluster_tree.py:117-149 beam search) -----------
    def _beam_leaf_indices(self, objective_batched,
                           n_candidates: int) -> np.ndarray:
        """Beam-search descent: keep the n_candidates best clusters per
        level (each level's means scored as one batch), return the
        surviving leaves' sample indices."""
        dev = self.device_data().device
        frontier = [self.root]
        leaves: List[TreeNode] = []
        while frontier:
            children = []
            for node in frontier:
                if node.is_leaf:
                    leaves.append(node)
                else:
                    children.extend(node.children)
            if not children:
                break
            means = torch.as_tensor(np.stack([c.mean for c in children]),
                                    dtype=torch.float32, device=dev)
            errs = objective_batched(means).cpu().numpy()
            order = np.argsort(errs)[: self.n_candidates_effective(
                n_candidates, len(children))]
            frontier = [children[i] for i in order]
        if not leaves:
            leaves = frontier
        return np.concatenate([leaf.indices for leaf in leaves])

    def find_best_example(self, objective_batched, n_candidates: int = 4):
        """Beam search to the leaves, then every member sample scored as
        one batch.  -> (error float, sample [L] numpy)."""
        idx = self._beam_leaf_indices(objective_batched, n_candidates)
        data = self.device_data()
        errs = objective_batched(
            data[torch.as_tensor(idx, device=data.device)]).cpu().numpy()
        i = int(np.argmin(errs))
        return float(errs[i]), self.data[idx[i]]

    def find_best_example_knn(self, objective_batched, n_candidates: int = 4,
                              k: int = 50):
        """Beam search to the leaves, then the k best leaf samples blended
        (reference cluster_tree.py:189-215 and cluster_tree_node.py:52-61).
        -> (error float, blended sample [L] numpy)."""
        idx = self._beam_leaf_indices(objective_batched, n_candidates)
        data = self.device_data()
        err, blended = knn_interpolation(
            objective_batched, data[torch.as_tensor(idx, device=data.device)],
            k=k)
        return float(err), blended.cpu().numpy()

    @staticmethod
    def n_candidates_effective(n_candidates, n_children):
        return min(n_candidates, n_children)

    # -- serialization (reference cluster_tree.py:63-94 json+data layout) --
    def save(self, prefix: str):
        meta = {"n_subdivisions": self.n_subdivisions,
                "max_level": self.max_level,
                "n_dims": int(self.data.shape[1]),
                "root": self._node_to_json(self.root)}
        with open(prefix + "_cluster_tree.json", "w") as f:
            json.dump(meta, f)
        self.data.astype(np.float32).tofile(prefix + "_cluster_tree.data")

    def _node_to_json(self, node: TreeNode) -> dict:
        return {"mean": node.mean.tolist(),
                "indices": node.indices.tolist(),
                "children": [self._node_to_json(c) for c in node.children]}

    @classmethod
    def load(cls, prefix: str, n_dims: Optional[int] = None,
             device=None) -> "ClusterTree":
        """The save() pair at `prefix`, its data copied to `device` (CUDA
        unless named)."""
        with open(prefix + "_cluster_tree.json") as f:
            meta = json.load(f)
        with open(prefix + "_cluster_tree.data", "rb") as f:
            raw = f.read()
        return cls.from_native_json(meta, raw, n_dims, device=device)

    @classmethod
    def from_native_json(cls, meta: dict, data_bytes: bytes,
                         n_dims: Optional[int] = None,
                         device=None) -> "ClusterTree":
        """Hydrate from this class's own save() layout: JSON meta (with
        n_dims recorded) and the raw float32 .data payload; the device
        copy goes to `device` (CUDA unless named)."""
        if n_dims is None:
            if "n_dims" not in meta:
                raise ValueError(
                    "cluster-tree meta JSON has no 'n_dims' (pre-n_dims "
                    "save?) — pass n_dims explicitly to ClusterTree.load/"
                    "from_native_json")
            n_dims = int(meta["n_dims"])
        tree = cls(meta["n_subdivisions"], meta["max_level"])
        tree.data = np.frombuffer(data_bytes, np.float32).reshape(-1, n_dims)
        tree.root = cls._node_from_json(meta["root"])
        return tree.to(device)

    @classmethod
    def _node_from_json(cls, d: dict) -> TreeNode:
        return TreeNode(mean=np.asarray(d["mean"], np.float32),
                        indices=np.asarray(d["indices"], np.int64),
                        children=[cls._node_from_json(c)
                                  for c in d["children"]])


def load_reference_feature_tree_json(tree_data: dict,
                                     device=None) -> ClusterTree:
    """Load the reference's FeatureClusterTree JSON form ({data, features,
    options, root}, feature_cluster_tree.py:293-348) into a ClusterTree
    over the LATENT data (the features only served to build it), its
    device copy on `device` (CUDA unless named)."""
    options = tree_data.get("options", {})
    tree = ClusterTree(
        n_subdivisions=options.get("n_subdivisions_per_level", 4),
        max_level=options.get("n_levels", 4))
    tree.data = np.asarray(tree_data["data"], np.float32)

    def parse(node) -> TreeNode:
        indices = np.asarray(node.get("indices", []), np.int64)
        mean = (tree.data[indices].mean(axis=0) if len(indices)
                else np.zeros(tree.data.shape[1], np.float32))
        children = [parse(c) for c in node.get("children", [])]
        return TreeNode(mean=mean, indices=indices, children=children)

    tree.root = parse(tree_data["root"])
    return tree.to(device)


def load_reference_pickle_tree(payload: bytes, device=None) -> ClusterTree:
    """Load a legacy pickled ClusterTree (`*_cluster_tree.pck` inside graph
    zips with formatVersion < 4 or usePickle, reference zip_io.py:210-223
    and cluster_tree.py:81-94) without importing the reference package;
    its device copy on `device` (CUDA unless named).

    The pickle stream names classes by module path
    (morphablegraphs.space_partitioning.*); a restricted Unpickler maps any
    such class to an attribute-bag stub (the reference classes are plain
    objects with no custom __setstate__), allows numpy's reconstructors by
    name, and refuses everything else.  The stub tree then becomes the
    index-based ClusterTree:

      * ClusterTreeNode stubs -> TreeNode (mean / indices / children);
      * KDTreeWrapper leaves (which store raw point LISTS, not indices,
        kdtree.py:87-89) -> indices recovered by exact row matching against
        the tree's data array (the reference builds them via
        data[indices].tolist(), so rows match bit for bit in float64).
    """
    import io
    import pickle

    class _Stub:
        pass

    _stub_cache: dict = {}

    def _stub_class(module: str, name: str):
        key = (module, name)
        if key not in _stub_cache:
            _stub_cache[key] = type(name, (_Stub,), {"__module__": module})
        return _stub_cache[key]

    # NAME-level allowlists: blanket module prefixes are gadget surfaces —
    # builtins.eval/exec would be direct code execution, and e.g.
    # numpy.ctypeslib.load_library reaches the loader during unpickling.
    # These names are exactly what numpy protocol-2 array pickles plus the
    # reference's plain-object trees need (_codecs.encode reconstructs the
    # raw byte payloads).
    _ALLOWED = {
        "builtins": {"object", "list", "dict", "tuple", "set", "frozenset",
                     "slice", "complex", "bytearray", "range"},
        "collections": {"OrderedDict", "defaultdict"},
        "_codecs": {"encode"},
    }
    _ALLOWED_NUMPY_NAMES = frozenset(
        {"ndarray", "dtype", "matrix", "_reconstruct", "scalar",
         "_frombuffer"})

    class _RestrictedUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if ("morphablegraphs" in module or "space_partitioning" in module
                    or "kdtree" in module or "cluster_tree" in module):
                return _stub_class(module, name)
            allowed = _ALLOWED.get(module)
            if allowed is not None and name in allowed:
                return super().find_class(module, name)
            if (module.split(".")[0] == "numpy"
                    and name in _ALLOWED_NUMPY_NAMES):
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"refusing to unpickle {module}.{name} from cluster tree")

    obj = _RestrictedUnpickler(io.BytesIO(payload)).load()
    data = np.asarray(obj.data, np.float64)
    tree = ClusterTree(n_subdivisions=int(getattr(obj, "n_subdivisions", 4)),
                       max_level=int(getattr(obj, "max_level", 4)))
    tree.data = data.astype(np.float32)

    # exact-match index of data rows for KDTreeWrapper point recovery
    row_index = {np.asarray(row, np.float64).tobytes(): i
                 for i, row in enumerate(data)}

    def match_points(points) -> np.ndarray:
        idx = []
        for p in points:
            k = np.asarray(p, np.float64).tobytes()
            if k in row_index:
                idx.append(row_index[k])
        return np.asarray(idx, np.int64)

    def convert(node) -> TreeNode:
        if hasattr(node, "kdtree"):  # KDTreeWrapper leaf
            # data may be a list or a numpy array (the truth value of a
            # multi-row array raises): test None and size explicitly
            pts = getattr(node.kdtree, "data", None)
            if pts is None or len(pts) == 0:
                pts = []
            indices = match_points(pts)
            mean = (data[indices].mean(axis=0) if len(indices)
                    else np.zeros(data.shape[1]))
            return TreeNode(mean=np.asarray(mean, np.float32),
                            indices=indices, children=[])
        children = [convert(c)
                    for c in (getattr(node, "clusters", None) or [])]
        indices = getattr(node, "indices", None)
        if indices is None:
            if children and any(len(c.indices) for c in children):
                indices = np.concatenate([c.indices for c in children])
            else:
                indices = np.asarray([], np.int64)
        indices = np.asarray(indices, np.int64)
        mean = getattr(node, "mean", None)
        if mean is None:
            mean = (data[indices].mean(axis=0) if len(indices)
                    else np.zeros(data.shape[1]))
        # KD wrappers stay plain leaf children: beam search scores their
        # member samples as the reference's directed kd-tree descent does
        return TreeNode(mean=np.asarray(mean, np.float32),
                        indices=indices, children=children)

    tree.root = convert(obj.root)
    return tree.to(device)


# ---------------------------------------------------------------------------
# Builder (reference construction/cluster_tree_builder.py:114-266)
# ---------------------------------------------------------------------------

def build_cluster_tree_for_primitive(generator: torch.Generator, prim,
                                     n_samples: int = 10000,
                                     n_subdivisions: int = 4,
                                     max_level: int = 4,
                                     spatial_only: bool = True,
                                     seed: int = 0) -> ClusterTree:
    """n_samples latents of the primitive's GMM, drawn from `generator` on
    the primitive's device (the JAX package draws with a PRNG key: other
    samples, the same distribution), clustered on their spatial
    dimensions (all of them with spatial_only=False); the tree stores the
    full latents and keeps its device copy where they were drawn."""
    from ..models import primitive as prim_mod
    lat_t = prim_mod.sample_latent(generator, prim, n_samples)
    lat = lat_t.cpu().numpy().astype(np.float32)
    cluster_data = lat[:, : prim.n_spatial] if spatial_only else lat
    tree = ClusterTree(n_subdivisions, max_level)
    tree.data = lat
    rng = np.random.default_rng(seed)
    tree.root = _build_on_features(tree, rng, cluster_data,
                                   np.arange(len(lat)), 0)
    return tree.to(lat_t.device)


def _build_on_features(tree: ClusterTree, rng, features: np.ndarray,
                       indices: np.ndarray, level: int) -> TreeNode:
    """Split `indices` by k-means on their feature rows, recursively; each
    node's mean is over the stored data."""
    mean = tree.data[indices].mean(axis=0)
    if level >= tree.max_level or len(indices) <= tree.n_subdivisions:
        return TreeNode(mean=mean, indices=indices, children=[])
    labels = kmeans(rng, features[indices], tree.n_subdivisions)
    children = []
    for c in range(tree.n_subdivisions):
        sub = indices[labels == c]
        if len(sub) > 0:
            children.append(_build_on_features(tree, rng, features, sub,
                                               level + 1))
    if len(children) <= 1:
        return TreeNode(mean=mean, indices=indices, children=[])
    return TreeNode(mean=mean, indices=indices, children=children)
