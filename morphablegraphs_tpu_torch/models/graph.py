"""Motion state graph: host-side nodes and transitions, the packaged-graph
loader (`load_graph`, `read_zip`) and the stacked device tables a graph walk
gathers from (port of morphablegraphs_tpu.models.graph)."""

from __future__ import annotations

import dataclasses
import json
import random
import zipfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .primitive import MotionPrimitive, back_project_unwarped, \
    load_primitive_json, sample_latent
from .skeleton import Skeleton, load_bvh

NODE_TYPE_START = "start"
NODE_TYPE_STANDARD = "standard"
NODE_TYPE_END = "end"
NODE_TYPE_SINGLE = "single_primitive"
NODE_TYPE_CYCLE_END = "cycle_end"
NODE_TYPE_IDLE = "idle"

NODE_TYPES = (NODE_TYPE_START, NODE_TYPE_STANDARD, NODE_TYPE_END,
              NODE_TYPE_SINGLE, NODE_TYPE_CYCLE_END, NODE_TYPE_IDLE)
NODE_TYPE_IDS = {t: i for i, t in enumerate(NODE_TYPES)}
TRANSITION_TYPE_IDS = {**NODE_TYPE_IDS, "action_transition": len(NODE_TYPES)}


@dataclasses.dataclass
class GraphNode:
    key: Tuple[str, str]
    primitive: MotionPrimitive
    node_type: str = NODE_TYPE_STANDARD
    outgoing_edges: Dict[Tuple[str, str], str] = dataclasses.field(
        default_factory=dict)
    average_step_length: float = 0.0
    n_standard_transitions: int = 0
    # a space-partitioning tree of candidate latents
    # (construct/space_partitioning.ClusterTree, its data copied to the
    # graph's device), searched under
    # constrained_sampling_mode="cluster_tree_search"
    cluster_tree: Optional[object] = None
    # per-edge conditional-GMM transition models (models/transition_model)
    transition_models: Dict[Tuple[str, str], object] = dataclasses.field(
        default_factory=dict)

    @property
    def action_name(self) -> str:
        return self.key[0]

    @property
    def name(self) -> str:
        return self.key[1]

    def edges_of_type(self, transition_type: str) -> List[Tuple[str, str]]:
        return [k for k, t in self.outgoing_edges.items()
                if t == transition_type]

    def has_transition_model(self, to_key) -> bool:
        return to_key in self.transition_models

    def predict_gmm(self, to_key, current_parameters):
        """The mixture over the next node's latent conditioned on this
        node's latent; without a model on the edge, this node's own
        mixture (as the reference's node does)."""
        from . import transition_model as tm
        if to_key in self.transition_models:
            return tm.predict(self.transition_models[to_key],
                              current_parameters)
        return self.primitive.gmm


@dataclasses.dataclass
class NodeGroup:
    name: str
    node_keys: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    start_states: List[str] = dataclasses.field(default_factory=list)
    end_states: List[str] = dataclasses.field(default_factory=list)
    idle_states: List[str] = dataclasses.field(default_factory=list)
    cycle_states: List[str] = dataclasses.field(default_factory=list)
    labeled_frames: Dict[str, dict] = dataclasses.field(default_factory=dict)
    label_to_motion_primitive_map: Dict[str, list] = dataclasses.field(
        default_factory=dict)

    def map_label_to_keyframe(self, mp_name: str, label: str,
                              n_canonical_frames: int) -> Optional[int]:
        """The canonical keyframe of a label annotated on a primitive
        (-1 / "lastFrame" -> the last frame, "middle" -> the middle), or
        None."""
        if mp_name in self.labeled_frames \
                and label in self.labeled_frames[mp_name]:
            keyframe = self.labeled_frames[mp_name][label]
            if keyframe in (-1, "lastFrame"):
                keyframe = n_canonical_frames - 1
            elif keyframe == "middle":
                keyframe = n_canonical_frames / 2
            return int(keyframe)
        return None


class MotionStateGraph:
    """Host-side graph of motion primitives."""

    def __init__(self):
        self.nodes: Dict[Tuple[str, str], GraphNode] = {}
        self.node_groups: Dict[str, NodeGroup] = {}
        self.skeleton: Optional[Skeleton] = None
        self.start_node: Optional[Tuple[str, str]] = None
        # action name -> {"node_sequence", "cycle_*", "constraint_slots",
        # ...}: the streaming planner's non-walk actions
        self.action_definitions: dict = {}
        # a HandPoseGenerator when the graph dict carries hand_pose_info
        self.hand_pose_generator = None
        # a package's raw PFNN arrays {weights, means} (models/pfnn)
        self.pfnn_data: Optional[dict] = None

    def add_transition(self, from_key, to_key):
        self.nodes[from_key].outgoing_edges[to_key] = self._transition_type(
            from_key, to_key)

    def _transition_type(self, from_key, to_key) -> str:
        if to_key[0] != from_key[0]:
            return "action_transition"
        from_type = self.nodes[from_key].node_type
        to_type = self.nodes[to_key].node_type
        if from_type == NODE_TYPE_IDLE:
            if to_type in (NODE_TYPE_START, NODE_TYPE_IDLE, NODE_TYPE_END):
                return to_type
            return "action_transition"
        if to_type in (NODE_TYPE_STANDARD, NODE_TYPE_START,
                       NODE_TYPE_CYCLE_END, NODE_TYPE_IDLE):
            return to_type
        return NODE_TYPE_END

    def apply_meta_information(self, action: str, info: Optional[dict]):
        """Start/end/idle/cycle states and packaged step statistics."""
        group = self.node_groups[action]
        info = info or {}
        group.start_states = list(info.get("start_states", []))
        group.end_states = list(info.get("end_states", []))
        group.idle_states = list(info.get("idle_states", []))
        group.cycle_states = list(info.get("cycle_states", []))
        if info:
            # annotations merge with the model files' keyframes
            for mp, ann in info.get("annotations", {}).items():
                if isinstance(ann, dict):
                    group.labeled_frames.setdefault(mp, {}).update(ann)
                else:
                    group.labeled_frames[mp] = ann
            for mp, annotations in group.labeled_frames.items():
                if mp == "all_primitives":
                    continue
                for label in annotations:
                    mps = group.label_to_motion_primitive_map.setdefault(
                        label, [])
                    if mp not in mps:
                        mps.append(mp)
        if len(group.node_keys) == 1:
            self.nodes[group.node_keys[0]].node_type = NODE_TYPE_SINGLE
        else:
            for states, t in ((group.start_states, NODE_TYPE_START),
                              (group.end_states, NODE_TYPE_END),
                              (group.cycle_states, NODE_TYPE_CYCLE_END),
                              (group.idle_states, NODE_TYPE_IDLE)):
                for k in states:
                    self.nodes[(action, k)].node_type = t
        for mp_name, st in info.get("stats", {}).items():
            if (action, mp_name) in self.nodes:
                node = self.nodes[(action, mp_name)]
                node.average_step_length = st.get("average_step_length", 0.0)
                node.n_standard_transitions = st.get("n_standard_transitions",
                                                     0)

    # -- random walks --------------------------------------------------
    def get_random_start_node(self, rng: random.Random, action: str):
        group = self.node_groups[action]
        if group.start_states:
            return (action, rng.choice(group.start_states))
        return None

    def random_transition(self, rng: random.Random, node_key,
                          transition_type):
        edges = self.nodes[node_key].edges_of_type(transition_type)
        if edges:
            return edges[rng.randrange(len(edges))]
        return None

    def generate_random_walk(self, generator: Optional[torch.Generator],
                             action: str, number_of_steps: int,
                             rng: Optional[random.Random] = None,
                             sampler: Optional[Callable] = None):
        """A host-level random walk: a start state, number_of_steps standard
        transitions and one end transition -> [{node_key, parameters}].
        Transitions are chosen by `rng` (random.Random(0) by default), as
        in the JAX package; each entry's latent is one draw of
        sampler(node_key, 1) when given, else of the node's mixture from
        `generator`."""
        rng = rng or random.Random(0)
        current = self.get_random_start_node(rng, action)
        if current is None:
            current = self.node_groups[action].node_keys[0]
        walk = []
        for i in range(number_of_steps + 2):
            if sampler is not None:
                params = sampler(current, 1)[0]
            else:
                params = sample_latent(generator,
                                       self.nodes[current].primitive, 1)[0]
            walk.append({"node_key": current, "parameters": np.asarray(
                torch.as_tensor(params).cpu(), np.float32)})
            if i > number_of_steps:
                break
            t_type = (NODE_TYPE_STANDARD if i < number_of_steps
                      else NODE_TYPE_END)
            nxt = self.random_transition(rng, current, t_type)
            if nxt is None and t_type == NODE_TYPE_STANDARD:
                nxt = self.random_transition(rng, current, NODE_TYPE_END)
            if nxt is None:
                break
            current = nxt
        return walk

    # -- statistics ----------------------------------------------------
    def update_motion_stats(self, generator: torch.Generator,
                            n_samples: int = 5, method: str = "median",
                            only_missing: bool = True):
        """Every node's standard-transition count, and the median (or mean)
        root-path arc length over n_samples GMM draws (unwarped
        back-projection) as its average step length: with only_missing,
        for the nodes without packaged statistics alone."""
        for node in self.nodes.values():
            node.n_standard_transitions = len(
                node.edges_of_type(NODE_TYPE_STANDARD))
            if only_missing and node.average_step_length != 0.0:
                continue
            prim = node.primitive
            lat = _sample_gmm(prim, n_samples, generator)
            root = back_project_unwarped(prim, lat[:, : prim.n_spatial])[
                ..., :3]
            seg = torch.linalg.vector_norm(root[:, 1:] - root[:, :-1],
                                           dim=-1)
            lengths = seg.sum(-1).cpu().numpy()
            node.average_step_length = float(
                np.median(lengths) if method == "median" else
                np.mean(lengths))


def _sample_gmm(prim: MotionPrimitive, n: int,
                generator: torch.Generator) -> torch.Tensor:
    g = prim.gmm
    comp = torch.multinomial(g.weights.cpu(), n, replacement=True,
                             generator=generator).to(g.means.device)
    eps = torch.randn((n, g.n_dims), generator=generator).to(g.means.device)
    return g.means[comp] + torch.einsum("nde,ne->nd", g.cov_chol[comp], eps)


def _resolve_node_key(s: str, split_key: str, nodes: dict):
    """"<action><sep><primitive>" -> a known (action, primitive) key; names
    may contain the separator, so every split position is tried."""
    pieces = s.split(split_key)
    for i in range(1, len(pieces)):
        key = (split_key.join(pieces[:i]), split_key.join(pieces[i:]))
        if key in nodes:
            return key
    return None


def build_graph_from_dict(graph_dict: dict,
                          skeleton: Optional[Skeleton] = None,
                          stats_seed: int = 1234,
                          device=None) -> MotionStateGraph:
    """Build a graph from the zip reader's dict form ("subgraphs",
    "transitions", "startNode", "actionDefinitions", "hand_pose_info",
    "transition_models", "pfnn_data") with its primitives, mixtures and
    transition models on `device` (the CPU by default).  When a node lacks
    packaged statistics, every node's standard-transition count is
    recounted and the missing average step lengths are sampled from a
    torch.Generator seeded with stats_seed (its draws differ from the JAX
    package's).  A node's cluster tree loads as the JAX package loads it:
    the reference's feature-tree JSON, the native `ClusterTree.save` pair
    (the JSON and its `.data` sidecar) or a legacy pickled tree, its data
    copied to `device`."""
    from ..utils.log import LOG_MODE_DEBUG, write_message_to_log
    graph = MotionStateGraph()
    graph.skeleton = skeleton
    for action, action_data in graph_dict.get("subgraphs", {}).items():
        write_message_to_log(f"Load action {action} "
                             f"({len(action_data.get('nodes', {}))} "
                             "primitives)", LOG_MODE_DEBUG)
        group = NodeGroup(name=action)
        graph.node_groups[action] = group
        for mp_name, desc in action_data.get("nodes", {}).items():
            key = (action, mp_name)
            prim = load_primitive_json(desc["mm"], name=f"{action}_{mp_name}",
                                       device=device)
            graph.nodes[key] = GraphNode(key=key, primitive=prim)
            group.node_keys.append(key)
            st = desc.get("stats")
            if st:
                graph.nodes[key].average_step_length = float(
                    st.get("average_step_length", 0.0))
                graph.nodes[key].n_standard_transitions = int(
                    st.get("n_standard_transitions", 0))
            tree_dev = "cpu" if device is None else device
            if "space_partition_json" in desc:
                from ..construct.space_partitioning import (
                    ClusterTree, load_reference_feature_tree_json)
                tj = desc["space_partition_json"]
                if "data" in tj:  # the reference's FeatureClusterTree
                    graph.nodes[key].cluster_tree = \
                        load_reference_feature_tree_json(tj, device=tree_dev)
                else:  # the native ClusterTree.save meta and .data sidecar
                    sidecar = desc.get("space_partition_data")
                    if sidecar is None:
                        raise ValueError(
                            f"cluster tree for node {key} has no 'data' key "
                            "(reference FeatureClusterTree layout) and no "
                            "'.data' sidecar next to its "
                            "'*_cluster_tree.json' in the zip — the native "
                            "ClusterTree.save layout needs both files")
                    graph.nodes[key].cluster_tree = \
                        ClusterTree.from_native_json(tj, sidecar,
                                                     device=tree_dev)
            elif "space_partition_pickle" in desc:
                # legacy pickled trees (formatVersion < 4 / usePickle
                # packages, reference zip_io.py:210-223)
                from ..construct.space_partitioning import \
                    load_reference_pickle_tree
                graph.nodes[key].cluster_tree = load_reference_pickle_tree(
                    desc["space_partition_pickle"], device=tree_dev)
            # the model files' keyframes feed the label maps
            kf = desc["mm"].get("keyframes", {})
            if kf:
                group.labeled_frames.setdefault(mp_name, {}).update(kf)
                for label in kf:
                    group.label_to_motion_primitive_map.setdefault(
                        label, []).append(mp_name)
        graph.apply_meta_information(action, action_data.get("info"))
        if action == "walk" and group.idle_states:
            graph.start_node = (action, group.idle_states[0])

    transitions = graph_dict.get("transitions", {})
    if transitions:
        split_key = ":" if ":" in next(iter(transitions)) else "_"
        for from_str, to_list in transitions.items():
            from_key = _resolve_node_key(from_str, split_key, graph.nodes)
            if from_key is None:
                continue
            for to_str in to_list:
                to_key = _resolve_node_key(to_str, split_key, graph.nodes)
                if to_key is not None:
                    graph.add_transition(from_key, to_key)

    # per-edge transition models carry their own from/to keys
    for entry in graph_dict.get("transition_models", []):
        from . import transition_model as tm
        split_key = ":" if ":" in entry["from"] else "_"
        from_key = _resolve_node_key(entry["from"], split_key, graph.nodes)
        to_key = _resolve_node_key(entry["to"], split_key, graph.nodes)
        if from_key is None or to_key is None:
            write_message_to_log(
                f"skipping transition model {entry['from']} -> "
                f"{entry['to']}: unknown node")
            continue
        graph.nodes[from_key].transition_models[to_key] = tm.from_json(
            entry["model"], device=device)

    if any(n.average_step_length == 0.0 for n in graph.nodes.values()):
        graph.update_motion_stats(torch.Generator().manual_seed(stats_seed))
    if "actionDefinitions" in graph_dict:
        graph.action_definitions = graph_dict["actionDefinitions"]
    if "startNode" in graph_dict:
        graph.start_node = tuple(graph_dict["startNode"])
    if "hand_pose_info" in graph_dict:
        from ..synthesis.hand_pose import HandPoseGenerator
        graph.hand_pose_generator = HandPoseGenerator(graph.skeleton)
        graph.hand_pose_generator.init_from_desc(graph_dict["hand_pose_info"])
    if "pfnn_data" in graph_dict:
        graph.pfnn_data = graph_dict["pfnn_data"]
    return graph


def read_zip(zip_path: str) -> dict:
    """A packaged graph zip (format versions 1-4) -> the dict form
    `build_graph_from_dict` reads."""
    with zipfile.ZipFile(zip_path, "r") as zf:
        return _read_zip_open(zf)


def _read_zip_open(zf: zipfile.ZipFile) -> dict:
    data = json.loads(zf.read("graph_definition.json").decode("utf-8"))
    version = float(data.get("formatVersion", 1.0))
    names = set(zf.namelist())

    ea_dir = "elementary_action_models"
    ea_prefix = "elementary_action_"
    actions: Dict[str, dict] = {}
    for name in sorted(names):
        parts = name.split("/")
        if version >= 2.0:
            if not (len(parts) > 2 and parts[0] == ea_dir
                    and parts[2].endswith("mm.json")):
                continue
            action_dir, fname = parts[1], parts[2]
        else:
            if not (len(parts) > 1 and parts[1].endswith("mm.json")):
                continue
            action_dir, fname = parts[0], parts[1]
        # elementary_action_<name>: action names may contain underscores,
        # so the prefix is stripped, never split on
        action_key = (action_dir[len(ea_prefix):]
                      if action_dir.startswith(ea_prefix) else action_dir)
        entry = actions.setdefault(action_key, {"name": action_key,
                                                "nodes": {}})
        mp_full = fname[: -len("_mm.json")]  # <action>_<primitive>
        mp_key = (mp_full[len(action_key) + 1:]
                  if mp_full.startswith(action_key + "_")
                  else mp_full[len(mp_full.split("_")[0]) + 1:])
        prefix = f"{ea_dir}/{action_dir}" if version >= 2.0 else action_dir
        node = {"name": mp_full,
                "mm": json.loads(zf.read(name).decode("utf-8"))}
        stats_path = f"{prefix}/{mp_full}.stats"
        if stats_path in names:
            node["stats"] = json.loads(zf.read(stats_path).decode("utf-8"))
        tree_path = f"{prefix}/{mp_full}_cluster_tree.json"
        data_path = f"{prefix}/{mp_full}_cluster_tree.data"
        pck_path = f"{prefix}/{mp_full}_cluster_tree.pck"
        if tree_path in names:
            node["space_partition_json"] = json.loads(
                zf.read(tree_path).decode("utf-8"))
            if data_path in names:
                node["space_partition_data"] = zf.read(data_path)
        elif pck_path in names:
            node["space_partition_pickle"] = zf.read(pck_path)
        entry["nodes"][mp_key] = node
        meta_path = f"{prefix}/meta_information.json"
        if meta_path in names and "info" not in entry:
            entry["info"] = json.loads(zf.read(meta_path).decode("utf-8"))

    data["subgraphs"] = actions
    # whatever skeleton the package carries, whatever its version
    if "skeleton.bvh" in names:
        data["bvh_skeleton_string"] = zf.read("skeleton.bvh").decode("utf-8")
    if "skeleton.json" in names:
        data["skeleton"] = json.loads(zf.read("skeleton.json").decode("utf-8"))

    if "hand_poses/hand_pose_info.json" in names:
        info = json.loads(zf.read("hand_poses/hand_pose_info.json")
                          .decode("utf-8"))
        info["skeletonStrings"] = {}
        for n in names:
            parts = n.split("/")
            if len(parts) > 1 and parts[0] == "hand_poses" \
                    and n.endswith(".bvh"):
                info["skeletonStrings"][parts[1][:-4]] = zf.read(n).decode(
                    "utf-8")
        data["hand_pose_info"] = info

    # conditional-GMM JSONs carry their own from/to keys; the reference's
    # .GPM blobs are pickles of an unshipped package and cannot be read
    tm_entries = []
    for n in sorted(names):
        if n.startswith("transition_models/") and n.endswith(".json"):
            tm_entries.append(json.loads(zf.read(n).decode("utf-8")))
        elif n.startswith("transition_models/") and n.endswith(".GPM"):
            from ..utils.log import write_message_to_log
            write_message_to_log(
                f"skipping {n}: reference .GPM transition models are "
                "pickled objects of an unshipped package; retrain with "
                "models/transition_model.fit_transition_model")
    if tm_entries:
        data["transition_models"] = tm_entries

    from .pfnn import read_pfnn_arrays  # raises on a partial pfnn/ section
    pfnn_data = read_pfnn_arrays(zf)
    if pfnn_data is not None:
        data["pfnn_data"] = pfnn_data
    return data


def load_graph(path: str, device=None) -> MotionStateGraph:
    """Load a packaged graph (`.zip`) with its primitives, mixtures and
    transition models on `device` (the CUDA device unless given another).
    The skeleton comes from skeleton.bvh, else skeleton.json; without its
    own joint weights it gets the package's explicit ones or
    depth-attenuated defaults."""
    from ..utils import device as device_mod
    dev = device_mod.resolve(device, "load_graph")
    if not path.endswith(".zip"):
        path = path + ".zip"
    data = read_zip(path)
    skeleton = None
    if "bvh_skeleton_string" in data:
        skeleton, _ = load_bvh(data["bvh_skeleton_string"])
    elif "skeleton" in data:
        from .skeleton import load_skeleton_json
        skeleton = load_skeleton_json(data["skeleton"])
    if skeleton is not None and not skeleton.joint_weights:
        from .skeleton_models import depth_joint_weights
        explicit = (data.get("skeleton") or {}).get("joint_weights")
        weights = (tuple(float(w) for w in explicit) if explicit
                   else depth_joint_weights(skeleton))
        if len(weights) == skeleton.n_animated:
            skeleton = dataclasses.replace(skeleton, joint_weights=weights)
    return build_graph_from_dict(data, skeleton, device=dev)


@dataclasses.dataclass
class StackedGraph:
    """All primitives padded and stacked; a walk step gathers row node_id
    from every tensor."""

    eigen_s: torch.Tensor  # [N, D_max, k_s_max]
    mean_s: torch.Tensor  # [N, D_max]
    knots_s: torch.Tensor  # [N, n_knots_max]
    mean_t_d: torch.Tensor  # [N, F_max]
    eigen_t_d: torch.Tensor  # [N, F_max, k_t_max]
    gmm_weights: torch.Tensor  # [N, K_max]
    gmm_means: torch.Tensor  # [N, K_max, L_max]
    gmm_cov_chol: torch.Tensor  # [N, K_max, L_max, L_max]
    gmm_prec_chol: torch.Tensor  # [N, K_max, L_max, L_max]
    n_canonical: torch.Tensor  # [N] int32
    node_n_basis: torch.Tensor  # [N] int32
    n_spatial: torch.Tensor  # [N] int32
    n_latent: torch.Tensor  # [N] int32
    avg_step_length: torch.Tensor  # [N] f32
    node_type: torch.Tensor  # [N] int32 (NODE_TYPE_IDS)
    transitions: torch.Tensor  # [T_types, N, N] bool
    node_keys: tuple = ()
    n_dim: int = 0
    n_basis_max: int = 0
    max_canonical: int = 0
    k_s_max: int = 0
    k_t_max: int = 0

    _TENSORS = ("eigen_s", "mean_s", "knots_s", "mean_t_d", "eigen_t_d",
                "gmm_weights", "gmm_means", "gmm_cov_chol", "gmm_prec_chol",
                "n_canonical", "node_n_basis", "n_spatial", "n_latent",
                "avg_step_length", "node_type", "transitions")
    _STATIC = ("node_keys", "n_dim", "n_basis_max", "max_canonical",
               "k_s_max", "k_t_max")

    @property
    def n_nodes(self) -> int:
        return len(self.node_keys)

    def node_id(self, key: Tuple[str, str]) -> int:
        return self.node_keys.index(tuple(key))

    def to(self, device) -> "StackedGraph":
        kw = {n: getattr(self, n).to(device) for n in self._TENSORS}
        kw.update({n: getattr(self, n) for n in self._STATIC})
        return StackedGraph(**kw)


def _from_numpy(arrays: dict, static: dict, device) -> StackedGraph:
    kw = {}
    for name in StackedGraph._TENSORS:
        a = np.array(arrays[name])
        dtype = (torch.bool if a.dtype == bool
                 else torch.int32 if np.issubdtype(a.dtype, np.integer)
                 else torch.float32)
        kw[name] = torch.as_tensor(a, dtype=dtype, device=device)
    kw.update(static)
    return StackedGraph(**kw)


def from_jax_numpy(stacked, device=None) -> StackedGraph:
    """The JAX package's StackedGraph (leaves as numpy arrays) -> the port's
    StackedGraph on `device`."""
    return _from_numpy({n: getattr(stacked, n) for n in StackedGraph._TENSORS},
                       {n: getattr(stacked, n) for n in StackedGraph._STATIC},
                       device)


def stack_graph(graph: MotionStateGraph, device=None) -> StackedGraph:
    """Pad and stack every node's primitive.  Extra eigen columns and basis
    rows are zero, extra knots repeat the end knot, padded GMM components
    get weight 0 and identity factors, padded latent dims variance 1."""
    keys = tuple(sorted(graph.nodes.keys()))
    prims = [graph.nodes[k].primitive for k in keys]
    n = len(keys)
    n_dim = prims[0].n_dim
    if any(p.n_dim != n_dim for p in prims):
        raise ValueError("mixed skeletons unsupported")
    n_basis_max = max(p.n_basis for p in prims)
    d_max = n_basis_max * n_dim
    f_max = max(p.n_canonical_frames for p in prims)
    k_s_max = max(p.n_spatial for p in prims)
    k_t_max = max(p.n_time for p in prims)
    l_max = k_s_max + k_t_max
    k_max = max(int(p.gmm.weights.shape[-1]) for p in prims)

    a = dict(
        eigen_s=np.zeros((n, d_max, k_s_max), np.float32),
        mean_s=np.zeros((n, d_max), np.float32),
        knots_s=np.zeros((n, n_basis_max + 4), np.float32),
        mean_t_d=np.zeros((n, f_max), np.float32),
        eigen_t_d=np.zeros((n, f_max, k_t_max), np.float32),
        gmm_weights=np.zeros((n, k_max), np.float32),
        gmm_means=np.zeros((n, k_max, l_max), np.float32),
        gmm_cov_chol=np.tile(np.eye(l_max, dtype=np.float32),
                             (n, k_max, 1, 1)),
        gmm_prec_chol=np.tile(np.eye(l_max, dtype=np.float32),
                              (n, k_max, 1, 1)),
        n_canonical=np.zeros(n, np.int32), node_n_basis=np.zeros(n, np.int32),
        n_spatial=np.zeros(n, np.int32), n_latent=np.zeros(n, np.int32),
        avg_step_length=np.zeros(n, np.float32),
        node_type=np.zeros(n, np.int32))

    def np32(t):
        return t.detach().cpu().numpy()

    for i, (key, p) in enumerate(zip(keys, prims)):
        ds = p.n_basis * p.n_dim
        es = np32(p.eigen_s).reshape(p.n_basis, p.n_dim, p.n_spatial)
        a["eigen_s"][i, :ds].reshape(p.n_basis, n_dim, k_s_max)[
            :, :, : p.n_spatial] = es
        a["mean_s"][i, :ds] = np32(p.mean_s)
        kn = np32(p.knots_s)
        a["knots_s"][i, : kn.shape[0]] = kn
        a["knots_s"][i, kn.shape[0]:] = kn[-1]
        a["n_canonical"][i] = p.n_canonical_frames
        a["node_n_basis"][i] = p.n_basis
        a["mean_t_d"][i, : p.n_canonical_frames] = np32(p.mean_t_d)
        if p.n_time > 0:
            a["eigen_t_d"][i, : p.n_canonical_frames, : p.n_time] = \
                np32(p.eigen_t_d)
        k = int(p.gmm.weights.shape[-1])
        a["gmm_weights"][i, :k] = np32(p.gmm.weights)
        idx = np.concatenate([np.arange(p.n_spatial),
                              k_s_max + np.arange(p.n_time)]).astype(int)
        a["gmm_means"][i][:k][:, idx] = np32(p.gmm.means)
        a["gmm_cov_chol"][i, :k][:, idx[:, None], idx[None, :]] = \
            np32(p.gmm.cov_chol)
        a["gmm_prec_chol"][i, :k][:, idx[:, None], idx[None, :]] = \
            np32(p.gmm.prec_chol)
        a["n_spatial"][i] = p.n_spatial
        a["n_latent"][i] = p.n_latent
        node = graph.nodes[key]
        a["avg_step_length"][i] = node.average_step_length
        a["node_type"][i] = NODE_TYPE_IDS[node.node_type]

    trans = np.zeros((len(TRANSITION_TYPE_IDS), n, n), bool)
    for i, key in enumerate(keys):
        for to_key, t_type in graph.nodes[key].outgoing_edges.items():
            trans[TRANSITION_TYPE_IDS[t_type], i, keys.index(to_key)] = True
    a["transitions"] = trans
    return _from_numpy(a, dict(node_keys=keys, n_dim=n_dim,
                               n_basis_max=n_basis_max, max_canonical=f_max,
                               k_s_max=k_s_max, k_t_max=k_t_max), device)
