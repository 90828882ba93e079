"""Graph package writer, the inverse of graph.read_zip (port of
morphablegraphs_tpu.models.zip_writer).

Writes the packaged layout the loader reads:
  graph_definition.json, skeleton.bvh,
  elementary_action_models/elementary_action_<a>/<a>_<mp>_mm.json
  (elementary_action_<a>/... below format version 2), meta_information.json,
  *_cluster_tree.json, hand_poses/, pfnn/, transition_models/.
"""

from __future__ import annotations

import json
import zipfile
from typing import Dict, Optional

import numpy as np

from .skeleton import Skeleton, write_bvh


def write_graph_zip(path: str, skeleton: Skeleton,
                    actions: Dict[str, dict],
                    transitions: Dict[str, list],
                    start_node: Optional[tuple] = None,
                    action_definitions: Optional[dict] = None,
                    format_version: float = 2.0,
                    hand_pose_info: Optional[dict] = None,
                    pfnn_data: Optional[dict] = None,
                    transition_models: Optional[list] = None):
    """actions: {action_name: {"nodes": {mp_name: model_json},
                               "info": meta_info_dict,
                               "cluster_trees": {mp_name: a ClusterTree
                                                 or a tree JSON dict}}}.
    transitions: {"action_mp": ["action2_mp2", ...]}.
    hand_pose_info / pfnn_data: optional sections in the reference layout
    (zip_io.py hand_poses/ + pfnn/weights|means float32 binaries).
    transition_models: optional [{"from": "a_mp", "to": "a2_mp2",
    "model": transition_model.to_json(...)}] — written under the
    reference's transition_models/ directory (zip_io.py:40) as JSON.
    """
    if not path.endswith(".zip"):
        path += ".zip"
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        graph_def = {"formatVersion": format_version,
                     "transitions": transitions}
        if start_node is not None:
            graph_def["startNode"] = list(start_node)
        if action_definitions:
            graph_def["actionDefinitions"] = action_definitions
        zf.writestr("graph_definition.json", json.dumps(graph_def))

        rest = np.zeros((1, skeleton.n_frame_params), np.float32)
        for j in range(skeleton.n_animated):
            rest[0, 3 + 4 * j] = 1.0
        zf.writestr("skeleton.bvh", write_bvh(skeleton, rest))

        for action, desc in actions.items():
            # v1 packages use 2-part paths (no elementary_action_models/
            # container, reference zip_io _read_..._v1); v2+ use 3-part
            prefix = (f"elementary_action_{action}" if format_version < 2.0
                      else f"elementary_action_models/elementary_action_{action}")
            for mp_name, mm in desc.get("nodes", {}).items():
                zf.writestr(f"{prefix}/{action}_{mp_name}_mm.json",
                            json.dumps(mm))
            if "info" in desc:
                zf.writestr(f"{prefix}/meta_information.json",
                            json.dumps(desc["info"]))
            for mp_name, tree in desc.get("cluster_trees", {}).items():
                base = f"{prefix}/{action}_{mp_name}_cluster_tree"
                if hasattr(tree, "data") and hasattr(tree, "root"):
                    # a ClusterTree: its own save() layout, the JSON meta
                    # and the raw float32 .data sidecar
                    meta = {"n_subdivisions": tree.n_subdivisions,
                            "max_level": tree.max_level,
                            "n_dims": int(tree.data.shape[1]),
                            "root": tree._node_to_json(tree.root)}
                    zf.writestr(base + ".json", json.dumps(meta))
                    zf.writestr(base + ".data",
                                tree.data.astype(np.float32).tobytes())
                else:  # the reference's FeatureClusterTree JSON dict
                    zf.writestr(base + ".json", json.dumps(tree))

        if hand_pose_info is not None:
            info = {k: v for k, v in hand_pose_info.items()
                    if k != "skeletonStrings"}
            zf.writestr("hand_poses/hand_pose_info.json", json.dumps(info))
            for name, bvh in hand_pose_info.get("skeletonStrings", {}).items():
                zf.writestr(f"hand_poses/{name}.bvh", bvh)

        if pfnn_data is not None:
            for k, v in pfnn_data.get("weights", {}).items():
                zf.writestr(f"pfnn/weights/{k}.bin",
                            np.asarray(v, np.float32).tobytes())
            for k, v in pfnn_data.get("means", {}).items():
                zf.writestr(f"pfnn/means/{k}.bin",
                            np.asarray(v, np.float32).tobytes())

        for entry in transition_models or []:
            zf.writestr(
                f"transition_models/{entry['from']}_to_{entry['to']}.json",
                json.dumps(entry))
    return path
