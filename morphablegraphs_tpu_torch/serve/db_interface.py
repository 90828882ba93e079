"""Remote motion-database interface (port of
morphablegraphs_tpu.serve.db_interface).

Replaces reference utilities/db_interface.py: an HTTP client for the
motion DB used to download clips, skeletons and graphs, upload trained
models, and run the training and alignment pipelines on DB-hosted data
(motion_state_graph_loader.py:76-180 build_from_database consumes these).

Every endpoint follows the reference's REST shape (POST with a JSON body to
<url>/<route>), and all traffic goes through `_post`, on the standard
library's urllib.  The pipelines train on `device`: the CUDA device unless
the caller names another.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional

import numpy as np
import torch

from ..utils import device as device_mod


def authenticate(url: str, user: str, password: str) -> dict:
    """POST /authenticate and return the server reply (contains "token" on
    success) — reference motion_db_interface.authenticate used by
    examples/utils.py get_session."""
    return _post(url, "authenticate", {"username": user, "password": password})


def get_session(url: str, user: Optional[str] = None,
                password: Optional[str] = None,
                token: Optional[str] = None) -> Optional[dict]:
    """Session dict for DB requests (reference examples/utils.py:3-11):
    user+password -> authenticate for a token; user+token -> use directly."""
    if user is not None and password is not None:
        result = authenticate(url, user, password)
        if isinstance(result, dict) and "token" in result:
            return {"user": user, "token": result["token"]}
        return None
    if user is not None and token is not None:
        return {"user": user, "token": token}
    return None


def _post(url: str, route: str, data: dict, timeout: float = 60.0,
          session: Optional[dict] = None):
    """POST data (with the session merged in) as JSON to <url>/<route> ->
    the reply's JSON, or its text when it is not JSON.  A status outside
    2xx raises urllib.error.HTTPError, a transport failure URLError (both
    OSError)."""
    if session is not None:
        data = dict(data, session=session)
    req = urllib.request.Request(
        url.rstrip("/") + "/" + route, data=json.dumps(data).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        text = resp.read().decode()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def get_skeleton_from_remote_db(url: str, skeleton_name: str, session=None):
    return _post(url, "get_skeleton", {"skeleton_name": skeleton_name}, session=session)


def get_skeleton_model_from_remote_db(url: str, skeleton_name: str, session=None):
    return _post(url, "get_skeleton_model", {"skeleton_name": skeleton_name}, session=session)


def download_graph_from_remote_db(url: str, graph_id, session=None):
    return _post(url, "download_graph", {"graph_id": graph_id}, session=session)


def download_motion_model_from_remote_db(url: str, model_id, session=None):
    return _post(url, "download_motion_model", {"model_id": model_id}, session=session)


def download_cluster_tree_from_remote_db(url: str, model_id, session=None):
    """The model's cluster tree, or None when the request fails (a status
    outside 2xx or no connection)."""
    try:
        return _post(url, "download_cluster_tree", {"model_id": model_id},
                     session=session)
    except OSError:
        return None


def get_motion_list_from_remote_db(url: str, collection_id, skeleton_name: str,
                                  session=None):
    return _post(url, "get_motion_list", {"collection_id": collection_id,
                                          "skeleton": skeleton_name},
                 session=session)


def download_motion_from_remote_db(url: str, motion_id, session=None):
    return _post(url, "download_motion", {"motion_id": motion_id}, session=session)


def upload_motion_model(url: str, name: str, collection_id, skeleton_name: str,
                        model_data: dict, session=None):
    return _post(url, "upload_motion_model",
                 {"name": name, "collection": collection_id,
                  "skeleton": skeleton_name, "data": model_data},
                 session=session)


def upload_cluster_tree(url: str, model_id, tree_data: dict, session=None):
    return _post(url, "upload_cluster_tree",
                 {"model_id": model_id, "cluster_tree_data": tree_data},
                 session=session)


# ---------------------------------------------------------------------------
# DB-backed pipelines (reference db_interface.py:178-430)
# ---------------------------------------------------------------------------

def _download_collection(url: str, collection_id, skeleton_name: str,
                         session: Optional[dict]) -> dict:
    """{motion id: frames [T, D] float64} of a collection."""
    motion_list = get_motion_list_from_remote_db(url, collection_id,
                                                 skeleton_name,
                                                 session=session)
    motions = {}
    for entry in motion_list or []:
        m = download_motion_from_remote_db(url, entry["id"], session=session)
        if m is not None:
            motions[entry["id"]] = np.asarray(m["frames"], np.float64)
    return motions


def align_motion_data_in_db(url: str, collection_id, skeleton_name: str,
                            skeleton, constructor_config: Optional[dict] = None,
                            session: Optional[dict] = None, device=None):
    """Download a collection's motions, run spatial+temporal alignment on
    `device`, and return the aligned frames + warps (reference
    align_motion_data :178).

    constructor_config: optional {"ref_orientation": (x, z),
    "mean_key": motion id} alignment options."""
    from ..construct.constructor import (align_frames_spatially,
                                         align_frames_temporally)
    dev = device_mod.resolve(device, "align_motion_data_in_db")
    motions = _download_collection(url, collection_id, skeleton_name, session)
    if not motions:
        return None, None
    cfg = constructor_config or {}
    aligned = align_frames_spatially(
        motions, ref_orientation=cfg.get("ref_orientation", (0.0, -1.0)),
        device=dev)
    return align_frames_temporally(skeleton, aligned,
                                   mean_key=cfg.get("mean_key"), device=dev)


def create_motion_model_in_db(url: str, collection_id, skeleton_name: str,
                              skeleton, name: str, version: int = 3,
                              config: Optional[dict] = None,
                              session: Optional[dict] = None, device=None):
    """Train a model on a DB collection on `device` and upload it
    (reference create_motion_model_in_db :274)."""
    from ..construct.constructor import MotionModelConstructor
    dev = device_mod.resolve(device, "create_motion_model_in_db")
    motions = _download_collection(url, collection_id, skeleton_name, session)
    if not motions:
        raise ValueError("no motions in collection")
    c = MotionModelConstructor(skeleton, config, device=dev)
    c.set_motions(motions)
    model = c.construct_model(name, version=version)
    upload_motion_model(url, name, collection_id, skeleton_name, model,
                        session=session)
    return model


def create_cluster_tree_for_model_in_db(url: str, model_id, n_samples: int = 10000,
                                        session: Optional[dict] = None,
                                        device=None):
    """Build a cluster tree for a DB-hosted model and upload it (reference
    create_cluster_tree_from_model :45); its samples are drawn on `device`
    from a torch.Generator seeded with 0."""
    from ..construct.space_partitioning import build_cluster_tree_for_primitive
    from ..models.primitive import load_primitive_json
    dev = device_mod.resolve(device, "create_cluster_tree_for_model_in_db")
    model_data = download_motion_model_from_remote_db(url, model_id,
                                                      session=session)
    prim = load_primitive_json(model_data, device=dev)
    tree = build_cluster_tree_for_primitive(
        torch.Generator(device=dev).manual_seed(0), prim, n_samples=n_samples)
    tree_json = {"data": tree.data.tolist(),
                 "options": {"n_subdivisions_per_level": tree.n_subdivisions,
                             "n_levels": tree.max_level},
                 "root": tree._node_to_json(tree.root)}
    upload_cluster_tree(url, model_id, tree_json, session=session)
    return tree
