"""The port's motion-database client (serve/db_interface.py, on urllib)
against the JAX package's (on requests), each under a fake transport that
records every POST and replies from the same route table: no socket
opens.  The same replies must give the same URLs and payloads, the same
session threading, and the same results; the DB-backed pipelines train on
the CPU (the model JSON held as tests/test_torch_construct.py holds the
constructor's: its arrays to 1e-4 relative, the mixture by K).  The
cluster tree's payload has JAX's schema; its samples come from a
torch.Generator, so its values are not JAX's."""

import io
import json
import urllib.error

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.serve import db_interface as dbj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.serve import db_interface as dbt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

SESSION = {"user": "u", "token": "t"}
# 3 spatial and 2 temporal components over 12 clips: every mixture
# component keeps a covariance of full rank, so JAX's float32 EM and the
# port's float64 EM take the same path (tests/test_torch_construct.py)
TRAIN_CONFIG = {"max_gmm_components": 2, "npc_temporal": 2,
                "n_components": 3}


class _JaxResp:
    def __init__(self, payload):
        self._payload = payload
        self.text = payload if isinstance(payload, str) else \
            json.dumps(payload)

    def raise_for_status(self):
        pass

    def json(self):
        if isinstance(self._payload, str):
            raise json.JSONDecodeError("not JSON", self._payload, 0)
        return self._payload


class _UrlResp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@pytest.fixture
def transports(monkeypatch):
    """-> (replies, JAX's calls, the port's calls): both modules' POSTs go
    to one route -> reply table (a callable reply gets the payload; a str
    reply is a body that is not JSON)."""
    replies, calls_j, calls_t = {}, [], []

    def reply_for(url, payload):
        reply = replies.get(url.rsplit("/", 1)[-1], {})
        return reply(payload) if callable(reply) else reply

    def post(url, json=None, timeout=None):
        calls_j.append((url, json))
        return _JaxResp(reply_for(url, json))

    def urlopen(req, timeout=None):
        assert req.get_method() == "POST"
        assert req.get_header("Content-type") == "application/json"
        payload = json.loads(req.data)
        calls_t.append((req.full_url, payload))
        reply = reply_for(req.full_url, payload)
        body = reply if isinstance(reply, str) else json.dumps(reply)
        return _UrlResp(body.encode())

    monkeypatch.setattr(dbj.requests, "post", post)
    monkeypatch.setattr(dbt.urllib.request, "urlopen", urlopen)
    return replies, calls_j, calls_t


def _both(fn_name, *args, **kw):
    return (getattr(dbj, fn_name)(*args, **kw),
            getattr(dbt, fn_name)(*args, **kw))


def test_authenticate_and_get_session(transports):
    replies, calls_j, calls_t = transports
    replies["authenticate"] = {"token": "abc123"}
    s_j, s_t = _both("get_session", "http://db", user="u", password="pw")
    assert s_t == s_j == {"user": "u", "token": "abc123"}
    # a direct token sends nothing; a failed authentication gives None
    assert _both("get_session", "http://db/", user="u", token="t9") == \
        ({"user": "u", "token": "t9"},) * 2
    replies["authenticate"] = {"error": "bad"}
    assert _both("get_session", "http://db", user="u", password="x") == \
        (None, None)
    assert calls_t == calls_j and len(calls_t) == 2
    assert calls_t[0] == ("http://db/authenticate",
                          {"username": "u", "password": "pw"})


ROUTES = (
    ("get_skeleton_from_remote_db", ("custom",), "get_skeleton"),
    ("get_skeleton_model_from_remote_db", ("custom",), "get_skeleton_model"),
    ("download_graph_from_remote_db", (4,), "download_graph"),
    ("download_motion_model_from_remote_db", (5,), "download_motion_model"),
    ("download_cluster_tree_from_remote_db", (5,), "download_cluster_tree"),
    ("get_motion_list_from_remote_db", (3, "custom"), "get_motion_list"),
    ("download_motion_from_remote_db", (7,), "download_motion"),
    ("upload_motion_model", ("walk", 3, "custom", {"sspm": [1.0]}),
     "upload_motion_model"),
    ("upload_cluster_tree", (5, {"data": [[0.5]]}), "upload_cluster_tree"),
)


@pytest.mark.parametrize("session", [None, SESSION])
def test_every_route_sends_jax_payloads(transports, session):
    """Each route function: the same URL and payload as JAX's, the session
    merged in only when given, the reply returned as parsed JSON, or as
    its text when it is not JSON."""
    replies, calls_j, calls_t = transports
    for i, (name, args, route) in enumerate(ROUTES):
        replies[route] = {"route": route, "i": i} if i % 2 else f"text {i}"
        out_j, out_t = _both(name, "http://db/", *args, session=session)
        assert out_t == out_j == replies[route]
    assert calls_t == calls_j
    assert [u.rsplit("/", 1)[-1] for u, _ in calls_t] == \
        [r for _, _, r in ROUTES]
    assert all(("session" in p) == (session is not None)
               and p.get("session") == session for _, p in calls_t)


def test_transport_errors(transports, monkeypatch):
    """A status outside 2xx raises (as raise_for_status does); the cluster
    tree's download answers None on a failed request, as JAX's does on
    requests.RequestException."""
    def refuse(req, timeout=None):
        raise urllib.error.HTTPError(req.full_url, 503, "unavailable", {},
                                     None)
    monkeypatch.setattr(dbt.urllib.request, "urlopen", refuse)
    with pytest.raises(urllib.error.HTTPError):
        dbt.download_motion_from_remote_db("http://db", 7)
    assert dbt.download_cluster_tree_from_remote_db("http://db", 5) is None

    def unreachable(req, timeout=None):
        raise urllib.error.URLError("no route to host")
    monkeypatch.setattr(dbt.urllib.request, "urlopen", unreachable)
    assert dbt.download_cluster_tree_from_remote_db("http://db", 5) is None

    def post(url, json=None, timeout=None):
        raise dbj.requests.ConnectionError("no route to host")
    monkeypatch.setattr(dbj.requests, "post", post)
    assert dbj.download_cluster_tree_from_remote_db("http://db", 5) is None


@pytest.fixture(scope="module")
def db_clips():
    """Twelve clips of a toy model (JAX's draws), unit quaternions, as
    lists of the DB's download_motion replies."""
    src = prj.load_primitive_json(synj.make_legacy_model_json(seed=9,
                                                              n_joints=4))
    key = jax.random.PRNGKey(0)
    clips = {}
    for i in range(12):
        key, sub = jax.random.split(key)
        s = prj.sample_latent(sub, src, 1)[0]
        frames, n, _ = prj.back_project(src, s, 96, use_time=True)
        f = np.asarray(frames)[: int(n)].astype(np.float64)
        q = f[:, 3:].reshape(len(f), -1, 4)
        f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
            len(f), -1)
        clips[i] = f.astype(np.float32).tolist()
    return clips


def _serve_collection(replies, clips):
    replies["get_motion_list"] = [{"id": i} for i in clips]
    replies["download_motion"] = lambda p: {"frames": clips[p["motion_id"]]}


def test_db_backed_training_pipeline_matches_jax(transports, db_clips):
    """create_motion_model_in_db: list, download each, train (the port on
    the CPU), upload: the same calls in the same order with the session in
    each, and the uploaded model JAX's within the constructor tests'
    bounds."""
    replies, calls_j, calls_t = transports
    _serve_collection(replies, db_clips)
    args = ("http://db", 3, "custom")
    m_j = dbj.create_motion_model_in_db(
        *args, skj.load_bvh(synj.TEST_BVH)[0], "walk_leftStance", version=3,
        config=TRAIN_CONFIG, session=SESSION)
    m_t = dbt.create_motion_model_in_db(
        *args, skt.load_bvh(synj.TEST_BVH)[0], "walk_leftStance", version=3,
        config=TRAIN_CONFIG, session=SESSION, device="cpu")
    routes = [u.rsplit("/", 1)[-1] for u, _ in calls_t]
    assert routes == [u.rsplit("/", 1)[-1] for u, _ in calls_j]
    assert routes[0] == "get_motion_list" and routes[-1] == \
        "upload_motion_model" and routes.count("download_motion") == 12
    assert calls_t[:-1] == calls_j[:-1]
    assert all(p["session"] == SESSION for _, p in calls_t)
    up_j, up_t = calls_j[-1][1], calls_t[-1][1]
    assert {k: v for k, v in up_t.items() if k != "data"} == \
        {k: v for k, v in up_j.items() if k != "data"}
    assert up_t["data"] == m_t
    tp.assert_model_json_close(m_t, m_j, {"gmm"})
    assert len(m_t["gmm"]["weights"]) == len(m_j["gmm"]["weights"])


def test_db_backed_alignment_and_cluster_tree(transports, db_clips):
    """align_motion_data_in_db gives JAX's warping functions and warped
    frames; create_cluster_tree_for_model_in_db uploads a tree of JAX's
    schema drawn from the downloaded model; an empty collection gives
    (None, None) and refuses training."""
    replies, calls_j, calls_t = transports
    _serve_collection(replies, db_clips)
    skel_j, skel_t = skj.load_bvh(synj.TEST_BVH)[0], \
        skt.load_bvh(synj.TEST_BVH)[0]
    frames_j, warps_j = dbj.align_motion_data_in_db(
        "http://db", 3, "custom", skel_j, {"mean_key": 4})
    frames_t, warps_t = dbt.align_motion_data_in_db(
        "http://db", 3, "custom", skel_t, {"mean_key": 4}, device="cpu")
    assert warps_t == {k: list(v) for k, v in warps_j.items()}
    for k in frames_j:
        np.testing.assert_allclose(frames_t[k], frames_j[k], atol=1e-4)
    assert calls_t == calls_j

    replies["download_motion_model"] = synj.make_legacy_model_json(
        seed=3, n_joints=4)
    tree = dbt.create_cluster_tree_for_model_in_db("http://db", 5,
                                                   n_samples=200,
                                                   session=SESSION,
                                                   device="cpu")
    url, up = calls_t[-1]
    assert url == "http://db/upload_cluster_tree"
    assert up["model_id"] == 5 and up["session"] == SESSION
    data = up["cluster_tree_data"]
    assert set(data) == {"data", "options", "root"}
    assert np.asarray(data["data"]).shape == (200, tree.data.shape[1])
    assert data["options"] == {"n_subdivisions_per_level": 4, "n_levels": 4}
    assert set(data["root"]) == {"mean", "indices", "children"}

    replies["get_motion_list"] = []
    assert dbt.align_motion_data_in_db("http://db", 3, "custom", skel_t,
                                       device="cpu") == (None, None)
    with pytest.raises(ValueError, match="no motions"):
        dbt.create_motion_model_in_db("http://db", 3, "custom", skel_t, "w",
                                      device="cpu")
