"""The port's REST service (serve/rest.py, on the standard library) against
the JAX package's tornado service, on the CPU at the toy size.

- Routes that draw nothing go through JAX's tornado app
  (tornado.testing, as tests/test_serve.py drives it) and the port's
  dispatcher: /get_skeleton gives the identical BVH text,
  /set_configuration leaves the identical merged config, the identical
  400 bodies answer bad JSON, a body that is not an object and
  {"requests": 3}, and every /set_height_map form (the image forms
  through PIL) leaves a scene with identical heights on a grid of query
  points.
- `MGContext.run`, on JAX's draws (torch_parity.jax_key_sampler), is
  held against JAX's `MGContext.run` on the same requests: the requests'
  results at the request tests' bounds (torch_parity.
  assert_request_matches), the BVH text's frames parsed back within
  those bounds, `annotation` and `event_list` identical, and the
  "Unity" mode's frames within the same bounds.
- The batch route keeps JAX's partition and flags; a kernel that cannot
  run answers 500 and never a sequential result, a request fault still
  degrades the batch.
- A real HTTPServer on 127.0.0.1 port 0, and `cli serve --device cpu` as
  a subprocess on the toy zip, answer."""

import base64
import copy
import json
import os
import queue
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.serve import rest as rest_j  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.ops import cuda_build  # noqa: E402
from morphablegraphs_tpu_torch.serve import batch as batch_t  # noqa: E402
from morphablegraphs_tpu_torch.serve import rest as rest_t  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import (KEYFRAME_INPUT, WALK_INPUT,  # noqa: E402
                          release_jax_executables)  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# requests to the local servers go past any proxy the environment names
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))
# the request tests' settings (tests/test_torch_motion_generator.py)
WALK_CFG = dict(n_random_samples=30, lm_iterations=5)
KEYFRAME_CFG = dict(n_random_samples=30, lm_iterations=8, debug_max_step=2)


def _config(**kw):
    cfg = default_config()
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def graphs():
    return tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)


def _contexts(graphs, cfg, seed=0):
    """(JAX's MGContext, the port's on the CPU drawing JAX's samples)."""
    g_j, g_t = graphs
    return (rest_j.MGContext(g_j, copy.deepcopy(cfg)),
            rest_t.MGContext(g_t, copy.deepcopy(cfg), device="cpu",
                             sampler=tp.jax_key_sampler(g_j, seed)))


def _jax_fetch(ctx_j, calls):
    """(status, content type, body) of each (method, path, body) call
    through JAX's tornado app."""
    import tornado.testing
    out = []

    class Case(tornado.testing.AsyncHTTPTestCase):
        def get_app(self):
            return rest_j.make_app(ctx_j)

        def runTest(self):
            for method, path, body in calls:
                r = self.fetch(path, method=method, raise_error=False,
                               body=body if method == "POST" else None)
                out.append((r.code, r.headers.get("Content-Type"), r.body))

    case = Case()
    case.setUp()
    try:
        case.runTest()
    finally:
        case.tearDown()
    return out


def _port_fetch(ctx_t, calls):
    app = rest_t.make_app(ctx_t)
    return [app(m, p, b.encode() if isinstance(b, str) else b)
            for m, p, b in calls]


def test_get_skeleton_and_bad_bodies_match_jax(graphs):
    """/get_skeleton by GET and POST: JAX's BVH text; bad JSON, a body
    that is not an object and a batch body without a request list: JAX's
    400 answers, byte for byte, with JAX's content types."""
    ctx_j, ctx_t = _contexts(graphs, _config(**WALK_CFG))
    calls = [("GET", "/get_skeleton", None), ("POST", "/get_skeleton", "")]
    calls += [("POST", path, "not json{")
              for path in ("/run_morphablegraphs", "/generate_motion",
                           "/run_morphablegraphs_batch", "/set_configuration",
                           "/set_height_map")]
    calls += [("POST", "/run_morphablegraphs", "[1, 2]"),
              ("POST", "/generate_motion", "3"),
              ("POST", "/run_morphablegraphs_batch", '{"requests": 3}'),
              ("POST", "/run_morphablegraphs_batch", "3"),
              ("POST", "/run_morphablegraphs_batch", '{"other": []}')]
    got_j, got_t = _jax_fetch(ctx_j, calls), _port_fetch(ctx_t, calls)
    assert got_t == got_j
    assert got_t[0][0] == 200 and b"HIERARCHY" in got_t[0][2]
    assert all(status == 400 for status, _, _ in got_t[2:])


def test_set_configuration_matches_jax(graphs):
    """The merged config is JAX's, the generator sees it, and the cached
    BatchedGenerator is dropped."""
    ctx_j, ctx_t = _contexts(graphs, _config(**WALK_CFG))
    bg = ctx_t.batched_generator()
    assert ctx_t.batched_generator() is bg and bg.device.type == "cpu"
    update = {"n_random_samples": 12, "verbose": True,
              "trajectory_following_settings": {"spline_type": 1}}
    calls = [("POST", "/set_configuration", json.dumps(update))]
    assert _port_fetch(ctx_t, calls) == _jax_fetch(ctx_j, calls)
    assert ctx_t.config == ctx_j.config
    assert ctx_t.config["n_random_samples"] == 12
    assert ctx_t.generator.config is ctx_t.config
    assert ctx_t.batched_generator() is not bg


def _height_forms(tmp_path):
    """Every /set_height_map body: the image file, the raw image bytes
    (grayscale and RGB), the pixel array and the plain height grid; and
    two that install nothing."""
    from PIL import Image
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (9, 13), np.uint8)
    rgb = rng.integers(0, 256, (7, 11, 3), np.uint8)
    path = str(tmp_path / "terrain.png")
    Image.fromarray(gray).save(path)
    grid = rng.uniform(0.0, 20.0, (6, 8)).round(3).tolist()
    return {
        "image_path": {"image_path": path, "width": 80, "depth": 60,
                       "height_scale": 4.0, "scale": [1.5, 1.0]},
        "image_gray": {"image": base64.b64encode(gray.tobytes()).decode(),
                       "size": [13, 9], "mode": "L", "width": 70,
                       "depth": 50, "height_scale": 2.0},
        "image_rgb": {"image": base64.b64encode(rgb.tobytes()).decode(),
                      "size": [11, 7], "mode": "RGB", "width": 70,
                      "depth": 50, "height_scale": 3.0, "scale": [2, 2]},
        "pixels": {"height_map": gray.tolist(), "width": 64, "depth": 64,
                   "height_scale": 2.5},
        "grid": {"height_map": grid, "origin": [-30.0, -20.0],
                 "scale": 7.5, "height_scale": 1.25},
        "missing_file": {"image_path": str(tmp_path / "none.png"),
                         "width": 1, "depth": 1, "height_scale": 1},
        "unknown": {"nonsense": 1},
    }


def test_every_height_map_form_matches_jax(graphs, tmp_path):
    """Each form answers as JAX's and leaves a scene of JAX's heights on a
    grid of query points; a form missing a key answers JAX's 400."""
    ctx_j, ctx_t = _contexts(graphs, _config(**WALK_CFG))
    queries = [(x, z) for x in np.linspace(-70, 70, 29)
               for z in np.linspace(-50, 50, 21)]
    for name, form in _height_forms(tmp_path).items():
        calls = [("POST", "/set_height_map", json.dumps(form))]
        got_t = _port_fetch(ctx_t, calls)
        assert got_t == _jax_fetch(ctx_j, calls), name
        assert json.loads(got_t[0][2])["success"] is (
            name not in ("missing_file", "unknown")), name
        heights_t = [ctx_t.generator.scene_interface.get_height(x, z)
                     for x, z in queries]
        heights_j = [ctx_j.generator.scene_interface.get_height(x, z)
                     for x, z in queries]
        assert heights_t == heights_j, name
        assert max(heights_t) > 0.0, name
    bad = {"height_map": [[1.0]], "width": 5}  # no depth: the plain grid
    calls = [("POST", "/set_height_map", json.dumps(
        {"image": "AA==", "size": [2, 2], "mode": "L"}))]
    got_t = _port_fetch(ctx_t, calls)
    assert got_t == _jax_fetch(ctx_j, calls) and got_t[0][0] == 400
    calls = [("POST", "/set_height_map", json.dumps(bad))]
    assert _port_fetch(ctx_t, calls) == _jax_fetch(ctx_j, calls)


def _recorded(ctx):
    """Record every MotionResult ctx's generator returns."""
    results, generate = [], ctx.generator.generate_motion

    def recording(*a, **kw):
        results.append(generate(*a, **kw))
        return results[-1]
    ctx.generator.generate_motion = recording
    return results


def _bvh_quat_frames(text: str) -> np.ndarray:
    skel, euler = skt.load_bvh(text)
    return skt.bvh_to_quat_frames(skel, euler)


def test_context_run_matches_jax(graphs):
    """MGContext.run in both output modes on JAX's draws, for the
    end-keyframe request (IK in its post-process): the requests' results as the request tests hold them; the BVH text's
    frames parsed back within their frame bound; annotation and
    event_list identical; the Unity frames within the same bound, its
    other fields identical."""
    mg_input = KEYFRAME_INPUT
    ctx_j, ctx_t = _contexts(graphs, _config(**KEYFRAME_CFG))
    res_j, res_t = _recorded(ctx_j), _recorded(ctx_t)
    out_j, out_t = ctx_j.run(mg_input), ctx_t.run(mg_input)
    unity_j = ctx_j.run(mg_input, "Unity")
    unity_t = ctx_t.run(mg_input, "Unity")
    for a, b in zip(res_j, res_t):
        tp.assert_request_matches(a, b)
    assert out_t.keys() == out_j.keys() == {"bvh", "annotation",
                                            "event_list"}
    assert out_t["annotation"] == out_j["annotation"]
    assert out_t["annotation"]["elementaryActionSequence"]
    assert out_t["event_list"] == out_j["event_list"]
    f_j, f_t = _bvh_quat_frames(out_j["bvh"]), _bvh_quat_frames(
        out_t["bvh"])
    assert f_t.shape == f_j.shape == res_j[0].frames.shape
    assert out_t["bvh"].split("MOTION")[0] == out_j["bvh"].split("MOTION")[0]
    np.testing.assert_allclose(f_t[:, :3], f_j[:, :3], rtol=1e-3, atol=1e-2)
    assert tp.rotations_diff(f_t, f_j) < 1e-2
    assert unity_t.keys() == unity_j.keys()
    assert {k: v for k, v in unity_t.items() if k != "frames"} == \
        {k: v for k, v in unity_j.items() if k != "frames"}

    def flat(frames):
        return np.asarray([[r["rootTranslation"][c] for c in "xyz"]
                           + [q[c] for q in r["rotations"] for c in "xyzw"]
                           for r in frames])
    np.testing.assert_allclose(flat(unity_t["frames"]),
                               flat(unity_j["frames"]), rtol=1e-3, atol=1e-2)


TRAJECTORIES = [(20, 100), (-20, 100), (0, 120)]


def _traj_request(end_x, end_z):
    return {"startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
            "elementaryActions": [{"action": "walk", "constraints": [{
                "joint": "Hips", "trajectoryConstraints": [
                    {"position": [0, None, 0]},
                    {"position": [end_x / 2, None, end_z / 2]},
                    {"position": [end_x, None, end_z]}]}]}]}


def _batch_body():
    return {"requests": [_traj_request(x, z) for x, z in TRAJECTORIES]
            + [KEYFRAME_INPUT]}


def test_batch_route_keeps_jax_partition_and_flags(graphs):
    """Three trajectory requests and a keyframe request: JAX's partition;
    the three come back batched, as one crowd walk of the context's
    BatchedGenerator would give them, the keyframe request sequential, as
    the context's run gives it."""
    ctx_j, ctx_t = _contexts(graphs, _config(**KEYFRAME_CFG))
    body = _batch_body()
    batchable_j, fallback_j, _ = ctx_j.batched_generator().split_batchable(
        body["requests"])
    bg = ctx_t.batched_generator()
    bg.n_steps, bg.lm_iters = 3, 1  # the toy size
    status, ctype, payload = rest_t.make_app(ctx_t)(
        "POST", "/run_morphablegraphs_batch", json.dumps(body).encode())
    assert status == 200 and ctype.startswith("text/html")
    results = json.loads(payload)["results"]
    assert [i for i, r in enumerate(results) if r["batched"]] == batchable_j
    assert [i for i, r in enumerate(results) if not r["batched"]] == \
        fallback_j == [3]
    direct = bg.generate_batch(body["requests"][:3])
    for r, frames in zip(results, direct):
        assert r["bvh"] == skt.write_bvh(graphs[1].skeleton, frames)
    _, ctx_ref = _contexts(graphs, _config(**KEYFRAME_CFG))
    assert {**ctx_ref.run(KEYFRAME_INPUT), "batched": False} == results[3]


def _kernel_failure(*a, **kw):
    raise cuda_build.KernelError("score_locomotion_candidates launch: "
                                 "CUDA error 209")


def _oom(*a, **kw):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory")


@pytest.mark.parametrize("failure", [_kernel_failure, _oom])
def test_kernel_failure_answers_500_and_is_not_degraded(graphs, monkeypatch,
                                                        failure):
    """A kernel that cannot run inside generate_batch answers 500 with its
    message: no request comes back sequential ("batched": false) and none
    as a 400; on /run_morphablegraphs it answers 500 too, where a request
    fault answers JAX's 400."""
    _, ctx_t = _contexts(graphs, _config(**WALK_CFG))
    sequential = []
    monkeypatch.setattr(ctx_t, "run", lambda *a, **kw: sequential.append(a))
    monkeypatch.setattr(batch_t.BatchedGenerator, "generate_batch", failure)
    app = rest_t.make_app(ctx_t)
    status, ctype, payload = app("POST", "/run_morphablegraphs_batch",
                                 json.dumps(_batch_body()).encode())
    assert status == 500 and ctype.startswith("application/json")
    assert "batched" not in payload.decode() and not sequential
    assert "CUDA" in json.loads(payload)["error"]
    monkeypatch.undo()
    monkeypatch.setattr(ctx_t.generator, "generate_motion", failure)
    status, _, payload = app("POST", "/run_morphablegraphs",
                             json.dumps(WALK_INPUT).encode())
    assert status == 500 and "CUDA" in json.loads(payload)["error"]

    def request_fault(*a, **kw):
        raise ValueError("unreachable keyframe")
    monkeypatch.setattr(ctx_t.generator, "generate_motion", request_fault)
    assert app("POST", "/run_morphablegraphs",
               json.dumps(WALK_INPUT).encode()) == rest_t._json(
        400, {"error": "unreachable keyframe"})


def test_request_fault_degrades_the_batch(graphs, monkeypatch):
    """A ValueError inside generate_batch (a request fault) sends the whole
    batch down the sequential path, as JAX's handler does; a request that
    fails there answers its own error."""
    _, ctx_t = _contexts(graphs, _config(**WALK_CFG))

    def fault(*a, **kw):
        raise ValueError("bad path")

    def run(mg_input, output_mode="bvh"):
        if mg_input == KEYFRAME_INPUT:
            raise KeyError("joint")
        return {"bvh": "sequential"}
    monkeypatch.setattr(batch_t.BatchedGenerator, "generate_batch", fault)
    monkeypatch.setattr(ctx_t, "run", run)
    status, _, payload = rest_t.make_app(ctx_t)(
        "POST", "/run_morphablegraphs_batch",
        json.dumps(_batch_body()).encode())
    results = json.loads(payload)["results"]
    assert status == 200
    assert results == [{"bvh": "sequential", "batched": False}] * 3 + [
        {"error": "'joint'"}]


def test_unknown_routes_and_methods(graphs):
    _, ctx_t = _contexts(graphs, _config(**WALK_CFG))
    app = rest_t.make_app(ctx_t)
    assert app("GET", "/nothing", b"")[0] == 404
    assert app("GET", "/run_morphablegraphs", b"")[0] == 405
    assert app("GET", "/get_skeleton?x=1", b"")[0] == 200


def test_http_server_on_a_free_port(graphs):
    """make_server on 127.0.0.1 port 0: the bound port answers GET
    /get_skeleton with the dispatcher's text and a bad body with 400."""
    _, ctx_t = _contexts(graphs, _config(**WALK_CFG))
    app = rest_t.make_app(ctx_t)
    server = rest_t.make_server(app, "127.0.0.1", 0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{port}"
        with _LOCAL.open(url + "/get_skeleton", timeout=30) as r:
            assert r.status == 200
            assert r.read() == app("GET", "/get_skeleton", b"")[2]
        req = urllib.request.Request(url + "/run_morphablegraphs",
                                     data=b"not json{", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            _LOCAL.open(req, timeout=30)
        assert e.value.code == 400
        assert json.loads(e.value.read()) == {"error": "invalid JSON"}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_cli_serve_answers_on_the_cpu(graphs, tmp_path):
    """`cli serve GRAPH.zip --port 0 --device cpu` in its own process
    prints JAX's serving line with its bound port and answers
    /get_skeleton with the loaded graph's BVH."""
    from morphablegraphs_tpu_torch.models.zip_writer import write_graph_zip
    gd = synj.make_graph_dict()
    walk = gd["subgraphs"]["walk"]
    zip_path = write_graph_zip(
        str(tmp_path / "graph.zip"), skt.load_bvh(synj.TEST_BVH)[0],
        {"walk": {"nodes": {mp: n["mm"] for mp, n in walk["nodes"].items()},
                  "info": walk["info"]}},
        gd["transitions"], start_node=tuple(gd["startNode"]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "morphablegraphs_tpu_torch.serve.cli",
         "serve", zip_path, "--port", "0", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    try:
        seen = []
        while True:
            line = lines.get(timeout=120)
            seen.append(line)
            if line.startswith("serving morphablegraphs on :"):
                break
            assert proc.poll() is None, "".join(seen)
        port = int(line.rsplit(":", 1)[1])
        with _LOCAL.open(
                f"http://127.0.0.1:{port}/get_skeleton", timeout=60) as r:
            text = r.read().decode()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    skel = skt.load_bvh(text)[0]
    assert skel.node_names == skt.load_bvh(synj.TEST_BVH)[0].node_names
