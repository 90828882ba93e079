"""REST service: constrained synthesis over HTTP (port of
morphablegraphs_tpu.serve.rest).

Replaces reference examples/mg_rest_interface.py:98-423 (POST
/run_morphablegraphs, /generate_motion, /get_skeleton, /set_configuration)
and the height-map route of its parallel variant.  The reference's
process-per-core server is replaced by the batch endpoint,
/run_morphablegraphs_batch: batchable locomotion requests become one crowd
walk (`serve/batch.py`), the others go through the sequential
`MotionGenerator`.

The transport is the standard library's `http.server`: one process, one
model, one request at a time, as the JAX package's tornado IOLoop serves
(the generator is not thread-safe).  `make_app(ctx)` is the route table
as a dispatcher, (method, path, body) -> (status, content type, body), so
tests call it without a socket; `make_server` puts it behind an
`HTTPServer`.

A kernel that cannot run (`ops.cuda_build.KernelError`, a CUDA error or
the card out of memory) is not a fault of the request: it is answered 500
and logged, never 400, and a batch that meets one is not re-run on the
sequential path, which does not run the batch's selection kernel.

Over several ranks (`main(..., nproc=)`, `cli serve --nproc N`; one
rank by default) rank 0 binds the HTTP server and the other ranks build
the same graph and context on their own cards and wait for rank 0's
commands (`parallel.group`).  The batch endpoint sends each batch's
requests to every rank, every rank walks its rows of the crowd, and the
ranks exchange their statuses: a rank that failed, hung past the data
timeout or is gone answers 500 and names the rank, and a group that lost
a rank answers every later batch 500.  /set_configuration reaches every
rank; the other routes run on rank 0 alone.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Optional, Tuple

import numpy as np

from ..constraints.input_reader import read_input
from ..models.graph import MotionStateGraph, load_graph
from ..models.skeleton import write_bvh
from ..ops import kernels
from ..parallel import group as group_mod
from ..synthesis.motion_generator import MotionGenerator
from ..utils import device as device_mod
from ..utils.config import _merge, default_config
from ..utils.log import (LOG_MODE_ERROR, configure_from_service_config,
                         write_message_to_log)
from .export import (AnnotatedMotion, collision_vis_data_from_result,
                     events_from_result)

# failures of the device or of a rank, not of the request
DEVICE_ERRORS = group_mod.DEVICE_ERRORS
# faults of the request: answered 400, or a batch degraded to the
# sequential path
REQUEST_ERRORS = group_mod.REQUEST_ERRORS

_TEXT = "text/html; charset=UTF-8"
_JSON = "application/json; charset=UTF-8"

Response = Tuple[int, str, bytes]


class MGContext:
    """Shared state: graph + generator + config (reference
    MGRestApplication), on `device`: the CUDA device unless the caller
    names another.  `sampler` is handed to the MotionGenerator (the
    tests replay the JAX package's draws through it).  `ranks`, this
    process's `parallel.RankGroup`, splits every batch over the group's
    ranks (one rank, or none: this process alone)."""

    def __init__(self, graph: MotionStateGraph, config: Optional[dict] = None,
                 activate_joint_mapping: bool = False,
                 activate_coordinate_transform: bool = False,
                 target_skeleton=None, joint_name_map: Optional[dict] = None,
                 retarget_scale: float = 1.0,
                 create_ca_vis_data: bool = False,
                 add_rotate_events: bool = False, device=None,
                 sampler: Optional[Callable] = None,
                 ranks: Optional[group_mod.RankGroup] = None):
        self.graph = graph
        self.ranks = ranks if ranks is not None and ranks.world > 1 \
            else None
        self.config = config or default_config()
        self.device = device_mod.resolve(device, "MGContext")
        self.generator = MotionGenerator(graph, self.config,
                                         device=self.device, sampler=sampler)
        self.activate_joint_mapping = activate_joint_mapping
        self.activate_coordinate_transform = activate_coordinate_transform
        # reference GraphWalk(create_ca_vis_data) + KeyframeEventList
        # (keyframe_event_list.py:32-39,:47-49,:110-142); rotate events are
        # additionally gated on NOT constrain_place_orientation
        self.create_ca_vis_data = create_ca_vis_data
        self.add_rotate_events = add_rotate_events
        # optional output retargeting (reference mg_rest_interface.py:70-93,
        # :133-136: retarget to a game-engine skeleton before export)
        self.target_skeleton = target_skeleton
        self.joint_name_map = joint_name_map
        self.retarget_scale = retarget_scale
        self._batched_generator = None

    def batched_generator(self):
        """The cached BatchedGenerator on the context's device (the graph
        is stacked and moved to the device once, not per request), over
        the ranks' data group when there are several."""
        if self._batched_generator is None:
            from .batch import BatchedGenerator
            r = self.ranks
            self._batched_generator = BatchedGenerator(
                self.graph, self.config, device=self.device,
                group=r and r.data, status_group=r and r.status)
        return self._batched_generator

    def generate_batch(self, mg_inputs: list,
                       parsed_list: Optional[list] = None) -> list:
        """The batched generator's frames for the requests, on every rank:
        rank 0 sends them to the others first."""
        if self.ranks is None:
            return self.batched_generator().generate_batch(
                mg_inputs, self.activate_coordinate_transform,
                parsed_list=parsed_list)
        cmd = dict(op="batch", requests=mg_inputs, seed=0,
                   coordinate_transform=self.activate_coordinate_transform)
        self.ranks.send(cmd)
        return _rank_batch(self, cmd, parsed_list)

    def configure(self, update: dict):
        """Merge an algorithm config update (on every rank, sent from rank
        0); the cached BatchedGenerator holds the old config and is
        rebuilt on demand."""
        _merge(self.config, update)
        self.generator.config = self.config
        self._batched_generator = None
        if self.ranks is not None and self.ranks.rank == 0:
            self.ranks.send(dict(op="set_configuration", update=update))

    def run(self, mg_input: dict, output_mode: str = "bvh") -> dict:
        result = self.generator.generate_motion(
            mg_input,
            activate_joint_mapping=self.activate_joint_mapping,
            activate_coordinate_transform=self.activate_coordinate_transform)
        out_skeleton = self.graph.skeleton
        out_frames = result.frames
        if self.target_skeleton is not None:
            from ..models.retarget import retarget_frames
            out_frames = retarget_frames(self.graph.skeleton, result.frames,
                                         self.target_skeleton,
                                         self.joint_name_map,
                                         self.retarget_scale,
                                         device=self.device)
            out_skeleton = self.target_skeleton
        parsed = read_input(
            mg_input,
            activate_coordinate_transform=self.activate_coordinate_transform)
        annotations_per_action = [a.annotations for a in parsed.actions]
        add_rotate = (self.add_rotate_events
                      and not self.config["inverse_kinematics_settings"]
                      .get("constrain_place_orientation", False))
        events = events_from_result(
            self.graph, result, annotations_per_action,
            add_rotate_events=add_rotate,
            constraints_per_action=[a.keyframe_constraints
                                    for a in parsed.actions])
        collision = None
        if self.create_ca_vis_data:
            collision = collision_vis_data_from_result(self.graph.skeleton,
                                                       result)
        motion = AnnotatedMotion(out_skeleton, out_frames,
                                 result.action_ranges, events, mg_input,
                                 collision_content=collision)
        if output_mode == "Unity":
            return motion.to_unity_format()
        return {
            "bvh": motion.generate_bvh_string(),
            "annotation": motion.keyframe_events_dict(),
            "event_list": motion.frame_annotation(),
        }


def _json(status: int, obj) -> Response:
    """A dict written as tornado's RequestHandler.write writes it."""
    return status, _JSON, json.dumps(obj).replace("</", "<\\/").encode()


def _text(text: str, status: int = 200) -> Response:
    return status, _TEXT, text.encode()


def generate_motion(ctx: MGContext, body: bytes) -> Response:
    """POST /run_morphablegraphs and /generate_motion (reference
    mg_rest_interface.py:98-163)."""
    try:
        mg_input = json.loads(body)
    except json.JSONDecodeError:
        return _json(400, {"error": "invalid JSON"})
    if not isinstance(mg_input, dict):
        return _json(400, {"error": "expected a JSON object"})
    try:
        output_mode = mg_input.get("outputMode", "bvh")
        return _text(json.dumps(ctx.run(mg_input, output_mode)))
    except DEVICE_ERRORS:
        raise
    except REQUEST_ERRORS as e:
        # RuntimeError covers SynthesisError/PathSearchError from the
        # generator (utils/exceptions.py)
        return _json(400, {"error": str(e)})


def generate_motion_batch(ctx: MGContext, body: bytes) -> Response:
    """POST /run_morphablegraphs_batch: {"requests": [mg_input, ...]} ->
    {"results": [{"bvh": ..., "batched": bool} or {"error": ...}, ...]}.
    The batchable locomotion requests run as one crowd walk; the others,
    and a batch whose requests fail to synthesize, go through the
    sequential path."""
    try:
        requests_list = json.loads(body)["requests"]
    except (json.JSONDecodeError, KeyError, TypeError):
        return _json(400, {"error": "expected {\"requests\": [...]}"})
    if not isinstance(requests_list, list):
        return _json(400, {"error": "expected {\"requests\": [...]}"})
    bg = ctx.batched_generator()
    batchable, fallback, parsed = bg.split_batchable(
        requests_list, ctx.activate_coordinate_transform)
    results = [None] * len(requests_list)
    if batchable:
        try:
            frames_list = ctx.generate_batch(
                [requests_list[i] for i in batchable],
                parsed_list=[parsed[i] for i in batchable])
            for i, frames in zip(batchable, frames_list):
                results[i] = {"bvh": write_bvh(ctx.graph.skeleton, frames),
                              "batched": True}
        except DEVICE_ERRORS:
            raise
        except REQUEST_ERRORS:
            # a request fault degrades the batch to the sequential path
            fallback = sorted(set(fallback) | set(batchable))
    for i in fallback:
        try:
            results[i] = {**ctx.run(requests_list[i]), "batched": False}
        except DEVICE_ERRORS:
            raise
        except REQUEST_ERRORS as e:
            results[i] = {"error": str(e)}
    return _text(json.dumps({"results": results}))


def get_skeleton(ctx: MGContext, body: bytes) -> Response:
    """GET or POST /get_skeleton -> the skeleton's BVH at its rest pose
    (reference :165-180)."""
    skel = ctx.graph.skeleton
    rest = np.zeros((1, skel.n_frame_params), np.float32)
    for j in range(skel.n_animated):
        rest[0, 3 + 4 * j] = 1.0
    return _text(write_bvh(skel, rest))


def set_configuration(ctx: MGContext, body: bytes) -> Response:
    """POST /set_configuration -> merge the algorithm config at run time
    (reference :204-233)."""
    try:
        update = json.loads(body)
    except json.JSONDecodeError:
        return _json(400, {"error": "invalid JSON"})
    ctx.configure(update)
    return _json(200, {"success": True})


def set_height_map(ctx: MGContext, data: dict) -> bool:
    """Install a terrain height map on the generator's scene interface
    (reference mg_rest_interface_parallel.py:154-191 set_height_map):
    either {"image_path", "width", "depth", "height_scale"[, "scale"]} or
    {"image": base64, "size", "mode", ...}; additionally accepts
    {"height_map": [[...]], "width", "depth"} as a pixel array with the
    image semantics, or {"height_map": [[...]]} alone as a plain grid of
    TRUE world heights (origin/scale texel mapping).  The image forms
    need PIL, imported when one arrives."""
    from ..utils.height_map import HeightMapInterface, ImageHeightMap
    scale = data.get("scale", [1.0, 1.0])
    if "image_path" in data:
        if not os.path.isfile(data["image_path"]):
            return False
        from PIL import Image
        with open(data["image_path"], "rb") as f:
            pixels = np.asarray(Image.open(f))
        hm = ImageHeightMap(pixels, data["width"], data["depth"], scale,
                            data["height_scale"])
    elif "image" in data:
        import base64
        from PIL import Image
        raw = base64.b64decode(data["image"])
        img = Image.frombytes(data["mode"], tuple(data["size"]), raw)
        hm = ImageHeightMap(np.asarray(img), data["width"], data["depth"],
                            scale, data["height_scale"])
    elif "height_map" in data and "width" in data and "depth" in data:
        # pixel-array form with the image semantics (values/255*height_scale
        # over a width x depth extent)
        hm = ImageHeightMap(np.asarray(data["height_map"], np.float64),
                            data["width"], data["depth"], scale,
                            data.get("height_scale", 1.0))
    elif "height_map" in data:
        # plain height grid: values are world heights (origin/scale texel
        # mapping, no /255 pixel semantics)
        hm = HeightMapInterface(
            np.asarray(data["height_map"], np.float64),
            origin=tuple(data.get("origin", (0.0, 0.0))),
            scale=float(scale[0]) if hasattr(scale, "__len__") else float(scale),
            height_scale=float(data.get("height_scale", 1.0)))
    else:
        return False
    ctx.generator.scene_interface.set_scene(hm)
    return True


def set_height_map_route(ctx: MGContext, body: bytes) -> Response:
    """POST /set_height_map (reference mg_rest_interface_parallel.py
    :193-214)."""
    try:
        data = json.loads(body)
    except json.JSONDecodeError:
        return _json(400, {"error": "invalid JSON"})
    try:
        ok = set_height_map(ctx, data)
    except (KeyError, ValueError, OSError) as e:
        return _json(400, {"error": str(e)})
    return _text(json.dumps({"success": bool(ok)}))


# path -> (methods, handler) (the JAX package's make_app table)
ROUTES = {
    "/run_morphablegraphs": (("POST",), generate_motion),
    "/run_morphablegraphs_batch": (("POST",), generate_motion_batch),
    "/generate_motion": (("POST",), generate_motion),
    "/get_skeleton": (("GET", "POST"), get_skeleton),
    "/set_configuration": (("POST",), set_configuration),
    "/set_height_map": (("POST",), set_height_map_route),
}


def make_app(ctx: MGContext) -> Callable[[str, str, bytes], Response]:
    """The service's routes as a dispatcher (method, path, body) ->
    (status, content type, body bytes).  An unknown path answers 404, a
    method the route does not take 405; an exception a handler does not
    answer itself (a kernel that cannot run among them) answers 500 with
    its message and is logged with its traceback."""

    def app(method: str, path: str, body: bytes) -> Response:
        route = ROUTES.get(path.split("?", 1)[0])
        if route is None:
            return _json(404, {"error": f"no route {path}"})
        methods, handler = route
        if method not in methods:
            return _json(405, {"error": f"{method} not allowed on {path}"})
        try:
            return handler(ctx, body)
        except Exception as e:  # the service keeps serving
            write_message_to_log(f"{method} {path} failed:\n"
                                 f"{traceback.format_exc()}", LOG_MODE_ERROR)
            return _json(500, {"error": f"{type(e).__name__}: {e}"})
    return app


def make_server(app: Callable[[str, str, bytes], Response], host: str = "",
                port: int = 8889) -> HTTPServer:
    """An HTTPServer that answers one request at a time through `app`;
    port 0 binds a free port (read it back from server_address[1])."""

    class Handler(BaseHTTPRequestHandler):
        def _serve(self):
            n = int(self.headers.get("Content-Length") or 0)
            status, ctype, payload = app(self.command, self.path,
                                         self.rfile.read(n))
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = do_PUT = do_DELETE = _serve

        def log_message(self, fmt, *args):
            write_message_to_log(f"{self.address_string()} {fmt % args}")

    return HTTPServer((host, port), Handler)


def load_service_config(path: str) -> dict:
    """Service config schema of the reference's examples/config/service.config
    (port, model path, algorithm preset, joint-map / coordinate flags)."""
    with open(path) as f:
        return json.load(f)


def _rank_batch(ctx: MGContext, cmd: dict,
                parsed_list: Optional[list] = None) -> list:
    """One batch command on this rank: its rows of the crowd, then every
    rank's status, seconds and launches (`RankGroup.report`, which raises
    on every rank when one failed); rank 0 prints them."""
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    frames, error = None, None
    try:
        frames = ctx.batched_generator().generate_batch(
            cmd["requests"], cmd["coordinate_transform"], seed=cmd["seed"],
            parsed_list=parsed_list)
    except Exception as e:  # every rank reports, then raises
        error = e
    after = kernels.launch_counts()
    statuses = ctx.ranks.report(
        error, seconds=round(time.perf_counter() - t0, 4),
        launches={k: n - before[k] for k, n in after.items()
                  if n != before[k]})
    if ctx.ranks.rank == 0:
        line = (f"batch of {len(cmd['requests'])} over {ctx.ranks.world} "
                f"ranks: seconds {[s['seconds'] for s in statuses]}, "
                f"launches {json.dumps([s['launches'] for s in statuses])}")
        write_message_to_log(line)
        print(line, flush=True)
    return frames


def _work(ctx: MGContext):
    """A rank other than 0: rank 0's commands until it says stop (or is
    gone).  A failed batch is rank 0's to answer."""
    while True:
        cmd = ctx.ranks.receive()
        if cmd["op"] == "stop":
            return
        if cmd["op"] == "set_configuration":
            ctx.configure(cmd["update"])
        elif cmd["op"] == "batch":
            try:
                _rank_batch(ctx, cmd)
            except group_mod.RankError:
                if ctx.ranks.broken is not None:
                    raise
            except Exception:  # reported to rank 0, which answers it
                write_message_to_log(f"rank {ctx.ranks.rank}: batch failed:"
                                     f"\n{traceback.format_exc()}",
                                     LOG_MODE_ERROR)


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(graph_path: Optional[str] = None, port: int = 8889,
         config: Optional[dict] = None, service_config: Optional[str] = None,
         device=None, nproc: int = 1,
         data_timeout: float = group_mod.DATA_TIMEOUT_S):
    """reference mg_rest_interface.py:381-423 main: load the graph zip on
    `device` (the CUDA device unless named) and serve until interrupted.
    `nproc` ranks (`parallel.launch`): rank 0 serves HTTP, the others
    walk their rows of each batch; `data_timeout` (seconds) bounds a
    gather or a status exchange inside a batch."""
    group_mod.launch(_serve_rank, (graph_path, port, config, service_config),
                     nproc=nproc, device=device, data_timeout=data_timeout,
                     fail_fast=False)


def _serve_rank(ranks: group_mod.RankGroup, graph_path: Optional[str],
                port: int, config: Optional[dict],
                service_config: Optional[str]):
    """main on one rank."""
    group_mod.build_kernels(ranks)
    joint_map = False
    coord_transform = False
    target_skeleton = None
    retarget_scale = 1.0
    if service_config is not None:
        svc = load_service_config(service_config)
        # write_log / log_file / log_level (reference service.config keys)
        configure_from_service_config(svc)
        graph_path = graph_path or svc.get("model_data")
        port = svc.get("port", port)
        joint_map = svc.get("activate_joint_map", False)
        coord_transform = svc.get("activate_coordinate_transform", False)
        # output retargeting to a game-engine rig (reference main
        # target_skeleton_file + scale, mg_rest_interface.py:385-401)
        target_path = svc.get("target_skeleton")
        retarget_scale = float(svc.get("retarget_scale", 1.0))
        if target_path:
            from ..models.retarget import load_target_skeleton
            target_skeleton = load_target_skeleton(target_path, retarget_scale)
        preset = svc.get("algorithm_settings")
        if preset and config is None:
            from ..utils.config import load_config
            preset_path = os.path.join(os.path.dirname(service_config),
                                       f"{preset}_algorithm.config")
            if os.path.exists(preset_path):
                config = load_config(preset_path)
    dev = device_mod.resolve(ranks.device, "the REST service")
    graph = load_graph(graph_path, device=dev)
    ctx = MGContext(graph, config, activate_joint_mapping=joint_map,
                    activate_coordinate_transform=coord_transform,
                    target_skeleton=target_skeleton,
                    retarget_scale=retarget_scale, device=dev, ranks=ranks)
    if ranks.rank != 0:
        _work(ctx)
        return
    server = make_server(make_app(ctx), "", port)
    bound = server.server_address[1]
    write_message_to_log(f"serving morphablegraphs on :{bound}")
    print(f"serving morphablegraphs on :{bound}", flush=True)
    if ctx.ranks is None:
        try:
            server.serve_forever()
        finally:
            server.server_close()
        return
    if threading.current_thread() is threading.main_thread():
        # a stop sent to rank 0 stops every rank
        signal.signal(signal.SIGTERM, _interrupt)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        try:
            ctx.ranks.send(dict(op="stop"))
        except group_mod.RankError as e:
            write_message_to_log(f"stopping the ranks: {e}", LOG_MODE_ERROR)


if __name__ == "__main__":
    import sys
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 8889)
