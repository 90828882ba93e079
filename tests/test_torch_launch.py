"""The port's entry points over ranks that they start themselves
(parallel/group.py, `cli train --nproc`, `cli serve --nproc`), on the CPU.

- The number of ranks and each rank's device: the CPU takes one rank by
  default, a CUDA device every visible card, rank r card r modulo the
  cards, and `LOCAL_RANK` names a rank's card; one rank spawns nothing.
- The agreement of ranks (`group.agree`) over two spawned gloo ranks: a
  device failure on one rank raises RankError naming it on both, a
  request fault the request's error; a rank that hangs inside a step
  fails the step on the other within the data timeout.
- `cli train --device cpu --nproc 2` as a subprocess on the constructor
  tests' 12 clips writes one model file, whose temporal fields (the
  warps' fPCA) equal `--nproc 1`'s bit for bit and whose arrays are
  within 1e-5 of it (the covariances' eigh factors left out: they follow
  from the covariances); it matches JAX's `cli.train_model` on its 8 virtual
  devices within tests/test_torch_cli.py's bounds.
- `rest.main(zip, 0, device="cpu", nproc=2, data_timeout=3)`: after
  idling past the data group's timeout it answers the batch endpoint as
  one process does (the frames parsed back from each BVH within 1e-5,
  the other fields equal), again after /set_configuration,
  with the sequential fallback inside the batch; a stop ends every rank.
  A second server, `cli serve --device cpu --nproc 2 --port 0`, whose
  rank 1 is killed answers the next batch 500
  naming rank 1, still answers a sequential request as one process
  does, and stops.

The servers and the trainer run `python -m
morphablegraphs_tpu_torch.serve.cli`, which imports torch and the port
only; the spawned ranks of the agreement test import this module, whose
top level imports torch and the port only (JAX is imported inside the
tests).  Every subprocess has a timeout of its own."""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from morphablegraphs_tpu_torch import parallel  # noqa: E402
from morphablegraphs_tpu_torch.ops.cuda_build import KernelError  # noqa: E402
from morphablegraphs_tpu_torch.parallel import group  # noqa: E402
from morphablegraphs_tpu_torch.utils import device as device_mod  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "morphablegraphs_tpu_torch.serve.cli"]
_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))
PROC_TIMEOUT = 300  # a subprocess's start, or its whole run
DATA_TIMEOUT = 3  # seconds: the served data group's, shortened
# a hung rank's sleep: past a data timeout of 1 s and the 2 s in which
# rank 0 looks for a rank that exited (RankGroup.lost)
HANG_S = 5.0
MODEL_ATOL = 1e-5  # --nproc 2's model arrays against --nproc 1's
FRAMES_ATOL = 1e-5  # a batch's frames over two ranks against one process's
# the request tests' settings (tests/test_torch_rest.py): the sequential
# keyframe request stays short
KEYFRAME_CFG = dict(n_random_samples=30, lm_iterations=8, debug_max_step=2)
TRAJECTORIES = [(20, 100), (-20, 100), (0, 120)]  # padded to 2 a rank


def test_ranks_and_devices(monkeypatch):
    """One rank on the CPU, every visible card for CUDA; rank r on card
    (index + r) modulo the cards; LOCAL_RANK names a process's card;
    NCCL only where each rank has a card of its own."""
    assert parallel.default_nproc("cpu") == 1
    assert parallel.rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert parallel.default_nproc("cuda") == parallel.default_nproc() == 4
    assert parallel.rank_device("cuda", 5) == torch.device("cuda", 1)
    assert parallel.rank_device("cuda:2", 3) == torch.device("cuda", 1)
    assert group._backend(torch.device("cuda", 0), 4) == "nccl"
    assert group._backend(torch.device("cuda", 0), 5) == "gloo"
    assert group._backend(torch.device("cpu"), 2) == "gloo"
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert device_mod.resolve(None) == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "6")
    assert device_mod.resolve("cuda") == torch.device("cuda", 2)
    assert device_mod.resolve(None) == torch.device("cuda", 2)
    assert device_mod.resolve("cuda:3") == torch.device("cuda", 3)
    assert device_mod.resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no|none"):
        parallel.rank_device("cuda", 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve("cuda")


def _where(ranks, tag):
    return (tag, ranks.rank, ranks.world, ranks.device, os.getpid(),
            dist.is_initialized())


def test_one_rank_spawns_nothing():
    """At one rank (the CPU's default, or --nproc 1) fn runs in this
    process with no process group."""
    for kw in (dict(device="cpu"), dict(device="cpu", nproc=1)):
        assert parallel.launch(_where, ("x",), **kw) == (
            "x", 0, 1, torch.device("cpu"), os.getpid(), False)


def test_failure_statuses():
    """group._raise_failures on every rank's statuses: all well returns;
    a device fault anywhere raises RankError naming the rank; request
    faults raise this rank's own error, or a ValueError naming the rank
    that met one."""
    ok = [None, None]
    group._raise_failures(ok, None)
    dev = [None, ("device", "KernelError: CUDA error 209")]
    with pytest.raises(group.RankError, match="rank 1: KernelError"):
        group._raise_failures(dev, None)
    own = ValueError("bad path")
    req = [("request", "ValueError: bad path"), None]
    with pytest.raises(ValueError, match="bad path") as e:
        group._raise_failures(req, own)
    assert e.value is own
    with pytest.raises(ValueError, match="rank 0: ValueError: bad path"):
        group._raise_failures(req, None)
    mixed = [("request", "KeyError: 'joint'"), ("other", "TypeError: x")]
    with pytest.raises(group.RankError, match="rank 1: TypeError"):
        group._raise_failures(mixed, KeyError("joint"))
    gone = group.RankError("rank 1 exited with code -9")
    with pytest.raises(group.RankError) as e:
        group._raise_failures([("device", str(gone)), None], gone)
    assert e.value is gone


def _agree_rank(ranks):
    """Three steps: all well, a kernel failure on rank 1, a request fault
    on rank 1 -> what each step raised on this rank."""
    out = []
    for fail in (None, KernelError("CUDA error 209"), ValueError("bad")):
        try:
            group.agree(ranks.status, fail if ranks.rank == 1 else None)
            out.append("ok")
        except (group.RankError, ValueError) as e:
            out.append(f"{type(e).__name__}: {e}")
    if ranks.rank == 1:
        assert out[1].startswith("RankError: rank 1: KernelError"), out
    return out


def test_agreement_over_two_ranks():
    """Two spawned gloo ranks agree on each step's outcome: a kernel
    failure on rank 1 raises RankError naming it on rank 0 too, and a
    request fault reaches rank 0 as a ValueError naming rank 1."""
    out = parallel.launch(_agree_rank, nproc=2, device="cpu")
    assert out == ["ok", "RankError: rank 1: KernelError: CUDA error 209",
                   "ValueError: rank 1: ValueError: bad"]


def _hang_rank(ranks):
    """Rank 1 hangs past the data timeout before it reports a step ->
    what the report raised on this rank, and after how long."""
    if ranks.rank == 1:
        time.sleep(HANG_S)
    t0 = time.monotonic()
    try:
        ranks.report(None)
        return "ok", 0.0
    except group.RankError as e:
        return f"RankError: {e}", time.monotonic() - t0


def test_a_hung_rank_fails_the_step_within_the_data_timeout():
    """A rank that hangs inside a step (alive, not exited) fails the
    status exchange on rank 0 within the data timeout, not the command
    group's (and the 2 s it looks for a rank that exited), and marks the
    group broken."""
    out, waited = parallel.launch(_hang_rank, nproc=2, device="cpu",
                                  data_timeout=1.0, fail_fast=False)
    assert out.startswith("RankError: "), out
    assert waited < HANG_S - 1.0, waited


# ---------------------------------------------------------------------------
# cli train


def _model_arrays(model: dict, prefix=""):
    """{dotted key: float array} of a model JSON's numeric leaves."""
    out = {}
    for k, v in model.items():
        if isinstance(v, dict):
            out.update(_model_arrays(v, f"{prefix}{k}."))
        else:
            try:
                out[prefix + k] = np.asarray(v, np.float64)
            except (TypeError, ValueError):
                pass
    return out


def test_cli_train_over_two_ranks(tmp_path, capsys):
    """`cli train --device cpu --nproc 2` splits the DTW's pair grids over
    two gloo ranks; rank 0 alone writes the model (and its sample BVH)
    and prints its path once.  Its temporal fields equal --nproc 1's bit
    for bit, every array within MODEL_ATOL; the spatial, temporal and
    knot arrays match JAX's 8-device train_model as
    tests/test_torch_cli.py holds them (1e-4 relative), the mixture by
    its K, weights and means (1e-3)."""
    from test_torch_cli import _gmm, _write_clips

    import torch_parity as tp
    from morphablegraphs_tpu.serve import cli as clij
    from morphablegraphs_tpu_torch.serve import cli as clit
    clips = str(tmp_path / "clips")
    _write_clips(clips, 12, seed=0)
    out2 = tmp_path / "two"
    out2.mkdir()
    proc = subprocess.Popen(
        CLI + ["train", clips, "walk_leftStance", "--output",
               str(out2 / "walk_mm.json"), "--device", "cpu", "--nproc", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # one process and JAX meanwhile
        out1 = str(tmp_path / "one_mm.json")
        clit.main(["train", clips, "walk_leftStance", "--output", out1,
                   "--device", "cpu", "--nproc", "1"])
        assert capsys.readouterr().out.splitlines() == [out1]
        out_j = clij.train_model(clips, "walk_leftStance",
                                 str(tmp_path / "j_mm.json"))
        stdout, stderr = proc.communicate(timeout=PROC_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=PROC_TIMEOUT)
    assert proc.returncode == 0, stdout + stderr
    lines = stdout.splitlines()
    assert re.match(r"2 ranks over gloo: rank 0 on cpu \(pid \d+\), rank 1 "
                    r"on cpu \(pid \d+\)$", lines[0]), lines
    assert lines[1:] == [str(out2 / "walk_mm.json")]
    assert sorted(os.listdir(out2)) == ["walk_mm.json", "walk_sample.bvh"]
    m2 = json.load(open(out2 / "walk_mm.json"))
    m1 = json.load(open(out1))
    a1, a2 = _model_arrays(m1), _model_arrays(m2)
    assert a1.keys() == a2.keys() and "tspm.eigen" in a1
    # gmm.eigen, the covariances' eigh factors, follows from gmm.covars
    # (held) and may turn inside a near-degenerate eigenspace
    for k in sorted(set(a1) - {"gmm.eigen"}):
        if k.startswith("tspm."):  # the warps' fPCA
            np.testing.assert_array_equal(a2[k], a1[k], err_msg=k)
        np.testing.assert_allclose(a2[k], a1[k], rtol=0, atol=MODEL_ATOL,
                                   err_msg=k)
    m_j = json.load(open(out_j))
    tp.assert_model_json_close(m2, m_j, {"gmm"})
    (w2, mu2), (w_j, mu_j) = _gmm(m2), _gmm(m_j)
    assert len(w2) == len(w_j)
    np.testing.assert_allclose(w2, w_j, atol=1e-3)
    np.testing.assert_allclose(mu2, mu_j, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# cli serve


def _traj_request(end_x, end_z):
    return {"startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
            "elementaryActions": [{"action": "walk", "constraints": [{
                "joint": "Hips", "trajectoryConstraints": [
                    {"position": [0, None, 0]},
                    {"position": [end_x / 2, None, end_z / 2]},
                    {"position": [end_x, None, end_z]}]}]}]}


class _Server:
    """`cli serve ZIP --port 0 --device D --nproc N` in its own process,
    or with a data timeout `rest.main` with it (the command line keeps
    the default)."""

    def __init__(self, zip_path: str, nproc: int = 2, device: str = "cpu",
                 data_timeout=None):
        cmd = CLI + ["serve", zip_path, "--port", "0", "--device", device,
                     "--nproc", str(nproc)]
        if data_timeout is not None:
            cmd = [sys.executable, "-c",
                   "import sys; from morphablegraphs_tpu_torch.serve import "
                   "rest; rest.main(sys.argv[1], 0, device=sys.argv[2], "
                   "nproc=int(sys.argv[3]), data_timeout=float(sys.argv[4]))",
                   zip_path, device, str(nproc), str(data_timeout)]
        self.nproc = nproc
        self.proc = subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.lines = queue.Queue()
        self.seen = []
        threading.Thread(target=lambda: [self.lines.put(x)
                                         for x in self.proc.stdout],
                         daemon=True).start()
        self.port, self.pids, self.t_up = None, [], None

    def _next(self):
        line = self.lines.get(timeout=PROC_TIMEOUT)
        self.seen.append(line)
        return line

    def wait_up(self):
        while self.port is None:
            line = self._next()
            if " ranks over " in line:
                self.pids = [int(p) for p in re.findall(r"pid (\d+)", line)]
            if line.startswith("serving morphablegraphs on :"):
                self.port = int(line.rsplit(":", 1)[1])
                self.t_up = time.monotonic()
            assert self.proc.poll() is None, "".join(self.seen)
        if self.nproc == 1:  # one rank spawns nothing and prints no layout
            assert not self.pids, "".join(self.seen)
            self.pids = [self.proc.pid]
        assert len(self.pids) == self.nproc and \
            self.pids[0] == self.proc.pid, "".join(self.seen)

    def call(self, path: str, body) -> tuple:
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}{path}",
            data=json.dumps(body).encode(), method="POST")
        try:
            with _LOCAL.open(req, timeout=PROC_TIMEOUT) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def stop(self) -> int:
        """SIGTERM to rank 0; -> its exit code, once every rank is gone."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=PROC_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise
        deadline = time.monotonic() + PROC_TIMEOUT
        while any(_alive(p) for p in self.pids) and \
                time.monotonic() < deadline:
            time.sleep(0.1)
        assert not any(_alive(p) for p in self.pids), self.pids
        return rc


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _graph_zip(path: str, gd: dict, bvh: str) -> str:
    """A graph dict's walk subgraph and its skeleton (a BVH) as a graph
    zip -> its path."""
    from morphablegraphs_tpu_torch.models import skeleton as skt
    from morphablegraphs_tpu_torch.models.zip_writer import write_graph_zip
    walk = gd["subgraphs"]["walk"]
    return write_graph_zip(
        path, skt.load_bvh(bvh)[0],
        {"walk": {"nodes": {mp: n["mm"] for mp, n in walk["nodes"].items()},
                  "info": walk["info"]}},
        gd["transitions"], start_node=tuple(gd["startNode"]))


@pytest.fixture(scope="module", autouse=True)
def served(tmp_path_factory):
    """Two two-rank servers on the toy zip, started with the module (they
    come up while the tests above the serving ones run), each with a
    one-process twin (make_app over an MGContext on the same zip) that
    takes the same calls, and those calls."""
    from morphablegraphs_tpu.utils import synthetic as synj
    from morphablegraphs_tpu_torch.models.graph import load_graph
    from morphablegraphs_tpu_torch.serve import rest

    from torch_parity import KEYFRAME_INPUT, WALK_INPUT
    zip_path = _graph_zip(str(tmp_path_factory.mktemp("serve") / "graph.zip"),
                          synj.make_graph_dict(), synj.TEST_BVH)
    servers = [_Server(zip_path, data_timeout=DATA_TIMEOUT),
               _Server(zip_path)]
    try:
        twins = [rest.make_app(rest.MGContext(
            load_graph(zip_path, device="cpu"), device="cpu"))
            for _ in servers]
        trajectories = {"requests": [_traj_request(x, z)
                                     for x, z in TRAJECTORIES]}
        with_keyframe = {"requests": trajectories["requests"]
                         + [KEYFRAME_INPUT]}
        # the first server's calls, then the second's
        calls = ([("/run_morphablegraphs_batch", trajectories),
                  ("/set_configuration", KEYFRAME_CFG),
                  ("/run_morphablegraphs_batch", with_keyframe)],
                 [("/set_configuration", KEYFRAME_CFG),
                  ("/run_morphablegraphs_batch", trajectories),
                  ("/run_morphablegraphs", WALK_INPUT)])
        yield servers, twins, calls
    finally:
        for s in servers:
            if s.proc.poll() is None:
                s.proc.kill()
                s.proc.wait(timeout=PROC_TIMEOUT)
            for pid in s.pids[1:]:
                if _alive(pid):
                    os.kill(pid, signal.SIGKILL)


def _both(server, twin, path, body):
    """The call to the server (on a thread) and to its one-process twin
    (meanwhile, here) -> (the server's, the twin's (status, body))."""
    box = {}
    t = threading.Thread(target=lambda: box.update(got=server.call(path,
                                                                   body)))
    t.start()
    want = twin("POST", path, json.dumps(body).encode())[::2]
    t.join(timeout=PROC_TIMEOUT)
    assert not t.is_alive()
    return box["got"], want


def _bvh_frames(text: str) -> np.ndarray:
    from morphablegraphs_tpu_torch.models import skeleton as skt
    skel, euler = skt.load_bvh(text)
    return skt.bvh_to_quat_frames(skel, euler)


def _assert_same_answer(got, want):
    """An endpoint's (status, body) against one process's: the same
    status and fields, every BVH's frames (parsed back) within FRAMES_ATOL
    with the same frame count.  A rank walks fewer characters than one
    process, and a batched op may round its last bit otherwise."""
    assert got[0] == want[0], got[1][:300]
    g, w = json.loads(got[1]), json.loads(want[1])
    pairs = list(zip(g["results"], w["results"])) if "results" in w \
        else [(g, w)]
    assert "results" not in w or len(g["results"]) == len(w["results"])
    for a, b in pairs:
        assert a.keys() == b.keys()
        assert all(a[k] == b[k] for k in a if k != "bvh"), (a.keys(), b)
        if "bvh" in b:
            fa, fb = _bvh_frames(a["bvh"]), _bvh_frames(b["bvh"])
            assert fa.shape == fb.shape and len(fa) > 30
            np.testing.assert_allclose(fa, fb, rtol=0, atol=FRAMES_ATOL)


def test_idle_ranks_outlast_the_data_timeout_then_answer_a_batch(served):
    """The first server idles past its data group's timeout (the ranks
    wait on the command group), then answers the trajectory batch as one
    process does, and prints each rank's seconds and launches."""
    servers, twins, calls = served
    s = servers[0]
    s.wait_up()
    time.sleep(max(0.0, DATA_TIMEOUT + 1.0 - (time.monotonic() - s.t_up)))
    got, want = _both(s, twins[0], *calls[0][0])
    _assert_same_answer(got, want)
    assert [r["batched"] for r in json.loads(got[1])["results"]] == \
        [True] * len(TRAJECTORIES)
    while not s.seen[-1].startswith("batch of "):
        s._next()
    assert re.match(rf"batch of {len(TRAJECTORIES)} over 2 ranks: seconds "
                    r"\[[0-9.]+, [0-9.]+\], launches \[\{\}, \{\}\]$",
                    s.seen[-1]), s.seen[-1]


def test_batch_after_set_configuration_matches_one_process(served):
    """/set_configuration reaches both ranks; the batch with the keyframe
    request (the sequential fallback, on rank 0) answers as one process
    does; a stop ends both ranks with exit code 0."""
    servers, twins, calls = served
    s = servers[0]
    s.wait_up()
    for call in calls[0][1:]:
        got, want = _both(s, twins[0], *call)
        _assert_same_answer(got, want)
    flags = [r["batched"] for r in json.loads(got[1])["results"]]
    assert flags == [True] * len(TRAJECTORIES) + [False]
    assert s.stop() == 0, "".join(s.seen)


def test_lost_rank_answers_500_and_sequential_route_serves(served):
    """The second server's rank 1 is killed: every later batch answers
    500 naming rank 1 (never a sequential or a one-rank answer), a
    sequential request still answers as one process does, and a stop
    ends rank 0 with a nonzero code that names the lost rank."""
    servers, twins, calls = served
    s = servers[1]
    s.wait_up()
    # /set_configuration reaches rank 1
    _assert_same_answer(*_both(s, twins[1], *calls[1][0]))
    os.kill(s.pids[1], signal.SIGKILL)
    for _ in range(2):
        status, body = s.call(*calls[1][1])
        assert status == 500 and "rank 1" in json.loads(body)["error"], body
        assert "batched" not in body.decode()
    _assert_same_answer(*_both(s, twins[1], *calls[1][2]))
    assert s.stop() != 0
    assert any("rank 1" in x for x in s.seen)
