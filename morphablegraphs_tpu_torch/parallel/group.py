"""Process groups over the visible cards (port of morphablegraphs_tpu.
parallel.crowd's make_mesh, shard_crowd_inputs and replicate_model).

The JAX package builds one mesh over every visible device
(`make_mesh`), shards the per-character inputs along it and replicates
the model, and the entry points take the mesh without any set-up by the
user.  The port runs one process per rank instead: `launch(fn, args,
nproc, device)` runs `fn(ranks, *args)` on every rank of a
torch.distributed group that it starts itself, rank r on its own device
(`rank_device`).  A rank replicates the model by building its own, and
takes its rows of the crowd with `crowd.rank_rows`, the counterpart of
`shard_crowd_inputs`.

- The default number of ranks is `torch.cuda.device_count()` for a CUDA
  device and 1 for the CPU (the entry points ask for one rank unless
  given --nproc).  At one rank nothing is spawned and no group is made:
  `fn` runs in this process.
- Rank 0 is this process; the others are spawned.  They meet through a
  FileStore in a temporary directory, so no port is chosen.
- The data group (the default group) takes the gathers of a crowd or a
  DTW: NCCL when every rank has a card of its own, gloo when ranks share
  a card or run on the CPU.  The command group is gloo with a long
  timeout: rank 0's commands (`RankGroup.send`) go over it, so a rank may
  wait for a command longer than the data group's timeout.  The status
  group is gloo with the data group's timeout: the ranks' statuses inside
  a step (`agree`, `RankGroup.report`) go over it, so a rank that hangs
  in a step fails the step on the others within that timeout.
- A process that is already in a group (started by `torchrun`, or by a
  caller's `init_process_group`) uses that group and `LOCAL_RANK`'s card,
  and spawns nothing.
- `build_kernels`: on a CUDA device rank 0 builds the kernels before the
  others load them, so a build error is reported once.

One process drives one card: the kernels keep per-process state of the
card they first ran on (`csrc/warp_chol.cuh`).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import shutil
import signal
import tempfile
import threading
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ..ops.cuda_build import KernelError

# a worker waits for rank 0's next command for as long as the service is
# idle; gloo holds a timeout in milliseconds, and 20 days stay inside an
# int32 of them
COMMAND_TIMEOUT = datetime.timedelta(days=20)
# how long a rank waits for the others inside a step: a gather of the data
# group, a status exchange of the status group
DATA_TIMEOUT_S = 600.0
# how long the ranks wait for each other to start (imports, the card)
START_TIMEOUT = datetime.timedelta(minutes=10)
# how long rank 0 waits for a spawned rank to leave after the work ends
LEAVE_GRACE_S = 30.0
_MONITOR_POLL_S = 0.2


class RankError(Exception):
    """A rank of the group failed or is gone: a fault of the group, not of
    the request or input it was working on."""


# failures of the device, not of the request
DEVICE_ERRORS = (KernelError, torch.cuda.OutOfMemoryError, RankError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())
# what a request can make a step raise (the service answers them 400 or
# degrades a batch to its sequential path)
REQUEST_ERRORS = (KeyError, ValueError, RuntimeError)


def default_nproc(device=None) -> int:
    """Every visible card for a CUDA device, one rank for the CPU."""
    dev = torch.device(device or "cuda")
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def rank_device(device, rank: int) -> torch.device:
    """Rank r's device: card (index + r) modulo the visible cards for a
    CUDA device (index 0 unless `device` names one), the device itself
    otherwise."""
    dev = torch.device(device or "cuda")
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a CUDA device was asked for and none is "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", ((dev.index or 0) + rank) % count)


def _backend(dev: torch.device, ranks_per_host: int) -> str:
    """NCCL when every rank of the host has a card of its own (NCCL
    refuses two ranks on one card), gloo otherwise."""
    return ("nccl" if dev.type == "cuda"
            and ranks_per_host <= torch.cuda.device_count() else "gloo")


def _describe(error: BaseException):
    if isinstance(error, DEVICE_ERRORS):
        kind = "device"
    elif isinstance(error, REQUEST_ERRORS):
        kind = "request"
    else:
        kind = "other"
    return kind, f"{type(error).__name__}: {error}"


def _exchange(group, obj) -> list:
    """Every rank's obj, in rank order, on every rank."""
    out = [None] * dist.get_world_size(group)
    try:
        dist.all_gather_object(out, obj, group=group)
    except RuntimeError as e:
        raise RankError(f"the process group lost a rank: {e}") from e
    return out


def _raise_failures(statuses: list, error: Optional[BaseException]):
    """statuses[r]: rank r's (kind, message), or None where it succeeded.
    A device or other fault on any rank raises RankError naming every
    failed rank (a RankError of this rank's own, which names them, is
    raised as it is); otherwise this rank's own error is raised, or, on a
    rank that succeeded while another met a request fault, a ValueError
    naming that rank."""
    failed = [(r, s) for r, s in enumerate(statuses) if s is not None]
    if not failed:
        return
    if isinstance(error, RankError):  # it names the ranks already
        raise error
    hard = [f"rank {r}: {msg}" for r, (kind, msg) in failed
            if kind != "request"]
    if hard:
        raise RankError("; ".join(hard)) from error
    if error is not None:
        raise error
    r, (_, msg) = failed[0]
    raise ValueError(f"rank {r}: {msg}")


def agree(group, error: Optional[BaseException]):
    """Every rank's outcome of the same step, exchanged over `group` (the
    status group) before the ranks meet in a collective of the data
    group: a rank that raised would leave the others waiting there.
    Returns when every rank succeeded and raises on every rank otherwise
    (`_raise_failures`)."""
    _raise_failures(_exchange(group, None if error is None
                              else _describe(error)), error)


@dataclasses.dataclass
class RankGroup:
    """This process's place among the ranks of `launch`: its rank, the
    number of ranks, its device, the data group (the crowd's and the
    DTW's gathers; None at one rank), the command group (gloo, long
    timeout), the status group (gloo, the data timeout), once a rank is
    known to be gone, why, and on rank 0 of `launch` a function that
    names the spawned ranks that exited."""
    rank: int
    world: int
    device: torch.device
    data: Optional[object] = None
    commands: Optional[object] = None
    status: Optional[object] = None
    broken: Optional[str] = None
    # which spawned ranks have exited, where this process spawned them
    lost: Optional[Callable[[], str]] = None

    def _collective(self, fn, *args):
        """fn(*args), a collective of the command or the status group;
        one that fails (or times out) marks the group broken, naming the
        ranks that exited where it can."""
        if self.broken is not None:
            raise RankError(self.broken)
        try:
            return fn(*args)
        except (RankError, RuntimeError) as e:
            msg = (str(e) if isinstance(e, RankError)
                   else f"the process group lost a rank: {e}")
            who = self.lost() if self.lost is not None else ""
            self.broken = f"{who} ({msg})" if who else msg
            raise RankError(self.broken) from e

    def send(self, command: dict):
        """Rank 0: the command to every other rank (`receive`)."""
        self._collective(dist.broadcast_object_list, [command], 0,
                         self.commands)

    def receive(self) -> dict:
        """A rank other than 0: rank 0's next command."""
        box = [None]
        self._collective(dist.broadcast_object_list, box, 0, self.commands)
        return box[0]

    def report(self, error: Optional[BaseException], **info) -> List[dict]:
        """After a step every rank took part in: every rank's info dict
        with its outcome under "error" ((kind, message) or None), in rank
        order, over the status group.  Raises as `agree` does when any
        rank failed."""
        status = dict(info, error=None if error is None
                      else _describe(error))
        statuses = self._collective(_exchange, self.status, status)
        _raise_failures([s["error"] for s in statuses], error)
        return statuses


def _in_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                        "MASTER_ADDR", "MASTER_PORT"))


def build_kernels(ranks: RankGroup):
    """For a path that launches kernels on several ranks of a card: rank
    0 builds the kernel library, then the others load it."""
    if ranks.world == 1 or ranks.device.type != "cuda":
        return
    from ..ops import cuda_build
    if ranks.rank == 0:
        cuda_build.load_library()
    dist.barrier(group=ranks.commands)
    if ranks.rank != 0:
        cuda_build.load_library()


def _join(rank: int, world: int, device, store_path: str,
          data_timeout: float) -> RankGroup:
    """Rank `rank` of a spawned group: its card, the data group through
    the FileStore, the command and status groups."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        # utils.device.resolve("cuda") names this rank's card
        os.environ["LOCAL_RANK"] = str(rank)
        torch.cuda.set_device(dev)
    else:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = dist.FileStore(store_path, world)
    # every rank arrives before the data group, whose timeout (a short one
    # too) then bounds its connections only, not a rank's start
    store.set_timeout(START_TIMEOUT)
    store.set(f"arrived/{rank}", "1")
    store.wait([f"arrived/{r}" for r in range(world)])
    timeout = datetime.timedelta(seconds=data_timeout)
    dist.init_process_group(_backend(dev, world), store=store, rank=rank,
                            world_size=world, timeout=timeout)
    return _ranks(rank, world, dev, timeout)


def _ranks(rank: int, world: int, dev: torch.device,
           timeout: datetime.timedelta) -> RankGroup:
    commands = dist.new_group(backend="gloo", timeout=COMMAND_TIMEOUT)
    status = dist.new_group(backend="gloo", timeout=timeout)
    return RankGroup(rank, world, dev, dist.group.WORLD, commands, status)


def _join_existing(device, data_timeout: float) -> RankGroup:
    """This process's rank in the group it is already in, or in the one
    `torchrun` describes in its environment (initialized here)."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        dev = rank_device(dev, int(local) if local is not None
                          else dist.get_rank())
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=data_timeout)
    if not dist.is_initialized():
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                      os.environ["WORLD_SIZE"]))
        dist.init_process_group(_backend(dev, per_host), timeout=timeout)
    return _ranks(dist.get_rank(), dist.get_world_size(), dev, timeout)


def _leave():
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, device, store_path: str,
               data_timeout: float, fn: Callable, args: tuple):
    """A spawned rank: join, run fn, leave.  An interrupt from the
    terminal goes to rank 0, which stops the others."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    ranks = _join(rank, world, device, store_path, data_timeout)
    try:
        fn(ranks, *args)
    finally:
        _leave()


def _exited(procs, wait_s: float) -> str:
    """The spawned ranks that have exited, waiting up to wait_s for a
    rank whose connection closed to be reaped."""
    deadline = time.monotonic() + wait_s
    while True:
        gone = [f"rank {r} exited with code {p.exitcode}"
                for r, p in enumerate(procs, 1) if p.exitcode is not None]
        if gone or time.monotonic() >= deadline:
            return "; ".join(gone)
        time.sleep(_MONITOR_POLL_S)


def _watch(procs, ranks: list, fail_fast: bool, done: threading.Event):
    """Rank 0's watch over the spawned ranks; ranks[0] is rank 0's
    RankGroup once the group is up.  A rank that exits nonzero before
    then, or at any time with fail_fast, ends every rank and this process
    with exit code 1 (rank 0 may be waiting for it, in the rendezvous or
    in a collective that would never end); after it, without fail_fast,
    it marks the group broken."""
    while not done.wait(_MONITOR_POLL_S):
        for rank, p in enumerate(procs, 1):
            if p.exitcode in (None, 0):
                continue
            print(f"rank {rank} (pid {p.pid}) exited with code "
                  f"{p.exitcode}", flush=True)
            if fail_fast or ranks[0] is None:
                for q in procs:
                    if q.is_alive():
                        q.kill()
                os._exit(1)
            ranks[0].broken = ranks[0].broken or (
                f"rank {rank} exited with code {p.exitcode}")
            return


def launch(fn: Callable, args: tuple = (), nproc: Optional[int] = None,
           device=None, data_timeout: float = DATA_TIMEOUT_S,
           fail_fast: bool = True):
    """Run fn(ranks, *args) on every rank (a `RankGroup` each) and return
    this process's fn value.

    nproc ranks (`default_nproc(device)` unless given; more ranks than
    cards share cards over gloo); rank r on `rank_device(device, r)`.
    `data_timeout` (seconds) bounds a collective of the data group and a
    status exchange inside a step.  Without a group and at one rank fn
    runs here with no group.  Otherwise this process is rank 0 and the
    others are spawned; the layout is printed once.  With fail_fast a
    spawned rank that fails ends the command with exit code 1 (training);
    without it the group is marked broken and rank 0 goes on (the
    service answers every later batch 500).  When fn returns on rank 0 it
    leaves the group and the others have `LEAVE_GRACE_S` to leave; a
    spawned rank that exited nonzero raises RankError here."""
    if dist.is_initialized() or _in_torchrun():
        ranks = _join_existing(device, data_timeout)
        if nproc is not None and nproc != ranks.world:
            raise ValueError(f"--nproc {nproc} in a group of {ranks.world}")
        if ranks.rank == 0:
            print(f"{ranks.world} ranks over "
                  f"{dist.get_backend(ranks.data)}: rank 0 on {ranks.device}"
                  " (the group was started outside)", flush=True)
        return fn(ranks, *args)
    world = max(1, default_nproc(device)) if nproc is None else int(nproc)
    if world < 1:
        raise ValueError(f"{world} ranks")
    if world == 1:  # fn resolves the device, and names itself if it fails
        return fn(RankGroup(0, 1, torch.device(device or "cuda")), *args)
    rank_device(device, 0)  # a card to share before anything is spawned
    # a spawned group lives on this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp(prefix="mg-ranks-")
    store = os.path.join(tmp, "store")
    spawn = multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=_rank_main, daemon=True,
                           args=(r, world, device, store, data_timeout, fn,
                                 args)) for r in range(1, world)]
    done = threading.Event()
    ranks, watched = None, [None]
    threads = torch.get_num_threads()  # a CPU rank takes its share
    try:
        for p in procs:
            p.start()
        threading.Thread(target=_watch, args=(procs, watched, fail_fast,
                                              done), daemon=True).start()
        ranks = _join(0, world, device, store, data_timeout)
        backend = dist.get_backend(ranks.data)
        layout = ", ".join(
            f"rank {r} on {rank_device(device, r)} (pid "
            f"{os.getpid() if r == 0 else procs[r - 1].pid})"
            for r in range(world))
        share = (" (ranks share cards)" if ranks.device.type == "cuda"
                 and backend != "nccl" else "")
        print(f"{world} ranks over {backend}{share}: {layout}", flush=True)
        ranks.lost = lambda: _exited(procs, wait_s=2.0)
        watched[0] = ranks
        out = fn(ranks, *args)
    finally:
        done.set()
        # NCCL's ranks leave the group together: rank 0 leaves before it
        # waits for the others (an NCCL group that lost a rank is left as
        # it is: its destruction would wait for that rank)
        if ranks is None or ranks.broken is None or \
                dist.get_backend(ranks.data) != "nccl":
            _leave()
        deadline = time.monotonic() + LEAVE_GRACE_S
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.set_num_threads(threads)
    failed = [f"rank {r} exited with code {p.exitcode}"
              for r, p in enumerate(procs, 1) if p.exitcode != 0]
    if failed:
        raise RankError("; ".join(failed))
    return out
