"""The constrained crowd split over the ranks of a process group, one rank a
card: `parallel.crowd.constrained_crowd_sharded`, one crowd walk after
another.

The driver starts the group itself (`parallel.launch`, NCCL between the
cards, every visible card by default, or the traffic's `ranks`): rank 0 is
the harness's process, on a thread that holds the group open until the
driver closes; ranks 1.. are spawned and follow rank 0's commands
(`RankGroup.send` / `receive`), as the service's ranks do.  Every rank
builds the same crowd from the seed (the configuration's graph, every
character's path, each walk's draws), walks its contiguous rows of it, and
the outputs are gathered to every rank, one `all_gather` per output
(the program's `crowd.gather` span).  The frames counted are all
characters', on rank 0 after the gather.

Judged like the one-card crowd (`drivers.crowd`): in the judged walk each
rank observes its own steps' chosen latents (`constrained_walk.
_emit_step`), and the ranks gather them, so the judged characters, drawn
over the whole crowd, may lie on any rank."""

from __future__ import annotations

import contextlib
import itertools
import queue
import threading

import torch

from . import crowd

# rank 0's part of each group this process started, by key: the spawned
# ranks are handed the key, which names nothing in their processes
_LEADS = {}
_KEYS = itertools.count()


class _Ranks:
    """The group of `parallel.launch`, held open on a thread of rank 0's
    process until `close`."""

    def __init__(self, config, traffic, seed, device):
        from morphablegraphs_tpu_torch.parallel import group as group_mod
        self._handed = queue.Queue()
        self._done = threading.Event()
        nproc = traffic.get("ranks")

        def lead(ranks):
            group_mod.build_kernels(ranks)
            self._handed.put(ranks)
            self._done.wait()
            ranks.send(dict(op="stop"))

        key = f"lead{next(_KEYS)}"
        _LEADS[key] = lead

        def hold():
            try:
                group_mod.launch(_lead_or_follow, (key, config, traffic,
                                                   seed), nproc=nproc,
                                 device=device)
            except BaseException as e:  # noqa: BLE001 - handed to the driver
                self._handed.put(e)
            finally:
                _LEADS.pop(key, None)

        self._thread = threading.Thread(target=hold, daemon=True)
        self._thread.start()
        got = self._handed.get()
        if isinstance(got, BaseException):
            raise got
        self.ranks = got

    def close(self):
        self._done.set()
        self._thread.join()


def _lead_or_follow(ranks, key, config, traffic, seed):
    """Rank 0: its lead (`_LEADS[key]`); any other rank: its rows of each
    walk rank 0 asks for, until it says stop."""
    if ranks.rank == 0:
        return _LEADS[key](ranks)
    torch.set_num_threads(1)  # as run.py's rank 0: the host is shared
    from morphablegraphs_tpu_torch.parallel import group as group_mod
    group_mod.build_kernels(ranks)
    follower = Driver(config, traffic, seed, ranks.device, ranks=ranks)
    while True:
        cmd = ranks.receive()
        if cmd["op"] == "stop":
            return
        follower.walk_rows(cmd["index"], cmd["keep"])


class Driver(crowd.Driver):
    """The one-card crowd's driver over a group of ranks (module doc)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 ranks=None):
        self._group = None
        if ranks is None:  # rank 0 starts the group
            self._group = _Ranks(config, traffic, seed, device)
            ranks = self._group.ranks
        self.ranks = ranks
        super().__init__(config, traffic, seed, ranks.device)

    def walk(self, index: int, keep: bool = False) -> torch.Tensor:
        self.ranks.send(dict(op="walk", index=index, keep=keep))
        return super().walk(index, keep)

    def walk_rows(self, index: int, keep: bool):
        """A following rank's part of walk `index`."""
        self.run_walk(self.draws(index), keep)

    def run_walk(self, draws, observe: bool = False):
        from morphablegraphs_tpu_torch.parallel import crowd as pcrowd
        ranks, seen = self.ranks, []
        with self._emitted(seen) if observe else contextlib.nullcontext():
            segs, n_frames, ids, _ = pcrowd.constrained_crowd_sharded(
                [ranks.device], self.skeleton, self.stacked, self.paths,
                self.start, self.traffic["steps"], draws=lambda t: draws[t],
                cfg=self.cfg, group=ranks.data, status_group=ranks.status)
        latents = None
        if observe:
            # every rank holds its rows' latents of each step, or none
            # where the program no longer makes the observed call
            have = len(seen) == self.traffic["steps"]
            if all(s["have"] for s in ranks.report(None, have=have)):
                mine = torch.stack(seen, 1)
                latents = pcrowd.all_gather_rows(mine, ranks.data)[
                    :self.traffic["characters"]]
        return segs, n_frames, ids, latents

    def close(self):
        if self._group is not None:
            self._group.close()
            self._group = None
