"""Crowd synthesis over devices (port of morphablegraphs_tpu.parallel):
the crowds split over the ranks of a process group (`crowd`), and the
group itself, started over every visible card (`group.launch`, the
counterpart of `make_mesh`)."""

from .crowd import constrained_crowd_sharded, crowd_walk_sharded, rank_rows
from .group import (RankError, RankGroup, default_nproc, launch,
                    rank_device)

__all__ = ["constrained_crowd_sharded", "crowd_walk_sharded", "rank_rows",
           "RankError", "RankGroup", "default_nproc", "launch",
           "rank_device"]
