"""A stage of the walk replayed as one CUDA graph (`torch.cuda.CUDAGraph`),
so that the host issues one graph launch where the stage's eager form
issues thousands of small kernel launches.

`StageGraphs(name, capacity).run(fn, inputs, key, reads)` runs
`fn(*inputs)`, where inputs is a tuple of tensors and dataclasses of
tensors (nested dataclasses too) and fn returns a tuple of tensors.  A key
of None, or inputs off a CUDA device, run fn eagerly.  Else the stage is
keyed on `stage_key`: the caller's key (the settings fn closes over), the
layout of the inputs (each tensor's shape, strides, dtype and device, every
other leaf's value) and the placement of `reads`, every device tensor fn
reads besides its inputs (model tables; each one's address, shape, strides
and dtype).  A key runs eagerly the first time it is seen, which loads what
the stage's kernels need, is captured the second time and replayed from
then on.  Before each replay the inputs are copied into the graph's own
buffers (a tensor that is a broadcast, a stride of 0, stays one there and
is copied once); the outputs are handed out as clones, as the graph's own
outputs are overwritten by its next replay.  The newest `capacity` keys
are kept.

fn must not synchronise with the host, and must read no device tensor
besides its inputs and `reads` whose place can change (constants made once
per device, `ops.consts`, stay put).  Replays run on the caller's current
stream, one caller at a time.

Counters (`utils.profiling`): `<name>.eager`, `<name>.graph_captures`,
`<name>.graph_replays`, one per run.  A capture launches no kernel, so the
kernel wrappers' launch counts made while capturing are taken back, and
each replay adds them again: `kernel.launches.<kernel>` keeps saying how
often each kernel ran."""

from __future__ import annotations

import collections
import dataclasses

import torch

from ..utils import profiling
from . import kernels


def _flatten(tree, leaves: list):
    """The tensors of `tree` appended to `leaves` in a fixed order -> the
    tree's layout, hashable."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (tuple(tree.shape), tree.stride(), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree):
        return (type(tree),) + tuple(_flatten(getattr(tree, f.name), leaves)
                                     for f in dataclasses.fields(tree))
    if isinstance(tree, tuple):
        return (tuple,) + tuple(_flatten(v, leaves) for v in tree)
    return tree


def stage_key(key, layout, reads=()):
    """(key, the inputs' layout (`_flatten`), the placement of reads): what
    a graph of the stage is captured for."""
    return (key, layout,
            tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                  for t in reads))


def _rebuild(tree, tensors):
    """`tree` with its tensors replaced, in `_flatten`'s order, by the next
    ones of the iterator `tensors`."""
    if isinstance(tree, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), tensors)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return tuple(_rebuild(v, tensors) for v in tree)
    return tree


def _buffer(t: torch.Tensor):
    """(a tensor of t's shape, strides and dtype, the part of it that a copy
    fills, the index of that part in t or None for the whole): dims along
    which t is a broadcast stay one."""
    zero = [st == 0 for st in t.stride()]
    base = torch.empty_strided([1 if z else n for z, n in zip(zero, t.shape)],
                               t.stride(), dtype=t.dtype, device=t.device)
    index = (tuple(slice(0, 1) if z else slice(None) for z in zero)
             if any(zero) else None)
    return base.expand(t.shape), base, index


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    device: torch.device
    buffers: list  # (base, index) of each input tensor
    outputs: tuple
    launched: dict  # kernel -> launches of one run


class StageGraphs:
    """The captured graphs of one stage (counters under `name`), of its
    newest `capacity` keys: a service that sees many crowd sizes keeps a
    bounded set."""

    def __init__(self, name: str, capacity: int = 8):
        self.name, self.capacity = name, capacity
        self._entries = collections.OrderedDict()  # key -> None or _Graph
        self._streams = {}  # device -> its capture stream

    def clear(self):
        """Forget every key and free its graph."""
        self._entries.clear()

    def run(self, fn, inputs: tuple, key=None, reads=()) -> tuple:
        """fn(*inputs): eagerly, or captured and replayed (the module's
        rules)."""
        leaves = []
        layout = _flatten(inputs, leaves)
        if key is None or not all(t.is_cuda for t in leaves):
            profiling.count(self.name + ".eager")
            return fn(*inputs)
        key = stage_key(key, layout, reads)
        entry = self._entries.get(key, False)
        if entry is False:  # first sight
            self._entries[key] = None
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            profiling.count(self.name + ".eager")
            return fn(*inputs)
        self._entries.move_to_end(key)
        if entry is None:
            entry = self._entries[key] = self._capture(fn, inputs, leaves)
        return self._replay(entry, leaves)

    def _capture(self, fn, inputs, leaves) -> _Graph:
        dev = leaves[0].device
        views, buffers = [], []
        for t in leaves:
            view, base, index = _buffer(t)
            views.append(view)
            buffers.append((base, index))
        static = _rebuild(inputs, iter(views))
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with torch.cuda.device(dev), torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            outputs = fn(*static)
        launched = {k: n - before[k]
                    for k, n in kernels.launch_counts().items()
                    if n != before[k]}
        for k, n in launched.items():  # the capture ran none of them
            profiling.count(kernels.LAUNCHES + k, -n)
        profiling.count(self.name + ".graph_captures")
        return _Graph(graph, dev, buffers, tuple(outputs), launched)

    def _replay(self, entry: _Graph, leaves) -> tuple:
        with torch.cuda.device(entry.device):
            for (base, index), t in zip(entry.buffers, leaves):
                base.copy_(t if index is None else t[index])
            entry.graph.replay()
            outputs = tuple(o.clone() for o in entry.outputs)
        for k, n in entry.launched.items():
            profiling.count(kernels.LAUNCHES + k, n)
        profiling.count(self.name + ".graph_replays")
        return outputs
