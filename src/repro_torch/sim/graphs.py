"""CUDA graphs of the fused round pipeline's rounds: the port's counterpart
of the reference's compiled chunk program and its jit cache
(``repro.sim.pipeline._chunk_program``).

A round of a non-robust batch under the SAA kernels is a function of
static buffers only: the pipeline's params, YoGi state, per-cell scalars
and stale-cache rows, the batch's training data, and one int64 block of
the round's packed indices, laid out by the round's padded shape
(``Bucket``: training rows, aggregation groups, operand rows a group,
cache capacity).  ``RoundGraphs`` owns those buffers and captures that
function once per bucket, then replays it for every round of that shape:
a round costs one device-to-device copy of its index block into the
graph's static input and one graph launch, whatever the ~220 kernels
inside (the batched MLP's forward and backward, the straggler scatter,
the operand gathers, kernel 1 or kernel 2 and the YoGi step).

Like the reference's jit cache, the graphs outlive a run: a pipeline
takes an idle ``RoundGraphs`` of its static structure (``acquire``), fills
its buffers with the run's initial state and data, and gives it back at
``finalize`` (``release``), so the next run of that structure replays the
graphs already captured.  At most ``IDLE_MAX`` idle ones are kept.

Before its capture a new bucket runs once, eagerly, on a side stream, with
every write redirected to the scratch rows (the cache's trash slot, the
params' scratch row): first-use work (cuBLAS handles and workspaces, the
autograd engine, the cluster kernels' ``cudaFuncSetAttribute`` and
``cudaOccupancyMaxActiveClusters``) then happens outside the capture, and
the real state is untouched.  The graphs share one private memory pool;
nothing a graph writes outlives the next replay except through the static
buffers, so replaying them in any order is safe.

Launch accounting: ``repro_torch.kernels.LAUNCHES`` counts the launches
that did a path's work.  A replay adds the launches its graph holds, per
kernel and per variant key; the warm-up's launches go to the run's
``warmup_launches``, and the capture's wrapper calls, which launch
nothing, are taken back out.
"""
from __future__ import annotations

import time
import warnings
from collections import Counter, OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES

IDLE_MAX = 8      # idle RoundGraphs kept; the least recently released goes


class Bucket(NamedTuple):
    """A round's padded shape, the key of its graph."""
    rows: int          # training rows (0: no learner survived)
    groups: int        # aggregation groups (0: no cell aggregates)
    n: int             # operand rows a group
    capacity: int      # stale-cache slots (which rows tensor it reads)


def upload(block: np.ndarray, device) -> torch.Tensor:
    """A chunk's packed indices on ``device`` in one host-to-device copy,
    staged in pinned memory (a view of ``block`` on the CPU).  The copy is
    asynchronous; torch's pinned-memory allocator hands the staging buffer
    out again only after the copy that reads it has finished."""
    host = torch.from_numpy(block)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


class _Graph(NamedTuple):
    graph: object      # torch.cuda.CUDAGraph
    block: torch.Tensor   # the static index block the graph reads
    out: object        # what the round returned at capture (pool memory)
    launches: Counter  # the kernel launches one replay makes


def _minus(after: Counter, before: Counter) -> Counter:
    return Counter({k: v - before[k] for k, v in after.items()
                    if v != before[k]})


class RoundGraphs:
    """The static buffers of one pipeline structure (``key``) on one CUDA
    device, and the rounds captured on them, one per ``Bucket``."""

    def __init__(self, device, key: tuple, buffers: dict):
        self.device = device
        self.key = key
        self.buffers = buffers           # name -> the tensor graphs read
        self.rows: dict = {}             # cache capacity -> its rows tensor
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self._graphs: dict = {}

    def cache_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """This structure's rows tensor of ``rows``' capacity, holding a
        copy of ``rows``: a grown cache is a new tensor, and the graphs of
        each capacity read their own."""
        mine = self.rows.get(rows.shape[0])
        if mine is None:
            mine = self.rows[rows.shape[0]] = torch.empty_like(rows)
        mine.copy_(rows)
        return mine

    def run(self, key: Bucket, block: torch.Tensor, fn, warm_block, stats):
        """The round ``fn`` of bucket ``key`` on the device index block
        ``block``: replayed from its graph, captured first if the bucket is
        new (``warm_block()`` gives the warm-up's redirected block).
        Counts into ``stats`` (``PipelineStats``).  Returns what ``fn``
        returns, in graph memory that the next replay may overwrite."""
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = self._capture(fn, warm_block(), stats)
        g.block.copy_(block)
        g.graph.replay()
        LAUNCHES.update(g.launches)
        stats.graph_replays += 1
        return g.out

    def _capture(self, fn, warm: torch.Tensor, stats) -> _Graph:
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        before = Counter(LAUNCHES)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn(warm)
            warmed = Counter(LAUNCHES)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self.pool)
            try:
                out = fn(warm)
            finally:
                with warnings.catch_warnings():
                    # a round with no survivor and no group is an empty graph
                    warnings.filterwarnings("ignore",
                                            "The CUDA Graph is empty")
                    graph.capture_end()
        cur.wait_stream(self.stream)
        stats.warmup_launches.update(_minus(warmed, before))
        launches = _minus(LAUNCHES, warmed)
        LAUNCHES.clear()
        LAUNCHES.update(before)
        stats.graph_captures += 1
        stats.graph_capture_s += time.perf_counter() - t0
        return _Graph(graph, warm, out, launches)


_IDLE: "OrderedDict[tuple, RoundGraphs]" = OrderedDict()


def acquire(key: tuple):
    """An idle ``RoundGraphs`` of static structure ``key``, or None."""
    return _IDLE.pop(key, None)


def release(graphs: RoundGraphs) -> None:
    """Hand ``graphs`` back for the next pipeline of its structure."""
    _IDLE[graphs.key] = graphs
    _IDLE.move_to_end(graphs.key)
    while len(_IDLE) > IDLE_MAX:
        _IDLE.popitem(last=False)
