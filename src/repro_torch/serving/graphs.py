"""The serving engine's chunk programs as CUDA graphs, the counterpart of
the reference's jitted decode loop and prefill step
(``repro/serving/engine.py:133-150,189-230``, jitted at ``:409-415``).

``ChunkGraph`` captures a no-argument body once and replays it with one
host call: the decode chunk is one graph, the prefill chunk one graph
per chunk size.  The body must read and write only tensors whose storage
outlives the graph (the engine's cache, lane vectors, ``out`` buffer and
prefill lane): a graph bakes in every address it was captured with, the
TMA descriptors the kernels take as ``__grid_constant__`` parameters
included.

Launch counting.  Each kernel wrapper adds one to its ``.launches`` when
Python calls it, and a capture calls every wrapper of the body without
running anything.  So the capture's additions are taken back off the
totals and kept as the graph's launches per replay, which every replay
adds once: the counts stay those of the eager engine, whatever the
graphs and however their replays interleave.
"""

from __future__ import annotations

import functools
import gc
import time

import torch

from repro_torch.kernels.flash_attention import KERNELS


def shared(device):
    """A side stream and a private memory pool for several graphs to be
    captured on and into (``torch.cuda.graph`` asks graphs that share a
    pool to capture on one stream).  Their intermediates may then share
    memory, which is safe because their replays are serialised on one
    stream and every output that outlives a replay is a tensor the
    caller holds."""
    return torch.cuda.Stream(device), torch.cuda.graph_pool_handle()


def capture(body, device, share=None) -> ChunkGraph:
    """Run ``body()`` once eagerly on a side stream (the warm-up that
    cuBLAS's handles and the caching allocator need before a capture),
    then capture it on that stream.  ``share``: a (stream, pool) pair from
    ``shared`` to capture on and into; else a new stream and the graph's
    own pool.  Returns the ``ChunkGraph``; its first replay is the NEXT
    run of the body."""
    side, pool = share if share is not None else (torch.cuda.Stream(device),
                                                  None)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    return ChunkGraph(body, side, record=functools.partial(record, pool=pool))


def record(body, stream, pool=None):
    """Capture ``body()`` into a new ``torch.cuda.CUDAGraph`` on the side
    stream ``stream`` (a capture may not run on the default stream), into
    ``pool`` if given.  Nothing runs; a capture that fails raises.  The
    cyclic garbage collector is held off meanwhile: freeing unreachable
    graphs (another engine's) releases device memory, which invalidates a
    capture in progress."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            body()
    finally:
        if collecting:
            gc.enable()
    return graph


class ChunkGraph:
    """``body`` captured once by ``record(body, stream)``; ``replay()``
    runs it on the current stream.  ``launches`` maps each kernel wrapper
    to its launches per replay, ``capture_s`` is the capture's host time
    (instantiation included)."""

    def __init__(self, body, stream, record=record):
        before = {fn: fn.launches for fn in KERNELS}
        t0 = time.perf_counter()
        try:
            self.graph = record(body, stream)
        finally:
            captured = {fn: fn.launches for fn in KERNELS}
            for fn, n in before.items():
                fn.launches = n
        self.capture_s = time.perf_counter() - t0
        self.launches = {fn: captured[fn] - before[fn] for fn in KERNELS
                         if captured[fn] != before[fn]}
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        for fn, n in self.launches.items():
            fn.launches += n
