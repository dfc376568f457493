"""The serving engine's decode chunk as one CUDA graph, the counterpart of
the reference's jitted decode loop (``repro/serving/engine.py:189-230``,
jitted at ``:412-415``).

``ChunkGraph`` captures a no-argument body once and replays it with one
host call.  The body must read and write only tensors whose storage
outlives the graph (the engine's cache, lane vectors and ``out``
buffer): a graph bakes in every address it was captured with, the TMA
descriptors the kernels take as ``__grid_constant__`` parameters
included.

Launch counting.  Each kernel wrapper adds one to its ``.launches`` when
Python calls it, and a capture calls every wrapper of the body without
running anything.  So the capture's additions are taken back off the
totals and kept as the graph's launches per replay, which every replay
adds once: the counts stay those of the eager engine.
"""

from __future__ import annotations

import time

import torch

from repro_torch.kernels.flash_attention import KERNELS


def capture(body, device) -> ChunkGraph:
    """Run ``body()`` once eagerly on a side stream (the warm-up that
    cuBLAS's handles and the caching allocator need before a capture),
    then capture it on that stream.  Returns the ``ChunkGraph``; its
    first replay is the NEXT run of the body."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(device).wait_stream(side)
    return ChunkGraph(body, side)


def record(body, stream):
    """Capture ``body()`` into a new ``torch.cuda.CUDAGraph`` on the side
    stream ``stream`` (a capture may not run on the default stream).
    Nothing runs; a capture that fails raises."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        body()
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
