"""CUDA graphs of the chunked trainer's episodes.

The port's counterpart of ``jax.jit`` on the JAX package's chunk program:
an episode is ~350 small device operations a slot over 96 slots, which the
host launches one by one far slower than the card runs them. Every chunk
episode of the chunked trainer starts from a fresh per-chunk state, so it
runs the same operations on the same shapes each time; ``capture`` records
one such run as a ``torch.cuda.CUDAGraph`` and ``replay`` launches it whole.

What a capture must get right, and how the trainer
(``scenarios.py::make_chunked_episode_runner``) does it:

* Draws. A generator would have to live inside the capture. Each chunk's
  draws are made up front, outside the graph, and copied into static
  buffers that the graph reads (``scenarios.py::ChunkDraws``); the graph runs
  only the episode's deterministic ``draws=`` path. The replay indices'
  bounds are known on the host (one transition a slot from an empty ring).
* Fixed addresses. The graph reads and writes the tensors it saw when it
  was captured. Before each replay the trainer copies the episode's
  starting parameters, optimiser state and exploration scale (``epsilon`` /
  ``noise_scale``, which decay replaces by new tensors) into the captured
  ones, and the chunk's draws into the captured draws. Learning rates are
  floats that a capture bakes in: they are fixed per chunk size, and the
  trainer refuses a replay if they changed.
* Kernels. The wrappers launch on the current stream, which is the capture
  stream; K7 asks the device for its cooperative grid once per shape and
  launches through ``cudaLaunchKernelEx`` with the cooperative attribute,
  which a graph keeps on its kernel node. A launch recorded into a graph
  runs at each replay, so ``capture`` tallies the wrappers' launches and
  ``replay`` adds the tally to their counts (``ops/_build.py::count_launch``).
* Optimisers. On the card Adam is ``capturable``: its step count is a
  device tensor and no step reads it on the host.
* No fallback. A capture that fails raises; nothing gives way to the eager
  loop, which stays as the reference that a replay is held to.
"""

from __future__ import annotations

import gc
import time as _time
from typing import Any, Callable, Dict, NamedTuple

import torch

from p2pmicrogrid_tpu_torch.ops import _build


class Captured(NamedTuple):
    """A captured graph and what its capture measured.

    graph: the ``torch.cuda.CUDAGraph``, instantiated
    outputs: what the captured function returned (tensors the graph writes)
    launches: {kernel wrapper: launches a replay makes}
    capture_seconds: host seconds to record the function into the graph
    instantiate_seconds: host seconds to instantiate it
    pool_bytes: device memory the graph's private pool reserved
    """

    graph: Any
    outputs: Any
    launches: Dict[Callable, int]
    capture_seconds: float
    instantiate_seconds: float
    pool_bytes: int


def capture(
    fn: Callable[[], Any],
    stage: Callable[[], None],
    warmup_runs: int = 1,
    capture_error_mode: str = "global",
) -> Captured:
    """Capture ``fn()`` into a CUDA graph.

    ``stage()`` writes the inputs that ``fn`` reads into their static
    buffers. ``fn`` first runs ``warmup_runs`` times eagerly on a side stream
    (after ``stage()`` each time: autograd and the libraries set themselves up
    outside the capture), then once under capture, after a last
    ``stage()``. A capture does not run ``fn``'s device work: the caller
    stages a chunk's inputs and calls ``replay``. ``capture_error_mode`` is
    ``torch.cuda.graph``'s: ``"global"`` refuses the capture if any thread
    makes an unsafe CUDA call meanwhile; ``"thread_local"`` (the serving
    engine's, ``serve/engine.py``, whose other threads keep serving) only
    the capturing thread's.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup_runs):
            stage()
            fn()
    torch.cuda.current_stream().wait_stream(side)
    stage()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    start = _time.perf_counter()
    _build._capture_tally = {}
    try:
        with torch.cuda.graph(graph, capture_error_mode=capture_error_mode):
            outputs = fn()
        launches = _build._capture_tally
    finally:
        _build._capture_tally = None
    captured_at = _time.perf_counter()
    graph.instantiate()
    torch.cuda.synchronize()
    done = _time.perf_counter()
    return Captured(
        graph=graph,
        outputs=outputs,
        launches=launches,
        capture_seconds=captured_at - start,
        instantiate_seconds=done - captured_at,
        pool_bytes=torch.cuda.memory_reserved() - reserved,
    )


def replay(captured: Captured) -> None:
    """Launch the graph on the current stream and count the kernels it
    launches."""
    captured.graph.replay()
    for wrapper, n in captured.launches.items():
        wrapper.launches += n
