"""CUDA-graph capture of a serving step: the port's counterpart of the JAX
package's device-resident horizons (``decode_n_fn``, ``fused_step_n_fn``).

JAX compiles a horizon of n steps into one program. PyTorch runs eagerly, so
the port captures one step (a decode step, or a speculative iteration) over
static device buffers in a CUDA graph and replays it n times: one graph
launch per step instead of thousands of launches from Python.

The body reads its inputs from buffers that outlive the graph and writes its
outputs back into them in place; whatever the buffers hold when a replay
runs is what the step works on. Everything else the body allocates lives in
the graph's memory pool and is overwritten by the next replay, so a caller
copies an output out, in stream order, before it replays again.

Capture is done from the thread that replays, in ``thread_local`` error
mode: a request manager's fetch worker may copy an earlier horizon's tokens
to the host meanwhile, and that copy must not invalidate the capture.

The kernel wrappers count their launches in Python, and a replay runs no
Python. So a capture records how much each counter grew while the body was
captured, puts the counters back (a capture launches nothing), and every
replay adds that growth: the counters go on counting the kernel launches
that ran.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Tuple

import torch

from flexflow_tpu_torch.ops.kernels import decode_attention, flash_prefill, quant_matmul

_COUNTERS = ((quant_matmul, "LAUNCHES"), (quant_matmul, "LAUNCHES_INT4"),
             (decode_attention, "LAUNCHES"), (flash_prefill, "LAUNCHES"))


def capturable(device: torch.device, *specs, offload: bool = False) -> bool:
    """Whether an engine on ``device`` running ``specs`` captures its greedy
    step: on a CUDA device, unless a model's MoE FFN is the ``ragged`` form,
    which reads its expert group sizes on the host every layer, or the
    engine offloads its layers to the host (``offload``). An offload step is
    bound by the host-to-device stream of its layers (about 1.7 s for bf16
    Mixtral-8x7B over PCIe), so a replay would save nothing."""
    return device.type == "cuda" and not offload and not any(
        s.moe is not None and s.moe.impl == "ragged" for s in specs)


def launch_counts() -> Tuple[int, ...]:
    """The serving kernels' launch counters: qmm_int8, qmm_int4,
    decode_attention, flash_prefill."""
    return tuple(getattr(mod, name) for mod, name in _COUNTERS)


def add_launches(delta: Tuple[int, ...]) -> None:
    for (mod, name), d in zip(_COUNTERS, delta):
        setattr(mod, name, getattr(mod, name) + d)


def counted(fn: Callable[[], None]) -> Tuple[int, ...]:
    """Run ``fn`` (a capture) and return how much each launch counter grew
    meanwhile; the counters are put back to where they were."""
    before = launch_counts()
    try:
        fn()
    finally:
        grown = tuple(a - b for a, b in zip(launch_counts(), before))
        add_launches(tuple(-g for g in grown))
    return grown


class StepGraphs:
    """A step body over static device buffers, captured in one CUDA graph
    per static ``key`` (the draft's attention window, or None); all graphs
    share one memory pool and one side stream. Graphs are replayed one at a
    time on the current stream, and the buffers outlive them all, so sharing
    the pool is safe in any replay order.

    The body is passed to ``capture`` and not kept: an engine that owns
    this object and whose method is the body would otherwise form a
    reference cycle, and its weights and cache would stay on the card after
    the last reference to the engine is dropped, until a garbage
    collection."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, Tuple[int, ...]]] = {}
        self.capture_ms = 0.0  # warm-ups and captures, host clock
        self.replays = 0
        self._stream = None
        self._pool = None

    def capture(self, body: Callable[[Hashable], None], key: Hashable) -> None:
        """Warm up, then capture ``body(key)``. The warm-up runs the body
        once, eagerly, on the side stream, on what the buffers hold (its
        launches run and count); the caller loads the buffers again before
        it replays."""
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            body(key)
        current.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                body(key)

        self.graphs[key] = (graph, counted(capture))
        self.capture_ms += (time.perf_counter() - t0) * 1e3

    def replay(self, key: Hashable) -> None:
        graph, launches = self.graphs[key]
        graph.replay()
        add_launches(launches)
        self.replays += 1
