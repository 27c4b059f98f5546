"""CPU offload: the decoder's layer stack in host memory, streamed to the
device one layer at a time (port of the JAX package's ``--offload``:
``InferenceEngine(offload=True)`` and ``decoder._stream_in``).

JAX puts ``params["layers"]`` in ``pinned_host`` memory and copies each
layer's slice in inside the layer scan; XLA's scheduler overlaps that copy
with the previous layer's compute. PyTorch runs eagerly, so the overlap is
built by hand here, in :class:`LayerStore`:

- **Host side.** Every ``params["layers"]`` leaf is an ``[L, ...]`` tensor in
  page-locked host memory (a quantized leaf: each of its ``q``, ``scale``,
  ``offset`` fields, ``[L, ...]`` or ``[L, E, ...]``). L is outermost, so a
  layer of a leaf is one contiguous slab.
- **Device side.** Two preallocated slots, each one layer of every leaf
  (``[1, ...]``; a quantized slot is a one-layer carrier, so
  ``LayerQuant(slot, 0)`` takes the resident engine's kernel path and
  regime). Nothing is allocated per layer.
- **Copies** run on a copy stream of their own, one non-blocking
  ``copy_`` per leaf field and layer.
- **Ordering** by CUDA events: the compute stream waits for a slot's
  "copied" event before the layer reads it (``acquire``); the copy of
  layer l + 2 into that slot waits for layer l's "consumed" event, recorded
  on the compute stream after the layer (``release``). The ring runs on
  across forwards: while the last layer of one forward computes, layer 0
  of the next is already being copied.

On a CPU store (the tests) the leaves stay plain CPU tensors and each load
copies a layer into a slot at once; the decoder reads the slots exactly as
on the card.

Page-locking. Host memory is pinned with ``cudaHostRegister`` over anonymous
``mmap`` buffers of the exact size (:func:`pinned_empty`), not through
PyTorch's caching host allocator: that allocator rounds each block up to a
power of two (an 87 GiB stack would take up to twice that) and keeps freed
blocks until the process ends. A registration lives as long as the buffer:
when the last tensor over it is freed the memory is unregistered and
unmapped. A leaf handed to the store in pageable memory (or on the device)
is copied into such a buffer. A failure to pin raises; nothing falls back to
pageable copies.

The store is memory management below the decoder, which reads it;
``serving/engine.py`` builds it. ``models/params.build_params(host_layers=
True)`` writes a stack straight into pinned leaves, already fused as the
engine would fuse it, and the store takes those leaves as they are: the
host holds one copy of the stack.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import mmap
import time
from typing import Any, Dict, List

import torch

from flexflow_tpu_torch.ops.kernels.quant_matmul import LayerQuant
from flexflow_tpu_torch.quant.weight_only import QuantizedArray

Params = Dict[str, Any]
_QFIELDS = ("q", "scale", "offset")
pin_seconds = 0.0  # wall time this process spent in cudaHostRegister
pinned_bytes = 0  # bytes this process holds page-locked through pinned_empty


class _PinnedBuffer(mmap.mmap):
    """Anonymous host memory registered with CUDA; unregistered when the
    buffer is freed (the last tensor over it holds the last reference)."""

    ptr = 0
    unregister = None

    def __del__(self):
        global pinned_bytes
        if self.ptr:
            self.unregister(self.ptr)
            self.ptr = 0
            pinned_bytes -= len(self)


def pinned_empty(shape, dtype) -> torch.Tensor:
    """An uninitialised CPU tensor in page-locked memory of exactly its size
    (``cudaHostRegister``). Raises if CUDA refuses to pin it."""
    global pin_seconds, pinned_bytes
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    buf = _PinnedBuffer(-1, max(nbytes, 1))
    raw = torch.frombuffer(buf, dtype=torch.uint8)  # holds buf until its storage is freed
    cudart = torch.cuda.cudart()
    t0 = time.perf_counter()
    err = cudart.cudaHostRegister(raw.data_ptr(), len(buf), 0)
    pin_seconds += time.perf_counter() - t0
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: {err}")
    buf.ptr, buf.unregister = raw.data_ptr(), cudart.cudaHostUnregister
    pinned_bytes += len(buf)
    return raw[:nbytes].view(dtype).view(shape)


def host_empty(shape, dtype, pin: bool) -> torch.Tensor:
    """An uninitialised CPU tensor, page-locked when ``pin``."""
    return pinned_empty(shape, dtype) if pin else torch.empty(shape, dtype=dtype)


def _host_tensor(t: torch.Tensor, pin: bool) -> torch.Tensor:
    if t.device.type == "cpu" and t.is_contiguous() and (not pin or t.is_pinned()):
        return t
    out = host_empty(t.shape, t.dtype, pin)
    out.copy_(t)
    return out


def leaf_fields(leaf) -> List[torch.Tensor]:
    """A leaf's tensors: itself, or a quantized carrier's fields."""
    if isinstance(leaf, QuantizedArray):
        return [t for t in (getattr(leaf, f) for f in _QFIELDS) if t is not None]
    return [leaf]


def _map_fields(leaf, fn):
    if isinstance(leaf, QuantizedArray):
        return dataclasses.replace(leaf, **{f: None if getattr(leaf, f) is None else
                                            fn(getattr(leaf, f)) for f in _QFIELDS})
    return fn(leaf)


def _one_layer(leaf, device, layer=None):
    """An empty one-layer ``[1, ...]`` slot of ``leaf`` on ``device`` (filled
    with ``layer`` if given)."""
    def slot(t):
        s = torch.empty((1, *t.shape[1:]), dtype=t.dtype, device=device)
        return s if layer is None else s.copy_(t[layer:layer + 1])

    out = _map_fields(leaf, slot)
    if isinstance(leaf, QuantizedArray):
        out = dataclasses.replace(out, shape=(1, *leaf.shape[1:]))
    return out


def _view(slot: Params) -> Params:
    """The decoder's view of a one-layer slot: plain leaves at index 0,
    quantized ones as ``LayerQuant(slot, 0)``."""
    return {k: LayerQuant(v, 0) if isinstance(v, QuantizedArray) else v[0]
            for k, v in slot.items()}


class LayerStore:
    """The layer stack in host memory and a ring of two device slots (see the
    module docstring). The decoder calls ``acquire(i)`` for layer i's
    parameters and ``release(i)`` once the layer's work is enqueued; layers
    are taken in order 0 .. L-1, forward after forward. A forward that
    breaks off leaves the ring one or two layers ahead: the next ``acquire``
    of another layer restarts it there."""

    def __init__(self, layers: Params, num_layers: int, device):
        self.device = torch.device(device)
        self.num_layers = num_layers
        cuda = self.device.type == "cuda"
        self.host = {k: _map_fields(v, lambda t: _host_tensor(t, cuda)) for k, v in layers.items()}
        for k, v in self.host.items():
            if any(t.shape[0] != num_layers for t in leaf_fields(v)):
                raise ValueError(f"{k}: every layer leaf must be stacked [{num_layers}, ...]")
        self.layer_bytes = sum(t[0].nbytes for v in self.host.values() for t in leaf_fields(v))
        self.slots = [{k: _one_layer(v, self.device) for k, v in self.host.items()}
                      for _ in range(2)]
        self._views = [_view(s) for s in self.slots]
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._copied = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._consumed = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._ring: collections.deque = collections.deque()  # (slot, layer) loads in order
        self.restart(0)

    # -- the ring ---------------------------------------------------------

    def _copy(self, slot: int, layer: int) -> None:
        """Copy ``layer`` into ``slot``: on the copy stream after the slot's
        last reader (its "consumed" event), recording its "copied" event; on
        the CPU at once."""
        dst = self.slots[slot]
        if self._stream is None:
            for k, v in self.host.items():
                for d, s in zip(leaf_fields(dst[k]), leaf_fields(v)):
                    d[0].copy_(s[layer])
            return
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(self._consumed[slot])
            for k, v in self.host.items():
                for d, s in zip(leaf_fields(dst[k]), leaf_fields(v)):
                    d[0].copy_(s[layer], non_blocking=True)
            self._copied[slot].record(self._stream)

    def _load(self, slot: int, layer: int) -> None:
        self._copy(slot, layer)
        self._ring.append((slot, layer))

    def restart(self, layer: int = 0) -> None:
        """Refill both slots from ``layer`` on, after whatever the compute
        stream has enqueued so far."""
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._ring.clear()
        self._load(0, layer)
        self._load(1, (layer + 1) % self.num_layers)

    def acquire(self, i: int) -> Params:
        """Layer i's parameters, read from its slot (the compute stream waits
        for the slot's copy)."""
        if self._ring[0][1] != i:
            self.restart(i)
        slot = self._ring[0][0]
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_event(self._copied[slot])
        return dict(self._views[slot])

    def release(self, i: int) -> None:
        """Layer i's work is enqueued: its slot takes the layer two ahead
        (wrapping into the next forward) once that work has run."""
        slot, layer = self._ring.popleft()
        if layer != i:
            raise RuntimeError(f"released layer {i}, but layer {layer} was staged")
        if self._stream is not None:
            self._consumed[slot].record(torch.cuda.current_stream(self.device))
        self._load(slot, (self._ring[-1][1] + 1) % self.num_layers)

    # -- outside the ring -------------------------------------------------

    def layer(self, i: int) -> Params:
        """Layer i copied into fresh one-layer device tensors, outside the
        ring (for a caller that keeps one layer, such as the per-op profile)."""
        return _view({k: _one_layer(v, self.device, i) for k, v in self.host.items()})

    def __del__(self):
        # copies in flight read the host leaves and write the slots: both
        # must outlive them (the pinned memory is returned once no other
        # tensor holds it)
        if getattr(self, "_stream", None) is not None:
            self._stream.synchronize()
