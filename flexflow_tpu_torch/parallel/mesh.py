"""Device mesh over ``torch.distributed`` ranks (port of
``flexflow_tpu/parallel/mesh.py``, with its axis names).

JAX builds one controller's ``jax.sharding.Mesh`` and lets GSPMD place the
arrays. The port runs one process per rank (SPMD): every rank runs the same
engine on the same requests with its own shard of the parameters and of the
KV cache, and the explicit collectives below make every value the host
reads identical on every rank. Rank ``r`` of a ``data x pipe x model x
seq`` mesh sits at JAX's coordinate ``np.arange(n).reshape(data, pipe,
model, seq)``: with ``seq == 1`` its model rank is ``r % model``, its pipe
rank (stage) ``(r // model) % pipe`` and its data rank ``r // (pipe *
model)`` (context parallelism below). Groups are made per coordinate:
``model`` per (data, pipe, seq), ``data`` per (pipe, model, seq), ``pipe``
per (data, model, seq). Besides them a mesh holds the group
over ``("model", "data")`` (``FFN_AXES``: one pipe stage's model x data
ranks), over which ``hybrid_ffn``'s FFN sums run: a group of its own only
where both degrees exceed 1, else the ``model`` or ``data`` group itself.

Pipeline stages (``pipe > 1``) pass hidden states along the stage ranks of
one (data, model) coordinate: :meth:`Mesh.send_next` / :meth:`Mesh.recv_prev`
between neighbouring stages, and a return hop from the last stage to stage
0 (:meth:`Mesh.send_first` / :meth:`Mesh.recv_last`) for the tokens an
overlapped decode horizon feeds back. Each hop is a ``broadcast`` from the
sender over a two-rank group of its own: gloo's ``send`` / ``recv`` take
CPU tensors only, while its ``broadcast`` takes CUDA tensors as NCCL's
does. The two directions use separate groups: at P = 2 the forward hop
(0 -> 1) and the return hop (1 -> 0) join the same two ranks, and one
group would meet stage 0's *h(mb0), h(mb1), t(mb0)* against stage 1's
*h(mb0), t(mb0), h(mb1)*. A hop is sent asynchronously (the sender never
waits for its receiver, so a stage's sends cannot block against the return
hop it waits on) and received blocking; :meth:`Mesh.wait_sends` ends the
sends in flight. A training step's backward hops (:meth:`Mesh.send_prev` /
:meth:`Mesh.recv_next`: a gradient from stage s + 1 to stage s) run over
the forward hops' pair groups with the other rank as the source; the
collectives of a group pair up in the order they are issued, so the
forward's sends are ended before the backward begins.
:meth:`Mesh.sum_first_last` sums a tied embedding's gradient over the
return hop's pair.

Only ``all_reduce``, list-form ``all_gather`` and ``broadcast`` are used:
NCCL and gloo take all three on CUDA tensors, so two ranks may share one
card over gloo (``backend="gloo"``). NCCL collectives can be captured in a
CUDA graph once their communicator exists; gloo's cannot.

Under a gradient the decoder's collectives are Megatron's conjugate pairs,
``torch.autograd.Function``s: ``reduce_from_model`` (sum forward, identity
backward), ``copy_to_model`` (identity forward, sum backward) and
``gather_from_model`` (gather forward, the rank's own slice backward).
Every model rank holds the same loss, so the gradient reaching a
replicated tensor is replicated and is never summed twice (the
``torch.distributed.nn`` all-reduce sums it again in its backward: T times
the gradient). Outside a gradient they are the in-place calls below, so a
served step's graph holds plain in-place collectives.

Context parallelism (``seq > 1``): rank ``r`` sits at ``np.arange(n)
.reshape(data, pipe, model, seq)`` with ``seq`` varying fastest, so its
seq rank is ``r % seq``, its model rank ``(r // seq) % model``, its stage
``(r // (seq * model)) % pipe`` and its data rank ``r // (pipe * model *
seq)``; the model, data, FFN and pipe groups are made per seq coordinate,
and a ``seq`` group per (data, pipe, model). The serving engines cut their
verifier KV cache on it (``parallel/sharding.SeqCut``) and merge the
ranks' attention states over it; the ring prefill
(``ops/ring_attention``) rotates K/V blocks along it with
:meth:`Mesh.ring_send` / :meth:`Mesh.ring_recv` (rank ``c`` to ``c + 1``,
the stage hops' scheme: a broadcast over a two-rank group, each directed
pair its own group, since at C = 2 both directions join the same two
ranks). Under pipeline stages (``pipe > 1`` with ``seq > 1``) the pipe
group and the stage hops are made per (data, model, seq) coordinate, so
each seq coordinate runs its own copy of the stage schedule (JAX's
pipeline engine and GPipe loop map over ``("pipe", "model")`` only and
replicate over ``seq``); the surfaces that do not cut on ``seq`` (the
pipeline engines, the Trainer, finetuning) replicate their work over it,
every collective staying inside the rank's seq coordinate.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
AXES = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, SEQ_AXIS)
FFN_AXES = (MODEL_AXIS, DATA_AXIS)  # hybrid_ffn's FFN: model-major over both
Axis = Union[str, Tuple[str, str]]


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a ``data x pipe x model x seq`` mesh: its
    coordinate, its device, the ``model``, ``data``, ``pipe``, ``seq`` and
    ``FFN_AXES`` process groups and the stage and ring hops' two-rank
    groups (None for a rank made by :meth:`fake`, which shards parameters
    but runs no collective)."""

    data: int
    pipe: int
    model: int
    seq: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    model_group: Any = None
    data_group: Any = None
    ffn_group: Any = None
    pipe_group: Any = None
    next_group: Any = None  # (this stage, the next): the forward hop out
    prev_group: Any = None  # (the stage before, this stage): the forward hop in
    return_group: Any = None  # (last stage, stage 0), on those two ranks only
    seq_group: Any = None  # this (data, pipe, model) coordinate's seq ranks (seq > 1)
    ring_out_group: Any = None  # (this seq rank, the next): the ring hop out
    ring_in_group: Any = None  # (the seq rank before, this one): the ring hop in
    hops: int = 0  # hops sent by this rank
    hop_bytes: int = 0
    _sends: list = dataclasses.field(default_factory=list, repr=False)

    @classmethod
    def fake(cls, data: int = 1, model: int = 1, rank: int = 0, device="cpu", *,
             pipe: int = 1, seq: int = 1) -> "Mesh":
        """The mesh coordinate ``rank`` without a process group: what
        ``shard_params`` needs to cut that rank's tree."""
        if not 0 <= rank < data * pipe * model * seq:
            raise ValueError(f"rank {rank} outside a {data} x {pipe} x {model} x {seq} mesh")
        return cls(data, pipe, model, seq, rank, torch.device(device))

    @property
    def seq_rank(self) -> int:
        """This rank's context-parallel coordinate (its block of positions)."""
        return self.rank % self.seq

    @property
    def model_rank(self) -> int:
        return (self.rank // self.seq) % self.model

    @property
    def pipe_rank(self) -> int:
        """This rank's pipeline stage."""
        return (self.rank // (self.seq * self.model)) % self.pipe

    @property
    def data_rank(self) -> int:
        return self.rank // (self.pipe * self.model * self.seq)

    @property
    def first_stage(self) -> bool:
        return self.pipe_rank == 0

    @property
    def last_stage(self) -> bool:
        return self.pipe_rank == self.pipe - 1

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may capture this mesh's collectives (NCCL)."""
        return self.backend == "nccl"

    def _at(self, d: int, p: int, m: int, c: int = 0) -> int:
        return ((d * self.pipe + p) * self.model + m) * self.seq + c

    def group_ranks(self, axis: Axis = MODEL_AXIS) -> List[int]:
        """The ranks of this rank's ``axis`` group, in the group's order
        (``FFN_AXES``: this stage's model x data ranks, in rank order)."""
        d, p, m, c = self.data_rank, self.pipe_rank, self.model_rank, self.seq_rank
        if axis == MODEL_AXIS:
            return [self._at(d, p, j, c) for j in range(self.model)]
        if axis == DATA_AXIS:
            return [self._at(j, p, m, c) for j in range(self.data)]
        if axis == PIPE_AXIS:
            return [self._at(d, j, m, c) for j in range(self.pipe)]
        if axis == SEQ_AXIS:
            return [self._at(d, p, m, j) for j in range(self.seq)]
        return [self._at(j, p, k, c) for j in range(self.data) for k in range(self.model)]

    def stage_rank(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's pipe group."""
        return self._at(self.data_rank, stage % self.pipe, self.model_rank, self.seq_rank)

    def _group(self, axis: Axis):
        group = {MODEL_AXIS: self.model_group, DATA_AXIS: self.data_group,
                 PIPE_AXIS: self.pipe_group, FFN_AXES: self.ffn_group,
                 SEQ_AXIS: self.seq_group}[axis]
        if group is None:
            raise RuntimeError("this mesh has no process group (Mesh.fake): it shards "
                               "parameters but runs no collective")
        return group

    def all_reduce(self, x: torch.Tensor, axis: Axis = MODEL_AXIS) -> torch.Tensor:
        """Sum ``x`` over ``axis`` in place; returns it."""
        dist.all_reduce(x, group=self._group(axis))
        return x

    def all_gather(self, x: torch.Tensor, dim: int, axis: Axis = MODEL_AXIS) -> torch.Tensor:
        """The ``axis`` ranks' ``x`` concatenated along ``dim`` in the
        group's order (:meth:`group_ranks`)."""
        x = x.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(x) for _ in self.group_ranks(axis)]
        dist.all_gather(parts, x, group=self._group(axis))
        return torch.cat(parts, dim=dim)

    def broadcast_from_stage(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """``x`` of pipeline stage ``stage`` on every stage of this rank's
        pipe group, in place (the other stages pass a buffer of its shape)."""
        if self.pipe > 1:
            dist.broadcast(x, self.stage_rank(stage), group=self._group(PIPE_AXIS))
        return x

    def _send(self, x: torch.Tensor, group) -> None:
        if group is None:
            raise RuntimeError("no stage hop from this rank (Mesh.fake, or no such neighbour)")
        x = x.contiguous()
        self._sends.append((dist.broadcast(x, self.rank, group=group, async_op=True), x))
        self.hops += 1
        self.hop_bytes += x.numel() * x.element_size()

    def _recv(self, like: torch.Tensor, src: int, group) -> torch.Tensor:
        """The tensor the global rank ``src`` sends over ``group``."""
        if group is None:
            raise RuntimeError("no hop into this rank (Mesh.fake, or no such neighbour)")
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        dist.broadcast(out, src, group=group)
        return out

    def send_next(self, x: torch.Tensor) -> None:
        """Send ``x`` to the next pipeline stage (asynchronous)."""
        self._send(x, self.next_group)

    def recv_prev(self, like: torch.Tensor) -> torch.Tensor:
        """The previous stage's tensor of ``like``'s shape and dtype."""
        return self._recv(like, self.stage_rank(self.pipe_rank - 1), self.prev_group)

    def send_prev(self, x: torch.Tensor) -> None:
        """The backward hop: send ``x`` (a gradient) to the previous
        pipeline stage (asynchronous), over the forward hop's pair group."""
        self._send(x, self.prev_group)

    def recv_next(self, like: torch.Tensor) -> torch.Tensor:
        """The next stage's tensor of ``like``'s shape and dtype (the
        backward hop in)."""
        return self._recv(like, self.stage_rank(self.pipe_rank + 1), self.next_group)

    def sum_first_last(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over stage 0 and the last stage (the return hop's
        pair) in place; returns it."""
        if self.return_group is None:
            raise RuntimeError("only stage 0 and the last stage of a pipe share a pair group")
        dist.all_reduce(x, group=self.return_group)
        return x

    def send_first(self, x: torch.Tensor) -> None:
        """The return hop: send ``x`` from the last stage to stage 0
        (asynchronous)."""
        self._send(x, self.return_group if self.last_stage else None)

    def recv_last(self, like: torch.Tensor) -> torch.Tensor:
        """On stage 0: the last stage's tensor of ``like``'s shape and dtype."""
        return self._recv(like, self.stage_rank(self.pipe - 1),
                          self.return_group if self.first_stage else None)

    def ring_send(self, x: torch.Tensor) -> None:
        """Send ``x`` to the next seq rank (``c + 1``, the last to 0;
        asynchronous): the ring prefill's rotation."""
        self._send(x, self.ring_out_group)

    def ring_recv(self, like: torch.Tensor) -> torch.Tensor:
        """The previous seq rank's tensor of ``like``'s shape and dtype."""
        return self._recv(like, self.group_ranks(SEQ_AXIS)[self.seq_rank - 1],
                          self.ring_in_group)

    def wait_sends(self) -> None:
        """Wait for every hop this rank has sent (each ends once its
        receiver has it)."""
        sends, self._sends = self._sends, []
        for work, _ in sends:
            work.wait()

    def release(self) -> None:
        """Destroy this rank's groups of the mesh (the default group stays);
        every rank calls it once it is done with the mesh (a layout search's
        candidate). The mesh runs no collective after it. The default
        group's barriers around it keep a rank from closing a gloo group's
        connections while a peer still reads them, or from making the next
        groups while a peer still closes these."""
        dist.barrier()
        names = ("model_group", "data_group", "ffn_group", "pipe_group", "next_group",
                 "prev_group", "return_group", "seq_group", "ring_out_group", "ring_in_group")
        done = []
        for name in names:
            g = getattr(self, name)
            setattr(self, name, None)
            if g is not None and not any(g is d for d in done):
                done.append(g)
                dist.destroy_process_group(g)
        dist.barrier()

    def warm(self, device) -> None:
        """One eager collective on each group (NCCL makes a communicator at
        its first collective, which must not happen under graph capture).
        The hop groups are warmed in one global order: stage pairs (0, 1),
        (1, 2), ..., then (last, 0), each rank joining those it is in; the
        ring hops likewise: seq pairs (0, 1), ..., (last, 0)."""
        own = self.ffn_group is not self.model_group and self.ffn_group is not self.data_group
        axes = (MODEL_AXIS, DATA_AXIS) + ((FFN_AXES,) if own else ()) + (
            (PIPE_AXIS,) if self.pipe > 1 else ()) + ((SEQ_AXIS,) if self.seq > 1 else ())
        for axis in axes:
            self.all_reduce(torch.zeros(1, device=device), axis)
        s = self.pipe_rank
        for k in range(self.pipe - 1):
            if k in (s - 1, s):
                g = self.prev_group if k == s - 1 else self.next_group
                dist.all_reduce(torch.zeros(1, device=device), group=g)
        if self.pipe > 1 and (self.first_stage or self.last_stage):
            dist.all_reduce(torch.zeros(1, device=device), group=self.return_group)
        c = self.seq_rank
        for k in range(self.seq if self.seq > 1 else 0):
            if k in (c, (c - 1) % self.seq):
                g = self.ring_out_group if k == c else self.ring_in_group
                dist.all_reduce(torch.zeros(1, device=device), group=g)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), ctx.axis), None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        own = g.narrow(ctx.dim, ctx.mesh.model_rank * ctx.width, ctx.width)
        return own.contiguous(), None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def reduce_from_model(x: torch.Tensor, mesh: Mesh, axis: Axis = MODEL_AXIS) -> torch.Tensor:
    """``x`` summed over ``axis`` (the ``model`` axis, or ``FFN_AXES`` for a
    hybrid FFN). Backward: the identity (the sum's gradient, replicated on
    every rank, is each partial's). Without a gradient: ``mesh.all_reduce``
    in place on ``x``."""
    return _ReduceFromModel.apply(x, mesh, axis) if _tracked(x) else mesh.all_reduce(x, axis)


def copy_to_model(x: torch.Tensor, mesh: Mesh, axis: Axis = MODEL_AXIS) -> torch.Tensor:
    """``x`` itself, entering a column-parallel region cut over ``axis``.
    Backward: the ranks' partial gradients summed over ``axis``."""
    return _CopyToModel.apply(x, mesh, axis) if _tracked(x) else x


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The ``model`` ranks' ``x`` concatenated along ``dim`` (equal widths).
    Backward: this rank's own slice of the gradient."""
    return _GatherFromModel.apply(x, mesh, dim) if _tracked(x) else mesh.all_gather(x, dim)


def all_reduce_grads(grads, mesh: Mesh, axis: str = DATA_AXIS) -> None:
    """Sum every gradient tensor of the list ``grads`` over ``axis`` in place,
    in float32 (one flat buffer a dtype and device, one collective each)."""
    groups: dict = {}
    for g in grads:
        groups.setdefault((g.dtype, g.device), []).append(g)
    for gs in groups.values():
        flat = torch.cat([g.reshape(-1).float() for g in gs])
        mesh.all_reduce(flat, axis)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _default_device() -> torch.device:
    """``cuda:LOCAL_RANK``; raises when the rank has no CUDA device (the
    CPU is used only when the caller names it, as ``resolve_device``)."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    resolve_device("cuda")
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"rank with LOCAL_RANK {local} has no CUDA device "
                           f"({torch.cuda.device_count()} visible); pass device=")
    return torch.device("cuda", local)


def needs_group(n: int) -> RuntimeError:
    """The error of ``n`` ranks asked for in a process without a group."""
    return RuntimeError(f"a {n}-rank mesh needs a process group: run under torchrun or call "
                        "torch.distributed.init_process_group first")


def init_world(need: int, backend: str) -> None:
    """Form the default process group unless one is initialised: from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``),
    or, for ``need == 1``, one rank on a free localhost port; else raise."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    elif need == 1:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
    else:
        raise needs_group(need)


def make_mesh(data: int = 1, pipe: int = 1, model: int = 1, seq: int = 1, *,
              backend: Optional[str] = None,
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """This rank's mesh over the default process group.

    The group is the caller's if one is initialised; otherwise it is made
    from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``), or, for a mesh of one rank, on a free localhost port.
    ``data * pipe * model * seq`` must equal the world size. The backend is
    NCCL for CUDA devices and gloo for the CPU unless ``backend`` names
    one; the device is ``cuda:LOCAL_RANK`` unless ``device`` names one
    (without CUDA that raises: only ``device="cpu"`` gives a CPU mesh).
    Every rank creates every group, in one order."""
    need = data * pipe * model * seq
    if min(data, pipe, model, seq) < 1:
        raise ValueError(f"mesh degrees must be >= 1, got {data}x{pipe}x{model}x{seq}")
    device = _default_device() if device is None else resolve_device(device)
    if backend is None:
        if dist.is_initialized():
            backend = dist.get_backend()
        else:
            backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    init_world(need, backend)
    world, rank = dist.get_world_size(), dist.get_rank()
    if need != world:
        raise ValueError(f"mesh {data}x{pipe}x{model}x{seq} needs {need} ranks, the world "
                         f"has {world}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = Mesh(data, pipe, model, seq, rank, device, backend)
    mine = {}  # axis -> this rank's group

    def group(axis, ranks):
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            mine[axis] = g

    at = mesh._at
    for d in range(data):
        for p in range(pipe):
            for c in range(seq):
                group(MODEL_AXIS, [at(d, p, m, c) for m in range(model)])
    for p in range(pipe):
        for m in range(model):
            for c in range(seq):
                group(DATA_AXIS, [at(d, p, m, c) for d in range(data)])
    if data > 1 and model > 1:  # else the model or the data group is the FFN's
        for p in range(pipe):
            for c in range(seq):
                group(FFN_AXES, [at(d, p, m, c) for d in range(data) for m in range(model)])
    if pipe > 1:  # the pipe group and the stage hops of each (data, model, seq)
        for d in range(data):
            for m in range(model):
                for c in range(seq):
                    group(PIPE_AXIS, [at(d, p, m, c) for p in range(pipe)])
                    for p in range(pipe - 1):
                        g = dist.new_group([at(d, p, m, c), at(d, p + 1, m, c)],
                                           backend=backend)
                        if rank == at(d, p, m, c):
                            mesh.next_group = g
                        elif rank == at(d, p + 1, m, c):
                            mesh.prev_group = g
                    group("return", [at(d, pipe - 1, m, c), at(d, 0, m, c)])
    if seq > 1:
        for d in range(data):
            for p in range(pipe):
                for m in range(model):
                    group(SEQ_AXIS, [at(d, p, m, c) for c in range(seq)])
                    for c in range(seq):  # the ring hop c -> c + 1, a group a direction
                        src, dst = at(d, p, m, c), at(d, p, m, (c + 1) % seq)
                        g = dist.new_group(sorted({src, dst}), backend=backend)
                        if rank == src:
                            mesh.ring_out_group = g
                        if rank == dst:
                            mesh.ring_in_group = g
    mesh.model_group, mesh.data_group = mine[MODEL_AXIS], mine[DATA_AXIS]
    mesh.ffn_group = mine.get(FFN_AXES) or (mesh.model_group if data == 1 else mesh.data_group)
    mesh.pipe_group, mesh.return_group = mine.get(PIPE_AXIS), mine.get("return")
    mesh.seq_group = mine.get(SEQ_AXIS)
    if rank == 0:
        print(f"[mesh] data={data} pipe={pipe} model={model}"
              + (f" seq={seq}" if seq > 1 else "") + f" over {world} rank(s), backend "
              f"{backend}, rank 0 on {device}", flush=True)
    return mesh
