"""Automatic layout search over (data, pipe, model) degrees (port of
``flexflow_tpu/parallel/auto.py``).

The layout space is the (dp, pp, tp) factorizations of the device count (and
a microbatch count for pp). The search:

1. enumerates the legal factorizations (``enumerate_layouts``: heads,
   layers and batch must divide);
2. ranks them with an analytic cost model (``analytic_cost``: matmul FLOPs
   over the chip's rate, collective bytes over the links, the pipeline
   bubble, and an HBM capacity filter);
3. measures the top candidates by timing a real step under each
   (``measure_layout``) and keeps the fastest.

``OpCostCache`` and ``simulate_runtime`` estimate a step from matmuls and
an attention timed once at their sharded shapes and cached;
``estimate_memory`` and ``memory_constrained_search`` pick the fastest
layout under a per-device memory budget.

Differences from the JAX module:

- ``MachineModel``'s defaults are the H100 SXM's datasheet figures (dense
  bf16 rate, HBM3 rate and size, one direction of NVLink 4), not a v5e's.
- The devices are the ranks of the default process group (one process a
  rank, each its device; ``device_count``): JAX counts the devices its one
  controller sees. Over more than one rank every rank runs the search, in
  the same order: it enumerates and ranks the candidates alike, builds
  each candidate's mesh (``layout_mesh``: ``parallel/mesh.make_mesh``, a
  collective), agrees with the others whether the build succeeded before
  any step runs, times the step, and takes the longest of the ranks' times
  (``measure_layout``), so every rank's report and choice are the same. A
  candidate's groups (``on_mesh``: on every rank, whether or not its build
  failed there), Trainer or engine are released before the next is built.
- A candidate that fails to build or run is skipped, as in JAX, but the
  exception's text goes into the report; when no candidate ran the search
  raises with those texts instead of returning nothing (or, for serving,
  a layout that never ran).
- Timed intervals are closed by ``torch.cuda.synchronize()`` on a CUDA
  device; times are seconds, as in JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.parallel import mesh as mesh_lib
from flexflow_tpu_torch.specs import ModelSpec


@dataclasses.dataclass(frozen=True)
class Layout:
    data: int
    pipe: int
    model: int
    num_microbatches: int = 1
    # per-op degrees: attention TP = model, FFN TP = model * data (the
    # serving search's candidate when attention TP is capped by kv_heads)
    hybrid_ffn: bool = False

    def __str__(self):
        h = " ffn-tp=%d" % (self.model * self.data) if self.hybrid_ffn else ""
        return (f"dp={self.data} pp={self.pipe} tp={self.model} "
                f"mb={self.num_microbatches}{h}")


@dataclasses.dataclass
class MachineModel:
    """Analytic machine description. The defaults are the NVIDIA H100 SXM's
    datasheet figures: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB, and
    450 GB/s one way over NVLink 4 (900 GB/s both ways).

    Attaching a ``topology`` (``parallel.topology.TorusTopology``) replaces
    the flat-bandwidth comm terms by per-axis ring-collective costs that
    spill to the network between hosts."""

    chip_flops: float = 989e12
    hbm_bw: float = 3.35e12
    ici_bw: float = 450e9
    hbm_bytes: float = 80e9
    topology: Optional[object] = None  # parallel.topology.TorusTopology


def device_count(device=None) -> int:
    """The devices a search places on: the world size of the default
    process group (under ``torchrun`` before it is formed, its
    ``WORLD_SIZE``); one without a group. More than one CUDA device in a
    process without a group raises ``make_mesh``'s error: each rank is a
    process of its own."""
    if dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n > 1:
        raise mesh_lib.needs_group(n)
    return 1


def search_device(device, n: int) -> torch.device:
    """The device this rank searches on: ``device``, except that an
    unnumbered CUDA device over more than one rank is ``cuda:LOCAL_RANK``
    (``make_mesh``'s default). Under ``torchrun`` the default group is
    formed here, as ``make_mesh`` forms it."""
    dev = resolve_device(device)
    if n > 1 and not dist.is_initialized() and "WORLD_SIZE" in os.environ \
            and "RANK" in os.environ:
        mesh_lib.init_world(n, "nccl" if dev.type == "cuda" else "gloo")
    if n > 1 and dev.type == "cuda" and dev.index is None:
        return mesh_lib._default_device()
    return dev


def speaks() -> bool:
    """Whether this process logs a search's choice: rank 0 of a world (JAX's
    one controller), or a process without one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _world_all(value: float, op, device: torch.device) -> float:
    """``value`` reduced over every rank of the default group with ``op``."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=op)
    return float(t.item())


_ERROR_BYTES = 512  # an agreed error text's bytes (longer texts are cut)


def _agreed_error(err: Optional[str], device: torch.device) -> Optional[str]:
    """The error every rank reports for a candidate: None when no rank
    failed, else the lowest failing rank's text (``rank r: ...``)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    first = int(_world_all(rank if err is not None else world, dist.ReduceOp.MIN, device))
    if first == world:
        return None
    buf = torch.zeros(_ERROR_BYTES, dtype=torch.uint8, device=device)
    if rank == first:
        text = f"rank {rank}: {err}".encode()[:_ERROR_BYTES]
        buf[:len(text)] = torch.frombuffer(bytearray(text), dtype=torch.uint8)
    dist.broadcast(buf, src=first)
    return bytes(buf.cpu().tolist()).rstrip(b"\0").decode(errors="replace")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def enumerate_layouts(
    n_devices: int, spec: ModelSpec, batch_size: int
) -> List[Layout]:
    """Legal (dp, pp, tp) factorizations of the device count."""
    out = []
    for tp in range(1, n_devices + 1):
        if n_devices % tp or spec.num_heads % tp:
            continue
        if spec.num_kv_heads % tp and spec.num_kv_heads > 1:
            continue
        rem = n_devices // tp
        for pp in range(1, rem + 1):
            if rem % pp or spec.num_layers % pp:
                continue
            dp = rem // pp
            if batch_size % dp:
                continue
            mb = pp if pp > 1 else 1
            if pp > 1 and (batch_size // dp) % mb:
                continue
            out.append(Layout(dp, pp, tp, mb))
    return out


def analytic_cost(
    layout: Layout,
    spec: ModelSpec,
    batch_size: int,
    seq_len: int,
    machine: Optional[MachineModel] = None,
    *,
    train: bool = True,
) -> float:
    """Estimated train-step seconds (3x the forward's FLOPs for forward and
    backward); ``train=False`` drops the backward factor and sizes the HBM
    filter for bf16 weights only (serving)."""
    m = machine or MachineModel()
    d, f, l, v = (spec.hidden_size, spec.intermediate_size, spec.num_layers,
                  spec.vocab_size)
    tokens = batch_size * seq_len
    # matmul flops per token per layer: qkv + o, and the mlp
    mlp_mults = 3 if spec.act == "silu_gate" else 2
    attn_per_tok = l * 2 * (
        d * (spec.num_heads + 2 * spec.num_kv_heads) * spec.head_dim
        + spec.num_heads * spec.head_dim * d
    )
    ffn_per_tok = l * 2 * mlp_mults * d * f + 2 * d * v
    flops_per_tok = attn_per_tok + ffn_per_tok
    bwd = 3 if train else 1
    total_flops = bwd * flops_per_tok * tokens
    if layout.hybrid_ffn:
        # attention on model only (data replicates it); FFN + head on
        # model * data
        compute = bwd * tokens * (
            attn_per_tok / (m.chip_flops * layout.pipe * layout.model)
            + ffn_per_tok / (m.chip_flops * layout.pipe * layout.model
                             * layout.data)
        )
    else:
        compute = total_flops / (
            m.chip_flops * layout.data * layout.pipe * layout.model)

    # TP: 2 allreduces per layer per microbatch pass (activations B*T*D)
    comm = 0.0
    topo = m.topology
    n_params = l * (4 * d * d + mlp_mults * d * f) + v * d
    if topo is not None:
        # per-axis ring collectives over the topology (spilling to the
        # network between hosts where an axis does not fit)
        if layout.model > 1:
            bytes_act = 2 * l * tokens * d * 2 / (layout.data * layout.pipe)
            comm += topo.all_reduce_time(bytes_act, layout.model)
        if layout.data > 1:
            comm += topo.all_reduce_time(2 * n_params * 4, layout.data)
        bubble = 1.0
        if layout.pipe > 1:
            mb = layout.num_microbatches
            bubble = (mb + layout.pipe - 1) / mb
            comm += 2 * (layout.pipe - 1) * topo.ppermute_time(
                tokens * d * 2 / layout.data)
    else:
        # hybrid_ffn: the data axis carries FFN TP, not DP: activations
        # reshard across model*data at the attention/FFN boundary and
        # there is NO gradient allreduce over it
        tp_eff = (layout.model * layout.data if layout.hybrid_ffn
                  else layout.model)
        dp_eff = 1 if layout.hybrid_ffn else layout.data
        if tp_eff > 1:
            bytes_ar = (2 * l * tokens * d * 2 * 2
                        * (tp_eff - 1) / tp_eff)
            comm += bytes_ar / (m.ici_bw * dp_eff * layout.pipe)
        # DP: gradient allreduce of all params
        if dp_eff > 1:
            comm += (2 * n_params * 4
                     * (dp_eff - 1) / dp_eff) / m.ici_bw
        # PP bubble: (P-1)/(M+P-1) of the pipe is idle; plus inter-stage
        # activation hops (fwd + bwd) over the links
        bubble = 1.0
        if layout.pipe > 1:
            mb = layout.num_microbatches
            bubble = (mb + layout.pipe - 1) / mb
            comm += (
                2 * (layout.pipe - 1) * tokens * d * 2
                / (m.ici_bw * layout.data)
            )

    # HBM capacity filter: params (+grads+adam when training) per device
    shard = layout.model * layout.pipe * (
        layout.data if layout.hybrid_ffn else 1)
    bytes_per_dev = n_params * (16 if train else 2) / shard
    if bytes_per_dev > m.hbm_bytes:
        return float("inf")
    return compute * bubble + comm


def on_mesh(mesh, build: Callable[[], Callable[[], None]]) -> Callable[[], None]:
    """A candidate's step, ``build()``, on its ``mesh`` (a step factory's
    last line once it has made the mesh): the step carries the mesh's
    ``release``, and so does the exception when ``build`` raises, so that
    ``measure_layout`` frees the groups on every rank at one point whether
    or not this rank's build failed."""
    try:
        run = build()
    except Exception as e:
        if mesh is not None:
            e.release = mesh.release
        raise
    if mesh is not None:
        run.release = mesh.release
    return run


def measure_layout(
    step_factory: Callable[[Layout], Callable[[], None]],
    layout: Layout,
    *,
    warmup: int = 1,
    reps: int = 3,
    device=None,
) -> Tuple[float, Optional[str]]:
    """Build and time the real step for a layout: (mean seconds a step,
    None), or (inf, the exception's text) when the candidate fails to build
    or run (it is skipped, not fatal to the search).

    Over a world (the default group's ranks, more than one) every rank
    calls this for the same layout at the same point. Whether every rank
    built it is agreed before any step runs: a candidate is skipped on
    every rank or on none, with the lowest failing rank's text. The time is
    the longest rank's. The factory makes its mesh before anything that
    can fail on one rank alone, and returns through ``on_mesh``. A step
    that raises on one rank after the build cannot be agreed on: the
    others wait in its collectives.

    The step (and what it holds) is dropped, its mesh's groups released
    (every rank, built or failed) and the device's cache emptied before
    this returns."""
    dev = resolve_device(device)
    world = dist.is_initialized() and dist.get_world_size() > 1
    step, err, release = None, None, None
    try:
        step = step_factory(layout)
        release = getattr(step, "release", None)
    except Exception as e:  # noqa: BLE001 — recorded in the report
        err = f"{type(e).__name__}: {e}"
        release = getattr(e, "release", None)
    try:
        if world:
            err = _agreed_error(err, dev)
        if err is not None:
            return float("inf"), err
        try:
            for _ in range(warmup):
                step()
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            _sync(dev)
            t = (time.perf_counter() - t0) / reps
        except Exception as e:  # noqa: BLE001 — recorded in the report
            return float("inf"), f"{type(e).__name__}: {e}"
        if world:
            t = _world_all(t, dist.ReduceOp.MAX, dev)
        return t, None
    finally:
        step = None
        gc.collect()
        if release is not None:
            release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def _measure_ranked(ranked, cost_of, step_factory, measure_top_k, device, what):
    """Measure the analytically ranked candidates: the top ``measure_top_k``,
    then on until one ran. Returns (best, report); raises when none ran."""
    report = []
    best, best_t = None, float("inf")
    for i, lo in enumerate(ranked):
        if i >= measure_top_k and best is not None:
            break
        t, err = measure_layout(step_factory, lo, device=device)
        entry = {"layout": str(lo), "analytic_s": cost_of(lo), "measured_s": t}
        if err is not None:
            entry["error"] = err
        report.append(entry)
        if t < best_t:
            best, best_t = lo, t
    if best is None:
        raise RuntimeError(f"no {what} candidate ran: " + "; ".join(
            f"{r['layout']}: {r['error']}" for r in report))
    return best, report


def optimize_layout(
    spec: ModelSpec,
    step_factory: Callable[[Layout], Callable[[], None]],
    *,
    n_devices: Optional[int] = None,
    batch_size: int = 8,
    seq_len: int = 128,
    measure_top_k: int = 3,
    machine: Optional[MachineModel] = None,
    device=None,
) -> Tuple[Layout, List[Dict]]:
    """Pick the fastest layout; returns (best, report).

    ``step_factory(layout)`` must return a zero-arg callable running one real
    training or serving step under that layout (with a ``release``
    attribute, a callable, when it holds something to free explicitly; a
    factory that makes a mesh returns through ``on_mesh``). Over more than
    one rank every rank calls this alike (``measure_layout``). Raises when no candidate ran (each report entry
    then holds its ``error``)."""
    n = n_devices or device_count(device)
    dev = search_device(device, n)
    candidates = enumerate_layouts(n, spec, batch_size)
    if not candidates:
        raise ValueError(f"no legal layouts for {n} devices")

    def cost_of(lo):
        return analytic_cost(lo, spec, batch_size, seq_len, machine)

    return _measure_ranked(sorted(candidates, key=cost_of), cost_of, step_factory,
                           measure_top_k, dev, "layout")


def layout_mesh(layout: Layout, device=None):
    """The mesh a Layout describes (``parallel/mesh.make_mesh(data=, pipe=,
    model=)`` over the default group, on ``device``; ``None`` (one device)
    for ``Layout(1, 1, 1)``)."""
    if layout.data * layout.pipe * layout.model == 1:
        return None
    return mesh_lib.make_mesh(data=layout.data, pipe=layout.pipe, model=layout.model,
                              device=device)


def optimize_train_layout(
    spec: ModelSpec,
    params,
    optimizer,
    *,
    batch_size: int,
    seq_len: int,
    loss: str = "sparse_categorical_crossentropy",
    n_devices: Optional[int] = None,
    measure_top_k: int = 3,
    log_fn: Callable[[str], None] = print,
    device=None,
) -> Tuple[Layout, List[Dict]]:
    """Measured layout search for the Trainer (``Trainer(mesh="auto")``):
    a real Trainer per candidate layout (its mesh, stages and microbatches),
    one train step timed on synthetic tokens. On one device the only
    candidate is dp = pp = tp = 1. Each candidate's Trainer trains copies
    of ``params`` (``optimizer`` holds no state), so the search leaves them
    as it found them."""
    import numpy as np

    from flexflow_tpu_torch.training.trainer import Trainer

    n = n_devices or device_count(device)
    dev = search_device(device, n)
    vocab = spec.vocab_size
    rng = np.random.RandomState(0)
    toks = rng.randint(1, vocab, size=(batch_size, seq_len)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)

    def step_factory(layout: Layout):
        mesh = layout_mesh(layout, dev)

        def build():
            tr = Trainer(spec, params, optimizer, mesh=mesh, pipeline_stages=layout.pipe,
                         num_microbatches=layout.num_microbatches, loss=loss, device=dev)

            def run():
                tr.train_step(toks, labels)  # returns the loss as a float: it waits

            return run

        return on_mesh(mesh, build)

    best, report = optimize_layout(
        spec, step_factory, n_devices=n, batch_size=batch_size,
        seq_len=seq_len, measure_top_k=measure_top_k, device=dev,
    )
    if speaks():
        log_fn(f"[auto-parallel] chose layout {best} "
               f"(measured {len(report)} candidates)")
        for r in report:
            log_fn(f"[auto-parallel]   {r['layout']}: "
                   f"analytic {r['analytic_s']:.4g}s measured "
                   f"{r['measured_s']:.4g}s")
    return best, report


def serving_candidates(n: int, spec: ModelSpec, batch_size: int) -> List[Layout]:
    """JAX's serving candidates over ``n`` devices: the TP x PP layouts
    (serving keeps data == 1), then, for each pp = 1 layout whose TP is
    capped below ``n`` (kv_heads / head divisibility), its per-op hybrid
    twin ``Layout(n // tp, 1, tp, hybrid_ffn=True)`` where the FFN divides
    by ``n`` (the leftover factor cuts the FFN only)."""
    candidates = [lo for lo in enumerate_layouts(n, spec, batch_size) if lo.data == 1]
    for lo in list(candidates):
        if lo.pipe != 1 or lo.model >= n:
            continue
        rem = n // lo.model
        if rem > 1 and spec.intermediate_size % (lo.model * rem) == 0:
            candidates.append(Layout(rem, 1, lo.model, hybrid_ffn=True))
    return candidates


def optimize_serving_layout(
    spec: ModelSpec,
    params,
    *,
    batch_size: int,
    max_seq_len: int,
    cache_dtype=None,
    n_devices: Optional[int] = None,
    measure_top_k: int = 2,
    log_fn: Callable[[str], None] = print,
    device=None,
) -> Tuple[Layout, List[Dict]]:
    """Measured serving-layout search: ``serving_candidates``, ranked
    analytically, then timed on one decode step of an ``InferenceEngine``
    under each (``hybrid_ffn`` for a hybrid candidate) or, with pipeline
    stages, a ``PipelineInferenceEngine``. On one device the only candidate
    is ``Layout(1, 1, 1)``."""
    import numpy as np

    n = n_devices or device_count(device)
    dev = search_device(device, n)
    dtype = cache_dtype if cache_dtype is not None else torch.bfloat16

    def step_factory(layout: Layout):
        from flexflow_tpu_torch.ops.sampling import SamplingConfig
        from flexflow_tpu_torch.serving.engine import InferenceEngine
        from flexflow_tpu_torch.serving.pp_engine import PipelineInferenceEngine

        mesh = layout_mesh(layout, dev)
        kw = dict(max_requests_per_batch=batch_size, max_seq_len=max_seq_len,
                  cache_dtype=dtype, device=dev)
        lens = np.full((batch_size,), 8, np.int32)
        toks = np.ones((batch_size,), np.int32)
        scfg = SamplingConfig.greedy(batch_size)  # host values, as a manager passes them

        def build():
            if layout.pipe > 1:
                eng = PipelineInferenceEngine(spec, params, mesh=mesh, **kw)
            else:
                eng = InferenceEngine(spec, params, mesh=mesh, hybrid_ffn=layout.hybrid_ffn,
                                      **kw)

            def run():
                eng.decode(lens, toks, 0, scfg)  # returns host tokens: it waits

            return run

        return on_mesh(mesh, build)

    candidates = serving_candidates(n, spec, batch_size)
    if not candidates:
        raise ValueError(f"no legal serving layouts for {n} devices")

    def cost_of(lo):
        return analytic_cost(lo, spec, batch_size, max_seq_len, train=False)

    best, report = _measure_ranked(sorted(candidates, key=cost_of), cost_of, step_factory,
                                   measure_top_k, dev, "serving layout")
    if speaks():
        log_fn(f"[auto-parallel] serving layout {best} "
               f"(measured {len(report)} candidates)")
    return best, report


# ---------------------------------------------------------------------------
# per-op cost cache + simulated runtime
# ---------------------------------------------------------------------------


class OpCostCache:
    """Measured per-op cost cache: each op is timed on ``device`` (``cuda``
    unless the caller names another) once and memoized by its descriptor.

    Keys are hashable op descriptors (kind, shapes after sharding); values
    are measured seconds. ``measure`` times a thunk on first use (after a
    warm-up, the interval closed by a device synchronize); a thunk that
    raises costs inf.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cache: Dict[tuple, float] = {}

    def __len__(self):
        return len(self._cache)

    def measure(self, key: tuple, thunk: Callable[[], None],
                *, warmup: int = 1, reps: int = 3) -> float:
        if key in self._cache:
            return self._cache[key]
        try:
            for _ in range(warmup):
                thunk()
            _sync(self.device)
            t0 = time.perf_counter()
            for _ in range(reps):
                thunk()
            _sync(self.device)
            t = (time.perf_counter() - t0) / reps
        except Exception:  # noqa: BLE001 — an op that cannot run costs inf, as in JAX
            t = float("inf")
        self._cache[key] = t
        return t

    def get(self, key: tuple) -> Optional[float]:
        return self._cache.get(key)

    def items(self):
        return self._cache.items()


def matmul_thunk(rows: int, k: int, n: int, device: torch.device):
    """A bf16 [rows, k] @ [k, n] ``torch.matmul`` on ``device`` (operands
    made on the first call, the warm-up)."""
    ops = []

    def thunk():
        if not ops:
            ops.extend((torch.ones((max(rows, 1), max(k, 1)), dtype=torch.bfloat16, device=device),
                        torch.ones((max(k, 1), max(n, 1)), dtype=torch.bfloat16, device=device)))
        torch.matmul(*ops)

    return thunk


def attention_thunk(b: int, h: int, s: int, dh: int, device: torch.device):
    """bf16 softmax(q q^T) q over [b, h, s, dh] (the einsum-softmax JAX
    times; operands made on the first call)."""
    ops = []

    def thunk():
        if not ops:
            ops.append(torch.ones((max(b, 1), h, s, dh), dtype=torch.bfloat16, device=device))
        q = ops[0]
        sc = torch.einsum("bhqd,bhkd->bhqk", q, q)
        torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, -1), q)

    return thunk


def _op_descriptors(spec: ModelSpec, layout: Layout, batch_size: int,
                    seq_len: int) -> List[tuple]:
    """Per-layer op list under a layout (shapes AFTER sharding): the unit of
    per-op cost accounting."""
    d = spec.hidden_size
    f = spec.intermediate_size // layout.model
    h = spec.num_heads // layout.model if spec.num_heads % layout.model == 0 \
        else spec.num_heads
    rows = batch_size // layout.data * seq_len
    mlp_mults = 3 if spec.act == "silu_gate" else 2
    ops = [
        ("matmul", rows, d, h * spec.head_dim),                # qkv (q part)
        ("matmul", rows, d, 2 * (spec.num_kv_heads * spec.head_dim
                                 // max(1, layout.model))),    # kv
        ("matmul", rows, h * spec.head_dim, d),                # o proj
        ("attn", rows // max(seq_len, 1), h, seq_len, spec.head_dim),
        ("matmul", rows, d, mlp_mults * f),                    # up/gate
        ("matmul", rows, f, d),                                # down
    ]
    return ops


def simulate_runtime(
    spec: ModelSpec,
    layout: Layout,
    batch_size: int,
    seq_len: int,
    cache: OpCostCache,
    *,
    machine: Optional[MachineModel] = None,
    train: bool = True,
) -> float:
    """Per-op-measured step estimate: the sum of the measured op costs x the
    stage's layers x a forward/backward factor, plus the analytic
    collective and bubble terms. Ops are timed on ``cache.device``."""
    m = machine or MachineModel()
    total = 0.0
    for desc in _op_descriptors(spec, layout, batch_size, seq_len):
        if desc[0] == "matmul":
            _, rows, k, n = desc
            if min(rows, k, n) <= 0:
                continue
            total += cache.measure(desc, matmul_thunk(rows, k, n, cache.device))
        elif desc[0] == "attn":
            _, b, h, s, dh = desc
            if min(b, h, s, dh) <= 0:
                continue
            total += cache.measure(desc, attention_thunk(b, h, s, dh, cache.device))
    total *= spec.num_layers // layout.pipe  # per-stage layer count
    if train:
        total *= 3.0  # fwd + ~2x bwd
    # collective + bubble terms from the analytic machine model
    comm_only = analytic_cost(layout, spec, batch_size, seq_len, m)
    flops_only = analytic_cost(
        layout, spec, batch_size, seq_len,
        MachineModel(chip_flops=m.chip_flops, ici_bw=float("inf"),
                     hbm_bw=m.hbm_bw, hbm_bytes=m.hbm_bytes),
    )
    comm = max(comm_only - flops_only, 0.0)
    bubble = 1.0
    if layout.pipe > 1:
        mb = layout.num_microbatches
        bubble = (mb + layout.pipe - 1) / mb
    return total * bubble + comm


# ---------------------------------------------------------------------------
# memory-constrained search
# ---------------------------------------------------------------------------


def estimate_memory(
    layout: Layout, spec: ModelSpec, batch_size: int, seq_len: int,
    *, train: bool = True,
) -> float:
    """Per-device bytes under a layout: params (+grads+Adam moments when
    training) + activation working set (with pipeline microbatching)."""
    d, f, l, v = (spec.hidden_size, spec.intermediate_size, spec.num_layers,
                  spec.vocab_size)
    mlp_mults = 3 if spec.act == "silu_gate" else 2
    n_params = l * (
        d * (spec.num_heads + 2 * spec.num_kv_heads) * spec.head_dim
        + spec.num_heads * spec.head_dim * d + mlp_mults * d * f
    ) + v * d
    shard = layout.model * layout.pipe
    state_mult = 16 if train else 2  # bf16 params + f32 grads/moments
    param_bytes = n_params * state_mult / shard
    rows = batch_size // layout.data * seq_len
    if layout.pipe > 1:
        rows //= layout.num_microbatches
    act_bytes = rows * d * 2 * (l // layout.pipe) * (4 if train else 1)
    return param_bytes + act_bytes


def memory_constrained_search(
    spec: ModelSpec,
    *,
    n_devices: int,
    batch_size: int,
    seq_len: int,
    memory_budget_bytes: float,
    machine: Optional[MachineModel] = None,
    train: bool = True,
    iters: int = 16,
) -> Tuple[Optional[Layout], List[Dict]]:
    """Best layout whose per-device memory fits the budget.

    Bisects a Lagrange multiplier ``lambda`` on the combined objective
    ``run_time + lambda * memory`` until the optimum satisfies the budget:
    lambda rises while the optimum is over budget, falls otherwise. The
    returned layout is the fastest one meeting the constraint (None if no
    layout fits).
    """
    candidates = enumerate_layouts(n_devices, spec, batch_size)
    if not candidates:
        return None, []
    mems = {lo: estimate_memory(lo, spec, batch_size, seq_len, train=train)
            for lo in candidates}
    runts = {lo: analytic_cost(lo, spec, batch_size, seq_len, machine)
             for lo in candidates}
    report = [
        {"layout": str(lo), "analytic_s": runts[lo], "mem_gb": mems[lo] / 1e9}
        for lo in candidates
    ]
    feasible = [lo for lo in candidates if mems[lo] <= memory_budget_bytes]
    if not feasible:
        return None, report
    lam_lo, lam_hi = 0.0, 1.0
    # grow lambda until the combined optimum is feasible
    for _ in range(iters):
        best = min(candidates, key=lambda lo: runts[lo] + lam_hi * mems[lo])
        if mems[best] <= memory_budget_bytes:
            break
        lam_hi *= 8.0
    # bisect the threshold lambda
    for _ in range(iters):
        lam = 0.5 * (lam_lo + lam_hi)
        best = min(candidates, key=lambda lo: runts[lo] + lam * mems[lo])
        if mems[best] <= memory_budget_bytes:
            lam_hi = lam
        else:
            lam_lo = lam
    best = min(candidates, key=lambda lo: runts[lo] + lam_hi * mems[lo])
    if mems[best] > memory_budget_bytes:
        best = min(feasible, key=lambda lo: runts[lo])
    return best, report
