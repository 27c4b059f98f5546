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
- The search places on one device: ``layout_mesh`` gives ``None`` for
  ``Layout(1, 1, 1)`` and refuses any other layout, and
  ``optimize_train_layout`` / ``optimize_serving_layout`` refuse more than
  one device before measuring anything (the search over a mesh, ROADMAP
  A11c). The meshes themselves are in the port (``parallel/mesh.make_mesh``:
  serving, and training with pipeline stages too). Without
  ``n_devices`` they count the CUDA devices for a CUDA device and one for
  the CPU.
- A candidate that fails to build or run is skipped, as in JAX, but the
  exception's text goes into the report; when no candidate ran the search
  raises with those texts instead of returning nothing (or, for serving,
  a layout that never ran).
- Timed intervals are closed by ``torch.cuda.synchronize()`` on a CUDA
  device; times are seconds, as in JAX.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.device import resolve_device
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
    """The devices a search may place on: the CUDA devices for a CUDA
    device, one for the CPU."""
    dev = resolve_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def refuse_mesh(n_devices: int, what: str, serving: bool = False) -> None:
    """The search places on one device. Over more, serving and training
    have their meshes (pass the degrees, or ``Trainer(mesh=make_mesh(...))``)
    but not the search over them (A11c)."""
    if n_devices > 1:
        if serving:
            raise NotImplementedError(
                f"{what} over {n_devices} devices: the serving mesh (ROADMAP.md Queue A, A8a) "
                "is in the port (pass tensor_parallelism_degree / data_parallelism_degree), "
                "the layout search on it (A11c) is not yet")
        raise NotImplementedError(
            f"{what} over {n_devices} devices: the training mesh is in the port (pass "
            "mesh=parallel.mesh.make_mesh(data=, model=)), the layout search on it (ROADMAP.md "
            "Queue A, A11c) is not yet")


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
    or run (it is skipped, not fatal to the search)."""
    dev = resolve_device(device)
    try:
        step = step_factory(layout)
        for _ in range(warmup):
            step()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        _sync(dev)
        return (time.perf_counter() - t0) / reps, None
    except Exception as e:  # noqa: BLE001 — recorded in the report
        return float("inf"), f"{type(e).__name__}: {e}"


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
    training or serving step under that layout. Raises when no candidate
    ran (each report entry then holds its ``error``)."""
    n = n_devices or device_count(device)
    candidates = enumerate_layouts(n, spec, batch_size)
    if not candidates:
        raise ValueError(f"no legal layouts for {n} devices")

    def cost_of(lo):
        return analytic_cost(lo, spec, batch_size, seq_len, machine)

    return _measure_ranked(sorted(candidates, key=cost_of), cost_of, step_factory,
                           measure_top_k, device, "layout")


def layout_mesh(layout: Layout):
    """The mesh a Layout describes: ``None`` (one device) for
    ``Layout(1, 1, 1)``; any other layout is a result of the search over a
    mesh, which the port does not run yet."""
    if (layout.data, layout.pipe, layout.model) == (1, 1, 1) and not layout.hybrid_ffn:
        return None
    raise NotImplementedError(
        f"layout {layout}: training under a searched layout over more than one device needs "
        "the search on a mesh (ROADMAP.md Queue A, A11c), which is not in the port yet")


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
    a real Trainer per candidate layout, one train step timed on synthetic
    tokens. On one device the only candidate is dp = pp = tp = 1."""
    import numpy as np

    from flexflow_tpu_torch.training.trainer import Trainer

    dev = resolve_device(device)
    n = n_devices or device_count(dev)
    refuse_mesh(n, "the training layout search")
    vocab = spec.vocab_size
    rng = np.random.RandomState(0)
    toks = rng.randint(1, vocab, size=(batch_size, seq_len)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)

    def step_factory(layout: Layout):
        mesh = layout_mesh(layout)
        tr = Trainer(spec, params, optimizer, mesh=mesh,
                     pipeline_stages=layout.pipe,
                     num_microbatches=layout.num_microbatches, loss=loss, device=dev)

        def run():
            tr.train_step(toks, labels)  # returns the loss as a float: it waits

        return run

    best, report = optimize_layout(
        spec, step_factory, n_devices=n, batch_size=batch_size,
        seq_len=seq_len, measure_top_k=measure_top_k, device=dev,
    )
    log_fn(f"[auto-parallel] chose layout {best} "
           f"(measured {len(report)} candidates)")
    for r in report:
        log_fn(f"[auto-parallel]   {r['layout']}: "
               f"analytic {r['analytic_s']:.4g}s measured "
               f"{r['measured_s']:.4g}s")
    return best, report


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
    """Measured serving-layout search: TP x PP candidates (serving keeps
    data == 1), ranked analytically, then timed on one decode step of an
    ``InferenceEngine``. On one device the only candidate is
    ``Layout(1, 1, 1)``."""
    import numpy as np

    dev = resolve_device(device)
    n = n_devices or device_count(dev)
    refuse_mesh(n, "the serving layout search", serving=True)
    dtype = cache_dtype if cache_dtype is not None else torch.bfloat16

    def step_factory(layout: Layout):
        from flexflow_tpu_torch.ops.sampling import SamplingConfig
        from flexflow_tpu_torch.serving.engine import InferenceEngine

        layout_mesh(layout)
        eng = InferenceEngine(spec, params, max_requests_per_batch=batch_size,
                              max_seq_len=max_seq_len, cache_dtype=dtype, device=dev)
        lens = np.full((batch_size,), 8, np.int32)
        toks = np.ones((batch_size,), np.int32)
        scfg = SamplingConfig.greedy(batch_size, dev)

        def run():
            eng.decode(lens, toks, 0, scfg)  # returns host tokens: it waits

        return run

    candidates = [
        lo for lo in enumerate_layouts(n, spec, batch_size) if lo.data == 1
    ]
    # per-op hybrid candidates: when uniform TP is capped below the device
    # count (kv_heads / head divisibility), the leftover factor shards the
    # FFN only
    for lo in list(candidates):
        if lo.pipe != 1 or lo.model >= n:
            continue
        rem = n // lo.model
        if rem > 1 and spec.intermediate_size % (lo.model * rem) == 0:
            candidates.append(Layout(rem, 1, lo.model, hybrid_ffn=True))
    if not candidates:
        raise ValueError(f"no legal serving layouts for {n} devices")

    def cost_of(lo):
        return analytic_cost(lo, spec, batch_size, max_seq_len, train=False)

    best, report = _measure_ranked(sorted(candidates, key=cost_of), cost_of, step_factory,
                                   measure_top_k, dev, "serving layout")
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
