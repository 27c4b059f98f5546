"""Joint graph-rewrite x placement search (port of
``flexflow_tpu/parallel/joint.py``).

A rewrite's value depends on the placements it enables or forbids, and the
other way round, so the two are searched together, in three tiers:

- ``layout_dp``: per-op machine views over one FIXED graph: a DP over the
  node list in topological order tracking the sharding state of each
  node's output (R replicated / B batch-sharded / F feature-sharded /
  P partial sums) with per-edge resharding costs.
- ``sequence_optimize``: graphs larger than ``base_threshold`` split at a
  bottleneck node (a single-output articulation point); the boundary's
  sharding state is enumerated and both halves recurse, memoized by
  (graph hash, boundary states).
- ``joint_optimize``: best-first search over single rewrite applications
  (``ffmodel.substitutions.match_sites`` / ``optimize_graph(only_site=)``),
  each candidate graph costed by the layout DP, pruned by a budget of
  expansions and an ``alpha`` bound on the best cost.

The interplay is real: a dense with a FUSED activation epilogue cannot take
the row-parallel view (the epilogue would apply to partial sums before
their reduction), so fusing can forbid the best placement.

Costs: per-op compute from an analytic FLOPs/bytes model, or a MEASURED
``auto.OpCostCache`` (bf16 matmuls timed at their SHARDED shapes on the
cache's device); resharding from the ``MachineModel``'s link terms.
``pipe > 1`` balances pipeline stages over the chosen graph's per-op costs
(``pipeline.balance_stages``). The arithmetic follows JAX's in the same
order, so the same graph gets the same costs.

The nodes are the port's FFModel ``_Node`` / ``Tensor`` dataclasses
(``ffmodel/model.py``).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from flexflow_tpu_torch.parallel.auto import MachineModel, OpCostCache, matmul_thunk

# sharding states of a tensor flowing along an edge (1-D mesh of degree n):
#   R  replicated          B  batch(leading)-dim sharded
#   F  last-dim sharded    P  partial sums over the mesh (reduction pending)
STATES = ("R", "B", "F", "P")

# FFModel's node op strings (e.g. subtract() makes op "sub")
_ELEMENTWISE = {
    "relu", "sigmoid", "tanh", "gelu", "elu", "silu", "identity",
    "dropout", "exp", "log", "sin", "cos", "sqrt", "rsqrt", "pow",
    "leaky_relu", "clamp", "softplus", "mish", "hardswish", "hardsigmoid",
    "scalar_add", "scalar_sub", "scalar_mul", "scalar_div",
}
_BINARY = {"add", "sub", "mul", "div", "max", "min", "where"}
_LASTDIM = {"softmax", "layer_norm", "rms_norm", "mean", "reduce_sum",
            "argmax", "top_k"}


def _nbytes(shape, dtype=None) -> float:
    return float(np.prod(shape)) * 4.0 if shape else 4.0


def reshard_cost(src: str, dst: str, nbytes: float, n: int,
                 m: MachineModel) -> float:
    """Link cost of moving a tensor between sharding states (the collective
    the transition implies)."""
    if src == dst:
        return 0.0
    ring = nbytes * (n - 1) / n / m.ici_bw
    if src == "P":
        # reduce (2x ring traffic) to R, then slice to the destination
        return 2 * ring
    if src in ("F", "B") and dst in ("R",):
        return ring  # all-gather
    if src == "R" and dst in ("B", "F"):
        return 0.0  # local slice
    if src in ("F", "B") and dst in ("F", "B"):
        return ring  # all-to-all-ish reshard
    return 2 * ring  # conservative default


@dataclasses.dataclass(frozen=True)
class View:
    """One per-op machine view: required input state -> output state, with
    the op's compute sharded ``shard``-ways."""

    name: str
    in_state: str
    out_state: str
    shard: int


def op_views(node, n: int, batch: int) -> List[View]:
    """Legal machine views for a node on an n-way 1-D mesh.

    A dense whose activation is fused cannot produce partial sums (row
    view): the epilogue would evaluate on partials before their reduction.
    """
    op = node.op
    out = node.out_shapes[0]
    batch_ok = batch % n == 0 and batch >= n
    views = [View("rep", "R", "R", 1)]
    if batch_ok:
        views.append(View("dp", "B", "B", n))
    if op == "dense":
        din = node.inputs[0].shape[-1] if node.inputs else 0
        dout = node.attrs.get("out_dim", out[-1] if out else 0)
        if dout % n == 0 and dout >= n:
            views.append(View("col", "R", "F", n))
        if (din % n == 0 and din >= n
                and node.attrs.get("activation") is None):
            views.append(View("row", "F", "P", n))
    elif op in _ELEMENTWISE or op in _BINARY:
        if out and out[-1] % n == 0 and out[-1] >= n:
            views.append(View("feat", "F", "F", n))
    elif op in ("reshape", "flatten"):
        ins = node.inputs[0].shape if node.inputs else ()
        if ins and out and ins[-1] == out[-1] and out[-1] % n == 0:
            views.append(View("feat", "F", "F", n))
    # _LASTDIM / concat / split / conv / unknown: R or B only (they need the
    # full last dim locally, or there is no sharding rule for them)
    return views


def op_cost(node, view: View, n: int, m: MachineModel,
            cache: Optional[OpCostCache] = None) -> float:
    """Per-op step cost under a view: measured at the SHARDED shape when a
    cache is given, else analytic FLOPs + bytes."""
    out = node.out_shapes[0] if node.out_shapes else ()
    if node.op == "dense":
        din = node.inputs[0].shape[-1] if node.inputs else 1
        rows = float(np.prod(out[:-1])) if len(out) > 1 else 1.0
        dout = out[-1] if out else 1
        if view.name == "dp":
            rows /= view.shard
        elif view.name == "col":
            dout //= view.shard
        elif view.name == "row":
            din //= view.shard
        if cache is not None:
            key = ("matmul", int(rows), int(din), int(dout))
            return cache.measure(key, matmul_thunk(int(rows), int(din), int(dout),
                                                   cache.device))
        flops = 2.0 * rows * din * dout
        return flops / m.chip_flops + (din * dout * 2) / m.hbm_bw
    # elementwise / everything else: one HBM pass over the output
    nbytes = _nbytes(out) / view.shard
    if node.op in ("input", "constant"):
        return 0.0
    return 2 * nbytes / m.hbm_bw


# ---------------------------------------------------------------------------
# tier 1: per-op view DP over one fixed graph
# ---------------------------------------------------------------------------


def layout_dp(
    nodes,
    input_ids: Sequence[int],
    *,
    n: int,
    batch: int,
    machine: Optional[MachineModel] = None,
    cache: Optional[OpCostCache] = None,
    in_state: str = "R",
    out_state: str = "R",
) -> Tuple[float, Dict[int, View]]:
    """Optimal per-op views for a fixed graph; returns (cost, {node: View}).

    DP in topological order (node ids are topological by construction) over
    the sharding state of each node's output. Exact on trees; a shared
    producer counts once per consumer (conservative). ``in_state`` /
    ``out_state`` pin the graph's boundary states (the sequence split's
    recursion uses them).
    """
    m = machine or MachineModel()
    best: Dict[int, Dict[str, Tuple[float, View, Tuple[str, ...]]]] = {}
    for j, node in enumerate(nodes):
        table: Dict[str, Tuple[float, View, Tuple[str, ...]]] = {}
        if node.op in ("input", "constant") or j in input_ids:
            st = in_state if j in input_ids else "R"
            table[st] = (0.0, View("src", st, st, 1), ())
            # a replicated source can also be consumed sharded for free
            for s2 in ("B", "F"):
                if st == "R":
                    table[s2] = (0.0, View("src", "R", s2, 1), ())
            best[j] = table
            continue
        for view in op_views(node, n, batch):
            cost = op_cost(node, view, n, m, cache)
            in_states = []
            feasible = True
            for t in node.inputs:
                ptab = best.get(t.node)
                if not ptab:
                    feasible = False
                    break
                nb = _nbytes(t.shape)
                cands = [
                    (pc + reshard_cost(ps, view.in_state, nb, n, m), ps)
                    for ps, (pc, _v, _b) in ptab.items()
                ]
                c, ps = min(cands)
                cost += c
                in_states.append(ps)
            if not feasible:
                continue
            cur = table.get(view.out_state)
            if cur is None or cost < cur[0]:
                table[view.out_state] = (cost, view, tuple(in_states))
        if not table:  # no legal view (rep always is)
            table["R"] = (float("inf"), View("rep", "R", "R", 1), ())
        best[j] = table

    root = len(nodes) - 1
    rtab = best[root]
    nb = _nbytes(nodes[root].out_shapes[0] if nodes[root].out_shapes else ())
    total, final_state = min(
        (c + reshard_cost(s, out_state, nb, n, m), s)
        for s, (c, _v, _b) in rtab.items()
    )
    # backtrack the view choices
    views: Dict[int, View] = {}
    want: Dict[int, str] = {root: final_state}
    for j in range(root, -1, -1):
        if j not in want:
            continue
        c, v, in_states = best[j][want[j]]
        views[j] = v
        for t, s in zip(nodes[j].inputs, in_states):
            # a producer feeding several consumers keeps the first-demanded
            # state
            want.setdefault(t.node, s)
    return total, views


# ---------------------------------------------------------------------------
# tier 2: sequence-split recursion
# ---------------------------------------------------------------------------


def find_bottleneck(nodes, input_ids) -> Optional[int]:
    """A mid-graph node through whose output EVERY earlier->later edge
    passes (a single-output articulation split point). Returns its id or
    None."""
    nmax = len(nodes)
    lo, hi = nmax // 4, 3 * nmax // 4
    candidates = []
    for j in range(nmax - 1):
        crossing = [
            (t.node, c)
            for c in range(j + 1, nmax)
            for t in nodes[c].inputs
            if t.node <= j and nodes[t.node].op not in ("input", "constant")
        ]
        if crossing and all(src == j for src, _ in crossing):
            candidates.append(j)
    mid = [j for j in candidates if lo <= j <= hi]
    pool = mid or candidates
    return pool[len(pool) // 2] if pool else None


def sequence_optimize(
    nodes,
    input_ids,
    *,
    n: int,
    batch: int,
    machine: Optional[MachineModel] = None,
    cache: Optional[OpCostCache] = None,
    in_state: str = "R",
    out_state: str = "R",
    base_threshold: int = 24,
    _memo: Optional[Dict] = None,
) -> Tuple[float, Dict[int, View]]:
    """Layout cost with a DP over sequence splits: split at a bottleneck,
    enumerate the boundary's sharding state, recurse on both halves
    (memoized). The flat DP at or below ``base_threshold`` nodes."""
    memo = _memo if _memo is not None else {}
    # hash by structure, not identity, so repeated subgraphs share entries
    key = (_graph_hash(nodes), in_state, out_state)
    if key in memo:
        return memo[key]
    if len(nodes) <= base_threshold:
        out = layout_dp(nodes, input_ids, n=n, batch=batch, machine=machine,
                        cache=cache, in_state=in_state, out_state=out_state)
        memo[key] = out
        return out
    b = find_bottleneck(nodes, input_ids)
    if b is None:
        out = layout_dp(nodes, input_ids, n=n, batch=batch, machine=machine,
                        cache=cache, in_state=in_state, out_state=out_state)
        memo[key] = out
        return out
    pre, pre_inputs = nodes[: b + 1], [i for i in input_ids if i <= b]
    # post graph: the bottleneck's output becomes a pseudo-input; input /
    # constant nodes referenced across the split are carried over
    # (find_bottleneck only guarantees that non-source crossing edges all
    # come from b)
    post = []
    remap = {b: 0}
    post.append(dataclasses.replace(
        nodes[b], op="input", inputs=[], attrs={}, name=nodes[b].name))
    for c in range(b + 1, len(nodes)):
        nd = nodes[c]
        for t in nd.inputs:
            if (t.node < b and t.node not in remap
                    and nodes[t.node].op in ("input", "constant")):
                remap[t.node] = len(post)
                post.append(nodes[t.node])
        new_inputs = [dataclasses.replace(t, node=remap.get(t.node, 0))
                      for t in nd.inputs]
        remap[c] = len(post)
        post.append(dataclasses.replace(nd, inputs=new_inputs))
    best_cost, best_views = float("inf"), {}
    for bs in ("R", "B", "F"):
        c1, v1 = sequence_optimize(
            pre, pre_inputs, n=n, batch=batch, machine=machine, cache=cache,
            in_state=in_state, out_state=bs, base_threshold=base_threshold,
            _memo=memo)
        c2, v2 = sequence_optimize(
            post, [0], n=n, batch=batch, machine=machine, cache=cache,
            in_state=bs, out_state=out_state, base_threshold=base_threshold,
            _memo=memo)
        if c1 + c2 < best_cost:
            views = dict(v1)
            inv = {v: k for k, v in remap.items()}
            # post node 0 is the pseudo-input COPY of the bottleneck: its
            # 'src' view must not overwrite the first half's real placement
            views.update({inv[j]: v for j, v in v2.items()
                          if j in inv and inv[j] != b})
            best_cost, best_views = c1 + c2, views
    memo[key] = (best_cost, best_views)
    return best_cost, best_views


def _graph_hash(nodes) -> int:
    return hash(tuple(
        (n.op, tuple((t.node, t.index) for t in n.inputs),
         tuple(n.out_shapes[0]) if n.out_shapes else (),
         n.attrs.get("activation"), n.attrs.get("out_dim"))
        for n in nodes
    ))


# ---------------------------------------------------------------------------
# tier 3: joint best-first search over rewrites x layouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JointPlan:
    nodes: list
    input_ids: list
    views: Dict[int, View]
    cost: float
    applied: List[Tuple[str, int]]
    stages: Optional[List[int]] = None  # per-stage node counts (pipe > 1)
    report: List[dict] = dataclasses.field(default_factory=list)


def joint_optimize(
    nodes,
    input_ids,
    *,
    n_devices: int,
    batch: int,
    rules: Optional[Set[str]] = None,
    machine: Optional[MachineModel] = None,
    cache: Optional[OpCostCache] = None,
    budget: int = 32,
    alpha: float = 1.2,
    pipe: int = 1,
    base_threshold: int = 24,
    log_fn: Callable[[str], None] = lambda *a: None,
) -> JointPlan:
    """Best-first joint search: expand one rewrite application at a time,
    cost every candidate graph with the per-op view DP, keep the best
    (graph, views) pair; at most ``budget`` expansions, and a candidate
    above ``alpha`` x the best cost is not expanded. ``pipe > 1`` also
    balances pipeline stages over the winning graph's per-op costs."""
    from flexflow_tpu_torch.ffmodel.substitutions import match_sites, optimize_graph

    m = machine or MachineModel()
    # ONE memo shared across every candidate graph: candidates differ by a
    # single rewrite, so almost all (subgraph hash, boundary states) DP
    # entries recur
    memo: Dict = {}

    def evaluate(ns, ins):
        return sequence_optimize(
            ns, ins, n=n_devices, batch=batch, machine=m, cache=cache,
            base_threshold=base_threshold, _memo=memo)

    c0, v0 = evaluate(nodes, input_ids)
    best = JointPlan(nodes, list(input_ids), v0, c0, [])
    seen = {_graph_hash(nodes)}
    counter = 0
    heap = [(c0, counter, nodes, list(input_ids), [])]
    expansions = 0
    report = [{"applied": [], "cost": c0}]
    while heap and expansions < budget:
        cost, _cnt, cur_nodes, cur_inputs, applied = heapq.heappop(heap)
        if cost > alpha * best.cost:
            continue  # alpha pruning
        expansions += 1
        for site in match_sites(cur_nodes, cur_inputs, rules):
            new_nodes, new_inputs, _rep = optimize_graph(
                cur_nodes, cur_inputs, rules, only_site=site)
            h = _graph_hash(new_nodes)
            if h in seen:
                continue
            seen.add(h)
            c, v = evaluate(new_nodes, new_inputs)
            report.append({"applied": applied + [site], "cost": c})
            if c < best.cost:
                best = JointPlan(new_nodes, new_inputs, v, c,
                                 applied + [site])
            if c <= alpha * best.cost:
                counter += 1
                heapq.heappush(
                    heap, (c, counter, new_nodes, new_inputs,
                           applied + [site]))
    best.report = report
    if pipe > 1:
        from flexflow_tpu_torch.parallel.pipeline import balance_stages

        costs = [
            op_cost(nd, best.views.get(j, View("rep", "R", "R", 1)),
                    n_devices, m, cache)
            for j, nd in enumerate(best.nodes)
        ]
        best.stages = balance_stages(costs, pipe)
    log_fn(f"[joint] {len(report)} candidates, best cost {best.cost:.4g}s "
           f"after {best.applied or 'no rewrites'}; views: "
           f"{ {j: v.name for j, v in best.views.items() if v.name not in ('rep', 'src')} }")
    return best
