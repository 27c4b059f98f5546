"""Graph substitutions: pattern rewrites over the FFModel DAG (the port's own
copy of ``flexflow_tpu/ffmodel/substitutions.py``, pure Python over the node
list, so the same builder calls give the same rewritten graph and report in
both packages).

Rules (each a ``(name, matcher)`` applied to fixpoint):
- ``fuse-activation``: dense/conv2d/conv2d_transpose followed by its only
  consumer relu/sigmoid/tanh/gelu/elu/silu -> folded into the op's epilogue.
- ``fuse-bn-relu``: batch_norm + relu -> batch_norm(relu=True).
- ``eliminate-identity``: identity nodes drop out.
- ``collapse-reshape``: reshape(reshape(x)) -> reshape(x).
- ``eliminate-split-concat``: concat(split(x)) over the same axis in
  original order -> x.
- dead-code elimination from the output root.

``optimize_graph`` runs inside ``FFModel.compile`` under ``config.fusion``
(the reference's --fusion flag); ``match_sites`` lists single rewrites, the
unit of the joint rewrite x placement search (``parallel/joint.py``,
``compile(auto_parallel=True)``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Set, Tuple

ALL_RULES = frozenset({
    "fuse-activation",
    "fuse-bn-relu",
    "eliminate-identity",
    "collapse-reshape",
    "eliminate-split-concat",
})


def load_rules(path: str) -> Set[str]:
    """Load a substitution rule file (--substitution-json). Format::

        {"rules": ["fuse-activation", ...]}        # enable exactly these
        {"disable": ["collapse-reshape", ...]}     # all built-ins minus

    The file selects among the built-in rules; it describes no new pattern.
    """
    with open(path) as f:
        doc = json.load(f)
    if "rules" in doc:
        rules = set(doc["rules"])
    elif "disable" in doc:
        rules = set(ALL_RULES) - set(doc["disable"])
    else:
        raise ValueError(f"{path}: expected a 'rules' or 'disable' key")
    unknown = rules - ALL_RULES
    if unknown:
        raise ValueError(f"{path}: unknown substitution rules {sorted(unknown)}")
    return rules


def match_sites(nodes, input_ids, rules: Optional[Set[str]] = None):
    """Applicable single-rewrite sites [(rule, node_id)] on the current graph.

    Each site can be applied alone via ``optimize_graph(..., only_site=(rule,
    j))``, so a layout-aware cost can accept or reject it individually.
    """
    if rules is None:
        rules = ALL_RULES
    cons: Dict[int, List[int]] = {i: [] for i in range(len(nodes))}
    for j, n in enumerate(nodes):
        for t in n.inputs:
            cons[t.node].append(j)
    ACT_OPS = {"relu", "sigmoid", "tanh", "gelu", "elu", "silu"}
    FUSABLE = {"dense", "conv2d", "conv2d_transpose"}
    sites = []
    for j, n in enumerate(nodes):
        srcs = [(t.node, t.index) for t in n.inputs]
        if n.op == "identity" and "eliminate-identity" in rules:
            sites.append(("eliminate-identity", j))
        if n.op in ACT_OPS and len(srcs) == 1:
            i, oi = srcs[0]
            prod = nodes[i]
            if (oi == 0 and prod.op in FUSABLE and "fuse-activation" in rules
                    and prod.attrs.get("activation") is None
                    and cons.get(i) == [j]):
                sites.append(("fuse-activation", j))
            if (oi == 0 and n.op == "relu" and prod.op == "batch_norm"
                    and "fuse-bn-relu" in rules and not prod.attrs.get("relu")
                    and cons.get(i) == [j]):
                sites.append(("fuse-bn-relu", j))
        if n.op == "reshape" and len(srcs) == 1 and "collapse-reshape" in rules:
            i, oi = srcs[0]
            if oi == 0 and nodes[i].op == "reshape" and cons.get(i) == [j]:
                sites.append(("collapse-reshape", j))
        if n.op == "concat" and "eliminate-split-concat" in rules:
            src_nodes = {s[0] for s in srcs}
            if len(src_nodes) == 1:
                i = next(iter(src_nodes))
                prod = nodes[i]
                if (prod.op == "split"
                        and prod.attrs.get("axis") == n.attrs.get("axis")
                        and [s[1] for s in srcs]
                        == list(range(len(prod.out_shapes)))
                        and len(srcs) == len(prod.out_shapes)):
                    sites.append(("eliminate-split-concat", j))
    return sites


def optimize_graph(nodes, input_ids, rules: Optional[Set[str]] = None,
                   only_site: Optional[Tuple[str, int]] = None):
    """Rewrite the node list; returns (new_nodes, new_input_ids, report).

    ``nodes`` are ``_Node`` records whose ``inputs`` hold Tensors referencing
    (node_id, out_index); node ids are list positions. Parameterized nodes
    keep their names (params/state/regularizers are name-keyed).

    ``only_site=(rule, node_id)``: apply exactly that one rewrite (single
    step of the joint search) instead of all rules to fixpoint.
    """
    if rules is None:
        rules = ALL_RULES
    if only_site is not None:
        rules = {only_site[0]}
    nodes = [dataclasses.replace(n, inputs=list(n.inputs),
                                 attrs=dict(n.attrs)) for n in nodes]
    redirect: Dict[Tuple[int, int], Tuple[int, int]] = {}
    deleted = set()
    report: Dict[str, int] = {}

    def resolve(ref):
        while ref in redirect:
            ref = redirect[ref]
        return ref

    def consumers():
        out: Dict[int, List[int]] = {i: [] for i in range(len(nodes))}
        for j, n in enumerate(nodes):
            if j in deleted:
                continue
            for t in n.inputs:
                src = resolve((t.node, t.index))[0]
                out[src].append(j)
        return out

    ACT_OPS = {"relu", "sigmoid", "tanh", "gelu", "elu", "silu"}
    FUSABLE = {"dense", "conv2d", "conv2d_transpose"}

    changed = True
    rounds = 0
    max_rounds = 1 if only_site is not None else 10
    while changed and rounds < max_rounds:
        changed = False
        rounds += 1
        cons = consumers()
        for j, n in enumerate(nodes):
            if j in deleted:
                continue
            if only_site is not None and j != only_site[1]:
                continue
            srcs = [resolve((t.node, t.index)) for t in n.inputs]

            if n.op == "identity" and "eliminate-identity" in rules:
                redirect[(j, 0)] = srcs[0]
                deleted.add(j)
                report["eliminate-identity"] = (
                    report.get("eliminate-identity", 0) + 1)
                changed = True
                continue

            if n.op in ACT_OPS and len(srcs) == 1:
                i, oi = srcs[0]
                prod = nodes[i]
                if (oi == 0 and prod.op in FUSABLE
                        and "fuse-activation" in rules
                        and prod.attrs.get("activation") is None
                        and cons.get(i) == [j]):
                    prod.attrs["activation"] = n.op
                    redirect[(j, 0)] = (i, 0)
                    deleted.add(j)
                    report["fuse-activation"] = (
                        report.get("fuse-activation", 0) + 1)
                    changed = True
                    continue
                if (oi == 0 and n.op == "relu" and prod.op == "batch_norm"
                        and "fuse-bn-relu" in rules
                        and not prod.attrs.get("relu")
                        and cons.get(i) == [j]):
                    prod.attrs["relu"] = True
                    redirect[(j, 0)] = (i, 0)
                    deleted.add(j)
                    report["fuse-bn-relu"] = report.get("fuse-bn-relu", 0) + 1
                    changed = True
                    continue

            if (n.op == "reshape" and len(srcs) == 1
                    and "collapse-reshape" in rules):
                i, oi = srcs[0]
                prod = nodes[i]
                if oi == 0 and prod.op == "reshape" and cons.get(i) == [j]:
                    # skip the inner reshape entirely
                    n.inputs = list(prod.inputs)
                    deleted.add(i)
                    report["collapse-reshape"] = (
                        report.get("collapse-reshape", 0) + 1)
                    changed = True
                    continue

            if n.op == "concat" and "eliminate-split-concat" in rules:
                src_nodes = {s[0] for s in srcs}
                if len(src_nodes) == 1:
                    i = next(iter(src_nodes))
                    prod = nodes[i]
                    if (prod.op == "split"
                            and prod.attrs.get("axis") == n.attrs.get("axis")
                            and [s[1] for s in srcs]
                            == list(range(len(prod.out_shapes)))
                            and len(srcs) == len(prod.out_shapes)):
                        redirect[(j, 0)] = resolve(
                            (prod.inputs[0].node, prod.inputs[0].index))
                        deleted.add(j)
                        report["eliminate-split-concat"] = (
                            report.get("eliminate-split-concat", 0) + 1)
                        changed = True
                        continue

    # --- dead-code elimination from the output root (last live node) ---
    root = resolve((len(nodes) - 1, 0))[0]
    live = set(input_ids)
    stack = [root]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        live.add(i)
        for t in nodes[i].inputs:
            stack.append(resolve((t.node, t.index))[0])
    dropped = [i for i in range(len(nodes))
               if i not in live or i in deleted]
    if dropped:
        report["dead-code"] = sum(
            1 for i in dropped if i not in deleted)

    # --- rebuild with remapped ids (graph order preserved; root last) ---
    keep = [i for i in range(len(nodes)) if i in live and i not in deleted]
    # the apply() executor returns the LAST node's output: move the root to
    # the end (everything after it is dead and already dropped)
    if keep and keep[-1] != root:
        keep = [i for i in keep if i != root] + [root]
    idmap = {old: new for new, old in enumerate(keep)}
    new_nodes = []
    for old in keep:
        n = nodes[old]
        new_inputs = []
        for t in n.inputs:
            src, oi = resolve((t.node, t.index))
            new_inputs.append(dataclasses.replace(t, node=idmap[src], index=oi))
        new_nodes.append(dataclasses.replace(n, inputs=new_inputs))
    new_input_ids = [idmap[i] for i in input_ids if i in idmap]
    return new_nodes, new_input_ids, report
