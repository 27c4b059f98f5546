"""A (data, model) cut of an ``FFModel`` graph over ``torch.distributed``
ranks: what ``compile(auto_parallel=True)``'s measured search chooses over
more than one rank, and how the executor runs it (JAX:
``FFModel._auto_parallelize`` places the parameters by ``PartitionSpec``s
and GSPMD partitions its jitted step).

A rank holds its slice of each cut leaf and every other leaf whole:

- a column cut of a dense's or an embedding's 2-D ``w`` over the mesh's
  ``model`` ranks (JAX's ``P(None, "model")``), and of a dense's ``b``
  with it (JAX keeps ``b`` whole under its uniform specs: the same numbers,
  another placement). The op computes its columns and gathers them
  (``gather_from_model``); its input enters through ``copy_to_model``,
  whose backward sums the input's gradient over ``model``.
- a row cut of a dense's ``w`` (``P("model", None)``, the joint plan's
  ``row`` view): the op takes its rows of the input's features, sums the
  partial products over ``model`` (``reduce_from_model``), then adds the
  bias and applies the activation.

Every other op runs on whole activations, so every model rank holds the
same values and the same loss. A training step under ``data > 1`` runs on
the data rank's rows of the batch; the loss to differentiate is the
rank's sum over the global count, and every gradient is summed over
``data`` (``parallel/mesh.all_reduce_grads``). A graph whose ops mix the
batch's rows (batch norm in training, a reduction, reshape, transpose,
concat, slice, pad, gather or softmax over the batch axis) cannot be cut
on ``data`` this way: such a candidate fails to build (``mixed_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.ops import nn as nn_ops
from flexflow_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_reduce_grads,
                                              copy_to_model, gather_from_model,
                                              reduce_from_model)
from flexflow_tpu_torch.training.losses import LOSS_PARTS


def uniform_views(params: Dict[str, Dict[str, torch.Tensor]], tp: int) -> Dict[str, Dict[str, int]]:
    """JAX's uniform specs at ``tp``: every 2-D ``w`` whose last dimension
    divides by ``tp`` cut on its columns (its node's ``b`` with it).
    {node: {leaf: the dimension it is cut on}}."""
    views = {}
    for name, leaves in params.items():
        w = leaves.get("w")
        if tp > 1 and w is not None and w.dim() == 2 and w.shape[-1] % tp == 0:
            views[name] = {"w": 1, **({"b": 0} if "b" in leaves else {})}
    return views


def joint_views(params, plan, tp: int) -> Dict[str, Dict[str, int]]:
    """The joint plan's per-op views at ``tp``: a ``col`` dense's ``w``
    (and ``b``) cut on its columns, a ``row`` dense's ``w`` on its rows,
    where the dimension divides by ``tp``."""
    by_name = {plan.nodes[j].name: v.name for j, v in plan.views.items() if plan.nodes[j].name}
    views = {}
    for name, leaves in params.items():
        view, w = by_name.get(name), leaves.get("w")
        if w is None or w.dim() != 2:
            continue
        if view == "col" and w.shape[-1] % tp == 0:
            b = leaves.get("b")
            views[name] = {"w": 1, **({"b": 0} if b is not None and b.dim() == 1 else {})}
        elif view == "row" and w.shape[0] % tp == 0:
            views[name] = {"w": 0}
    return views


def has_cut_views(plan) -> bool:
    """Whether the joint plan holds a ``col`` or ``row`` view (JAX then adds
    its per-op candidate)."""
    return plan is not None and any(v.name in ("col", "row") for v in plan.views.values())


def mixed_rows(nodes, batch: int) -> Optional[str]:
    """The first node whose op mixes the batch's rows (as ``op name``), or
    None when each row of every node's output depends on its own rows of
    the inputs only."""
    for node in nodes:
        a, op = node.attrs, node.op
        nd = len(node.inputs[0].shape) if node.inputs else len(node.out_shapes[0])
        if op == "input":
            bad = not node.out_shapes[0] or node.out_shapes[0][0] != batch
        elif op == "batch_norm":
            bad = True
        elif op in ("mean", "reduce_sum", "reduce_max", "reduce_min"):
            bad = 0 in {d % nd for d in a.get("dims", a.get("axes", ()))}
        elif op == "reshape":
            bad = a["shape"][0] != node.inputs[0].shape[0]
        elif op == "transpose":
            bad = a["perm"][0] != 0
        elif op in ("concat", "split", "reverse", "gather", "take", "softmax"):
            bad = a["axis"] % nd == 0
        elif op == "slice":
            sl = a["slices"][0] if a["slices"] else (None, None, None)
            bad = isinstance(sl, int) or tuple(sl) not in ((None, None, None), (0, None, None),
                                                          (None, None, 1), (0, None, 1))
        elif op == "pad":
            bad = tuple(a["pad_width"][0]) != (0, 0)
        else:
            bad = False
        if bad:
            return f"{op} {node.name}"
    return None


@dataclasses.dataclass
class Cut:
    """One rank's cut: its mesh and the cut leaves ({node: {leaf: dim}})."""

    mesh: Mesh
    views: Dict[str, Dict[str, int]]

    def _own(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        width = t.shape[dim] // self.mesh.model
        return t.narrow(dim, self.mesh.model_rank * width, width)

    def place(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        """This rank's leaves of a whole tree: copies (cut leaves sliced),
        leaves that require grad."""
        out = {}
        for name, leaves in params.items():
            dims = self.views.get(name, {})
            out[name] = {k: (self._own(v.detach(), dims[k]) if k in dims else v.detach())
                         .clone().requires_grad_() for k, v in leaves.items()}
        return out

    def gather(self, params) -> Dict[str, Dict[str, torch.Tensor]]:
        """The whole tree from this rank's leaves, detached (every rank
        calls it)."""
        return {name: {k: (self.mesh.all_gather(v.detach(), self.views[name][k], MODEL_AXIS)
                           if k in self.views.get(name, {}) else v.detach())
                       for k, v in leaves.items()}
                for name, leaves in params.items()}

    def rows(self, n: int) -> slice:
        """This data rank's rows of an ``n``-row batch; raises when the data
        ranks do not divide ``n`` (JAX's ``P("data")`` refuses it too)."""
        if n % self.mesh.data:
            raise ValueError(f"a batch of {n} rows does not split over {self.mesh.data} data "
                             "ranks")
        per = n // self.mesh.data
        return slice(self.mesh.data_rank * per, (self.mesh.data_rank + 1) * per)

    def loss(self, loss_type: str, loss_fn, out, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        """(this rank's part of the batch's loss, to differentiate; the
        batch's loss, detached): over ``data`` ranks the rank's sum over the
        global count (``losses.LOSS_PARTS``), else ``loss_fn``."""
        if self.mesh.data == 1:
            loss = loss_fn(out, labels)
            return loss, loss.detach()
        total, count = LOSS_PARTS[loss_type](out, labels)
        whole, denom = self.mesh.all_reduce(
            torch.stack([total.detach().double(), count.double()]), DATA_AXIS)
        denom = denom.clamp_min(1)
        return total / denom.float(), (whole / denom).float()

    def penalty(self, name: str, pen: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the part of a node's penalty this rank differentiates: all of it
        on data rank 0, none on the others; its value: summed over the
        model ranks when the node's ``w`` is cut)."""
        value = pen.detach().clone()
        if "w" in self.views.get(name, {}):
            self.mesh.all_reduce(value, MODEL_AXIS)
        return (pen if self.mesh.data_rank == 0 else 0.0), value

    def reduce_grads(self, params) -> None:
        """Sum the leaves' gradients over ``data`` (after the backward)."""
        if self.mesh.data > 1:
            all_reduce_grads([p.grad for leaves in params.values() for p in leaves.values()
                              if p.grad is not None], self.mesh, DATA_AXIS)

    def apply(self, node, p, x: torch.Tensor, act) -> torch.Tensor:
        """A cut dense or embedding on whole activations ``x``: the whole
        output on every model rank."""
        m = self.mesh
        if node.op == "embedding":
            return gather_from_model(nn_ops.embedding_lookup(x, p["w"], node.attrs["aggr"]), m, -1)
        x = copy_to_model(x, m)
        if self.views[node.name]["w"] == 0:  # rows: this rank's input features
            y = reduce_from_model(self._own(x, x.dim() - 1) @ p["w"], m)
            if "b" in p:
                y = y + p["b"]
            return act(y) if act else y
        y = x @ p["w"]
        if "b" in p:
            y = y + p["b"]
        return gather_from_model(act(y) if act else y, m, -1)


def candidates(n: int, batch: int, plan) -> List[tuple]:
    """JAX's candidates over ``n`` ranks: (dp, tp, "uniform") for every
    ``dp`` dividing ``n`` and the batch, then (1, n, "joint") when the plan
    cuts a dense."""
    out = [(dp, n // dp, "uniform") for dp in range(1, n + 1) if n % dp == 0 and batch % dp == 0]
    if has_cut_views(plan):
        out.append((1, n, "joint"))
    return out
