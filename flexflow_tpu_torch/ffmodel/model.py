"""FFModel — the layer-graph DSL and its training executor on one device (port
of ``flexflow_tpu/ffmodel/model.py``).

The builder methods make the same nodes as JAX's (names ``f"{op}_{nid}"``,
shapes, attrs), so the same calls give the same graph, and the same
substitutions (``ffmodel/substitutions.py``) rewrite it the same way. The
parameters are tensors on one explicit device (``cuda`` unless the caller
asks for another, through ``resolve_device``), initialized from one
``torch.Generator`` seeded by ``seed``. JAX traces one jitted program per
step; here a step runs eagerly: the graph's ops (plain ``torch`` calls and
``ops/nn.py``, no kernel of the port's own), the loss, autograd, and the
port's optimizers, which update the parameters in place. Batch-norm
statistics are updated in place, outside autograd. ``set_learning_rate``
changes the optimizer's rate without rebuilding anything.

``compile(auto_parallel=True)`` runs JAX's joint rewrite x placement
search (``parallel/joint.py``) and keeps its graph, planned as JAX plans it
for at least two devices; on one device nothing is sharded, as in JAX.
Over the ranks of a ``torch.distributed`` world (``parallel/auto.
device_count``) the first ``fit`` batch then runs JAX's measured search
(``_auto_parallelize``) on every rank alike: each (data, model) candidate
is timed on copies of the parameters and the model keeps the fastest's
cut (``ffmodel/cut.py``), which ``fit``, ``evaluate`` and ``forward``
run. ``FFModel(mesh=)`` takes a ``parallel/mesh.Mesh`` and keeps it as JAX
keeps its mesh, unread: the graph is not sharded by it (JAX's executor
never reads ``_mesh`` either); the model runs on ``mesh.device`` unless
``device`` names another.
``load_numpy`` takes the JAX model's ``params`` / ``state`` as numpy trees,
so both packages can compute the same thing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.ops import activations as act_lib
from flexflow_tpu_torch.ops import nn as nn_ops
from flexflow_tpu_torch.ops import norms as norm_ops
from flexflow_tpu_torch.ops.topk import top_k
from flexflow_tpu_torch.parallel.mesh import DATA_AXIS
from flexflow_tpu_torch.training import losses as loss_lib
from flexflow_tpu_torch.training import metrics as metrics_lib
from flexflow_tpu_torch.training.metrics import PerfMetrics
from flexflow_tpu_torch.training.optimizers import tree_map, zip_leaves


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type (``np.int32``,
    JAX's ``jnp.float32``) or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if dt.name == "bfloat16":  # ml_dtypes' bf16 (JAX's)
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dt)).dtype


def to_numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _relu(x):
    # the maximum's gradient at a tie is 1/2, as JAX's relu (jnp.maximum)
    return torch.maximum(x, x.new_zeros(()))


def _clip(x, lo, hi):
    # clamp as JAX's jnp.clip: a minimum over a maximum (1/2 at the bounds)
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def _softplus(x):
    return torch.logaddexp(x, x.new_zeros(()))


@dataclasses.dataclass(frozen=True)
class Tensor:
    """Symbolic handle into the layer graph."""

    node: int
    index: int  # output index within the node (for multi-output ops)
    shape: Tuple[int, ...]
    dtype: Any  # a torch dtype

    @property
    def ndim(self):
        return len(self.shape)


@dataclasses.dataclass
class _Node:
    op: str
    inputs: List[Tensor]
    attrs: Dict[str, Any]
    out_shapes: List[Tuple[int, ...]]
    out_dtypes: List[Any]
    name: str = ""


_ACT = {
    None: None,
    "relu": _relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": act_lib.gelu,
    "elu": F.elu,
    "silu": act_lib.silu,
}

_UNARY = {
    "exp": torch.exp, "log": torch.log, "sin": torch.sin, "cos": torch.cos,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "relu": _relu, "sigmoid": torch.sigmoid,
    "tanh": torch.tanh, "elu": F.elu, "gelu": act_lib.gelu, "silu": act_lib.silu,
    "hardswish": F.hardswish, "hardsigmoid": F.hardsigmoid, "softplus": _softplus,
    "mish": lambda x: x * torch.tanh(_softplus(x)), "identity": lambda x: x,
}

_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
           "max": torch.maximum, "min": torch.minimum}


def _slice(x, slices):
    """Basic indexing with JAX's semantics: an int squeezes its dim, a
    (start, stop, step) triple slices it (a negative step too, which torch's
    indexing refuses)."""
    idx = []
    for d, sl in enumerate(slices):
        if isinstance(sl, int):
            idx.append(sl)
            continue
        s = slice(*sl)
        if s.step is None or s.step > 0:
            idx.append(s)
            continue
        rows = torch.tensor(list(range(*s.indices(x.shape[d]))), dtype=torch.long,
                            device=x.device)
        x = x.index_select(d, rows)
        idx.append(slice(None))
    return x[tuple(idx)]


def _take(x, index, axis):
    """``jnp.take(x, index, axis)``: index of any shape; a negative index
    counts from the end, as in numpy (one below ``-size`` still raises)."""
    flat = x.index_select(axis, nn_ops.wrap_index(index.reshape(-1), x.shape[axis]))
    return flat.reshape(x.shape[:axis] + index.shape + x.shape[axis + 1:])


class FFModel:
    """Layer-graph builder and its executor on one device."""

    def __init__(self, seed: int = 0, mesh=None, device=None):
        from flexflow_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
        self._mesh = mesh  # stored as JAX stores it; nothing reads it
        self._cut = None  # the search's (data, model) cut over the ranks (ffmodel/cut.py)
        self._pending_auto = False
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)
        self._nodes: List[_Node] = []
        self._inputs: List[int] = []
        self._seed = seed
        self._compiled = False
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.metrics = PerfMetrics()
        # per-node L1/L2 weight penalties (keras kernel_regularizer)
        self._regularizers: Dict[str, Tuple[float, float]] = {}
        # per-node kernel-initializer overrides (keras kernel_initializer)
        self._initializers: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # graph construction
    # ------------------------------------------------------------------

    def _add(self, op, inputs, attrs, out_shapes, out_dtypes, name="") -> List[Tensor]:
        nid = len(self._nodes)
        self._nodes.append(_Node(op, list(inputs), attrs, out_shapes, out_dtypes,
                                 name or f"{op}_{nid}"))
        return [
            Tensor(nid, i, tuple(s), d)
            for i, (s, d) in enumerate(zip(out_shapes, out_dtypes))
        ]

    def create_tensor(self, dims: Sequence[int], dtype=torch.float32) -> Tensor:
        [t] = self._add("input", [], {}, [tuple(dims)], [to_torch_dtype(dtype)])
        self._inputs.append(t.node)
        return t

    def constant(self, value, dtype=None, name: str = "") -> Tensor:
        """Frozen (non-trainable) tensor constant baked into the graph: float
        values are float32, others int32, unless ``dtype`` says otherwise."""
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        arr = np.asarray(value)
        dt = to_torch_dtype(dtype) if dtype is not None else (
            torch.float32 if arr.dtype.kind == "f" else torch.int32)
        [t] = self._add("constant", [], {"value": arr, "dtype": dt},
                        [arr.shape], [dt], name)
        return t

    # --- elementwise unary ---

    def _unary(self, op, x, **attrs):
        [t] = self._add(op, [x], attrs, [x.shape], [x.dtype])
        return t

    def exp(self, x): return self._unary("exp", x)
    def log(self, x): return self._unary("log", x)
    def sin(self, x): return self._unary("sin", x)
    def cos(self, x): return self._unary("cos", x)
    def sqrt(self, x): return self._unary("sqrt", x)
    def rsqrt(self, x): return self._unary("rsqrt", x)
    def relu(self, x): return self._unary("relu", x)
    def sigmoid(self, x): return self._unary("sigmoid", x)
    def tanh(self, x): return self._unary("tanh", x)
    def elu(self, x): return self._unary("elu", x)
    def gelu(self, x): return self._unary("gelu", x)
    def silu(self, x): return self._unary("silu", x)
    def hardswish(self, x): return self._unary("hardswish", x)
    def hardsigmoid(self, x): return self._unary("hardsigmoid", x)
    def softplus(self, x): return self._unary("softplus", x)
    def mish(self, x): return self._unary("mish", x)
    def identity(self, x): return self._unary("identity", x)

    def leaky_relu(self, x, negative_slope: float = 0.01):
        return self._unary("leaky_relu", x, negative_slope=negative_slope)

    def clamp(self, x, min_val=None, max_val=None):
        return self._unary("clamp", x, min_val=min_val, max_val=max_val)
    def pow(self, x, exponent: float): return self._unary("pow", x, exponent=exponent)
    def scalar_add(self, x, scalar: float): return self._unary("scalar_add", x, scalar=scalar)
    def scalar_sub(self, x, scalar: float): return self._unary("scalar_sub", x, scalar=scalar)
    def scalar_multiply(self, x, scalar: float): return self._unary("scalar_mul", x, scalar=scalar)
    def scalar_true_divide(self, x, scalar: float): return self._unary("scalar_div", x, scalar=scalar)

    def softmax(self, x, axis: int = -1):
        return self._unary("softmax", x, axis=axis)

    # --- elementwise binary ---

    def _binary(self, op, a, b):
        shape = np.broadcast_shapes(a.shape, b.shape)
        [t] = self._add(op, [a, b], {}, [tuple(shape)], [a.dtype])
        return t

    def add(self, a, b): return self._binary("add", a, b)
    def subtract(self, a, b): return self._binary("sub", a, b)
    def multiply(self, a, b): return self._binary("mul", a, b)
    def divide(self, a, b): return self._binary("div", a, b)
    def max(self, a, b): return self._binary("max", a, b)
    def min(self, a, b): return self._binary("min", a, b)

    def where(self, cond, a, b):
        """Elementwise select ``cond ? a : b`` (broadcasting); a non-finite
        value on the branch not taken never reaches the result."""
        shape = np.broadcast_shapes(cond.shape, a.shape, b.shape)
        [t] = self._add("where", [cond, a, b], {}, [tuple(shape)], [a.dtype])
        return t

    # --- dense / conv / pool / norm ---

    def dense(self, x, out_dim: int, activation: Optional[str] = None,
              use_bias: bool = True, name: str = ""):
        shape = x.shape[:-1] + (out_dim,)
        [t] = self._add(
            "dense", [x],
            {"out_dim": out_dim, "activation": activation, "use_bias": use_bias},
            [shape], [x.dtype], name,
        )
        return t

    def conv2d(self, x, out_channels: int, kernel_h: int, kernel_w: int,
               stride_h: int = 1, stride_w: int = 1, padding_h: int = 0,
               padding_w: int = 0, activation: Optional[str] = None,
               groups: int = 1, use_bias: bool = True, name: str = ""):
        n, c, h, w = x.shape
        oh = (h + 2 * padding_h - kernel_h) // stride_h + 1
        ow = (w + 2 * padding_w - kernel_w) // stride_w + 1
        [t] = self._add(
            "conv2d", [x],
            dict(out_channels=out_channels, kernel=(kernel_h, kernel_w),
                 stride=(stride_h, stride_w), padding=(padding_h, padding_w),
                 activation=activation, groups=groups, use_bias=use_bias),
            [(n, out_channels, oh, ow)], [x.dtype], name,
        )
        return t

    def conv2d_transpose(self, x, out_channels: int, kernel_h: int,
                         kernel_w: int, stride_h: int = 1, stride_w: int = 1,
                         padding_h: int = 0, padding_w: int = 0,
                         output_padding_h: int = 0, output_padding_w: int = 0,
                         activation: Optional[str] = None,
                         use_bias: bool = True, name: str = ""):
        n, c, h, w = x.shape
        oh = (h - 1) * stride_h - 2 * padding_h + kernel_h + output_padding_h
        ow = (w - 1) * stride_w - 2 * padding_w + kernel_w + output_padding_w
        [t] = self._add(
            "conv2d_transpose", [x],
            dict(out_channels=out_channels, kernel=(kernel_h, kernel_w),
                 stride=(stride_h, stride_w), padding=(padding_h, padding_w),
                 output_padding=(output_padding_h, output_padding_w),
                 activation=activation, use_bias=use_bias),
            [(n, out_channels, oh, ow)], [x.dtype], name,
        )
        return t

    def group_norm(self, x, num_groups: int, eps: float = 1e-5,
                   affine: bool = True, name: str = ""):
        """GroupNorm over [N, C, ...] channels split into num_groups."""
        if x.shape[1] % num_groups:
            raise ValueError(f"{x.shape[1]} channels do not split into {num_groups} groups")
        [t] = self._add("group_norm", [x],
                        dict(num_groups=num_groups, eps=eps, affine=affine),
                        [x.shape], [x.dtype], name)
        return t

    def pool2d(self, x, kernel_h: int, kernel_w: int, stride_h: int = 1,
               stride_w: int = 1, padding_h: int = 0, padding_w: int = 0,
               pool_type: str = "max", name: str = ""):
        n, c, h, w = x.shape
        oh = (h + 2 * padding_h - kernel_h) // stride_h + 1
        ow = (w + 2 * padding_w - kernel_w) // stride_w + 1
        [t] = self._add(
            "pool2d", [x],
            dict(kernel=(kernel_h, kernel_w), stride=(stride_h, stride_w),
                 padding=(padding_h, padding_w), pool_type=pool_type),
            [(n, c, oh, ow)], [x.dtype], name,
        )
        return t

    def batch_norm(self, x, relu: bool = True, momentum: float = 0.9,
                   eps: float = 1e-5, name: str = ""):
        [t] = self._add("batch_norm", [x],
                        dict(relu=relu, momentum=momentum, eps=eps),
                        [x.shape], [x.dtype], name)
        return t

    def layer_norm(self, x, elementwise_affine: bool = True, eps: float = 1e-5,
                   use_bias: bool = True, name: str = ""):
        [t] = self._add("layer_norm", [x],
                        dict(affine=elementwise_affine, eps=eps, use_bias=use_bias),
                        [x.shape], [x.dtype], name)
        return t

    def rms_norm(self, x, eps: float = 1e-6, name: str = ""):
        [t] = self._add("rms_norm", [x], dict(eps=eps), [x.shape], [x.dtype], name)
        return t

    def residual_layer_norm(self, x, residual, eps: float = 1e-5, name: str = ""):
        [res, out] = self._add("residual_layer_norm", [x, residual],
                               dict(eps=eps), [x.shape, x.shape],
                               [x.dtype, x.dtype], name)
        return res, out

    def residual_rms_norm(self, x, residual, eps: float = 1e-6, name: str = ""):
        [res, out] = self._add("residual_rms_norm", [x, residual],
                               dict(eps=eps), [x.shape, x.shape],
                               [x.dtype, x.dtype], name)
        return res, out

    def sigmoid_silu_multi(self, gate, up, name: str = ""):
        [t] = self._add("sigmoid_silu_multi", [gate, up], {},
                        [gate.shape], [gate.dtype], name)
        return t

    def embedding(self, x, num_entries: int, out_dim: int, aggr: str = "none",
                  name: str = ""):
        if aggr == "none":
            shape = x.shape + (out_dim,)
        else:
            shape = x.shape[:-1] + (out_dim,)
        [t] = self._add("embedding", [x],
                        dict(num_entries=num_entries, out_dim=out_dim, aggr=aggr),
                        [shape], [torch.float32], name)
        return t

    def dropout(self, x, rate: float = 0.5, name: str = ""):
        [t] = self._add("dropout", [x], dict(rate=rate), [x.shape], [x.dtype], name)
        return t

    # --- data movement ---

    def flat(self, x, name: str = ""):
        shape = (x.shape[0], int(np.prod(x.shape[1:])))
        [t] = self._add("flat", [x], {}, [shape], [x.dtype], name)
        return t

    def reshape(self, x, shape: Sequence[int], name: str = ""):
        [t] = self._add("reshape", [x], dict(shape=tuple(shape)),
                        [tuple(shape)], [x.dtype], name)
        return t

    def transpose(self, x, perm: Sequence[int], name: str = ""):
        shape = tuple(x.shape[p] for p in perm)
        [t] = self._add("transpose", [x], dict(perm=tuple(perm)),
                        [shape], [x.dtype], name)
        return t

    def concat(self, tensors: Sequence[Tensor], axis: int, name: str = ""):
        axis = axis % tensors[0].ndim
        dim = sum(t.shape[axis] for t in tensors)
        shape = list(tensors[0].shape)
        shape[axis] = dim
        [t] = self._add("concat", list(tensors), dict(axis=axis),
                        [tuple(shape)], [tensors[0].dtype], name)
        return t

    def split(self, x, sizes: Sequence[int], axis: int, name: str = ""):
        axis = axis % x.ndim
        shapes = []
        for s in sizes:
            sh = list(x.shape)
            sh[axis] = s
            shapes.append(tuple(sh))
        return self._add("split", [x], dict(sizes=tuple(sizes), axis=axis),
                         shapes, [x.dtype] * len(sizes), name)

    def cast(self, x, dtype, name: str = ""):
        dtype = to_torch_dtype(dtype)
        [t] = self._add("cast", [x], dict(dtype=dtype), [x.shape], [dtype], name)
        return t

    def slice_tensor(self, x, slices, name: str = ""):
        """Basic indexing: per-dim entry is an int (dim squeezed) or a
        (start, stop, step) triple (any may be None). Dims beyond
        ``len(slices)`` pass through."""
        shape = []
        norm = []
        for i, s in enumerate(x.shape):
            if i < len(slices):
                sl = slices[i]
                if isinstance(sl, int):
                    norm.append(sl % s)
                    continue  # dim squeezed
                start, stop, step = sl
                norm.append((start, stop, step))
                shape.append(len(range(*slice(start, stop, step).indices(s))))
            else:
                shape.append(s)
        [t] = self._add("slice", [x], dict(slices=tuple(norm)),
                        [tuple(shape)], [x.dtype], name)
        return t

    def reverse(self, x, axis: int, name: str = ""):
        [t] = self._add("reverse", [x], dict(axis=axis), [x.shape], [x.dtype], name)
        return t

    def gather(self, x, index: Tensor, axis: int, name: str = ""):
        [t] = self._add("gather", [x, index], dict(axis=axis),
                        [index.shape], [x.dtype], name)
        return t

    def take(self, x, index: Tensor, axis: int, name: str = ""):
        """Index rows of ``x`` along ``axis`` (take(weight, ids, 0) ->
        ids.shape + weight.shape[1:])."""
        axis = axis % x.ndim
        shape = x.shape[:axis] + index.shape + x.shape[axis + 1:]
        [t] = self._add("take", [x, index], dict(axis=axis),
                        [shape], [x.dtype], name)
        return t

    def mean(self, x, dims: Sequence[int], keepdims: bool = False, name: str = ""):
        shape = [s for i, s in enumerate(x.shape)
                 if i not in dims or keepdims]
        if keepdims:
            shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
        [t] = self._add("mean", [x], dict(dims=tuple(dims), keepdims=keepdims),
                        [tuple(shape)], [x.dtype], name)
        return t

    def pad(self, x, pad_width: Sequence[Tuple[int, int]], value: float = 0.0,
            name: str = ""):
        """Constant-pad; ``pad_width`` is one (lo, hi) pair per dim, numpy style."""
        pw = tuple((int(lo), int(hi)) for lo, hi in pad_width)
        shape = tuple(s + lo + hi for s, (lo, hi) in zip(x.shape, pw))
        [t] = self._add("pad", [x], {"pad_width": pw, "value": value},
                        [shape], [x.dtype], name)
        return t

    def reduce_max(self, x, axes: Sequence[int], keepdims: bool = False,
                   name: str = ""):
        return self._reduce("reduce_max", x, axes, keepdims, name)

    def reduce_min(self, x, axes: Sequence[int], keepdims: bool = False,
                   name: str = ""):
        return self._reduce("reduce_min", x, axes, keepdims, name)

    def _reduce(self, op, x, axes, keepdims, name):
        axes = tuple(d % x.ndim for d in axes)
        shape = tuple(
            (1 if i in axes else s) for i, s in enumerate(x.shape)
            if keepdims or i not in axes
        )
        [t] = self._add(op, [x], {"axes": axes, "keepdims": keepdims},
                        [shape], [x.dtype], name)
        return t

    def reduce_sum(self, x, axes: Sequence[int], keepdims: bool = False,
                   name: str = ""):
        if keepdims:
            shape = [1 if i in axes else s for i, s in enumerate(x.shape)]
        else:
            shape = [s for i, s in enumerate(x.shape) if i not in axes]
        [t] = self._add("reduce_sum", [x], dict(axes=tuple(axes), keepdims=keepdims),
                        [tuple(shape)], [x.dtype], name)
        return t

    def batch_matmul(self, a, b, name: str = ""):
        shape = a.shape[:-1] + (b.shape[-1],)
        [t] = self._add("batch_matmul", [a, b], {}, [shape], [a.dtype], name)
        return t

    # --- attention (training-style MHA) ---

    def multihead_attention(self, query, key, value, embed_dim: int,
                            num_heads: int, causal: bool = False,
                            name: str = ""):
        shape = query.shape[:-1] + (embed_dim,)
        [t] = self._add("mha", [query, key, value],
                        dict(embed_dim=embed_dim, num_heads=num_heads,
                             causal=causal),
                        [shape], [query.dtype], name)
        return t

    # --- top-k / sampling heads ---

    def top_k(self, x, k: int, name: str = ""):
        shape = x.shape[:-1] + (k,)
        return self._add("top_k", [x], dict(k=k), [shape, shape],
                         [x.dtype, torch.int32], name)

    def arg_top_k(self, x, k: int, name: str = ""):
        shape = x.shape[:-1] + (k,)
        [t] = self._add("arg_top_k", [x], dict(k=k), [shape], [torch.int32], name)
        return t

    def argmax(self, x, name: str = ""):
        [t] = self._add("argmax", [x], {}, [x.shape[:-1]], [torch.int32], name)
        return t

    # --- MoE composite (gate -> top-k -> experts -> combine) ---

    def moe(self, x, num_experts: int, top_k: int, expert_hidden: int,
            out_dim: int, alpha: float = 2.0, name: str = ""):
        shape = x.shape[:-1] + (out_dim,)
        [t] = self._add("moe", [x],
                        dict(num_experts=num_experts, top_k=top_k,
                             expert_hidden=expert_hidden, out_dim=out_dim,
                             alpha=alpha),
                        [shape], [x.dtype], name)
        return t

    # ------------------------------------------------------------------
    # compile: parameters and the step
    # ------------------------------------------------------------------

    def set_regularizer(self, node_name: str, l1: float = 0.0,
                        l2: float = 0.0) -> None:
        """Attach an L1/L2 penalty to a node's "w" leaf (keras
        kernel_regularizer). Call before compile()."""
        if l1 or l2:
            self._regularizers[node_name] = (float(l1), float(l2))

    def set_learning_rate(self, lr: float) -> None:
        """Change the optimizer's learning rate mid-training (keras
        LearningRateScheduler); the optimizer state is kept."""
        self._require_compiled()
        self.optimizer = dataclasses.replace(self.optimizer, lr=float(lr))

    def set_initializer(self, node_name: str, init) -> None:
        """Override a node's kernel initializer (keras kernel_initializer);
        ``init(shape, fan_in, fan_out, generator)`` returns the array, drawn
        from the CPU ``torch.Generator`` it is given."""
        self._initializers[node_name] = init

    def _init_node(self, node: _Node, gen: torch.Generator) -> Tuple[Dict, Dict]:
        """Returns (params, state) for one node, on the CPU."""
        override = self._initializers.get(node.name)

        def glorot(shape, fan_in, fan_out):
            if override is not None:
                return torch.as_tensor(override(shape, fan_in, fan_out, gen),
                                       dtype=torch.float32)
            scale = math.sqrt(2.0 / (fan_in + fan_out))
            return torch.randn(shape, generator=gen) * scale

        a = node.attrs
        if node.op == "dense":
            d_in = node.inputs[0].shape[-1]
            p = {"w": glorot((d_in, a["out_dim"]), d_in, a["out_dim"])}
            if a["use_bias"]:
                p["b"] = torch.zeros((a["out_dim"],))
            return p, {}
        if node.op == "conv2d":
            c_in = node.inputs[0].shape[1] // a["groups"]
            kh, kw = a["kernel"]
            p = {"w": glorot((a["out_channels"], c_in, kh, kw), c_in * kh * kw,
                             a["out_channels"])}
            if a["use_bias"]:
                p["b"] = torch.zeros((a["out_channels"],))
            return p, {}
        if node.op == "conv2d_transpose":
            c_in = node.inputs[0].shape[1]
            kh, kw = a["kernel"]
            p = {"w": glorot((c_in, a["out_channels"], kh, kw),
                             c_in * kh * kw, a["out_channels"])}
            if a["use_bias"]:
                p["b"] = torch.zeros((a["out_channels"],))
            return p, {}
        if node.op == "group_norm":
            c = node.inputs[0].shape[1]
            if a.get("affine", True):
                return {"scale": torch.ones((c,)), "bias": torch.zeros((c,))}, {}
            return {}, {}
        if node.op == "batch_norm":
            c = node.inputs[0].shape[1]
            return (
                {"scale": torch.ones((c,)), "bias": torch.zeros((c,))},
                {"mean": torch.zeros((c,)), "var": torch.ones((c,))},
            )
        if node.op in ("layer_norm", "residual_layer_norm"):
            d = node.inputs[0].shape[-1]
            p = {}
            if a.get("affine", True):
                p["scale"] = torch.ones((d,))
                if a.get("use_bias", True):
                    p["bias"] = torch.zeros((d,))
            return p, {}
        if node.op in ("rms_norm", "residual_rms_norm"):
            d = node.inputs[0].shape[-1]
            return {"scale": torch.ones((d,))}, {}
        if node.op == "embedding":
            return {"w": glorot((a["num_entries"], a["out_dim"]),
                                a["num_entries"], a["out_dim"])}, {}
        if node.op == "mha":
            d = node.inputs[0].shape[-1]
            e = a["embed_dim"]
            return {
                "wq": glorot((d, e), d, e),
                "wk": glorot((node.inputs[1].shape[-1], e), d, e),
                "wv": glorot((node.inputs[2].shape[-1], e), d, e),
                "wo": glorot((e, e), e, e),
            }, {}
        if node.op == "moe":
            d = node.inputs[0].shape[-1]
            e, hdim, od = a["num_experts"], a["expert_hidden"], a["out_dim"]
            return {
                "gate": glorot((d, e), d, e),
                "w1": glorot((e, d, hdim), d, hdim),
                "b1": torch.zeros((e, hdim)),
                "w2": glorot((e, hdim, od), hdim, od),
                "b2": torch.zeros((e, od)),
            }, {}
        return {}, {}

    def _apply_node(self, node: _Node, p, s, xs, train: bool, gen):
        """Evaluate one node; returns (outputs list, new_state)."""
        a = node.attrs
        op = node.op
        if self._cut is not None and node.name in self._cut.views:
            return [self._cut.apply(node, p, xs[0], _ACT.get(a.get("activation")))], s
        if op in _UNARY:
            return [_UNARY[op](xs[0])], s
        if op == "pad":
            pairs = [v for lo_hi in reversed(a["pad_width"]) for v in lo_hi]
            return [F.pad(xs[0], pairs, value=a["value"])], s
        if op == "reduce_max":
            return [torch.amax(xs[0], dim=a["axes"], keepdim=a["keepdims"])], s
        if op == "reduce_min":
            return [torch.amin(xs[0], dim=a["axes"], keepdim=a["keepdims"])], s
        if op == "leaky_relu":
            return [F.leaky_relu(xs[0], a["negative_slope"])], s
        if op == "clamp":
            return [_clip(xs[0], a["min_val"], a["max_val"])], s
        if op == "slice":
            return [_slice(xs[0], a["slices"])], s
        if op == "pow":
            return [torch.pow(xs[0], a["exponent"])], s
        if op == "scalar_add":
            return [xs[0] + a["scalar"]], s
        if op == "scalar_sub":
            return [xs[0] - a["scalar"]], s
        if op == "scalar_mul":
            return [xs[0] * a["scalar"]], s
        if op == "scalar_div":
            return [xs[0] / a["scalar"]], s
        if op == "softmax":
            return [torch.softmax(xs[0], dim=a["axis"])], s
        if op in _BINARY:
            return [_BINARY[op](xs[0], xs[1])], s
        if op == "where":
            return [torch.where(xs[0] != 0, xs[1], xs[2])], s
        if op == "dense":
            y = xs[0] @ p["w"]
            if "b" in p:
                y = y + p["b"]
            act = _ACT[a["activation"]]
            return [act(y) if act else y], s
        if op == "conv2d":
            y = nn_ops.conv2d(xs[0], p["w"], p.get("b"), a["stride"],
                              a["padding"], a["groups"])
            act = _ACT[a["activation"]]
            return [act(y) if act else y], s
        if op == "conv2d_transpose":
            y = nn_ops.conv2d_transpose(xs[0], p["w"], p.get("b"), a["stride"],
                                        a["padding"], a["output_padding"])
            act = _ACT[a["activation"]]
            return [act(y) if act else y], s
        if op == "group_norm":
            return [nn_ops.group_norm(xs[0], a["num_groups"], p.get("scale"),
                                      p.get("bias"), a["eps"])], s
        if op == "pool2d":
            return [nn_ops.pool2d(xs[0], a["kernel"], a["stride"],
                                  a["padding"], a["pool_type"])], s
        if op == "batch_norm":
            if train:
                y, m, v = nn_ops.batch_norm_train(
                    xs[0], p["scale"], p["bias"], s["mean"], s["var"],
                    a["momentum"], a["eps"])
                s = {"mean": m, "var": v}
            else:
                y = nn_ops.batch_norm_infer(xs[0], p["scale"], p["bias"],
                                            s["mean"], s["var"], a["eps"])
            return [_relu(y) if a["relu"] else y], s
        if op == "layer_norm":
            scale = p.get("scale", xs[0].new_ones(xs[0].shape[-1]))
            return [norm_ops.layer_norm(xs[0], scale, p.get("bias"), a["eps"])], s
        if op == "rms_norm":
            return [norm_ops.rms_norm(xs[0], p["scale"], a["eps"])], s
        if op == "residual_layer_norm":
            scale = p.get("scale", xs[0].new_ones(xs[0].shape[-1]))
            res, out = norm_ops.residual_layer_norm(xs[0], xs[1], scale, p.get("bias"),
                                                    a["eps"])
            return [res, out], s
        if op == "residual_rms_norm":
            res, out = norm_ops.residual_rms_norm(xs[0], xs[1], p["scale"], a["eps"])
            return [res, out], s
        if op == "sigmoid_silu_multi":
            return [act_lib.sigmoid_silu_multi(xs[0], xs[1])], s
        if op == "embedding":
            return [nn_ops.embedding_lookup(xs[0], p["w"], a["aggr"])], s
        if op == "dropout":
            if train and gen is not None:
                return [nn_ops.dropout(xs[0], a["rate"], gen)], s
            return [xs[0]], s
        if op == "flat":
            return [nn_ops.flat(xs[0])], s
        if op == "reshape":
            shape = a["shape"]
            if self._cut is not None and self._cut.mesh.data > 1:  # keeps the rows (mixed_rows)
                shape = (xs[0].shape[0],) + tuple(shape[1:])
            return [xs[0].reshape(shape)], s
        if op == "transpose":
            return [xs[0].permute(a["perm"])], s
        if op == "concat":
            return [torch.cat(xs, dim=a["axis"])], s
        if op == "split":
            return list(torch.split(xs[0], list(a["sizes"]), dim=a["axis"])), s
        if op == "cast":
            return [xs[0].to(a["dtype"])], s
        if op == "reverse":
            return [nn_ops.reverse(xs[0], a["axis"])], s
        if op == "gather":
            return [nn_ops.gather(xs[0], xs[1], a["axis"])], s
        if op == "take":
            return [_take(xs[0], xs[1], a["axis"])], s
        if op == "mean":
            return [torch.mean(xs[0], dim=a["dims"], keepdim=a["keepdims"])], s
        if op == "reduce_sum":
            return [torch.sum(xs[0], dim=a["axes"], keepdim=a["keepdims"])], s
        if op == "batch_matmul":
            return [nn_ops.batch_matmul(xs[0], xs[1])], s
        if op == "mha":
            q = xs[0] @ p["wq"]
            k = xs[1] @ p["wk"]
            v = xs[2] @ p["wv"]
            nh = a["num_heads"]
            b, tq, e = q.shape
            tk = k.shape[1]
            hd = e // nh
            qh = q.reshape(b, tq, nh, hd).transpose(1, 2)
            kh = k.reshape(b, tk, nh, hd).transpose(1, 2)
            vh = v.reshape(b, tk, nh, hd).transpose(1, 2)
            scores = qh @ kh.transpose(2, 3) / math.sqrt(hd)
            if a["causal"]:
                mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril()
                scores = torch.where(mask, scores, -1e30)
            probs = torch.softmax(scores, dim=-1)
            out = (probs @ vh).transpose(1, 2).reshape(b, tq, e)
            return [out @ p["wo"]], s
        if op == "top_k":
            vals, idx = top_k(xs[0], a["k"])
            return [vals, idx.to(torch.int32)], s
        if op == "arg_top_k":
            _, idx = top_k(xs[0], a["k"])
            return [idx.to(torch.int32)], s
        if op == "argmax":
            return [torch.argmax(xs[0], dim=-1).to(torch.int32)], s
        if op == "moe":
            # gate -> softmax -> top-k -> renormalize -> every expert -> combine
            # (exact dense routing, no capacity drop)
            logits = xs[0] @ p["gate"]
            probs = torch.softmax(logits, dim=-1)
            topw, topi = top_k(probs, a["top_k"])
            topw = topw / torch.sum(topw, dim=-1, keepdim=True)
            combine = torch.sum(
                F.one_hot(topi, a["num_experts"]).to(topw.dtype) * topw[..., None], dim=-2
            )  # [..., E]
            h1 = torch.einsum("...d,edf->...ef", xs[0], p["w1"]) + p["b1"]
            h1 = _relu(h1)
            h2 = torch.einsum("...ef,efo->...eo", h1, p["w2"]) + p["b2"]
            return [torch.sum(h2 * combine[..., None], dim=-2)], s
        raise ValueError(f"Unknown op {node.op!r}")

    def _run(self, inputs: List[torch.Tensor], train: bool, gen=None) -> torch.Tensor:
        """The graph on ``inputs``; the last node's first output. In training
        the batch-norm statistics are written into ``self.state`` in place."""
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        input_iter = iter(inputs)
        for nid, node in enumerate(self._nodes):
            if node.op == "input":
                values[(nid, 0)] = next(input_iter)
                continue
            if node.op == "constant":
                values[(nid, 0)] = self._consts[nid]
                continue
            xs = [values[(t.node, t.index)] for t in node.inputs]
            state = self.state.get(node.name, {})
            outs, ns = self._apply_node(node, self.params.get(node.name, {}), state, xs,
                                        train, gen)
            if ns is not state:
                with torch.no_grad():
                    for k, v in ns.items():
                        state[k].copy_(v)
            for i, o in enumerate(outs):
                values[(nid, i)] = o
        return values[(len(self._nodes) - 1, 0)]

    def compile(
        self,
        optimizer=None,
        loss_type: str = "sparse_categorical_crossentropy",
        metrics: Sequence[str] = ("accuracy",),
        auto_parallel: bool = False,
    ) -> None:
        """Rewrite the graph (under ``config.fusion``), initialize the
        parameters on the model's device, and set up the optimizer.

        ``auto_parallel=True`` rewrites through the joint rewrite x
        placement search instead of the plain fixpoint, as JAX's compile
        does: ``joint_optimize`` with analytic costs for
        ``max(devices, 2)`` devices, the batch from the inputs' leading
        dimensions, ``config.search_budget * 4`` expansions and
        ``config.search_alpha``. Its graph replaces the model's, the plan is
        ``self.joint_plan`` and its rewrites join ``substitution_report``.
        One device runs the graph unsharded. Over more than one rank the
        measured (data, model) search runs at the first ``fit`` batch
        (``_auto_parallelize``), as in JAX."""
        from flexflow_tpu_torch.config import config as _ffconfig
        from flexflow_tpu_torch.ffmodel.substitutions import load_rules, optimize_graph
        from flexflow_tpu_torch.parallel import auto as auto_lib

        n_devices = auto_lib.device_count(self.device) if auto_parallel else 1
        self.device = auto_lib.search_device(self.device, n_devices)
        self.substitution_report = {}
        self.joint_plan = None
        self.auto_report = None
        if getattr(_ffconfig, "fusion", True):
            rules = None
            if getattr(_ffconfig, "substitution_json", None):
                rules = load_rules(_ffconfig.substitution_json)
            if auto_parallel:
                from flexflow_tpu_torch.parallel.joint import joint_optimize

                batch = 1
                for i in self._inputs:
                    shp = self._nodes[i].out_shapes[0]
                    if shp:
                        batch = max(batch, int(shp[0]))
                plan = joint_optimize(
                    self._nodes, self._inputs, n_devices=max(n_devices, 2), batch=batch,
                    rules=rules, budget=getattr(_ffconfig, "search_budget", 8) * 4,
                    alpha=getattr(_ffconfig, "search_alpha", 1.2))
                self._nodes, self._inputs = plan.nodes, plan.input_ids
                self.joint_plan = plan
                for r, _j in plan.applied:
                    self.substitution_report[r] = self.substitution_report.get(r, 0) + 1
            else:
                self._nodes, self._inputs, self.substitution_report = (
                    optimize_graph(self._nodes, self._inputs, rules))

        gen = torch.Generator().manual_seed(self._seed)
        params, state = {}, {}
        for node in self._nodes:
            p, st = self._init_node(node, gen)
            if p:
                params[node.name] = {k: v.to(self.device).requires_grad_()
                                     for k, v in p.items()}
            if st:
                state[node.name] = {k: v.to(self.device) for k, v in st.items()}
        self.params, self.state = params, state
        self._consts = {
            nid: torch.as_tensor(n.attrs["value"], dtype=n.attrs["dtype"], device=self.device)
            for nid, n in enumerate(self._nodes) if n.op == "constant"}
        self._input_dtypes = [self._nodes[i].out_dtypes[0] for i in self._inputs]
        self.optimizer = optimizer
        self.loss_type = loss_type
        self._metric_names = tuple(metrics)
        self.loss_fn = loss_lib.LOSSES[loss_type]
        self.opt_state = optimizer.init(params) if optimizer else None
        self._classification = loss_type in (
            "sparse_categorical_crossentropy", "categorical_crossentropy")
        self._cut = None
        self._pending_auto = bool(auto_parallel) and n_devices > 1
        self._compiled = True

    def load_numpy(self, params: Dict[str, Dict[str, Any]],
                   state: Optional[Dict[str, Dict[str, Any]]] = None) -> None:
        """Set nodes' parameters (and batch-norm statistics) from numpy trees
        ``{node name: {leaf: array}}``, such as the JAX model's ``params`` and
        ``state`` after ``np.asarray`` on each leaf; bf16 leaves are widened
        to f32. Each named node's leaves are replaced by the given ones."""
        from flexflow_tpu_torch.models.params import params_from_numpy

        self._require_compiled()
        for tree, own, what in ((params, self.params, "parameters"),
                                (state or {}, self.state, "state")):
            for name, leaves in tree.items():
                if name not in own:
                    raise KeyError(f"the graph has no node {name!r} with {what}")
                loaded = params_from_numpy(dict(leaves), self.device)
                if own is self.params and self._cut is not None:
                    own[name] = self._cut.place({name: loaded})[name]
                else:
                    own[name] = ({k: v.requires_grad_() for k, v in loaded.items()}
                                 if own is self.params else loaded)

    def _require_compiled(self):
        if not self._compiled:
            raise RuntimeError("call compile() first")

    # ------------------------------------------------------------------
    # the step and the executor
    # ------------------------------------------------------------------

    def _to_inputs(self, xs) -> List[torch.Tensor]:
        """Host arrays as the graph's inputs: on the model's device, in each
        input node's dtype."""
        if len(xs) != len(self._input_dtypes):
            raise ValueError(f"the graph has {len(self._input_dtypes)} inputs, got {len(xs)}")
        return [torch.as_tensor(np.asarray(a)).to(self.device, dt)
                for a, dt in zip(xs, self._input_dtypes)]

    def _to_labels(self, y) -> torch.Tensor:
        arr = np.asarray(y)
        dt = torch.float32 if arr.dtype.kind == "f" else torch.int64
        return torch.as_tensor(arr).to(self.device, dt)

    def _metrics(self, out, labels, rows: bool = False) -> Dict[str, float]:
        """The batch's metrics; of a data rank's ``rows`` under a cut, the
        counts summed and the means averaged over the data ranks."""
        if self._classification:
            m = metrics_lib.classification_metrics(
                out, labels if labels.ndim < out.ndim else torch.argmax(labels, -1))
        else:
            m = metrics_lib.regression_metrics(out, labels)
        mesh = None if self._cut is None else self._cut.mesh
        if rows and mesh is not None and mesh.data > 1:
            both = mesh.all_reduce(torch.stack([v.double() for v in m.values()]), DATA_AXIS)
            if self._classification:
                return {k: int(v) for k, v in zip(m, both.tolist())}
            return {k: v / mesh.data for k, v in zip(m, both.tolist())}
        return {k: v.item() for k, v in m.items()}

    def _step(self, inputs, labels, gen) -> Tuple[torch.Tensor, torch.Tensor]:
        """One training step: the forward, the loss (with the regularizers'
        penalties), autograd and the optimizer's in-place update. Returns the
        loss and the output on the device; nothing waits for the device.
        Under a cut ``inputs`` and ``labels`` are the data rank's rows, the
        cut gives the loss's and the penalties' parts (``Cut.loss``,
        ``Cut.penalty``) and sums the gradients over ``data``; the loss
        returned is the whole batch's and the output the rank's rows."""
        cut = self._cut
        with torch.enable_grad():
            out = self._run(inputs, True, gen)
            if cut is None:
                loss = self.loss_fn(out, labels)
                value = loss.detach()
            else:
                loss, value = cut.loss(self.loss_type, self.loss_fn, out, labels)
            for name, (l1, l2) in self._regularizers.items():
                w = self.params[name]["w"]
                for coef, term in ((l2, torch.square), (l1, torch.abs)):
                    if coef:
                        pen = coef * torch.sum(term(w))
                        own, whole = (pen, pen.detach()) if cut is None else cut.penalty(name, pen)
                        loss, value = loss + own, value + whole
            if self.params:
                loss.backward()
        if cut is not None:
            cut.reduce_grads(self.params)
        grads = tree_map(lambda p: p.grad, self.params)
        self.params, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
        for p, in zip_leaves(self.params):
            p.grad = None
        return value, out.detach()

    def _auto_parallelize(self, bx, by, log_fn: Callable = print) -> None:
        """JAX's measured (dp, tp) search over the ranks
        (``flexflow_tpu/ffmodel/model.py`` ``_auto_parallelize``): the
        candidates of ``cut.candidates``, each built on every rank (its
        mesh and cut, copies of the parameters and batch-norm statistics,
        a fresh optimizer state) and timed on a warm-up step and one more
        on (``bx``, ``by``) with a dropout generator of its own
        (``parallel/auto.measure_layout``: the build agreed, the slowest
        rank's time). The model then keeps the fastest's cut of its
        pre-search parameters, a fresh optimizer state and its batch-norm
        statistics, as JAX re-places ``self.params``. Raises when no
        candidate ran (JAX stays on one device)."""
        from flexflow_tpu_torch.ffmodel import cut as cut_lib
        from flexflow_tpu_torch.parallel import auto as auto_lib
        from flexflow_tpu_torch.parallel.mesh import make_mesh

        n = auto_lib.device_count(self.device)
        dev = auto_lib.search_device(self.device, n)
        batch = by.shape[0]
        whole, state, opt_state = self.params, self.state, self.opt_state

        def views(tp, kind):
            return (cut_lib.uniform_views(whole, tp) if kind == "uniform"
                    else cut_lib.joint_views(whole, self.joint_plan, tp))

        def build(cand):
            dp, tp, kind = cand
            if dp > 1:
                mixed = cut_lib.mixed_rows(self._nodes, batch)
                if mixed:
                    raise NotImplementedError(f"data={dp}: {mixed} mixes the batch's rows")
            mesh = make_mesh(data=dp, model=tp, device=dev)

            def build_step():
                cut = cut_lib.Cut(mesh, views(tp, kind))
                params = cut.place(whole)
                run_state = {k: {n_: v.clone() for n_, v in st.items()} for k, st in state.items()}
                rows = cut.rows(batch)
                inputs = self._to_inputs([np.asarray(a)[rows] for a in bx])
                labels = self._to_labels(np.asarray(by)[rows])
                gen = torch.Generator(device=dev).manual_seed(0)
                held = {"opt": self.optimizer.init(params)}

                def run():
                    self.params, self.state, self.opt_state, self._cut = (
                        params, run_state, held["opt"], cut)
                    try:
                        loss, _ = self._step(inputs, labels, gen)
                        loss.item()  # waits for the step
                        held["opt"] = self.opt_state
                    finally:
                        self.params, self.state, self.opt_state, self._cut = (
                            whole, state, opt_state, None)

                return run

            return auto_lib.on_mesh(mesh, build_step)

        report, best = [], None
        for cand in cut_lib.candidates(n, batch, self.joint_plan):
            dp, tp, kind = cand
            label = f"dp={dp} tp={tp}" + (" (joint per-op views)" if kind == "joint" else "")
            t, err = auto_lib.measure_layout(build, cand, warmup=1, reps=1, device=dev)
            report.append({"layout": label, "error": err} if err else
                          {"layout": label, "measured_s": t})
            if err is None and (best is None or t < best[0]):
                best = (t, cand)
        self.auto_report = report
        if best is None:
            raise RuntimeError("no auto-parallel candidate ran: " + "; ".join(
                f"{r['layout']}: {r['error']}" for r in report))
        dp, tp, kind = best[1]
        if auto_lib.speaks():
            log_fn(f"[auto-parallel] chose dp={dp} tp={tp} over {len(report)} candidates")
        self._cut = cut_lib.Cut(make_mesh(data=dp, model=tp, device=dev), views(tp, kind))
        self.params = self._cut.place(whole)
        self.opt_state = self.optimizer.init(self.params)

    def full_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The whole parameter tree, detached: under a cut each rank's
        slices gathered over the model ranks (every rank calls it)."""
        self._require_compiled()
        if self._cut is None:
            return tree_map(lambda p: p.detach(), self.params)
        return self._cut.gather(self.params)

    def _batches(self, arrays, batch_size, shuffle=False, seed=0):
        n = arrays[0].shape[0]
        idx = np.arange(n)
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = idx[i:i + batch_size]
            yield [np.asarray(a)[sel] for a in arrays]

    def fit(self, x, y, *, batch_size: int, epochs: int = 1,
            shuffle: bool = True, log_fn: Callable = print,
            log_every: int = 0) -> List[dict]:
        """Train for ``epochs`` over ``batch_size`` batches (shuffled with
        ``np.random.RandomState(epoch)``, as JAX does); one history entry an
        epoch with its mean loss and accuracy. With the search pending
        (``compile(auto_parallel=True)`` over more than one rank) the first
        batch runs it first; under its cut each data rank steps on its rows
        of every batch (every rank calls ``fit`` alike)."""
        self._require_compiled()
        xs = x if isinstance(x, (list, tuple)) else [x]
        if self._pending_auto:  # JAX: the search at the first batch
            self._pending_auto = False
            first = next(self._batches(list(xs) + [y], batch_size), None)
            if first is not None:
                *bx, by = first
                self._auto_parallelize(bx, by, log_fn=log_fn)
        gen = torch.Generator(device=self.device).manual_seed(self._seed + 1)  # dropout
        history = []
        for epoch in range(epochs):
            losses = []
            self.metrics = PerfMetrics()
            for batch in self._batches(list(xs) + [y], batch_size, shuffle, seed=epoch):
                if self._cut is not None:  # this data rank's rows
                    rows = self._cut.rows(batch_size)
                    batch = [a[rows] for a in batch]
                *bx, by = batch
                labels = self._to_labels(by)
                loss, out = self._step(self._to_inputs(bx), labels, gen)
                losses.append(loss.item())
                self.metrics.update(self._metrics(out, labels, rows=True))
                if log_every and len(losses) % log_every == 0:
                    log_fn(f"epoch {epoch} it {len(losses)}: "
                           f"loss={losses[-1]:.4f} acc={self.metrics.accuracy:.4f}")
            history.append({"epoch": epoch,
                            "loss": float(np.mean(losses)) if losses else 0.0,
                            "accuracy": self.metrics.accuracy})
        return history

    @torch.no_grad()
    def evaluate(self, x, y, *, batch_size: int) -> dict:
        """The mean loss and the accuracy over ``batch_size`` batches. Under
        a cut every rank runs every row (the model ranks' cut ops, no data
        split) and gets the whole result."""
        self._require_compiled()
        xs = x if isinstance(x, (list, tuple)) else [x]
        total, n = 0.0, 0
        pm = PerfMetrics()
        for batch in self._batches(list(xs) + [y], batch_size):
            *bx, by = batch
            labels = self._to_labels(by)
            out = self._run(self._to_inputs(bx), False)
            total += self.loss_fn(out, labels).item()
            pm.update(self._metrics(out, labels))
            n += 1
        return {"loss": total / max(n, 1), "accuracy": pm.accuracy}

    @torch.no_grad()
    def forward(self, x) -> np.ndarray:
        """The graph's output on host arrays ``x`` (one, or a list), as numpy
        (under a cut: every row on every rank, as ``evaluate``)."""
        self._require_compiled()
        xs = x if isinstance(x, (list, tuple)) else [x]
        return self._run(self._to_inputs(xs), False).cpu().numpy()

    # ------------------------------------------------------------------
    # graph export
    # ------------------------------------------------------------------

    def export_dot(self, path: Optional[str] = None) -> str:
        """Graphviz dot of the layer graph (op, name, output shapes)."""
        lines = ["digraph ffmodel {", "  rankdir=TB;",
                 '  node [shape=record, fontsize=10];']
        for nid, node in enumerate(self._nodes):
            shapes = ",".join(str(s) for s in node.out_shapes)
            label = f"{node.name}|{node.op}|{shapes}".replace("(", "[").replace(")", "]")
            lines.append(f'  n{nid} [label="{{{label}}}"];')
            for t in node.inputs:
                lines.append(f"  n{t.node} -> n{nid};")
        lines.append("}")
        dot = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(dot)
        return dot
