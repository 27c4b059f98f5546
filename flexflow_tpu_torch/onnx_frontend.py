"""ONNX frontend: ONNX graph -> FFModel DSL (+ initializer weights) (port of
``flexflow_tpu/onnx_frontend.py``).

Uses the ``onnx`` package when installed; otherwise it parses with the
bundled pure-Python protobuf codec (``flexflow_tpu_torch.utils.onnx_proto``),
so .onnx files load with no extra dependency. Which parser reads the file
has nothing to do with the device: the model is built on ``device``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from flexflow_tpu_torch.ffmodel import FFModel
from flexflow_tpu_torch.ffmodel.model import to_numpy_dtype


def _attr(node, name, default=None):
    for a in node.attribute:
        if a.name == name:
            if a.type == 1:
                return a.f
            if a.type == 2:
                return a.i
            if a.type == 7:
                return list(a.ints)
            if a.type == 6:
                return list(a.floats)
            if a.type == 3:
                return a.s.decode()
    return default


def _scalar(a) -> float:
    """A one-element initializer or Constant as a float."""
    return float(np.asarray(a).reshape(()))


def from_onnx_model(
    model_or_path,
    *,
    batch_size: int = 32,
    device=None,
) -> FFModel:
    """Build an FFModel on ``device`` from an onnx.ModelProto (or a path to a
    .onnx file).

    Initializer weights transfer into the DSL params via
    :func:`apply_onnx_weights` after ``compile()``.
    """
    try:
        import onnx
        from onnx import numpy_helper

        _load, _to_array = onnx.load, numpy_helper.to_array
    except ImportError:  # bundled pure-Python fallback
        from flexflow_tpu_torch.utils import onnx_proto

        _load, _to_array = onnx_proto.load, onnx_proto.tensor_to_array

    model = (
        _load(model_or_path)
        if isinstance(model_or_path, str)
        else model_or_path
    )
    graph = model.graph
    inits: Dict[str, np.ndarray] = {
        i.name: _to_array(i) for i in graph.initializer
    }

    ff = FFModel(device=device)
    env: Dict[str, Any] = {}
    const_vals: Dict[str, np.ndarray] = {}  # Constant-node outputs by value
    weight_loads = []

    def shape_input(node, idx, what):
        """Value of a shape-like operand: graph initializer OR Constant-node
        output. Anything else (runtime-computed shapes) fails LOUDLY with
        the op name instead of an opaque KeyError/TypeError downstream."""
        name = node.input[idx]
        if name in inits:
            return inits[name]
        if name in const_vals:
            return const_vals[name]
        raise NotImplementedError(
            f"ONNX {node.op_type}: {what} input {name!r} must be an "
            f"initializer or Constant output (runtime-computed values are "
            f"not supported)")

    for vi in graph.input:
        if vi.name in inits:
            continue
        dims = [
            d.dim_value if d.dim_value > 0 else batch_size
            for d in vi.type.tensor_type.shape.dim
        ]
        dims[0] = batch_size
        env[vi.name] = ff.create_tensor(tuple(dims))

    for node in graph.node:
        op = node.op_type
        ins = node.input
        x = env.get(ins[0]) if ins else None  # Constant nodes have no inputs
        if op == "Gemm":
            w = inits[ins[1]]
            # the full Gemm attribute set: Y = alpha * op(A) @ op(B) + beta * C
            trans_b = _attr(node, "transB", 0)
            trans_a = _attr(node, "transA", 0)
            alpha = _attr(node, "alpha", 1.0)
            beta = _attr(node, "beta", 1.0)
            w_np = (w.T if trans_b else w) * alpha
            if trans_a:
                x = ff.transpose(x, list(range(x.ndim - 2))
                                 + [x.ndim - 1, x.ndim - 2])
            out_dim = w_np.shape[1]
            b_np = inits.get(ins[2]) if len(ins) > 2 else None
            t = ff.dense(x, out_dim, use_bias=b_np is not None, name=node.name or ins[1])
            name = ff._nodes[t.node].name
            weight_loads.append(
                (name, w_np.astype(np.float32),
                 None if b_np is None else (b_np * beta).astype(np.float32)))
            env[node.output[0]] = t
        elif op == "MatMul":
            if ins[1] in inits:
                w_np = inits[ins[1]]
                t = ff.dense(x, w_np.shape[-1], use_bias=False,
                             name=node.name or ins[1])
                name = ff._nodes[t.node].name
                weight_loads.append((name, w_np.astype(np.float32), None))
                env[node.output[0]] = t
            else:
                env[node.output[0]] = ff.batch_matmul(x, env[ins[1]])
        elif op == "Conv":
            w = inits[ins[1]]
            strides = _attr(node, "strides", [1, 1])
            pads = _attr(node, "pads", [0, 0, 0, 0])
            group = _attr(node, "group", 1)
            b_np = inits.get(ins[2]) if len(ins) > 2 else None
            t = ff.conv2d(x, w.shape[0], w.shape[2], w.shape[3],
                          strides[0], strides[1], pads[0], pads[1],
                          groups=group, use_bias=b_np is not None,
                          name=node.name or ins[1])
            name = ff._nodes[t.node].name
            weight_loads.append(
                (name, w.astype(np.float32),
                 None if b_np is None else b_np.astype(np.float32)))
            env[node.output[0]] = t
        elif op in ("MaxPool", "AveragePool"):
            kernel = _attr(node, "kernel_shape")
            strides = _attr(node, "strides", kernel)
            pads = _attr(node, "pads", [0, 0, 0, 0])
            env[node.output[0]] = ff.pool2d(
                x, kernel[0], kernel[1], strides[0], strides[1],
                pads[0], pads[1],
                "max" if op == "MaxPool" else "avg", name=node.name)
        elif op == "BatchNormalization":
            eps = _attr(node, "epsilon", 1e-5)
            t = ff.batch_norm(x, relu=False, eps=eps, name=node.name or ins[1])
            name = ff._nodes[t.node].name
            weight_loads.append(
                (name, {"scale": inits[ins[1]], "bias": inits[ins[2]],
                        "__state__": {"mean": inits[ins[3]],
                                      "var": inits[ins[4]]}}, None))
            env[node.output[0]] = t
        elif op == "Relu":
            env[node.output[0]] = ff.relu(x)
        elif op == "Sigmoid":
            env[node.output[0]] = ff.sigmoid(x)
        elif op == "Tanh":
            env[node.output[0]] = ff.tanh(x)
        elif op == "Softmax":
            env[node.output[0]] = ff.softmax(x, axis=_attr(node, "axis", -1))
        elif op == "Add":
            env[node.output[0]] = ff.add(x, env[ins[1]])
        elif op == "Sub":
            env[node.output[0]] = ff.subtract(x, env[ins[1]])
        elif op == "Mul":
            env[node.output[0]] = ff.multiply(x, env[ins[1]])
        elif op == "Concat":
            env[node.output[0]] = ff.concat(
                [env[i] for i in ins], axis=_attr(node, "axis", 0))
        elif op == "Flatten":
            env[node.output[0]] = ff.flat(x)
        elif op == "Reshape":
            shape = inits[ins[1]].tolist()
            total = int(np.prod(x.shape))
            shape = [s if s != 0 else x.shape[i] for i, s in enumerate(shape)]
            if -1 in shape:
                known = int(np.prod([s for s in shape if s != -1]))
                shape[shape.index(-1)] = total // known
            env[node.output[0]] = ff.reshape(x, shape)
        elif op == "Transpose":
            env[node.output[0]] = ff.transpose(x, _attr(node, "perm"))
        elif op in ("Dropout", "Identity"):
            env[node.output[0]] = x
        elif op == "Div":
            env[node.output[0]] = ff.divide(x, env[ins[1]])
        elif op == "Split":
            axis = _attr(node, "axis", 0)
            sizes = _attr(node, "split")
            if sizes is None and len(ins) > 1:
                sizes = shape_input(node, 1, "split").tolist()  # opset>=13
            if sizes is None:
                n = len(node.output)
                sizes = [x.shape[axis] // n] * n
            parts = ff.split(x, sizes, axis=axis)
            for o, p in zip(node.output, parts):
                env[o] = p
        elif op == "GlobalAveragePool":
            _, _, h, w_ = x.shape
            env[node.output[0]] = ff.pool2d(x, h, w_, h, w_, 0, 0, "avg",
                                            name=node.name)
        elif op == "Pad":
            pads = _attr(node, "pads")
            if pads is None and len(ins) > 1:
                pads = shape_input(node, 1, "pads").tolist()  # opset>=11
            val = _attr(node, "value", 0.0)
            if len(ins) > 2 and (ins[2] in inits or ins[2] in const_vals):
                val = _scalar(shape_input(node, 2, "constant_value"))
            nd = x.ndim
            pw = [(int(pads[i]), int(pads[i + nd])) for i in range(nd)]
            env[node.output[0]] = ff.pad(x, pw, val)
        elif op == "Cast":
            to = _attr(node, "to", 1)
            dt = {1: torch.float32, 6: torch.int32, 7: torch.int32,
                  9: torch.bool, 10: torch.float16, 16: torch.bfloat16}.get(
                      to, torch.float32)
            env[node.output[0]] = ff.cast(x, dt)
        elif op in ("Unsqueeze", "Squeeze"):
            axes = _attr(node, "axes")
            if axes is None and len(ins) > 1:
                axes = shape_input(node, 1, "axes").tolist()
            shape = list(x.shape)
            if op == "Unsqueeze":
                # axes index into the OUTPUT rank (x.ndim + len(axes)):
                # normalizing by x.ndim+1 breaks multi-axis/negative cases
                out_rank = x.ndim + len(axes)
                for a in sorted(int(a) % out_rank for a in axes):
                    shape.insert(a, 1)
            else:
                if axes is None:
                    shape = [d for d in shape if d != 1]
                else:
                    drop = {int(a) % x.ndim for a in axes}
                    if not all(shape[a] == 1 for a in drop):
                        raise ValueError(f"Squeeze of axes {axes} on shape {shape}")
                    shape = [d for i, d in enumerate(shape) if i not in drop]
            env[node.output[0]] = ff.reshape(x, shape)
        elif op == "Expand":
            tgt = shape_input(node, 1, "shape").tolist()
            shape = list(x.shape)
            pad_nd = len(tgt) - len(shape)
            out_shape = [
                int(t_) if int(t_) != 1 else (shape[i - pad_nd]
                                              if i >= pad_nd else 1)
                for i, t_ in enumerate(tgt)
            ]
            if pad_nd:
                x = ff.reshape(x, [1] * pad_nd + shape)
            np_dt = to_numpy_dtype(x.dtype)
            env[node.output[0]] = ff.add(
                x, ff.constant(np.zeros(out_shape, np_dt), dtype=x.dtype))
        elif op == "Constant":
            val = _attr(node, "value")
            if val is None:  # tensor attribute (type 4) — decode manually
                for a in node.attribute:
                    if a.name == "value":
                        val = _to_array(a.t)
            const_vals[node.output[0]] = np.asarray(val)
            env[node.output[0]] = ff.constant(np.asarray(val))
        elif op == "LeakyRelu":
            env[node.output[0]] = ff.leaky_relu(
                x, _attr(node, "alpha", 0.01))
        elif op == "Clip":
            lo = _attr(node, "min")
            hi = _attr(node, "max")
            if lo is None and len(ins) > 1 and ins[1]:
                lo = _scalar(shape_input(node, 1, "min"))
            if hi is None and len(ins) > 2 and ins[2]:
                hi = _scalar(shape_input(node, 2, "max"))
            env[node.output[0]] = ff.clamp(x, lo, hi)
        elif op == "Exp":
            env[node.output[0]] = ff.exp(x)
        elif op == "Sqrt":
            env[node.output[0]] = ff.sqrt(x)
        elif op == "Pow":
            env[node.output[0]] = ff.pow(
                x, _scalar(shape_input(node, 1, "exponent")))
        elif op == "ReduceMean":
            axes = _attr(node, "axes")
            if axes is None and len(ins) > 1:
                axes = shape_input(node, 1, "axes").tolist()
            keep = bool(_attr(node, "keepdims", 1))
            env[node.output[0]] = ff.mean(
                x, [int(a) % x.ndim for a in axes], keepdims=keep)
        elif op == "Gather":
            # embedding-style gather: data is an initializer table
            if ins[0] in inits:
                table = inits[ins[0]]
                idx = env[ins[1]]
                t = ff.take(ff.constant(table.astype(np.float32)), idx,
                            axis=_attr(node, "axis", 0))
                env[node.output[0]] = t
            else:
                env[node.output[0]] = ff.take(
                    x, env[ins[1]], axis=_attr(node, "axis", 0))
        else:
            raise NotImplementedError(f"ONNX op {op}")

    ff._onnx_weight_loads = weight_loads
    return ff


def apply_onnx_weights(ff: FFModel) -> None:
    """After ff.compile(): overwrite initialized params with ONNX weights."""
    params, state = {}, {}
    for name, w, b in getattr(ff, "_onnx_weight_loads", []):
        if isinstance(w, dict):
            w = dict(w)
            st = w.pop("__state__", None)
            params[name] = w
            if st:
                state[name] = st
            continue
        params[name] = {"w": w} if b is None else {"w": w, "b": b}
    ff.load_numpy(params, state)
