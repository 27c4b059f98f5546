"""PyTorch frontend: torch.fx symbolic trace -> FFModel DSL graph (+weights)
(port of ``flexflow_tpu/torch_frontend.py``, every fx node kind it maps).

The module is traced with ``torch.fx`` and rebuilt as FFModel ops on the
model's device; ``apply_torch_weights`` then carries the module's weights
in, so the imported model computes what the module does.
"""

from __future__ import annotations

import operator
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.fx
import torch.nn as tnn
import torch.nn.functional as F

from flexflow_tpu_torch.ffmodel import FFModel
from flexflow_tpu_torch.ffmodel.model import Tensor, to_numpy_dtype


def _support(cond: bool, what: str) -> None:
    if not cond:
        raise NotImplementedError(what)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _adaptive_pool(ff, x, output_size, pool_type):
    """AdaptiveAvg/MaxPool2d for divisible sizes: kernel = stride = in/out
    (matches torch exactly in the divisible case, which is every
    torchvision classifier head)."""
    oh, ow = _pair(output_size)
    _, _, h, w = x.shape
    if h % oh or w % ow:
        raise NotImplementedError(
            f"adaptive pool needs divisible sizes, got {h}x{w} -> {oh}x{ow}"
        )
    sh, sw = h // oh, w // ow
    return ff.pool2d(x, sh, sw, sh, sw, 0, 0, pool_type)


def _quad(padding):
    """torch 2d padding spec -> (left, right, top, bottom)."""
    if isinstance(padding, int):
        return padding, padding, padding, padding
    p = tuple(padding)
    _support(len(p) == 4, f"expected int or 4-tuple padding, got {p}")
    return p  # (l, r, t, b)


def _upsample_nearest(ff, x, scale_factor, size=None):
    """Nearest-neighbor integer upsample via reshape+concat replication.

    ``size=(H_out, W_out)`` (nn.Upsample(size=...) / F.interpolate(size=...))
    derives integer scales from the input shape; a None scale_factor without
    a size raises."""
    if scale_factor is None:
        if size is None:
            raise NotImplementedError(
                "Upsample/interpolate needs scale_factor or size"
            )
        oh, ow = _pair(size)
        _, _, h, w = x.shape
        if oh % h or ow % w:
            raise NotImplementedError(
                f"nearest upsample needs integer scale, got {h}x{w} -> "
                f"{oh}x{ow}"
            )
        scale_factor = (oh // h, ow // w)
    sh, sw = _pair(scale_factor)
    sh, sw = int(sh), int(sw)
    b, c, h, w = x.shape
    y = ff.reshape(x, [b, c, h, 1, w])
    y = ff.concat([y] * sh, axis=3)
    y = ff.reshape(y, [b, c, h * sh, w, 1])
    y = ff.concat([y] * sw, axis=4)
    return ff.reshape(y, [b, c, h * sh, w * sw])


def _expand_to(ff, x, sizes):
    """torch .expand: broadcast singleton dims to ``sizes`` (-1 = keep)."""
    tgt = []
    pad = len(sizes) - x.ndim
    xs = (1,) * pad + tuple(x.shape)
    for i, want in enumerate(sizes):
        tgt.append(xs[i] if want == -1 else int(want))
    if pad:
        x = ff.reshape(x, list(xs))
    if tuple(tgt) == xs:
        return x
    # broadcast by adding a zeros constant of the input's dtype: a float32
    # zeros would silently promote integer/bool runtime values while the
    # graph metadata keeps the declared dtype
    np_dt = to_numpy_dtype(x.dtype)
    return ff.add(x, ff.constant(np.zeros(tgt, np_dt), dtype=x.dtype))


def _getitem_tensor(ff, x, idx):
    """torch basic indexing on a traced tensor -> DSL slice op."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    norm = []
    for i, e in enumerate(idx):
        if e is Ellipsis:
            # expand ellipsis to full slices for the skipped dims
            rest = len(idx) - i - 1
            norm.extend([(None, None, None)] * (x.ndim - len(norm) - rest))
        elif isinstance(e, slice):
            norm.append((e.start, e.stop, e.step))
        elif isinstance(e, int):
            norm.append(e)
        else:
            raise NotImplementedError(f"tensor getitem index {e!r}")
    return ff.slice_tensor(x, norm)


def _reduce_dims(node, x, argpos=1):
    dims = node.kwargs.get(
        "dim", node.args[argpos] if len(node.args) > argpos else None)
    keep = bool(node.kwargs.get("keepdim", False))
    if dims is None:
        dims = list(range(x.ndim))
    if isinstance(dims, int):
        dims = [dims]
    dims = [d % x.ndim for d in dims]
    return dims, keep


def from_torch_module(
    module,
    input_shapes: Sequence[Tuple[int, ...]],
    *,
    batch_size: int = 32,
    input_dtypes: Sequence[Any] = (),
    transfer_weights: bool = True,
    device=None,
) -> FFModel:
    """Trace a ``torch.nn.Module`` into a (compiled-ready) FFModel on
    ``device``.

    ``input_shapes`` exclude the batch dim. Call ``ff.compile(...)`` on the
    result, then ``apply_torch_weights(ff)``; pass ``transfer_weights=False``
    to keep fresh initialization.
    """
    gm = torch.fx.symbolic_trace(module)
    ff = FFModel(device=device)
    env: Dict[str, Any] = {}
    weight_loads = []  # (dsl_node_name, loader_fn)
    in_iter = iter(range(len(input_shapes)))
    dtypes = list(input_dtypes) or [torch.float32] * len(input_shapes)

    def t(x):
        """fx arg -> DSL tensor or python value."""
        if isinstance(x, torch.fx.Node):
            return env[x.name]
        return x

    def mark(node, out):
        env[node.name] = out

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            i = next(in_iter)
            mark(node, ff.create_tensor(
                (batch_size,) + tuple(input_shapes[i]), dtypes[i]))
        elif node.op == "call_module":
            sub = gm.get_submodule(node.target)
            x = t(node.args[0])
            if isinstance(sub, tnn.Linear):
                out = ff.dense(x, sub.out_features,
                               use_bias=sub.bias is not None, name=node.name)
                if transfer_weights:
                    weight_loads.append((node.name, _linear_loader(sub)))
            elif isinstance(sub, tnn.Conv2d):
                ph, pw = _pair(sub.padding)
                sh, sw = _pair(sub.stride)
                kh, kw = _pair(sub.kernel_size)
                out = ff.conv2d(x, sub.out_channels, kh, kw, sh, sw, ph, pw,
                                groups=sub.groups,
                                use_bias=sub.bias is not None, name=node.name)
                if transfer_weights:
                    weight_loads.append((node.name, _conv_loader(sub)))
            elif isinstance(sub, tnn.ConvTranspose2d):
                _support(sub.groups == 1, "grouped deconv unsupported")
                ph, pw = _pair(sub.padding)
                sh, sw = _pair(sub.stride)
                kh, kw = _pair(sub.kernel_size)
                oph, opw = _pair(sub.output_padding)
                out = ff.conv2d_transpose(
                    x, sub.out_channels, kh, kw, sh, sw, ph, pw, oph, opw,
                    use_bias=sub.bias is not None, name=node.name)
                if transfer_weights:
                    # torch ConvTranspose2d weight [I, O, KH, KW] == ours
                    weight_loads.append((node.name, _conv_loader(sub)))
            elif isinstance(sub, tnn.GroupNorm):
                out = ff.group_norm(x, sub.num_groups, eps=sub.eps,
                                    affine=sub.affine, name=node.name)
                if transfer_weights and sub.affine:
                    weight_loads.append((node.name, _gn_loader(sub)))
            elif isinstance(sub, tnn.MultiheadAttention):
                _support(sub.batch_first, "trace with batch_first=True")
                q_in = x
                k_in = t(node.args[1]) if len(node.args) > 1 else q_in
                v_in = t(node.args[2]) if len(node.args) > 2 else k_in
                out_t = ff.multihead_attention(
                    q_in, k_in, v_in, sub.embed_dim, sub.num_heads,
                    name=node.name)
                if transfer_weights:
                    weight_loads.append((node.name, _mha_loader(sub)))
                # torch MHA returns (output, attn_weights): mirror the tuple
                # so downstream getitem nodes resolve
                out = (out_t, None)
            elif isinstance(sub, tnn.MaxPool2d):
                kh, kw = _pair(sub.kernel_size)
                sh, sw = _pair(sub.stride or sub.kernel_size)
                ph, pw = _pair(sub.padding)
                out = ff.pool2d(x, kh, kw, sh, sw, ph, pw, "max", name=node.name)
            elif isinstance(sub, tnn.AvgPool2d):
                kh, kw = _pair(sub.kernel_size)
                sh, sw = _pair(sub.stride or sub.kernel_size)
                ph, pw = _pair(sub.padding)
                out = ff.pool2d(x, kh, kw, sh, sw, ph, pw, "avg", name=node.name)
            elif isinstance(sub, (tnn.BatchNorm2d, tnn.BatchNorm1d)):
                out = ff.batch_norm(x, relu=False, momentum=1 - sub.momentum,
                                    eps=sub.eps, name=node.name)
                if transfer_weights:
                    weight_loads.append((node.name, _bn_loader(sub)))
            elif isinstance(sub, tnn.LayerNorm):
                out = ff.layer_norm(x, eps=sub.eps,
                                    elementwise_affine=sub.elementwise_affine,
                                    name=node.name)
                if transfer_weights and sub.elementwise_affine:
                    weight_loads.append((node.name, _ln_loader(sub)))
            elif isinstance(sub, tnn.Embedding):
                out = ff.embedding(x, sub.num_embeddings, sub.embedding_dim,
                                   name=node.name)
                if transfer_weights:
                    weight_loads.append(
                        (node.name,
                         lambda s=sub: {"w": _np(s.weight)}))
            elif isinstance(sub, tnn.ReLU):
                out = ff.relu(x)
            elif isinstance(sub, tnn.ReLU6):
                out = ff.clamp(x, 0.0, 6.0)
            elif isinstance(sub, tnn.Sigmoid):
                out = ff.sigmoid(x)
            elif isinstance(sub, tnn.Tanh):
                out = ff.tanh(x)
            elif isinstance(sub, tnn.GELU):
                out = ff.gelu(x)
            elif isinstance(sub, tnn.SiLU):
                out = ff.silu(x)
            elif isinstance(sub, tnn.Hardswish):
                out = ff.hardswish(x)
            elif isinstance(sub, tnn.Hardsigmoid):
                out = ff.hardsigmoid(x)
            elif isinstance(sub, tnn.LeakyReLU):
                out = ff.leaky_relu(x, sub.negative_slope)
            elif isinstance(sub, tnn.ELU):
                out = ff.elu(x)
            elif isinstance(sub, tnn.Conv1d):
                # [B, C, L] -> conv2d over a height-1 plane -> [B, C', L']
                _support(sub.groups == 1, "grouped conv1d unsupported")
                k, st, pd = (sub.kernel_size[0], sub.stride[0],
                             sub.padding[0])
                bb, cc, ll = x.shape
                x4 = ff.reshape(x, [bb, cc, 1, ll])
                y = ff.conv2d(x4, sub.out_channels, 1, k, 1, st, 0, pd,
                              use_bias=sub.bias is not None, name=node.name)
                out = ff.reshape(y, [y.shape[0], y.shape[1], y.shape[3]])
                if transfer_weights:
                    weight_loads.append((node.name, _conv1d_loader(sub)))
            elif isinstance(sub, tnn.PReLU):
                # prelu(x) = relu(x) + a * min(x, 0); slope(s) enter as a
                # frozen constant (per-channel [C] broadcasts over [B,C,H,W])
                w = _np(sub.weight)
                neg = ff.min(x, ff.constant(np.zeros((), np.float32)))
                if w.size == 1:
                    scaled = ff.scalar_multiply(neg, float(w.reshape(())))
                else:
                    cshape = (w.size,) + (1,) * (x.ndim - 2)
                    scaled = ff.multiply(
                        neg, ff.constant(w.reshape(cshape)))
                out = ff.add(ff.relu(x), scaled)
            elif isinstance(sub, tnn.Softplus):
                _support(sub.beta == 1 and sub.threshold >= 20,
                         "nonstandard Softplus params unsupported")
                out = ff.softplus(x)
            elif isinstance(sub, tnn.Mish):
                out = ff.mish(x)
            elif isinstance(sub, tnn.GLU):
                d = sub.dim % x.ndim
                half = x.shape[d] // 2
                a_t, b_t = ff.split(x, [half, half], axis=d)
                out = ff.multiply(a_t, ff.sigmoid(b_t))
            elif isinstance(sub, (tnn.ZeroPad2d, tnn.ConstantPad2d)):
                pl, pr, pt, pb = _quad(sub.padding)
                val = float(getattr(sub, "value", 0.0))
                out = ff.pad(x, [(0, 0), (0, 0), (pt, pb), (pl, pr)], val)
            elif isinstance(sub, tnn.Upsample):
                _support(sub.mode == "nearest", "only nearest Upsample")
                out = _upsample_nearest(ff, x, sub.scale_factor,
                                        size=sub.size)
            elif isinstance(sub, tnn.AdaptiveAvgPool2d):
                out = _adaptive_pool(ff, x, sub.output_size, "avg")
            elif isinstance(sub, tnn.AdaptiveMaxPool2d):
                out = _adaptive_pool(ff, x, sub.output_size, "max")
            elif isinstance(sub, tnn.Softmax):
                out = ff.softmax(x, axis=sub.dim if sub.dim is not None else -1)
            elif isinstance(sub, tnn.Dropout):
                out = ff.dropout(x, sub.p, name=node.name)
            elif isinstance(sub, tnn.Flatten):
                out = ff.flat(x)
            elif isinstance(sub, tnn.Identity):
                out = x
            else:
                raise NotImplementedError(f"torch module {type(sub).__name__}")
            mark(node, out)
        elif node.op == "call_function":
            fn = node.target
            args = [t(a) for a in node.args]
            if fn in (operator.add, torch.add):
                out = (ff.add(args[0], args[1])
                       if isinstance(args[1], Tensor)
                       else ff.scalar_add(args[0], float(args[1])))
            elif fn in (operator.sub, torch.sub):
                out = (ff.subtract(args[0], args[1])
                       if isinstance(args[1], Tensor)
                       else ff.scalar_sub(args[0], float(args[1])))
            elif fn in (operator.mul, torch.mul):
                out = (ff.multiply(args[0], args[1])
                       if isinstance(args[1], Tensor)
                       else ff.scalar_multiply(args[0], float(args[1])))
            elif fn in (operator.truediv, torch.div):
                out = (ff.divide(args[0], args[1])
                       if isinstance(args[1], Tensor)
                       else ff.scalar_true_divide(args[0], float(args[1])))
            elif fn is F.relu or fn is torch.relu:
                out = ff.relu(args[0])
            elif fn is torch.sigmoid or fn is F.sigmoid:
                out = ff.sigmoid(args[0])
            elif fn is torch.tanh or fn is F.tanh:
                out = ff.tanh(args[0])
            elif fn is F.gelu:
                out = ff.gelu(args[0])
            elif fn is F.softmax or fn is torch.softmax:
                dim = node.kwargs.get("dim", node.args[1] if len(node.args) > 1 else -1)
                out = ff.softmax(args[0], axis=dim)
            elif fn is torch.flatten:
                sd = node.kwargs.get(
                    "start_dim", node.args[1] if len(node.args) > 1 else 0)
                ed = node.kwargs.get(
                    "end_dim", node.args[2] if len(node.args) > 2 else -1)
                xt = args[0]
                sd, ed = sd % xt.ndim, ed % xt.ndim
                merged = int(np.prod(xt.shape[sd:ed + 1]))
                out = ff.reshape(
                    xt,
                    list(xt.shape[:sd]) + [merged] + list(xt.shape[ed + 1:]))
            elif fn is torch.cat:
                dim = node.kwargs.get("dim", node.args[1] if len(node.args) > 1 else 0)
                out = ff.concat([t(a) for a in node.args[0]], axis=dim)
            elif fn is torch.exp:
                out = ff.exp(args[0])
            elif fn is operator.getitem:
                out = (
                    _getitem_tensor(ff, args[0], node.args[1])
                    if isinstance(args[0], Tensor)
                    else args[0][node.args[1]]
                )
            elif fn is getattr:
                attr = node.args[1]
                if attr == "shape" and isinstance(args[0], Tensor):
                    out = tuple(int(d) for d in args[0].shape)
                elif attr == "ndim" and isinstance(args[0], Tensor):
                    out = args[0].ndim
                elif attr == "dtype" and isinstance(args[0], Tensor):
                    out = args[0].dtype
                else:
                    raise NotImplementedError(f"getattr {attr!r}")
            elif fn in (torch.matmul, operator.matmul, torch.bmm):
                out = ff.batch_matmul(args[0], args[1])
            elif fn in (operator.pow, torch.pow):
                out = ff.pow(args[0], float(node.args[1]))
            elif fn is torch.rsqrt:
                out = ff.rsqrt(args[0])
            elif fn is torch.sqrt:
                out = ff.sqrt(args[0])
            elif fn is torch.log:
                out = ff.log(args[0])
            elif fn is torch.sin:
                out = ff.sin(args[0])
            elif fn is torch.cos:
                out = ff.cos(args[0])
            elif fn is F.elu:
                out = ff.elu(args[0])
            elif fn is F.dropout:
                out = ff.dropout(args[0], rate=node.kwargs.get("p", 0.5))
            elif fn is torch.mean:
                dims = node.kwargs.get(
                    "dim", node.args[1] if len(node.args) > 1 else None)
                keep = bool(node.kwargs.get("keepdim", False))
                if dims is None:
                    dims = list(range(args[0].ndim))
                if isinstance(dims, int):
                    dims = [dims]
                out = ff.mean(args[0], dims, keepdims=keep)
            elif fn is torch.unsqueeze:
                d = node.args[1] % (args[0].ndim + 1)
                shape = list(args[0].shape)
                shape.insert(d, 1)
                out = ff.reshape(args[0], shape)
            elif fn is torch.transpose:
                d0, d1 = node.args[1], node.args[2]
                perm = list(range(args[0].ndim))
                perm[d0], perm[d1] = perm[d1], perm[d0]
                out = ff.transpose(args[0], perm)
            elif fn is torch.permute:
                out = ff.transpose(args[0], list(node.args[1]))
            elif fn is torch.reshape:
                out = ff.reshape(args[0], list(node.args[1]))
            elif fn is torch.squeeze:
                if len(node.args) > 1:
                    d = node.args[1] % args[0].ndim
                    if args[0].shape[d] != 1:  # torch: no-op unless size 1
                        out = args[0]
                    else:
                        out = ff.reshape(
                            args[0],
                            [s for i, s in enumerate(args[0].shape)
                             if i != d])
                else:
                    out = ff.reshape(
                        args[0], [s for s in args[0].shape if s != 1])
            elif fn is torch.sum:
                dims, keep = _reduce_dims(node, args[0])
                out = ff.reduce_sum(args[0], dims, keepdims=keep)
            elif fn is torch.clamp:
                lo = node.kwargs.get(
                    "min", node.args[1] if len(node.args) > 1 else None)
                hi = node.kwargs.get(
                    "max", node.args[2] if len(node.args) > 2 else None)
                out = ff.clamp(args[0], lo, hi)
            elif fn is operator.neg or fn is torch.neg:
                out = ff.scalar_multiply(args[0], -1.0)
            elif fn is torch.chunk:
                n_chunks = node.args[1]
                dim = node.kwargs.get(
                    "dim", node.args[2] if len(node.args) > 2 else 0)
                total = args[0].shape[dim]
                base = -(-total // n_chunks)
                sizes = [base] * (total // base)
                if total % base:
                    sizes.append(total % base)
                out = tuple(ff.split(args[0], sizes, axis=dim))
            elif fn is torch.stack:
                dim = node.kwargs.get(
                    "dim", node.args[1] if len(node.args) > 1 else 0)
                parts = [t(a) for a in node.args[0]]
                dim = dim % (parts[0].ndim + 1)
                expanded = []
                for pt in parts:
                    shape = list(pt.shape)
                    shape.insert(dim, 1)
                    expanded.append(ff.reshape(pt, shape))
                out = ff.concat(expanded, axis=dim)
            elif fn is F.silu:
                out = ff.silu(args[0])
            elif fn is F.hardswish:
                out = ff.hardswish(args[0])
            elif fn is F.hardsigmoid:
                out = ff.hardsigmoid(args[0])
            elif fn is F.leaky_relu:
                slope = node.kwargs.get(
                    "negative_slope",
                    node.args[1] if len(node.args) > 1 else 0.01)
                out = ff.leaky_relu(args[0], slope)
            elif fn is F.relu6:
                out = ff.clamp(args[0], 0.0, 6.0)
            elif fn in (F.max_pool2d, F.avg_pool2d):
                kh, kw = _pair(node.kwargs.get(
                    "kernel_size",
                    node.args[1] if len(node.args) > 1 else 1))
                stride = node.kwargs.get(
                    "stride", node.args[2] if len(node.args) > 2 else None)
                sh, sw = _pair(stride) if stride else (kh, kw)
                ph, pw = _pair(node.kwargs.get(
                    "padding", node.args[3] if len(node.args) > 3 else 0))
                kind = "max" if fn is F.max_pool2d else "avg"
                out = ff.pool2d(args[0], kh, kw, sh, sw, ph, pw, kind)
            elif fn is F.adaptive_avg_pool2d:
                out = _adaptive_pool(
                    ff, args[0],
                    node.kwargs.get(
                        "output_size",
                        node.args[1] if len(node.args) > 1 else 1),
                    "avg")
            elif fn is F.linear:
                # weight arrives as a traced constant [O, I]
                w = args[1]
                y = ff.batch_matmul(args[0], ff.transpose(w, [1, 0]))
                b_arg = node.kwargs.get(
                    "bias", args[2] if len(args) > 2 else None)
                out = y if b_arg is None else ff.add(y, t(b_arg) if isinstance(
                    b_arg, torch.fx.Node) else b_arg)
            elif fn is F.layer_norm:
                eps = node.kwargs.get("eps", 1e-5)
                nd = len(node.args[1])  # normalized_shape
                dims = list(range(args[0].ndim - nd, args[0].ndim))
                mu = ff.mean(args[0], dims, keepdims=True)
                xc = ff.subtract(args[0], mu)
                var = ff.mean(ff.multiply(xc, xc), dims, keepdims=True)
                y = ff.multiply(xc, ff.rsqrt(ff.scalar_add(var, float(eps))))
                w_arg = node.kwargs.get(
                    "weight", args[2] if len(args) > 2 else None)
                b_arg = node.kwargs.get(
                    "bias", args[3] if len(args) > 3 else None)
                if w_arg is not None:
                    y = ff.multiply(y, t(w_arg) if isinstance(
                        w_arg, torch.fx.Node) else w_arg)
                if b_arg is not None:
                    y = ff.add(y, t(b_arg) if isinstance(
                        b_arg, torch.fx.Node) else b_arg)
                out = y
            elif fn is F.pad:
                spec_p = list(node.args[1])
                _support(node.kwargs.get("mode", "constant") == "constant",
                         "only constant-mode F.pad")
                val = float(node.kwargs.get("value") or 0.0)
                # torch pad spec runs minor-dim first in (lo, hi) pairs
                pw = [(0, 0)] * args[0].ndim
                for i in range(len(spec_p) // 2):
                    pw[args[0].ndim - 1 - i] = (spec_p[2 * i],
                                                spec_p[2 * i + 1])
                out = ff.pad(args[0], pw, val)
            elif fn is F.softplus:
                out = ff.softplus(args[0])
            elif fn is F.mish:
                out = ff.mish(args[0])
            elif fn is F.glu:
                dim = node.kwargs.get(
                    "dim", node.args[1] if len(node.args) > 1 else -1)
                dim = dim % args[0].ndim
                half = args[0].shape[dim] // 2
                a_t, b_t = ff.split(args[0], [half, half], axis=dim)
                out = ff.multiply(a_t, ff.sigmoid(b_t))
            elif fn is F.prelu:
                # per-channel weight [C] applies along dim 1 in torch; numpy
                # broadcasting would hit the trailing dim: reshape to
                # (C, 1, ..., 1) like the nn.PReLU module path
                x0, w = args[0], args[1]
                if w.ndim == 1 and w.shape[0] > 1 and x0.ndim > 2:
                    w = ff.reshape(
                        w, [w.shape[0]] + [1] * (x0.ndim - 2))
                neg = ff.min(x0, ff.constant(np.zeros((), np.float32)))
                out = ff.add(ff.relu(x0), ff.multiply(neg, w))
            elif fn in (torch.maximum, torch.minimum):
                out = (ff.max if fn is torch.maximum else ff.min)(
                    args[0], args[1])
            elif fn in (torch.amax, torch.amin):
                dims, keep = _reduce_dims(node, args[0])
                red = ff.reduce_max if fn is torch.amax else ff.reduce_min
                out = red(args[0], dims, keepdims=keep)
            elif fn in (torch.abs, operator.abs):
                out = ff.max(args[0], ff.scalar_multiply(args[0], -1.0))
            elif fn in (torch.max, torch.min) and (
                    len(node.args) > 1 or "dim" in node.kwargs):
                if len(node.args) > 1 and isinstance(args[1], Tensor):
                    out = (ff.max if fn is torch.max else ff.min)(
                        args[0], args[1])
                else:
                    dims, keep = _reduce_dims(node, args[0])
                    red = ff.reduce_max if fn is torch.max else ff.reduce_min
                    # torch.max(x, dim) returns (values, indices); indices
                    # resolve only for a trailing-dim argmax
                    vals = red(args[0], dims, keepdims=keep)
                    idx = (ff.argmax(args[0]) if fn is torch.max
                           and list(dims) == [args[0].ndim - 1] and not keep
                           else None)
                    out = (vals, idx)
            elif fn is F.interpolate:
                _support(node.kwargs.get("mode", "nearest") == "nearest",
                         "only nearest interpolate")
                size = node.kwargs.get(
                    "size", t(node.args[1]) if len(node.args) > 1 else None)
                out = _upsample_nearest(
                    ff, args[0], node.kwargs.get("scale_factor"), size=size)
            elif fn is F.embedding:
                out = ff.take(args[1], args[0], axis=0)  # w [V,D], ids [...]
            else:
                raise NotImplementedError(f"torch function {fn}")
            mark(node, out)
        elif node.op == "call_method":
            x = t(node.args[0])
            m = node.target
            if m == "view" or m == "reshape":
                # dims may be traced values (x.size(0) etc.) -> resolve
                shape = [t(a) for a in node.args[1:]]
                if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
                    shape = list(shape[0])
                concrete = list(shape)
                if -1 in concrete:
                    known = int(np.prod([s for s in concrete if s != -1]))
                    total = int(np.prod(x.shape))
                    concrete[concrete.index(-1)] = total // abs(known)
                out = ff.reshape(x, concrete)
            elif m == "flatten":
                sd = node.kwargs.get(
                    "start_dim", node.args[1] if len(node.args) > 1 else 0)
                ed = node.kwargs.get(
                    "end_dim", node.args[2] if len(node.args) > 2 else -1)
                sd, ed = sd % x.ndim, ed % x.ndim
                merged = int(np.prod(x.shape[sd:ed + 1]))
                out = ff.reshape(
                    x, list(x.shape[:sd]) + [merged] + list(x.shape[ed + 1:]))
            elif m in ("transpose",):
                d0, d1 = node.args[1], node.args[2]
                perm = list(range(x.ndim))
                perm[d0], perm[d1] = perm[d1], perm[d0]
                out = ff.transpose(x, perm)
            elif m == "permute":
                out = ff.transpose(x, list(node.args[1:]))
            elif m == "relu":
                out = ff.relu(x)
            elif m == "contiguous":
                out = ff.identity(x)
            elif m == "mean":
                dims = node.kwargs.get(
                    "dim", node.args[1] if len(node.args) > 1 else None)
                keep = bool(node.kwargs.get("keepdim", False))
                if dims is None:
                    dims = list(range(x.ndim))
                if isinstance(dims, int):
                    dims = [dims]
                out = ff.mean(x, dims, keepdims=keep)
            elif m == "pow":
                out = ff.pow(x, float(node.args[1]))
            elif m == "unsqueeze":
                d = node.args[1] % (x.ndim + 1)
                shape = list(x.shape)
                shape.insert(d, 1)
                out = ff.reshape(x, shape)
            elif m == "squeeze":
                if len(node.args) > 1:
                    d = node.args[1] % x.ndim
                    if x.shape[d] != 1:  # torch: no-op unless size 1
                        out = x
                    else:
                        out = ff.reshape(
                            x, [s for i, s in enumerate(x.shape) if i != d])
                else:
                    out = ff.reshape(x, [s for s in x.shape if s != 1])
            elif m in ("to", "float", "double", "half", "type_as"):
                dmap = {torch.float32: torch.float32,
                        torch.float64: torch.float32,
                        torch.float16: torch.bfloat16,
                        torch.bfloat16: torch.bfloat16,
                        torch.int32: torch.int32,
                        torch.int64: torch.int32}
                if m == "to":
                    # only a recognized torch dtype emits a cast; .to(device)
                    # / .to(memory_format=...) are dtype-preserving identity
                    # in torch and must not silently cast to float32
                    cand = [a for a in list(node.args[1:])
                            + list(node.kwargs.values())
                            if isinstance(a, torch.dtype)]
                    out = ff.cast(x, dmap[cand[0]]) if (
                        cand and cand[0] in dmap) else x
                elif m == "type_as":
                    out = ff.cast(x, t(node.args[1]).dtype)
                else:
                    out = ff.cast(
                        x, torch.bfloat16 if m == "half" else torch.float32)
            elif m == "split":
                size = node.args[1]
                dim = node.kwargs.get(
                    "dim", node.args[2] if len(node.args) > 2 else 0)
                total = x.shape[dim]
                if isinstance(size, int):
                    sizes = [size] * (total // size)
                    if total % size:
                        sizes.append(total % size)
                else:
                    sizes = list(size)
                out = tuple(ff.split(x, sizes, axis=dim))
            elif m == "matmul":
                out = ff.batch_matmul(x, t(node.args[1]))
            elif m == "softmax":
                dim = node.kwargs.get(
                    "dim", node.args[1] if len(node.args) > 1 else -1)
                out = ff.softmax(x, axis=dim)
            elif m == "sigmoid":
                out = ff.sigmoid(x)
            elif m == "tanh":
                out = ff.tanh(x)
            elif m == "exp":
                out = ff.exp(x)
            elif m == "size":
                shp = tuple(int(d) for d in x.shape)
                out = shp[node.args[1]] if len(node.args) > 1 else shp
            elif m in ("dim", "ndimension"):
                out = x.ndim
            elif m == "sum":
                dims, keep = _reduce_dims(node, x)
                out = ff.reduce_sum(x, dims, keepdims=keep)
            elif m == "chunk":
                n_chunks = node.args[1]
                dim = node.kwargs.get(
                    "dim", node.args[2] if len(node.args) > 2 else 0)
                total = x.shape[dim]
                base = -(-total // n_chunks)
                sizes = [base] * (total // base)
                if total % base:
                    sizes.append(total % base)
                out = tuple(ff.split(x, sizes, axis=dim))
            elif m in ("add", "sub", "mul", "div", "truediv"):
                other = t(node.args[1])
                if node.kwargs.get("rounding_mode") is not None:
                    raise NotImplementedError(
                        "div with rounding_mode is not supported")
                alpha = node.kwargs.get("alpha", 1)
                if alpha != 1:  # torch: x.add(y, alpha=a) == x + a*y
                    _support(m in ("add", "sub"), f"{m} with alpha")
                    other = (ff.scalar_multiply(other, float(alpha))
                             if isinstance(other, Tensor)
                             else float(other) * float(alpha))
                pair = {
                    "add": (ff.add, ff.scalar_add),
                    "sub": (ff.subtract, ff.scalar_sub),
                    "mul": (ff.multiply, ff.scalar_multiply),
                    "div": (ff.divide, ff.scalar_true_divide),
                    "truediv": (ff.divide, ff.scalar_true_divide),
                }[m]
                out = (pair[0](x, other) if isinstance(other, Tensor)
                       else pair[1](x, float(other)))
            elif m == "neg":
                out = ff.scalar_multiply(x, -1.0)
            elif m == "clamp":
                lo = node.kwargs.get(
                    "min", node.args[1] if len(node.args) > 1 else None)
                hi = node.kwargs.get(
                    "max", node.args[2] if len(node.args) > 2 else None)
                out = ff.clamp(x, lo, hi)
            elif m == "bmm":
                out = ff.batch_matmul(x, t(node.args[1]))
            elif m == "expand":
                sizes = [t(a) for a in node.args[1:]]
                if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
                    sizes = list(sizes[0])
                out = _expand_to(ff, x, sizes)
            elif m == "expand_as":
                out = _expand_to(ff, x, list(t(node.args[1]).shape))
            elif m == "repeat":
                reps = [t(a) for a in node.args[1:]]
                if len(reps) == 1 and isinstance(reps[0], (tuple, list)):
                    reps = list(reps[0])
                pad_nd = len(reps) - x.ndim
                if pad_nd:
                    x = ff.reshape(x, [1] * pad_nd + list(x.shape))
                out = x
                for d, r in enumerate(reps):
                    if r > 1:
                        out = ff.concat([out] * int(r), axis=d)
            elif m == "masked_fill":
                # select semantics: arithmetic blending (x*(1-m) + m*val)
                # turns val=-inf into 0*inf = NaN in the canonical attention
                # masking pattern
                mask, val = t(node.args[1]), float(t(node.args[2]))
                out = ff.where(mask,
                               ff.constant(np.full((), val, np.float32)), x)
            elif m in ("amax", "amin"):
                dims, keep = _reduce_dims(node, x)
                red = ff.reduce_max if m == "amax" else ff.reduce_min
                out = red(x, dims, keepdims=keep)
            elif m in ("max", "min") and (
                    len(node.args) > 1 or "dim" in node.kwargs):
                other = t(node.args[1]) if len(node.args) > 1 else None
                if isinstance(other, Tensor):
                    out = (ff.max if m == "max" else ff.min)(x, other)
                else:
                    dims, keep = _reduce_dims(node, x)
                    red = ff.reduce_max if m == "max" else ff.reduce_min
                    vals = red(x, dims, keepdims=keep)
                    idx = (ff.argmax(x) if m == "max"
                           and list(dims) == [x.ndim - 1] and not keep
                           else None)
                    out = (vals, idx)
            elif m == "argmax":
                dims, keep = _reduce_dims(node, x)
                _support(list(dims) == [x.ndim - 1],
                         "argmax supports the trailing dim only")
                out = ff.argmax(x)
                if keep:
                    out = ff.reshape(out, list(out.shape) + [1])
            elif m == "abs":
                out = ff.max(x, ff.scalar_multiply(x, -1.0))
            elif m == "rsqrt":
                out = ff.rsqrt(x)
            elif m == "sqrt":
                out = ff.sqrt(x)
            elif m == "log":
                out = ff.log(x)
            else:
                raise NotImplementedError(f"torch method {m}")
            mark(node, out)
        elif node.op == "get_attr":
            # constant attributes resolve from the traced module: scalars
            # flow into the scalar-op paths; larger tensors become frozen
            # constant ops (FlexFlow's ATTRIBUTE ops).
            obj = gm
            for part in node.target.split("."):
                obj = getattr(obj, part)
            val = _np(obj) if isinstance(obj, torch.Tensor) else obj
            if np.ndim(val) == 0 or np.size(val) == 1:
                mark(node, float(np.reshape(val, ())))
            else:
                # frozen tensor constant (buffers, F.linear weights, masks):
                # enters the graph as a constant op
                mark(node, ff.constant(np.asarray(val)))
        elif node.op == "output":
            pass

    ff._torch_weight_loads = weight_loads
    return ff


def apply_torch_weights(ff: FFModel) -> None:
    """After ff.compile(): overwrite initialized params with torch weights."""
    params, state = {}, {}
    for name, loader in getattr(ff, "_torch_weight_loads", []):
        out = loader()
        st = out.pop("__state__", None)
        params[name] = out
        if st:
            state[name] = st
    ff.load_numpy(params, state)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _linear_loader(sub):
    def load():
        p = {"w": _np(sub.weight).T}
        if sub.bias is not None:
            p["b"] = _np(sub.bias)
        return p
    return load


def _conv_loader(sub):
    def load():
        p = {"w": _np(sub.weight)}
        if sub.bias is not None:
            p["b"] = _np(sub.bias)
        return p
    return load


def _conv1d_loader(sub):
    def load():
        # torch Conv1d weight [O, I, K] -> height-1 conv2d kernel [O, I, 1, K]
        p = {"w": _np(sub.weight)[:, :, None, :]}
        if sub.bias is not None:
            p["b"] = _np(sub.bias)
        return p
    return load


def _bn_loader(sub):
    def load():
        return {
            "scale": _np(sub.weight),
            "bias": _np(sub.bias),
            "__state__": {
                "mean": _np(sub.running_mean),
                "var": _np(sub.running_var),
            },
        }
    return load


def _gn_loader(sub):
    def load():
        return {"scale": _np(sub.weight), "bias": _np(sub.bias)}
    return load


def _mha_loader(sub):
    """torch MultiheadAttention -> DSL mha params (bias-free projections)."""
    if sub.in_proj_bias is not None and sub.in_proj_bias.abs().any():
        raise NotImplementedError(
            "the DSL's mha is bias-free: construct MultiheadAttention(bias=False)")

    def load():
        e = sub.embed_dim
        if sub.in_proj_weight is not None:
            w = _np(sub.in_proj_weight)  # [3e, d]
            wq, wk, wv = w[:e], w[e:2 * e], w[2 * e:]
        else:
            wq = _np(sub.q_proj_weight)
            wk = _np(sub.k_proj_weight)
            wv = _np(sub.v_proj_weight)
        return {"wq": wq.T, "wk": wk.T, "wv": wv.T, "wo": _np(sub.out_proj.weight).T}
    return load


def _ln_loader(sub):
    def load():
        p = {"scale": _np(sub.weight)}
        if sub.bias is not None:
            p["bias"] = _np(sub.bias)
        return p
    return load
