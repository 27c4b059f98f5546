"""Classic NN ops: conv2d, pool2d, batch norm, dropout, embedding, etc. (port
of ``flexflow_tpu/ops/nn.py``).

Plain PyTorch on tensors, laid out as the JAX functions lay them out: NCHW
activations and OIHW kernels (``conv2d_transpose`` takes torch's
``[I, O, KH, KW]``), so a JAX model's weights carry across unchanged. The
graph layer (``ffmodel/model.py``) computes every op with these and with
``torch`` calls; none of them has a kernel of the port's own.

Where PyTorch's library call differs from JAX's semantics the op is written
out: pools pad explicitly (``F.max_pool2d`` refuses padding above half the
kernel; JAX pads with -inf or 0 whatever the size, and its average counts
the padding), batch norm keeps JAX's momentum convention and the biased
batch variance, and index operands are widened to int64 (JAX's graphs carry
int32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# conv / pool (NCHW, weights OIHW)
# ---------------------------------------------------------------------------


def conv2d(
    x: torch.Tensor,  # [N, C, H, W]
    w: torch.Tensor,  # [O, I/groups, KH, KW]
    b: Optional[torch.Tensor],  # [O]
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    groups: int = 1,
) -> torch.Tensor:
    return F.conv2d(x, w, b, stride=tuple(stride), padding=tuple(padding), groups=groups)


def conv2d_transpose(
    x: torch.Tensor,  # [N, C, H, W]
    w: torch.Tensor,  # [I, O, KH, KW] (torch ConvTranspose2d layout)
    b: Optional[torch.Tensor],  # [O]
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    output_padding: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Transposed convolution: out = (in - 1) * stride - 2 * pad + kernel +
    output_pad (JAX builds it as a dilated conv over the flipped kernel)."""
    return F.conv_transpose2d(x, w, b, stride=tuple(stride), padding=tuple(padding),
                              output_padding=tuple(output_padding))


def group_norm(
    x: torch.Tensor,  # [N, C, *spatial]
    num_groups: int,
    scale: Optional[torch.Tensor],  # [C]
    bias: Optional[torch.Tensor],  # [C]
    eps: float = 1e-5,
) -> torch.Tensor:
    """Normalize over (C/G, *spatial) within each of G channel groups, in f32."""
    n, c = x.shape[0], x.shape[1]
    spatial = x.shape[2:]
    g = num_groups
    xg = x.reshape(n, g, c // g, *spatial).float()
    axes = tuple(range(2, xg.ndim))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xg - mean), dim=axes, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * len(spatial)
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y.to(x.dtype)


def pool2d(
    x: torch.Tensor,  # [N, C, H, W]
    kernel: Tuple[int, int],
    stride: Tuple[int, int],
    padding: Tuple[int, int],
    pool_type: str = "max",  # "max" | "avg"
) -> torch.Tensor:
    """Max pads with -inf, avg with 0 and divides by the whole window, the
    padding included (JAX's ``reduce_window``); any padding size."""
    ph, pw = padding
    if ph or pw:
        fill = float("-inf") if pool_type == "max" else 0.0
        x = F.pad(x, (pw, pw, ph, ph), value=fill)
    if pool_type == "max":
        return F.max_pool2d(x, tuple(kernel), tuple(stride))
    return F.avg_pool2d(x, tuple(kernel), tuple(stride))


def _bn_shape(x: torch.Tensor):
    return (1, -1) + (1,) * (x.ndim - 2)


def batch_norm_train(
    x: torch.Tensor,  # [N, C, H, W] or [N, C]
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    momentum: float = 0.9,
    eps: float = 1e-5,
):
    """Batch statistics; returns (y, new_mean, new_var) with JAX's running
    update ``momentum * running + (1 - momentum) * batch`` and the biased
    batch variance (the opposite of ``F.batch_norm``'s conventions). The new
    statistics carry no gradient."""
    axes = tuple(i for i in range(x.ndim) if i != 1)
    mean = torch.mean(x, dim=axes)
    var = torch.mean(torch.square(x - mean.reshape(_bn_shape(x))), dim=axes)
    shape = _bn_shape(x)
    y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + eps)
    y = y * scale.reshape(shape) + bias.reshape(shape)
    new_mean = momentum * running_mean + (1 - momentum) * mean.detach()
    new_var = momentum * running_var + (1 - momentum) * var.detach()
    return y, new_mean, new_var


def batch_norm_infer(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    shape = _bn_shape(x)
    y = (x - running_mean.reshape(shape)) * torch.rsqrt(running_var.reshape(shape) + eps)
    return y * scale.reshape(shape) + bias.reshape(shape)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Keep each element with probability 1 - rate, scaled by 1 / (1 - rate).
    The mask is drawn from ``generator`` (on ``x``'s device), not from a JAX
    key, so it matches JAX's in distribution only."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def flat(x: torch.Tensor) -> torch.Tensor:
    """[N, ...] -> [N, prod(...)]."""
    return x.reshape(x.shape[0], -1)


def embedding_lookup(
    ids: torch.Tensor,  # [N] or [N, T] int
    table: torch.Tensor,  # [V, D]
    aggr: str = "none",  # "none" | "sum" | "avg"
) -> torch.Tensor:
    out = table[ids.long()]
    if aggr == "sum":
        return torch.sum(out, dim=-2)
    if aggr == "avg":
        return torch.mean(out, dim=-2)
    return out


def batch_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def reverse(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.flip(x, dims=(axis,))


def wrap_index(index: torch.Tensor, size: int) -> torch.Tensor:
    """int64 indices into a dimension of ``size``, a negative one counted from
    the end as numpy does (JAX's ``take`` and ``take_along_axis`` too)."""
    index = index.long()
    return torch.where(index < 0, index + size, index)


def gather(x: torch.Tensor, index: torch.Tensor, axis: int) -> torch.Tensor:
    """``take_along_axis``: int32 indices are widened for ``torch.gather``, a
    negative index counts from the end."""
    return torch.gather(x, axis, wrap_index(index, x.shape[axis]))
