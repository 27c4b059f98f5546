"""The port's ``ops/nn.py`` against the JAX package's ``ops/nn.py`` on the CPU
(f32): each function's output and its gradients (a seeded cotangent pulled
back to every float operand) within 1e-5 of the magnitude, on the same numpy
inputs. The cases that differ from PyTorch's library calls are here: a pool
whose padding exceeds half its kernel, an average pool that counts the
padding, a grouped conv, a transposed conv with output padding, batch-norm
running statistics after 3 steps, int32 gather indices. Dropout draws its
own masks, so it is held by distribution: the kept share within 4 sigma of
the binomial, the kept values scaled by 1 / (1 - rate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops import nn as jnn
from flexflow_tpu_torch.ops import nn as tnn
from flexflow_tpu_torch.ops import norms as tnorms
from flexflow_tpu.ops import norms as jnorms

torch.set_num_threads(2)
TOL = 1e-5  # of the magnitude, f32


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= TOL * scale, (what, np.abs(got - want).max(), scale)


def _check(jfn, tfn, arrays, grad_args=None, seed=0):
    """``jfn(*jax arrays)`` against ``tfn(*torch tensors)``: the output and
    the pull-back of one seeded cotangent to each float array (or to the
    positions in ``grad_args``)."""
    if grad_args is None:
        grad_args = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]
    jin = [jnp.asarray(a) for a in arrays]
    jout, vjp = jax.vjp(lambda *f: jfn(*[f[grad_args.index(i)] if i in grad_args else jin[i]
                                         for i in range(len(jin))]),
                        *[jin[i] for i in grad_args])
    ct = np.random.RandomState(seed + 100).randn(*jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(ct))
    tin = [torch.tensor(a, requires_grad=i in grad_args) for i, a in enumerate(arrays)]
    tout = tfn(*tin)
    _close(tout.detach().numpy(), jout, "output")
    tgrads = torch.autograd.grad(tout, [tin[i] for i in grad_args], torch.tensor(ct))
    for i, jg, tg in zip(grad_args, jgrads, tgrads):
        _close(tg.numpy(), jg, f"gradient of operand {i}")


def _r(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("stride,padding,groups", [
    ((1, 1), (0, 0), 1), ((2, 1), (1, 2), 1), ((1, 1), (1, 1), 2), ((2, 2), (1, 1), 4)])
def test_conv2d(stride, padding, groups):
    x, w, b = _r(0, 2, 4, 9, 8), _r(1, 8, 4 // groups, 3, 3), _r(2, 8)
    _check(lambda x, w, b: jnn.conv2d(x, w, b, stride, padding, groups),
           lambda x, w, b: tnn.conv2d(x, w, b, stride, padding, groups), [x, w, b])


@pytest.mark.parametrize("stride,padding,opad", [((1, 1), (0, 0), (0, 0)),
                                                 ((2, 2), (1, 1), (1, 1)),
                                                 ((3, 2), (2, 1), (2, 1))])
def test_conv2d_transpose(stride, padding, opad):
    x, w, b = _r(0, 2, 3, 5, 6), _r(1, 3, 4, 4, 3), _r(2, 4)
    _check(lambda x, w, b: jnn.conv2d_transpose(x, w, b, stride, padding, opad),
           lambda x, w, b: tnn.conv2d_transpose(x, w, b, stride, padding, opad), [x, w, b])


@pytest.mark.parametrize("affine", [True, False])
def test_group_norm(affine):
    x = _r(0, 3, 12, 5, 4) * 2 + 1
    s, b = _r(1, 12), _r(2, 12)
    if affine:
        _check(lambda x, s, b: jnn.group_norm(x, 4, s, b, 1e-5),
               lambda x, s, b: tnn.group_norm(x, 4, s, b, 1e-5), [x, s, b])
    else:
        _check(lambda x: jnn.group_norm(x, 3, None, None, 1e-3),
               lambda x: tnn.group_norm(x, 3, None, None, 1e-3), [x])


@pytest.mark.parametrize("pool_type,kernel,stride,padding", [
    ("max", (2, 2), (2, 2), (0, 0)),
    ("max", (3, 3), (1, 2), (2, 2)),  # padding above half the kernel: -inf fill
    ("avg", (3, 3), (2, 2), (1, 1)),  # the average counts the padding
    ("avg", (2, 3), (1, 1), (2, 2)),  # both
])
def test_pool2d(pool_type, kernel, stride, padding):
    x = _r(0, 2, 3, 7, 8)
    _check(lambda x: jnn.pool2d(x, kernel, stride, padding, pool_type),
           lambda x: tnn.pool2d(x, kernel, stride, padding, pool_type), [x])


def test_avg_pool_divides_by_the_whole_window():
    """A corner window of a 3x3 pool padded by 1 sees 4 ones: 4/9, not 1."""
    out = tnn.pool2d(torch.ones(1, 1, 4, 4), (3, 3), (1, 1), (1, 1), "avg")
    assert out[0, 0, 0, 0].item() == pytest.approx(4 / 9)


@pytest.mark.parametrize("shape", [(8, 4, 3, 3), (16, 6)])
def test_batch_norm_train_and_running_stats(shape):
    """Output and gradients of a training step, and the running mean and
    (biased) variance after 3 steps with momentum 0.8."""
    c = shape[1]
    s, b = _r(1, c), _r(2, c)
    x = _r(0, *shape) * 3 + 1
    _check(lambda x, s, b: jnn.batch_norm_train(x, s, b, jnp.zeros(c), jnp.ones(c), 0.8, 1e-5)[0],
           lambda x, s, b: tnn.batch_norm_train(x, s, b, torch.zeros(c), torch.ones(c), 0.8,
                                                1e-5)[0], [x, s, b])
    jm, jv = jnp.zeros(c), jnp.ones(c)
    tm, tv = torch.zeros(c), torch.ones(c)
    for step in range(3):
        xs = _r(10 + step, *shape) * (step + 1) - step
        _, jm, jv = jnn.batch_norm_train(jnp.asarray(xs), jnp.asarray(s), jnp.asarray(b), jm, jv,
                                         0.8, 1e-5)
        _, tm, tv = tnn.batch_norm_train(torch.tensor(xs), torch.tensor(s), torch.tensor(b), tm,
                                         tv, 0.8, 1e-5)
    _close(tm.numpy(), jm, "running mean")
    _close(tv.numpy(), jv, "running var")
    _check(lambda x, s, b: jnn.batch_norm_infer(x, s, b, jm, jv, 1e-5),
           lambda x, s, b: tnn.batch_norm_infer(x, s, b, tm, tv, 1e-5), [x, s, b])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_distribution(rate):
    x = torch.tensor(_r(0, 64, 512)) + 5.0
    gen = torch.Generator().manual_seed(0)
    y = tnn.dropout(x, rate, gen)
    kept = y != 0
    n, p = x.numel(), 1.0 - rate
    sigma = np.sqrt(n * p * (1 - p))
    assert abs(kept.sum().item() - n * p) <= 4 * sigma
    torch.testing.assert_close(y[kept], x[kept] / (1.0 - rate), rtol=1e-6, atol=0)
    assert tnn.dropout(x, 0.0, gen) is x
    # a second draw from the generator is another mask
    assert not torch.equal(tnn.dropout(x, rate, gen) != 0, kept)


def test_flat_batch_matmul_reverse():
    _check(jnn.flat, tnn.flat, [_r(0, 3, 4, 5)])
    _check(jnn.batch_matmul, tnn.batch_matmul, [_r(0, 2, 3, 4, 5), _r(1, 2, 3, 5, 6)])
    for axis in (0, 2, -1):
        _check(lambda x: jnn.reverse(x, axis), lambda x: tnn.reverse(x, axis), [_r(0, 3, 4, 5)])


@pytest.mark.parametrize("aggr", ["none", "sum", "avg"])
def test_embedding_lookup_int32_ids(aggr):
    ids = np.random.RandomState(0).randint(0, 20, (4, 6)).astype(np.int32)
    table = _r(1, 20, 8)
    _check(lambda i, t: jnn.embedding_lookup(i, t, aggr),
           lambda i, t: tnn.embedding_lookup(i, t, aggr), [ids, table], grad_args=[1])


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gather_int32_indices(axis):
    x = _r(0, 4, 5, 6)
    shape = list(x.shape)
    shape[axis] = 3
    idx = np.random.RandomState(1).randint(0, x.shape[axis], shape).astype(np.int32)
    _check(lambda x, i: jnn.gather(x, i, axis), lambda x, i: tnn.gather(x, i, axis), [x, idx],
           grad_args=[0])


@pytest.mark.parametrize("kind", ["rms", "layer", "layer_nobias"])
def test_residual_norms(kind):
    """The norms' residual forms (``ops/norms.py``): both outputs and gradients."""
    x, r, s, b = _r(0, 3, 5, 16), _r(1, 3, 5, 16), _r(2, 16), _r(3, 16)
    if kind == "rms":
        jf = lambda x, r, s: jnp.concatenate(jnorms.residual_rms_norm(x, r, s, 1e-6), -1)  # noqa: E731
        tf = lambda x, r, s: torch.cat(tnorms.residual_rms_norm(x, r, s, 1e-6), -1)  # noqa: E731
        _check(jf, tf, [x, r, s])
    elif kind == "layer":
        jf = lambda x, r, s, b: jnp.concatenate(  # noqa: E731
            jnorms.residual_layer_norm(x, r, s, b, 1e-5), -1)
        tf = lambda x, r, s, b: torch.cat(tnorms.residual_layer_norm(x, r, s, b, 1e-5), -1)  # noqa: E731
        _check(jf, tf, [x, r, s, b])
    else:
        jf = lambda x, r, s: jnp.concatenate(  # noqa: E731
            jnorms.residual_layer_norm(x, r, s, None, 1e-5), -1)
        tf = lambda x, r, s: torch.cat(tnorms.residual_layer_norm(x, r, s, None, 1e-5), -1)  # noqa: E731
        _check(jf, tf, [x, r, s])
