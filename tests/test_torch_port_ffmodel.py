"""The port's FFModel (``flexflow_tpu_torch/ffmodel/model.py``) against the
JAX package's on the CPU (f32). Both packages build each graph from the same
calls; the port takes the JAX model's parameters through ``load_numpy``.

- Every op of ``_apply_node``, one small graph each: the node list (ops,
  names, attrs, shapes, dtypes) equal, the forward and the gradients of a
  seeded cotangent to every parameter and float input (training mode)
  within 1e-5 of their magnitude.
- Mirrors of ``tests/test_ffmodel.py``'s 8 tests on the port, each also
  holding the port's first epoch (or output) to JAX's.
- ``fit`` for 2 epochs on a dropout-free model (batch norm, SGD with
  momentum and Adam): per-epoch losses within 1e-4 of JAX's, the same
  shuffle; a regularizer and ``set_learning_rate`` likewise (SGD).
- ``export_dot`` string-equal; the A8 / A11c refusals.
- Negative ``take`` / ``gather`` indices wrap as JAX's (C4), at int32 and
  int64; tied ``top_k`` / ``arg_top_k`` inputs and a tied MoE gate pick
  JAX's indices, the lower index first (C5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ffmodel import AdamOptimizer as JAdam
from flexflow_tpu.ffmodel import FFModel as JFF
from flexflow_tpu.ffmodel import SGDOptimizer as JSGD
from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel, SGDOptimizer

torch.set_num_threads(2)
TOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _dtype_name(d):
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) else np.dtype(d).name


def _norm_attr(v):
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.name, v.shape, v.tolist())
    if isinstance(v, torch.dtype) or (isinstance(v, type) and issubclass(v, np.generic)) or (
            hasattr(v, "dtype") and not isinstance(v, np.ndarray) and not np.isscalar(v)):
        return ("dtype", _dtype_name(v))
    if isinstance(v, (tuple, list)):
        return tuple(_norm_attr(x) for x in v)
    return v


def graph_signature(nodes):
    """A package-neutral view of a node list: op, name, inputs, attrs, output
    shapes and dtypes."""
    return [(n.op, n.name, [(t.node, t.index, tuple(t.shape)) for t in n.inputs],
             {k: _norm_attr(v) for k, v in sorted(n.attrs.items())},
             [tuple(s) for s in n.out_shapes], [_dtype_name(d) for d in n.out_dtypes])
            for n in nodes]


def pair(build, seed=0, optimizer=None, loss_type="sparse_categorical_crossentropy"):
    """The JAX model and the port's (on the CPU, the JAX parameters carried
    in), each built by ``build(ff)`` and compiled."""
    j, t = JFF(seed=seed), FFModel(seed=seed, device="cpu")
    build(j)
    build(t)
    j.compile(optimizer=optimizer[0] if optimizer else None, loss_type=loss_type)
    t.compile(optimizer=optimizer[1] if optimizer else None, loss_type=loss_type)
    assert graph_signature(t._nodes) == graph_signature(j._nodes)
    assert t.substitution_report == j.substitution_report
    t.load_numpy(_np_tree(j.params), _np_tree(j.state))
    return j, t


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _r(seed, *shape, lo=None):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


def _ints(seed, hi, *shape):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int32)


# --- one graph per op: (build(ff), inputs) ----------------------------------

def _unary(op, lo=None, shape=(3, 4, 5)):
    return (lambda ff: getattr(ff, op)(ff.create_tensor(shape)), lambda: [_r(0, *shape, lo=lo)])


def _one(fn, shapes, ints=()):
    """``fn(ff, *tensors)`` over float inputs of ``shapes`` (int32 where the
    shape is in ``ints`` as (shape, high))."""
    def build(ff):
        ts = [ff.create_tensor(s) for s in shapes]
        ts += [ff.create_tensor(s, np.int32) for s, _ in ints]
        fn(ff, *ts)

    def inputs():
        return ([_r(i, *s) for i, s in enumerate(shapes)]
                + [_ints(10 + i, hi, *s) for i, (s, hi) in enumerate(ints)])
    return build, inputs


def _fixed_ints(fn, shapes, ints):
    """``fn(ff, *tensors)`` over float inputs of ``shapes`` and the given
    int32 index arrays ``ints``."""
    def build(ff):
        ts = [ff.create_tensor(s) for s in shapes]
        ts += [ff.create_tensor(a.shape, np.int32) for a in ints]
        fn(ff, *ts)
    return build, lambda: [_r(i, *s) for i, s in enumerate(shapes)] + list(ints)


# C4: indices in [-6, 6) into an axis of 6, with -1 (take) and -6 (gather)
TAKE_NEG = np.array([[0, -1, 5, -6, 2], [3, -2, 1, 4, -1]], np.int32)
GATHER_NEG = np.random.RandomState(12).randint(-6, 6, (3, 2, 4)).astype(np.int32)
GATHER_NEG[0, 0, 0] = -6


def _tied(ff, x):
    """relu(x - 1) of a normal draw (C5): most entries tie at 0."""
    return ff.relu(ff.scalar_sub(x, 1.0))


def _top_k_ties(ff, x):
    """The values and the indices (as floats) of a tied top-16."""
    vals, idx = ff.top_k(_tied(ff, x), 16)
    return ff.concat([vals, ff.cast(idx, np.float32)], -1)


OPS = {f"unary-{op}": _unary(op) for op in (
    "exp", "sin", "cos", "relu", "sigmoid", "tanh", "elu", "gelu", "identity", "silu",
    "hardswish", "hardsigmoid", "softplus", "mish")}
OPS.update({f"unary-{op}": _unary(op, lo=0.5) for op in ("log", "sqrt", "rsqrt")})
OPS.update({
    "constant": _one(lambda ff, x: ff.add(x, ff.constant(_r(7, 4, 5))), [(3, 4, 5)]),
    "pad": _one(lambda ff, x: ff.pad(x, [(0, 0), (1, 2), (2, 0)], 0.5), [(2, 3, 4)]),
    "reduce_max": _one(lambda ff, x: ff.reduce_max(x, [1, -1], keepdims=True), [(2, 3, 4)]),
    "reduce_min": _one(lambda ff, x: ff.reduce_min(x, [0]), [(2, 3, 4)]),
    "leaky_relu": _one(lambda ff, x: ff.leaky_relu(x, 0.2), [(3, 5)]),
    "clamp": _one(lambda ff, x: ff.clamp(x, -0.5, 0.7), [(3, 5)]),
    "clamp-lo": _one(lambda ff, x: ff.clamp(x, min_val=0.1), [(3, 5)]),
    "slice": _one(lambda ff, x: ff.slice_tensor(x, [(None, None, None), 1, (1, None, 2)]),
                  [(2, 3, 6, 2)]),
    "slice-negative-step": _one(lambda ff, x: ff.slice_tensor(x, [(None, None, -1), (4, 0, -2)]),
                                [(3, 6)]),
    "pow": _one(lambda ff, x: ff.pow(ff.scalar_add(ff.relu(x), 0.5), 1.7), [(3, 5)]),
    "scalar_add": _one(lambda ff, x: ff.scalar_add(x, 1.5), [(3, 5)]),
    "scalar_sub": _one(lambda ff, x: ff.scalar_sub(x, 1.5), [(3, 5)]),
    "scalar_mul": _one(lambda ff, x: ff.scalar_multiply(x, -2.5), [(3, 5)]),
    "scalar_div": _one(lambda ff, x: ff.scalar_true_divide(x, 3.0), [(3, 5)]),
    "softmax": _one(lambda ff, x: ff.softmax(x, axis=1), [(2, 5, 3)]),
    **{f"binary-{op}": _one(lambda ff, a, b, op=op: getattr(ff, op)(a, b), [(3, 1, 5), (4, 5)])
       for op in ("add", "subtract", "multiply", "max", "min")},
    "binary-divide": _one(lambda ff, a, b: ff.divide(a, ff.scalar_add(ff.relu(b), 1.0)),
                          [(3, 1, 5), (4, 5)]),
    "where": _one(lambda ff, c, a, b: ff.where(ff.relu(c), a, b), [(3, 4), (3, 4), (1, 4)]),
    **{f"dense-{act}": _one(lambda ff, x, act=act: ff.dense(x, 6, activation=act), [(2, 3, 8)])
       for act in (None, "relu", "sigmoid", "tanh", "gelu", "elu", "silu")},
    "dense-nobias": _one(lambda ff, x: ff.dense(x, 6, use_bias=False), [(4, 8)]),
    "conv2d": _one(lambda ff, x: ff.conv2d(x, 6, 3, 3, 2, 1, 1, 1, activation="relu"),
                   [(2, 4, 7, 6)]),
    "conv2d-grouped": _one(lambda ff, x: ff.conv2d(x, 6, 3, 2, 1, 1, 1, 0, groups=2,
                                                   use_bias=False), [(2, 4, 7, 6)]),
    "conv2d_transpose": _one(lambda ff, x: ff.conv2d_transpose(x, 5, 3, 3, 2, 2, 1, 1, 1, 1,
                                                               activation="tanh"),
                             [(2, 3, 4, 5)]),
    "group_norm": _one(lambda ff, x: ff.group_norm(x, 2), [(2, 6, 3, 4)]),
    "group_norm-noaffine": _one(lambda ff, x: ff.group_norm(x, 3, affine=False, eps=1e-3),
                                [(2, 6, 3, 4)]),
    "pool2d-max": _one(lambda ff, x: ff.pool2d(x, 3, 3, 2, 2, 1, 1), [(2, 3, 7, 8)]),
    "pool2d-avg-wide-pad": _one(lambda ff, x: ff.pool2d(x, 2, 2, 1, 1, 2, 2, "avg"),
                                [(2, 3, 5, 6)]),
    "batch_norm": _one(lambda ff, x: ff.batch_norm(x, relu=False, momentum=0.8), [(8, 3, 4, 4)]),
    "batch_norm-relu": _one(lambda ff, x: ff.batch_norm(x), [(16, 5)]),
    "layer_norm": _one(lambda ff, x: ff.layer_norm(x), [(3, 4, 8)]),
    "layer_norm-nobias": _one(lambda ff, x: ff.layer_norm(x, use_bias=False, eps=1e-3),
                              [(3, 8)]),
    "layer_norm-noaffine": _one(lambda ff, x: ff.layer_norm(x, elementwise_affine=False),
                                [(3, 8)]),
    "rms_norm": _one(lambda ff, x: ff.rms_norm(x), [(3, 4, 8)]),
    "residual_layer_norm": _one(lambda ff, x, r: ff.concat(list(ff.residual_layer_norm(x, r)),
                                                           -1), [(3, 8), (3, 8)]),
    "residual_rms_norm": _one(lambda ff, x, r: ff.concat(list(ff.residual_rms_norm(x, r)), -1),
                              [(3, 8), (3, 8)]),
    "sigmoid_silu_multi": _one(lambda ff, g, u: ff.sigmoid_silu_multi(g, u), [(3, 8), (3, 8)]),
    **{f"embedding-{aggr}": _one(lambda ff, ids, aggr=aggr: ff.embedding(ids, 20, 6, aggr=aggr),
                                 [], ints=[((4, 3), 20)]) for aggr in ("none", "sum", "avg")},
    "dropout": _one(lambda ff, x: ff.dropout(x, 0.3), [(4, 6)]),
    "flat": _one(lambda ff, x: ff.flat(x), [(2, 3, 4)]),
    "reshape": _one(lambda ff, x: ff.reshape(x, (2, 12)), [(2, 3, 4)]),
    "transpose": _one(lambda ff, x: ff.transpose(x, (2, 0, 1)), [(2, 3, 4)]),
    "concat": _one(lambda ff, a, b: ff.concat([a, b, a], axis=-1), [(2, 3), (2, 5)]),
    "split": _one(lambda ff, x: ff.concat(list(reversed(ff.split(x, [1, 3, 2], axis=1))), 1),
                  [(2, 6, 3)]),
    "cast": _one(lambda ff, x: ff.cast(ff.cast(x, np.int32), np.float32), [(3, 4)]),
    "reverse": _one(lambda ff, x: ff.reverse(x, 1), [(2, 5, 3)]),
    "gather": _one(lambda ff, x, i: ff.gather(x, i, 1), [(3, 6, 4)], ints=[((3, 2, 4), 6)]),
    "take": _one(lambda ff, x, i: ff.take(x, i, 1), [(3, 6, 4)], ints=[((2, 5), 6)]),
    "gather-negative": _fixed_ints(lambda ff, x, i: ff.gather(x, i, 1), [(3, 6, 4)],
                                   [GATHER_NEG]),
    "take-negative": _fixed_ints(lambda ff, x, i: ff.take(x, i, 1), [(3, 6, 4)], [TAKE_NEG]),
    "mean": _one(lambda ff, x: ff.mean(x, (1, 2)), [(2, 3, 4)]),
    "mean-keepdims": _one(lambda ff, x: ff.mean(x, (1,), keepdims=True), [(2, 3, 4)]),
    "reduce_sum": _one(lambda ff, x: ff.reduce_sum(x, (0, 2)), [(2, 3, 4)]),
    "batch_matmul": _one(lambda ff, a, b: ff.batch_matmul(a, b), [(2, 3, 4, 5), (2, 3, 5, 2)]),
    "mha": _one(lambda ff, q: ff.multihead_attention(q, q, q, 16, 4), [(2, 5, 16)]),
    "mha-causal-cross": _one(lambda ff, q, kv: ff.multihead_attention(q, kv, kv, 8, 2,
                                                                      causal=True),
                             [(2, 5, 12), (2, 5, 6)]),
    "top_k": _one(lambda ff, x: ff.top_k(x, 3), [(4, 9)]),
    "arg_top_k": _one(lambda ff, x: ff.arg_top_k(x, 3), [(4, 9)]),
    "top_k-ties": _one(_top_k_ties, [(4, 64)]),
    "arg_top_k-ties": _one(lambda ff, x: ff.arg_top_k(_tied(ff, x), 16), [(4, 64)]),
    "argmax": _one(lambda ff, x: ff.argmax(x), [(4, 3, 9)]),
    "moe": _one(lambda ff, x: ff.moe(x, num_experts=4, top_k=2, expert_hidden=8, out_dim=5),
                [(6, 10)]),
})


def _jax_grads(j, xs, ct):
    apply = j._build_apply()
    fidx = [i for i, a in enumerate(xs) if a.dtype.kind == "f"]

    def loss(params, fins):
        full = [jnp.asarray(a) for a in xs]
        for k, i in enumerate(fidx):
            full[i] = fins[k]
        out, _ = apply(params, j.state, full, True, None)
        return jnp.sum(out * ct), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        j.params, [jnp.asarray(xs[i]) for i in fidx])
    return out, gp, dict(zip(fidx, gx))


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    build, inputs = OPS[name]
    j, t = pair(build)
    xs = inputs()
    want = j.forward(xs)
    got = t.forward(xs)
    assert got.dtype == np.asarray(want).dtype, (got.dtype, np.asarray(want).dtype)
    _close(got, want, "forward")
    if got.dtype.kind != "f":
        return
    ct = np.random.RandomState(99).randn(*got.shape).astype(np.float32)
    jout, jgp, jgx = _jax_grads(j, xs, ct)
    tin = t._to_inputs(xs)
    for i, x in enumerate(tin):
        if x.is_floating_point():
            x.requires_grad_()
    out = t._run(tin, True, None)
    _close(out.detach().numpy(), jout, "training-mode forward")
    leaves = [(k, leaf, p) for k, d in t.params.items() for leaf, p in d.items()]
    fins = [(i, x) for i, x in enumerate(tin) if x.requires_grad]
    wrt = [p for *_, p in leaves] + [x for _, x in fins]
    grads = (torch.autograd.grad((out * torch.tensor(ct)).sum(), wrt, allow_unused=True)
             if out.requires_grad else [None] * len(wrt))  # (through an int cast: none)
    for (k, leaf, p), g in zip(leaves, grads):
        _close(np.zeros(p.shape) if g is None else g.numpy(), jgp[k][leaf], f"d {k}/{leaf}")
    for (i, _), g in zip(fins, grads[len(leaves):]):
        _close(np.zeros(xs[i].shape) if g is None else g.numpy(), jgx[i], f"d input {i}")


def test_moe_tied_gate_routes_as_jax():
    """C5: a zero gate ties every expert; JAX's top-k takes experts 0 and 1."""
    def build(ff):
        ff.moe(ff.create_tensor((6, 10)), num_experts=8, top_k=2, expert_hidden=8, out_dim=5)

    j, t = pair(build)
    name = j._nodes[-1].name
    j.params = {**j.params, name: {**j.params[name],
                                   "gate": jnp.zeros_like(j.params[name]["gate"])}}
    t.load_numpy(_np_tree(j.params))
    x = _r(0, 6, 10)
    _close(t.forward([x]), j.forward([x]), "forward")


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_negative_indices_wrap_as_jax(dtype):
    """C4 at both index widths; an index below -size still raises."""
    from flexflow_tpu_torch.ffmodel.model import _take
    from flexflow_tpu_torch.ops import nn as t_nn

    x = _r(3, 3, 6, 4)
    np.testing.assert_array_equal(
        _take(torch.tensor(x), torch.tensor(TAKE_NEG, dtype=dtype), 1).numpy(),
        np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(TAKE_NEG), axis=1)))
    np.testing.assert_array_equal(
        t_nn.gather(torch.tensor(x), torch.tensor(GATHER_NEG, dtype=dtype), 1).numpy(),
        np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(GATHER_NEG), axis=1)))
    with pytest.raises((IndexError, RuntimeError)):
        _take(torch.tensor(x), torch.tensor([-7], dtype=dtype), 1)
    with pytest.raises((IndexError, RuntimeError)):
        t_nn.gather(torch.tensor(x), torch.full((3, 1, 4), 6, dtype=dtype), 1)


# --- mirrors of tests/test_ffmodel.py ----------------------------------------

def _toy_classification(n=256, d=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w + 0.1 * rng.randn(n, classes)).argmax(-1).astype(np.int32)
    return x, y


def _first_epoch_equal(j, t, x, y, batch_size, epochs):
    """Train both for ``epochs``; the first epoch's loss within 1e-4 (Adam's
    first updates are about lr * sign(g), so later epochs drift apart by
    gradients near 0); returns the port's history."""
    hj = j.fit(x, y, batch_size=batch_size, epochs=epochs)
    ht = t.fit(x, y, batch_size=batch_size, epochs=epochs)
    assert abs(ht[0]["loss"] - hj[0]["loss"]) <= 1e-4 * abs(hj[0]["loss"]), (ht[0], hj[0])
    return ht


def test_mlp_learns():
    x, y = _toy_classification()

    def build(ff):
        t = ff.create_tensor((32, 16))
        t = ff.dense(t, 64, activation="relu")
        ff.dense(t, 4)

    j, t = pair(build, optimizer=(JAdam(lr=1e-2), AdamOptimizer(lr=1e-2)))
    hist = _first_epoch_equal(j, t, x, y, 32, 12)
    assert hist[-1]["accuracy"] > 0.9, hist[-1]


def test_cnn_mnist_like():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 1, 8, 8).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int32)

    def build(ff):
        t = ff.create_tensor((16, 1, 8, 8))
        t = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1, activation="relu")
        t = ff.pool2d(t, 2, 2, 2, 2)
        t = ff.conv2d(t, 16, 3, 3, 1, 1, 1, 1, activation="relu")
        t = ff.flat(t)
        t = ff.dense(t, 32, activation="relu")
        ff.dense(t, 2)

    j, t = pair(build, optimizer=(JAdam(lr=5e-3), AdamOptimizer(lr=5e-3)))
    hist = _first_epoch_equal(j, t, x, y, 16, 15)
    assert hist[-1]["accuracy"] > 0.8, hist[-1]


def test_batch_norm_state_updates():
    rng = np.random.RandomState(0)
    x = (rng.randn(64, 4, 4, 4) * 3 + 1).astype(np.float32)
    y = rng.randint(0, 2, 64).astype(np.int32)

    def build(ff):
        t = ff.create_tensor((16, 4, 4, 4))
        t = ff.batch_norm(t, relu=True)
        t = ff.flat(t)
        ff.dense(t, 2)

    j, t = pair(build, optimizer=(JSGD(lr=1e-2), SGDOptimizer(lr=1e-2)))
    bn_name = t._nodes[1].name
    before = t.state[bn_name]["mean"].clone()
    j.fit(x, y, batch_size=16, epochs=1)
    t.fit(x, y, batch_size=16, epochs=1)
    after = t.state[bn_name]["mean"]
    assert not torch.allclose(before, after)
    for k in ("mean", "var"):
        _close(t.state[bn_name][k].numpy(), j.state[bn_name][k], f"running {k}")
    r1 = t.evaluate(x, y, batch_size=16)
    r2 = t.evaluate(x, y, batch_size=16)
    assert r1 == r2
    rj = j.evaluate(x, y, batch_size=16)
    assert abs(r1["loss"] - rj["loss"]) <= 1e-4 * rj["loss"] and r1["accuracy"] == rj["accuracy"]


def test_elementwise_and_movement_ops():
    def build(ff):
        a = ff.create_tensor((4, 6))
        b = ff.create_tensor((4, 6))
        t = ff.add(ff.exp(a), ff.scalar_multiply(b, 2.0))
        t = ff.relu(ff.subtract(t, ff.sigmoid(b)))
        parts = ff.split(t, [2, 4], axis=1)
        t = ff.concat([parts[1], parts[0]], axis=1)
        t = ff.reshape(t, (4, 3, 2))
        t = ff.transpose(t, (0, 2, 1))
        t = ff.flat(t)
        ff.softmax(t)

    j, t = pair(build)
    xa = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    xb = np.random.RandomState(1).randn(4, 6).astype(np.float32)
    out = t.forward([xa, xb])
    assert out.shape == (4, 6)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    _close(out, j.forward([xa, xb]), "forward")


def test_mha_causal():
    def build(ff):
        q = ff.create_tensor((2, 5, 16))
        ff.multihead_attention(q, q, q, embed_dim=16, num_heads=4, causal=True)

    j, t = pair(build)
    x = np.random.RandomState(0).randn(2, 5, 16).astype(np.float32)
    out = t.forward([x])
    assert out.shape == (2, 5, 16)
    x2 = x.copy()
    x2[:, 1:] += 1.0
    np.testing.assert_allclose(out[:, 0], t.forward([x2])[:, 0], atol=1e-5)
    _close(out, j.forward([x]), "forward")


def test_moe_composite_learns():
    x, y = _toy_classification(n=256, d=16, classes=4, seed=1)

    def build(ff):
        t = ff.create_tensor((32, 16))
        t = ff.moe(t, num_experts=4, top_k=2, expert_hidden=32, out_dim=16)
        ff.dense(t, 4)

    j, t = pair(build, optimizer=(JAdam(lr=1e-2), AdamOptimizer(lr=1e-2)))
    hist = _first_epoch_equal(j, t, x, y, 32, 12)
    assert hist[-1]["accuracy"] > 0.8, hist[-1]


def test_embedding_and_reduce():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 50, size=(64, 5)).astype(np.int32)
    y = (ids.sum(-1) % 2).astype(np.int32)

    def build(ff):
        t = ff.create_tensor((16, 5), dtype=np.int32)
        t = ff.embedding(t, num_entries=50, out_dim=8, aggr="sum")
        ff.dense(t, 2)

    j, t = pair(build, optimizer=(JAdam(lr=1e-2), AdamOptimizer(lr=1e-2)))
    hist = _first_epoch_equal(j, t, ids, y, 16, 10)
    assert hist[-1]["loss"] < 0.7


def test_export_dot(tmp_path):
    def build(ff):
        t = ff.create_tensor((4, 8))
        t = ff.dense(t, 16, activation="relu", name="fc1")
        ff.dense(t, 2, name="fc2")

    j, t = JFF(), FFModel(device="cpu")
    build(j)
    build(t)
    p = str(tmp_path / "graph.dot")
    dot = t.export_dot(p)
    assert "digraph" in dot and "fc1" in dot and "fc2" in dot and "->" in dot
    assert open(p).read() == dot
    assert dot == j.export_dot()
    j.compile()
    t.compile()
    assert t.export_dot() == j.export_dot()


# --- training against JAX ----------------------------------------------------

def _bn_mlp(ff):
    t = ff.create_tensor((16, 3, 6, 6))
    t = ff.conv2d(t, 4, 3, 3, 1, 1, 1, 1, use_bias=False)  # a bias before BN has no gradient
    t = ff.batch_norm(t, relu=True)
    t = ff.pool2d(t, 2, 2, 2, 2)
    t = ff.flat(t)
    t = ff.dense(t, 16, activation="gelu")
    ff.dense(t, 3)


@pytest.mark.parametrize("opt", ["sgd-momentum", "adam"])
def test_fit_two_epochs_matches_jax(opt):
    """A dropout-free CNN with batch norm: per-epoch losses and accuracies of
    2 shuffled epochs within 1e-4 of JAX's, then evaluate."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 3, 6, 6).astype(np.float32)
    y = rng.randint(0, 3, 64).astype(np.int32)
    opts = ((JSGD(lr=0.05, momentum=0.9), SGDOptimizer(lr=0.05, momentum=0.9))
            if opt == "sgd-momentum" else (JAdam(lr=1e-2), AdamOptimizer(lr=1e-2)))
    j, t = pair(_bn_mlp, optimizer=opts)
    hj = j.fit(x, y, batch_size=16, epochs=2)
    ht = t.fit(x, y, batch_size=16, epochs=2)
    for a, b in zip(ht, hj):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]), (ht, hj)
        assert a["accuracy"] == b["accuracy"]
    ej, et = j.evaluate(x, y, batch_size=16), t.evaluate(x, y, batch_size=16)
    assert abs(et["loss"] - ej["loss"]) <= 1e-4 * abs(ej["loss"])


def test_regularizer_and_set_learning_rate_match_jax():
    """An L1 + L2 penalty on one dense layer, then the learning rate lowered
    between fits: the losses within 1e-4 of JAX's; the optimizer's state
    carries over (SGD momentum), nothing is rebuilt."""
    rng = np.random.RandomState(1)
    x = rng.randn(64, 8).astype(np.float32)
    y = rng.randint(0, 3, 64).astype(np.int32)

    def build(ff):
        t = ff.create_tensor((16, 8))
        t = ff.dense(t, 12, activation="tanh", name="hidden")
        ff.dense(t, 3)

    def make(ff_cls, opt):
        ff = ff_cls(seed=3) if ff_cls is JFF else ff_cls(seed=3, device="cpu")
        build(ff)
        ff.set_regularizer("hidden", l1=0.01, l2=0.05)
        ff.compile(opt)
        return ff

    j = make(JFF, JSGD(lr=0.1, momentum=0.5))
    t = make(FFModel, SGDOptimizer(lr=0.1, momentum=0.5))
    t.load_numpy(_np_tree(j.params))
    velocity = t.opt_state.velocity["hidden"]["w"]
    out = []
    for lr in (None, 0.02):
        if lr is not None:
            j.set_learning_rate(lr)
            t.set_learning_rate(lr)
        out.append((j.fit(x, y, batch_size=16, epochs=2), t.fit(x, y, batch_size=16, epochs=2)))
    assert t.optimizer.lr == 0.02 and t.opt_state.velocity["hidden"]["w"] is velocity
    for hj, ht in out:
        for a, b in zip(ht, hj):
            assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]), (ht, hj)
    _close(t.params["hidden"]["w"].detach().numpy(), j.params["hidden"]["w"], "w", 1e-4)


def test_refusals(monkeypatch):
    """A mesh that is not a ``parallel.mesh.Mesh`` is a TypeError; a Mesh is
    kept unread, as JAX keeps its own, and names the device: the search
    counts the world's ranks, not the mesh's axes (one in this process);
    over more than one device without a process group the pending search
    (JAX's, at the first ``fit`` batch) finds no candidate that builds and
    raises ``make_mesh``'s "run under torchrun" (over a world of ranks:
    ``test_torch_port_search_mesh``)."""
    from flexflow_tpu_torch.parallel import auto as auto_lib
    from flexflow_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        FFModel(mesh=object(), device="cpu")
    mesh = Mesh.fake(1, 2, 0)
    meshed = FFModel(mesh=mesh)
    assert meshed._mesh is mesh and meshed.device == torch.device("cpu")
    meshed.dense(meshed.create_tensor((2, 4)), 3)
    meshed.compile(auto_parallel=True)
    assert not meshed._pending_auto and meshed.joint_plan is not None
    ff = FFModel(device="cpu")
    ff.dense(ff.create_tensor((2, 4)), 3)
    with pytest.raises(RuntimeError, match="compile"):
        ff.forward(np.zeros((2, 4), np.float32))
    monkeypatch.setattr(auto_lib, "device_count", lambda device=None: 2)
    ff.compile(SGDOptimizer(lr=0.1), auto_parallel=True)
    assert ff._pending_auto
    x, y = np.zeros((2, 4), np.float32), np.zeros(2, np.int32)
    with pytest.raises(RuntimeError, match="no auto-parallel candidate ran.*process group"):
        ff.fit(x, y, batch_size=2, epochs=1)
    ff.compile()
    with pytest.raises(KeyError):
        ff.load_numpy({"no_such_node": {"w": np.zeros((4, 3), np.float32)}})


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FFModel()
