"""The port's training examples (``flexflow_tpu_torch/examples``) on the CPU
at ``tests/test_examples.py``'s sizes: each of the 15 trains to a finite
loss. For the dropout-free builders (mnist_mlp, transformer, dlrm, moe,
bert_proxy small) the first training step's loss on the JAX model's
initial parameters equals JAX's within 1e-5 (relative)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples import bert_proxy as j_bert  # noqa: E402
from examples import dlrm as j_dlrm  # noqa: E402
from examples import moe as j_moe  # noqa: E402
from examples import transformer as j_transformer  # noqa: E402
import flexflow_tpu.keras as jkeras  # noqa: E402
from flexflow_tpu.ffmodel import AdamOptimizer as JAdam  # noqa: E402
from flexflow_tpu.ffmodel import FFModel as JFF  # noqa: E402
from flexflow_tpu.ffmodel import SGDOptimizer as JSGD  # noqa: E402
import flexflow_tpu_torch.keras as tkeras  # noqa: E402
from flexflow_tpu_torch.examples import (  # noqa: E402
    alexnet, bert_proxy, candle_uno, cifar10_cnn, dlrm, inception, mlp_unify, mnist_mlp, moe,
    multi_head_attention, resnet, resnext50, split_test, transformer, xdl)
from flexflow_tpu_torch.ffmodel import AdamOptimizer, FFModel, SGDOptimizer  # noqa: E402

torch.set_num_threads(2)

# each example's main at tests/test_examples.py's sizes (alexnet, which that
# file does not run, at 2 images of 224 x 224)
MAINS = {
    "alexnet": (alexnet.main, dict(batch_size=2, epochs=1, samples=4)),
    "bert_proxy": (bert_proxy.main, dict(argv=[])),
    "candle_uno": (candle_uno.main, dict(batch_size=8, epochs=1, samples=16)),
    "cifar10_cnn": (cifar10_cnn.main, dict(epochs=1, batch=4, samples=16)),
    "dlrm": (dlrm.main, dict(batch_size=16, epochs=2, samples=64)),
    "inception": (inception.main, dict(batch_size=4, epochs=1, samples=8)),
    "mlp_unify": (mlp_unify.main, dict(argv=[])),
    "mnist_mlp": (mnist_mlp.main, dict()),
    "moe": (moe.main, dict(batch_size=8, epochs=1, samples=32)),
    "multi_head_attention": (multi_head_attention.main, dict(epochs=2, batch=4, seq=8,
                                                              hidden=32)),
    "resnet": (resnet.main, dict(batch_size=8, epochs=1, samples=16)),
    "resnext50": (resnext50.main, dict(batch_size=4, epochs=1, samples=8)),
    "split_test": (split_test.main, dict(epochs=1, batch=4)),
    "transformer": (transformer.main, dict(batch_size=8, epochs=2, samples=32)),
    "xdl": (xdl.main, dict(batch_size=8, epochs=1, samples=16)),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_example_trains(name, capsys):
    fn, kw = MAINS[name]
    hist = fn(device="cpu", **kw)
    out = capsys.readouterr().out
    assert "final:" in out
    loss = float(out.split("final:")[1].split("'loss': ")[1].split(",")[0])
    assert np.isfinite(loss)
    if hist is not None:
        assert np.isfinite(hist[-1]["loss"])
    if name == "multi_head_attention":
        assert hist[-1]["loss"] <= hist[0]["loss"] + 1e-3


def _first_step(build, opts, xs, y, batch):
    """The first step's loss of the same builder in both packages, the port
    on the JAX model's initial parameters."""
    j, t = JFF(seed=0), FFModel(seed=0, device="cpu")
    build(j)
    build(t)
    j.compile(optimizer=opts[0])
    t.compile(optimizer=opts[1])
    t.load_numpy(jax.tree.map(np.asarray, j.params), jax.tree.map(np.asarray, j.state))
    sel = [a[:batch] for a in xs]
    hj = j.fit(sel, y[:batch], batch_size=batch, epochs=1, shuffle=False)
    ht = t.fit(sel, y[:batch], batch_size=batch, epochs=1, shuffle=False)
    return ht[0]["loss"], hj[0]["loss"]


def _transformer():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 128, size=(32, 16)).astype(np.int32)
    return ((lambda ff: (j_transformer if isinstance(ff, JFF) else transformer)
             .build_transformer(ff, 8)),
            (JAdam(lr=1e-3), AdamOptimizer(lr=1e-3)), [x], (x.sum(-1) % 2).astype(np.int32), 8)


def _dlrm():
    rng = np.random.RandomState(0)
    dense = rng.randn(64, 13).astype(np.float32)
    sparse = [rng.randint(0, 100, size=(64, 1)).astype(np.int32) for _ in range(4)]
    y = ((dense.sum(-1) + sum(s[:, 0] % 7 for s in sparse)) > 8).astype(np.int32)
    return ((lambda ff: (j_dlrm if isinstance(ff, JFF) else dlrm).build_dlrm(ff, 16)),
            (JAdam(lr=1e-2), AdamOptimizer(lr=1e-2)), [dense] + sparse, y, 16)


def _moe():
    from flexflow_tpu_torch.keras.datasets import mnist

    (x, y), _ = mnist.load_data(synthetic=True)
    x = (x[:32].reshape(32, -1) / 255.0).astype(np.float32)
    return ((lambda ff: (j_moe if isinstance(ff, JFF) else moe).build_moe(ff, 8)),
            (JAdam(lr=1e-3), AdamOptimizer(lr=1e-3)), [x], y[:32].astype(np.int32), 8)


def _bert():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 16, 64).astype(np.float32)
    y = rng.randint(0, 8, size=(16,)).astype(np.int32)
    return ((lambda ff: (j_bert if isinstance(ff, JFF) else bert_proxy).build(ff, 4, 16, 64, 4, 2)),
            (JSGD(lr=0.01), SGDOptimizer(lr=0.01)), [x], y, 4)


@pytest.mark.parametrize("case", [_transformer, _dlrm, _moe, _bert],
                         ids=["transformer", "dlrm", "moe", "bert_proxy"])
def test_first_step_loss_matches_jax(case):
    got, want = _first_step(*case())
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_mnist_mlp_first_step_loss_matches_jax():
    """The Keras Sequential of ``examples/mnist_mlp.py``."""
    rng = np.random.RandomState(0)
    x = rng.randn(512, 784).astype(np.float32)
    y = (x[:, :10].argmax(-1)).astype(np.int32)
    models = []
    for k, kw in ((jkeras, {}), (tkeras, {"device": "cpu"})):
        m = k.Sequential([k.Input(shape=(784,), batch_size=64), k.Dense(512, activation="relu"),
                          k.Dense(512, activation="relu"), k.Dense(10)], **kw)
        m.compile(optimizer=k.SGD(learning_rate=0.01, momentum=0.9),
                  loss="sparse_categorical_crossentropy")
        models.append(m)
    models[1].ffmodel.load_numpy(jax.tree.map(np.asarray, models[0].ffmodel.params))
    want, got = (m.fit(x[:64], y[:64], batch_size=64, epochs=1, shuffle=False)[0]["loss"]
                 for m in models)
    assert abs(got - want) <= 1e-5 * want, (got, want)


def test_moe_refuses_a_mesh():
    """Only a ``parallel.mesh.Mesh`` is taken; with one the example trains
    as without (JAX's FFModel keeps its mesh unread: nothing shards)."""
    from flexflow_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        moe.main(mesh=object(), device="cpu")
    kw = dict(batch_size=16, epochs=1, samples=32)
    assert moe.main(mesh=Mesh.fake(1, 2, 0), **kw) == moe.main(device="cpu", **kw)
