"""The port's Keras frontend (``flexflow_tpu_torch/keras``) against the JAX
package's on the CPU: mirrors of ``tests/test_keras.py``'s 7 tests. Each
model is built by the same layer calls in both packages, the port takes the
JAX model's initial parameters (``FFModel.load_numpy``), and then the
outputs before training agree within 1e-5 of their magnitude, and the
trained losses within 1e-4 (every epoch where the optimizer is SGD and
there is no dropout; the first epoch under Adam, whose first updates are
about lr * sign(g)); each test keeps its own gate on the port. The
preprocessing helpers and the synthetic datasets give JAX's exact values.
"""

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu.keras as jkeras
import flexflow_tpu_torch.keras as tkeras
from flexflow_tpu.keras.models import InputTensor as JInput
from flexflow_tpu.keras.models import Model as JModel
from flexflow_tpu_torch.keras.models import InputTensor as TInput
from flexflow_tpu_torch.keras.models import Model as TModel

torch.set_num_threads(2)


def _toy(n=256, d=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(d, classes)
    x = rng.randn(n, d).astype(np.float32)
    y = (x @ w).argmax(-1).astype(np.int32)
    return x, y


def _carry(jm, tm):
    """The JAX model's parameters and state into the port's (by node name)."""
    assert [n.name for n in tm.ffmodel._nodes] == [n.name for n in jm.ffmodel._nodes]
    tm.ffmodel.load_numpy(jax.tree.map(np.asarray, jm.ffmodel.params),
                          jax.tree.map(np.asarray, jm.ffmodel.state))


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _losses_close(ht, hj, epochs=None):
    for a, b in list(zip(ht, hj))[:epochs]:
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]), (ht, hj)


def _sequential(keras, device_kw, layers):
    return keras.Sequential(layers, **device_kw)


def test_sequential_mlp():
    x, y = _toy()

    def make(k, kw):
        m = k.Sequential([k.Input(shape=(16,), batch_size=32), k.Dense(64, activation="relu"),
                          k.Dropout(0.1), k.Dense(4)], **kw)
        m.compile(optimizer=k.Adam(learning_rate=1e-2), loss="sparse_categorical_crossentropy")
        return m

    jm, tm = make(jkeras, {}), make(tkeras, {"device": "cpu"})
    _carry(jm, tm)
    _close(tm.predict(x[:32]), jm.predict(x[:32]))  # dropout is off in predict
    hist = tm.fit(x, y, batch_size=32, epochs=12)
    assert hist[-1]["accuracy"] > 0.85
    out = tm.predict(x[:32])
    assert out.shape == (32, 4)
    assert "dense" in tm.summary()
    assert tm.summary().splitlines()[1:] == jm.summary().splitlines()[1:]


def test_sequential_cnn():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 1, 8, 8).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int32)

    def make(k, kw):
        m = k.Sequential(**kw)
        m.add(k.Input(shape=(1, 8, 8), batch_size=16))
        m.add(k.Conv2D(8, 3, padding="same", activation="relu"))
        m.add(k.MaxPooling2D(2))
        m.add(k.BatchNormalization(relu=True))
        m.add(k.Flatten())
        m.add(k.Dense(2))
        m.compile(optimizer=k.SGD(learning_rate=1e-2, momentum=0.9))
        return m

    jm, tm = make(jkeras, {}), make(tkeras, {"device": "cpu"})
    _carry(jm, tm)
    _close(tm.predict(x[:16]), jm.predict(x[:16]))
    hj = jm.fit(x, y, batch_size=16, epochs=10)
    ht = tm.fit(x, y, batch_size=16, epochs=10)
    _losses_close(ht, hj)
    assert ht[-1]["accuracy"] > 0.75


def test_functional_two_branch():
    x, y = _toy(d=8, classes=2)

    def make(k, inp_fn, model_cls, kw):
        inp = inp_fn(shape=(8,), batch_size=32, **kw)
        b1 = k.Dense(16, activation="relu")(inp)
        b2 = k.Dense(16, activation="tanh")(inp)
        merged = k.Concatenate(axis=1)([b1, b2])
        summed = k.Add()([k.Dense(8)(merged), k.Dense(8)(merged)])
        out = k.Dense(2)(k.Activation("relu")(summed))
        m = model_cls(inputs=inp, outputs=out)
        m.compile(optimizer=k.Adam(learning_rate=1e-2))
        return m

    jm = make(jkeras, JInput, JModel, {})
    tm = make(tkeras, TInput, TModel, {"device": "cpu"})
    _carry(jm, tm)
    _close(tm.predict(x[:32]), jm.predict(x[:32]))
    hj = jm.fit(x, y, batch_size=32, epochs=10)
    ht = tm.fit(x, y, batch_size=32, epochs=10)
    _losses_close(ht, hj, epochs=1)
    assert ht[-1]["accuracy"] > 0.8


def test_callbacks_lr_schedule_and_history():
    rng = np.random.RandomState(0)
    x = rng.rand(64, 8).astype("float32")
    y = (x.sum(-1) > 4.0).astype("int64")

    def run(k, kw):
        m = k.Sequential([k.Input(shape=(8,), batch_size=16), k.Dense(16, activation="relu"),
                          k.Dense(2)], **kw)
        m.compile(optimizer=k.SGD(learning_rate=0.5), loss="sparse_categorical_crossentropy")
        return m

    jm, tm = run(jkeras, {}), run(tkeras, {"device": "cpu"})
    _carry(jm, tm)
    hists = []
    for k, m in ((jkeras, jm), (tkeras, tm)):
        sched = k.callbacks.LearningRateScheduler(lambda e: 0.5 * (0.5 ** e))
        hist_cb = k.callbacks.History()
        m.fit(x, y, batch_size=16, epochs=3,
              callbacks=[sched, hist_cb, k.callbacks.VerifyMetrics(0.5)])
        assert len(hist_cb.history["loss"]) == 3
        assert abs(m.optimizer.lr - 0.5 * 0.25) < 1e-9
        hists.append(hist_cb.history["loss"])
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-4)
    with pytest.raises(AssertionError, match="gate"):
        tm.fit(x, y, batch_size=16, epochs=1, callbacks=[tkeras.callbacks.VerifyMetrics(1.01)])


def test_regularizer_and_initializer():
    rng = np.random.RandomState(0)
    x = rng.rand(32, 4).astype("float32")
    y = rng.randint(0, 2, 32).astype("int64")

    def build(k, reg, kw):
        m = k.Sequential([
            k.Input(shape=(4,), batch_size=16),
            k.Dense(8, activation="relu", kernel_regularizer=reg,
                    kernel_initializer=k.initializers.RandomNormal(stddev=0.1, seed=3)),
            k.Dense(2),
        ], **kw)
        m.compile(optimizer=k.SGD(learning_rate=0.1), loss="sparse_categorical_crossentropy")
        return m

    m_reg = build(tkeras, tkeras.regularizers.L2(1.0), {"device": "cpu"})
    m_base = build(tkeras, None, {"device": "cpu"})
    name = m_reg.ff._nodes[1].name
    w0 = m_reg.ff.params[name]["w"].detach().clone()
    assert torch.equal(w0, m_base.ff.params[name]["w"])  # the seeded initializer
    assert abs(w0.std().item() - 0.1) < 0.05
    m_reg.fit(x, y, batch_size=16, epochs=3, shuffle=False)
    m_base.fit(x, y, batch_size=16, epochs=3, shuffle=False)
    w_reg = m_reg.ff.params[name]["w"].detach().numpy()
    w_base = m_base.ff.params[name]["w"].detach().numpy()
    assert np.linalg.norm(w_reg) < np.linalg.norm(w_base)
    # the penalty against JAX's, on JAX's initial weights
    jm, tm = (build(jkeras, jkeras.regularizers.L1L2(0.05, 1.0), {}),
              build(tkeras, tkeras.regularizers.L1L2(0.05, 1.0), {"device": "cpu"}))
    _carry(jm, tm)
    _losses_close(tm.fit(x, y, batch_size=16, epochs=3, shuffle=False),
                  jm.fit(x, y, batch_size=16, epochs=3, shuffle=False))


def test_preprocessing_and_synthetic_datasets():
    from flexflow_tpu.keras.datasets import cifar10 as jc
    from flexflow_tpu.keras.datasets import mnist as jmn
    from flexflow_tpu.keras.preprocessing.sequence import pad_sequences as jpad
    from flexflow_tpu.keras.preprocessing.text import Tokenizer as JTok
    from flexflow_tpu_torch.keras.datasets import cifar10, mnist
    from flexflow_tpu_torch.keras.preprocessing.sequence import pad_sequences
    from flexflow_tpu_torch.keras.preprocessing.text import Tokenizer

    texts = ["the cat sat", "the dog sat down", "A cat, a DOG!"]
    tok, jtok = Tokenizer(oov_token="<oov>"), JTok(oov_token="<oov>")
    tok.fit_on_texts(texts)
    jtok.fit_on_texts(texts)
    seqs = tok.texts_to_sequences(["the cat ran", "down down dog"])
    assert seqs == jtok.texts_to_sequences(["the cat ran", "down down dog"])
    assert len(seqs[0]) == 3  # 'ran' -> oov id
    for kw in ({"maxlen": 5}, {"maxlen": 2, "truncating": "post", "padding": "post"}, {}):
        np.testing.assert_array_equal(pad_sequences(seqs, **kw), jpad(seqs, **kw))
    padded = pad_sequences(seqs, maxlen=5)
    assert padded.shape == (2, 5) and padded[0, 0] == 0
    (xtr, ytr), (xte, yte) = mnist.load_data(synthetic=True)
    assert xtr.shape == (512, 28, 28) and ytr.shape == (512,)
    for got, want in zip(jax.tree.leaves((mnist.load_data(synthetic=True),
                                          cifar10.load_data(synthetic=True))),
                         jax.tree.leaves((jmn.load_data(synthetic=True),
                                          jc.load_data(synthetic=True)))):
        np.testing.assert_array_equal(got, want)


def test_merge_and_shape_layers():
    """Subtract/Multiply/Maximum/Minimum + Reshape/Permute against numpy and JAX."""
    rng = np.random.RandomState(0)
    xa = rng.randn(8, 4, 6).astype(np.float32)
    xb = rng.randn(8, 4, 6).astype(np.float32)

    def make(k, inp_fn, model_cls, kw):
        a = inp_fn(shape=(4, 6), batch_size=8, **kw)
        b = inp_fn(shape=(4, 6), batch_size=8, builder=a.builder)
        s = k.Subtract()([a, b])
        m = k.Multiply()([a, b])
        hi = k.Maximum()([s, m])
        lo = k.Minimum()([s, m])
        r = k.Reshape((6, 4))(hi)
        p = k.Permute((2, 1))(r)
        out = k.Multiply()([p, lo])
        model = model_cls(inputs=[a, b], outputs=out)
        model.compile(optimizer=None, loss="mean_squared_error")
        return model

    jm = make(jkeras, JInput, JModel, {})
    tm = make(tkeras, TInput, TModel, {"device": "cpu"})
    got = tm.ffmodel.forward([xa, xb])
    sub, mul = xa - xb, xa * xb
    want = (np.maximum(sub, mul).reshape(8, 6, 4).transpose(0, 2, 1) * np.minimum(sub, mul))
    np.testing.assert_allclose(got, want, atol=1e-5)
    _close(got, jm.ffmodel.forward([xa, xb]))


def test_conv_transpose_group_norm_layer_norm_build():
    """The Keras Conv2DTranspose / GroupNormalization / LayerNormalization
    stack of ``tests/test_frontend_widening.py``: outputs on JAX's weights
    equal JAX's, and one epoch's loss too (SGD)."""
    x = np.random.RandomState(0).randn(8, 3, 8, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 10, size=(8,)).astype(np.int32)

    def make(k, kw):
        m = k.Sequential([
            k.Input(shape=(3, 8, 8), batch_size=4),
            k.Conv2D(8, 3, activation="relu"),
            k.GroupNormalization(groups=2),
            k.Conv2DTranspose(4, 3, strides=2),
            k.LayerNormalization(),
            k.Flatten(),
            k.Dense(10),
        ], **kw)
        m.compile(optimizer=k.SGD(0.01), loss="sparse_categorical_crossentropy")
        return m

    jm, tm = make(jkeras, {}), make(tkeras, {"device": "cpu"})
    _carry(jm, tm)
    out = tm.predict(x[:4])
    assert out.shape == (4, 10) and np.isfinite(out).all()
    _close(out, jm.predict(x[:4]))
    _losses_close(tm.fit(x, y, batch_size=4, epochs=1), jm.fit(x, y, batch_size=4, epochs=1))
