"""The port's training core against the JAX package on the CPU (f32): losses
and metrics (1e-6), the SGD and Adam update formulas on identical numpy
gradients (1e-6), Trainer trajectories on a tiny LLaMA and on a spec with
biases, learned positions and tied embeddings (SGD: losses and parameters
within 1e-5; Adam: losses within rtol 1e-4, since Adam's first update is
about lr * sign(g) and a gradient near 0 may take either sign in the two
frameworks' sums), fit / evaluate, the data loader's batches, and the
refusals. ``tests/test_training.py``'s recipes; its sharded cases become
the refusal test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.training import AdamOptimizer as JAdam
from flexflow_tpu.training import SGDOptimizer as JSGD
from flexflow_tpu.training import Trainer as JTrainer
from flexflow_tpu.training import losses as jlosses
from flexflow_tpu.training import metrics as jmetrics
from flexflow_tpu.training.dataloader import SingleDataLoader as JLoader
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.training import AdamOptimizer, SGDOptimizer, Trainer
from flexflow_tpu_torch.training import losses as tlosses
from flexflow_tpu_torch.training import metrics as tmetrics
from flexflow_tpu_torch.training.dataloader import SingleDataLoader

torch.set_num_threads(2)

TINY = dict(arch="LlamaForCausalLM", vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            num_kv_heads=2, head_dim=16, intermediate_size=64, max_position_embeddings=64,
            norm_eps=1e-6)
# layer norms with biases, q/k/v/o and MLP biases, learned positions, tied embeddings
BIASED = dict(TINY, arch="OPTForCausalLM", norm="layernorm", norm_bias=True, pos="learned",
              learned_pos_offset=2, act="relu", qkv_bias=True, attn_out_bias=True,
              mlp_bias=True, tie_word_embeddings=True)
SPECS = {"llama": TINY, "biased_tied": BIASED}


def _data(batch=8, seqlen=16, n=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, TINY["vocab_size"], size=(batch, seqlen)).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -100
        out.append((toks, labels))
    return out


def _models(kw, seed=0):
    js, ts = jspecs.ModelSpec(**kw), tspecs.ModelSpec(**kw)
    jparams = jp.init_params(js, jax.random.PRNGKey(seed), jnp.float32)
    return js, jparams, ts, jax.tree.map(np.asarray, jparams)


def _leaf_pairs(jtree, ttree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        t = ttree
        for p in path:
            t = t[p.key if hasattr(p, "key") else p.idx]
        yield "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path), \
            np.asarray(leaf), t.detach().cpu().numpy()


@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_losses_match_jax(name):
    r = np.random.default_rng(0)
    logits = r.standard_normal((2, 5, 7)).astype(np.float32)
    if name == "sparse_categorical_crossentropy":
        labels = r.integers(0, 7, (2, 5)).astype(np.int32)
        labels[0, 1] = labels[1, 4] = tlosses.IGNORE_INDEX
        args = (logits, labels)
    elif name == "categorical_crossentropy":
        t = r.random((2, 5, 7)).astype(np.float32)
        args = (logits, t / t.sum(-1, keepdims=True))
    elif name == "mean_squared_error":
        args = (logits, r.standard_normal((2, 5, 7)).astype(np.float32))
    else:
        args = (logits,)
    want = float(jlosses.LOSSES[name](*(jnp.asarray(a) for a in args)))
    got = float(tlosses.LOSSES[name](*(torch.from_numpy(a) for a in args)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sparse_cce_ignores_every_label():
    """All labels ignored: 0 (the denominator clamps at 1), as in JAX."""
    logits = torch.zeros((2, 3, 4))
    labels = torch.full((2, 3), tlosses.IGNORE_INDEX)
    assert float(tlosses.sparse_categorical_crossentropy(logits, labels)) == 0.0
    np.testing.assert_allclose(float(tlosses.sparse_categorical_crossentropy(
        logits, torch.tensor([[0, 1, -100], [2, -100, -100]]))), np.log(4.0), rtol=1e-6)


def test_metrics_match_jax():
    r = np.random.default_rng(1)
    logits = r.standard_normal((3, 6, 9)).astype(np.float32)
    labels = r.integers(0, 9, (3, 6)).astype(np.int32)
    labels[:, -1] = -100
    labels[0, :3] = logits[0, :3].argmax(-1)  # some correct
    jm = jmetrics.classification_metrics(jnp.asarray(logits), jnp.asarray(labels))
    tm = tmetrics.classification_metrics(torch.from_numpy(logits), torch.from_numpy(labels))
    assert {k: int(v) for k, v in tm.items()} == {k: int(v) for k, v in jm.items()}
    pred, tgt = logits[..., 0], r.standard_normal((3, 6)).astype(np.float32)
    jr = jmetrics.regression_metrics(jnp.asarray(pred), jnp.asarray(tgt))
    tr = tmetrics.regression_metrics(torch.from_numpy(pred), torch.from_numpy(tgt))
    for k in jr:
        np.testing.assert_allclose(float(tr[k]), float(jr[k]), rtol=1e-6)
    jp_, tp_ = jmetrics.PerfMetrics(), tmetrics.PerfMetrics()
    for upd in ({k: int(v) for k, v in jm.items()}, {"count": 5, "correct": 2, "mse_loss": 0.5}):
        jp_.update(upd)
        tp_.update(upd)
    assert tp_ == tmetrics.PerfMetrics(**vars(jp_)) and tp_.accuracy == jp_.accuracy


_SGD_CASES = {"plain": {}, "momentum": dict(momentum=0.9),
              "nesterov_decay": dict(momentum=0.9, nesterov=True, weight_decay=0.01)}


@pytest.mark.parametrize("case", sorted(_SGD_CASES))
def test_sgd_math_matches_jax(case):
    """Three updates on identical gradients: the same parameters and velocity."""
    kw = dict(lr=0.1, **_SGD_CASES[case])
    r = np.random.default_rng(2)
    p0 = {"w": r.standard_normal((3, 4)).astype(np.float32), "b": {"x": np.ones(2, np.float32)}}
    grads = [jax.tree.map(lambda a: r.standard_normal(a.shape).astype(np.float32), p0)
             for _ in range(3)]
    jo, to = JSGD(**kw), SGDOptimizer(**kw)
    jparams, tparams = jax.tree.map(jnp.asarray, p0), jax.tree.map(torch.from_numpy, p0)
    js_, ts_ = jo.init(jparams), to.init(tparams)
    for g in grads:
        jparams, js_ = jo.update(jax.tree.map(jnp.asarray, g), js_, jparams)
        tparams, ts_ = to.update(jax.tree.map(torch.from_numpy, g), ts_, tparams)
        for _, a, b in _leaf_pairs(jparams, tparams):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    if kw.get("momentum"):
        for _, a, b in _leaf_pairs(js_.velocity, ts_.velocity):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    # the JAX test's hand-computed case
    opt = SGDOptimizer(lr=0.1, momentum=0.9)
    p = {"w": torch.ones(2)}
    st = opt.init(p)
    p, st = opt.update({"w": torch.full((2,), 2.0)}, st, p)
    np.testing.assert_allclose(p["w"].numpy(), 1.0 - 0.1 * 2.0)
    p, st = opt.update({"w": torch.full((2,), 2.0)}, st, p)
    np.testing.assert_allclose(p["w"].numpy(), 0.8 - 0.1 * 3.8, rtol=1e-6)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["adam", "adam_decay"])
def test_adam_math_matches_jax(weight_decay):
    """Three updates on identical gradients: the same parameters, m, v and step."""
    r = np.random.default_rng(3)
    p0 = {"w": r.standard_normal((3, 4)).astype(np.float32), "v": r.random(5).astype(np.float32)}
    grads = [jax.tree.map(lambda a: r.standard_normal(a.shape).astype(np.float32), p0)
             for _ in range(3)]
    jo, to = JAdam(lr=0.1, weight_decay=weight_decay), AdamOptimizer(lr=0.1,
                                                                      weight_decay=weight_decay)
    jparams, tparams = jax.tree.map(jnp.asarray, p0), jax.tree.map(torch.from_numpy, p0)
    js_, ts_ = jo.init(jparams), to.init(tparams)
    for g in grads:
        jparams, js_ = jo.update(jax.tree.map(jnp.asarray, g), js_, jparams)
        tparams, ts_ = to.update(jax.tree.map(torch.from_numpy, g), ts_, tparams)
        for tree_j, tree_t in ((jparams, tparams), (js_.m, ts_.m), (js_.v, ts_.v)):
            for _, a, b in _leaf_pairs(tree_j, tree_t):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    assert int(ts_.step) == int(js_.step) == 3 and ts_.step.dtype == torch.int32
    p1, _ = AdamOptimizer(lr=0.1).update({"w": torch.full((1,), 3.0)},
                                         AdamOptimizer().init({"w": torch.zeros(1)}),
                                         {"w": torch.zeros(1)})
    np.testing.assert_allclose(p1["w"].numpy(), -0.1, rtol=1e-5)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_sgd_trajectory_matches_jax(spec):
    """Four SGD steps (momentum 0.9): every loss and every parameter within 1e-5."""
    js, jparams, ts, npp = _models(SPECS[spec])
    jt = JTrainer(js, jparams, JSGD(lr=0.05, momentum=0.9))
    tt = Trainer(ts, tp.params_from_numpy(npp), SGDOptimizer(lr=0.05, momentum=0.9),
                 device="cpu")
    for toks, labels in _data():
        np.testing.assert_allclose(tt.train_step(toks, labels), jt.train_step(toks, labels),
                                   rtol=1e-5, atol=1e-5)
    for name, a, b in _leaf_pairs(jt.params, tt.params):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=name)
    assert tt.metrics.train_all == jt.metrics.train_all
    assert tt.metrics.train_correct == jt.metrics.train_correct


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_adam_trajectory_losses_match_jax(spec):
    js, jparams, ts, npp = _models(SPECS[spec], seed=1)
    jt = JTrainer(js, jparams, JAdam(lr=1e-2))
    tt = Trainer(ts, tp.params_from_numpy(npp), AdamOptimizer(lr=1e-2), device="cpu")
    losses = [(tt.train_step(x, y), jt.train_step(x, y)) for x, y in _data(n=3)]
    np.testing.assert_allclose(*zip(*losses), rtol=1e-4)
    assert int(tt.opt_state.step) == 3


def test_loss_decreases_and_caller_params_stay():
    """JAX's ``test_loss_decreases``; the Trainer trains copies of the
    caller's tensors, which keep their values (JAX's trees are immutable)."""
    _, _, ts, npp = _models(TINY)
    params = tp.params_from_numpy(npp)
    before = params["layers"]["wq"].clone()
    tr = Trainer(ts, params, AdamOptimizer(lr=1e-2), device="cpu")
    toks, labels = _data(n=1)[0]
    first = tr.train_step(toks, labels)
    for _ in range(10):
        last = tr.train_step(toks, labels)
    assert last < first
    assert torch.equal(params["layers"]["wq"], before) and not params["layers"]["wq"].requires_grad
    assert tr.params["layers"]["wq"].requires_grad and tr.params["layers"]["wq"].grad is None


def test_fit_and_evaluate_match_jax():
    js, jparams, ts, npp = _models(TINY)
    jt = JTrainer(js, jparams, JSGD(lr=0.05))
    tt = Trainer(ts, tp.params_from_numpy(npp), SGDOptimizer(lr=0.05), device="cpu")
    jh, th = jt.fit(_data(n=3), epochs=2), tt.fit(_data(n=3), epochs=2)
    assert [h["epoch"] for h in th] == [0, 1]
    np.testing.assert_allclose([h["loss"] for h in th], [h["loss"] for h in jh], rtol=1e-5)
    assert [h["accuracy"] for h in th] == [h["accuracy"] for h in jh]
    je, te = jt.evaluate(_data(n=2, seed=1)), tt.evaluate(_data(n=2, seed=1))
    np.testing.assert_allclose(te["loss"], je["loss"], rtol=1e-5)
    assert te["accuracy"] == je["accuracy"] and 0.0 <= te["accuracy"] <= 1.0
    logs = []
    tt.fit(_data(n=2), log_every=1, log_fn=logs.append)
    assert len(logs) == 2 and logs[0].startswith("epoch 0 it 1: loss=")


@pytest.mark.parametrize("drop_last,shuffle", [(True, True), (False, True), (True, False)])
def test_dataloader_batches_equal_jax(drop_last, shuffle):
    rng = np.random.RandomState(0)
    x = rng.randn(42, 8).astype(np.float32)
    y = rng.randint(0, 4, 42).astype(np.int32)
    jd = JLoader([x, y], batch_size=8, seed=3, drop_last=drop_last, shuffle=shuffle)
    td = SingleDataLoader([x, y], batch_size=8, seed=3, drop_last=drop_last, shuffle=shuffle)
    assert td.num_batches == jd.num_batches == (5 if drop_last else 6)
    for _ in range(2):  # two epochs: each reshuffles by seed + epoch
        jb, tb = list(jd.epoch()), list(td)
        assert len(jb) == len(tb) == td.num_batches
        for (jx, jy), (tx, ty) in zip(jb, tb):
            assert np.array_equal(tx, np.asarray(jx)) and np.array_equal(ty, np.asarray(jy))


def test_refusals(monkeypatch):
    """The pipelined Trainer names its ROADMAP item, and the auto one over
    more than one device without a process group raises ``make_mesh``'s
    "run under torchrun" (on one device it trains: ``test_torch_port_search``;
    over a world of ranks: ``test_torch_port_search_mesh``); a
    mesh that is not a ``parallel.mesh.Mesh`` is a TypeError, and a Mesh is
    taken (each rank's cut: ``test_torch_port_mesh_training``); a quantized
    parameter tree is a TypeError, as a gradient of JAX's integer leaves
    is; without ``device`` the Trainer runs on the card or raises."""
    from flexflow_tpu_torch.parallel import auto as auto_lib
    from flexflow_tpu_torch.parallel.mesh import Mesh
    from flexflow_tpu_torch.training.dataloader import RankRows

    js, jparams, ts, npp = _models(TINY)
    params = tp.params_from_numpy(npp)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        Trainer(ts, params, SGDOptimizer(), mesh=object(), device="cpu")
    mesh = Mesh.fake(1, 2, 1)  # a rank's cut, made without a process group
    tr = Trainer(ts, params, SGDOptimizer(), mesh=mesh)
    assert tr.device == torch.device("cpu") and tr.shard.mesh is mesh
    assert tr.params["layers"]["wq"].shape[-2] == TINY["num_heads"] // 2
    with monkeypatch.context() as m:
        m.setattr(auto_lib, "device_count", lambda device=None: 2)
        with pytest.raises(RuntimeError, match="no layout candidate ran.*needs a process group"):
            Trainer(ts, params, SGDOptimizer(), mesh="auto", device="cpu")
    with pytest.raises(ValueError, match="'auto'"):
        Trainer(ts, params, SGDOptimizer(), mesh="manual", device="cpu")
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh"):
        Trainer(ts, params, SGDOptimizer(), pipeline_stages=2, device="cpu")
    rows = next(SingleDataLoader([np.arange(8)[:, None]], batch_size=4, shuffle=False,
                                 mesh=Mesh.fake(2, 1, 1)).epoch())[0]
    assert isinstance(rows, RankRows) and rows[:, 0].tolist() == [2, 3]
    quantized = tp.params_from_numpy(jax.tree.map(np.asarray, j_quant_params(
        js, jparams, bits=8, group_size=16, compute_dtype=jnp.float32)))
    with pytest.raises(TypeError, match="quantized or integer"):
        Trainer(ts, quantized, SGDOptimizer(), device="cpu")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(ts, params, SGDOptimizer())
