"""The port's graph substitutions (``flexflow_tpu_torch/ffmodel/substitutions.py``)
against the JAX package's on the same builder calls: the four graphs of
``tests/test_substitutions.py`` and a rule file give the same rewritten node
lists (ops, names, inputs, attrs, shapes) and the same report, through
``optimize_graph`` and through ``FFModel.compile``; the same single-rewrite
sites (``match_sites``); and on the port the rewrites keep the outputs
exact (f32, CPU)."""

import json

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu.config import config as jconfig
from flexflow_tpu.ffmodel import FFModel as JFF
from flexflow_tpu.ffmodel import substitutions as jsub
from flexflow_tpu_torch.config import config as tconfig
from flexflow_tpu_torch.ffmodel import FFModel, SGDOptimizer
from flexflow_tpu_torch.ffmodel import substitutions as tsub

torch.set_num_threads(2)


def _sig(nodes):
    def attr(v):
        if isinstance(v, torch.dtype) or isinstance(v, type) or hasattr(v, "dtype"):
            return str(v).replace("torch.", "").replace("<class 'numpy.", "").rstrip("'>")
        return v
    return [(n.op, n.name, [(t.node, t.index, tuple(t.shape)) for t in n.inputs],
             {k: attr(v) for k, v in sorted(n.attrs.items())}, [tuple(s) for s in n.out_shapes])
            for n in nodes]


def _build_net(ff):
    x = ff.create_tensor((4, 16))
    h = ff.dense(x, 32)          # fusable with the relu below
    h = ff.relu(h)
    h = ff.identity(h)           # eliminated
    h = ff.reshape(h, (4, 2, 16))
    h = ff.reshape(h, (4, 32))   # collapsed
    parts = ff.split(h, [16, 16], axis=1)
    h = ff.concat(parts, axis=1)  # split+concat eliminated
    ff.dense(h, 8)


def _bn_relu(ff):
    x = ff.create_tensor((4, 3, 8, 8))
    h = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1)
    h = ff.batch_norm(h, relu=False)
    ff.relu(h)


def _dense_relu_dense(ff):
    x = ff.create_tensor((8, 16))
    h = ff.dense(x, 32)
    h = ff.relu(h)
    ff.dense(h, 4)


def _split_partial_consumer(ff):
    x = ff.create_tensor((2, 8))
    parts = ff.split(x, [4, 4], axis=1)
    cat = ff.concat(parts, axis=1)
    extra = ff.relu(parts[0])
    ff.add(cat, ff.concat([extra, extra], axis=1))


GRAPHS = {"net": _build_net, "bn_relu": _bn_relu, "dense_relu_dense": _dense_relu_dense,
          "split_partial_consumer": _split_partial_consumer}


def _graphs(build):
    j, t = JFF(), FFModel(device="cpu")
    build(j)
    build(t)
    assert _sig(t._nodes) == _sig(j._nodes)
    return j, t


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_optimize_graph_matches_jax(name):
    j, t = _graphs(GRAPHS[name])
    assert tsub.match_sites(t._nodes, t._inputs) == jsub.match_sites(j._nodes, j._inputs)
    jn, ji, jr = jsub.optimize_graph(j._nodes, j._inputs)
    tn, ti, tr = tsub.optimize_graph(t._nodes, t._inputs)
    assert _sig(tn) == _sig(jn) and ti == ji and tr == jr
    for site in jsub.match_sites(j._nodes, j._inputs):  # each rewrite alone
        a = jsub.optimize_graph(j._nodes, j._inputs, only_site=site)
        b = tsub.optimize_graph(t._nodes, t._inputs, only_site=site)
        assert _sig(b[0]) == _sig(a[0]) and b[1:] == a[1:]


def _compiled(build, fusion, rules=None):
    """The JAX model and the port's compiled under the same ``fusion`` and
    ``substitution_json``; the port carries JAX's parameters."""
    saved = [(c, c.fusion, c.substitution_json) for c in (jconfig, tconfig)]
    try:
        for c in (jconfig, tconfig):
            c.fusion, c.substitution_json = fusion, rules
        j, t = _graphs(build)
        j.compile(optimizer=None)
        t.compile(optimizer=None)
    finally:
        for c, f, r in saved:
            c.fusion, c.substitution_json = f, r
    assert _sig(t._nodes) == _sig(j._nodes)
    assert t.substitution_report == j.substitution_report
    t.load_numpy(jax.tree.map(np.asarray, j.params), jax.tree.map(np.asarray, j.state))
    return j, t


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_compile_rewrites_as_jax_and_keeps_outputs(name):
    """Under ``config.fusion`` the port's compile gives JAX's graph and report;
    the fused and unfused port graphs on the same parameters give the same
    outputs exactly, and JAX's within 1e-5 of the magnitude."""
    build = GRAPHS[name]
    j1, t1 = _compiled(build, True)
    _, t0 = _compiled(build, False)
    assert len(t1._nodes) <= len(t0._nodes)
    xs = [np.random.RandomState(i).randn(*t1._nodes[k].out_shapes[0]).astype(np.float32)
          for i, k in enumerate(t1._inputs)]
    want = np.asarray(j1.forward(xs))
    assert np.abs(t1.forward(xs) - want).max() <= 1e-5 * np.abs(want).max()
    # names survive the rewrites: the unfused graph's parameters, moved by name
    t1.load_numpy({k: {leaf: v.detach().numpy() for leaf, v in d.items()}
                   for k, d in t0.params.items() if k in t1.params})
    np.testing.assert_array_equal(t1.forward(xs), t0.forward(xs))


def test_reports_of_the_rewrites():
    _, t = _compiled(_build_net, True)
    rep = t.substitution_report
    for rule in ("fuse-activation", "eliminate-identity", "collapse-reshape",
                 "eliminate-split-concat"):
        assert rep.get(rule, 0) >= 1, rep
    _, t = _compiled(_bn_relu, True)
    assert t.substitution_report.get("fuse-bn-relu", 0) == 1
    assert any(n.op == "batch_norm" and n.attrs["relu"] for n in t._nodes)
    assert not any(n.op == "relu" for n in t._nodes)
    t = FFModel(device="cpu")
    _split_partial_consumer(t)
    nodes, _, rep = tsub.optimize_graph(t._nodes, t._inputs)
    assert rep.get("eliminate-split-concat", 0) == 1
    assert any(n.op == "split" for n in nodes)  # still live for the relu


@pytest.mark.parametrize("doc", [{"rules": ["fuse-activation", "collapse-reshape"]},
                                 {"disable": ["eliminate-identity", "eliminate-split-concat"]}])
def test_rule_file_matches_jax(tmp_path, doc):
    path = str(tmp_path / "rules.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    assert tsub.load_rules(path) == jsub.load_rules(path)
    j, t = _compiled(_build_net, True, rules=path)
    assert "eliminate-identity" not in t.substitution_report
    assert any(n.op == "identity" for n in t._nodes)


def test_bad_rule_files_refused(tmp_path):
    for doc in ({"rules": ["no-such-rule"]}, {"neither": []}):
        path = str(tmp_path / "bad.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        with pytest.raises(ValueError):
            tsub.load_rules(path)


def test_substituted_graph_trains():
    """A fused graph (dense + relu folded) trains: the loss does not rise
    over 2 epochs (SGD)."""
    ff = FFModel(device="cpu")
    _dense_relu_dense(ff)
    ff.compile(SGDOptimizer(lr=0.1))
    assert ff.substitution_report.get("fuse-activation") == 1
    xs = np.random.RandomState(0).randn(16, 16).astype(np.float32)
    ys = (np.arange(16) % 4).astype(np.int32)
    hist = ff.fit(xs, ys, batch_size=8, epochs=2)
    assert np.isfinite(hist[-1]["loss"])
    assert hist[-1]["loss"] <= hist[0]["loss"] + 1e-3
