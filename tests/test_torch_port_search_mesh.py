"""The layout searches over a world of gloo ranks on the CPU
(``flexflow_tpu_torch/parallel/auto.py``, ``FFModel._auto_parallelize``,
``LLM.compile(auto_parallel=True)``; the spawn helpers of
``test_torch_port_mesh_serving.py``), held against the JAX package. JAX's
measured searches run on its 8 host devices and are slow tests there, so
its side here is its pure functions and its Trainer, FFModel and LLM under
the layout the ranks chose, passed explicitly:

- the training and serving candidates (hybrid ones included) and their
  analytic costs equal JAX's at n = 2, 4, 8;
- at a world of 2 every rank's report and choice are equal for
  ``Trainer(mesh="auto")``, ``FFModel.compile(auto_parallel=True)``,
  ``mlp_unify --auto-parallelism``, a Keras model and ``LLM.compile``;
- the Trainer's steps after the search are bitwise an explicit mesh's of
  the chosen layout and within 1e-5 of JAX's under it, and the search
  leaves the parameters it was given as it found them;
- FFModel: the parameters after the search equal those before it, and the
  losses under each cut (the chosen one, and each candidate forced alone)
  are within 1e-5 of JAX's; a data cut refuses a batch its ranks do not
  divide; a batch-norm graph skips the data cut on every rank;
  ``mlp_unify`` over the ranks gives its one-device losses;
- ``LLM.compile(auto_parallel=True)`` at f32 serves JAX's greedy tokens
  under the chosen degrees;
- the Trainer at C = 2 against its own one-device Trainer leaf by leaf
  after each step (C6);
- a candidate whose build fails on one rank alone, after its mesh is
  made, is skipped on every rank with that rank's text, and every
  candidate's groups are released on every rank.

The analytic-only branch and the hybrid-winner rule need no ranks: they are
in ``test_torch_port_search.py``.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_port_cp_layouts import HF_TINY, _hf_dir
from test_torch_port_mesh_serving import _join, _start, _tspec

TINY = dict(arch="LlamaForCausalLM", vocab_size=64, hidden_size=32, num_layers=4,
            num_heads=4, num_kv_heads=4, head_dim=8, intermediate_size=64,
            max_position_embeddings=64, norm_eps=1e-6)
GQA = dict(TINY, num_kv_heads=2, num_layers=8, intermediate_size=96)
MQA = dict(TINY, num_kv_heads=1, intermediate_size=96)
AUTO = dict(auto_batch_size=4, auto_seq_len=16)
UNIFY = (16, 32, [64, 64, 10])  # mlp_unify's small graph: batch, in_dim, hidden
FF_CANDIDATES = [(1, 2, "uniform"), (2, 1, "uniform"), (1, 2, "joint")]
LLM_PROMPTS = ["hello world", "abc def"]
REL = 1e-12


def _batch(vocab=64, seed=5):
    x = np.random.RandomState(seed).randint(0, vocab, (4, 16)).astype(np.int32)
    return x, np.roll(x, -1, 1)


def _unify_data(seed=0):
    batch, in_dim, hidden = UNIFY
    rng = np.random.RandomState(seed)
    xs = [rng.randn(4 * batch, in_dim).astype(np.float32) for _ in range(2)]
    return xs, rng.randint(0, hidden[-1], size=(4 * batch,)).astype(np.int32)


def _cnn(ff):
    """conv -> batch norm -> flat -> dense (a graph whose batch norm mixes rows)."""
    t = ff.create_tensor((8, 3, 8, 8))
    t = ff.conv2d(t, 4, 3, 3, 1, 1, 1, 1)
    t = ff.batch_norm(t)
    ff.dense(ff.flat(t), 10)
    return ff


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _tree_np(tree):
    return {k: _tree_np(v) if isinstance(v, dict) else v.detach().cpu().numpy().copy()
            for k, v in tree.items()}


def _trainer_case(case):
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer

    spec = _tspec(case["spec"])
    params = tp.params_from_numpy(case["params"])
    before = _tree_np(params)
    x, y = _batch()
    tr = Trainer(spec, params, SGDOptimizer(lr=0.1), mesh="auto", device="cpu", **AUTO)
    m = tr.mesh
    chosen = None if m is None else (m.data, m.pipe, m.model, tr.num_microbatches)
    losses = [tr.train_step(x, y) for _ in range(2)]
    auto_full = _tree_np(tr.full_params())
    mesh = None if m is None else make_mesh(*chosen[:3], device="cpu")
    ref = Trainer(spec, params, SGDOptimizer(lr=0.1), mesh=mesh, device="cpu",
                  pipeline_stages=1 if m is None else m.pipe,
                  num_microbatches=None if m is None else chosen[3])
    ref_losses = [ref.train_step(x, y) for _ in range(2)]
    ref_full = _tree_np(ref.full_params())
    same = all(np.array_equal(a, b) for a, b in zip(_leaves(auto_full), _leaves(ref_full)))
    untouched = all(np.array_equal(a, b) for a, b in zip(_leaves(before),
                                                         _leaves(_tree_np(params))))
    return dict(report=tr.auto_report, chosen=chosen, losses=losses, ref_losses=ref_losses,
                params_bitwise=same, untouched=untouched)


def _leaves(tree):
    """The leaves of a nested dict, in the order of their sorted paths."""
    flat = _flat(tree)
    return [flat[k] for k in sorted(flat)]


def _ff_unify(params, cand=None):
    """mlp_unify's small graph compiled with the search over the world
    (``cand``: that candidate alone); (model, the full params before and
    after the search, the losses of 2 epochs, evaluate, forward)."""
    from flexflow_tpu_torch.examples import mlp_unify
    from flexflow_tpu_torch.ffmodel import FFModel, SGDOptimizer
    from flexflow_tpu_torch.ffmodel import cut as cut_lib

    batch, in_dim, hidden = UNIFY
    xs, y = _unify_data()
    ff = mlp_unify.build(FFModel(device="cpu"), batch, in_dim, hidden)
    ff.compile(SGDOptimizer(lr=0.01), auto_parallel=True)
    ff.load_numpy(params)
    before = _tree_np(ff.full_params())
    keep = cut_lib.candidates
    if cand is not None:
        cut_lib.candidates = lambda n, b, plan: [cand]
    try:
        ff.fit(xs, y, batch_size=batch, epochs=0, log_fn=lambda *a: None)
    finally:
        cut_lib.candidates = keep
    after = _tree_np(ff.full_params())
    hist = ff.fit(xs, y, batch_size=batch, epochs=2, shuffle=False, log_fn=lambda *a: None)
    out = dict(report=ff.auto_report, cut=(ff._cut.mesh.data, ff._cut.mesh.model,
                                           sorted(ff._cut.views)),
               unchanged=all(np.array_equal(a, b) for a, b in
                             zip(_leaves(before), _leaves(after))),
               losses=[h["loss"] for h in hist], accuracy=hist[-1]["accuracy"],
               evaluate=ff.evaluate(xs, y, batch_size=batch)["loss"],
               forward=ff.forward([a[:batch] for a in xs]),
               params=_tree_np(ff.full_params()), refused=None)
    try:  # a batch the data ranks do not divide
        ff.fit(xs, y, batch_size=batch - 1, epochs=1, log_fn=lambda *a: None)
    except ValueError as e:
        out["refused"] = str(e)
    return out


def _ffmodel_case(case):
    import contextlib
    import io

    from flexflow_tpu_torch.examples import mlp_unify
    from flexflow_tpu_torch.ffmodel import FFModel, SGDOptimizer

    out = {"auto": _ff_unify(case["params"])}
    for cand in FF_CANDIDATES:
        out[cand] = _ff_unify(case["params"], cand)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        hist = mlp_unify.main(["--auto-parallelism", "--epochs", "2"], device="cpu")
    out["cli"] = dict(losses=[h["loss"] for h in hist], text=text.getvalue())
    ff = _cnn(FFModel(device="cpu"))
    ff.compile(SGDOptimizer(lr=0.01), auto_parallel=True)
    rng = np.random.RandomState(3)
    x = rng.randn(16, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 10, size=(16,)).astype(np.int32)
    hist = ff.fit(x, y, batch_size=8, epochs=1, shuffle=False, log_fn=lambda *a: None)
    out["cnn"] = dict(report=ff.auto_report, losses=[h["loss"] for h in hist])
    return out


def _keras_case(case):
    import flexflow_tpu_torch.keras as tk

    m = tk.Sequential([tk.Input(shape=(32,), batch_size=16), tk.Dense(64, activation="relu"),
                       tk.Dense(10)], device="cpu")
    m.compile(optimizer=tk.SGD(learning_rate=0.01), auto_parallel=True)
    x, y = case["x"], case["y"]
    hist = m.fit(x, y, batch_size=16, epochs=2)
    return dict(report=m.ffmodel.auto_report, losses=[h["loss"] for h in hist])


def _llm_case(case, model_dir):
    from flexflow_tpu_torch.serve import LLM

    llm = LLM(model_dir, data_type="float32", device="cpu")
    llm.compile(max_requests_per_batch=2, max_seq_length=64, auto_parallel=True)
    res = llm.generate(LLM_PROMPTS, max_new_tokens=8)
    m = llm.mesh
    return dict(report=llm.auto_report, tokens=[r.output_tokens for r in res],
                degrees=None if m is None else (m.data, m.pipe, m.model))


def _c6_case(case):
    """The Trainer at C = 2 against its one-device Trainer: the first step
    and leaf whose bits part (None: every step bitwise)."""
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer

    spec = _tspec(case["spec"])
    params = tp.params_from_numpy(case["params"])
    x, y = _batch()
    cp = Trainer(spec, params, SGDOptimizer(lr=0.1), mesh=make_mesh(seq=2, device="cpu"))
    one = Trainer(spec, params, SGDOptimizer(lr=0.1), device="cpu")
    parted, losses = None, []
    for step in range(3):
        losses.append((cp.train_step(x, y), one.train_step(x, y)))
        got, want = _flat(_tree_np(cp.full_params())), _flat(_tree_np(one.full_params()))
        for name in sorted(want):
            if parted is None and not np.array_equal(got[name], want[name]):
                parted = (step, name, float(np.abs(got[name] - want[name]).max()))
    return dict(parted=parted, losses=losses)


def _fail_case(case):
    """``Trainer(mesh="auto")`` with the tp = 2 candidate's Trainer raising
    on rank 1 alone, after its mesh is made: every rank skips it with one
    text, every candidate's mesh is released on every rank, and the search
    ends with another layout."""
    import torch.distributed as dist

    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel import mesh as mesh_lib
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer
    from flexflow_tpu_torch.training import trainer as trainer_lib

    released = []
    release, init = mesh_lib.Mesh.release, trainer_lib.Trainer.__init__

    def counted(self):
        released.append((self.data, self.pipe, self.model))
        release(self)

    def failing(self, *a, mesh=None, **k):
        if getattr(mesh, "model", 1) > 1 and dist.get_rank() == 1:
            raise MemoryError("out of memory on this rank")
        init(self, *a, mesh=mesh, **k)

    mesh_lib.Mesh.release, trainer_lib.Trainer.__init__ = counted, failing
    try:
        tr = Trainer(_tspec(case["spec"]), tp.params_from_numpy(case["params"]),
                     SGDOptimizer(lr=0.1), mesh="auto", device="cpu", **AUTO)
    finally:
        mesh_lib.Mesh.release, trainer_lib.Trainer.__init__ = release, init
    m = tr.mesh
    return dict(report=tr.auto_report, released=released,
                chosen=None if m is None else (m.data, m.pipe, m.model))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def run_search_cases(cases, model_dir):
    out = {}
    for case in cases:
        kind = case["kind"]
        out[kind] = (_llm_case(case, model_dir) if kind == "llm" else
                     {"trainer": _trainer_case, "ffmodel": _ffmodel_case,
                      "keras": _keras_case, "c6": _c6_case, "fail": _fail_case}[kind](case))
    return out


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _jax_params(kw, seed=0):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.models import params as jp

    js = jspecs.ModelSpec(**kw)
    params = jp.init_params(js, jax.random.PRNGKey(seed), jnp.float32)
    return js, params, jax.tree.map(np.asarray, params)


def _port_machine_values():
    from flexflow_tpu_torch.parallel import auto as ta

    return {k: getattr(ta.MachineModel(), k) for k in ("chip_flops", "hbm_bw", "ici_bw",
                                                        "hbm_bytes")}


def _jax_serving_candidates(ja, n, spec, batch):
    """JAX's construction in ``optimize_serving_layout`` (auto.py:357-368)."""
    cands = [lo for lo in ja.enumerate_layouts(n, spec, batch) if lo.data == 1]
    for lo in list(cands):
        if lo.pipe != 1 or lo.model >= n:
            continue
        rem = n // lo.model
        if rem > 1 and spec.intermediate_size % (lo.model * rem) == 0:
            cands.append(ja.Layout(rem, 1, lo.model, hybrid_ffn=True))
    return cands


@pytest.mark.parametrize("n", [2, 4, 8])
def test_candidates_and_costs_match_jax(n):
    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.parallel import auto as ja
    from flexflow_tpu_torch import specs as tspecs
    from flexflow_tpu_torch.parallel import auto as ta

    jm, tm = ja.MachineModel(**_port_machine_values()), ta.MachineModel()
    seen = 0
    for kw in (TINY, GQA, MQA):
        js, ts = jspecs.ModelSpec(**kw), tspecs.ModelSpec(**kw)
        for batch in (2, 4, 8):
            for serving in (False, True):
                if serving:
                    jl, tl = _jax_serving_candidates(ja, n, js, batch), \
                        ta.serving_candidates(n, ts, batch)
                else:
                    jl, tl = ja.enumerate_layouts(n, js, batch), ta.enumerate_layouts(n, ts, batch)
                assert [dataclasses.astuple(lo) for lo in tl] == \
                    [dataclasses.astuple(lo) for lo in jl]
                for jlo, tlo in zip(jl, tl):
                    got = ta.analytic_cost(tlo, ts, batch, 64, tm, train=not serving)
                    want = ja.analytic_cost(jlo, js, batch, 64, jm, train=not serving)
                    assert got == pytest.approx(want, rel=REL)
                    seen += 1
                    seen += any(lo.hybrid_ffn for lo in tl)
    assert seen > 20


def test_two_ranks_search_and_train_as_jax(tmp_path):
    import jax

    import examples.mlp_unify as j_mlp_unify
    from flexflow_tpu.config import config as jconfig
    from flexflow_tpu.ffmodel.model import FFModel as JFF
    from flexflow_tpu.parallel import auto as ja
    from flexflow_tpu.parallel import joint as jj
    from flexflow_tpu.parallel.mesh import make_mesh as jmake_mesh
    from flexflow_tpu.serve import LLM as JLLM
    from flexflow_tpu.training import SGDOptimizer as JSGD
    from flexflow_tpu.training import Trainer as JTrainer
    from flexflow_tpu_torch.config import config as tconfig
    import flexflow_tpu_torch.keras as tk
    from flexflow_tpu_torch.examples import mlp_unify as t_mlp_unify

    js, jparams, npp = _jax_params(TINY)
    model_dir = str(_hf_dir(tmp_path / "hf", HF_TINY))
    # the FFModel's parameters: JAX's init of mlp_unify's graph, planned at n = 2
    j = j_mlp_unify.build(JFF(), *UNIFY)
    plan = jj.joint_optimize(j._nodes, j._inputs, n_devices=2, batch=UNIFY[0],
                             machine=ja.MachineModel(**_port_machine_values()),
                             budget=tconfig.search_budget * 4, alpha=tconfig.search_alpha)
    j._nodes, j._inputs = plan.nodes, plan.input_ids
    old, jconfig.fusion = jconfig.fusion, False
    try:
        j.compile(optimizer=JSGD(lr=0.01))
    finally:
        jconfig.fusion = old
    ff_params = jax.tree.map(np.asarray, j.params)
    rng = np.random.RandomState(1)
    kx = rng.randn(64, 32).astype(np.float32)
    ky = rng.randint(0, 10, size=(64,)).astype(np.int32)
    cases = [dict(kind="trainer", spec=TINY, params=npp),
             dict(kind="ffmodel", params=ff_params),
             dict(kind="keras", x=kx, y=ky),
             dict(kind="llm"),
             dict(kind="c6", spec=TINY, params=npp),
             dict(kind="fail", spec=TINY, params=npp)]
    started = _start(tmp_path, 2, cases, model_dir=model_dir, runner=run_search_cases)
    # JAX's side while the ranks run: the FFModel's losses, one device
    xs, y = _unify_data()
    jh = j.fit(xs, y, batch_size=UNIFY[0], epochs=2, shuffle=False)
    jeval = j.evaluate(xs, y, batch_size=UNIFY[0])["loss"]
    jfwd = np.asarray(j.forward([a[:UNIFY[0]] for a in xs]))
    # the port's one-device mlp_unify and Keras model
    one_cli = [h["loss"] for h in t_mlp_unify.main(["--auto-parallelism", "--epochs", "2"],
                                                   device="cpu")]
    km = tk.Sequential([tk.Input(shape=(32,), batch_size=16), tk.Dense(64, activation="relu"),
                        tk.Dense(10)], device="cpu")
    km.compile(optimizer=tk.SGD(learning_rate=0.01), auto_parallel=True)
    one_keras = [h["loss"] for h in km.fit(kx, ky, batch_size=16, epochs=2)]
    r0, r1 = _join(tmp_path, 2, started)

    # every rank: the same report and choice
    for kind in ("trainer", "llm"):
        assert [e["layout"] for e in r0[kind]["report"]] == \
            [e["layout"] for e in r1[kind]["report"]]
        assert [e["measured_s"] for e in r0[kind]["report"]] == \
            [e["measured_s"] for e in r1[kind]["report"]]
    for key in ("auto", *FF_CANDIDATES, "cnn"):
        assert r0["ffmodel"][key]["report"] == r1["ffmodel"][key]["report"]
    assert r0["keras"]["report"] == r1["keras"]["report"]
    assert r0["trainer"]["chosen"] == r1["trainer"]["chosen"]
    assert r0["llm"]["degrees"] == r1["llm"]["degrees"]
    assert r0["ffmodel"]["auto"]["cut"] == r1["ffmodel"]["auto"]["cut"]

    # the Trainer: JAX's ranking of the candidates, the explicit mesh's bits,
    # JAX's losses under the chosen layout, the given parameters untouched
    tr = r0["trainer"]
    ts = _tspec(TINY)
    ranked = sorted(ja.enumerate_layouts(2, js, 4), key=lambda lo: ja.analytic_cost(
        lo, js, 4, 16, ja.MachineModel(**_port_machine_values())))
    assert [e["layout"] for e in tr["report"]] == [str(lo) for lo in ranked]
    for e, lo in zip(tr["report"], ranked):
        assert e["analytic_s"] == pytest.approx(ja.analytic_cost(
            lo, js, 4, 16, ja.MachineModel(**_port_machine_values())), rel=REL)
        assert 0 < e["measured_s"] < float("inf") and "error" not in e
    assert ts.num_layers == js.num_layers
    for r in (r0, r1):
        assert r["trainer"]["losses"] == r["trainer"]["ref_losses"]
        assert r["trainer"]["params_bitwise"] and r["trainer"]["untouched"]
    d, p, m, mb = tr["chosen"]
    jtr = JTrainer(js, jparams, JSGD(lr=0.1), mesh=jmake_mesh(data=d, pipe=p, model=m),
                   pipeline_stages=p, num_microbatches=mb)
    x, y_ = _batch()
    want = [float(jtr.train_step(x, y_)) for _ in range(2)]
    np.testing.assert_allclose(tr["losses"], want, rtol=1e-5)

    # FFModel: the search leaves the parameters; every cut trains as JAX
    ffo = r0["ffmodel"]
    for key in ("auto", *FF_CANDIDATES):
        got = ffo[key]
        assert got["unchanged"], key
        np.testing.assert_allclose(got["losses"], [h["loss"] for h in jh], rtol=1e-5)
        np.testing.assert_allclose(got["evaluate"], jeval, rtol=1e-5)
        np.testing.assert_allclose(got["forward"], jfwd, rtol=1e-5, atol=1e-7)
        assert r1["ffmodel"][key]["losses"] == got["losses"]
        assert got["refused"] == (None if got["cut"][0] == 1 else
                                  f"a batch of {UNIFY[0] - 1} rows does not split over 2 data ranks")
    for cand in FF_CANDIDATES:
        dp, tp_, kind = cand
        [entry] = ffo[cand]["report"]
        assert entry["layout"] == f"dp={dp} tp={tp_}" + (
            " (joint per-op views)" if kind == "joint" else "")
        assert ffo[cand]["cut"][:2] == (dp, tp_)
    labels = [e["layout"] for e in ffo["auto"]["report"]]
    assert labels == ["dp=1 tp=2", "dp=2 tp=1", "dp=1 tp=2 (joint per-op views)"]
    np.testing.assert_allclose(r0["ffmodel"]["cli"]["losses"], one_cli, rtol=1e-5)
    assert "final:" in r0["ffmodel"]["cli"]["text"] and not r1["ffmodel"]["cli"]["text"]
    cnn = r0["ffmodel"]["cnn"]["report"]
    assert "mixes the batch's rows" in cnn[1]["error"] and "batch_norm" in cnn[1]["error"]
    assert "measured_s" in cnn[0] and np.isfinite(r0["ffmodel"]["cnn"]["losses"]).all()
    np.testing.assert_allclose(r0["keras"]["losses"], one_keras, rtol=1e-5)

    # LLM: JAX's tokens under the chosen degrees
    llm = r0["llm"]
    assert [e["layout"] for e in llm["report"]] == ["dp=1 pp=2 tp=1 mb=2", "dp=1 pp=1 tp=2 mb=1"] \
        or sorted(e["layout"] for e in llm["report"]) == sorted(
            ["dp=1 pp=2 tp=1 mb=2", "dp=1 pp=1 tp=2 mb=1"])
    assert llm["tokens"] == r1["llm"]["tokens"]
    _, pp, tp_ = llm["degrees"]
    jllm = JLLM(model_dir, data_type="float32")
    jllm.compile(max_requests_per_batch=2, max_seq_length=64, tensor_parallelism_degree=tp_,
                 pipeline_parallelism_degree=pp)
    assert llm["tokens"] == [r.output_tokens for r in
                             jllm.generate(LLM_PROMPTS, max_new_tokens=8)]

    # a build that fails on rank 1 alone after its mesh: skipped on both
    # ranks with rank 1's text, every candidate's groups released on both
    fail = r0["fail"]
    assert fail["report"] == r1["fail"]["report"] and fail["chosen"] == r1["fail"]["chosen"]
    [bad] = [e for e in fail["report"] if "tp=2" in e["layout"]]
    assert bad["measured_s"] == float("inf")
    assert bad["error"] == "rank 1: MemoryError: out of memory on this rank"
    assert fail["chosen"] is not None and fail["chosen"][2] == 1
    assert all("error" not in e for e in fail["report"] if e is not bad)
    built = sorted((lo.data, lo.pipe, lo.model) for lo in ja.enumerate_layouts(2, js, 4))
    for r in (r0, r1):
        assert sorted(r["fail"]["released"]) == built

    # C6: the Trainer at C = 2 against the port's one device
    c6 = r0["c6"]
    assert c6["parted"] is None, c6
    assert all(a == b for a, b in c6["losses"])
