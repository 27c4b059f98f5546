"""The port's search on one device (``flexflow_tpu_torch/parallel/{auto,joint,
topology,pipeline}.py``) against the JAX package's, and its entry points.

- ``layout_dp``, ``sequence_optimize`` (split forced by ``base_threshold``)
  and ``joint_optimize`` at n = 2 and 8 on the same builder calls (the
  interplay model of ``tests/test_joint_search.py``, a dense chain,
  ``mlp_unify``'s small graph): the same nodes, applied sites and views,
  costs within 1e-12 relative, at JAX's ``MachineModel`` values (the port's
  defaults are the H100's). ``joint_optimize(pipe=2)``'s stages.
- ``enumerate_layouts``, ``analytic_cost`` (train and serve, hybrid and
  not, with a ``TorusTopology`` at JAX's v5e / v4 values and without),
  ``estimate_memory``, ``memory_constrained_search`` and
  ``simulate_runtime`` over caches pre-filled with the same seconds under
  the same keys (nothing is timed), and the topology's collectives.
- ``OpCostCache`` for its caching only (its times are never asserted).
- The entry points on the CPU: ``FFModel.compile(auto_parallel=True)``
  equal to JAX's ``joint_optimize(n_devices=2)`` given the port's machine
  values, ``mlp_unify --auto-parallelism`` and Keras training against
  JAX's planned graph, ``Trainer(mesh="auto")`` against ``mesh=None`` and
  JAX, ``optimize_serving_layout`` on one device, and the refusals over
  more than one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.mlp_unify as j_mlp_unify
from flexflow_tpu import specs as jspecs
from flexflow_tpu.config import config as jconfig
from flexflow_tpu.ffmodel.model import FFModel as JFF
from flexflow_tpu.ffmodel.substitutions import ALL_RULES
from flexflow_tpu.models import params as jp
from flexflow_tpu.parallel import auto as ja
from flexflow_tpu.parallel import joint as jj
from flexflow_tpu.parallel import pipeline as jpipe
from flexflow_tpu.parallel import topology as jtopo
from flexflow_tpu.training import SGDOptimizer as JSGD
from flexflow_tpu.training import Trainer as JTrainer
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.config import config as tconfig
from flexflow_tpu_torch.examples import mlp_unify as t_mlp_unify
from flexflow_tpu_torch.ffmodel import FFModel as TFF
from flexflow_tpu_torch.ffmodel import SGDOptimizer as TFFSGD
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.parallel import auto as ta
from flexflow_tpu_torch.parallel import joint as tj
from flexflow_tpu_torch.parallel import pipeline as tpipe
from flexflow_tpu_torch.parallel import topology as ttopo
from flexflow_tpu_torch.training import SGDOptimizer as TSGD
from flexflow_tpu_torch.training import Trainer as TTrainer

torch.set_num_threads(2)
REL = 1e-12
MACHINE_FIELDS = ("chip_flops", "hbm_bw", "ici_bw", "hbm_bytes")


def _machines(values=None):
    """(JAX's, the port's) MachineModel at ``values`` (default: JAX's)."""
    values = values or {k: getattr(ja.MachineModel(), k) for k in MACHINE_FIELDS}
    return ja.MachineModel(**values), ta.MachineModel(**values)


def _topologies(dims, link):
    return (jtopo.TorusTopology(dims=dims, link_bw=link, dcn_bw=jtopo.DCN_BW),
            ttopo.TorusTopology(dims=dims, link_bw=link, dcn_bw=jtopo.DCN_BW))


def _spec_pair(**kw):
    return jspecs.ModelSpec(**kw), tspecs.ModelSpec(**kw)


TINY = dict(arch="LlamaForCausalLM", vocab_size=64, hidden_size=32, num_layers=4,
            num_heads=4, num_kv_heads=4, head_dim=8, intermediate_size=64,
            max_position_embeddings=64, norm_eps=1e-6)
GQA = dict(TINY, num_kv_heads=2, num_layers=8, intermediate_size=96)
BIG = dict(arch="LlamaForCausalLM", vocab_size=32000, hidden_size=4096, num_layers=32,
           num_heads=32, num_kv_heads=32, head_dim=128, intermediate_size=11008,
           max_position_embeddings=2048)
GELU = dict(TINY, arch="GPT2LMHeadModel", act="gelu", num_layers=6, num_heads=6,
            num_kv_heads=6, hidden_size=48)


def _close(got, want, rel=REL):
    if want == float("inf") or got == float("inf"):
        assert got == want
    else:
        assert abs(got - want) <= rel * abs(want), (got, want)


def _sig(nodes):
    """Package-neutral nodes: op, name, inputs, attrs (dtypes by name), shapes."""
    def attr(v):
        if isinstance(v, np.ndarray):
            return (v.dtype.kind, v.shape, v.tolist())
        if isinstance(v, torch.dtype) or isinstance(v, type) or hasattr(v, "dtype"):
            return np.dtype(str(v).replace("torch.", "")).name if not hasattr(v, "name") \
                else getattr(v, "name", str(v))
        if isinstance(v, (tuple, list)):
            return tuple(attr(x) for x in v)
        return v
    return [(n.op, n.name, [(t.node, t.index, tuple(t.shape)) for t in n.inputs],
             {k: attr(v) for k, v in sorted(n.attrs.items()) if k != "dtype"},
             [tuple(s) for s in n.out_shapes]) for n in nodes]


def _views(views):
    return {j: dataclasses.astuple(v) for j, v in views.items()}


# --- the graphs: the same builder calls through both packages ----------------

def _interplay(m):
    """tests/test_joint_search.py's: a dense whose row view dies if its relu
    fuses, then a dense + sigmoid where fusion is a pure win; batch 1."""
    x = m.create_tensor((1, 4096))
    d1 = m.dense(x, 2004, name="d1")
    a1 = m.relu(d1)
    d2 = m.dense(a1, 2004, name="d2")
    m.sigmoid(d2)
    return m, 1


def _chain(m):
    x = m.create_tensor((16, 512))
    t = x
    for i in range(12):
        t = m.dense(t, 512, name=f"l{i}")
        t = m.relu(t)
    return m, 16


def _megatron(m):
    x = m.create_tensor((4, 1024))
    r = m.relu(m.dense(x, 4096, name="up"))
    m.dense(r, 1024, name="down")
    return m, 4


def _unify(m):
    """examples/mlp_unify.py's CPU-size graph (batch 16, 32 -> 64, 64, 10)."""
    mod = j_mlp_unify if isinstance(m, JFF) else t_mlp_unify
    return mod.build(m, 16, 32, [64, 64, 10]), 16


def _stages(m):
    """tests/test_joint_search.py::test_stage_balance_composes's chain."""
    x = m.create_tensor((16, 256))
    t = x
    for i in range(6):
        t = m.dense(t, 256 if i % 2 else 1024, name=f"l{i}")
    return m, 16


GRAPHS = {"interplay": _interplay, "chain": _chain, "megatron": _megatron, "unify": _unify}


def _graph_pair(name):
    (j, batch), (t, _) = GRAPHS[name](JFF()), GRAPHS[name](TFF(device="cpu"))
    assert _sig(t._nodes) == _sig(j._nodes) and t._inputs == j._inputs
    return j, t, batch


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_layout_dp_matches_jax(name, n):
    j, t, batch = _graph_pair(name)
    jm, tm = _machines()
    jc, jv = jj.layout_dp(j._nodes, j._inputs, n=n, batch=batch, machine=jm)
    tc, tv = tj.layout_dp(t._nodes, t._inputs, n=n, batch=batch, machine=tm)
    _close(tc, jc)
    assert _views(tv) == _views(jv)
    for node_t, node_j in zip(t._nodes, j._nodes):
        assert [dataclasses.astuple(v) for v in tj.op_views(node_t, n, batch)] == [
            dataclasses.astuple(v) for v in jj.op_views(node_j, n, batch)]


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", ["chain", "unify"])
def test_sequence_optimize_matches_jax(name, n):
    """A base_threshold of 8 forces the split recursion on both graphs."""
    j, t, batch = _graph_pair(name)
    split = tj.find_bottleneck(t._nodes, t._inputs)
    assert split is not None and split == jj.find_bottleneck(j._nodes, j._inputs)
    jm, tm = _machines()
    jc, jv = jj.sequence_optimize(j._nodes, j._inputs, n=n, batch=batch, machine=jm,
                                  base_threshold=8)
    tc, tv = tj.sequence_optimize(t._nodes, t._inputs, n=n, batch=batch, machine=tm,
                                  base_threshold=8)
    _close(tc, jc)
    assert _views(tv) == _views(jv)


def _plans_equal(tplan, jplan):
    assert _sig(tplan.nodes) == _sig(jplan.nodes)
    assert tplan.input_ids == jplan.input_ids
    assert tplan.applied == jplan.applied
    assert _views(tplan.views) == _views(jplan.views)
    _close(tplan.cost, jplan.cost)
    assert [r["applied"] for r in tplan.report] == [r["applied"] for r in jplan.report]
    for tr, jr in zip(tplan.report, jplan.report):
        _close(tr["cost"], jr["cost"])


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_joint_optimize_matches_jax(name, n):
    j, t, batch = _graph_pair(name)
    jm, tm = _machines()
    kw = dict(n_devices=n, batch=batch, rules=ALL_RULES, budget=32, alpha=1.2,
              base_threshold=8 if name == "chain" else 24)
    _plans_equal(tj.joint_optimize(t._nodes, t._inputs, machine=tm, **kw),
                 jj.joint_optimize(j._nodes, j._inputs, machine=jm, **kw))


def test_joint_pipe_stages_match_jax():
    (j, batch), (t, _) = _stages(JFF()), _stages(TFF(device="cpu"))
    jm, tm = _machines()
    jplan = jj.joint_optimize(j._nodes, j._inputs, n_devices=8, batch=batch, machine=jm, pipe=2)
    tplan = tj.joint_optimize(t._nodes, t._inputs, n_devices=8, batch=batch, machine=tm, pipe=2)
    _plans_equal(tplan, jplan)
    assert tplan.stages == jplan.stages and sum(tplan.stages) == len(tplan.nodes)
    costs = np.random.RandomState(3).rand(11).tolist()
    for p in (1, 2, 3, 5, 11):
        assert tpipe.balance_stages(costs, p) == jpipe.balance_stages(costs, p)


def test_reshard_cost_matches_jax():
    jm, tm = _machines()
    for src in jj.STATES:
        for dst in jj.STATES:
            for n in (2, 8):
                _close(tj.reshard_cost(src, dst, 12345.0, n, tm),
                       jj.reshard_cost(src, dst, 12345.0, n, jm))


# --- the layout functions ----------------------------------------------------

SPECS = {"tiny": TINY, "gqa": GQA, "big": BIG, "gelu": GELU}


def _layouts(n, js, ts, batch):
    jl, tl = ja.enumerate_layouts(n, js, batch), ta.enumerate_layouts(n, ts, batch)
    assert [dataclasses.astuple(lo) for lo in tl] == [dataclasses.astuple(lo) for lo in jl]
    assert [str(lo) for lo in tl] == [str(lo) for lo in jl]
    return jl, tl


def _with_hybrid(jl, tl, n):
    """Each layout, and its hybrid-FFN twin where the serving search makes one."""
    extra = [(ja.Layout(n // lo.model, 1, lo.model, hybrid_ffn=True),
              ta.Layout(n // lo.model, 1, lo.model, hybrid_ffn=True))
             for lo in jl if lo.pipe == 1 and lo.model < n]
    return list(zip(jl, tl)) + extra


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_enumerate_and_analytic_cost_match_jax(spec):
    js, ts = _spec_pair(**SPECS[spec])
    jm, tm = _machines()
    topos = [(None, None), _topologies((4, 4), jtopo.V5E_LINK),
             _topologies((2, 2, 2), jtopo.V4_LINK), _topologies((2, 2), jtopo.V5E_LINK)]
    seen = 0
    for n in (1, 2, 4, 8, 16):
        for batch in (1, 8, 12):
            jl, tl = _layouts(n, js, ts, batch)
            for jlo, tlo in _with_hybrid(jl, tl, n):
                for jt, tt in topos:
                    jmm = dataclasses.replace(jm, topology=jt)
                    tmm = dataclasses.replace(tm, topology=tt)
                    for train in (True, False):
                        for seq in (16, 512):
                            _close(ta.analytic_cost(tlo, ts, batch, seq, tmm, train=train),
                                   ja.analytic_cost(jlo, js, batch, seq, jmm, train=train))
                            seen += 1
                    _close(ta.estimate_memory(tlo, ts, batch, 32, train=False),
                           ja.estimate_memory(jlo, js, batch, 32, train=False))
                _close(ta.estimate_memory(tlo, ts, batch, 32),
                       ja.estimate_memory(jlo, js, batch, 32))
    assert seen > 100
    if spec == "big":  # 7B training state: not on one v5e at dp=8, fits at tp=8
        assert ta.analytic_cost(ta.Layout(8, 1, 1), ts, 8, 512, tm) == float("inf")
        assert ta.analytic_cost(ta.Layout(1, 1, 8), ts, 8, 512, tm) < float("inf")


def test_topology_matches_jax():
    for dims, link in (((4, 4), jtopo.V5E_LINK), ((4, 4, 4), jtopo.V4_LINK),
                       ((8,), jtopo.V5E_LINK)):
        for wrap in (True, False):
            jt, tt = (dataclasses.replace(x, wraparound=wrap) for x in _topologies(dims, link))
            assert tt.num_devices == jt.num_devices
            for k in (1, 2, 4, 8, 16, 64, 128):
                assert tt.fits(k) == jt.fits(k)
                _close(tt.all_reduce_time(1e6, k), jt.all_reduce_time(1e6, k))
                _close(tt.all_gather_time(1e6, k), jt.all_gather_time(1e6, k))
                _close(tt.reduce_scatter_time(3e5, k), jt.reduce_scatter_time(3e5, k))
            _close(tt.ppermute_time(1e6), jt.ppermute_time(1e6))
            for axes in ({"data": 4, "model": 4}, {"data": 8, "pipe": 2, "model": 4},
                         {"data": 3, "model": 2}, {"data": 1, "model": 16}):
                assert tt.assign_axes(axes) == jt.assign_axes(axes)
    with pytest.raises(TypeError):
        ttopo.TorusTopology()  # no TPU presets: the caller gives the rates


@pytest.mark.parametrize("spec", ["tiny", "gqa"])
def test_memory_constrained_search_matches_jax(spec):
    """tests/test_auto_parallel.py's generous, tight and impossible budgets."""
    js, ts = _spec_pair(**SPECS[spec])
    jm, tm = _machines()
    kw = dict(n_devices=8, batch_size=8, seq_len=32)
    jbest, jrep = ja.memory_constrained_search(js, memory_budget_bytes=1e15, machine=jm, **kw)
    tbest, trep = ta.memory_constrained_search(ts, memory_budget_bytes=1e15, machine=tm, **kw)
    assert str(tbest) == str(jbest) and trep == jrep
    tight = ja.estimate_memory(jbest, js, 8, 32) * 0.5
    for budget in (tight, 1.0):
        for train in (True, False):
            jb, jr = ja.memory_constrained_search(js, memory_budget_bytes=budget, machine=jm,
                                                  train=train, **kw)
            tb, tr = ta.memory_constrained_search(ts, memory_budget_bytes=budget, machine=tm,
                                                  train=train, **kw)
            assert str(tb) == str(jb) and tr == jr
    assert ta.memory_constrained_search(ts, memory_budget_bytes=1.0, **kw)[0] is None


def _filled(cache, keys):
    """The same made-up seconds under each key: nothing is timed."""
    for i, key in enumerate(sorted(set(keys), key=repr)):
        cache._cache[key] = 1e-4 * (1 + (7 * i) % 13) / 3
    return cache


@pytest.mark.parametrize("spec", ["tiny", "gqa", "gelu"])
def test_simulate_runtime_matches_jax_on_filled_caches(spec):
    js, ts = _spec_pair(**SPECS[spec])
    jm, tm = _machines()
    for jlo, tlo in _with_hybrid(*_layouts(8, js, ts, 8), 8):
        jd = ja._op_descriptors(js, jlo, 8, 32)
        assert ta._op_descriptors(ts, tlo, 8, 32) == jd
        jc, tc = _filled(ja.OpCostCache(), jd), _filled(ta.OpCostCache(device="cpu"), jd)
        for train in (True, False):
            _close(ta.simulate_runtime(ts, tlo, 8, 32, tc, machine=tm, train=train),
                   ja.simulate_runtime(js, jlo, 8, 32, jc, machine=jm, train=train))
        assert len(tc) == len(jc) == len(set(jd))  # nothing new was measured


def test_op_cost_cache_caches():
    """tests/test_auto_parallel.py's cache checks on the CPU: hits, no
    growth, new keys at sharded shapes. The times are not asserted."""
    _, ts = _spec_pair(**TINY)
    cache = ta.OpCostCache(device="cpu")
    t1 = ta.simulate_runtime(ts, ta.Layout(1, 1, 1), 4, 32, cache)
    n_first = len(cache)
    assert n_first > 0 and t1 > 0
    t2 = ta.simulate_runtime(ts, ta.Layout(1, 1, 1), 4, 32, cache)
    assert len(cache) == n_first and t2 == t1
    ta.simulate_runtime(ts, ta.Layout(1, 1, 2), 4, 32, cache)
    assert len(cache) > n_first
    _, t, batch = _graph_pair("megatron")
    before = len(cache)
    cost, _ = tj.layout_dp(t._nodes, t._inputs, n=2, batch=batch, cache=cache)
    n_dp = len(cache)
    assert n_dp > before and cost < float("inf")
    assert tj.layout_dp(t._nodes, t._inputs, n=2, batch=batch, cache=cache)[0] == cost
    assert len(cache) == n_dp


def test_failed_candidates_are_reported():
    """A candidate that raises is skipped and its text kept; none running
    raises with every text (no silent fallback)."""
    _, ts = _spec_pair(**TINY)

    def factory(layout):
        if layout.model > 1:
            raise RuntimeError(f"cannot build tp={layout.model}")
        return lambda: None

    best, report = ta.optimize_layout(ts, factory, n_devices=8, batch_size=8, seq_len=16,
                                      device="cpu")
    assert best.model == 1
    errs = [r for r in report if "error" in r]
    assert all("cannot build" in r["error"] and r["measured_s"] == float("inf") for r in errs)
    with pytest.raises(RuntimeError, match="no layout candidate ran.*cannot build tp=2"):
        ta.optimize_layout(ts, lambda lo: factory(ta.Layout(1, 1, 2)), n_devices=8,
                           batch_size=8, seq_len=16, device="cpu")


# --- the entry points --------------------------------------------------------

def _jax_plan(j, batch, machine_values):
    jm, _ = _machines(machine_values)
    return jj.joint_optimize(
        j._nodes, j._inputs, n_devices=2, batch=batch, machine=jm,
        budget=tconfig.search_budget * 4, alpha=tconfig.search_alpha)


def _port_defaults():
    return {k: getattr(ta.MachineModel(), k) for k in MACHINE_FIELDS}


def _compile_planned_jax(j, plan, **kw):
    """JAX's model over a plan's graph as it stands (fusion off: the plan
    has already chosen the rewrites)."""
    j._nodes, j._inputs = plan.nodes, plan.input_ids
    old, jconfig.fusion = jconfig.fusion, False
    try:
        j.compile(**kw)
    finally:
        jconfig.fusion = old
    return j


@pytest.mark.parametrize("name", ["interplay", "unify"])
def test_compile_auto_parallel_equals_jax_plan(name):
    j, t, batch = _graph_pair(name)
    t.compile(TFFSGD(lr=0.01), loss_type="mean_squared_error", auto_parallel=True)
    plan = _jax_plan(j, batch, _port_defaults())
    _plans_equal(t.joint_plan, plan)
    assert _sig(t._nodes) == _sig(plan.nodes)
    want = {}
    for r, _ in plan.applied:
        want[r] = want.get(r, 0) + 1
    assert t.substitution_report == want
    plain = GRAPHS[name](TFF(device="cpu"))[0]
    plain.compile(TFFSGD(lr=0.01), loss_type="mean_squared_error")
    assert plain.joint_plan is None


def _first_epoch(j, t, xs, y, batch):
    t.load_numpy(jax.tree.map(np.asarray, j.params), jax.tree.map(np.asarray, j.state))
    jh = j.fit(xs, y, batch_size=batch, epochs=1)
    th = t.fit(xs, y, batch_size=batch, epochs=1, log_fn=lambda *a: None)
    assert np.isfinite(th[0]["loss"])
    _close(th[0]["loss"], jh[0]["loss"], rel=1e-5)


def test_mlp_unify_auto_parallelism_trains_as_jax_plan(capsys):
    """The example's CLI trains; its graph, compiled the same way, takes the
    first epoch JAX's model over JAX's plan takes."""
    hist = t_mlp_unify.main(["--auto-parallelism", "--epochs", "2"], device="cpu")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "final:" in capsys.readouterr().out
    j, t, batch = _graph_pair("unify")
    t.compile(TFFSGD(lr=0.001), auto_parallel=True)
    plan = _jax_plan(j, batch, _port_defaults())
    assert _sig(t._nodes) == _sig(plan.nodes)
    _compile_planned_jax(j, plan, optimizer=JSGD(lr=0.001))
    rng = np.random.RandomState(0)
    xs = [rng.randn(4 * batch, 32).astype(np.float32) for _ in range(2)]
    y = rng.randint(0, 10, size=(4 * batch,)).astype(np.int32)
    _first_epoch(j, t, xs, y, batch)


def test_keras_compile_auto_parallel_trains():
    import flexflow_tpu.keras as jk
    import flexflow_tpu_torch.keras as tk

    def model(k, **kw):
        return k.Sequential([k.Input(shape=(32,), batch_size=16),
                             k.Dense(64, activation="relu"), k.Dense(64, activation="relu"),
                             k.Dense(10)], **kw)

    t = model(tk, device="cpu")
    t.compile(optimizer=tk.SGD(learning_rate=0.01), auto_parallel=True)
    ff = t.ffmodel
    assert ff.device.type == "cpu" and ff.joint_plan is not None
    j = model(jk)
    j._build()
    plan = _jax_plan(j.ff, 16, _port_defaults())
    assert _sig(ff._nodes) == _sig(plan.nodes)
    _compile_planned_jax(j.ff, plan, optimizer=JSGD(lr=0.01))
    rng = np.random.RandomState(1)
    x = rng.randn(64, 32).astype(np.float32)
    y = rng.randint(0, 10, size=(64,)).astype(np.int32)
    _first_epoch(j.ff, ff, x, y, 16)
    hist = t.fit(x, y, batch_size=16, epochs=2)
    assert hist[-1]["loss"] < hist[0]["loss"]


@pytest.fixture(scope="module")
def tiny_params():
    js, ts = _spec_pair(**TINY)
    jparams = jp.init_params(js, jax.random.PRNGKey(0), jnp.float32)
    return js, jparams, ts, jax.tree.map(np.asarray, jparams)


def test_trainer_mesh_auto_trains(tiny_params):
    js, jparams, ts, npp = tiny_params
    logs = []
    tr = TTrainer(ts, tp.params_from_numpy(npp), TSGD(lr=0.1), mesh="auto", device="cpu",
                  auto_batch_size=4, auto_seq_len=16)
    assert [r["layout"] for r in tr.auto_report] == ["dp=1 pp=1 tp=1 mb=1"]
    assert 0 < tr.auto_report[0]["measured_s"] < float("inf")
    plain = TTrainer(ts, tp.params_from_numpy(npp), TSGD(lr=0.1), device="cpu")
    jtr = JTrainer(js, jparams, JSGD(lr=0.1))
    rng = np.random.RandomState(5)
    x = rng.randint(0, 64, (4, 16)).astype(np.int32)
    y = np.roll(x, -1, 1)
    first = tr.train_step(x, y)
    assert first == plain.train_step(x, y)
    _close(first, float(jtr.train_step(x, y)), rel=1e-5)
    assert tr.train_step(x, y) < first
    best, report = ta.optimize_train_layout(ts, tp.params_from_numpy(npp), TSGD(lr=0.1),
                                            batch_size=4, seq_len=8, device="cpu",
                                            log_fn=logs.append)
    assert best == ta.Layout(1, 1, 1) and len(report) == 1 and "chose layout" in logs[0]


def test_optimize_serving_layout_one_device(tiny_params):
    _, _, ts, npp = tiny_params
    best, report = ta.optimize_serving_layout(ts, tp.params_from_numpy(npp), batch_size=2,
                                              max_seq_len=32, cache_dtype=torch.float32,
                                              n_devices=1, device="cpu", log_fn=lambda s: None)
    assert best == ta.Layout(1, 1, 1) and len(report) == 1
    assert report[0]["measured_s"] < float("inf") and "error" not in report[0]


def test_refusals_over_more_than_one_device(tiny_params, monkeypatch):
    """The devices are the world's ranks: one in a process without a
    process group (``WORLD_SIZE`` under torchrun). Over more than one
    device without a group every layout's mesh raises ``make_mesh``'s "run
    under torchrun", so the searches find no candidate that builds and
    raise; ``Layout(1, 1, 1)`` is no mesh. Over a world of ranks:
    ``test_torch_port_search_mesh``."""
    _, _, ts, npp = tiny_params
    params = tp.params_from_numpy(npp)
    assert ta.layout_mesh(ta.Layout(1, 1, 1)) is None
    for lo in (ta.Layout(2, 1, 1), ta.Layout(1, 1, 2), ta.Layout(1, 2, 1, 2),
               ta.Layout(2, 1, 1, hybrid_ffn=True)):
        with pytest.raises(RuntimeError, match="2-rank mesh needs a process group"):
            ta.layout_mesh(lo, device="cpu")
    with pytest.raises(RuntimeError, match="no layout candidate ran.*needs a process group"):
        ta.optimize_train_layout(ts, params, TSGD(), batch_size=4, seq_len=8, n_devices=2,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="no serving layout candidate ran.*process group"):
        ta.optimize_serving_layout(ts, params, batch_size=2, max_seq_len=32, n_devices=8,
                                   device="cpu")
    assert ta.device_count("cpu") == 1
    with monkeypatch.context() as m:
        m.setenv("WORLD_SIZE", "4")
        m.setenv("RANK", "1")
        assert ta.device_count("cpu") == 4
    monkeypatch.setattr(ta, "device_count", lambda device=None: 2)
    with pytest.raises(RuntimeError, match="no layout candidate ran"):
        TTrainer(ts, params, TSGD(), mesh="auto", device="cpu")
    ff = _interplay(TFF(device="cpu"))[0]
    ff.compile(auto_parallel=True)  # the search is JAX's, pending until the first fit
    assert ff._pending_auto and ff.joint_plan is not None
    ff.compile()  # without the search, one device's graph either way
    assert ff.joint_plan is None and not ff._pending_auto


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny HF LLaMA directory (2 layers, d=64) with a character tokenizer."""
    import json

    import transformers
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_llama_search")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=4, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "tokenizer.json"))
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
    return str(d)


def test_llm_compile_auto_parallel(model_dir, monkeypatch):
    """JAX's serving search runs only over more than one device: on one,
    ``LLM.compile(auto_parallel=True)`` serves as without it. Over more, it
    searches (here without a process group no candidate builds, and it
    raises), also when ``config.auto_parallel`` asks for it. JAX serves a
    hybrid winner ``Layout(n / m, 1, m, hybrid_ffn=True)`` at T = m on its
    first m devices: at m = 1 every rank serves the whole model (one
    device's tokens); at 1 < m < n it raises, naming JAX's rule."""
    from flexflow_tpu_torch.serve import LLM

    kw = dict(max_requests_per_batch=2, max_seq_length=64)
    outs = []
    for auto in (False, True):
        llm = LLM(model_dir, data_type="float32", device="cpu")
        llm.compile(auto_parallel=auto, **kw)
        [res] = llm.generate([[1, 5, 9, 12]], max_new_tokens=6)
        outs.append(res.output_tokens)
        assert llm.auto_report is None
    assert outs[0] == outs[1] and len(outs[0]) == 6
    monkeypatch.setattr(ta, "device_count", lambda device=None: 2)
    with pytest.raises(RuntimeError, match="no serving layout candidate ran"):
        LLM(model_dir, data_type="float32", device="cpu").compile(auto_parallel=True, **kw)
    monkeypatch.setattr(tconfig, "auto_parallel", True)
    with pytest.raises(RuntimeError, match="no serving layout candidate ran"):
        LLM(model_dir, data_type="float32", device="cpu").compile(**kw)
    LLM(model_dir, data_type="float32", device="cpu").compile(auto_parallel=False, **kw)
    chosen = {}

    def winner(spec, params, *, n_devices, **_):
        lo = chosen["layout"]
        return lo, [{"layout": str(lo), "analytic_s": 0.0, "measured_s": 1.0}]

    monkeypatch.setattr(ta, "optimize_serving_layout", winner)
    chosen["layout"] = ta.Layout(2, 1, 1, hybrid_ffn=True)
    llm = LLM(model_dir, data_type="float32", device="cpu")
    llm.compile(**kw)
    assert llm.mesh is None and llm.auto_report[0]["layout"] == "dp=2 pp=1 tp=1 mb=1 ffn-tp=2"
    [res] = llm.generate([[1, 5, 9, 12]], max_new_tokens=6)
    assert res.output_tokens == outs[0]
    monkeypatch.setattr(ta, "device_count", lambda device=None: 4)
    chosen["layout"] = ta.Layout(2, 1, 2, hybrid_ffn=True)
    with pytest.raises(NotImplementedError, match="T=2.*first 2 devices"):
        LLM(model_dir, data_type="float32", device="cpu").compile(**kw)


def test_llm_auto_parallel_large_model_analytic_only(monkeypatch):
    """JAX's ``tests/test_auto_parallel.py`` case: a model whose whole
    weights in the serving dtype pass 0.35 of a device's memory ranks the
    layouts analytically (no probe) and serves JAX's choice at the
    port's machine values. The port's device is an H100 (80 GB), so the
    model is LLaMA-2-70B's width (JAX's 7B passes a v5e's 16 GB)."""
    import flexflow_tpu_torch.serve as serve_mod
    from flexflow_tpu_torch.serve import LLM

    kw = dict(arch="LlamaForCausalLM", vocab_size=32000, hidden_size=8192, num_layers=80,
              num_heads=64, num_kv_heads=8, head_dim=128, intermediate_size=28672,
              max_position_embeddings=4096, norm_eps=1e-5)
    js, big = _spec_pair(**kw)
    llm = LLM.__new__(LLM)
    llm.model_dir, llm.dtype, llm.quant_bits = "<big>", torch.bfloat16, None
    llm.spec, llm.params, llm.tokenizer, llm.rm = big, None, object(), None
    llm._ssms, llm._peft, llm.lora, llm.lora_config = [], [], None, None
    llm.device = torch.device("cpu")
    made = {}

    def stop(self, tp_, dp, pp, cp):
        made.update(tp=tp_, dp=dp, pp=pp, cp=cp)
        raise RuntimeError("stop after layout choice")

    monkeypatch.setattr(ta, "device_count", lambda device=None: 8)
    monkeypatch.setattr(LLM, "_make_mesh", stop)
    monkeypatch.setattr(serve_mod.auto_lib, "optimize_serving_layout",
                        lambda *a, **k: pytest.fail("the probe must not be measured"))
    with pytest.raises(RuntimeError, match="stop after layout choice"):
        llm.compile(max_requests_per_batch=8, max_seq_length=256, auto_parallel=True)
    [entry] = llm.auto_report
    assert entry["measured_s"] is None and "analytic-only" in entry["note"]
    jm, _ = _machines(_port_defaults())
    cands = [lo for lo in ja.enumerate_layouts(8, js, 8) if lo.data == 1]
    want = min(cands, key=lambda lo: ja.analytic_cost(lo, js, 8, 256, jm))
    assert entry["layout"] == str(want)
    _close(entry["analytic_s"], ja.analytic_cost(want, js, 8, 256, jm))
    assert made == dict(tp=want.model, dp=1, pp=want.pipe, cp=1)
