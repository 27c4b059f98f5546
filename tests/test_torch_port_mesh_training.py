"""The port's Trainer over a ``data x model`` mesh of gloo ranks on the CPU
(the spawn helpers of ``test_torch_port_mesh_serving.py``), held against
the JAX package's Trainer with and without ``make_mesh(data=2, model=2)``
at float32 (JAX's ``tests/test_training.py::test_sharded_step_matches_single``
tolerances):

- 3 SGD steps on 4 ranks (2 x 2) and on 2 (T = 2, D = 2; MQA at T = 2,
  whose K/V are projected whole): losses within 1e-5, ``full_params()``
  within 1e-4 a leaf; the replicated leaves (norms, the biases added after
  a sum) bitwise equal on every rank after every step;
- 3 Adam steps: losses only (Adam's update normalises a near-zero
  gradient's sign noise, which can move a parameter by up to lr);
- ``evaluate``, and a batch whose second data rank holds only ignored
  labels (the global mean);
- ``SingleDataLoader(mesh=)``'s rows against the matching addressable
  shard of JAX's batch;
- ``parallel/mesh``'s autograd collectives against a one-process autograd
  reference: no gradient scaled by T;
- ``FFModel(mesh=)`` trains exactly as without the mesh, and as JAX's.

The ranks import no JAX: the parent computes JAX's side while they run.
"""

import numpy as np
import pytest
import torch

from test_torch_port_mesh_serving import _join, _numpy_tree, _start

TSPEC = dict(arch="LlamaForCausalLM", vocab_size=64, hidden_size=32, num_layers=2,
             num_heads=4, num_kv_heads=4, head_dim=8, intermediate_size=64,
             max_position_embeddings=64, norm_eps=1e-6, qkv_bias=True, attn_out_bias=True,
             mlp_bias=True)
MQA_T = dict(TSPEC, num_kv_heads=1, qkv_bias=False, attn_out_bias=False, mlp_bias=False)
MIXTRAL_T = dict(MQA_T, arch="MixtralForCausalLM", num_kv_heads=2, moe=(4, 2))
REPLICATED = ("ln1_scale", "ln2_scale", "bo", "bd")  # layer leaves every model rank holds
STEPS = 3
IGNORE = -100


def _batches(vocab, n=STEPS, batch=4, seq=12, seed=0, ignore_second_half=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, vocab, size=(batch, seq)).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = IGNORE
        if ignore_second_half:  # data rank 1's rows of a D = 2 batch
            labels[batch // 2:] = IGNORE
        out.append((toks, labels))
    return out


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _tspec(kw):
    from flexflow_tpu_torch import specs as tspecs

    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = tspecs.MoESpec(num_experts=kw["moe"][0], top_k=kw["moe"][1])
    return tspecs.ModelSpec(**kw)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def _train(case, mesh):
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.training import AdamOptimizer, SGDOptimizer, Trainer

    spec = _tspec(case["spec"])
    opt = (SGDOptimizer(lr=0.05) if case["opt"] == "sgd" else AdamOptimizer(lr=1e-2))
    tr = Trainer(spec, tp.params_from_numpy(case["params"]), opt, mesh=mesh)
    losses, replicated = [], []
    for toks, labels in case["batches"]:
        losses.append(tr.train_step(toks, labels))
        layers = tr.params["layers"]
        replicated.append({n: _numpy(layers[n]) for n in REPLICATED if n in layers}
                          | {"final_norm_scale": _numpy(tr.params["final_norm_scale"])})
    out = dict(losses=losses, replicated=replicated)
    if case.get("full"):
        out["full"] = _numpy(tr.full_params())
    if case.get("evaluate"):
        out["evaluate"] = tr.evaluate(case["batches"])
    return out


def _collectives(case, mesh):
    """y = gather(copy(x) @ W[:, cols]) and u = reduce(relu(copy(x) @ W[:,
    cols]) @ V[cols, :]) on this rank's cut; the loss and every gradient
    against one process's autograd over the whole W and V."""
    from flexflow_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce_grads, copy_to_model,
                                                  gather_from_model, reduce_from_model)

    g = torch.Generator().manual_seed(0)
    x0, w0, v0 = (torch.randn(s, generator=g) for s in ((3, 8), (8, 6), (6, 8)))
    c, e = torch.randn(3, 6, generator=g), torch.randn(3, 8, generator=g)
    t, r = mesh.model, mesh.model_rank
    cols = slice(r * 6 // t, (r + 1) * 6 // t)

    def loss_of(x, w, v, cut):
        h = x @ w
        if cut:
            y = gather_from_model(copy_to_model(x, mesh) @ w, mesh, 1)
            u = reduce_from_model(torch.relu(copy_to_model(x, mesh) @ w) @ v, mesh)
        else:
            y, u = h, torch.relu(h) @ v
        return (y * c).sum() + (u * e).sum()

    x, w, v = (a.clone().requires_grad_() for a in (x0, w0[:, cols], v0[cols]))
    loss = loss_of(x, w, v, True)
    loss.backward()
    xr, wr, vr = (a.clone().requires_grad_() for a in (x0, w0, v0))
    ref = loss_of(xr, wr, vr, False)
    ref.backward()
    # a data-parallel sum of a replicated gradient: D times it
    d = x.grad.clone()
    if mesh.data > 1:
        all_reduce_grads([d], mesh, DATA_AXIS)
    return dict(err=max(float((loss - ref).abs()), float((x.grad - xr.grad).abs().max()),
                        float((w.grad - wr.grad[:, cols]).abs().max()),
                        float((v.grad - vr.grad[cols]).abs().max())),
                data_sum_err=float((d - mesh.data * xr.grad).abs().max()))


KINDS = {"train": _train, "collectives": _collectives}


def run_training_cases(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for case in cases:
        data, model = case["mesh"]
        out[case["name"]] = KINDS[case["kind"]](case, make_mesh(data=data, model=model,
                                                                device="cpu"))
    return out


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _jax_init(kw, seed):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.models import params as jp

    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = jspecs.MoESpec(num_experts=kw["moe"][0], top_k=kw["moe"][1])
    spec = jspecs.ModelSpec(**kw)
    params = jp.init_params(spec, jax.random.PRNGKey(seed), jnp.float32)
    return spec, params


def _jax_train(spec, params, batches, opt, mesh=None, evaluate=False):
    import jax

    from flexflow_tpu.training import AdamOptimizer, SGDOptimizer, Trainer

    tr = Trainer(spec, params, SGDOptimizer(lr=0.05) if opt == "sgd"
                 else AdamOptimizer(lr=1e-2), mesh=mesh)
    losses = [float(tr.train_step(t, lab)) for t, lab in batches]
    out = dict(losses=losses, params=jax.tree.map(np.asarray, tr.params))
    if evaluate:
        out["evaluate"] = tr.evaluate(batches)
    return out


def _close_trees(got, want, tol):
    for k, w in want.items():
        if isinstance(w, dict):
            _close_trees(got[k], w, tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(w), atol=tol, rtol=tol, err_msg=k)


def _replicated_bitwise(results, name):
    """Every rank's replicated leaves equal rank 0's, bit for bit, after
    every step."""
    first = results[0][name]["replicated"]
    for r in results[1:]:
        for step, (a, b) in enumerate(zip(first, r[name]["replicated"])):
            for leaf in a:
                assert np.array_equal(a[leaf], b[leaf]), (name, step, leaf)


def test_four_ranks_two_by_two_against_jax_mesh_trainer(tmp_path):
    """data=2 x model=2: SGD (losses, full_params, replicated leaves
    bitwise), Adam (losses), evaluate, and all-ignored labels on data rank
    1, against JAX's Trainer on make_mesh(data=2, model=2) and on one
    device."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    js, jparams = _jax_init(TSPEC, 0)
    npp = _numpy_tree(jparams)
    batches = _batches(TSPEC["vocab_size"])
    ignored = _batches(TSPEC["vocab_size"], seed=1, ignore_second_half=True)
    base = dict(kind="train", spec=TSPEC, params=npp, mesh=(2, 2))
    cases = [dict(base, name="sgd", opt="sgd", batches=batches, full=True, evaluate=True),
             dict(base, name="adam", opt="adam", batches=batches),
             dict(base, name="ignored", opt="sgd", batches=ignored),
             dict(kind="collectives", name="collectives", mesh=(2, 2))]
    started = _start(tmp_path, 4, cases, runner=run_training_cases)
    jmesh = j_make_mesh(data=2, model=2)
    want = {"sgd": _jax_train(js, jparams, batches, "sgd", jmesh, evaluate=True),
            "adam": _jax_train(js, jparams, batches, "adam", jmesh),
            "ignored": _jax_train(js, jparams, ignored, "sgd", jmesh)}
    one = _jax_train(js, jparams, batches, "sgd")
    res = _join(tmp_path, 4, started)
    for name, w in want.items():
        for r in res:
            np.testing.assert_allclose(r[name]["losses"], w["losses"], atol=1e-5, rtol=1e-5,
                                       err_msg=name)
    np.testing.assert_allclose(res[0]["sgd"]["losses"], one["losses"], atol=1e-5, rtol=1e-5)
    for r in res:
        _close_trees(r["sgd"]["full"], want["sgd"]["params"], 1e-4)
        got, ev = r["sgd"]["evaluate"], want["sgd"]["evaluate"]
        assert abs(got["loss"] - ev["loss"]) < 1e-5 and got["accuracy"] == ev["accuracy"]
        assert r["collectives"]["err"] < 1e-5 and r["collectives"]["data_sum_err"] < 1e-5
    for name in ("sgd", "adam", "ignored"):
        _replicated_bitwise(res, name)


def test_two_ranks_tensor_and_data_parallel(tmp_path):
    """T = 2 (LLaMA with biases; MQA: K/V projected whole on each rank,
    their gradients summed over the model ranks; Mixtral: each expert cut,
    the router's gradient through the rank's partial experts summed) and
    D = 2: SGD losses and
    full_params against JAX's one-device Trainer, Adam losses, replicated
    leaves bitwise; the collectives at T = 2."""
    js, jparams = _jax_init(TSPEC, 2)
    jq, jmqa = _jax_init(MQA_T, 3)
    jx, jmix = _jax_init(MIXTRAL_T, 4)
    npp, nmqa = _numpy_tree(jparams), _numpy_tree(jmqa)
    batches = _batches(TSPEC["vocab_size"], seed=2)
    base = dict(kind="train", batches=batches, full=True)
    cases = [dict(base, name="t2-sgd", spec=TSPEC, params=npp, opt="sgd", mesh=(1, 2)),
             dict(base, name="t2-adam", spec=TSPEC, params=npp, opt="adam", mesh=(1, 2)),
             dict(base, name="mqa-t2", spec=MQA_T, params=nmqa, opt="sgd", mesh=(1, 2)),
             dict(base, name="mixtral-t2", spec=MIXTRAL_T, params=_numpy_tree(jmix), opt="sgd",
                  mesh=(1, 2)),
             dict(base, name="d2-sgd", spec=TSPEC, params=npp, opt="sgd", mesh=(2, 1)),
             dict(base, name="d2-adam", spec=TSPEC, params=npp, opt="adam", mesh=(2, 1)),
             dict(kind="collectives", name="collectives", mesh=(1, 2))]
    started = _start(tmp_path, 2, cases, runner=run_training_cases)
    want = {"sgd": _jax_train(js, jparams, batches, "sgd"),
            "adam": _jax_train(js, jparams, batches, "adam"),
            "mqa": _jax_train(jq, jmqa, batches, "sgd"),
            "mixtral": _jax_train(jx, jmix, batches, "sgd")}
    res = _join(tmp_path, 2, started)
    for name, key in (("t2-sgd", "sgd"), ("t2-adam", "adam"), ("mqa-t2", "mqa"),
                      ("mixtral-t2", "mixtral"), ("d2-sgd", "sgd"), ("d2-adam", "adam")):
        for r in res:
            np.testing.assert_allclose(r[name]["losses"], want[key]["losses"], atol=1e-5,
                                       rtol=1e-5, err_msg=name)
            if key != "adam":
                _close_trees(r[name]["full"], want[key]["params"], 1e-4)
        _replicated_bitwise(res, name)
    for r in res:
        assert r["collectives"]["err"] < 1e-5


def test_ffmodel_mesh_trains_as_without_and_as_jax():
    """``FFModel(mesh=)`` keeps the mesh and shards nothing, as JAX's: the
    same builder calls on JAX's parameters train to the same losses with
    and without a mesh (bitwise in the port), and to JAX's; the model runs
    on the mesh's device."""
    from flexflow_tpu.ffmodel import FFModel as JFF
    from flexflow_tpu.ffmodel import SGDOptimizer as JSGD
    from flexflow_tpu.parallel import make_mesh as j_make_mesh
    from flexflow_tpu_torch.ffmodel import FFModel, SGDOptimizer
    from flexflow_tpu_torch.parallel.mesh import Mesh

    rng = np.random.RandomState(5)
    x = rng.randn(32, 16).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.int32)

    def build(ff, opt):
        t = ff.dense(ff.create_tensor((8, 16)), 32, activation="relu")
        ff.dense(t, 4)
        ff.compile(optimizer=opt)
        return ff

    hists, params = [], None
    for mesh in (None, j_make_mesh(model=2)):
        j = build(JFF(seed=0, mesh=mesh), JSGD(lr=0.1))
        params = params or _numpy_tree(j.params)
        hists.append([h["loss"] for h in j.fit(x, y, batch_size=8, epochs=2)])
    assert hists[0] == hists[1]  # JAX keeps its mesh unread
    mesh = Mesh.fake(1, 2, 0)
    got = []
    for kw in (dict(device="cpu"), dict(mesh=mesh)):
        t = build(FFModel(seed=0, **kw), SGDOptimizer(lr=0.1))
        t.load_numpy(params)
        got.append([h["loss"] for h in t.fit(x, y, batch_size=8, epochs=2)])
        assert t.device == torch.device("cpu")
    assert t._mesh is mesh and got[0] == got[1]
    np.testing.assert_allclose(got[0], hists[0], rtol=1e-5)


@pytest.mark.parametrize("data,model", [(2, 2), (2, 1), (4, 1)])
def test_data_loader_rows_equal_jax_shards(data, model):
    """``SingleDataLoader(mesh=)`` yields each data rank's rows: JAX's
    addressable shard of the batch at that rank's devices, batch by batch,
    over two epochs (the shuffle as JAX's)."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh
    from flexflow_tpu.training.dataloader import SingleDataLoader as JLoader
    from flexflow_tpu_torch.parallel.mesh import Mesh
    from flexflow_tpu_torch.training.dataloader import RankRows, SingleDataLoader

    rng = np.random.RandomState(0)
    arrays = [rng.randint(0, 50, (24, 5)).astype(np.int32), rng.randn(24).astype(np.float32)]
    jmesh = j_make_mesh(data=data, model=model)
    devices = list(jmesh.devices.reshape(-1))
    jl = JLoader(arrays, 8, seed=3, mesh=jmesh)
    mine = [SingleDataLoader(arrays, 8, seed=3, mesh=Mesh.fake(data, model, r))
            for r in range(data * model)]
    for _ in range(2):
        for jb, *rank_batches in zip(jl.epoch(), *(m.epoch() for m in mine)):
            for r, batch in enumerate(rank_batches):
                for jx, x in zip(jb, batch):
                    shard = next(s for s in jx.addressable_shards if s.device == devices[r])
                    assert isinstance(x, RankRows)
                    assert np.array_equal(np.asarray(x), np.asarray(shard.data))
    with pytest.raises(ValueError, match="does not divide"):
        next(SingleDataLoader(arrays, 6, mesh=Mesh.fake(4, 1, 0)).epoch())
