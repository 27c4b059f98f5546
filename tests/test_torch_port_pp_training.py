"""Training under pipeline stages (``parallel/pipeline.py``'s
``pipeline_forward`` and ``gpipe_step``, ``Trainer(pipeline_stages=,
num_microbatches=)``) over gloo ranks on the CPU (the spawn helpers of
``test_torch_port_mesh_serving.py``), held against the JAX package at
float32 on JAX's ``tests/test_pipeline.py`` spec (``TINY``) and bounds:

- ``pipeline_forward`` at P = 4, P = 2 x T = 2 and D = 2 x P = 2 x T = 2
  against JAX's ``pipeline_forward`` on the same meshes and against JAX's
  ``decoder.forward`` (atol 2e-4, rtol 1e-4); uneven ``[3, 1]`` stages
  against JAX's uneven ``pipeline_forward`` at P = 2 and, for an ALiBi
  spec, at P = 2 x T = 2; at P = 2 x T = 2 a tied-embedding spec (OPT:
  ``embed_tokens`` cut over the vocabulary on both end stages) trains 3
  SGD steps against JAX's one-device Trainer;
- at P = 2 the loss and every leaf's gradient (gathered over the stages)
  against ``jax.value_and_grad`` of JAX's one-device loss (atol 3e-4,
  rtol 3e-3); ``remat=False`` bitwise equal to ``remat=True``;
- the Trainer: 3 SGD steps at D = 2 x P = 2 x T = 2 and 3 Adam steps at
  P = 2 (losses within 1e-4, ``full_params()`` against JAX's one-device
  Trainer), and a tied-embedding spec with learned positions (OPT), an
  ALiBi spec (MPT) and a Mixtral spec at P = 2, forward and 3 SGD steps;
- ``stage_params_uneven`` bitwise against JAX's; the refusals, JAX's
  failure to finetune on its ``PipelineInferenceEngine`` among them.

The ranks import no JAX: the parent computes JAX's side while they run.
"""

import pickle

import numpy as np
import pytest
import torch

from test_torch_port_mesh_serving import _join, _numpy_tree, _start, _tspec

TINY = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=4, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, max_position_embeddings=64,
            norm_eps=1e-6)
OPT = dict(TINY, arch="OPTForCausalLM", pos="learned", learned_pos_offset=2, norm="layernorm",
           norm_bias=True, act="relu", qkv_bias=True, attn_out_bias=True, mlp_bias=True,
           tie_word_embeddings=True)
MPT = dict(TINY, arch="MPTForCausalLM", num_kv_heads=4, pos="alibi", norm="layernorm",
           act="gelu", tie_word_embeddings=True)
MIXTRAL = dict(TINY, arch="MixtralForCausalLM", moe=(4, 2))
FAMILIES = {"opt": OPT, "mpt": MPT, "mixtral": MIXTRAL}
LOGITS = dict(atol=2e-4, rtol=1e-4)  # JAX's test_pipeline.py bounds
GRADS = dict(atol=3e-4, rtol=3e-3)
STEPS, SGD_LR, ADAM_LR = 3, 0.05, 1e-3


def _data(b=8, t=12):
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, TINY["vocab_size"], size=(b, t)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def _forward(case, mesh, spec, params):
    from flexflow_tpu_torch.parallel.pipeline import pipeline_forward

    tokens, _ = _data()
    tokens = torch.from_numpy(tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32)[None].expand(*tokens.shape)
    return pipeline_forward(spec, params, tokens, positions, mesh=mesh,
                            num_microbatches=case.get("m"), remat=case.get("remat", True),
                            stage_sizes=case.get("sizes")).numpy()


def _grads(case, mesh, spec, params):
    """gpipe_step's loss (the last stage's, broadcast) and gradient on this
    rank's leaves, gathered (one data and model rank: nothing to sum)."""
    from flexflow_tpu_torch.parallel.pipeline import gpipe_step
    from flexflow_tpu_torch.parallel.sharding import gather_params, shard_params, tree_shard
    from flexflow_tpu_torch.training.losses import LOSS_PARTS
    from flexflow_tpu_torch.training.optimizers import tree_map

    tokens, labels = (torch.from_numpy(a) for a in _data())
    shard = tree_shard(spec, params, mesh)
    leaves = tree_map(lambda a: a.clone().requires_grad_(), shard_params(spec, params, mesh))
    stats = gpipe_step(spec, leaves, shard, tokens, labels,
                       LOSS_PARTS["sparse_categorical_crossentropy"], num_microbatches=case["m"],
                       remat=case.get("remat", True))
    if stats is None:
        stats = torch.empty(2, dtype=torch.float64)
    total, count = mesh.broadcast_from_stage(stats, mesh.pipe - 1).tolist()
    return dict(loss=total / count, grads=_np(gather_params(
        spec, tree_map(lambda p: p.grad, leaves), mesh)))


def _train(case, mesh, spec, params):
    from flexflow_tpu_torch.training import AdamOptimizer, SGDOptimizer, Trainer

    opt = SGDOptimizer(lr=SGD_LR) if case["opt"] == "sgd" else AdamOptimizer(lr=ADAM_LR)
    tr = Trainer(spec, params, opt, mesh=mesh, pipeline_stages=mesh.pipe,
                 num_microbatches=case["m"])
    tokens, labels = _data()
    losses = [tr.train_step(tokens, labels) for _ in range(STEPS)]
    return dict(losses=losses, full=_np(tr.full_params()),
                evaluate=tr.evaluate([(tokens, labels)]), accuracy=tr.metrics.accuracy)


def _run(cases_file, model_dir):
    """Each case of the pickle ``cases_file`` (read here: a large argument
    to a spawned rank would hold up the next rank's start)."""
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    with open(cases_file, "rb") as f:
        cases = pickle.load(f)
    out, meshes = {}, {}
    for case in cases:
        spec = _tspec(case["spec"])
        key = tuple(sorted(case["mesh"].items()))
        if key not in meshes:  # each mesh's groups made once
            meshes[key] = make_mesh(**case["mesh"], device="cpu")
        mesh = meshes[key]
        run = {"forward": _forward, "grads": _grads, "train": _train}[case["kind"]]
        out[case["name"]] = run(case, mesh, spec, tp.params_from_numpy(case["params"]))
    return out


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _jax_model(kw, seed=0):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.models import params as jp

    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = jspecs.MoESpec(num_experts=kw["moe"][0], top_k=kw["moe"][1])
    spec = jspecs.ModelSpec(**kw)
    params = jp.init_params(spec, jax.random.PRNGKey(seed), jnp.float32)
    return spec, params, _numpy_tree(params)


def _jax_logits(spec, params, mesh=None, m=None, sizes=None):
    """JAX's decoder.forward (no mesh) or pipeline_forward on ``mesh``."""
    import jax.numpy as jnp

    from flexflow_tpu.models import decoder
    from flexflow_tpu.parallel.pipeline import (pipeline_forward, stage_params,
                                                stage_params_uneven)

    tokens, _ = _data()
    positions = np.broadcast_to(np.arange(tokens.shape[1], dtype=np.int32), tokens.shape)
    tokens, positions = jnp.asarray(tokens), jnp.asarray(positions)
    if mesh is None:
        return np.asarray(decoder.forward(spec, params, tokens, positions)[0])
    p = mesh.shape["pipe"]
    layers = (stage_params(params["layers"], p) if sizes is None
              else stage_params_uneven(params["layers"], sizes))
    return np.asarray(pipeline_forward(spec, {**params, "layers": layers}, tokens, positions,
                                       mesh=mesh, num_microbatches=m, stage_sizes=sizes))


def _jax_train(spec, params, opt):
    from flexflow_tpu.training import AdamOptimizer, SGDOptimizer, Trainer

    tr = Trainer(spec, params, SGDOptimizer(lr=SGD_LR) if opt == "sgd"
                 else AdamOptimizer(lr=ADAM_LR))
    tokens, labels = _data()
    losses = [tr.train_step(tokens, labels) for _ in range(STEPS)]
    return dict(losses=losses, full=_numpy_tree(tr.params),
                evaluate=tr.evaluate([(tokens, labels)]))


def _spawn(tmp, world, cases):
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    return _start(tmp, world, str(tmp / "cases.pkl"), runner=_run)


def _jmesh(**degrees):
    from flexflow_tpu.parallel import make_mesh

    return make_mesh(**degrees)


def _same_on_ranks(ranks, name):
    """Every rank's result of ``name`` (bitwise equal); rank 0's."""
    first = ranks[0][name]
    for r in ranks[1:]:
        np.testing.assert_equal(r[name], first, err_msg=name)
    return first


def _close_trees(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _close_trees(got[k], w, **tol)
        else:
            np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


def _check_train(got, want, params_tol):
    np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4, rtol=1e-4)
    _close_trees(got["full"], want["full"], **params_tol)
    np.testing.assert_allclose(got["evaluate"]["loss"], want["evaluate"]["loss"], rtol=1e-5)
    assert got["evaluate"]["accuracy"] == want["evaluate"]["accuracy"]


def test_stage_params_uneven_bitwise_jax():
    """The padded ``[P, kmax, ...]`` form bitwise JAX's, each stage's real
    layers, and ``stage_range`` over uneven sizes."""
    from flexflow_tpu.parallel.pipeline import stage_params as j_stage
    from flexflow_tpu.parallel.pipeline import stage_params_uneven as j_uneven
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.pipeline import (stage_params, stage_params_uneven,
                                                      stage_range)

    _, jparams, npp = _jax_model(TINY)
    layers = tp.params_from_numpy(npp)["layers"]
    for sizes in ([3, 1],):
        want = _numpy_tree(j_uneven(jparams["layers"], sizes))
        got = stage_params_uneven(layers, sizes)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=f"{sizes} {k}")
        for s, n in enumerate(sizes):
            lo = sum(sizes[:s])
            assert stage_range(4, len(sizes), s, sizes) == (lo, lo + n)
            mine = stage_params_uneven(layers, sizes, s)
            for k in want:
                np.testing.assert_array_equal(mine[k].numpy(), want[k][s, :n])
    even = _numpy_tree(j_stage(jparams["layers"], 2))
    for k, w in even.items():
        np.testing.assert_array_equal(stage_params(layers, 2)[k].numpy(), w)
    for bad in ([3, 0], [2, 1], [1, 1, 2]):
        with pytest.raises(ValueError, match="do not cut 4 layers"):
            stage_range(4, 2, 0, bad)


def test_forward_and_tied_trainer_over_four_ranks(tmp_path):
    """P = 4, P = 2 x T = 2, and an ALiBi spec (heads and slopes cut over
    ``model``) with ``[3, 1]`` stages at P = 2 x T = 2; at P = 2 x T = 2 the
    tied OPT spec's 3 SGD steps against JAX's one-device Trainer (the tied
    ``embed_tokens``' vocabulary cut summed over the end stages' pair)."""
    js, jparams, npp = _jax_model(TINY)
    ms, mparams, mpp = _jax_model(MPT)
    os_, oparams, opp = _jax_model(OPT, seed=1)
    cases = [dict(kind="forward", name="p4", spec=TINY, params=npp, mesh=dict(pipe=4), m=4),
             dict(kind="forward", name="p2t2", spec=TINY, params=npp,
                  mesh=dict(pipe=2, model=2), m=2),
             dict(kind="forward", name="alibi-31", spec=MPT, params=mpp,
                  mesh=dict(pipe=2, model=2), m=2, sizes=[3, 1]),
             dict(kind="train", name="opt-sgd", spec=OPT, params=opp,
                  mesh=dict(pipe=2, model=2), m=2, opt="sgd")]
    started = _spawn(tmp_path, 4, cases)
    one = _jax_logits(js, jparams)
    want = {"p4": _jax_logits(js, jparams, _jmesh(pipe=4), 4),
            "p2t2": _jax_logits(js, jparams, _jmesh(pipe=2, model=2), 2),
            "alibi-31": _jax_logits(ms, mparams, _jmesh(pipe=2, model=2), 2, [3, 1])}
    mone = _jax_logits(ms, mparams)
    tied = _jax_train(os_, oparams, "sgd")
    ranks = _join(tmp_path, 4, started)
    for name, w in want.items():
        got = _same_on_ranks(ranks, name)
        assert got.shape == (8, 12, 96) and got.dtype == np.float32
        np.testing.assert_allclose(got, w, err_msg=name, **LOGITS)
        np.testing.assert_allclose(got, mone if name.startswith("alibi") else one,
                                   err_msg=name, **LOGITS)
    for r in ranks:
        assert r["opt-sgd"]["losses"] == ranks[0]["opt-sgd"]["losses"]
        _check_train(r["opt-sgd"], tied, dict(atol=1e-4, rtol=1e-4))


def test_forward_and_trainer_over_eight_ranks(tmp_path):
    """D = 2 x P = 2 x T = 2: ``pipeline_forward`` against JAX's on that mesh
    and one device, and JAX's ``Trainer(mesh=make_mesh(data=2, pipe=2,
    model=2), pipeline_stages=2, num_microbatches=2)`` call: 3 SGD steps
    within 1e-4 of JAX's one-device Trainer on every rank, the gathered
    parameters too, and ``evaluate``."""
    js, jparams, npp = _jax_model(TINY)
    mesh = dict(data=2, pipe=2, model=2)
    cases = [dict(kind="forward", name="fwd", spec=TINY, params=npp, mesh=mesh, m=2),
             dict(kind="train", name="sgd", spec=TINY, params=npp, mesh=mesh, m=2, opt="sgd")]
    started = _spawn(tmp_path, 8, cases)
    want_pp = _jax_logits(js, jparams, _jmesh(**mesh), 2)
    one = _jax_logits(js, jparams)
    want = _jax_train(js, jparams, "sgd")
    ranks = _join(tmp_path, 8, started)
    got = _same_on_ranks(ranks, "fwd")
    np.testing.assert_allclose(got, want_pp, **LOGITS)
    np.testing.assert_allclose(got, one, **LOGITS)
    for r in ranks:
        assert r["sgd"]["losses"] == ranks[0]["sgd"]["losses"]
        assert r["sgd"]["accuracy"] == ranks[0]["sgd"]["accuracy"]
        _check_train(r["sgd"], want, dict(atol=1e-4, rtol=1e-4))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """P = 2 over 2 ranks: the forward (even, remat off, [3, 1]), the
    gradients (remat on and off), Adam, and each family's forward and SGD
    steps; with JAX's side of each."""
    tmp = tmp_path_factory.mktemp("pp2")
    js, jparams, npp = _jax_model(TINY)
    p2 = dict(pipe=2)
    base = dict(spec=TINY, params=npp, mesh=p2, m=2)
    cases = [dict(base, kind="forward", name="fwd"),
             dict(base, kind="forward", name="fwd-noremat", remat=False),
             dict(base, kind="forward", name="fwd-31", sizes=[3, 1]),
             dict(base, kind="grads", name="grads"),
             dict(base, kind="grads", name="grads-noremat", remat=False),
             dict(base, kind="train", name="adam", opt="adam")]
    fams = {name: _jax_model(kw, seed=1) for name, kw in FAMILIES.items()}
    for name, (_, _, fpp) in fams.items():
        fam = dict(spec=FAMILIES[name], params=fpp, mesh=p2, m=2)
        cases += [dict(fam, kind="forward", name=f"{name}-fwd"),
                  dict(fam, kind="train", name=f"{name}-sgd", opt="sgd")]
    started = _spawn(tmp, 2, cases)
    want = dict(one=_jax_logits(js, jparams), fwd=_jax_logits(js, jparams, _jmesh(pipe=2), 2),
                fwd31=_jax_logits(js, jparams, _jmesh(pipe=2), 2, [3, 1]),
                grads=_jax_grads(js, jparams), adam=_jax_train(js, jparams, "adam"))
    for name, (fs, fparams, _) in fams.items():
        want[name] = dict(one=_jax_logits(fs, fparams), sgd=_jax_train(fs, fparams, "sgd"))
    return _join(tmp, 2, started), want


def _jax_grads(spec, params):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.models import decoder
    from flexflow_tpu.training.losses import sparse_categorical_crossentropy

    tokens, labels = _data()
    positions = jnp.broadcast_to(jnp.arange(tokens.shape[1], dtype=jnp.int32), tokens.shape)

    def loss(p):
        logits, _ = decoder.forward(spec, p, jnp.asarray(tokens), positions)
        return sparse_categorical_crossentropy(logits, jnp.asarray(labels))

    value, grads = jax.value_and_grad(loss)(params)
    return dict(loss=float(value), grads=_numpy_tree(grads))


def test_two_ranks_forward_gradients_and_remat(two_ranks):
    """P = 2: logits against JAX's pipeline_forward and one device (even
    and ``[3, 1]`` stages); the loss and every leaf's gathered gradient
    against JAX's one-device ``value_and_grad``; ``remat=False`` bitwise
    ``remat=True``, logits and gradients."""
    ranks, want = two_ranks
    got = _same_on_ranks(ranks, "fwd")
    np.testing.assert_allclose(got, want["fwd"], **LOGITS)
    np.testing.assert_allclose(got, want["one"], **LOGITS)
    np.testing.assert_array_equal(_same_on_ranks(ranks, "fwd-noremat"), got)
    uneven = _same_on_ranks(ranks, "fwd-31")
    np.testing.assert_allclose(uneven, want["fwd31"], **LOGITS)
    np.testing.assert_allclose(uneven, want["one"], **LOGITS)
    for r in ranks:
        assert r["grads"]["loss"] == ranks[0]["grads"]["loss"]
        np.testing.assert_allclose(r["grads"]["loss"], want["grads"]["loss"], rtol=1e-5)
        _close_trees(r["grads"]["grads"], want["grads"]["grads"], **GRADS)
        assert r["grads-noremat"]["loss"] == r["grads"]["loss"]
        _close_trees(r["grads-noremat"]["grads"], r["grads"]["grads"], atol=0, rtol=0)


def test_two_ranks_adam_trainer(two_ranks):
    """P = 2, 3 Adam steps: losses within 1e-4 of JAX's one-device Trainer
    and the gathered parameters within a tenth of the learning rate (an
    Adam step moves a parameter by about lr, whatever its gradient's
    size)."""
    ranks, want = two_ranks
    for r in ranks:
        assert r["adam"]["losses"] == ranks[0]["adam"]["losses"]
        _check_train(r["adam"], want["adam"], dict(atol=ADAM_LR / 10, rtol=0))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_two_ranks_families(two_ranks, family):
    """P = 2: a tied-embedding spec with learned positions (OPT: the
    embeddings on both end stages, ``embed_pos`` on stage 0 only, the
    tied gradient summed over the pair), an ALiBi spec (MPT) and a
    Mixtral spec: logits against one device, 3 SGD steps against JAX's
    one-device Trainer."""
    ranks, want = two_ranks
    np.testing.assert_allclose(_same_on_ranks(ranks, f"{family}-fwd"), want[family]["one"],
                               **LOGITS)
    for r in ranks:
        _check_train(r[f"{family}-sgd"], want[family]["sgd"], dict(atol=1e-4, rtol=1e-4))


def test_refusals():
    """JAX's texts for ``b % m`` and uneven stages on a post-norm spec; the
    Trainer's stage count against its mesh; finetuning on a pipeline engine,
    which JAX's ``FinetuneSession`` fails at too."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.peft import LoraConfig as JLora
    from flexflow_tpu.peft import init_lora_params
    from flexflow_tpu.peft.finetune import FinetuneSession as JSession
    from flexflow_tpu.serving.pp_engine import PipelineInferenceEngine as JPipe
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.mesh import Mesh
    from flexflow_tpu_torch.parallel.pipeline import pipeline_forward
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer

    spec = _tspec(TINY)
    params = tp.init_params(spec, 0)
    staged = Mesh.fake(1, 1, 0, pipe=2)
    tokens, labels = _data()
    positions = torch.arange(12, dtype=torch.int32)[None].expand(8, 12)
    with pytest.raises(ValueError, match="batch 8 not divisible by microbatches 3"):
        pipeline_forward(spec, params, torch.from_numpy(tokens), positions, mesh=staged,
                         num_microbatches=3)
    with pytest.raises(ValueError, match="batch 8 not divisible by microbatches 3"):
        Trainer(spec, params, SGDOptimizer(), mesh=staged, num_microbatches=3).train_step(
            tokens, labels)
    post = _tspec(dict(OPT, pre_norm=False, final_norm=False))
    with pytest.raises(ValueError, match="uneven stages need pre-norm residual passthrough"):
        pipeline_forward(post, tp.init_params(post, 0), torch.from_numpy(tokens), positions,
                         mesh=staged, stage_sizes=[3, 1])
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh .* got no mesh"):
        Trainer(spec, params, SGDOptimizer(), pipeline_stages=2, device="cpu")
    with pytest.raises(ValueError, match="got pipe=2"):
        Trainer(spec, params, SGDOptimizer(), pipeline_stages=4, mesh=staged)
    tr = Trainer(spec, params, SGDOptimizer(), mesh=staged)  # a pipe mesh alone: P stages
    assert (tr.stages, tr.num_microbatches) == (2, 2)
    assert tr.params["layers"]["wq"].shape[0] == 2  # stage 0's two layers
    assert sorted(tr.params) == ["embed_tokens", "layers"]

    class Staged:  # what FinetuneSession reads of an engine under stages
        mesh, lora = staged, None

    with pytest.raises(NotImplementedError, match="JAX's FinetuneSession cannot run on its "
                                                  "PipelineInferenceEngine"):
        FinetuneSession(spec, LoraConfig(), 0, [])._build(Staged())
    js, jparams, _ = _jax_model(TINY)
    cfg = JLora(rank=4, alpha=8.0, target_modules=("wq", "wv"))
    engine = JPipe(js, jparams, mesh=_jmesh(pipe=2), max_requests_per_batch=2, max_seq_len=32,
                   cache_dtype=jnp.float32, lora=init_lora_params(js, cfg, 2,
                                                                   jax.random.PRNGKey(1)),
                   lora_config=cfg)
    with pytest.raises(ValueError, match="leading axis sizes"):
        JSession(js, cfg, 0, [(tokens[:2], labels[:2])]).tick(engine)
