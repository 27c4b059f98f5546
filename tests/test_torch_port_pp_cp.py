"""Pipeline stages under a context degree (``make_mesh(pipe=2, seq=2)``,
P = 2 x C = 2) over four gloo ranks on the CPU (the spawn helpers of
``test_torch_port_mesh_serving.py``), held against the JAX package at
float32 (the ranks import no JAX: the parent computes JAX's side while
they run). JAX's pipeline engines and GPipe loop map over ``("pipe",
"model")`` only, so every seq coordinate runs a whole copy of the stages,
each stage holding its whole cache; the port does the same:

- rank r sits at JAX's ``np.arange(n).reshape(data, pipe, model, seq)``
  coordinate, and its pipe group and stage hops stay within its seq
  coordinate;
- ``PipelineInferenceEngine`` (the overlapped horizon, its return hop
  included) gives the tokens of JAX's ``PipelineInferenceEngine(mesh=
  make_mesh(pipe=2, seq=2))`` and JAX's one-device engine, each rank
  holding its stage's layers and the stage's whole cache;
- ``PipelineSpecEngine`` (``test_torch_port_pp_spec.py``'s pair) gives
  JAX's tokens on the same mesh, every rank's draft trees bitwise equal;
- ``Trainer(pipeline_stages=2)`` against JAX's on ``make_mesh(pipe=2,
  seq=2)`` (``test_torch_port_pp_training.py``'s tolerances), the two seq
  ranks of each stage bitwise equal;
- ``LLM.compile(pipeline_parallelism_degree=2, context_parallel_degree=2)``
  and ``incr_decoding --pp 2 --cp 2`` against JAX's ``LLM`` and CLI under
  the same degrees.
"""

import json

import numpy as np

from test_torch_port_cp_layouts import HF_TINY, _hf_dir
from test_torch_port_mesh_cli import _texts
from test_torch_port_mesh_serving import (_cli_text, _jax_params, _join, _prompts, _start,
                                          unfused_jax)  # noqa: F401 (a fixture)
from test_torch_port_pp_serving import HORIZON
from test_torch_port_pp_serving import SPEC as PP_SPEC
from test_torch_port_pp_serving import _engine as _pp_engine
from test_torch_port_pp_serving import _jax_run
from test_torch_port_pp_serving import _serve as _pp_serve
from test_torch_port_pp_spec import _jax_pair, _jax_spec
from test_torch_port_pp_spec import _prompts as _spec_prompts
from test_torch_port_pp_spec import _serve as _spec_serve
from test_torch_port_pp_training import STEPS, SGD_LR, TINY, _check_train, _data, _jax_model
from test_torch_port_pp_training import _train as _pp_train

P2C2 = dict(pipe=2, seq=2)
LLM_PROMPTS = [[1, 5, 9, 12] * 15, [3, 4]]  # 60 + 6 tokens: past position 64


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _groups(mesh):
    """The global ranks of this rank's pipe group and stage hop groups."""
    import torch.distributed as dist

    def ranks(g):
        return None if g is None else sorted(dist.get_process_group_ranks(g))

    return dict(coord=(mesh.data_rank, mesh.pipe_rank, mesh.model_rank, mesh.seq_rank),
                pipe=ranks(mesh.pipe_group), next=ranks(mesh.next_group),
                prev=ranks(mesh.prev_group), ret=ranks(mesh.return_group),
                seq=ranks(mesh.seq_group), model=ranks(mesh.model_group))


def _residency(case, mesh):
    """What this rank holds: each layer leaf's depth, the cache's shape, the
    top leaves and the stage's global layers."""
    eng = _pp_engine(case, mesh)
    return dict(layers={k: v.shape[0] for k, v in eng.params["layers"].items()},
                cache=tuple(eng.cache.k.shape), top=sorted(k for k in eng.params if k != "layers"),
                stage=eng.layers)


def _train(case, mesh):
    from flexflow_tpu_torch.models import params as tp
    from test_torch_port_mesh_serving import _tspec

    spec = _tspec(case["spec"])
    return _pp_train(case, mesh, spec, tp.params_from_numpy(case["params"]))


def _llm(case, model_dir):
    """``LLM.compile(pipeline_parallelism_degree=2, context_parallel_degree=2)``
    and ``incr_decoding --pp 2 --cp 2``."""
    from flexflow_tpu_torch.inference import incr_decoding
    from flexflow_tpu_torch.serve import LLM

    llm = LLM(model_dir, data_type="float32", device="cpu")
    llm.compile(max_requests_per_batch=2, max_seq_length=128, pipeline_parallelism_degree=2,
                context_parallel_degree=2)
    eng = llm.rm.engine
    out = dict(tokens=[r.output_tokens for r in llm.generate(LLM_PROMPTS, max_new_tokens=6)],
               engine=type(eng).__name__, cache=tuple(eng.cache.k.shape),
               coord=(llm.mesh.pipe_rank, llm.mesh.seq_rank))
    llm.rm.close()
    out["cli"] = _cli_text(incr_decoding, case["argv"] + ["--device", "cpu", "--pp", "2",
                                                          "--cp", "2"])
    return out


def run_pp_cp_cases(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(**P2C2, device="cpu")
    mesh.warm("cpu")  # every group once, the hop and ring groups in one global order
    out = {"groups": _groups(mesh)}
    for case in cases:
        if case["kind"] == "llm":
            out[case["name"]] = _llm(case, model_dir)
            continue
        run = {"serve": _pp_serve, "residency": _residency, "spec": _spec_serve,
               "train": _train}[case["kind"]]
        out[case["name"]] = run(case, mesh)
    return out


# ---------------------------------------------------------------------------
# JAX's side
# ---------------------------------------------------------------------------


def _jax_train(spec, params, mesh):
    """JAX's ``Trainer(mesh=, pipeline_stages=2, num_microbatches=2)``: 3 SGD
    steps on ``test_torch_port_pp_training``'s batch."""
    from flexflow_tpu.training import SGDOptimizer, Trainer
    from test_torch_port_mesh_serving import _numpy_tree

    tr = Trainer(spec, params, SGDOptimizer(lr=SGD_LR), mesh=mesh, pipeline_stages=2,
                 num_microbatches=2)
    tokens, labels = _data()
    losses = [float(tr.train_step(tokens, labels)) for _ in range(STEPS)]
    full = _numpy_tree(tr.params)  # its layers stage-stacked [P, L / P, ...]
    full["layers"] = {k: v.reshape((-1,) + v.shape[2:]) for k, v in full["layers"].items()}
    return dict(losses=losses, full=full, evaluate=tr.evaluate([(tokens, labels)]))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_rank_coordinates_equal_jax_grid():
    """Every rank of ``pipe=2 x seq=2`` and of ``pipe=2 x model=2 x seq=2``
    sits at JAX's device grid, and its pipe group and stage neighbours
    share its data, model and seq coordinates."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh
    from flexflow_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh

    for degrees in (P2C2, dict(pipe=2, model=2, seq=2)):
        jm = j_make_mesh(**degrees)
        ids = np.vectorize(lambda dv: dv.id)(jm.devices)  # [data, pipe, model, seq]
        for r in range(ids.size):
            m = Mesh.fake(1, degrees.get("model", 1), r, pipe=2, seq=2)
            assert ids[m.data_rank, m.pipe_rank, m.model_rank, m.seq_rank] == r, (degrees, r)
            group = m.group_ranks(PIPE_AXIS)
            assert group == [m.stage_rank(s) for s in range(2)]
            for q in group:
                other = Mesh.fake(1, degrees.get("model", 1), q, pipe=2, seq=2)
                assert (other.data_rank, other.model_rank, other.seq_rank) == (
                    m.data_rank, m.model_rank, m.seq_rank)


def test_pipe2_by_seq2_engines_trainer_llm_and_cli_equal_jax(tmp_path, unfused_jax):
    """P = 2 x C = 2 over 4 gloo ranks: the hop groups per seq coordinate;
    ``PipelineInferenceEngine`` (overlapped horizon) against JAX's on
    ``make_mesh(pipe=2, seq=2)`` and at one device, each rank its stage's
    layers and whole cache; ``PipelineSpecEngine`` against JAX's on the same
    mesh; ``Trainer(pipeline_stages=2)`` against JAX's on that mesh;
    ``LLM.compile`` and ``incr_decoding --pp 2 --cp 2`` against JAX's under
    the same degrees (rank 0 prints, the others nothing)."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh
    from flexflow_tpu.serve import LLM as JLLM
    from flexflow_tpu.serving import GenerationConfig as JGen
    from inference import incr_decoding as j_cli

    js, jparams, npp = _jax_params(PP_SPEC, 0)
    (ls, ds, jllm, jssm, _), pair = _jax_pair()
    ts, jtrain_p, ntrain = _jax_model(TINY)
    model_dir = _hf_dir(tmp_path / "model", HF_TINY)
    prompts_file = tmp_path / "prompts.json"
    prompts_file.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", str(model_dir), "-prompt", str(prompts_file), "--max-new-tokens", "8",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2", "--full-precision"]
    prompts = _prompts()
    cases = [dict(kind="serve", name="pp", spec=PP_SPEC, params=npp, prompts=prompts,
                  max_new=16, rm=HORIZON),
             dict(kind="residency", name="resident", spec=PP_SPEC, params=npp),
             dict(pair, kind="spec", name="spec", prompts=_spec_prompts(), max_new=12),
             dict(kind="train", name="train", spec=TINY, params=ntrain, m=2, opt="sgd"),
             dict(kind="llm", name="llm", argv=argv)]
    started = _start(tmp_path, 4, cases, str(model_dir), runner=run_pp_cp_cases)
    jmesh = j_make_mesh(**P2C2)
    want = _jax_run(js, jparams, cases[0], mesh=jmesh)
    assert want == _jax_run(js, jparams, cases[0])
    want_spec = _jax_spec(ls, ds, jllm, jssm, _spec_prompts(), 12, mesh=jmesh)
    assert want_spec == _jax_spec(ls, ds, jllm, jssm, _spec_prompts(), 12)
    want_train = _jax_train(ts, jtrain_p, jmesh)
    jl = JLLM(str(model_dir), data_type="float32")
    jl.compile(max_requests_per_batch=2, max_seq_length=128, pipeline_parallelism_degree=2,
               context_parallel_degree=2)
    want_llm = [r.output_tokens for r in jl.rm.generate(LLM_PROMPTS, JGen(max_new_tokens=6))]
    jdegrees = ["-pipeline-parallelism-degree", "2", "-context-parallel-degree", "2"]
    want_cli = _cli_text(j_cli, argv + jdegrees)
    res = _join(tmp_path, 4, started)

    for r, got in enumerate(res):
        g = got["groups"]
        d, p, m, c = g["coord"]
        assert (d, p, m, c) == (0, r // 2, 0, r % 2)  # seq fastest, then pipe
        assert g["pipe"] == [c, 2 + c] and g["seq"] == [2 * p, 2 * p + 1]
        assert g["ret"] == [c, 2 + c] and g["model"] == [r]
        assert (g["next"] if p == 0 else g["prev"]) == [c, 2 + c]
        assert (g["prev"] if p == 0 else g["next"]) is None
        assert got["pp"] == want, r
        held = got["resident"]
        assert held["stage"] == ((0, 2) if p == 0 else (2, 4))
        assert set(held["layers"].values()) == {2}
        assert held["cache"] == (2, 4, 8, 128, 8)  # the stage's layers, every slot and position
        assert ("embed_tokens" in held["top"]) == (p == 0) and ("lm_head" in held["top"]) == (
            p == 1)
        assert got["spec"]["tokens"] == want_spec
        assert got["spec"]["trees"] == res[0]["spec"]["trees"]
        _check_train(got["train"], want_train, dict(atol=1e-4, rtol=1e-4))
        assert got["llm"]["tokens"] == want_llm
        assert got["llm"]["engine"] == "PipelineInferenceEngine"
        assert got["llm"]["cache"][0] == 1 and got["llm"]["cache"][3] == 128  # whole cache
        assert (got["llm"]["cli"] != "") == (r == 0)
    assert res[0]["resident"] == res[1]["resident"] and res[2]["resident"] == res[3]["resident"]
    for a, b in ((0, 1), (2, 3)):  # the seq ranks of one stage: the same step, bit for bit
        assert res[a]["train"]["losses"] == res[b]["train"]["losses"]
        _same_leaves(res[a]["train"]["full"], res[b]["train"]["full"])
    assert _texts(res[0]["llm"]["cli"]) == _texts(want_cli)
    assert len(_texts(want_cli)) == 2


def _same_leaves(a, b):
    for k, v in a.items():
        if isinstance(v, dict):
            _same_leaves(v, b[k])
        else:
            assert np.array_equal(v, b[k]), k
