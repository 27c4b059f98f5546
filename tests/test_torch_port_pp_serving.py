"""Pipeline-parallel serving of the port (``serving/pp_engine.py``) over gloo
ranks on the CPU (the helpers of ``test_torch_port_mesh_serving.py``), held
against the JAX package at float32 on JAX's ``tests/test_pp_serving.py``
spec (4 layers, hidden 64, f32 cache):

- P = 2, P = 4 and P = 2 x T = 2 give JAX's one-device ``InferenceEngine``
  tokens; P = 2 and P = 2 x T = 2 also give JAX's own
  ``PipelineInferenceEngine``'s on the virtual CPU devices;
- under a stage, the layouts JAX's one-device engine is held to: GQA (8
  heads on 4 KV heads) and MQA at P = 2 x T = 2, a Mixtral (MoE) spec and
  JAX's INT8 and INT4 carriers at P = 2;
- ALiBi, the stepwise horizon (M < P), the overlapped one (M = P, and M = 2P
  with tokens banked), chunked prefill with a partial last chunk and a final
  window past the cache end, and LoRA at T = 1 through a non-pipelined
  manager with a horizon (the adapter ids JAX's pipeline engine drops);
- a sampled overlapped horizon gives the port's one-device sampled tokens
  bit for bit;
- each rank holds only its stage's layers and cache, and the top leaves
  its stage runs;
- ``stage_params``, the mesh coordinates and the refusals.

The ranks import no JAX: the parent computes JAX's tokens while they run.
``LLM.compile`` and ``incr_decoding --pp`` are in ``test_torch_port_pp_cli.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_port_mesh_serving import (MIXTRAL, MQA, _all_ranks, _jax_params, _join, _prompts,
                                          _start, _tspec)

SPEC = dict(arch="LlamaForCausalLM", vocab_size=256, hidden_size=64, num_layers=4,
            num_heads=8, num_kv_heads=8, head_dim=8, intermediate_size=128,
            max_position_embeddings=256, norm_eps=1e-6)
ALIBI = dict(SPEC, pos="alibi")
GQA = dict(SPEC, num_kv_heads=4)
ENGINE = dict(max_requests_per_batch=4, max_seq_len=128)
HORIZON = dict(decode_horizon=8, pipelined=True)
CHUNK_PROMPTS = [list(range(2, 30)), [7, 8, 9], list(range(40, 60)), [5]]  # 28 = 3 x 8 + 4
END_PROMPT = list(range(2, 52))  # 50 tokens: the third 24-token window crosses S = 64
LORA_CFG = dict(rank=4, alpha=8.0, target_modules=("wq", "wv", "wd"))
LORA_PROMPTS, LORA_IDS = [[5, 6, 7], [8, 9, 10], [11, 12], [3, 4]], [0, 1, -1, 0]
SAMPLED = dict(temperature=[0.8, 1.2, 0.7, 1.0], top_p=[0.95, 1.0, 0.9, 1.0], top_k=[0, 8, 0, 16])
SAMPLED_PROMPTS = [[5, 6, 7], [8, 9], [10, 11, 12, 13], [3]]


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _sampled_scfg():
    from flexflow_tpu_torch.ops.sampling import SamplingConfig

    return SamplingConfig(*(np.asarray(SAMPLED[k], dt) for k, dt in
                            (("temperature", np.float32), ("top_p", np.float32),
                             ("top_k", np.int32))))


def _engine(case, mesh):
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.pp_engine import PipelineInferenceEngine

    spec = _tspec(case["spec"])
    params = tp.params_from_numpy(case["params"], spec=spec, mesh=mesh)
    kw = dict(ENGINE, **case.get("engine", {}), cache_dtype=torch.float32)
    if "lora" in case:
        kw.update(lora=tp.lora_from_numpy(case["lora"]), lora_config=LoraConfig(**LORA_CFG))
    if mesh is None:
        kw.pop("num_microbatches", None)
        return InferenceEngine(spec, params, device="cpu", **kw)
    return PipelineInferenceEngine(spec, params, mesh=mesh, **kw)


def _serve(case, mesh):
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager

    eng = _engine(case, mesh)
    rm = RequestManager(eng, **case.get("rm", {}))
    try:
        if "adapters" in case:  # one request at a time, each through its adapter
            return [rm.generate([p], GenerationConfig(max_new_tokens=case["max_new"],
                                                      adapter_id=a))[0].output_tokens
                    for p, a in zip(case["prompts"], case["adapters"])]
        return [r.output_tokens for r in rm.generate(
            case["prompts"], GenerationConfig(max_new_tokens=case["max_new"]))]
    finally:
        rm.close()


def _sampled_horizon(case, mesh):
    """One sampled batched prefill, then one sampled 5-step horizon (the
    overlapped one at M = P), from the same keys: [first tokens, horizon]."""
    eng = _engine(case, mesh)
    scfg = _sampled_scfg()
    first = eng.fetch(eng.prefill_batch_to_slots_async(SAMPLED_PROMPTS, [0, 1, 2, 3], 11, scfg))
    lens = np.array([len(p) for p in SAMPLED_PROMPTS], np.int32)
    out = eng.fetch(eng.decode_horizon_async(lens, first.astype(np.int32), 12, scfg, 5))
    return [first.tolist(), out.tolist()]


def _residency(case, mesh):
    """What this rank holds: each layer leaf's depth, the cache's, the top
    leaves and the stage's global layers."""
    eng = _engine(case, mesh)
    return dict(layers={k: v.shape[0] for k, v in eng.params["layers"].items()},
                cache=(eng.cache.k.shape[0], eng.cache.v.shape[0]),
                top=sorted(k for k in eng.params if k != "layers"), stage=eng.layers,
                hops=mesh.hops)


def run_pp_cases(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    out = {}
    meshes = {}
    for case in cases:
        degrees = case["mesh"]
        if degrees not in meshes:
            meshes[degrees] = make_mesh(pipe=degrees[0], model=degrees[1], device="cpu")
            meshes[degrees].warm("cpu")  # every group once, the hop groups in one order
        mesh = meshes[degrees]
        run = {"serve": _serve, "sampled": _sampled_horizon, "residency": _residency}
        out[case["name"]] = run[case["kind"]](case, mesh)
    return out


# ---------------------------------------------------------------------------
# the parent (JAX)
# ---------------------------------------------------------------------------


def _jax_run(spec, params, case, mesh=None, lora=None):
    """JAX's tokens for ``case``: its one-device engine, or its pipeline
    engine on ``mesh``."""
    import jax.numpy as jnp

    from flexflow_tpu.peft import LoraConfig
    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager
    from flexflow_tpu.serving.pp_engine import PipelineInferenceEngine

    kw = dict(ENGINE, cache_dtype=jnp.float32,
              **{k: v for k, v in case.get("engine", {}).items() if k != "num_microbatches"})
    if lora is not None:
        kw.update(lora=lora, lora_config=LoraConfig(**LORA_CFG))
    eng = (InferenceEngine(spec, params, **kw) if mesh is None
           else PipelineInferenceEngine(spec, params, mesh=mesh, **kw))
    rm = RequestManager(eng, **case.get("rm", {}))
    if "adapters" in case:
        return [rm.generate([p], GenerationConfig(max_new_tokens=case["max_new"],
                                                  adapter_id=a))[0].output_tokens
                for p, a in zip(case["prompts"], case["adapters"])]
    return [r.output_tokens for r in rm.generate(
        case["prompts"], GenerationConfig(max_new_tokens=case["max_new"]))]


def _jax_lora(spec):
    """JAX's two adapters on wq, wv and wd, B drawn (LoRA active), and the
    ranks' numpy copy."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.peft import LoraConfig, init_lora_params

    lora = init_lora_params(spec, LoraConfig(**LORA_CFG), 2, jax.random.PRNGKey(1))
    keys = jax.random.split(jax.random.PRNGKey(2), len(lora))
    lora = {mod: {"a": ab["a"], "b": jax.random.normal(k, ab["b"].shape, jnp.float32) * 0.05}
            for k, (mod, ab) in zip(keys, lora.items())}
    return lora, {m: {k: np.asarray(v) for k, v in ab.items()} for m, ab in lora.items()}


def test_two_stages_equal_jax(tmp_path):
    """P = 2 over two ranks: greedy (against JAX's one-device engine and its
    own pipeline engine), ALiBi, the overlapped horizon at M = 2 and M = 4
    (tokens banked), the stepwise one at M = 1, chunked prefill with a
    partial last chunk and a final window past the cache end, LoRA at T = 1
    through a non-pipelined manager with a horizon, a sampled overlapped
    horizon against the port's one-device draws, and stage residency; a
    Mixtral spec and JAX's INT8 and INT4 carriers against JAX's one-device
    engine."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    js, jparams, npp = _jax_params(SPEC, 0)
    ja, jalibi, nalibi = _jax_params(ALIBI, 3)
    jlora, nlora = _jax_lora(js)
    others = {"mixtral": (MIXTRAL, _jax_params(MIXTRAL, 2)),
              **{f"int{bits}": (SPEC, _jax_params(SPEC, 5, bits)) for bits in (8, 4)}}
    prompts = _prompts()
    base = dict(kind="serve", spec=SPEC, params=npp, prompts=prompts, max_new=24, mesh=(2, 1))
    cases = [
        dict(base, name="p2"),
        dict(base, name="alibi", spec=ALIBI, params=nalibi, prompts=prompts[:4], rm=HORIZON),
        dict(base, name="m2", rm=HORIZON),
        dict(base, name="m4", engine=dict(num_microbatches=4), rm=HORIZON),
        dict(base, name="m1", engine=dict(num_microbatches=1), rm=HORIZON),
        dict(base, name="chunk", prompts=CHUNK_PROMPTS, engine=dict(max_tokens_per_batch=8)),
        dict(base, name="chunk-end", prompts=[END_PROMPT], max_new=6,
             engine=dict(max_seq_len=64, max_tokens_per_batch=24)),
        dict(base, name="lora", prompts=LORA_PROMPTS, adapters=LORA_IDS, max_new=12,
             lora=nlora, rm=dict(decode_horizon=4, pipelined=False)),
        dict(base, kind="sampled", name="sampled"),
        dict(base, kind="residency", name="resident"),
    ]
    layouts = [dict(base, name=name, spec=kw, params=jax_p[2], max_new=12, rm=HORIZON)
               for name, (kw, jax_p) in others.items()]
    started = _start(tmp_path, 2, cases + layouts, runner=run_pp_cases)
    want = {c["name"]: _jax_run(ja if c["spec"] is ALIBI else js,
                                jalibi if c["spec"] is ALIBI else jparams, c,
                                lora=jlora if "lora" in c else None)
            for c in cases if c["kind"] == "serve"}
    want.update({c["name"]: _jax_run(*others[c["name"]][1][:2], c) for c in layouts})
    want_pp = _jax_run(js, jparams, cases[0], mesh=j_make_mesh(pipe=2))
    want["chunk-end"] = _jax_run(js, jparams, dict(cases[6], engine=dict(max_seq_len=64)))
    sampled = _sampled_horizon(cases[8], None)  # the port's one device
    res = _join(tmp_path, 2, started)
    for name, tokens in want.items():
        assert _all_ranks(res, name) == tokens, name
    assert _all_ranks(res, "p2") == want_pp
    assert want["lora"][0] != want["lora"][2] or want["lora"][1] != want["lora"][2]
    assert _all_ranks(res, "sampled") == sampled
    assert len(set(map(tuple, sampled[1]))) > 1  # the draws are not one token
    r0, r1 = res[0]["resident"], res[1]["resident"]
    assert r0["stage"] == (0, 2) and r1["stage"] == (2, 4)
    for r in (r0, r1):
        assert set(r["layers"].values()) == {2} and r["cache"] == (2, 2)
    assert r0["top"] == ["embed_tokens"]
    assert r1["top"] == ["final_norm_scale", "lm_head"]
    assert r0["hops"] > 0 and r1["hops"] > 0  # hidden states out, tokens back


def test_four_ranks_pipe4_and_pipe2_by_tensor2_equal_jax(tmp_path):
    """P = 4 and P = 2 x T = 2 over four ranks: JAX's one-device tokens
    (greedy, the overlapped horizon, ALiBi, chunked prefill, GQA and MQA at
    P = 2 x T = 2), and at P = 2 x T = 2 JAX's pipeline engine's."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    js, jparams, npp = _jax_params(SPEC, 5)
    ja, jalibi, nalibi = _jax_params(ALIBI, 4)
    heads = {"p2t2-gqa": (GQA, _jax_params(GQA, 6)), "p2t2-mqa": (MQA, _jax_params(MQA, 7))}
    prompts = _prompts(4)
    base = dict(kind="serve", spec=SPEC, params=npp, prompts=prompts, max_new=16)
    cases = [dict(base, name="p4", mesh=(4, 1)),
             dict(base, name="p4-h8", mesh=(4, 1), rm=HORIZON),
             dict(base, name="p2t2", mesh=(2, 2)),
             dict(base, name="p2t2-h8", mesh=(2, 2), rm=HORIZON),
             dict(base, name="p2t2-alibi", mesh=(2, 2), spec=ALIBI, params=nalibi),
             dict(base, name="p2t2-chunk", mesh=(2, 2), prompts=CHUNK_PROMPTS,
                  engine=dict(max_tokens_per_batch=8)),
             dict(base, kind="residency", name="resident", mesh=(2, 2))]
    layouts = [dict(base, name=name, spec=kw, params=jax_p[2], mesh=(2, 2), rm=HORIZON)
               for name, (kw, jax_p) in heads.items()]
    started = _start(tmp_path, 4, cases + layouts, runner=run_pp_cases)
    want = {c["name"]: _jax_run(ja if c["spec"] is ALIBI else js,
                                jalibi if c["spec"] is ALIBI else jparams, c)
            for c in cases if c["kind"] == "serve"}
    want.update({c["name"]: _jax_run(*heads[c["name"]][1][:2], c) for c in layouts})
    want_pp = _jax_run(js, jparams, cases[2], mesh=j_make_mesh(pipe=2, model=2))
    res = _join(tmp_path, 4, started)
    for name, tokens in want.items():
        assert _all_ranks(res, name) == tokens, name
    assert _all_ranks(res, "p2t2") == want_pp
    # ranks 0, 1: stage 0's two model ranks; 2, 3: stage 1's
    for r, (stage, top) in enumerate([((0, 2), ["embed_tokens"])] * 2
                                     + [((2, 4), ["final_norm_scale", "lm_head"])] * 2):
        held = res[r]["resident"]
        assert held["stage"] == stage and held["top"] == top
        assert set(held["layers"].values()) == {2} and held["cache"] == (2, 2)


def test_stage_params_equal_jax():
    """``stage_params(layers, P)`` is JAX's stage-major ``[P, L/P, ...]`` form
    leaf for leaf, and ``stage=s`` its slice ``s``; ``shard_params`` under a
    pipe mesh keeps that slice and the stage's top leaves (tied embeddings
    on the last stage too); ``L % P`` raises."""
    from flexflow_tpu.parallel.pipeline import stage_params as j_stage_params

    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.mesh import Mesh
    from flexflow_tpu_torch.parallel.pipeline import stage_params, stage_range
    from flexflow_tpu_torch.parallel.sharding import shard_params

    js, jparams, npp = _jax_params(SPEC, 0)
    layers = tp.params_from_numpy(npp)["layers"]
    for p in (2, 4):
        want = j_stage_params(jparams["layers"], p)
        got = stage_params(layers, p)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            for s in range(p):
                np.testing.assert_array_equal(stage_params(layers, p, s)[k].numpy(),
                                              np.asarray(want[k])[s])
    with pytest.raises(ValueError, match="not divisible"):
        stage_params(layers, 3)
    with pytest.raises(ValueError, match="not divisible"):
        stage_range(4, 3, 0)
    spec = _tspec(SPEC)
    whole = tp.params_from_numpy(npp)
    tied = {k: v for k, v in whole.items() if k != "lm_head"}
    for s, top, top_tied in ((0, {"embed_tokens"}, {"embed_tokens"}),
                             (1, {"final_norm_scale", "lm_head"},
                              {"final_norm_scale", "embed_tokens"})):
        mesh = Mesh.fake(1, 1, s, pipe=2)
        cut = shard_params(spec, whole, mesh)
        assert set(cut) - {"layers"} == top and set(cut) - {"layers"} <= set(whole)
        assert set(shard_params(spec, tied, mesh)) - {"layers"} == top_tied
        for k, v in cut["layers"].items():
            np.testing.assert_array_equal(v.numpy(), whole["layers"][k][2 * s:2 * s + 2].numpy())
        again = shard_params(spec, cut, mesh)  # idempotent
        assert all(torch.equal(again["layers"][k], v) for k, v in cut["layers"].items())
        # the loaders build only the stage: the same leaves as the cut
        built = tp.params_from_numpy(npp, spec=spec, mesh=mesh)
        assert set(built) == set(cut)
        assert all(torch.equal(built["layers"][k], v) for k, v in cut["layers"].items())
        drawn = tp.init_params(spec, 0, mesh=mesh)
        full = tp.init_params(spec, 0)
        assert all(torch.equal(drawn["layers"][k], full["layers"][k][2 * s:2 * s + 2])
                   for k in drawn["layers"])
        # JAX's quantized carriers: the stage's layers converted only, byte
        # for byte the cut of the whole carriers
        for bits in (8, 4):
            nq = _jax_params(SPEC, 0, bits=bits)[2]
            got, want = (tp.params_from_numpy(nq, spec=spec, mesh=mesh),
                         shard_params(spec, tp.params_from_numpy(nq), mesh))
            assert set(got) == set(want)
            for k, v in want["layers"].items():
                g = got["layers"][k]
                fields = ("q", "scale", "offset") if hasattr(v, "q") else (None,)
                for f in fields:
                    a, b = (g, v) if f is None else (getattr(g, f), getattr(v, f))
                    assert (a is None and b is None) or torch.equal(a, b), (bits, k, f)
                if hasattr(v, "q"):
                    assert g.shape == v.shape and g.shape[0] == 2


def test_mesh_coordinates_equal_jax_grid():
    """Rank r of ``Mesh.fake(data=2, pipe=2, model=2)`` sits where device r
    sits in JAX's ``make_mesh(data=2, pipe=2, model=2)`` grid, and each
    axis group is that grid's line through it."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    from flexflow_tpu_torch.parallel.mesh import (DATA_AXIS, FFN_AXES, MODEL_AXIS, PIPE_AXIS,
                                                  Mesh)

    grid = np.vectorize(lambda d: d.id)(j_make_mesh(data=2, pipe=2, model=2).devices)[..., 0]
    for r in range(8):
        m = Mesh.fake(2, 2, r, pipe=2)
        d, p, t = (int(a[0]) for a in np.nonzero(grid == r))
        assert (m.data_rank, m.pipe_rank, m.model_rank) == (d, p, t)
        assert m.group_ranks(MODEL_AXIS) == grid[d, p, :].tolist()
        assert m.group_ranks(DATA_AXIS) == grid[:, p, t].tolist()
        assert m.group_ranks(PIPE_AXIS) == grid[d, :, t].tolist()
        assert m.group_ranks(FFN_AXES) == sorted(grid[:, p, :].ravel().tolist())
        assert m.stage_rank(1) == grid[d, 1, t]
    with pytest.raises(ValueError, match="outside"):
        Mesh.fake(2, 2, 8, pipe=2)


def test_refusals():
    """Every refusal under pipeline stages raises and names its label: data
    > 1, ``L % P``, ``B % M`` and LoRA with T > 1 in the engine (JAX's
    words), and data > 1, ``B % M``, a vocabulary mismatch and a tree over
    the cap in ``PipelineSpecEngine``; merged trees of several drafts,
    offload, LoRA with T > 1, PEFT with drafts and data > 1 in
    ``LLM.compile``; ``SpecEngine`` names ``PipelineSpecEngine``; the
    Trainer's ``pipeline_stages`` without a mesh (a pipe mesh alone builds
    it), finetuning on a pipeline engine (JAX fails there too);
    the one-device engine takes no pipe mesh; ``layout_mesh`` with pipe > 1
    builds the mesh, which without a process group raises ``make_mesh``'s
    "run under torchrun"."""
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel import auto
    from flexflow_tpu_torch.parallel.mesh import Mesh
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.serve import LLM, SSM
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.pp_engine import PipelineInferenceEngine
    from flexflow_tpu_torch.serving.pp_spec import PipelineSpecEngine
    from flexflow_tpu_torch.serving.speculative import SpecEngine
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer

    spec = _tspec(SPEC)
    params = tp.init_params(spec, 0)
    lora = {"wq": {"a": torch.zeros(4, 1, 64, 4), "b": torch.zeros(4, 1, 4, 64)}}
    pp = dict(cache_dtype=torch.float32, **ENGINE)
    with pytest.raises(NotImplementedError, match="requires data axis == 1"):
        PipelineInferenceEngine(spec, params, mesh=Mesh.fake(2, 1, 0, pipe=2), **pp)
    with pytest.raises(ValueError, match="not divisible by pipeline stages 3"):
        PipelineInferenceEngine(spec, params, mesh=Mesh.fake(1, 1, 0, pipe=3), **pp)
    with pytest.raises(ValueError, match="not divisible by microbatches 3"):
        PipelineInferenceEngine(spec, params, mesh=Mesh.fake(1, 1, 0, pipe=2),
                                num_microbatches=3, **pp)
    with pytest.raises(NotImplementedError, match="tensor_parallelism_degree == 1"):
        PipelineInferenceEngine(spec, params, mesh=Mesh.fake(1, 2, 0, pipe=2), lora=lora, **pp)
    with pytest.raises(ValueError, match="PipelineInferenceEngine"):
        InferenceEngine(spec, params, device="cpu", mesh=Mesh.fake(1, 1, 0, pipe=2))
    with pytest.raises(ValueError, match="PipelineSpecEngine"):
        SpecEngine(spec, params, spec, params, device="cpu", mesh=Mesh.fake(1, 1, 0, pipe=2))
    staged = Mesh.fake(1, 1, 0, pipe=2)
    with pytest.raises(NotImplementedError, match="requires data axis == 1"):
        PipelineSpecEngine(spec, params, spec, params, mesh=Mesh.fake(2, 1, 0, pipe=2), **pp)
    with pytest.raises(ValueError, match="not divisible by microbatches 3"):
        PipelineSpecEngine(spec, params, spec, params, mesh=staged, num_microbatches=3, **pp)
    with pytest.raises(ValueError, match="one vocabulary"):
        PipelineSpecEngine(spec, params, _tspec(dict(SPEC, vocab_size=128)), params,
                           mesh=staged, **pp)
    with pytest.raises(ValueError, match="exceeds the cap 64"):
        PipelineSpecEngine(spec, params, spec, params, mesh=staged, beam_width=3, beam_depth=22,
                           **pp)
    with pytest.raises(ValueError, match="pipeline_stages=2 needs a mesh"):
        Trainer(spec, params, SGDOptimizer(lr=0.1), pipeline_stages=2, device="cpu")
    assert Trainer(spec, params, SGDOptimizer(lr=0.1), mesh=Mesh.fake(1, 1, 0, pipe=2)).stages == 2

    class Staged:  # what FinetuneSession reads of an engine under stages
        mesh, lora = Mesh.fake(1, 1, 0, pipe=2), None

    with pytest.raises(NotImplementedError, match="JAX's FinetuneSession cannot run"):
        FinetuneSession(spec, LoraConfig(), 0, [])._build(Staged())
    with pytest.raises(RuntimeError, match="2-rank mesh needs a process group"):
        auto.layout_mesh(auto.Layout(data=1, pipe=2, model=1), device="cpu")

    def llm(ssms=(), peft=()):
        out = LLM.__new__(LLM)
        out._ssms, out._peft = list(ssms), list(peft)
        out.quant_bits, out.device = None, torch.device("cpu")
        return out

    ssm = SSM.__new__(SSM)
    cfg = (LoraConfig(), None)
    for what, model, kw in (
            ("merge_ssm_trees with pipeline parallelism", llm(),
             dict(ssms=[ssm, ssm], merge_ssm_trees=True)),
            ("offload", llm(), dict(offload=True)),
            ("tensor_parallelism_degree == 1", llm(peft=[cfg]), dict(tensor_parallelism_degree=2)),
            ("PEFT with speculative", llm(ssms=[ssm], peft=[cfg]), {}),
            ("data axis == 1", llm(), dict(data_parallelism_degree=2))):
        with pytest.raises(NotImplementedError, match=what):
            model.compile(pipeline_parallelism_degree=2, **kw)
