"""Tree-speculative serving under pipeline stages (``serving/pp_spec.py``)
over gloo ranks on the CPU (the helpers of ``test_torch_port_mesh_serving.py``),
held against the JAX package at float32 on JAX's ``tests/test_pp_spec.py``
specs (a 4-layer x 64 verifier block-embedding a 2-layer x 32 draft, the
draft perturbed at 0.05; width 2, depth 3, 4 slots, 160 positions):

- P = 2 gives JAX's one-device ``SpecEngine`` tokens, its
  ``PipelineSpecEngine``'s on ``make_mesh(pipe=2)`` and incremental greedy
  decoding's, with more than one verified token a step; so do a horizon of
  2 (and a pipelined one), three model families (learned positions,
  parallel-attention MQA, ALiBi) and two drafts rotated over one shared
  staged verifier;
- every rank's draft tree is bitwise the same at every iteration;
- a sampled horizon gives the port's one-device ``SpecEngine`` draws bit
  for bit (JAX's draws come from another generator);
- P = 2 x T = 2 gives JAX's ``make_mesh(pipe=2, model=2)`` tokens, and at
  P = 4 each rank holds L/P verifier layers and its cache rows, and the
  draft whole.

The ranks import no JAX: the parent computes JAX's tokens while they run.
``LLM.compile(ssms=, pipeline_parallelism_degree=)`` and ``spec_infer --pp``
are in ``test_torch_port_pp_cli.py``.
"""

import dataclasses
import hashlib

import numpy as np
import torch

from test_torch_port_mesh_serving import (_all_ranks, _join, _numpy_tree, _start, _tspec,
                                          unfused_jax)  # noqa: F401 - a fixture

LLM_SPEC = dict(arch="LlamaForCausalLM", vocab_size=256, hidden_size=64, num_layers=4,
                num_heads=8, num_kv_heads=8, head_dim=8, intermediate_size=128,
                max_position_embeddings=256, norm_eps=1e-6)
SSM_SPEC = dict(LLM_SPEC, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=4,
                intermediate_size=64)
ENGINE = dict(beam_width=2, beam_depth=3, max_requests_per_batch=4, max_seq_len=160)
ZOO_FAMILIES = ("opt", "falcon_mqa", "mpt_alibi")
SAMPLED = dict(temperature=[0.8, 1.2, 0.7, 1.0], top_p=[0.95, 1.0, 0.9, 1.0], top_k=[0, 8, 0, 16])


def _prompts(n=4):
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, size=rng.randint(4, 16)).tolist() for _ in range(n)]


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _engine(case, mesh, ssm="ssm", shared=None):
    """The port's engine for ``case``: ``PipelineSpecEngine`` on ``mesh``
    (over ``shared``'s staged verifier if given), ``SpecEngine`` without."""
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.serving.pp_spec import PipelineSpecEngine
    from flexflow_tpu_torch.serving.speculative import SpecEngine

    spec, dspec = _tspec(case["spec"]), _tspec(case["dspec"])
    llm = None if shared else tp.params_from_numpy(case["params"], spec=spec, mesh=mesh)
    draft = tp.params_from_numpy(case[ssm])
    kw = dict(ENGINE, cache_dtype=torch.float32)
    if mesh is None:
        return SpecEngine(spec, llm, dspec, draft, device="cpu", **kw)
    return PipelineSpecEngine(spec, llm, dspec, draft, mesh=mesh, shared_pp=shared, **kw)


def _digest(*tensors) -> str:
    return hashlib.sha256(b"".join(t.detach().cpu().contiguous().numpy().tobytes()
                                   for t in tensors)).hexdigest()


def _serve(case, mesh):
    """The tokens of ``case``'s prompts through the fused manager, its mean
    verified tokens a step, and a digest of every draft tree it expanded."""
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager

    eng = _engine(case, mesh)
    trees, draft = [], eng._draft_phase

    def recorded(*args):
        tokens, parents, anc, (bk, bv) = out = draft(*args)
        trees.append(_digest(tokens, parents, anc, bk, bv))
        return out

    eng._draft_phase = recorded
    rm = SpecRequestManager(eng, fused=True, **case.get("rm", {}))
    reqs = rm.generate(case["prompts"], GenerationConfig(max_new_tokens=case["max_new"]))
    return dict(tokens=[r.output_tokens for r in reqs], trees=trees,
                verified=rm.mean_verified_tokens_per_step)


def _rotation(case, mesh):
    """Two drafts rotated over one staged verifier."""
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig
    from flexflow_tpu_torch.serving.spec_manager import MultiSSMSpecManager

    first = _engine(case, mesh)
    second = _engine(case, mesh, ssm="ssm2", shared=first._pp)
    rm = MultiSSMSpecManager([first, second], fused=True)
    reqs = rm.generate(case["prompts"], GenerationConfig(max_new_tokens=case["max_new"]))
    return dict(tokens=[r.output_tokens for r in reqs], steps=rm.total_decoding_steps,
                shared=second.llm_cache is first.llm_cache)


def _sampled(case, mesh):
    """A sampled admission, then one sampled 4-iteration horizon from the
    same keys: [first tokens, produced, accepted counts]."""
    from flexflow_tpu_torch.ops.sampling import SamplingConfig

    eng = _engine(case, mesh)
    scfg = SamplingConfig(*(np.asarray(SAMPLED[k], dt) for k, dt in (
        ("temperature", np.float32), ("top_p", np.float32), ("top_k", np.int32))))
    prompts = case["prompts"]
    first = eng.prefill_both_batch(prompts, [0, 1, 2, 3], key=11, scfg=scfg)
    lens = np.array([len(p) for p in prompts], np.int32)
    produced, n_acc, _, _ = eng.fused_sample_step_n_async(
        eng._h(lens), eng._h(first), 12, scfg, 4, window=eng.attn_window_bucket(int(lens.max())))
    return [first, eng.fetch(produced).tolist(), eng.fetch(n_acc).tolist()]


def _residency(case, mesh):
    """What this rank holds: the verifier's layer depths and cache depth,
    the draft's layer depths and cache shape."""
    eng = _engine(case, mesh)
    return dict(layers=sorted({v.shape[0] for v in eng.llm_params["layers"].values()}),
                cache=tuple(eng.llm_cache.k.shape), stage=eng._pp.layers,
                draft=sorted({v.shape[0] for v in eng.ssm_params["layers"].values()}),
                draft_cache=tuple(eng.ssm_cache.k.shape))


def run_pp_spec_cases(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    out, meshes = {}, {}
    for case in cases:
        degrees = case["mesh"]
        if degrees not in meshes:
            meshes[degrees] = make_mesh(pipe=degrees[0], model=degrees[1], device="cpu")
            meshes[degrees].warm("cpu")
        run = {"serve": _serve, "rotation": _rotation, "sampled": _sampled,
               "residency": _residency}[case["kind"]]
        out[case["name"]] = run(case, meshes[degrees])
    return out


# ---------------------------------------------------------------------------
# the parent (JAX)
# ---------------------------------------------------------------------------


def _spec_dict(spec) -> dict:
    """A JAX ModelSpec's fields (the port's ModelSpec has the same; no MoE)."""
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec) if f.name != "moe"}


def _jax_pair():
    """JAX's correlated (verifier, draft) pair (``test_pp_spec._params``),
    a second draft from seed 7, and the ranks' numpy copies."""
    import jax
    import jax.numpy as jnp

    from benchmarks.spec_pair import embed_draft_in_verifier, perturb_params
    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.models import params as jp

    js, jd = jspecs.ModelSpec(**LLM_SPEC), jspecs.ModelSpec(**SSM_SPEC)
    dparams = jp.init_params(jd, jax.random.PRNGKey(0), jnp.float32)
    llm = embed_draft_in_verifier(jd, dparams, js, jnp.float32)
    ssm = perturb_params(dparams, 0.05, jax.random.PRNGKey(42))
    ssm2 = jp.init_params(jd, jax.random.PRNGKey(7), jnp.float32)
    return (js, jd, llm, ssm, ssm2), dict(spec=LLM_SPEC, dspec=SSM_SPEC, params=_numpy_tree(llm),
                                          ssm=_numpy_tree(ssm), ssm2=_numpy_tree(ssm2))


def _jax_zoo(family):
    """JAX's zoo verifier (``tests/test_serving_zoo.ZOO``) and its 1-layer
    draft, independent random models, and the ranks' numpy copies."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.models import params as jp
    from tests.test_serving_zoo import ZOO

    vspec = ZOO[family]
    dspec = dataclasses.replace(vspec, num_layers=1)
    vparams = jp.init_params(vspec, jax.random.PRNGKey(0), jnp.float32)
    dparams = jp.init_params(dspec, jax.random.PRNGKey(1), jnp.float32)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 96, size=rng.randint(3, 10)).tolist() for _ in range(3)]
    return (vspec, dspec, vparams, dparams), dict(
        spec=_spec_dict(vspec), dspec=_spec_dict(dspec), params=_numpy_tree(vparams),
        ssm=_numpy_tree(dparams), prompts=prompts)


def _jax_spec(js, jd, llm, ssm, prompts, max_new, mesh=None, **rm_kw):
    """JAX's fused speculative tokens: its one-device engine, or its
    pipeline engine on ``mesh``."""
    import jax.numpy as jnp

    from flexflow_tpu.serving import GenerationConfig
    from flexflow_tpu.serving.pp_spec import PipelineSpecEngine
    from flexflow_tpu.serving.spec_manager import SpecRequestManager
    from flexflow_tpu.serving.speculative import SpecEngine

    kw = dict(ENGINE, cache_dtype=jnp.float32)
    eng = (SpecEngine(js, llm, jd, ssm, **kw) if mesh is None
           else PipelineSpecEngine(js, llm, jd, ssm, mesh=mesh, **kw))
    reqs = SpecRequestManager(eng, fused=True, **rm_kw).generate(
        prompts, GenerationConfig(max_new_tokens=max_new))
    return [r.output_tokens for r in reqs]


def _jax_incremental(js, llm, prompts, max_new):
    import jax.numpy as jnp

    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager

    eng = InferenceEngine(js, llm, max_requests_per_batch=4, max_seq_len=160,
                          cache_dtype=jnp.float32)
    return [r.output_tokens for r in RequestManager(eng).generate(
        prompts, GenerationConfig(max_new_tokens=max_new))]


def _jax_rotation(js, jd, llm, drafts, prompts, max_new):
    import jax.numpy as jnp

    from flexflow_tpu.serving import GenerationConfig
    from flexflow_tpu.serving.spec_manager import MultiSSMSpecManager
    from flexflow_tpu.serving.speculative import SpecEngine

    engines = [SpecEngine(js, llm, jd, d, **ENGINE, cache_dtype=jnp.float32) for d in drafts]
    return [r.output_tokens for r in MultiSSMSpecManager(engines, fused=True).generate(
        prompts, GenerationConfig(max_new_tokens=max_new))]


def test_two_stages_equal_jax(tmp_path, unfused_jax):
    """P = 2 over two ranks: greedy against JAX's one-device engine, its
    pipeline engine and incremental decoding; horizons of 2 (plain and
    pipelined); the three model families; two drafts rotated over one
    staged verifier; every rank's draft trees bitwise the same; a sampled
    horizon against the port's one-device draws."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    (js, jd, jllm, jssm, jssm2), pair = _jax_pair()
    prompts = _prompts()
    zoo = {f: _jax_zoo(f) for f in ZOO_FAMILIES}
    base = dict(pair, kind="serve", prompts=prompts, max_new=20, mesh=(2, 1))
    cases = [dict(base, name="p2"),
             dict(base, name="h2", rm=dict(spec_horizon=2)),
             dict(base, name="h2-pipelined", rm=dict(spec_horizon=2, pipelined=True)),
             *(dict(base, **zoo[f][1], name=f, max_new=10) for f in ZOO_FAMILIES),
             dict(base, kind="rotation", name="rotation", max_new=16),
             dict(base, kind="sampled", name="sampled")]
    started = _start(tmp_path, 2, cases, runner=run_pp_spec_cases)
    incr = _jax_incremental(js, jllm, prompts, 20)
    want = _jax_spec(js, jd, jllm, jssm, prompts, 20)
    want_pp = _jax_spec(js, jd, jllm, jssm, prompts, 20, mesh=j_make_mesh(pipe=2))
    want_h2 = _jax_spec(js, jd, jllm, jssm, prompts, 20, spec_horizon=2)
    want_zoo = {}
    for f, ((vs, ds, vp, dp), nz) in zoo.items():
        want_zoo[f] = _jax_spec(vs, ds, vp, dp, nz["prompts"], 10)
        assert want_zoo[f] == _jax_incremental(vs, vp, nz["prompts"], 10), f
    want_rot = _jax_rotation(js, jd, jllm, (jssm, jssm2), prompts, 16)
    one_sampled = _sampled(cases[-1], None)  # the port's one device
    res = _join(tmp_path, 2, started)
    assert want == incr == want_pp == want_h2
    assert _all_ranks(res, "p2")["verified"] > 1.0  # speculation is active
    for name in ("p2", "h2", "h2-pipelined", *ZOO_FAMILIES):
        got = _all_ranks(res, name)
        assert got["tokens"] == (want_zoo[name] if name in want_zoo else want), name
        assert got["trees"] and res[1][name]["trees"] == res[0][name]["trees"], name
    rot = _all_ranks(res, "rotation")
    assert rot["tokens"] == want_rot and rot["tokens"] == [t[:16] for t in incr]
    assert rot["steps"] >= 2 and rot["shared"]
    assert _all_ranks(res, "sampled") == one_sampled
    produced = np.asarray(one_sampled[1])
    assert len(set(produced[..., 0].ravel().tolist())) > 1  # the draws are not one token


def test_four_ranks_pipe2_by_tensor2_and_pipe4_residency(tmp_path, unfused_jax):
    """P = 2 x T = 2 against JAX's ``make_mesh(pipe=2, model=2)`` run; P = 4:
    JAX's one-device tokens, each rank one verifier layer and its cache
    rows, the draft whole."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    (js, jd, jllm, jssm, _), pair = _jax_pair()
    prompts = _prompts()
    base = dict(pair, kind="serve", prompts=prompts, max_new=16)
    cases = [dict(base, name="p2t2", mesh=(2, 2)), dict(base, name="p4", mesh=(4, 1)),
             dict(base, kind="residency", name="resident", mesh=(4, 1))]
    started = _start(tmp_path, 4, cases, runner=run_pp_spec_cases)
    want_mesh = _jax_spec(js, jd, jllm, jssm, prompts, 16, mesh=j_make_mesh(pipe=2, model=2))
    want = _jax_spec(js, jd, jllm, jssm, prompts, 16)
    res = _join(tmp_path, 4, started)
    assert want_mesh == want
    assert _all_ranks(res, "p2t2")["tokens"] == want_mesh
    assert _all_ranks(res, "p4")["tokens"] == want
    for name in ("p2t2", "p4"):
        assert all(r[name]["trees"] == res[0][name]["trees"] for r in res), name
    for s, r in enumerate(res):
        held = r["resident"]
        assert held["stage"] == (s, s + 1) and held["layers"] == [1]
        assert held["cache"] == (1, 4, 8, 160, 8)
        assert held["draft"] == [2] and held["draft_cache"] == (2, 4, 4, 160, 8)
