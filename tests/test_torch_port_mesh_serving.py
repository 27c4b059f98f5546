"""Tensor and data parallel serving of the port over gloo ranks on the CPU
(``torch.multiprocessing``, a ``file://`` rendezvous under ``tmp_path``),
held against the JAX package's engines at float32 (JAX's
``tests/test_mesh_serving.py`` spec):

- T = 4 and 8 (pipelined horizon 8), D = 2 x T = 2 and the ``SpecEngine``
  at D = 2 x T = 2 give JAX's one-device greedy tokens, and D = 2 x T = 4
  gives the tokens of JAX's own mesh engine at that mesh;
- refusals name their ROADMAP items.

Two ranks (T = 2, Mixtral, MQA, quantized, sampled, ``LLM.compile`` and the
CLIs) are in ``test_torch_port_mesh_llm.py``, on these helpers. The ranks
import no JAX: the parent computes JAX's tokens while they run. Each
multi-process test has its own time limit, which kills its ranks.
"""

import contextlib
import io
import pickle
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

SPEC = dict(arch="LlamaForCausalLM", vocab_size=256, hidden_size=64, num_layers=2,
            num_heads=8, num_kv_heads=8, head_dim=8, intermediate_size=128,
            max_position_embeddings=256, norm_eps=1e-6)
MIXTRAL = dict(SPEC, arch="MixtralForCausalLM", num_kv_heads=4, moe=(4, 2))
MQA = dict(SPEC, num_kv_heads=1)
ENGINE = dict(max_requests_per_batch=4, max_seq_len=128)
LIMIT_S = 120


def _prompts(n=5):
    rng = np.random.RandomState(0)
    return [rng.randint(1, 256, size=rng.randint(4, 20)).tolist() for _ in range(n)]


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _tspec(kw):
    from flexflow_tpu_torch import specs as tspecs

    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = tspecs.MoESpec(num_experts=kw["moe"][0], top_k=kw["moe"][1])
    return tspecs.ModelSpec(**kw)


def _serve(case, mesh):
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine

    spec = _tspec(case["spec"])
    llm = tp.params_from_numpy(case["params"], spec=spec, mesh=mesh)
    gen = GenerationConfig(max_new_tokens=case["max_new"], temperature=case.get("temp", 0.0))
    if "ssm" in case:
        ssm = tp.params_from_numpy(case["ssm"], spec=spec, mesh=mesh)
        eng = SpecEngine(spec, llm, spec, ssm, beam_width=2, beam_depth=3,
                         cache_dtype=torch.float32, device="cpu", mesh=mesh, **ENGINE)
        rm = SpecRequestManager(eng, fused=True)
        return [r.output_tokens for r in rm.generate(case["prompts"], gen)]
    eng = InferenceEngine(spec, llm, cache_dtype=torch.float32, device="cpu", mesh=mesh,
                          **ENGINE, **case.get("engine", {}))
    rm = RequestManager(eng, **case.get("rm", {}))
    try:
        return [r.output_tokens for r in rm.generate(case["prompts"], gen)]
    finally:
        rm.close()


def _cli_text(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main(argv)
    return out.getvalue()


def _run_cases(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for case in cases:
        if case["kind"] == "serve":
            mesh = None if case["mesh"] is None else make_mesh(*case["mesh"], device="cpu")
            out[case["name"]] = _serve(case, mesh)
        elif case["kind"] == "indivisible":
            try:
                make_mesh(model=4, device="cpu")
            except ValueError as e:
                out[case["name"]] = str(e)
        elif case["kind"] == "llm":
            from flexflow_tpu_torch.serve import LLM

            for tp_, dp in ((1, 1), (2, 1), (1, 2)):
                llm = LLM(model_dir, data_type="float32", device="cpu")
                llm.compile(max_requests_per_batch=2, max_seq_length=64,
                            tensor_parallelism_degree=tp_, data_parallelism_degree=dp)
                res = llm.generate([[1, 5, 9, 12], [3, 4]], max_new_tokens=6)
                out[f"llm-{tp_}x{dp}"] = [r.output_tokens for r in res]
        elif case["kind"] == "cli":
            from flexflow_tpu_torch.inference import incr_decoding, spec_infer

            base = ["-llm-model", model_dir, "-prompt", case["prompts"], "--max-new-tokens",
                    "8", "--max-requests-per-batch", "2", "--full-precision",
                    "--device", "cpu"]
            spec = ["-ssm-model", model_dir, "--max-sequence-length", "128"]
            tp2, dp2 = ["-tensor-parallelism-degree", "2"], ["-data-parallelism-degree", "2"]
            out["incr-one"] = _cli_text(incr_decoding, base)
            out["incr-tp2"] = _cli_text(incr_decoding, base + tp2)
            out["spec-one"] = _cli_text(spec_infer, base + spec)
            out["spec-dp2"] = _cli_text(spec_infer, base + spec + dp2)
    return out


def _rank_main(rank, world, init, cases, out_path, model_dir, runner=None):
    """One rank: ``runner(cases, model_dir)`` (default ``_run_cases``; a
    module-level function of a test file that imports no JAX at its top)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
    try:
        res = (runner or _run_cases)(cases, model_dir)
        res["jax imported"] = "jax" in sys.modules  # the port and the ranks import none
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _start(tmp_path, world, cases, model_dir=None, runner=None):
    ctx = mp.start_processes(
        _rank_main, args=(world, f"file://{tmp_path}/rendezvous", cases, str(tmp_path / "out"),
                          model_dir, runner),
        nprocs=world, join=False, start_method="spawn")
    return ctx, time.monotonic() + LIMIT_S


def _join(tmp_path, world, started):
    """Every rank's results; the ranks are killed at the time limit."""
    ctx, deadline = started
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"{world} ranks did not finish within {LIMIT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(tmp_path / f"out.{r}", "rb") as f:
            out.append(pickle.load(f))
    assert not any(r.pop("jax imported") for r in out)
    return out


@pytest.fixture
def unfused_jax():
    """JAX's mesh tests pin fuse_qkv off (its mesh engines keep split
    carriers); the port fuses each rank's own cut."""
    from flexflow_tpu.config import config as jconfig

    prev = jconfig.fuse_qkv
    jconfig.fuse_qkv = False
    yield
    jconfig.fuse_qkv = prev


def _jax_params(kw, seed, bits=None):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.models import params as jp
    from flexflow_tpu.quant import quantize_params

    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = jspecs.MoESpec(num_experts=kw["moe"][0], top_k=kw["moe"][1])
    spec = jspecs.ModelSpec(**kw)
    params = jp.init_params(spec, jax.random.PRNGKey(seed), jnp.float32)
    if bits:
        params = quantize_params(spec, params, bits=bits, group_size=16,
                                 compute_dtype=jnp.float32)
    return spec, params, _numpy_tree(params)


def _numpy_tree(tree):
    """The ranks' copy of JAX's parameters: numpy arrays, and each quantized
    carrier as a dict of its fields (``params_from_numpy`` takes both), so
    unpickling it imports no JAX."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "group_size"):
        return {f: (np.asarray(getattr(tree, f)) if f in ("q", "scale", "offset")
                    and getattr(tree, f) is not None else getattr(tree, f))
                for f in ("q", "scale", "offset", "bits", "group_size", "shape", "batch_dims",
                          "contract_dims", "rest_pad")}
    return np.asarray(tree)


def _jax_tokens(spec, params, prompts, max_new, mesh=None, ssm=None, engine=None, **rm_kw):
    import jax.numpy as jnp

    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager
    from flexflow_tpu.serving.spec_manager import SpecRequestManager
    from flexflow_tpu.serving.speculative import SpecEngine

    gen = GenerationConfig(max_new_tokens=max_new)
    if ssm is not None:
        eng = SpecEngine(spec, params, spec, ssm, beam_width=2, beam_depth=3,
                         cache_dtype=jnp.float32, mesh=mesh, **ENGINE)
        return [r.output_tokens for r in SpecRequestManager(eng, fused=True).generate(
            prompts, gen)]
    eng = InferenceEngine(spec, params, cache_dtype=jnp.float32, mesh=mesh, **ENGINE,
                          **(engine or {}))
    return [r.output_tokens for r in RequestManager(eng, **rm_kw).generate(prompts, gen)]


def _all_ranks(results, name):
    got = [r[name] for r in results]
    assert all(g == got[0] for g in got), name
    return got[0]


def test_tp_dp_and_spec_over_four_ranks_equal_jax(tmp_path, unfused_jax):
    """T = 4, D = 2 x T = 2 and SpecEngine at D = 2 x T = 2 over 4 ranks."""
    prompts = _prompts()
    _, jparams, npp = _jax_params(SPEC, 0)
    js, jssm, nssm = _jax_params(SPEC, 3)
    base = dict(kind="serve", spec=SPEC, params=npp, prompts=prompts, max_new=24)
    cases = [dict(base, name="t4", mesh=(1, 1, 4)), dict(base, name="d2t2", mesh=(2, 1, 2)),
             dict(base, name="spec-d2t2", mesh=(2, 1, 2), ssm=nssm, prompts=prompts[:3],
                  max_new=16)]
    started = _start(tmp_path, 4, cases)
    want = _jax_tokens(js, jparams, prompts, 24)
    want_spec = _jax_tokens(js, jparams, prompts[:3], 16, ssm=jssm)
    res = _join(tmp_path, 4, started)
    assert _all_ranks(res, "t4") == want
    assert _all_ranks(res, "d2t2") == want
    assert _all_ranks(res, "spec-d2t2") == want_spec


def test_tp8_pipelined_and_jax_mesh_engine(tmp_path, unfused_jax):
    """T = 8 with a pipelined horizon of 8 against JAX's one-device engine,
    and D = 2 x T = 4 against JAX's mesh engine at make_mesh(data=2,
    model=4), over 8 ranks."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    prompts = _prompts(6)
    js, jparams, npp = _jax_params(SPEC, 1)
    pipe = dict(decode_horizon=8, pipelined=True)
    base = dict(kind="serve", spec=SPEC, params=npp, prompts=prompts, max_new=16)
    cases = [dict(base, name="t8", mesh=(1, 1, 8), rm=pipe),
             dict(base, name="d2t4", mesh=(2, 1, 4))]
    started = _start(tmp_path, 8, cases)
    want_t8 = _jax_tokens(js, jparams, prompts, 16, **pipe)
    want_mesh = _jax_tokens(js, jparams, prompts, 16, mesh=j_make_mesh(data=2, model=4))
    res = _join(tmp_path, 8, started)
    assert _all_ranks(res, "t8") == want_t8
    assert _all_ranks(res, "d2t4") == want_mesh


def test_refusals():
    """A context degree with the model axis is taken (past it the process
    group is asked for); ``SpecEngine`` on a pipe mesh names ``PipelineSpecEngine``, and PEFT
    with drafts under pipeline stages raises. Pipeline stages are taken
    (``test_torch_port_pp_serving``), as is LoRA under a mesh (the rank's
    cut of the stacks: ``test_torch_port_mesh_lora``), the PEFT CLI's mesh
    and offload under a mesh (``test_torch_port_mesh_layouts``)."""
    from flexflow_tpu_torch.inference import peft as peft_cli
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.mesh import Mesh, make_mesh
    from flexflow_tpu_torch.serve import LLM, SSM
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.speculative import SpecEngine

    with pytest.raises(RuntimeError, match="a 4-rank mesh needs a process group"):
        make_mesh(model=2, seq=2, device="cpu")
    drafted = LLM.__new__(LLM)
    drafted._ssms, drafted._peft, drafted.quant_bits = [SSM.__new__(SSM)], [None], None
    with pytest.raises(NotImplementedError, match="PEFT with speculative decoding under PP"):
        drafted.compile(pipeline_parallelism_degree=2)
    spec = _tspec(SPEC)
    params = tp.init_params(spec, 0)
    with pytest.raises(ValueError, match="PipelineSpecEngine"):
        SpecEngine(spec, params, spec, params, device="cpu", mesh=Mesh.fake(1, 1, 0, pipe=2))
    mesh = Mesh.fake(1, 2, 0)
    lora = {m: {"a": torch.zeros(2, 1, i, 4), "b": torch.zeros(2, 1, 4, 64)}
            for m, i in (("wq", 64), ("wd", 128))}
    eng = InferenceEngine(spec, params, device="cpu", mesh=mesh, lora=lora)
    assert eng.lora.b["wq"].shape == (2, 4, 32) and eng.lora.a["wd"].shape == (2, 64, 4)
    with pytest.raises(OSError):  # past the mesh: the model directory is read
        peft_cli.main(["-llm-model", "unused", "-tensor-parallelism-degree", "2",
                       "--device", "cpu"])


@pytest.mark.parametrize("kw", [dict(model=2), dict(data=2), dict(model=1),
                                dict(model=2, backend="gloo")])
def test_mesh_without_cuda_never_falls_back_to_the_cpu(monkeypatch, kw):
    """With no device named and no CUDA, ``make_mesh`` raises as
    ``resolve_device`` does (before any process group is made); only an
    explicit ``device="cpu"`` gives a CPU mesh."""
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(**kw, device="cuda")
    assert not dist.is_initialized()
