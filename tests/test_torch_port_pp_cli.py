"""``LLM.compile(pipeline_parallelism_degree=2)``, with and without a draft
model, and ``incr_decoding --pp 2`` / ``spec_infer --pp 2`` over two gloo
ranks on the CPU (the helpers of ``test_torch_port_mesh_serving.py``, the
tiny model of ``test_torch_port_mesh_cli.py``): the one-device tokens and
JAX's, and on rank 0 the JAX CLI's text under ``-pipeline-parallelism-degree
2`` (JAX's pipeline engines), nothing on rank 1; merged trees under
pipeline stages raise JAX's words.
"""

import contextlib
import io
import json

import pytest

from test_torch_port_mesh_cli import _texts, _tiny_model
from test_torch_port_mesh_serving import _all_ranks, _cli_text, _join, _start

PROMPTS = [[1, 5, 9, 12], [3, 4]]


SPEC_ARGS = ["--max-sequence-length", "128"]  # room for the speculation margin


def run_pp_cli(cases, model_dir):
    from flexflow_tpu_torch.inference import incr_decoding, spec_infer
    from flexflow_tpu_torch.serve import LLM, SSM

    llm = LLM(model_dir, data_type="float32", device="cpu")
    llm.compile(max_requests_per_batch=2, max_seq_length=64, pipeline_parallelism_degree=2)
    held = sorted(k for k in llm.params if k != "layers")
    out = {"llm-pp2": [r.output_tokens for r in llm.generate(PROMPTS, max_new_tokens=6)],
           "top": held, "depth": llm.rm.engine.cache.k.shape[0]}
    spec = LLM(model_dir, data_type="float32", device="cpu")
    spec.compile(max_requests_per_batch=2, max_seq_length=128, pipeline_parallelism_degree=2,
                 ssms=[SSM(model_dir, data_type="float32", device="cpu")])
    out.update({"spec-pp2": [r.output_tokens for r in spec.generate(PROMPTS, max_new_tokens=6)],
                "engine": type(spec.rm.engine).__name__,
                "spec-depth": spec.rm.engine.llm_cache.k.shape[0]})
    argv = cases[0]["argv"] + ["--device", "cpu", "--pp", "2"]
    out["cli-pp2"] = _cli_text(incr_decoding, argv)
    out["spec-cli-pp2"] = _cli_text(spec_infer, argv + ["-ssm-model", model_dir] + SPEC_ARGS)
    return out


def test_llm_compile_and_cli_with_pipeline_degree(tmp_path):
    """Two ranks: ``LLM.compile(pipeline_parallelism_degree=2)`` serves the
    one-device tokens, each rank loading one of the two layers (stage 0
    the embeddings, stage 1 the head); with ``ssms=[...]`` it serves
    through ``PipelineSpecEngine`` the tokens of JAX's ``LLM`` under the same
    call; ``incr_decoding --pp 2`` and ``spec_infer --pp 2`` print the JAX
    CLIs' text on rank 0 and nothing on rank 1; merged trees of two drafts
    under pipeline stages raise JAX's words before a mesh is made."""
    import flexflow_tpu.serve as j_serve
    from inference import incr_decoding as j_cli
    from flexflow_tpu.serving import GenerationConfig
    from inference import spec_infer as j_spec_cli

    from flexflow_tpu_torch.serve import LLM, SSM

    d = _tiny_model(tmp_path)
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", str(d), "-prompt", str(prompts), "--max-new-tokens", "12",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2", "--full-precision"]
    started = _start(tmp_path, 2, [dict(argv=argv)], str(d), runner=run_pp_cli)
    one = LLM(str(d), data_type="float32", device="cpu")
    one.compile(max_requests_per_batch=2, max_seq_length=64)
    want = [r.output_tokens for r in one.generate(PROMPTS, max_new_tokens=6)]
    pp2 = ["-pipeline-parallelism-degree", "2"]
    out, spec_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_cli.main(argv + pp2) == 0
    with contextlib.redirect_stdout(spec_out):
        assert j_spec_cli.main(argv + pp2 + ["-ssm-model", str(d)] + SPEC_ARGS) == 0
    j_llm = j_serve.LLM(str(d), data_type="float32")
    j_llm.compile(max_requests_per_batch=2, max_seq_length=128, pipeline_parallelism_degree=2,
                  ssms=[j_serve.SSM(str(d), data_type="float32")])
    want_spec = [r.output_tokens for r in j_llm.rm.generate(  # token ids, as the port's LLM takes
        PROMPTS, GenerationConfig(max_new_tokens=6))]
    merged = LLM(str(d), data_type="float32", device="cpu")
    with pytest.raises(NotImplementedError, match="merge_ssm_trees with pipeline parallelism is "
                                                  "not supported; use rotation"):
        merged.compile(pipeline_parallelism_degree=2, merge_ssm_trees=True,
                       ssms=[SSM(str(d), device="cpu"), SSM(str(d), device="cpu")])
    res = _join(tmp_path, 2, started)
    assert len(want[0]) == 6 and _all_ranks(res, "llm-pp2") == want
    assert res[0]["top"] == ["embed_tokens"] and res[1]["top"] == ["final_norm_scale", "lm_head"]
    assert res[0]["depth"] == res[1]["depth"] == 1
    assert _all_ranks(res, "engine") == "PipelineSpecEngine"
    assert res[0]["spec-depth"] == res[1]["spec-depth"] == 1
    assert _all_ranks(res, "spec-pp2") == want_spec and want_spec[0][:6] == want[0]
    for key, jax_text in (("cli-pp2", out), ("spec-cli-pp2", spec_out)):
        got = res[0][key]
        assert len(_texts(got)) == 2 and res[1][key] == "", key
        assert _texts(got) == _texts(jax_text.getvalue()), key
