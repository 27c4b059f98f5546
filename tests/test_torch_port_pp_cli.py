"""``LLM.compile(pipeline_parallelism_degree=2)`` and ``incr_decoding --pp 2``
over two gloo ranks on the CPU (the helpers of
``test_torch_port_mesh_serving.py``, the tiny model of
``test_torch_port_mesh_cli.py``): the one-device tokens, and on rank 0 the
JAX CLI's text under ``-pipeline-parallelism-degree 2`` (JAX's pipeline
engine), nothing on rank 1; ``spec_infer --pp 2`` names A9b.
"""

import contextlib
import io
import json

import pytest

from test_torch_port_mesh_cli import _texts, _tiny_model
from test_torch_port_mesh_serving import _all_ranks, _cli_text, _join, _start

PROMPTS = [[1, 5, 9, 12], [3, 4]]


def run_pp_cli(cases, model_dir):
    from flexflow_tpu_torch.inference import incr_decoding
    from flexflow_tpu_torch.serve import LLM

    llm = LLM(model_dir, data_type="float32", device="cpu")
    llm.compile(max_requests_per_batch=2, max_seq_length=64, pipeline_parallelism_degree=2)
    held = sorted(k for k in llm.params if k != "layers")
    return {"llm-pp2": [r.output_tokens for r in llm.generate(PROMPTS, max_new_tokens=6)],
            "top": held, "depth": llm.rm.engine.cache.k.shape[0],
            "cli-pp2": _cli_text(incr_decoding, cases[0]["argv"] + ["--device", "cpu", "--pp", "2"])}


def test_llm_compile_and_cli_with_pipeline_degree(tmp_path):
    """Two ranks: ``LLM.compile(pipeline_parallelism_degree=2)`` serves the
    one-device tokens, each rank loading one of the two layers (stage 0
    the embeddings, stage 1 the head); ``incr_decoding --pp 2`` prints the
    JAX CLI's text on rank 0 and nothing on rank 1; ``spec_infer --pp 2``
    refuses (A9b) before it makes a mesh."""
    from inference import incr_decoding as j_cli

    from flexflow_tpu_torch.inference import spec_infer
    from flexflow_tpu_torch.serve import LLM

    d = _tiny_model(tmp_path)
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", str(d), "-prompt", str(prompts), "--max-new-tokens", "12",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2", "--full-precision"]
    started = _start(tmp_path, 2, [dict(argv=argv)], str(d), runner=run_pp_cli)
    one = LLM(str(d), data_type="float32", device="cpu")
    one.compile(max_requests_per_batch=2, max_seq_length=64)
    want = [r.output_tokens for r in one.generate(PROMPTS, max_new_tokens=6)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_cli.main(argv + ["-pipeline-parallelism-degree", "2"]) == 0
    with pytest.raises(NotImplementedError, match="A9b"):
        spec_infer.main(argv + ["-ssm-model", str(d), "--device", "cpu", "--pp", "2"])
    res = _join(tmp_path, 2, started)
    assert len(want[0]) == 6 and _all_ranks(res, "llm-pp2") == want
    assert res[0]["top"] == ["embed_tokens"] and res[1]["top"] == ["final_norm_scale", "lm_head"]
    assert res[0]["depth"] == res[1]["depth"] == 1
    got = res[0]["cli-pp2"]
    assert len(_texts(got)) == 2 and res[1]["cli-pp2"] == ""
    assert _texts(got) == _texts(out.getvalue())
