"""``LLM.compile`` and both CLIs with tensor / data parallel degrees over two
gloo ranks on the CPU (the helpers of ``test_torch_port_mesh_serving.py``):
they serve the one-device tokens, and the CLIs print the one-device text on
rank 0 and nothing on rank 1; ``--offload`` with ``-tensor-parallelism-degree
2`` prints the JAX CLI's text under the same flags.
"""

import contextlib
import io
import json

import torch
import transformers
from tokenizers import Tokenizer
from tokenizers import models as tok_models

from test_torch_port_mesh_serving import _all_ranks, _cli_text, _join, _start


def _tiny_model(tmp_path):
    """A tiny HF LLaMA directory (GQA) with a byte-level BPE tokenizer."""
    d = tmp_path / "model"
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast"}))
    return d


def test_llm_compile_and_clis_with_degrees(tmp_path):
    """``LLM.compile(tensor_parallelism_degree=2)`` and
    ``(data_parallelism_degree=2)`` serve the one-device tokens; both CLIs
    with ``-tensor-parallelism-degree 2`` / ``-data-parallelism-degree 2``
    print the one-device text on rank 0 and nothing on rank 1
    (``incr_decoding`` at T = 2, ``spec_infer`` at D = 2)."""
    d = _tiny_model(tmp_path)
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    cases = [dict(kind="llm"), dict(kind="cli", prompts=str(prompts))]
    res = _join(tmp_path, 2, _start(tmp_path, 2, cases, str(d)))
    one = _all_ranks(res, "llm-1x1")
    assert len(one[0]) == 6
    assert _all_ranks(res, "llm-2x1") == one and _all_ranks(res, "llm-1x2") == one
    def texts(out):  # each request's text, without its timing header
        return [chunk.split("\n", 1)[1] for chunk in out.split("=== guid")[1:]]

    for cli, deg in (("incr", "tp2"), ("spec", "dp2")):
        want = texts(res[0][f"{cli}-one"])
        assert len(want) == 2
        assert texts(res[0][f"{cli}-{deg}"]) == want, cli
        assert res[1][f"{cli}-{deg}"] == ""


def _texts(out):
    """Each request's text, without its timing header."""
    return [chunk.split("\n", 1)[1] for chunk in out.split("=== guid")[1:]]


def run_offload_cli(cases, model_dir):
    from flexflow_tpu_torch.inference import incr_decoding

    return {"offload-tp2": _cli_text(incr_decoding, cases[0]["argv"] + ["--device", "cpu"])}


def test_cli_offload_with_tensor_parallelism_prints_jax_text(tmp_path):
    """``--offload -tensor-parallelism-degree 2`` under two ranks (each pins
    and streams its cut of the layers) prints, on rank 0, the JAX CLI's text
    under the same flags (JAX's offload mesh engine), and nothing on rank 1."""
    from inference import incr_decoding as j_cli

    d = _tiny_model(tmp_path)
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", str(d), "-prompt", str(prompts), "--max-new-tokens", "12",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2", "--full-precision",
            "--offload", "-tensor-parallelism-degree", "2"]
    started = _start(tmp_path, 2, [dict(argv=argv)], str(d), runner=run_offload_cli)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_cli.main(argv) == 0
    res = _join(tmp_path, 2, started)
    got, want = res[0]["offload-tp2"], out.getvalue()
    assert len(_texts(got)) == 2 and res[1]["offload-tp2"] == ""
    assert _texts(got) == _texts(want)
