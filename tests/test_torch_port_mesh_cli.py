"""``LLM.compile`` and both CLIs with tensor / data parallel degrees over two
gloo ranks on the CPU (the helpers of ``test_torch_port_mesh_serving.py``):
they serve the one-device tokens, and the CLIs print the one-device text on
rank 0 and nothing on rank 1.
"""

import json

import torch
import transformers
from tokenizers import Tokenizer
from tokenizers import models as tok_models

from test_torch_port_mesh_serving import _all_ranks, _join, _start


def test_llm_compile_and_clis_with_degrees(tmp_path):
    """``LLM.compile(tensor_parallelism_degree=2)`` and
    ``(data_parallelism_degree=2)`` serve the one-device tokens; both CLIs
    with ``-tensor-parallelism-degree 2`` / ``-data-parallelism-degree 2``
    print the one-device text on rank 0 and nothing on rank 1
    (``incr_decoding`` at T = 2, ``spec_infer`` at D = 2)."""
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
