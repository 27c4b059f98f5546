"""The whole slice: the port's InferenceEngine + RequestManager give the
JAX package's greedy tokens exactly at float32 (tiny LLaMA, MHA and GQA,
unquantized and INT8, horizon 1 and pipelined horizon 8), and the port's CLI
prints the JAX CLI's text at --full-precision."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.serving.engine import InferenceEngine as JEngine
from flexflow_tpu.serving.request_manager import GenerationConfig as JGen
from flexflow_tpu.serving.request_manager import RequestManager as JRM
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.serving.engine import InferenceEngine as TEngine
from flexflow_tpu_torch.serving.request_manager import GenerationConfig as TGen
from flexflow_tpu_torch.serving.request_manager import RequestManager as TRM

torch.set_num_threads(2)

PROMPTS = [[5, 17, 3, 99, 42], [1] * 17, [8, 9, 10, 11, 12, 13, 14, 15, 16]]


def _models(kh, bits):
    kw = dict(arch="LlamaForCausalLM", vocab_size=128, hidden_size=64, num_layers=2,
              num_heads=4, num_kv_heads=kh, head_dim=16, intermediate_size=128,
              max_position_embeddings=256, norm_eps=1e-6)
    jparams = jp.init_params(jspecs.ModelSpec(**kw), jax.random.PRNGKey(kh), jnp.float32)
    if bits:
        jparams = j_quant_params(jspecs.ModelSpec(**kw), jparams, bits=bits, group_size=32,
                                 compute_dtype=jnp.float32)
        tparams = tp.params_from_numpy(jparams)
    else:
        tparams = tp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jspecs.ModelSpec(**kw), jparams, tspecs.ModelSpec(**kw), tparams


def _serve(jax_side, spec, params, horizon, pipelined, max_new=12, **engine_kw):
    kw = dict(max_requests_per_batch=2, max_seq_len=64, **engine_kw)
    if jax_side:
        rm = JRM(JEngine(spec, params, cache_dtype=jnp.float32, **kw),
                 decode_horizon=horizon, pipelined=pipelined)
        return [r.output_tokens for r in rm.generate(PROMPTS, JGen(max_new_tokens=max_new))]
    rm = TRM(TEngine(spec, params, cache_dtype=torch.float32, device="cpu", **kw),
             decode_horizon=horizon, pipelined=pipelined)
    try:
        return [r.output_tokens for r in rm.generate(PROMPTS, TGen(max_new_tokens=max_new))]
    finally:
        rm.close()


@pytest.mark.parametrize("horizon,pipelined", [(1, False), (8, True)], ids=["h1", "h8-pipe"])
@pytest.mark.parametrize("bits", [None, 8], ids=["fp32", "int8"])
@pytest.mark.parametrize("kh", [4, 2], ids=["mha", "gqa"])
def test_greedy_tokens_equal_jax(kh, bits, horizon, pipelined):
    js, jparams, ts, tparams = _models(kh, bits)
    want = _serve(True, js, jparams, horizon, pipelined)
    got = _serve(False, ts, tparams, horizon, pipelined)
    assert got == want
    assert all(len(t) == 12 for t in got)


def test_chunked_prefill_and_int4_equal_jax():
    """Chunked prefill (8-token budget) through the plain cached path, and
    the INT4 format through qmm_int4's plain version (CPU tensors)."""
    js, jparams, ts, tparams = _models(2, 4)
    want = _serve(True, js, jparams, 4, True, max_tokens_per_batch=8)
    got = _serve(False, ts, tparams, 4, True, max_tokens_per_batch=8)
    assert got == want


def test_stop_tokens_and_budget():
    _, _, ts, tparams = _models(4, None)
    rm = TRM(TEngine(ts, tparams, max_requests_per_batch=2, max_seq_len=64,
                     cache_dtype=torch.float32, device="cpu"), decode_horizon=4, pipelined=True)
    try:
        [free] = rm.generate([PROMPTS[0]], TGen(max_new_tokens=10))
        stop = free.output_tokens[3]
        [cut] = rm.generate([PROMPTS[0]], TGen(max_new_tokens=10, stop_token_ids=(stop,)))
    finally:
        rm.close()
    first = free.output_tokens.index(stop)
    assert cut.output_tokens == free.output_tokens[:first + 1]
    assert cut.state == "COMPLETED" and free.profile.ttft >= 0


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny HF LLaMA directory (2 layers, d=64) with a byte-level BPE
    tokenizer, saved as safetensors."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_llama_cli")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=4, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "tokenizer.json"))
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
    return str(d)


def _texts(out: str):
    return [line for line in out.splitlines() if not line.startswith("=== guid")]


def test_cli_matches_jax_cli(model_dir, tmp_path, capsys):
    from flexflow_tpu_torch.inference import incr_decoding as t_cli
    from inference import incr_decoding as j_cli

    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", model_dir, "-prompt", str(prompts), "--max-new-tokens", "16",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2",
            "--full-precision"]
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.count("=== guid") == 2
    assert _texts(got) == _texts(want)
