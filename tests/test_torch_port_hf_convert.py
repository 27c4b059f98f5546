"""The port's HF converters (``models/params.convert_hf_state_dict``) for
every architecture the JAX package converts: logits of tiny in-process
HuggingFace models (the recipes of ``tests/test_hf_alignment.py``) against
the port's float32 ``decoder.forward`` on the converted state dict, within
atol 2e-4 (Mixtral 5e-4, as there), rtol 1e-3, and greedy tokens equal.
Nothing is downloaded."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import decoder as td
from flexflow_tpu_torch.models import params as tp

transformers = pytest.importorskip("transformers")

torch.set_num_threads(2)

CASES = {
    "llama_gqa": ("LlamaConfig", "LlamaForCausalLM", 2e-4, dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128)),
    "opt": ("OPTConfig", "OPTForCausalLM", 2e-4, dict(
        vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=3,
        num_attention_heads=4, max_position_embeddings=64, do_layer_norm_before=True,
        word_embed_proj_dim=64)),
    "opt_post_ln": ("OPTConfig", "OPTForCausalLM", 2e-4, dict(
        vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=64, do_layer_norm_before=False,
        word_embed_proj_dim=32)),
    "falcon_mqa": ("FalconConfig", "FalconForCausalLM", 2e-4, dict(
        vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        multi_query=True, parallel_attn=True, new_decoder_architecture=False, bias=False,
        alibi=False)),
    "falcon_new_arch": ("FalconConfig", "FalconForCausalLM", 2e-4, dict(
        vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        num_kv_heads=2, multi_query=False, parallel_attn=True, new_decoder_architecture=True,
        bias=False, alibi=False)),
    "mpt_alibi": ("MptConfig", "MptForCausalLM", 2e-4, dict(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, expansion_ratio=2,
        max_seq_len=64)),
    "starcoder_mqa": ("GPTBigCodeConfig", "GPTBigCodeForCausalLM", 2e-4, dict(
        vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=64, multi_query=True)),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", 5e-4, dict(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converted_logits_match_hf(case):
    cfg_name, arch, atol, kw = CASES[case]
    cfg = getattr(transformers, cfg_name)(**kw)
    cfg.architectures = [arch]
    torch.manual_seed(0)
    model = getattr(transformers, arch)(cfg).eval()
    cfg_dict = cfg.to_dict()
    cfg_dict["architectures"] = cfg.architectures
    spec = tspecs.from_hf_config(cfg_dict)
    params = tp.convert_hf_state_dict(spec, model.state_dict())

    tokens = np.random.RandomState(0).randint(0, spec.vocab_size, size=(2, 12))
    with torch.no_grad():
        ref = model(input_ids=torch.tensor(tokens, dtype=torch.long)).logits.float().numpy()
        pos = torch.arange(tokens.shape[1])[None].expand(2, -1)
        got, _ = td.forward(spec, params, torch.tensor(tokens), pos)
    got = got.numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol, rtol=1e-3)
    assert (got.argmax(-1) == ref.argmax(-1)).all()
