"""The port's (verifier, draft) pair construction against the JAX package's
``benchmarks/spec_pair.embed_draft_in_verifier`` (leaf for leaf, and the
quantized carriers byte for byte), the embedded verifier's function, and the
port's speculative CLI against its incremental CLI."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.spec_pair import embed_draft_in_verifier as j_embed
from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import decoder as td
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.quant import QuantizedArray
from flexflow_tpu_torch.utils.spec_pair import embed_draft_in_verifier

torch.set_num_threads(2)


def _kw(d, l, h, kh, f):
    return dict(arch="LlamaForCausalLM", vocab_size=128, hidden_size=d, num_layers=l,
                num_heads=h, num_kv_heads=kh, head_dim=16, intermediate_size=f,
                max_position_embeddings=256, norm_eps=1e-6)


DRAFT, VERIFIER = _kw(32, 2, 2, 1, 64), _kw(128, 4, 8, 4, 160)  # GQA, G = 2 in both


@pytest.fixture(scope="module")
def draft():
    jparams = jp.init_params(jspecs.ModelSpec(**DRAFT), jax.random.PRNGKey(0), jnp.float32)
    return jparams, tp.params_from_numpy(jax.tree.map(np.asarray, jparams))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_embedded_verifier_equals_jax_leaf_for_leaf(draft):
    want = j_embed(jspecs.ModelSpec(**DRAFT), draft[0], jspecs.ModelSpec(**VERIFIER),
                   dtype=jnp.float32)
    got = embed_draft_in_verifier(tspecs.ModelSpec(**DRAFT), draft[1],
                                  tspecs.ModelSpec(**VERIFIER), dtype=torch.float32)
    w, g = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(w) == sorted(g)
    for name in w:
        assert torch.equal(g[name], torch.tensor(np.asarray(w[name]))), name


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_verifier_carriers_equal_jax(draft, bits):
    """Built and quantized layer by layer, the carriers equal JAX's
    ``quantize_params`` of the whole embedded verifier byte for byte."""
    jv = j_quant_params(jspecs.ModelSpec(**VERIFIER),
                        j_embed(jspecs.ModelSpec(**DRAFT), draft[0],
                                jspecs.ModelSpec(**VERIFIER), dtype=jnp.float32),
                        bits=bits, group_size=32, compute_dtype=jnp.float32)
    want = tp.params_from_numpy(jv)
    got = embed_draft_in_verifier(tspecs.ModelSpec(**DRAFT), draft[1],
                                  tspecs.ModelSpec(**VERIFIER), bits=bits, group_size=32,
                                  dtype=torch.float32)
    for name, w in dict(_leaves(want)).items():
        g = dict(_leaves(got))[name]
        if isinstance(w, QuantizedArray):
            assert isinstance(g, QuantizedArray), name
            assert (g.bits, g.group_size, g.shape, g.batch_dims, g.contract_dims, g.rest_pad) == (
                w.bits, w.group_size, w.shape, w.batch_dims, w.contract_dims, w.rest_pad), name
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale), name
            assert (g.offset is None) == (w.offset is None), name
            assert g.offset is None or torch.equal(g.offset, w.offset), name
        else:
            assert torch.equal(g, w), name


def test_embedded_verifier_computes_the_draft(draft):
    """Prefill and one cached step: the verifier's logits within 1e-4 of the
    draft's, same greedy tokens. The only difference is the norm epsilon,
    which the verifier's wider mean scales by dv/dd; embedding rows of unit
    RMS (as a trained model's hidden states are) keep that below 1e-5."""
    ds, vs = tspecs.ModelSpec(**DRAFT), tspecs.ModelSpec(**VERIFIER)
    dparams = dict(draft[1])
    emb = dparams["embed_tokens"]
    dparams["embed_tokens"] = emb / emb.pow(2).mean(-1, keepdim=True).sqrt()
    vparams = embed_draft_in_verifier(ds, dparams, vs, dtype=torch.float32)
    toks = torch.tensor(np.random.default_rng(1).integers(0, 128, (2, 9)))
    pos = torch.arange(9, dtype=torch.int32)[None].expand(2, 9)
    outs = []
    for spec, params in ((ds, dparams), (vs, vparams)):
        logits, (k, v) = td.forward(spec, params, toks, pos, return_kv=True)
        cache = td.init_kv_cache(spec, 2, 16, torch.float32)
        td.commit_kv_windows(cache.k, cache.v, k.permute(0, 1, 3, 2, 4),
                             v.permute(0, 1, 3, 2, 4), [0, 0])
        step, _ = td.forward_cached(spec, params, toks[:, :1], cache,
                                    torch.tensor([9, 9], dtype=torch.int32))
        outs.append(torch.cat([logits, step], dim=1))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(outs[1].argmax(-1), outs[0].argmax(-1))


def test_pair_checks(draft):
    bad = tspecs.ModelSpec(**_kw(128, 4, 8, 8, 160))  # G = 1 against the draft's 2
    with pytest.raises(ValueError, match="GQA"):
        embed_draft_in_verifier(tspecs.ModelSpec(**DRAFT), draft[1], bad)
    with pytest.raises(ValueError, match="cannot embed"):
        embed_draft_in_verifier(tspecs.ModelSpec(**VERIFIER), draft[1], tspecs.ModelSpec(**DRAFT))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny HF LLaMA directory (2 layers, d=64) with a character tokenizer."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_llama_spec_cli")
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


def test_spec_cli_matches_incremental_cli(model_dir, tmp_path, capsys):
    """The port's spec_infer (the model as its own draft) prints the text
    of the port's incr_decoding at --full-precision on the CPU."""
    from flexflow_tpu_torch.inference import incr_decoding, spec_infer

    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", model_dir, "-prompt", str(prompts), "--max-new-tokens", "16",
            "--max-sequence-length", "128", "--max-requests-per-batch", "2",
            "--full-precision", "--device", "cpu"]
    assert incr_decoding.main(argv) == 0
    want = capsys.readouterr().out
    assert spec_infer.main(argv + ["-ssm-model", model_dir]) == 0
    got = capsys.readouterr().out
    assert got.count("=== guid") == 2 and "verified/step" in got
    texts = [[line for line in out.splitlines() if not line.startswith("=== guid")]
             for out in (got, want)]
    assert texts[0] == texts[1]
    # two drafts (the model twice), rotated: the same text
    assert spec_infer.main(argv + ["-ssm-model", model_dir, "-ssm-model", model_dir]) == 0
    two = capsys.readouterr().out
    assert [line for line in two.splitlines() if not line.startswith("=== guid")] == texts[1]
