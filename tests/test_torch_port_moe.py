"""The port's Mixtral (MoE) slice against the JAX package at float32:
``ops/moe.py`` (routing, dense and ragged forms), the expert index of the
quant-matmul, the decoder's MoE FFN (forward, forward_cached, fused
carriers), [L, E, D, F] carriers, the streaming quantized init and HF load,
served greedy tokens (horizon 1 and pipelined horizon 8, fp32 and INT8
group 32) and the CLI. Routing indices must be equal; outputs use the
tolerances of ``tests/test_hf_alignment.py::test_mixtral_ragged_matches_dense``
(atol 2e-5, rtol 1e-5) and ``tests/test_torch_port_decoder.py`` (1e-5)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import decoder as jd
from flexflow_tpu.models import params as jp
from flexflow_tpu.ops import moe as jmoe
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.quant import weight_only as jw
from flexflow_tpu.serving.engine import InferenceEngine as JEngine
from flexflow_tpu.serving.request_manager import GenerationConfig as JGen
from flexflow_tpu.serving.request_manager import RequestManager as JRM
from flexflow_tpu.utils import hf_weights as j_hf
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import decoder as td
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.ops import moe as tmoe
from flexflow_tpu_torch.ops.kernels.quant_matmul import LayerQuant, quant_matmul
from flexflow_tpu_torch.quant import QuantizedArray
from flexflow_tpu_torch.quant import weight_only as tw
from flexflow_tpu_torch.serving.engine import InferenceEngine as TEngine
from flexflow_tpu_torch.serving.request_manager import GenerationConfig as TGen
from flexflow_tpu_torch.serving.request_manager import RequestManager as TRM
from flexflow_tpu_torch.utils import hf_weights as t_hf

torch.set_num_threads(2)

E, K = 4, 2  # experts, top-k
KW = dict(arch="MixtralForCausalLM", vocab_size=96, hidden_size=64, num_layers=2,
          num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
          max_position_embeddings=128, norm_eps=1e-5, rope_theta=1e6)


def _specs(impl):
    return (jspecs.ModelSpec(**KW, moe=jspecs.MoESpec(E, K, impl=impl)),
            tspecs.ModelSpec(**KW, moe=tspecs.MoESpec(E, K, impl=impl)))


@pytest.fixture(scope="module")
def jparams():
    return jp.init_params(_specs("dense")[0], jax.random.PRNGKey(0), jnp.float32)


def _close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=1e-5)


def _moe_inputs(seed, n=24, d=64, f=128):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, d)).astype(np.float32)
    router = r.standard_normal((d, E)).astype(np.float32)
    wg, wu = (r.standard_normal((E, d, f)).astype(np.float32) * 0.1 for _ in range(2))
    wd = r.standard_normal((E, f, d)).astype(np.float32) * 0.1
    return x, router, wg, wu, wd


def test_route_topk_matches_jax():
    logits = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32) * 3
    jw_, ji = jmoe.route_topk(jnp.asarray(logits), 2)
    tw_, ti = tmoe.route_topk(torch.tensor(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw_, jw_, atol=1e-7)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_topk_ties_match_jax(k):
    """C5: rounded logits tie within most rows (equal logits give equal
    probabilities); the lower expert id comes first, as in JAX."""
    logits = np.round(np.random.default_rng(4).standard_normal((64, 8)) * 0.7)
    assert (np.sort(logits, -1)[:, 1:] == np.sort(logits, -1)[:, :-1]).any(-1).all()
    jw_, ji = jmoe.route_topk(jnp.asarray(logits, jnp.float32), k)
    tw_, ti = tmoe.route_topk(torch.tensor(logits, dtype=torch.float32), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw_, jw_, atol=1e-7)


@pytest.mark.parametrize("bits", [None, 8], ids=["fp32", "int8"])
@pytest.mark.parametrize("form", ["dense", "ragged"])
def test_moe_ffn_matches_jax(form, bits):
    """Each form against JAX's (ragged: ``moe_ffn_ragged``; dense:
    ``_moe_mlp``'s default branch), plain experts or INT8 [E, D, F]
    carriers (group 32) that JAX dequantizes; the routing is equal."""
    x, router, wg, wu, wd = _moe_inputs(1)
    jlogits = jnp.tensordot(jnp.asarray(x), jnp.asarray(router), axes=1)
    tlogits = torch.tensordot(torch.tensor(x), torch.tensor(router), dims=1)
    np.testing.assert_array_equal(tmoe.route_topk(tlogits, K)[1].numpy(),
                                  np.asarray(jmoe.route_topk(jlogits, K)[1]))
    jws = [jnp.asarray(w) for w in (wg, wu, wd)]
    tws = [torch.tensor(w) for w in (wg, wu, wd)]
    if bits:
        jws = [jw.as_array(jw.quantize(w, bits, 32, batch_dims=1, compute_dtype=jnp.float32))
               for w in jws]
        tws = [tw.quantize(w, bits, 32, batch_dims=1, compute_dtype=torch.float32) for w in tws]
    if form == "ragged":
        want = jmoe.moe_ffn_ragged(jnp.asarray(x), jlogits, *jws, K)
        got = tmoe.moe_ffn_ragged(torch.tensor(x), tlogits, *tws, K)
    else:
        p = {"router": jnp.asarray(router), "wg": jws[0], "wu": jws[1], "wd": jws[2]}
        want = jd._moe_mlp(_specs("dense")[0], p, jnp.asarray(x)[None])[0]
        got = tmoe.moe_ffn_dense(torch.tensor(x), tlogits, *tws, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_expert_index_equals_slicing(bits):
    """quant_matmul(layer=l, expert=e) on an [L, E, D, F] stack gives the
    product with that expert's own carrier exactly; the stack's slab at
    l * E + e is that carrier byte for byte."""
    r = np.random.default_rng(bits)
    w = torch.tensor(r.standard_normal((2, E, 64, 96)).astype(np.float32))
    x = torch.tensor(r.standard_normal((5, 64)).astype(np.float32))
    stack = tw.quantize(w, bits, 32, batch_dims=2, compute_dtype=torch.float32)
    for layer in range(2):
        for e in range(E):
            one = tw.quantize(w[layer, e], bits, 32, compute_dtype=torch.float32)
            assert torch.equal(stack.q[layer, e], one.q)
            assert torch.equal(quant_matmul(x, stack, layer=layer, expert=e), quant_matmul(x, one))
            assert torch.equal(tmoe.expert_matmul(x, LayerQuant(stack, layer), e),
                               quant_matmul(x, one))
    with pytest.raises(IndexError):
        quant_matmul(x, stack, layer=0, expert=E)
    with pytest.raises(ValueError):
        quant_matmul(x, stack, layer=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_moe_byte_identical(jparams, bits):
    """quantize_params on the MoE tree ([L, E, D, F] experts, batch_dims=2;
    the router stays full precision) equals JAX's byte for byte."""
    js, ts = _specs("dense")
    jq = jw.quantize_params(js, jparams, bits=bits, group_size=32, compute_dtype=jnp.float32)
    tq = tw.quantize_params(ts, tp.params_from_numpy(jax.tree.map(np.asarray, jparams)),
                            bits=bits, group_size=32, compute_dtype=torch.float32)
    assert not isinstance(tq["layers"]["router"], QuantizedArray)
    for name in ("wg", "wu", "wd", "wq", "wo"):
        t, j = tq["layers"][name], jq["layers"][name]
        assert t.batch_dims == j.batch_dims == (2 if name in ("wg", "wu", "wd") else 1)
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_forward_matches_jax(jparams, impl):
    """Prefill with padded rows (compared on valid rows; the ragged form
    drops the padding), flash and plain attention."""
    js, ts = _specs(impl)
    tparams = tp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    r = np.random.default_rng(1)
    tok = r.integers(0, 96, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    lens = np.array([12, 7], np.int32)
    jl, (jk, jv) = jd.forward(js, jparams, jnp.asarray(tok), jnp.asarray(pos),
                              lengths=jnp.asarray(lens), return_kv=True)
    for flash in (True, False):
        tl, (tk, tv) = td.forward(ts, tparams, torch.tensor(tok), torch.tensor(pos),
                                  lengths=torch.tensor(lens), return_kv=True, flash=flash)
        for i, n in enumerate(lens):
            _close(tl[i, :n], np.asarray(jl)[i, :n])
            _close(tk[:, i, :n], np.asarray(jk)[:, i, :n])
            _close(tv[:, i, :n], np.asarray(jv)[:, i, :n])


def _jcache(spec, b, s, seed):
    r = np.random.default_rng(seed)
    shape = (spec.num_layers, b, spec.num_kv_heads, spec.head_dim, s)
    return jd.KVCache(jnp.asarray(r.standard_normal(shape), jnp.float32),
                      jnp.asarray(r.standard_normal(shape), jnp.float32))


@pytest.mark.parametrize("t", [1, 3], ids=["decode", "chunk"])
@pytest.mark.parametrize("impl", ["dense", "ragged"])
def test_forward_cached_matches_jax(jparams, impl, t):
    js, ts = _specs(impl)
    tparams = tp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    r = np.random.default_rng(2)
    tok = r.integers(0, 96, (3, t)).astype(np.int32)
    lens = np.array([4, 0, 20], np.int32)
    jc = _jcache(js, 3, 32, 3)
    tc = tp.kv_cache_from_numpy(np.asarray(jc.k), np.asarray(jc.v))
    jl, jout = jd.forward_cached(js, jparams, jnp.asarray(tok), jc, jnp.asarray(lens))
    tl, tout = td.forward_cached(ts, tparams, torch.tensor(tok), tc, torch.tensor(lens))
    _close(tl, jl)
    want = tp.kv_cache_from_numpy(np.asarray(jout.k), np.asarray(jout.v))
    _close(tout.k, want.k.numpy())
    _close(tout.v, want.v.numpy())


@pytest.mark.parametrize("bits", [None, 8], ids=["fp32", "int8"])
def test_fused_carriers_keep_the_experts(jparams, bits):
    """fuse_qkv_params fuses wq|wk|wv for Mixtral and leaves the experts
    unfused (as JAX does); decode logits agree with JAX's fused tree."""
    js, ts = _specs("dense")
    params = jparams
    if bits:
        params = j_quant_params(js, jparams, bits=bits, group_size=32, compute_dtype=jnp.float32)
    jf = jd.fuse_qkv_params(js, params)
    tf = td.fuse_qkv_params(ts, tp.params_from_numpy(
        params if bits else jax.tree.map(np.asarray, params)))
    assert "wqkv" in tf["layers"] and "wgu" not in tf["layers"] and "wg" in tf["layers"]
    tok = np.array([[3], [7]], np.int32)
    lens = np.array([3, 5], np.int32)
    jc = _jcache(js, 2, 16, 7)
    jl, _ = jd.forward_cached(js, jf, jnp.asarray(tok), jc, jnp.asarray(lens))
    tl, _ = td.forward_cached(ts, tf, torch.tensor(tok),
                              tp.kv_cache_from_numpy(np.asarray(jc.k), np.asarray(jc.v)),
                              torch.tensor(lens))
    _close(tl, jl)


PROMPTS = [[5, 17, 3, 90, 42], [1] * 17, [8, 9, 10, 11, 12, 13, 14, 15, 16]]


def _serve(jax_side, spec, params, horizon, pipelined, max_new=12):
    kw = dict(max_requests_per_batch=2, max_seq_len=64)
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


@pytest.mark.parametrize("impl,bits,horizon,pipelined", [
    ("dense", None, 1, False), ("dense", None, 8, True), ("dense", 8, 1, False),
    ("dense", 8, 8, True), ("ragged", None, 8, True), ("ragged", 8, 1, False),
], ids=["dense-fp32-h1", "dense-fp32-h8-pipe", "dense-int8-h1", "dense-int8-h8-pipe",
        "ragged-fp32-h8-pipe", "ragged-int8-h1"])
def test_greedy_tokens_equal_jax(jparams, impl, bits, horizon, pipelined):
    """Served Mixtral tokens equal JAX's RequestManager's (INT8: group 32)."""
    js, ts = _specs(impl)
    params = jparams
    if bits:
        params = j_quant_params(js, jparams, bits=bits, group_size=32, compute_dtype=jnp.float32)
        tparams = tp.params_from_numpy(params)
    else:
        tparams = tp.params_from_numpy(jax.tree.map(np.asarray, params))
    want = _serve(True, js, params, horizon, pipelined)
    got = _serve(False, ts, tparams, horizon, pipelined)
    assert got == want
    assert all(len(t) == 12 for t in got)


def test_ragged_engine_is_never_replayed():
    """A ragged-MoE engine captures nothing (its group sizes are read on the
    host); asking it to replay raises instead of capturing."""
    _, ts = _specs("ragged")
    eng = TEngine(ts, tp.init_params(ts, 0), max_requests_per_batch=2, max_seq_len=32,
                  cache_dtype=torch.float32, device="cpu")
    assert eng.graphs is None
    with pytest.raises(ValueError):
        eng.greedy_horizon_async([1, 2], [3, 4], 1, replay=True)


def test_streaming_quantized_init():
    """init_quantized_params: init_params' leaves, with every matmul weight
    an INT8 carrier in quantize_params' layout (experts [L, E, ...],
    batch_dims 2, contiguous), Glorot-scaled, and a forward through it."""
    _, ts = _specs("dense")
    qp = tp.init_quantized_params(ts, 0, bits=8, group_size=32, dtype=torch.float32)
    ref = tw.quantize_params(ts, tp.init_params(ts, 0), bits=8, group_size=32,
                             compute_dtype=torch.float32)
    assert set(qp) == set(ref) and set(qp["layers"]) == set(ref["layers"])
    layer_leaves, _ = tp._leaves(ts)
    for name, want in ref["layers"].items():
        got = qp["layers"][name]
        assert type(got) is type(want)
        if isinstance(want, QuantizedArray):
            assert (got.shape, got.batch_dims, got.contract_dims, got.group_size, got.rest_pad,
                    got.q.shape, got.q.dtype, got.scale.shape) == (
                want.shape, want.batch_dims, want.contract_dims, want.group_size, want.rest_pad,
                want.q.shape, want.q.dtype, want.scale.shape)
            assert got.q.is_contiguous() and got.scale.is_contiguous()
            fan_in, fan_out = layer_leaves[name][1]
            std = tw.dequantize(got).std().item()
            assert abs(std / np.sqrt(2.0 / (fan_in + fan_out)) - 1) < 0.1, name
        else:
            assert got.shape == want.shape and got.dtype == want.dtype
    assert isinstance(qp["lm_head"], QuantizedArray)
    tok = torch.tensor([[3, 17, 91, 5, 8, 13]])
    pos = torch.arange(6)[None]
    logits, _ = td.forward(ts, qp, tok, pos)
    assert logits.shape == (1, 6, 96) and bool(torch.isfinite(logits).all())


@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    """A tiny HF Mixtral directory (2 layers, d 64, F 128, 4 experts, top-2,
    4 heads, 2 KV heads) with a byte-level BPE tokenizer, saved as bf16
    safetensors."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_mixtral")
    torch.manual_seed(0)
    cfg = transformers.MixtralConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     num_key_value_heads=2, num_local_experts=E,
                                     num_experts_per_tok=K, max_position_embeddings=128)
    cfg.architectures = ["MixtralForCausalLM"]
    transformers.MixtralForCausalLM(cfg).to(torch.bfloat16).save_pretrained(
        d, safe_serialization=True)
    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "tokenizer.json"))
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
    return str(d)


def test_hf_load_matches_jax(mixtral_dir):
    """The Mixtral converter gives the JAX loader's parameters leaf for leaf."""
    jspec, jparams_ = j_hf.load_params(mixtral_dir, dtype=jnp.float32)
    tspec, tparams = t_hf.load_params(mixtral_dir, dtype=torch.float32)
    assert json.dumps(jspec.__dict__, default=str) == json.dumps(tspec.__dict__, default=str)
    jflat = jax.tree_util.tree_flatten_with_path(jparams_)[0]
    assert len(jflat) == sum(len(v) if isinstance(v, dict) else 1 for v in tparams.values())
    for path, leaf in jflat:
        got = tparams
        for k in [p.key for p in path]:
            got = got[k]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("bits", [8, 4])
def test_streaming_quantized_load_byte_identical(mixtral_dir, bits):
    """Quantize-on-load, layer by layer, gives the carriers of converting
    the whole tree and then calling quantize_params, byte for byte (bf16
    compute dtype, as served)."""
    spec, streamed = t_hf.load_params(mixtral_dir, dtype=torch.bfloat16, quantize_bits=bits,
                                      quantize_group_size=32)
    whole = tw.quantize_params(
        spec, tp.convert_hf_state_dict(spec, t_hf.LazyStateDict(mixtral_dir), torch.bfloat16),
        bits=bits, group_size=32, compute_dtype=torch.bfloat16)
    flat = {**{k: v for k, v in whole.items() if k != "layers"}, **whole["layers"]}
    got = {**{k: v for k, v in streamed.items() if k != "layers"}, **streamed["layers"]}
    assert set(got) == set(flat)
    for name, want in flat.items():
        if isinstance(want, QuantizedArray):
            g = got[name]
            assert (g.shape, g.batch_dims, g.contract_dims, g.group_size, g.rest_pad, g.bits) == (
                want.shape, want.batch_dims, want.contract_dims, want.group_size, want.rest_pad,
                want.bits)
            for f in ("q", "scale", "offset"):
                a, b = getattr(g, f), getattr(want, f)
                assert (a is None and b is None) or torch.equal(a, b), (name, f)
        else:
            assert torch.equal(got[name], want), name


def test_cli_matches_jax_cli(mixtral_dir, tmp_path, capsys):
    from flexflow_tpu_torch.inference import incr_decoding as t_cli
    from inference import incr_decoding as j_cli

    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", mixtral_dir, "-prompt", str(prompts), "--max-new-tokens", "16",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2",
            "--full-precision"]
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.count("=== guid") == 2
    texts = [[ln for ln in out.splitlines() if not ln.startswith("=== guid")]
             for out in (got, want)]
    assert texts[0] == texts[1]


def test_router_rows_do_not_depend_on_the_row_count():
    """The router logits of a row are the same bits in a call of 8 rows, of
    104 (a speculative verify's 8 x 13) and of 300, wherever the row sits,
    and within 1e-5 of JAX's f32 router GEMM."""
    r = np.random.default_rng(8)
    x = r.standard_normal((300, 64)).astype(np.float32)
    router = r.standard_normal((64, E)).astype(np.float32)
    tx, tr = torch.tensor(x), torch.tensor(router)
    full = tmoe.router_logits(tx, tr)
    assert torch.equal(tmoe.router_logits(tx[:8], tr), full[:8])
    assert torch.equal(tmoe.router_logits(tx[96:200], tr), full[96:200])
    perm = torch.randperm(300, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tmoe.router_logits(tx[perm], tr), full[perm])
    _close(full, jnp.asarray(x) @ jnp.asarray(router))
