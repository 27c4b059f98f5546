"""CPU offload (A7b): the port's ``InferenceEngine(offload=True)`` (layer
stack in host memory, two staged device slots, ``models/layer_store.py``)
against the JAX package's ``InferenceEngine(offload=True)`` on the CPU, at
float32: greedy tokens equal for dense LLaMA, INT8 and INT4 (group 32, f32
activations), a tiny Mixtral, LoRA and chunked prefill. Against the port's
own resident engine the logits are bitwise equal (prefill, decode across
several forwards, chunked, MoE, LoRA). Also: an offload engine captures no
graph, ``LLM.compile(offload=True)`` with drafts raises, and ``--offload``
through the port's CLI prints the JAX CLI's text."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.peft import lora as jl
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.serving.engine import InferenceEngine as JEngine
from flexflow_tpu.serving.request_manager import GenerationConfig as JGen
from flexflow_tpu.serving.request_manager import RequestManager as JRM
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import decoder as td
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.peft import lora as tl
from flexflow_tpu_torch.serving.engine import InferenceEngine as TEngine
from flexflow_tpu_torch.serving.graphs import capturable
from flexflow_tpu_torch.models.layer_store import LayerStore
from flexflow_tpu_torch.serving.request_manager import GenerationConfig as TGen
from flexflow_tpu_torch.serving.request_manager import RequestManager as TRM

torch.set_num_threads(2)

LLAMA = dict(arch="LlamaForCausalLM", vocab_size=128, hidden_size=64, num_layers=3,
             num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
             max_position_embeddings=256, norm_eps=1e-6)
MIXTRAL = dict(arch="MixtralForCausalLM", vocab_size=96, hidden_size=64, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
               max_position_embeddings=128, norm_eps=1e-5, rope_theta=1e6)
PROMPTS = [[5, 17, 3, 91, 42], [1] * 17, [8, 9, 10, 11, 12, 13, 14, 15, 16]]
ALL7 = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
RANK, ALPHA, N = 4, 8.0, 2


def _models(kind, bits=None):
    if kind == "mixtral":
        js = jspecs.ModelSpec(**MIXTRAL, moe=jspecs.MoESpec(4, 2))
        ts = tspecs.ModelSpec(**MIXTRAL, moe=tspecs.MoESpec(4, 2))
    else:
        js, ts = jspecs.ModelSpec(**LLAMA), tspecs.ModelSpec(**LLAMA)
    jparams = jp.init_params(js, jax.random.PRNGKey(3), jnp.float32)
    if bits:
        jparams = j_quant_params(js, jparams, bits=bits, group_size=32,
                                 compute_dtype=jnp.float32)
        return js, jparams, ts, tp.params_from_numpy(jparams)
    return js, jparams, ts, tp.params_from_numpy(jax.tree.map(np.asarray, jparams))


def _stacks(seed=1):
    """numpy LoRA stacks in JAX's layout on all seven modules, B non-zero."""
    r = np.random.default_rng(seed)
    out = {}
    for mod in jl.LoraConfig(rank=RANK, alpha=ALPHA, target_modules=ALL7).keys():
        d_in, d_out = jl._module_dims(jspecs.ModelSpec(**LLAMA), mod)
        out[mod] = {"a": (r.standard_normal((3, N, d_in, RANK)) / np.sqrt(d_in)).astype(np.float32),
                    "b": (r.standard_normal((3, N, RANK, d_out)) * 0.05).astype(np.float32)}
    return out


def _serve(jax_side, spec, params, *, offload, budget=0, stacks=None, adapters=None,
           horizon=4, max_new=10):
    kw = dict(max_requests_per_batch=2, max_seq_len=64, max_tokens_per_batch=budget,
              offload=offload)
    adapters = adapters or [-1] * len(PROMPTS)
    if jax_side:
        if stacks is not None:
            kw.update(lora=jax.tree.map(jnp.asarray, stacks),
                      lora_config=jl.LoraConfig(rank=RANK, alpha=ALPHA, target_modules=ALL7))
        eng = JEngine(spec, params, cache_dtype=jnp.float32, **kw)
        if offload:
            assert next(iter(eng.params["layers"].values())).sharding.memory_kind == "pinned_host"
        rm = JRM(eng, decode_horizon=horizon, pipelined=horizon > 1)
        guids = [rm.register_request(p, JGen(max_new_tokens=max_new, adapter_id=a))
                 for p, a in zip(PROMPTS, adapters)]
        rm.run_until_idle()
        return [rm.get_request(g).output_tokens for g in guids]
    if stacks is not None:
        kw.update(lora=tp.lora_from_numpy(stacks),
                  lora_config=tl.LoraConfig(rank=RANK, alpha=ALPHA, target_modules=ALL7))
    eng = TEngine(spec, params, cache_dtype=torch.float32, device="cpu", **kw)
    assert isinstance(eng.params["layers"], LayerStore) == offload
    rm = TRM(eng, decode_horizon=horizon, pipelined=horizon > 1)
    try:
        guids = [rm.register_request(p, TGen(max_new_tokens=max_new, adapter_id=a))
                 for p, a in zip(PROMPTS, adapters)]
        rm.run_until_idle()
        return [rm.get_request(g).output_tokens for g in guids]
    finally:
        rm.close()


@pytest.mark.parametrize("kind,bits", [("llama", None), ("llama", 8), ("llama", 4),
                                       ("mixtral", None)],
                         ids=["dense-f32", "int8", "int4", "mixtral"])
def test_offload_tokens_equal_jax_offload(kind, bits):
    js, jparams, ts, tparams = _models(kind, bits)
    want = _serve(True, js, jparams, offload=True)
    got = _serve(False, ts, tparams, offload=True)
    assert got == want and all(len(t) == 10 for t in got)


def test_offload_lora_tokens_equal_jax_offload():
    """Three requests routed [0, 1, -1] over two adapters; the adapter stacks
    stay on the device, the layers stream."""
    js, jparams, ts, tparams = _models("llama")
    kw = dict(offload=True, stacks=_stacks(), adapters=[0, 1, -1])
    want = _serve(True, js, jparams, **kw)
    got = _serve(False, ts, tparams, **kw)
    assert got == want and all(len(t) == 10 for t in got)


def test_offload_chunked_prefill_tokens_equal_jax_offload():
    """An 8-token prefill budget: the 9- and 17-token prompts go in chunks
    through the streamed cached forward."""
    js, jparams, ts, tparams = _models("llama", 8)
    want = _serve(True, js, jparams, offload=True, budget=8)
    got = _serve(False, ts, tparams, offload=True, budget=8)
    assert got == want


def _engine_pair(ts, tparams, **kw):
    kw = dict(max_requests_per_batch=2, max_seq_len=64, cache_dtype=torch.float32,
              device="cpu", **kw)
    return TEngine(ts, tparams, **kw), TEngine(ts, tparams, offload=True, **kw)


@pytest.mark.parametrize("kind,bits", [("llama", None), ("llama", 4), ("mixtral", 8)],
                         ids=["dense-f32", "int4", "mixtral-int8"])
def test_offload_logits_bitwise_resident(kind, bits):
    """Prefill, then five decode steps (the ring runs on across forwards,
    an odd layer count included), then a chunked forward, through the
    resident and the offload engine's parameters: every logit bitwise."""
    _, _, ts, tparams = _models(kind, bits)
    res, off = _engine_pair(ts, tparams)
    tok = torch.tensor(np.random.default_rng(0).integers(1, ts.vocab_size, (2, 12)),
                       dtype=torch.int32)
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    with torch.no_grad():
        outs = []
        for eng in (res, off):
            logits, kv = td.forward(ts, eng.params, tok, pos, return_kv=True)
            cache = td.init_kv_cache(ts, 2, 64, torch.float32)
            for b in range(2):
                td.insert_kv(cache, kv[0][:, b], kv[1][:, b], b)
            seq = [logits]
            lens, nxt = torch.full((2,), 12, dtype=torch.int32), tok[:, -1:]
            for _ in range(5):
                step, _ = td.forward_cached(ts, eng.params, nxt, cache, lens)
                seq.append(step)
                nxt, lens = step[:, -1:].argmax(-1).to(torch.int32), lens + 1
            chunk, _ = td.forward_cached(ts, eng.params, tok[:, :6], cache, lens,
                                         write_start=lens.numpy())
            outs.append(seq + [chunk])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_offload_lora_logits_bitwise_resident():
    _, _, ts, tparams = _models("llama")
    lora = tp.lora_from_numpy(_stacks())
    cfg = tl.LoraConfig(rank=RANK, alpha=ALPHA, target_modules=ALL7)
    res, off = _engine_pair(ts, tparams, lora=lora, lora_config=cfg)
    tok = torch.tensor([[3, 9, 27, 81, 5, 15], [2, 4, 8, 16, 32, 64]], dtype=torch.int32)
    pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
    ids = torch.tensor([1, -1])
    with torch.no_grad():
        want, _ = td.forward(ts, res.params, tok, pos, **res._routing(ids))
        got, _ = td.forward(ts, off.params, tok, pos, **off._routing(ids))
    assert torch.equal(got, want)


def test_offload_served_tokens_equal_resident():
    """The port's offload and resident engines serve the same tokens
    (pipelined horizon 4, the third request admitted into a freed slot)."""
    _, _, ts, tparams = _models("llama", 8)
    assert (_serve(False, ts, tparams, offload=True)
            == _serve(False, ts, tparams, offload=False))


def test_layer_store_ring_restarts_after_a_broken_forward():
    """A forward that stops after layer 0 leaves the ring ahead; the next
    forward's ``acquire(0)`` restarts it and reads layer 0's values."""
    _, _, ts, tparams = _models("llama")
    store = LayerStore(tparams["layers"], ts.num_layers, "cpu")
    first = store.acquire(0)
    store.release(0)
    assert torch.equal(store.acquire(1)["wq"], tparams["layers"]["wq"][1])
    store.release(1)
    again = store.acquire(0)  # the ring had layers 2 and 0 staged
    assert torch.equal(again["wq"], tparams["layers"]["wq"][0])
    assert torch.equal(again["wq"], first["wq"])
    with pytest.raises(RuntimeError, match="released layer 2"):
        store.release(2)


def test_layer_store_layer_copies_outside_the_ring():
    """``layer(i)`` copies layer i into tensors of its own and leaves the
    ring as it was: the next forward's layer 0 is still staged."""
    _, _, ts, tparams = _models("llama", 8)
    store = LayerStore(tparams["layers"], ts.num_layers, "cpu")
    one = store.layer(2)
    assert torch.equal(one["wo"].qa.q[0], tparams["layers"]["wo"].q[2])
    assert list(store._ring) == [(0, 0), (1, 1)]
    assert torch.equal(store.acquire(0)["wo"].qa.q[0], tparams["layers"]["wo"].q[0])
    assert list(store._ring) == [(0, 0), (1, 1)]


@pytest.mark.parametrize("bits", [None, 8], ids=["f32", "int8"])
def test_offload_holds_one_host_copy_of_the_stack(bits, monkeypatch):
    """A ``host_layers`` build comes fused (wqkv, wgu) and the offload
    engine's store takes its leaves as they are: every host leaf of the
    store is one the build allocated, and the build allocated nothing
    else (on the card the same leaves are the only pinned copy)."""
    from flexflow_tpu_torch.models import layer_store

    allocated = []

    def counting_empty(shape, dtype, pin):
        t = layer_store.host_empty(shape, dtype, pin)
        allocated.append(t)
        return t

    monkeypatch.setattr(tp, "host_empty", counting_empty)
    ts = tspecs.ModelSpec(**LLAMA)
    params = tp.init_quantized_params(ts, 5, bits=bits, group_size=32, dtype=torch.float32,
                                      device="cpu", host_layers=True)
    assert {"wqkv", "wgu"} <= set(params["layers"]) and "wq" not in params["layers"]
    eng = TEngine(ts, params, max_requests_per_batch=2, max_seq_len=64,
                  cache_dtype=torch.float32, device="cpu", offload=True)
    del params
    host = [t for v in eng.params["layers"].host.values() for t in layer_store.leaf_fields(v)]
    assert sorted(t.data_ptr() for t in host) == sorted(t.data_ptr() for t in allocated)


@pytest.mark.parametrize("bits", [None, 8], ids=["f32", "int8"])
def test_host_layers_build_equals_resident_build(bits):
    """The streaming init into host memory gives the resident build's bits
    (on the CPU both are CPU tensors; on the card the host copy is pinned);
    ``init_params(host_layers=True)`` is its unquantized form."""
    ts = tspecs.ModelSpec(**MIXTRAL, moe=tspecs.MoESpec(4, 2))
    kw = dict(bits=bits, dtype=torch.float32, device="cpu")
    res = tp.init_quantized_params(ts, 7, **kw)
    host = tp.init_quantized_params(ts, 7, host_layers=True, **kw)
    if bits is None:
        host = tp.init_params(ts, 7, torch.float32, "cpu", host_layers=True)
    res = td.fuse_qkv_params(ts, res)  # a host build comes fused, as the engine fuses
    assert set(res["layers"]) == set(host["layers"]) and "wqkv" in host["layers"]
    for k, v in res["layers"].items():
        w = host["layers"][k]
        pairs = ([(v.q, w.q), (v.scale, w.scale)] if hasattr(v, "q") else [(v, w)])
        assert all(torch.equal(x, y) for x, y in pairs), k
    assert all(torch.equal(res[k], host[k]) for k in res if k != "layers" and bits is None)


def test_offload_captures_no_graph():
    ts = tspecs.ModelSpec(**LLAMA)
    cuda = torch.device("cuda")
    assert capturable(cuda, ts) and not capturable(cuda, ts, offload=True)
    _, _, ts, tparams = _models("llama")
    _, off = _engine_pair(ts, tparams)
    assert off.graphs is None and off.offload


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny HF LLaMA directory with a byte-level BPE tokenizer."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_llama_offload")
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


def test_compile_offload_with_drafts_raises(model_dir):
    from flexflow_tpu_torch.serve import LLM, SSM

    llm = LLM(model_dir, data_type="float32", device="cpu")
    with pytest.raises(NotImplementedError, match="A7b"):
        llm.compile(max_seq_length=64, ssms=[SSM(model_dir, data_type="float32", device="cpu")],
                    offload=True)


def test_compile_offload_keeps_only_the_engine_tree(model_dir):
    """``LLM.compile(offload=True)`` keeps the engine's tree (its layers the
    store's, fused) and not the loaded one beside it, and serves the
    resident LLM's tokens."""
    from flexflow_tpu_torch.serve import LLM

    outs = []
    for offload in (False, True):
        llm = LLM(model_dir, data_type="float32", device="cpu")
        llm.compile(max_seq_length=64, max_requests_per_batch=2, offload=offload)
        layers = llm.rm.engine.params["layers"]
        assert llm.params is llm.rm.engine.params and isinstance(layers, LayerStore) == offload
        assert {"wqkv", "wgu"} <= set(layers.host if offload else layers)
        outs.append([r.output_tokens for r in llm.generate([[5, 6, 7], [40] * 9],
                                                           max_new_tokens=6)])
    assert outs[0] == outs[1]


def test_cli_offload_matches_jax_cli(model_dir, tmp_path, capsys):
    """``--offload`` through the port's CLI serves, with the JAX CLI's text
    (also under ``--offload``)."""
    from flexflow_tpu_torch.inference import incr_decoding as t_cli
    from inference import incr_decoding as j_cli

    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", model_dir, "-prompt", str(prompts), "--max-new-tokens", "16",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2",
            "--full-precision", "--offload"]
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.count("=== guid") == 2
    texts = [line for line in got.splitlines() if not line.startswith("=== guid")]
    assert texts == [line for line in want.splitlines() if not line.startswith("=== guid")]
