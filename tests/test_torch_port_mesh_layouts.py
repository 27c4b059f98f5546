"""The serving layouts left under a mesh, held against the JAX package at
float32 over gloo ranks on the CPU (the spawn helpers of
``test_torch_port_mesh_serving.py``; JAX computed in the parent):

- CPU offload under a mesh: JAX's ``test_mesh_offload_matches_resident``
  spec at data=2 x model=2; INT8, INT4, LoRA and chunked prefill at T = 2;
  ``LLM.compile(offload=True, tensor_parallelism_degree=2)``. Tokens equal
  JAX's offload mesh engine's and the port's resident mesh engine's, whose
  prefill logits the offload engine gives bit for bit;
- ``hybrid_ffn``: ``test_hybrid_tp.py``'s GQA spec at 2 x 2 and 2 x 1
  (float, INT8, INT4), Mixtral float and INT8, with offload, with LoRA, and
  an FFN width the 4 ranks do not divide: tokens equal JAX's hybrid engine's
  and one device's;
- ``expert_parallel``: ``test_parallel.py``'s MoE spec at T = 4 and 2,
  dense and ragged forms, logits within 1e-5 of JAX's EP-sharded
  ``decoder.forward`` (and cached decode steps within 1e-5 of one
  device's), ``E % T != 0``, and a quantized Mixtral (TP within each
  expert);
- co-scheduled LoRA finetuning on a hybrid engine at 2 x 2: the served
  tokens, the losses and the slot gathered over each cut's group (and the
  HF adapter rank 0 exports) against JAX's ``FinetuneSession`` on its
  hybrid mesh engine;
- each rank's hybrid and EP cut against JAX's device shard of the same
  leaf (no process group: ``Mesh.fake``), the host-layer build under a mesh
  against the rank's cut of the whole build, and an engine refusing an
  EP-cut tree.

The ranks import this file, so it imports JAX only inside the parent's
functions.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.parallel.mesh import FFN_AXES, MODEL_AXIS, Mesh
from flexflow_tpu_torch.parallel.sharding import (_blocks_of, _rule, _take, shard_params,
                                                  tree_shard)
from flexflow_tpu_torch.quant.weight_only import QuantizedArray, dequantize

from test_torch_port_mesh_lora import CFG, RM, _stacks
from test_torch_port_mesh_serving import _join, _numpy_tree, _start

torch.set_num_threads(2)

# tests/test_serving.py::test_mesh_offload_matches_resident
OFFLOAD = dict(arch="LlamaForCausalLM", vocab_size=256, hidden_size=64, num_layers=2,
               num_heads=4, num_kv_heads=4, head_dim=16, intermediate_size=128,
               max_position_embeddings=256, norm_eps=1e-6)
# tests/test_hybrid_tp.py: GQA, attention capped at 2 ranks, a fat FFN
HYBRID = dict(arch="LlamaForCausalLM", vocab_size=256, hidden_size=128, num_layers=2,
              num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=1024,
              max_position_embeddings=128, norm_eps=1e-6)
# tests/test_parallel.py::test_expert_parallel_moe
MOE = dict(arch="MixtralForCausalLM", vocab_size=128, hidden_size=64, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128, norm_eps=1e-6,
           max_position_embeddings=128, moe=(4, 2, "dense"))
MIXTRAL = dict(MOE, intermediate_size=256)
INDIVISIBLE = dict(HYBRID, intermediate_size=1022)  # 4 ranks do not divide it; 2 do
ENGINE = dict(max_requests_per_batch=4, max_seq_len=64)
IDS = [0, 1, -1, 1]  # the LoRA cases' adapters


def _jspec(kw):
    from flexflow_tpu import specs as jspecs

    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = jspecs.MoESpec(*kw["moe"])
    return jspecs.ModelSpec(**kw)


def _tspec(kw):
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = tspecs.MoESpec(*kw["moe"])
    return tspecs.ModelSpec(**kw)


def _jax_params(kw, seed, bits=None):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.models import params as jp
    from flexflow_tpu.quant import quantize_params as j_quant_params

    spec = _jspec(kw)
    params = jp.init_params(spec, jax.random.PRNGKey(seed), jnp.float32)
    if bits:
        params = j_quant_params(spec, params, bits=bits, group_size=16,
                                compute_dtype=jnp.float32)
    return spec, params


def _offload_prompts():
    return [np.random.RandomState(i).randint(1, 256, size=12).tolist() for i in range(4)]


def _hybrid_prompts():
    """Within every spec's vocabulary (Mixtral's 128)."""
    rng = np.random.RandomState(3)
    return [rng.randint(1, 128, size=n).tolist() for n in (4, 9, 17, 6)]


def _ft_data():
    """Two finetuning sequences within ``HYBRID``'s vocabulary."""
    toks = np.random.RandomState(4).randint(1, HYBRID["vocab_size"], size=(2, 12))
    toks = toks.astype(np.int32)
    return [(toks, np.roll(toks, -1, axis=1)), (toks[::-1].copy(), np.roll(toks[::-1], -1, 1))]


def _ep_tokens(vocab):
    return np.random.RandomState(5).randint(1, vocab, size=(2, 8)).astype(np.int32)


# ---------------------------------------------------------------------------
# each rank's cut against JAX's placement (no process group)
# ---------------------------------------------------------------------------


def _shard_at(arr, device) -> np.ndarray:
    for s in arr.addressable_shards:
        if s.device == device:
            return np.asarray(s.data)
    raise AssertionError(f"no shard on {device}")


CUTS = [  # (tree, bits, layout, data, model)
    ("hybrid", None, "hybrid", 2, 2), ("hybrid", None, "hybrid", 2, 1),
    ("hybrid", 8, "hybrid", 2, 2), ("hybrid", 4, "hybrid", 2, 2), ("hybrid", 4, "hybrid", 2, 1),
    ("indivisible", None, "hybrid", 2, 2), ("mixtral", None, "hybrid", 2, 2),
    ("mixtral", 8, "hybrid", 2, 2), ("moe", None, "ep", 1, 4), ("moe", None, "ep", 1, 2),
    ("moe", None, "ep", 2, 2), ("moe", 8, "ep", 1, 2), ("moe-e3", None, "ep", 1, 2),
]
TREES = {"hybrid": HYBRID, "indivisible": INDIVISIBLE, "mixtral": MIXTRAL, "moe": MOE,
         "moe-e3": dict(MOE, moe=(3, 2, "dense"))}


@pytest.mark.parametrize("tree,bits,layout,data,model", CUTS,
                         ids=[f"{t}-{b or 'f32'}-{lo}-d{d}m{m}" for t, b, lo, d, m in CUTS])
def test_rank_cut_equals_jax_layout(tree, bits, layout, data, model):
    """Every rank's ``shard_params(hybrid_ffn=)`` / ``(expert_parallel=)``
    leaf against JAX's device shard at that rank's coordinate: plain leaves
    and INT8 ``q`` (and INT4's row-parallel ``q``) byte for byte, every
    carrier dequantizing bit for bit to its cut of the one-device weight.
    The hybrid FFN's block is model-major; a float MoE stack is not
    hybrid-cut, a quantized one is; EP keeps whole experts, or the whole
    stack where E % T != 0, and quantized carriers keep TP within experts."""
    import jax

    from flexflow_tpu.parallel import make_mesh as j_make_mesh
    from flexflow_tpu.parallel.sharding import shard_params as j_shard_params

    kw = TREES[tree]
    js, jparams = _jax_params(kw, 3, bits)
    ts = _tspec(kw)
    tparams = tp.params_from_numpy(jparams if bits else jax.tree.map(np.asarray, jparams))
    flags = dict(hybrid_ffn=layout == "hybrid", expert_parallel=layout == "ep")
    jmesh = j_make_mesh(data=data, model=model)
    placed = j_shard_params(js, jparams, jmesh, **flags)
    devices = list(jmesh.devices.reshape(-1))
    moe = "moe" in kw
    for rank in range(data * model):
        mesh = Mesh.fake(data, model, rank)
        mine = shard_params(ts, tparams, mesh, **flags)
        shard = tree_shard(ts, tparams, mesh, **flags)
        # which cut each layout takes
        if kw is INDIVISIBLE:  # 1022 % 4: the FFN whole, no model-only fallback
            assert shard.ffn is None
        elif layout == "hybrid" and (bits or not moe):
            assert shard.ffn_axis == FFN_AXES
            k = mesh.model_rank * data + mesh.data_rank  # model-major, as JAX's P(("model", "data"))
            width = kw["intermediate_size"] // (data * model)
            assert shard.ffn[0][0] == (k * width // 2 if bits == 4 else k * width)
        elif layout == "ep" and not bits:
            e, m = kw["moe"][0], mesh.model_rank
            assert shard.ffn is None
            assert shard.experts == (None if e % model else ((m * e // model,
                                                              (m + 1) * e // model),))
        else:
            assert shard.ffn_axis == MODEL_AXIS and shard.experts is None
        for name, leaf in tparams["layers"].items():
            _check_leaf(name, mine["layers"][name], leaf, placed["layers"][name], shard,
                        devices[rank], top=False)
        for name, leaf in tparams.items():
            if name != "layers":
                _check_leaf(name, mine[name], leaf, placed[name], shard, devices[rank], top=True)
        _trees_equal(shard_params(ts, mine, mesh, **flags), mine)  # idempotent


def _check_leaf(name, mine, full, placed, shard, device, top):
    rule = _rule(name, shard, top)
    blocks = None if rule is None else _blocks_of(shard, rule[1])
    if not isinstance(mine, QuantizedArray):
        assert np.array_equal(mine.numpy(), _shard_at(placed, device)), name
        return
    want = dequantize(full)
    if blocks is not None:
        want = _take(want, want.dim() + rule[0], blocks)
    assert torch.equal(dequantize(mine), want), name
    if mine.bits == 8 or (rule is not None and name in ("wo", "wd")):
        assert np.array_equal(mine.q.numpy(), _shard_at(placed.q, device)), name


@pytest.mark.parametrize("bits", [None, 8], ids=["bf16", "int8"])
def test_host_layer_build_under_a_mesh(bits):
    """``build_params(host_layers=True, mesh=)`` (through
    ``init_quantized_params``): each rank's layers are its cut of the whole
    host build, fused as the engine fuses a rank's tree (wqkv, wgu), at T x
    D = 2 x 2 and with the hybrid FFN cut; the top leaves likewise."""
    from flexflow_tpu_torch.models.decoder import fuse_qkv_params
    from flexflow_tpu_torch.models.params import build_params
    from flexflow_tpu_torch.quant.weight_only import layer_quant_layout, quantize

    ts = _tspec(HYBRID)
    kw = dict(bits=bits, group_size=16, dtype=torch.float32, device="cpu", host_layers=True)
    whole = tp.init_quantized_params(ts, 5, **kw)
    assert "wqkv" in whole["layers"] and "wgu" in whole["layers"]
    for rank in range(4):
        mesh = Mesh.fake(2, 2, rank)
        mine = tp.init_quantized_params(ts, 5, mesh=mesh, **kw)
        raw = tp.init_quantized_params(ts, 5, **dict(kw, host_layers=False))
        want = fuse_qkv_params(ts, shard_params(ts, raw, mesh), tree_shard(ts, raw, mesh))
        _trees_equal(mine, want)
    # the hybrid cut through build_params (a layer generator, as the loaders)
    gen = torch.Generator().manual_seed(2)
    slabs = {"ln1_scale": torch.ones(2, 128), "ln2_scale": torch.ones(2, 128),
             "wq": torch.randn(2, 128, 4, 32, generator=gen),
             "wk": torch.randn(2, 128, 2, 32, generator=gen),
             "wv": torch.randn(2, 128, 2, 32, generator=gen),
             "wo": torch.randn(2, 4, 32, 128, generator=gen),
             "wg": torch.randn(2, 128, 1024, generator=gen),
             "wu": torch.randn(2, 128, 1024, generator=gen),
             "wd": torch.randn(2, 1024, 128, generator=gen)}
    top = {"embed_tokens": torch.randn(256, 128, generator=gen),
           "final_norm_scale": torch.ones(128), "lm_head": torch.randn(128, 256, generator=gen)}
    one = {n: (quantize(v, 8, 16, batch_dims=layer_quant_layout(n, v.dim())[0],
                        contract_dims=layer_quant_layout(n, v.dim())[1],
                        compute_dtype=torch.float32)
               if layer_quant_layout(n, v.dim()) else v) for n, v in slabs.items()}
    full = {**top, "lm_head": quantize(top["lm_head"], 8, 16, compute_dtype=torch.float32),
            "layers": one}
    for rank in range(4):
        mesh = Mesh.fake(2, 2, rank)
        mine = build_params(ts, top, lambda i: ((n, v[i]) for n, v in slabs.items()),
                            dtype=torch.float32, device="cpu", bits=8, group_size=16,
                            mesh=mesh, hybrid_ffn=True)
        _trees_equal(mine, shard_params(ts, full, mesh, hybrid_ffn=True))


def _trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _trees_equal(a[k], b[k])
        elif isinstance(a[k], QuantizedArray):
            assert (a[k].shape, a[k].group_size, a[k].rest_pad) == (
                b[k].shape, b[k].group_size, b[k].rest_pad), k
            for f in ("q", "scale", "offset"):
                x, y = getattr(a[k], f), getattr(b[k], f)
                assert (x is None and y is None) or torch.equal(x, y), (k, f)
        else:
            assert torch.equal(a[k], b[k]), k


def test_engines_refuse_an_expert_parallel_tree():
    """JAX's engine re-places a tree ``shard_params(expert_parallel=True)``
    cut with its TP rules; the port's engines refuse it and ask for the
    full tree."""
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.speculative import SpecEngine

    ts = _tspec(MOE)
    params = tp.init_params(ts, 0)
    mesh = Mesh.fake(1, 2, 1)
    ep = shard_params(ts, params, mesh, expert_parallel=True)
    assert ep["layers"]["wg"].shape[1] == 2 and ep["layers"]["router"].shape[-1] == 4
    with pytest.raises(ValueError, match="full tree"):
        InferenceEngine(ts, ep, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="full tree"):
        SpecEngine(ts, ep, ts, params, device="cpu", mesh=mesh)
    eng = InferenceEngine(ts, params, device="cpu", mesh=mesh)  # the full tree: TP within experts
    assert eng.shard.experts is None and eng.params["layers"]["wg"].shape[1:] == (4, 64, 64)


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _prefill_logits(spec, eng, prompts):
    """The engine's parameters' prefill logits at each prompt's last position
    (one batched forward, no cache write)."""
    from flexflow_tpu_torch.models import decoder

    n, t = len(prompts), max(len(p) for p in prompts)
    tok = torch.zeros(n, t, dtype=torch.int32)
    for i, p in enumerate(prompts):
        tok[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    pos = torch.arange(t, dtype=torch.int32)[None].expand(n, t)
    with torch.no_grad():
        logits, _ = decoder.forward(spec, eng.params, tok, pos, lengths=lens, logits_at=lens - 1,
                                    shard=eng.shard)
    return logits


def _serve(case, mesh):
    """The served tokens of each run (``resident``, ``offload``) of one
    engine configuration, and whether the offload engine's prefill logits
    equal the resident one's bit for bit."""
    from flexflow_tpu_torch.models.layer_store import LayerStore
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager

    spec = _tspec(case["spec"])
    params = tp.params_from_numpy(case["params"])
    kw = dict(ENGINE, cache_dtype=torch.float32, device="cpu", mesh=mesh, **case.get("engine", {}))
    ids = [-1] * len(case["prompts"])
    if "stacks" in case:
        kw.update(lora=tp.lora_from_numpy(case["stacks"]), lora_config=LoraConfig(**CFG))
        ids = IDS
    out = {}
    for run in case["runs"]:
        eng = InferenceEngine(spec, params, offload=run == "offload", **kw)
        assert isinstance(eng.params["layers"], LayerStore) == (run == "offload")
        rm = RequestManager(eng, decode_horizon=4, pipelined=True)
        try:
            g = [rm.register_request(p, GenerationConfig(max_new_tokens=case["max_new"],
                                                         adapter_id=a))
                 for p, a in zip(case["prompts"], ids)]
            rm.run_until_idle()
            out[run] = [rm.get_request(i).output_tokens for i in g]
        finally:
            rm.close()
        out[run + "-logits"] = _prefill_logits(spec, eng, case["prompts"])
        if mesh is not None:
            out[run + "-slots"] = (eng.slots.lo, eng.slots.hi)
    if len(case["runs"]) == 2:
        out["logits bitwise"] = torch.equal(out["resident-logits"], out["offload-logits"])
    for run in case["runs"]:
        out.pop(run + "-logits")
    return out


def _finetune(case, mesh):
    """Slot 1 finetuned (SGD) beside serving on a hybrid engine: the served
    tokens, the losses, the slot gathered over each cut's group, and the
    adapter directory rank 0 exports (``export_hf_adapter(shard=)``)."""
    from flexflow_tpu_torch.parallel.sharding import gather_lora
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import LoraConfig, export_hf_adapter, unroute_lora
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager

    spec = _tspec(case["spec"])
    eng = InferenceEngine(spec, tp.params_from_numpy(case["params"]), cache_dtype=torch.float32,
                          device="cpu", mesh=mesh, hybrid_ffn=True,
                          lora=tp.lora_from_numpy(case["stacks"]),
                          lora_config=LoraConfig(**CFG), **ENGINE)
    assert eng.shard.ffn_axis == FFN_AXES
    rm = RequestManager(eng, **RM)
    sess = FinetuneSession(spec, LoraConfig(**CFG), 1, case["data"], epochs=1)
    rm.register_finetune(sess)
    try:
        tokens = [rm.generate([p], GenerationConfig(max_new_tokens=case["max_new"],
                                                    adapter_id=a))[0].output_tokens
                  for p, a in zip(case["prompts"], (1, 0))]
    finally:
        rm.close()
    stacks = gather_lora(spec, unroute_lora(eng.lora), eng.shard)
    export_hf_adapter(case["export"], spec, unroute_lora(eng.lora), 1, LoraConfig(**CFG),
                      shard=eng.shard)
    return dict(tokens=tokens, losses=sess.losses,
                slot={m: {k: v[:, 1].numpy() for k, v in ab.items()} for m, ab in stacks.items()})


def _ep(case, mesh):
    """The EP cut's prefill logits (``decoder.forward``) and a cached prefill
    plus 3 decode steps (``forward_cached``), beside one device's."""
    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.parallel.sharding import shard_params as t_shard, tree_shard as t_tree

    spec = _tspec(case["spec"])
    whole = tp.params_from_numpy(case["params"])
    ep = t_shard(spec, whole, mesh, expert_parallel=True)
    shard = t_tree(spec, ep, mesh, expert_parallel=True)
    tok = torch.as_tensor(case["tokens"])
    b, t = tok.shape
    pos = torch.arange(t, dtype=torch.int32)[None].expand(b, t)

    def run(params, sh):
        cache = decoder.init_kv_cache(spec, b, 16, torch.float32,
                                      num_kv_heads=None if sh is None else sh.num_kv_cache(spec))
        with torch.no_grad():
            logits, _ = decoder.forward(spec, params, tok, pos, shard=sh)
            steps = []
            lens = torch.zeros(b, dtype=torch.int32)
            cur = tok
            for _ in range(4):  # the prompt as one chunk, then 3 decode steps
                lg, _ = decoder.forward_cached(spec, params, cur, cache, lens, shard=sh)
                steps.append(lg[:, -1])
                lens = lens + cur.shape[1]
                cur = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        return logits.numpy(), torch.stack(steps).numpy()

    got, got_steps = run(ep, shard)
    one, one_steps = run(whole, None)
    return dict(logits=got, steps=got_steps, one=one, one_steps=one_steps,
                experts=shard.expert_ids(), wg=tuple(ep["layers"]["wg"].shape))


def _llm(case, mesh, model_dir):
    """``LLM.compile(offload=True, tensor_parallelism_degree=2)`` against the
    one-device resident LLM."""
    from flexflow_tpu_torch.models.layer_store import LayerStore
    from flexflow_tpu_torch.serve import LLM

    out = {}
    for name, tp_, offload in (("one", 1, False), ("tp2-offload", 2, True)):
        llm = LLM(model_dir, data_type="float32", device="cpu")
        llm.compile(max_requests_per_batch=2, max_seq_length=64,
                    tensor_parallelism_degree=tp_, offload=offload)
        assert isinstance(llm.rm.engine.params["layers"], LayerStore) == offload
        out[name] = [r.output_tokens for r in llm.generate([[1, 5, 9, 12], [3, 4]],
                                                           max_new_tokens=6)]
    return out


def run_layout_cases(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    out = {"ffn group": {}}  # the group FFN_AXES' sums run over, by case
    for case in cases:
        data, model = case.get("mesh", (1, 1))
        mesh = make_mesh(data=data, model=model, device="cpu")
        out["ffn group"][case["name"]] = (
            "model" if mesh.ffn_group is mesh.model_group
            else "data" if mesh.ffn_group is mesh.data_group else "own")
        fn = {"serve": _serve, "ep": _ep, "finetune": _finetune}.get(case["kind"])
        out[case["name"]] = (_llm(case, mesh, model_dir) if fn is None
                             else fn(case, None if case.get("one") else mesh))
    return out


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _tokenizer(d):
    """A byte-level BPE tokenizer beside an HF model directory."""
    import json

    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "PreTrainedTokenizerFast"}))


def _jax_tokens(spec, params, prompts, max_new, mesh=None, stacks=None, **engine):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.peft import lora as jl
    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager

    kw = dict(ENGINE, cache_dtype=jnp.float32, mesh=mesh, **engine)
    ids = [-1] * len(prompts)
    if stacks is not None:
        kw.update(lora=jax.tree.map(jnp.asarray, stacks), lora_config=jl.LoraConfig(**CFG))
        ids = IDS
    eng = InferenceEngine(spec, params, **kw)
    if engine.get("offload"):
        leaf = jax.tree_util.tree_leaves(eng.params["layers"])[0]
        assert leaf.sharding.memory_kind == "pinned_host"
    rm = RequestManager(eng, decode_horizon=4, pipelined=True)
    g = [rm.register_request(p, GenerationConfig(max_new_tokens=max_new, adapter_id=a))
         for p, a in zip(prompts, ids)]
    rm.run_until_idle()
    return [rm.get_request(i).output_tokens for i in g]


def _jax_finetune(spec, params, stacks, prompts, max_new, data, mesh):
    """JAX's ``FinetuneSession`` on its hybrid mesh engine: as ``_finetune``."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.peft import lora as jl
    from flexflow_tpu.peft.finetune import FinetuneSession
    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager

    eng = InferenceEngine(spec, params, cache_dtype=jnp.float32, mesh=mesh, hybrid_ffn=True,
                          lora=jax.tree.map(jnp.asarray, stacks),
                          lora_config=jl.LoraConfig(**CFG), **ENGINE)
    rm = RequestManager(eng, **RM)
    sess = FinetuneSession(spec, jl.LoraConfig(**CFG), 1, data, epochs=1)
    rm.register_finetune(sess)
    tokens = [rm.generate([p], GenerationConfig(max_new_tokens=max_new, adapter_id=a)
                          )[0].output_tokens for p, a in zip(prompts, (1, 0))]
    return dict(tokens=tokens, losses=sess.losses,
                slot={m: {k: np.asarray(v)[:, 1] for k, v in ab.items()}
                      for m, ab in eng.lora.items()})


def _check_finetune(res, name, want, export_dir):
    """Every rank's tokens, losses and gathered slot against JAX's (the
    slot bit for bit the same on every rank), and rank 0's exported
    adapter equal to its gathered slot."""
    import safetensors.numpy

    for r in res:
        got = r[name]
        assert got["tokens"] == want["tokens"], name
        assert len(got["losses"]) == 2
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=1e-5)
        for m, ab in want["slot"].items():
            for k, v in ab.items():
                np.testing.assert_allclose(got["slot"][m][k], v, rtol=1e-5,
                                           atol=1e-5 * np.abs(v).max(), err_msg=(name, m, k))
                assert np.array_equal(got["slot"][m][k], res[0][name]["slot"][m][k])
    hf = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
          "wo": "self_attn.o_proj", "wg": "mlp.gate_proj", "wu": "mlp.up_proj",
          "wd": "mlp.down_proj"}
    saved = safetensors.numpy.load_file(str(export_dir / "adapter_model.safetensors"))
    slot = res[0][name]["slot"]
    for m, ab in slot.items():
        for k, ab_k in (("a", "lora_A"), ("b", "lora_B")):
            for layer in range(ab[k].shape[0]):
                key = f"base_model.model.model.layers.{layer}.{hf[m]}.{ab_k}.weight"
                assert np.array_equal(saved[key], ab[k][layer].T), key


def _jax_ep_logits(spec, params, tokens, model):
    import jax.numpy as jnp

    from flexflow_tpu.models import decoder as jd
    from flexflow_tpu.parallel import make_mesh as j_make_mesh
    from flexflow_tpu.parallel.sharding import shard_params as j_shard_params

    ep = j_shard_params(spec, params, j_make_mesh(model=model), expert_parallel=True)
    pos = np.broadcast_to(np.arange(tokens.shape[1], dtype=np.int32), tokens.shape)
    logits, _ = jd.forward(spec, ep, jnp.asarray(tokens), jnp.asarray(pos))
    return np.asarray(logits)


def _all(res, name):
    """Every rank's results of case ``name``; the ranks agree on each token
    list."""
    got = [r[name] for r in res]
    for g in got[1:]:
        for k, v in g.items():
            if isinstance(v, list):
                assert v == got[0][k], (name, k)
    return got


def _check_serve(res, name, want, runs=("resident", "offload")):
    for r in _all(res, name):
        for run in runs:
            assert r[run] == want, (name, run)
            assert all(len(t) == len(want[0]) for t in r[run])
        if len(runs) == 2:
            assert r["logits bitwise"], name


def _check_ep(res, name, want, tol=1e-5):
    for r in _all(res, name):
        np.testing.assert_allclose(r["logits"], want, atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_allclose(r["steps"], r["one_steps"], atol=tol, rtol=tol, err_msg=name)
        np.testing.assert_allclose(r["one"], want, atol=tol, rtol=tol, err_msg=name)


@pytest.fixture(scope="module")
def jax_hybrid():
    """JAX's hybrid engine (``make_mesh(data=2, model=2)``) on ``HYBRID``
    from seed 0, float, INT8 and INT4: {bits: (spec, params, tokens of the
    hybrid prompts)}. Both rank tests hold their hybrid runs to it. (JAX's
    engines fuse nothing under a mesh, so ``fuse_qkv`` plays no part.)"""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    out = {}
    for bits in (None, 8, 4):
        s, p = _jax_params(HYBRID, 0, bits)
        out[bits] = (s, p, _jax_tokens(s, p, _hybrid_prompts(), 9,
                                       mesh=j_make_mesh(data=2, model=2), hybrid_ffn=True))
    return out


def test_four_ranks_offload_hybrid_and_expert_parallel(tmp_path, jax_hybrid):
    """Over 4 ranks: offload at 2 x 2 (JAX's mesh offload spec; the
    resident engine's tokens and logits), ``hybrid_ffn`` at 2 x 2 (float,
    INT8, INT4, Mixtral float and INT8, with offload, with LoRA, an FFN
    the 4 ranks do not divide; one device's tokens), co-scheduled LoRA
    finetuning and the adapter export on the hybrid engine, and EP at
    T = 4 (dense and ragged)."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    oprompts, hprompts = _offload_prompts(), _hybrid_prompts()
    jo, jop = _jax_params(OFFLOAD, 0)
    jh = {bits: v[:2] for bits, v in jax_hybrid.items()}
    jm = {bits: _jax_params(MIXTRAL, 1, bits) for bits in (None, 8)}
    ji = _jax_params(INDIVISIBLE, 2)
    jmoe = _jax_params(MOE, 2)
    stacks = _stacks(HYBRID, 1)
    tokens = _ep_tokens(MOE["vocab_size"])
    hyb = dict(kind="serve", prompts=hprompts, max_new=9, mesh=(2, 2),
               engine=dict(hybrid_ffn=True), runs=("resident",))
    cases = [dict(kind="serve", name="offload", spec=OFFLOAD, params=_numpy_tree(jop),
                  prompts=oprompts, max_new=13, mesh=(2, 2), runs=("resident", "offload")),
             *(dict(hyb, name=f"hybrid-{bits}", spec=HYBRID, params=_numpy_tree(p))
               for bits, (_, p) in jh.items()),
             *(dict(hyb, name=f"mixtral-{bits}", spec=MIXTRAL, params=_numpy_tree(p))
               for bits, (_, p) in jm.items()),
             dict(hyb, name="hybrid-offload", spec=HYBRID, params=_numpy_tree(jh[8][1]),
                  runs=("resident", "offload")),
             dict(hyb, name="hybrid-lora", spec=HYBRID, params=_numpy_tree(jh[None][1]),
                  stacks=stacks),
             dict(hyb, name="indivisible", spec=INDIVISIBLE, params=_numpy_tree(ji[1])),
             dict(hyb, name="hybrid-one", spec=HYBRID, params=_numpy_tree(jh[None][1]),
                  mesh=(2, 2), one=True),
             dict(kind="finetune", name="hybrid-ft", spec=HYBRID, params=_numpy_tree(jh[None][1]),
                  stacks=stacks, prompts=hprompts[:2], max_new=6, data=_ft_data(), mesh=(2, 2),
                  export=str(tmp_path / "hybrid-ft")),
             *(dict(kind="ep", name=f"ep-{impl}", spec=dict(MOE, moe=(4, 2, impl)),
                    params=_numpy_tree(jmoe[1]), tokens=tokens, mesh=(1, 4))
               for impl in ("dense", "ragged"))]
    started = _start(tmp_path, 4, cases, runner=run_layout_cases)
    m22 = j_make_mesh(data=2, model=2)
    want = {"offload": _jax_tokens(jo, jop, oprompts, 13, mesh=m22, offload=True)}
    want.update({f"hybrid-{bits}": v[2] for bits, v in jax_hybrid.items()})
    for bits, (s, p) in jm.items():
        want[f"mixtral-{bits}"] = _jax_tokens(s, p, hprompts, 9, mesh=m22, hybrid_ffn=True)
    want["hybrid-lora"] = _jax_tokens(*jh[None], hprompts, 9, mesh=m22, hybrid_ffn=True,
                                      stacks=stacks)
    want["indivisible"] = _jax_tokens(*ji, hprompts, 9, mesh=m22, hybrid_ffn=True)
    jft = _jax_finetune(*jh[None], stacks, hprompts[:2], 6, _ft_data(), m22)
    ep = _jax_ep_logits(*jmoe, tokens, 4)
    res = _join(tmp_path, 4, started)
    # a group of its own only where both degrees exceed 1
    assert all(r["ffn group"]["offload"] == "own" for r in res)
    _check_finetune(res, "hybrid-ft", jft, tmp_path / "hybrid-ft")
    _check_serve(res, "offload", want["offload"])
    assert [r["offload"]["offload-slots"] for r in res] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    for name in ("hybrid-None", "hybrid-8", "hybrid-4", "mixtral-None", "mixtral-8",
                 "hybrid-lora", "indivisible"):
        _check_serve(res, name, want[name], runs=("resident",))
    # every rank holds every slot under the hybrid FFN; one device's tokens
    assert all(r["hybrid-None"]["resident-slots"] == (0, 4) for r in res)
    _check_serve(res, "hybrid-one", want["hybrid-None"], runs=("resident",))
    _check_serve(res, "hybrid-offload", want["hybrid-8"])
    for impl in ("dense", "ragged"):
        _check_ep(res, f"ep-{impl}", ep)
        assert [r[f"ep-{impl}"]["experts"] for r in res] == [(0,), (1,), (2,), (3,)]


def test_two_ranks_offload_hybrid_and_expert_parallel(tmp_path, jax_hybrid):
    """Over 2 ranks: offload at T = 2 with INT8, INT4, LoRA and chunked
    prefill against JAX's offload mesh engine and the resident mesh engine;
    ``LLM.compile(offload=True, tensor_parallelism_degree=2)``; hybrid at
    data = 2 x model = 1 (float, INT8, INT4) against JAX's hybrid engine;
    EP at T = 2 (dense, ragged, ``E % T != 0``, and INT8 carriers cut
    within each expert)."""
    import transformers

    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    oprompts, hprompts = _offload_prompts(), _hybrid_prompts()
    jq = {bits: _jax_params(OFFLOAD, 4, bits) for bits in (8, 4)}
    jo = _jax_params(OFFLOAD, 5)
    e3 = dict(MOE, moe=(3, 2, "dense"))
    jmoe, je3, jq8 = _jax_params(MOE, 7), _jax_params(e3, 7), _jax_params(MOE, 7, 8)
    stacks = _stacks(OFFLOAD, 2)
    tokens = _ep_tokens(MOE["vocab_size"])
    off = dict(kind="serve", prompts=oprompts, max_new=9, mesh=(1, 2),
               runs=("resident", "offload"), spec=OFFLOAD)
    hyb = dict(kind="serve", prompts=hprompts, max_new=9, mesh=(2, 1),
               engine=dict(hybrid_ffn=True), runs=("resident",), spec=HYBRID)
    cases = [*(dict(off, name=f"offload-int{bits}", params=_numpy_tree(p))
               for bits, (_, p) in jq.items()),
             dict(off, name="offload-lora", params=_numpy_tree(jo[1]), stacks=stacks),
             dict(off, name="offload-chunked", params=_numpy_tree(jo[1]),
                  engine=dict(max_tokens_per_batch=8)),
             *(dict(hyb, name=f"hybrid-{bits}", params=_numpy_tree(p))
               for bits, (_, p, _) in jax_hybrid.items()),
             *(dict(kind="ep", name=f"ep-{impl}", spec=dict(MOE, moe=(4, 2, impl)),
                    params=_numpy_tree(jmoe[1]), tokens=tokens, mesh=(1, 2))
               for impl in ("dense", "ragged")),
             dict(kind="ep", name="ep-e3", spec=e3, params=_numpy_tree(je3[1]), tokens=tokens,
                  mesh=(1, 2)),
             dict(kind="ep", name="ep-int8", spec=MOE, params=_numpy_tree(jq8[1]), tokens=tokens,
                  mesh=(1, 2)),
             dict(kind="llm", name="llm", mesh=(1, 2))]
    d = tmp_path / "model"
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).save_pretrained(d, safe_serialization=True)
    _tokenizer(d)
    started = _start(tmp_path, 2, cases, str(d), runner=run_layout_cases)
    m2 = j_make_mesh(model=2)
    want = {f"offload-int{bits}": _jax_tokens(s, p, oprompts, 9, mesh=m2, offload=True)
            for bits, (s, p) in jq.items()}
    want["offload-lora"] = _jax_tokens(*jo, oprompts, 9, mesh=m2, offload=True, stacks=stacks)
    want["offload-chunked"] = _jax_tokens(*jo, oprompts, 9, mesh=m2, offload=True,
                                          max_tokens_per_batch=8)
    ep, ep3 = _jax_ep_logits(*jmoe, tokens, 2), _jax_ep_logits(*je3, tokens, 2)
    ep8 = _jax_ep_logits(*jq8, tokens, 2)
    res = _join(tmp_path, 2, started)
    assert all(r["ffn group"]["offload-int8"] == "model" for r in res)
    assert all(r["ffn group"]["hybrid-None"] == "data" for r in res)
    for name in ("offload-int8", "offload-int4", "offload-lora", "offload-chunked"):
        _check_serve(res, name, want[name])
    for bits, (_, _, tokens_) in jax_hybrid.items():  # the same values at 2 x 1 as at 2 x 2
        _check_serve(res, f"hybrid-{bits}", tokens_, runs=("resident",))
    for impl in ("dense", "ragged"):
        _check_ep(res, f"ep-{impl}", ep)
        assert [r[f"ep-{impl}"]["experts"] for r in res] == [(0, 1), (2, 3)]
    _check_ep(res, "ep-e3", ep3)
    assert all(r["ep-e3"]["experts"] is None and r["ep-e3"]["wg"][1] == 3 for r in res)
    _check_ep(res, "ep-int8", ep8, tol=1e-4)
    assert all(r["ep-int8"]["experts"] is None for r in res)
    llm = _all(res, "llm")[0]
    assert llm["tp2-offload"] == llm["one"] and all(len(t) == 6 for t in llm["one"])
