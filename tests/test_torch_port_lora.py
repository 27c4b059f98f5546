"""LoRA serving in the port against the JAX package on the CPU (tiny LLaMA of
``tests/test_peft.py``'s widths: vocab 96, d 64, 2 layers, 4 heads on 2 KV
heads): the routed forward and forward_cached at float32 (atol/rtol 1e-4;
the INT8 base at the decoder tests' 1e-5), routing identities, merge_lora,
served greedy tokens equal to JAX's engine, a sampled adapter request, the
HF-PEFT adapter format both ways and against ``peft`` itself, the refusals
(and a co-scheduled finetuning session), and the PEFT CLI (with and without
``-finetuning-dataset``). Adapter stacks are made with numpy from a seed and cross
over through ``params_from_numpy`` / ``lora_from_numpy``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import decoder as jd
from flexflow_tpu.models import params as jp
from flexflow_tpu.peft import lora as jl
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.serving.engine import InferenceEngine as JEngine
from flexflow_tpu.serving.request_manager import GenerationConfig as JGen
from flexflow_tpu.serving.request_manager import RequestManager as JRM
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import decoder as td
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.ops import sampling as t_samp
from flexflow_tpu_torch.peft import lora as tl
from flexflow_tpu_torch.serving.engine import InferenceEngine as TEngine
from flexflow_tpu_torch.serving.request_manager import GenerationConfig as TGen
from flexflow_tpu_torch.serving.request_manager import RequestManager as TRM

torch.set_num_threads(2)

KW = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128, max_position_embeddings=128,
          norm_eps=1e-6)
ALL7 = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
RANK, ALPHA, N = 4, 8.0, 2
JCFG = jl.LoraConfig(rank=RANK, alpha=ALPHA, target_modules=ALL7)
TCFG = tl.LoraConfig(rank=RANK, alpha=ALPHA, target_modules=ALL7)
SCALE = ALPHA / RANK
IDS = [0, 1, -1]
PROMPTS = [[5, 17, 3, 91, 42], [1] * 17, [8, 9, 10, 11, 12, 13, 14, 15, 16]]


def _stacks(seed, b_scale=0.05):
    """numpy adapter stacks in JAX's layout on all seven modules, B non-zero."""
    r = np.random.default_rng(seed)
    out = {}
    for mod in JCFG.keys():
        d_in, d_out = jl._module_dims(jspecs.ModelSpec(**KW), mod)
        out[mod] = {"a": (r.standard_normal((2, N, d_in, RANK)) / np.sqrt(d_in)).astype(np.float32),
                    "b": (r.standard_normal((2, N, RANK, d_out)) * b_scale).astype(np.float32)}
    return out


def _onehot(ids):
    oh = np.zeros((len(ids), N), np.float32)
    for i, a in enumerate(ids):
        if a >= 0:
            oh[i, a] = 1.0
    return jnp.asarray(oh)


@pytest.fixture(scope="module")
def base():
    js, ts = jspecs.ModelSpec(**KW), tspecs.ModelSpec(**KW)
    jparams = jp.init_params(js, jax.random.PRNGKey(0), jnp.float32)
    return js, jparams, ts, tp.params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def stacks():
    return _stacks(1)


def _variant(base, variant):
    js, jparams, ts, tparams = base
    if variant == "int8":
        jparams = j_quant_params(js, jparams, bits=8, group_size=32, compute_dtype=jnp.float32)
        tparams = tp.params_from_numpy(jparams)
    if variant in ("fused", "int8"):
        jparams, tparams = jd.fuse_qkv_params(js, jparams), td.fuse_qkv_params(ts, tparams)
        assert "wqkv" in tparams["layers"] and "wgu" in tparams["layers"]
    return jparams, tparams


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("mode", ["forward", "forward_cached"])
@pytest.mark.parametrize("variant", ["unfused", "fused", "int8"])
def test_routed_forward_matches_jax(base, stacks, variant, mode):
    """Rows routed to adapters 0 and 1 and to none, through every projection."""
    js, _, ts, _ = base
    jparams, tparams = _variant(base, variant)
    tol = 1e-5 if variant == "int8" else 1e-4
    jlora = jax.tree.map(jnp.asarray, stacks)
    routed = tl.route_lora(tp.lora_from_numpy(stacks))
    ids = torch.tensor(IDS)
    r = np.random.default_rng(2)
    jkw = dict(lora=jlora, adapter_onehot=_onehot(IDS), lora_scale=SCALE)
    tkw = dict(lora=routed, adapter_ids=ids, lora_scale=SCALE)
    if mode == "forward":
        tok = r.integers(0, 96, (3, 9)).astype(np.int32)
        pos = np.broadcast_to(np.arange(9, dtype=np.int32), (3, 9)).copy()
        lens = np.array([9, 6, 9], np.int32)
        jlog, _ = jd.forward(js, jparams, jnp.asarray(tok), jnp.asarray(pos),
                             lengths=jnp.asarray(lens), flash=True, **jkw)
        tlog, _ = td.forward(ts, tparams, torch.tensor(tok), torch.tensor(pos),
                             lengths=torch.tensor(lens), flash=True, **tkw)
        for i, n in enumerate(lens):
            _close(tlog[i, :n], np.asarray(jlog)[i, :n], tol)
        base_log, _ = td.forward(ts, tparams, torch.tensor(tok), torch.tensor(pos),
                                 lengths=torch.tensor(lens), flash=True)
    else:
        tok = r.integers(0, 96, (3, 1)).astype(np.int32)
        lens = np.array([4, 0, 11], np.int32)
        shape = (2, 3, 2, 16, 16)  # [L, B, KH, D, S]
        ck, cv = (r.standard_normal(shape).astype(np.float32) for _ in range(2))
        jlog, jc = jd.forward_cached(js, jparams, jnp.asarray(tok),
                                     jd.KVCache(jnp.asarray(ck), jnp.asarray(cv)),
                                     jnp.asarray(lens), **jkw)
        tc = tp.kv_cache_from_numpy(ck, cv)
        tlog, _ = td.forward_cached(ts, tparams, torch.tensor(tok), tc, torch.tensor(lens), **tkw)
        _close(tlog, jlog, tol)
        want = tp.kv_cache_from_numpy(np.asarray(jc.k), np.asarray(jc.v))
        _close(tc.k, want.k.numpy(), tol)
        _close(tc.v, want.v.numpy(), tol)
        base_log, _ = td.forward_cached(ts, tparams, torch.tensor(tok),
                                        tp.kv_cache_from_numpy(ck, cv), torch.tensor(lens))
    # the adapters act on their rows; the row routed to -1 is the base bit for bit
    assert all((tlog[i] - base_log[i]).abs().max() > 1e-2 for i in (0, 1))
    assert torch.equal(tlog[2], base_log[2])


def _logits(ts, tparams, tok, lora=None, ids=None):
    pos = torch.arange(tok.shape[1], dtype=torch.int32)[None].expand(tok.shape)
    kw = {} if lora is None else dict(lora=lora, adapter_ids=torch.tensor(ids), lora_scale=SCALE)
    return td.forward(ts, tparams, torch.tensor(tok), pos, **kw)[0]


def test_zero_b_is_identity(base):
    _, _, ts, tparams = base
    lora = tl.init_lora_params(ts, TCFG, N, torch.Generator().manual_seed(3))
    assert all(not ab["b"].any() for ab in lora.values())
    tok = np.array([[3, 17, 91, 5], [6, 7, 8, 9]], np.int32)
    got = _logits(ts, tparams, tok, tl.route_lora(lora), [0, 1])
    assert torch.equal(got, _logits(ts, tparams, tok))


def test_routed_equals_merged(base, stacks):
    """A routed row equals the merged dense weights' forward; the port's
    merge_lora equals JAX's."""
    js, jparams, ts, tparams = base
    tlora = tp.lora_from_numpy(stacks)
    routed = tl.route_lora(tlora)
    tok = np.array([[3, 17, 91, 5, 8]], np.int32)
    for adapter in range(N):
        merged = tl.merge_lora(ts, tparams, tlora, adapter, TCFG)
        jmerged = jl.merge_lora(js, jparams, jax.tree.map(jnp.asarray, stacks), adapter, JCFG)
        for mod in TCFG.keys():
            _close(merged["layers"][mod], jmerged["layers"][mod], 1e-6)
        _close(_logits(ts, tparams, tok, routed, [adapter]), _logits(ts, merged, tok), 1e-4)


def test_mixed_batch_rows_equal_single_rows(base, stacks):
    """[0, 1, -1] in one batch: each row as its own single-row run, and the
    -1 row bitwise the no-LoRA forward of the same batch."""
    _, _, ts, tparams = base
    routed = tl.route_lora(tp.lora_from_numpy(stacks))
    tok = np.array([[3, 17, 91, 5], [3, 17, 91, 5], [3, 17, 91, 5]], np.int32)
    mixed = _logits(ts, tparams, tok, routed, IDS)
    for i, a in enumerate(IDS):
        one = _logits(ts, tparams, tok[i:i + 1], routed, [a])
        _close(mixed[i], one[0].numpy(), 1e-5)
    assert torch.equal(mixed[2], _logits(ts, tparams, tok)[2])
    assert not torch.equal(mixed[0], mixed[1])


def test_lora_from_numpy_widens_bf16_and_checks_layout(stacks):
    j16 = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), stacks)
    got = tp.lora_from_numpy(j16, dtype=torch.bfloat16)
    want = np.asarray(jnp.asarray(stacks["wq"]["a"], jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got["wq"]["a"].float().numpy(), want)
    with pytest.raises(ValueError, match="expected"):
        tp.lora_from_numpy({"wq": {"a": stacks["wq"]["a"][0]}})


def _serve_both(base, stacks, horizon, pipelined, budget, adapters=IDS, max_new=8):
    js, jparams, ts, tparams = base
    kw = dict(max_requests_per_batch=2, max_seq_len=64, max_tokens_per_batch=budget)
    jrm = JRM(JEngine(js, jparams, cache_dtype=jnp.float32,
                      lora=jax.tree.map(jnp.asarray, stacks), lora_config=JCFG, **kw),
              decode_horizon=horizon, pipelined=pipelined)
    jg = [jrm.register_request(p, JGen(max_new_tokens=max_new, adapter_id=a))
          for p, a in zip(PROMPTS, adapters)]
    jrm.run_until_idle()
    trm = TRM(TEngine(ts, tparams, cache_dtype=torch.float32, device="cpu",
                      lora=tp.lora_from_numpy(stacks), lora_config=TCFG, **kw),
              decode_horizon=horizon, pipelined=pipelined)
    try:
        tg = [trm.register_request(p, TGen(max_new_tokens=max_new, adapter_id=a))
              for p, a in zip(PROMPTS, adapters)]
        trm.run_until_idle()
        assert (trm._adapter == -1).all()  # every slot released
        return ([jrm.get_request(g).output_tokens for g in jg],
                [trm.get_request(g).output_tokens for g in tg])
    finally:
        trm.close()


@pytest.mark.parametrize("horizon,pipelined,budget", [(1, False, 0), (8, True, 0), (4, True, 8)],
                         ids=["h1", "h8-pipe", "chunked"])
def test_served_greedy_tokens_equal_jax(base, stacks, horizon, pipelined, budget):
    """Requests routed [0, 1, -1] on two slots (the third is admitted when a
    slot frees), batched or chunked prefill, eager or pipelined horizons."""
    want, got = _serve_both(base, stacks, horizon, pipelined, budget)
    assert got == want and all(len(t) == 8 for t in got)


def test_base_request_equals_engine_without_lora(base, stacks):
    _, _, ts, tparams = base
    kw = dict(max_requests_per_batch=2, max_seq_len=64, cache_dtype=torch.float32, device="cpu")
    out = []
    for lora in (tp.lora_from_numpy(stacks), None):
        rm = TRM(TEngine(ts, tparams, lora=lora, lora_config=TCFG, **kw), decode_horizon=4,
                 pipelined=True)
        try:
            out.append([r.output_tokens for r in rm.generate(PROMPTS, TGen(max_new_tokens=10))])
        finally:
            rm.close()
    assert out[0] == out[1]


def test_sampled_adapter_request_draws_from_the_adapter(base):
    """A sampled request with an adapter runs the eager horizon to its
    budget; the eager step's draws follow the adapter's next-token
    distribution (2000 draws, within 4 standard errors), not the base's."""
    _, _, ts, tparams = base
    stacks = _stacks(4, b_scale=0.5)
    eng = TEngine(ts, tparams, max_requests_per_batch=4, max_seq_len=32,
                  cache_dtype=torch.float32, device="cpu", lora=tp.lora_from_numpy(stacks),
                  lora_config=TCFG)
    rm = TRM(eng, decode_horizon=4, pipelined=True)
    try:
        [req] = rm.generate([PROMPTS[0]], TGen(max_new_tokens=6, temperature=1.0, adapter_id=1))
    finally:
        rm.close()
    assert req.state == "COMPLETED" and len(req.output_tokens) == 6
    prompt, nxt = PROMPTS[0], 7
    greedy = t_samp.SamplingConfig(np.zeros(4, np.float32), np.ones(4, np.float32),
                                   np.zeros(4, np.int32))
    eng.prefill_batch_to_slots_async([prompt] * 4, [0, 1, 2, 3], 0, greedy, adapter_ids=[1] * 4)
    cfg = greedy._replace(temperature=np.ones(4, np.float32))
    lens, toks = [len(prompt)] * 4, [nxt] * 4
    draws = np.concatenate([eng.decode_horizon(lens, toks, k, cfg, 1, adapter_ids=[1] * 4)[0]
                            for k in range(500)])
    freq = np.bincount(draws, minlength=96) / len(draws)
    tok = np.array([prompt + [nxt]], np.int32)
    want = torch.softmax(_logits(ts, tparams, tok, eng.lora, [1])[0, -1], -1).numpy()
    base_p = torch.softmax(_logits(ts, tparams, tok)[0, -1], -1).numpy()
    atol = 4 * np.sqrt(want.max() * (1 - want.max()) / len(draws))
    np.testing.assert_allclose(freq, want, atol=atol)
    assert np.abs(freq - base_p).max() > 2 * atol


def test_hf_adapter_round_trips_with_jax(tmp_path, stacks):
    """Port export -> JAX load gives the port's stacks bit for bit (the
    other slot untouched), and both packages' loaders read a JAX export
    into equal stacks. (JAX's writer hands ``safetensors`` transposed
    views, which safetensors 0.8 writes by their buffer, so that file does
    not hold JAX's stacks; the port's writer makes each array contiguous.)"""
    js, ts = jspecs.ModelSpec(**KW), tspecs.ModelSpec(**KW)
    tl.export_hf_adapter(str(tmp_path / "t"), ts, tp.lora_from_numpy(stacks), 0, TCFG)
    jcfg = jl.load_hf_adapter_config(str(tmp_path / "t"))
    assert (jcfg.rank, jcfg.alpha, jcfg.keys()) == (RANK, ALPHA, JCFG.keys())
    fresh = jl.init_lora_params(js, JCFG, N, jax.random.PRNGKey(0))
    back = jl.load_hf_adapter_into_slot(str(tmp_path / "t"), js, fresh, 0, jcfg)
    for mod, ab in stacks.items():
        np.testing.assert_array_equal(np.asarray(back[mod]["a"])[:, 0], ab["a"][:, 0])
        np.testing.assert_array_equal(np.asarray(back[mod]["b"])[:, 0], ab["b"][:, 0])
        np.testing.assert_array_equal(np.asarray(back[mod]["a"])[:, 1],
                                      np.asarray(fresh[mod]["a"])[:, 1])
    jl.export_hf_adapter(str(tmp_path / "j"), js, jax.tree.map(jnp.asarray, stacks), 1, JCFG)
    want = jl.load_hf_adapter_into_slot(str(tmp_path / "j"), js, fresh, 1, JCFG)
    got = tl.load_hf_adapter_into_slot(
        str(tmp_path / "j"), ts, tp.lora_from_numpy(jax.tree.map(np.asarray, fresh)), 1,
        tl.load_hf_adapter_config(str(tmp_path / "j")))
    for mod in stacks:
        for ab in ("a", "b"):
            np.testing.assert_array_equal(got[mod][ab].numpy(), np.asarray(want[mod][ab]))


@pytest.fixture(scope="module")
def hf_peft(tmp_path_factory):
    """A tiny HF LLaMA directory with a byte-level tokenizer, and an HF PEFT
    adapter on all seven modules (B randomised) saved beside it; returns
    (model dir, adapter dir, the peft model)."""
    transformers = pytest.importorskip("transformers")
    peft = pytest.importorskip("peft")
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_llama_lora")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    model = transformers.LlamaForCausalLM(cfg).float()
    model.save_pretrained(d / "model", safe_serialization=True)
    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "model" / "tokenizer.json"))
    with open(d / "model" / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
    pmodel = peft.get_peft_model(model, peft.LoraConfig(
        r=RANK, lora_alpha=ALPHA, target_modules=list(ALL7), lora_dropout=0.0, bias="none",
        task_type="CAUSAL_LM"))
    with torch.no_grad():
        for name, w in pmodel.named_parameters():
            if "lora_B" in name:
                w.normal_(0.0, 0.1)
    pmodel.save_pretrained(d / "adapter")
    return str(d / "model"), str(d / "adapter"), pmodel.eval()


def test_hf_peft_oracle(hf_peft):
    """``peft``'s own logits against the port's LLM.register_peft_adapter
    route (within 2e-4), and greedy tokens through generate(adapter_id=)."""
    from flexflow_tpu_torch.serve import LLM

    model_dir, adapter_dir, pmodel = hf_peft
    llm = LLM(model_dir, data_type="float32", device="cpu")
    llm.register_peft_adapter(tl.LoraConfig(rank=RANK, alpha=ALPHA, target_modules=ALL7))
    slot = llm.register_peft_adapter(adapter_dir)
    llm.compile(max_requests_per_batch=2, max_seq_length=64)
    eng = llm.rm.engine
    tok = np.random.default_rng(5).integers(0, 95, (1, 12)).astype(np.int32)
    with torch.no_grad():
        want = pmodel(input_ids=torch.tensor(tok, dtype=torch.long)).logits[0]
        base = pmodel.get_base_model()
        with pmodel.disable_adapter():
            plain = base(input_ids=torch.tensor(tok, dtype=torch.long)).logits[0]
    got = _logits(llm.spec, eng.params, tok, eng.lora, [slot])[0]
    assert (got - want).abs().max() <= 2e-4
    assert (want - plain).abs().max() > 1e-2  # the adapter acts
    fresh = _logits(llm.spec, eng.params, tok, eng.lora, [0])[0]  # B zero: the base model
    assert (fresh - plain).abs().max() <= 2e-4
    [res] = llm.generate("hello world", max_new_tokens=6, adapter_id=slot)
    ids = torch.tensor([llm.tokenizer("hello world")["input_ids"]])
    with torch.no_grad():
        hf = pmodel.generate(input_ids=ids, max_new_tokens=6, do_sample=False)[0, ids.shape[1]:]
    assert res.output_tokens == hf.tolist()
    llm.rm.close()


def test_refusals(hf_peft):
    """Adapters under speculation, adapters of another rank and an adapter id
    the engine does not hold are refused; a co-scheduled finetuning session
    registers and trains (its slot only) while a request is served."""
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.serve import LLM, SSM
    from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine

    model_dir, adapter_dir, _ = hf_peft
    ts = tspecs.ModelSpec(**KW)
    tparams = tp.init_params(ts, 0)
    srm = SpecRequestManager(SpecEngine(ts, tparams, ts, tparams, beam_width=1, beam_depth=1,
                                        max_requests_per_batch=1, max_seq_len=64,
                                        cache_dtype=torch.float32, device="cpu"))
    with pytest.raises(NotImplementedError, match="speculative"):
        srm.register_request([1, 2, 3], TGen(adapter_id=0))
    rm = TRM(TEngine(ts, tparams, max_requests_per_batch=1, max_seq_len=32, device="cpu",
                     lora=tp.lora_from_numpy(_stacks(0)), lora_config=TCFG))
    toks = np.random.default_rng(3).integers(0, 96, (2, 10)).astype(np.int32)
    session = FinetuneSession(ts, tl.LoraConfig(rank=RANK, alpha=ALPHA, target_modules=ALL7,
                                                learning_rate=0.05),
                              1, [(toks, np.roll(toks, -1, axis=1))], epochs=3)
    slot0 = {m: rm.engine.lora.a[m][..., :RANK].clone() for m in rm.engine.lora.a}
    try:
        rm.register_finetune(session)
        [req] = rm.generate([[1, 2, 3]], TGen(max_new_tokens=2))
        with pytest.raises(ValueError, match="holds 2 adapters"):
            rm.register_request([1, 2, 3], TGen(adapter_id=2))
    finally:
        rm.close()
    assert len(req.output_tokens) == 2 and len(session.losses) == 3
    assert all(torch.equal(rm.engine.lora.a[m][..., :RANK], a) for m, a in slot0.items())
    llm = LLM(model_dir, data_type="float32", device="cpu")
    llm.register_peft_adapter(adapter_dir)
    with pytest.raises(ValueError, match="share rank"):
        llm.register_peft_adapter(tl.LoraConfig(rank=RANK * 2, target_modules=ALL7))
    with pytest.raises(NotImplementedError, match="speculative"):
        llm.compile(ssms=[SSM(model_dir, data_type="float32", device="cpu")])


def test_cli_parser_and_text_match_jax(hf_peft, tmp_path, capsys):
    """The PEFT CLI takes JAX's flags (every dest, plus --device) and prints
    the JAX CLI's text serving an HF PEFT adapter at --full-precision."""
    from flexflow_tpu_torch.inference import peft as t_cli
    from inference import peft as j_cli

    def dests(p):
        return {a.dest for a in p._actions if a.dest != "help"}

    assert dests(t_cli.build_parser()) == dests(j_cli.build_parser()) | {"device"}
    model_dir, adapter_dir, _ = hf_peft
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", model_dir, "-enable-peft", "-peft-model", adapter_dir, "-prompt",
            str(prompts), "--max-new-tokens", "8", "--max-sequence-length", "64",
            "--max-requests-per-batch", "2", "--full-precision"]
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert t_cli.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    texts = [[ln for ln in out.splitlines() if not ln.startswith("=== guid")]
             for out in (got, want)]
    assert got.count("=== guid") == 2 and texts[0] == texts[1]
    # co-scheduled finetuning of a second slot: the served text stays the adapter's
    assert t_cli.main(argv + ["-finetuning-dataset", str(prompts), "--device", "cpu"]) == 0
    tuned = capsys.readouterr().out
    assert "[Finetune] steps 2 losses" in tuned
    assert [ln for ln in tuned.splitlines()
            if not ln.startswith(("=== guid", "[Finetune]"))] == texts[1]
