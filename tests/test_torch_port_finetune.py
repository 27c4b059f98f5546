"""Co-scheduled LoRA finetuning in the port against the JAX package on the
CPU (f32, ``tests/test_peft.py``'s tiny LLaMA: vocab 96, d 64, 2 layers):
``FinetuneSession`` losses and the trained slot's A / B over 20 steps on a
float, an INT8 and an INT4 base (rtol 1e-4), the session co-scheduled with
serving (tokens equal to JAX's, the routed tensors updated in place, every
other slot and the base bitwise unchanged), ``QuantMatmulFn``'s dx against
autograd of the plain dequant + matmul (1e-5), and the PEFT CLI with
``-finetuning-dataset`` and ``--save-peft`` against JAX's CLI."""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.peft import lora as jl
from flexflow_tpu.peft.finetune import FinetuneSession as JSession
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.serving.engine import InferenceEngine as JEngine
from flexflow_tpu.serving.request_manager import GenerationConfig as JGen
from flexflow_tpu.serving.request_manager import RequestManager as JRM
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.ops.kernels import quant_matmul as tqm
from flexflow_tpu_torch.peft import lora as tl
from flexflow_tpu_torch.peft.finetune import FinetuneSession as TSession
from flexflow_tpu_torch.quant.weight_only import quantize
from flexflow_tpu_torch.serving.engine import InferenceEngine as TEngine
from flexflow_tpu_torch.serving.request_manager import GenerationConfig as TGen
from flexflow_tpu_torch.serving.request_manager import RequestManager as TRM

torch.set_num_threads(2)

KW = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, intermediate_size=128, max_position_embeddings=128,
          norm_eps=1e-6)
MODS = ("wq", "wv", "wd")
RANK, ALPHA, N = 4, 8.0, 2


def _cfgs(lr=5e-2, optimizer="sgd"):
    kw = dict(rank=RANK, alpha=ALPHA, target_modules=MODS, learning_rate=lr, optimizer=optimizer)
    return jl.LoraConfig(**kw), tl.LoraConfig(**kw)


def _stacks(seed, b_std=0.0):
    """numpy adapter stacks on wq, wv, wd (JAX's layout); B zero by default."""
    r = np.random.default_rng(seed)
    out = {}
    for mod in MODS:
        d_in, d_out = jl._module_dims(jspecs.ModelSpec(**KW), mod)
        out[mod] = {"a": (r.standard_normal((2, N, d_in, RANK)) / np.sqrt(d_in)).astype(np.float32),
                    "b": (r.standard_normal((2, N, RANK, d_out)) * b_std).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def bases():
    js, ts = jspecs.ModelSpec(**KW), tspecs.ModelSpec(**KW)
    jparams = jp.init_params(js, jax.random.PRNGKey(0), jnp.float32)
    out = {}
    for name, bits in (("float", None), ("int8", 8), ("int4", 4)):
        jpar = jparams if bits is None else j_quant_params(
            js, jparams, bits=bits, group_size=32, compute_dtype=jnp.float32)
        out[name] = (js, jpar, ts, tp.params_from_numpy(jax.tree.map(np.asarray, jpar)))
    return out


def _data(n=2, b=2, t=12, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, KW["vocab_size"], size=(b, t)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _engines(base, stacks, jcfg, tcfg, **kw):
    js, jpar, ts, tpar = base
    je = JEngine(js, jpar, max_requests_per_batch=2, max_seq_len=64, cache_dtype=jnp.float32,
                 lora=jax.tree.map(jnp.asarray, stacks), lora_config=jcfg, **kw)
    te = TEngine(ts, tpar, max_requests_per_batch=2, max_seq_len=64, cache_dtype=torch.float32,
                 device="cpu", lora=tp.lora_from_numpy(stacks), lora_config=tcfg)
    return je, te


def _close_slot(je, te, slot, rtol):
    got = tl.unroute_lora(te.lora)
    for mod in MODS:
        for k in ("a", "b"):
            want = np.asarray(je.lora[mod][k])[:, slot]
            np.testing.assert_allclose(got[mod][k][:, slot].numpy(), want, rtol=rtol,
                                       atol=rtol * np.abs(want).max(), err_msg=f"{mod}.{k}")


@pytest.mark.parametrize("base_name,optimizer", [
    ("float", "sgd"), ("int8", "sgd"), ("int4", "sgd"), ("float", "adam")])
def test_finetune_session_matches_jax(bases, base_name, optimizer):
    """20 steps (10 epochs of 2 batches) on slot 1: losses and the trained A
    and B within rtol 1e-4 (Adam by its losses: its first update is about
    lr * sign(g)); slot 0 keeps its bits."""
    stacks = _stacks(1, b_std=0.05)
    jcfg, tcfg = _cfgs(5e-2 if optimizer == "sgd" else 5e-3, optimizer)
    je, te = _engines(bases[base_name], stacks, jcfg, tcfg)
    data = _data()
    js_, ts_ = (JSession(bases[base_name][0], jcfg, 1, data, epochs=10),
                TSession(bases[base_name][2], tcfg, 1, data, epochs=10))
    while not js_.tick(je):
        pass
    while not ts_.tick(te):
        pass
    assert len(ts_.losses) == len(js_.losses) == 20 and ts_.tick(te)
    np.testing.assert_allclose(ts_.losses, js_.losses, rtol=1e-4)
    assert ts_.losses[-1] < ts_.losses[0]
    if optimizer == "sgd":
        _close_slot(je, te, 1, 1e-4)
    back = tl.unroute_lora(te.lora)
    for mod in MODS:
        for k in ("a", "b"):
            assert np.array_equal(back[mod][k][:, 0].numpy(), stacks[mod][k][:, 0])


@pytest.mark.parametrize("pipelined", [False, True], ids=["stepwise", "pipelined"])
def test_finetune_coscheduled_matches_jax(bases, pipelined):
    """``test_peft.py::test_finetune_coscheduled``'s recipe with the request
    routed through the slot being trained (its tokens follow every step) and
    another through slot 0: tokens equal to JAX's, stepwise and with
    pipelined 4-step horizons; the routed tensors trained in place; slot 0,
    the base and the session count as in JAX."""
    stacks = _stacks(2, b_std=0.05)
    jcfg, tcfg = _cfgs()
    je, te = _engines(bases["float"], stacks, jcfg, tcfg)
    kw = dict(decode_horizon=4, pipelined=True) if pipelined else {}
    jrm, trm = JRM(je, **kw), TRM(te, **kw)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, KW["vocab_size"], size=(4, 12)).astype(np.int32)
    data = [(toks, np.roll(toks, -1, axis=1))]
    jsess = JSession(bases["float"][0], jcfg, 1, data, epochs=20)
    tsess = TSession(bases["float"][2], tcfg, 1, data, epochs=20)
    jrm.register_finetune(jsess)
    trm.register_finetune(tsess)
    ptrs = {m: (te.lora.a[m].data_ptr(), te.lora.b[m].data_ptr()) for m in MODS}
    base_before = {k: v.clone() for k, v in te.params["layers"].items()
                   if isinstance(v, torch.Tensor)}
    try:
        prompts = [[3, 17, 91], [5, 6, 7, 8, 9]]
        want = [jrm.generate([p], JGen(max_new_tokens=6, adapter_id=a))[0].output_tokens
                for p, a in zip(prompts, (1, 0))]
        got = [trm.generate([p], TGen(max_new_tokens=6, adapter_id=a))[0].output_tokens
               for p, a in zip(prompts, (1, 0))]
    finally:
        trm.close()
    assert got == want
    assert len(tsess.losses) == len(jsess.losses) == 20
    np.testing.assert_allclose(tsess.losses, jsess.losses, rtol=1e-4)
    assert tsess.losses[-1] < tsess.losses[0]
    assert {m: (te.lora.a[m].data_ptr(), te.lora.b[m].data_ptr()) for m in MODS} == ptrs
    assert all(torch.equal(te.params["layers"][k], v) for k, v in base_before.items())
    back = tl.unroute_lora(te.lora)
    for mod in MODS:
        assert np.array_equal(back[mod]["a"][:, 0].numpy(), stacks[mod]["a"][:, 0])
        assert np.array_equal(back[mod]["b"][:, 0].numpy(), stacks[mod]["b"][:, 0])
        assert not np.array_equal(back[mod]["b"][:, 1].numpy(), stacks[mod]["b"][:, 1])
    _close_slot(je, te, 1, 1e-4)


def test_finetune_refuses_an_engine_without_the_slot(bases):
    jcfg, tcfg = _cfgs()
    _, te = _engines(bases["float"], _stacks(3), jcfg, tcfg)
    with pytest.raises(ValueError, match="holds 2 adapters"):
        TSession(bases["float"][2], tcfg, 2, _data()).tick(te)
    plain = TEngine(bases["float"][2], bases["float"][3], max_requests_per_batch=1,
                    max_seq_len=32, device="cpu")
    with pytest.raises(ValueError, match="no LoRA adapters"):
        TSession(bases["float"][2], tcfg, 0, _data()).tick(plain)


def test_unroute_inverts_route():
    stacks = tp.lora_from_numpy(_stacks(4, b_std=0.1))
    back = tl.unroute_lora(tl.route_lora(stacks))
    for mod in MODS:
        for k in ("a", "b"):
            assert torch.equal(back[mod][k], stacks[mod][k])


_QMM_CASES = {  # (bits, stacked dims, layer, expert)
    "int8-2d": (8, (), None, None), "int8-layer": (8, (3,), 2, None),
    "int8-expert": (8, (2, 3), 1, 2), "int4-layer": (4, (3,), 1, None),
    "int4-expert": (4, (2, 3), 1, 0),
}


@pytest.mark.parametrize("case", sorted(_QMM_CASES))
def test_quant_matmul_fn_dx_matches_plain(case):
    """The Function's forward equals the plain version and its dx equals
    autograd of the plain dequant + matmul at f32 (1e-5); the carriers get
    no gradient, and a call without a gradient does not go through it."""
    bits, batch, layer, expert = _QMM_CASES[case]
    gen = torch.Generator().manual_seed(7)
    d, (h, dh) = 64, (4, 12)  # contraction over [4, 16] (two contract dims), out 48
    w = torch.randn((*batch, 4, 16, h * dh), generator=gen) * 0.1
    qa = quantize(w, bits, 16, batch_dims=len(batch), contract_dims=2)
    x = torch.randn((2, 3, 4, 16), generator=gen, requires_grad=True)
    x_plain = x.detach().clone().requires_grad_()
    before = tqm.BACKWARD_CALLS
    out = tqm.quant_matmul(x, qa, layer=layer, expert=expert)
    want = tqm.quant_matmul_plain(x_plain, qa, layer=layer, expert=expert)
    assert type(out.grad_fn.next_functions[0][0]).__name__ == "QuantMatmulFnBackward"
    assert out.shape == want.shape == (2, 3, h * dh)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    dy = torch.randn(out.shape, generator=gen)
    out.backward(dy)
    want.backward(dy)
    assert tqm.BACKWARD_CALLS == before + 1
    torch.testing.assert_close(x.grad, x_plain.grad, rtol=1e-5, atol=1e-5)
    assert not qa.q.requires_grad and qa.scale.grad is None
    with torch.no_grad():
        assert tqm.quant_matmul(x, qa, layer=layer, expert=expert).grad_fn is None
    del d


@pytest.fixture(scope="module")
def tiny_model_dir(tmp_path_factory):
    """A tiny HF LLaMA directory (``test_peft.py``'s widths) with a
    byte-level tokenizer, and a json list of training strings."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    d = tmp_path_factory.mktemp("tiny_llama_finetune")
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).float().save_pretrained(d / "model",
                                                               safe_serialization=True)
    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "model" / "tokenizer.json"))
    with open(d / "model" / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
    (d / "prompts.json").write_text(json.dumps(["hello world", "abc def"]))
    (d / "texts.json").write_text(json.dumps(
        ["the quick brown fox jumps over the lazy dog", "a", "lorem ipsum dolor sit amet"]))
    return d


def _same_adapters(monkeypatch, rank):
    """Both packages' LLM builds its fresh adapters from one numpy draw (A
    from seed 9, B zero): jax.random and torch draw other numbers."""
    import flexflow_tpu.peft.lora as jl_mod
    import flexflow_tpu_torch.serve as t_serve

    def draw(spec, cfg, n):
        r = np.random.default_rng(9)
        out = {}
        for mod in cfg.keys():
            d_in, d_out = tl._module_dims(spec, mod)
            out[mod] = {"a": (r.standard_normal((spec.num_layers, n, d_in, rank))
                              / np.sqrt(d_in)).astype(np.float32),
                        "b": np.zeros((spec.num_layers, n, rank, d_out), np.float32)}
        return out

    monkeypatch.setattr(jl_mod, "init_lora_params", lambda spec, cfg, n, key, dtype=None:
                        jax.tree.map(jnp.asarray, draw(spec, cfg, n)))
    monkeypatch.setattr(t_serve, "init_lora_params",
                        lambda spec, cfg, n, gen, dtype=None, device="cpu":
                        tp.lora_from_numpy(draw(spec, cfg, n), device, dtype))


def test_cli_finetune_and_save_peft_match_jax(tiny_model_dir, tmp_path, monkeypatch, capsys):
    """``-finetuning-dataset`` and ``--save-peft`` at --full-precision: the
    served text, the ``[Finetune]`` step count and losses (within 1e-4, as
    printed) equal JAX's CLI's; the exported adapter, read by JAX's loader,
    equals the port's trained slot bitwise and JAX's trained values within
    rtol 1e-4 (JAX's export writes each transposed view by its buffer, a
    fault of the reference: its values are read back from that buffer)."""
    import safetensors.numpy

    import flexflow_tpu_torch.serve as t_serve
    from flexflow_tpu_torch.inference import peft as t_cli
    from inference import peft as j_cli

    _same_adapters(monkeypatch, 4)
    made = []
    compile_ = t_serve.LLM.compile
    monkeypatch.setattr(t_serve.LLM, "compile",
                        lambda self, **kw: (made.append(self), compile_(self, **kw))[1])
    d = tiny_model_dir
    argv = ["-llm-model", str(d / "model"), "-enable-peft", "-prompt", str(d / "prompts.json"),
            "-finetuning-dataset", str(d / "texts.json"), "--max-training-steps", "5",
            "--learning-rate", "0.05", "--lora-rank", "4", "--lora-alpha", "8",
            "--max-new-tokens", "8", "--max-sequence-length", "64",
            "--max-requests-per-batch", "2", "--full-precision"]
    assert j_cli.main(argv + ["--save-peft", str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out
    assert t_cli.main(argv + ["--save-peft", str(tmp_path / "port"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out

    def text(out):
        return [ln for ln in out.splitlines()
                if not ln.startswith(("=== guid", "[Finetune]"))]

    def losses(out):
        line = next(ln for ln in out.splitlines() if ln.startswith("[Finetune] steps"))
        steps = int(re.match(r"\[Finetune\] steps (\d+)", line).group(1))
        return steps, [float(v) for v in re.findall(r"'(-?[\d.]+)'", line)]

    assert text(got) == text(want) and got.count("=== guid") == 2
    (n_got, l_got), (n_want, l_want) = losses(got), losses(want)
    assert n_got == n_want == 5 and len(l_got) == 5
    np.testing.assert_allclose(l_got, l_want, atol=1e-4 + 1e-9)  # 4 decimals as printed
    assert f"[Finetune] adapter saved to {tmp_path / 'port'}" in got
    js = jspecs.ModelSpec(**KW)
    cfg = jl.LoraConfig(rank=4, alpha=8.0, target_modules=("wq", "wv"))
    zeros = {m: {"a": jnp.zeros((2, 1, jl._module_dims(js, m)[0], 4)),
                 "b": jnp.zeros((2, 1, 4, jl._module_dims(js, m)[1]))} for m in cfg.keys()}
    port = jl.load_hf_adapter_into_slot(str(tmp_path / "port"), js, zeros, 0, cfg)
    trained = tl.unroute_lora(made[0].rm.engine.lora)
    ref = safetensors.numpy.load_file(str(tmp_path / "jax" / "adapter_model.safetensors"))
    for mod, hf in (("wq", "q_proj"), ("wv", "v_proj")):
        assert float(jnp.abs(port[mod]["b"]).max()) > 0
        for k, part in (("a", "lora_A"), ("b", "lora_B")):
            assert np.array_equal(np.asarray(port[mod][k])[:, 0], trained[mod][k][:, 1].numpy())
            for layer in range(2):
                raw = ref[f"base_model.model.model.layers.{layer}.self_attn.{hf}.{part}.weight"]
                np.testing.assert_allclose(np.asarray(port[mod][k])[layer, 0],
                                           raw.reshape(raw.shape[::-1]), rtol=1e-4,
                                           atol=1e-4 * np.abs(raw).max())
