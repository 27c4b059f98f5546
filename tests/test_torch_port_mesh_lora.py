"""LoRA serving and co-scheduled PEFT finetuning of the port over gloo ranks
on the CPU (the spawn helpers of ``test_torch_port_mesh_serving.py``),
held against the JAX package's ``InferenceEngine(mesh=, lora=)`` and
``FinetuneSession`` on a mesh engine at float32:

- two adapters on all seven projections (column cuts: ``b``'s columns;
  row cuts wo / wd: ``x @ a`` summed over the model ranks) at T = 2, D = 2
  and 2 x 2, and MQA at T = 2 (K/V projected whole, wk / wv's ``b`` whole):
  greedy tokens equal to JAX's mesh engine's; a row routed to -1 keeps the
  base output bit for bit; INT8 at T = 2 within the quant-matmul tests'
  tolerances of JAX's one-device logits;
- 2 SGD steps co-scheduled with serving at T = 2 (and D = 2: every data
  rank runs the same step, the adapters equal bit for bit): tokens, losses
  and the gathered slot within 1e-5 of JAX's;
- the PEFT CLI with ``-tensor-parallelism-degree 2`` prints the one-device
  text (served and finetuned) and writes the gathered adapter from rank 0.

The ranks import no JAX: the parent computes JAX's side while they run.
"""

import contextlib
import io
import json

import numpy as np
import torch

from test_torch_port_mesh_serving import (MQA, SPEC, _join, _numpy_tree, _prompts, _start,
                                          unfused_jax)  # noqa: F401 (a fixture)

ALL7 = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
CFG = dict(rank=4, alpha=8.0, target_modules=ALL7, learning_rate=5e-2, optimizer="sgd")
N = 2
IDS = [0, 1, -1, 1, 0]
ENGINE = dict(max_requests_per_batch=4, max_seq_len=64)
RM = dict(decode_horizon=4, pipelined=True)


def _stacks(kw, seed, b_std=0.05):
    """numpy adapter stacks in JAX's layout ([L, N, D_in, r], [L, N, r,
    D_out]) on all seven modules, B non-zero."""
    d, hh, kh, dh, f = (kw["hidden_size"], kw["num_heads"], kw["num_kv_heads"],
                        kw["head_dim"], kw["intermediate_size"])
    dims = {"wq": (d, hh * dh), "wk": (d, kh * dh), "wv": (d, kh * dh), "wo": (hh * dh, d),
            "wg": (d, f), "wu": (d, f), "wd": (f, d)}
    r = np.random.default_rng(seed)
    r_ = CFG["rank"]
    return {m: {"a": (r.standard_normal((kw["num_layers"], N, i, r_)) / np.sqrt(i)
                      ).astype(np.float32),
                "b": (r.standard_normal((kw["num_layers"], N, r_, o)) * b_std
                      ).astype(np.float32)}
            for m, (i, o) in dims.items()}


def _ft_data(seed=4):
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, SPEC["vocab_size"], size=(2, 12)).astype(np.int32)
    return [(toks, np.roll(toks, -1, axis=1)), (toks[::-1].copy(), np.roll(toks[::-1], -1, 1))]


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _engine(case, mesh):
    from flexflow_tpu_torch import specs as tspecs
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    spec = tspecs.ModelSpec(**case["spec"])
    params = tp.params_from_numpy(case["params"], spec=spec, mesh=mesh)
    return spec, InferenceEngine(spec, params, cache_dtype=torch.float32, device="cpu",
                                 mesh=mesh, lora=tp.lora_from_numpy(case["stacks"]),
                                 lora_config=LoraConfig(**CFG), **ENGINE)


def _serve(case, mesh):
    from flexflow_tpu_torch.models import decoder
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager

    spec, eng = _engine(case, mesh)
    rm = RequestManager(eng, **RM)
    try:
        g = [rm.register_request(p, GenerationConfig(max_new_tokens=case["max_new"],
                                                     adapter_id=a))
             for p, a in zip(case["prompts"], IDS)]
        rm.run_until_idle()
        out = dict(tokens=[rm.get_request(i).output_tokens for i in g])
    finally:
        rm.close()
    # one routed forward ([0, -1, 1]) and the same rows without adapters
    tok = torch.tensor(case["tokens"])
    pos = torch.arange(tok.shape[1], dtype=torch.int32)[None].expand(tok.shape)
    kw = dict(shard=eng.shard)
    with torch.no_grad():
        routed, _ = decoder.forward(spec, eng.params, tok, pos, lora=eng.lora,
                                    adapter_ids=torch.tensor([0, -1, 1]),
                                    lora_scale=eng.lora_scale, **kw)
        plain, _ = decoder.forward(spec, eng.params, tok, pos, **kw)
    out["logits"] = routed.numpy()
    out["base_row_kept"] = bool(torch.equal(routed[1], plain[1]))
    out["adapter_rows_moved"] = bool(not torch.equal(routed[0], plain[0]))
    return out


def _finetune(case, mesh):
    from flexflow_tpu_torch.parallel.sharding import gather_lora
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import LoraConfig, unroute_lora
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager
    from flexflow_tpu_torch.utils.checkpoint import save_lora_adapter

    spec, eng = _engine(case, mesh)
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
    if case.get("ckpt"):  # every rank calls it; rank 0 writes the gathered slot
        save_lora_adapter(case["ckpt"], unroute_lora(eng.lora), 1, spec=spec, shard=eng.shard)
    return dict(tokens=tokens, losses=sess.losses,
                slot={m: {k: v[:, 1].numpy() for k, v in ab.items()} for m, ab in stacks.items()})


def _cli(case, mesh, model_dir):
    from flexflow_tpu_torch.inference import peft as cli

    import torch.distributed as dist

    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # each rank's own directory for a one-device run
        cli.main([a.replace("{rank}", str(dist.get_rank())) for a in case["argv"]])
    return out.getvalue()


def run_lora_cases(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for case in cases:
        if case["kind"] == "cli":
            out[case["name"]] = _cli(case, None, model_dir)
            continue
        data, model = case["mesh"]
        mesh = make_mesh(data=data, model=model, device="cpu")
        out[case["name"]] = {"serve": _serve, "finetune": _finetune}[case["kind"]](case, mesh)
    return out


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _jax_base(kw, seed, bits=None):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.models import params as jp
    from flexflow_tpu.quant import quantize_params

    spec = jspecs.ModelSpec(**kw)
    params = jp.init_params(spec, jax.random.PRNGKey(seed), jnp.float32)
    if bits:
        params = quantize_params(spec, params, bits=bits, group_size=16,
                                 compute_dtype=jnp.float32)
    return spec, params


def _jax_engine(spec, params, stacks, mesh):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.peft import lora as jl
    from flexflow_tpu.serving.engine import InferenceEngine

    return InferenceEngine(spec, params, cache_dtype=jnp.float32, mesh=mesh,
                           lora=jax.tree.map(jnp.asarray, stacks),
                           lora_config=jl.LoraConfig(**CFG), **ENGINE)


def _jax_serve(spec, params, stacks, prompts, max_new, mesh):
    from flexflow_tpu.serving.request_manager import GenerationConfig, RequestManager

    rm = RequestManager(_jax_engine(spec, params, stacks, mesh), **RM)
    g = [rm.register_request(p, GenerationConfig(max_new_tokens=max_new, adapter_id=a))
         for p, a in zip(prompts, IDS)]
    rm.run_until_idle()
    return [rm.get_request(i).output_tokens for i in g]


def _jax_logits(spec, params, stacks, tokens):
    import jax.numpy as jnp

    from flexflow_tpu.models import decoder as jd

    onehot = np.zeros((3, N), np.float32)
    onehot[0, 0] = onehot[2, 1] = 1.0
    pos = np.broadcast_to(np.arange(tokens.shape[1], dtype=np.int32), tokens.shape)
    logits, _ = jd.forward(spec, params, jnp.asarray(tokens), jnp.asarray(pos),
                           lora={m: {k: jnp.asarray(v) for k, v in ab.items()}
                                 for m, ab in stacks.items()},
                           adapter_onehot=jnp.asarray(onehot),
                           lora_scale=CFG["alpha"] / CFG["rank"])
    return np.asarray(logits)


def _jax_finetune(spec, params, stacks, prompts, max_new, data, mesh):
    from flexflow_tpu.peft import lora as jl
    from flexflow_tpu.peft.finetune import FinetuneSession
    from flexflow_tpu.serving.request_manager import GenerationConfig, RequestManager

    eng = _jax_engine(spec, params, stacks, mesh)
    rm = RequestManager(eng, **RM)
    sess = FinetuneSession(spec, jl.LoraConfig(**CFG), 1, data, epochs=1)
    rm.register_finetune(sess)
    tokens = [rm.generate([p], GenerationConfig(max_new_tokens=max_new, adapter_id=a)
                          )[0].output_tokens for p, a in zip(prompts, (1, 0))]
    return dict(tokens=tokens, losses=sess.losses,
                slot={m: {k: np.asarray(v)[:, 1] for k, v in ab.items()}
                      for m, ab in eng.lora.items()})


def _check_serve(res, name, want_tokens, want_logits=None, tol=1e-4):
    for r in res:
        got = r[name]
        assert got["tokens"] == want_tokens, name
        assert got["base_row_kept"] and got["adapter_rows_moved"], name
        if want_logits is not None:
            np.testing.assert_allclose(got["logits"], want_logits, atol=tol * 2, rtol=tol,
                                       err_msg=name)


def test_two_ranks_lora_serving_finetuning_and_cli(tmp_path, unfused_jax):
    """Over 2 ranks: LoRA serving at T = 2, D = 2, MQA T = 2 and INT8 T = 2;
    co-scheduled finetuning at T = 2 and D = 2; the PEFT CLI at T = 2."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    prompts = _prompts(5)
    tokens = np.random.RandomState(7).randint(1, SPEC["vocab_size"], (3, 9)).astype(np.int32)
    js, jparams = _jax_base(SPEC, 0)
    jq, jmqa = _jax_base(MQA, 1)
    j8, jint8 = _jax_base(SPEC, 2, bits=8)
    stacks, smqa = _stacks(SPEC, 1), _stacks(MQA, 2)
    data = _ft_data()
    model_dir = _tiny_model(tmp_path / "tiny")
    serve = dict(kind="serve", prompts=prompts, max_new=10, tokens=tokens, stacks=stacks,
                 spec=SPEC)
    ft = dict(kind="finetune", spec=SPEC, params=_numpy_tree(jparams), stacks=stacks,
              prompts=prompts[:2], max_new=6, data=data)
    argv = ["-llm-model", str(model_dir / "model"), "-enable-peft", "-prompt",
            str(model_dir / "prompts.json"), "-finetuning-dataset",
            str(model_dir / "texts.json"), "--max-training-steps", "3", "--learning-rate",
            "0.05", "--lora-rank", "4", "--lora-alpha", "8", "--max-new-tokens", "8",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2",
            "--full-precision", "--device", "cpu"]
    cases = [dict(serve, name="t2", params=_numpy_tree(jparams), mesh=(1, 2)),
             dict(serve, name="d2", params=_numpy_tree(jparams), mesh=(2, 1)),
             dict(serve, name="mqa-t2", spec=MQA, params=_numpy_tree(jmqa), stacks=smqa,
                  mesh=(1, 2)),
             dict(serve, name="int8-t2", params=_numpy_tree(jint8), mesh=(1, 2)),
             dict(ft, name="ft-t2", mesh=(1, 2), ckpt=str(tmp_path / "slot.npz")),
             dict(ft, name="ft-d2", mesh=(2, 1)),
             dict(kind="cli", name="cli-one", argv=argv + ["--save-peft",
                                                           str(tmp_path / "one{rank}")]),
             dict(kind="cli", name="cli-t2", argv=argv + ["--save-peft", str(tmp_path / "t2"),
                                                          "-tensor-parallelism-degree", "2"])]
    started = _start(tmp_path, 2, cases, runner=run_lora_cases)
    t2, d2 = j_make_mesh(model=2), j_make_mesh(data=2)
    want = {"t2": _jax_serve(js, jparams, stacks, prompts, 10, t2),
            "d2": _jax_serve(js, jparams, stacks, prompts, 10, d2),
            "mqa-t2": _jax_serve(jq, jmqa, smqa, prompts, 10, t2),
            "int8-t2": _jax_serve(j8, jint8, stacks, prompts, 10, t2)}
    logits = {"t2": _jax_logits(js, jparams, stacks, tokens),
              "int8-t2": _jax_logits(j8, jint8, stacks, tokens)}
    jft = _jax_finetune(js, jparams, stacks, prompts[:2], 6, data, t2)
    res = _join(tmp_path, 2, started)
    for name, w in want.items():
        _check_serve(res, name, w, logits.get(name), tol=1e-2 if "int8" in name else 1e-4)
    for name in ("ft-t2", "ft-d2"):
        for r in res:
            got = r[name]
            assert got["tokens"] == jft["tokens"], name
            assert len(got["losses"]) == 2
            np.testing.assert_allclose(got["losses"], jft["losses"], rtol=1e-5, atol=1e-5)
            for m, ab in jft["slot"].items():
                for k, v in ab.items():
                    np.testing.assert_allclose(got["slot"][m][k], v, rtol=1e-5,
                                               atol=1e-5 * np.abs(v).max(), err_msg=(name, m, k))
                    assert np.array_equal(got["slot"][m][k], res[0][name]["slot"][m][k])
    from flexflow_tpu_torch.utils.checkpoint import load_checkpoint

    saved = load_checkpoint(str(tmp_path / "slot.npz"))
    for m, ab in res[0]["ft-t2"]["slot"].items():
        for k, v in ab.items():
            assert np.array_equal(saved[m][k].numpy(), v), (m, k)
    one, tp2 = res[0]["cli-one"], res[0]["cli-t2"]
    assert _served_text(tp2) == _served_text(one) and one.count("=== guid") == 2
    np.testing.assert_allclose(_losses(tp2), _losses(one), atol=1e-4 + 1e-9)
    assert res[1]["cli-t2"] == ""  # rank 0 speaks for the mesh
    import safetensors.numpy

    a = safetensors.numpy.load_file(str(tmp_path / "one0" / "adapter_model.safetensors"))
    b = safetensors.numpy.load_file(str(tmp_path / "t2" / "adapter_model.safetensors"))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-5, err_msg=k)


def _served_text(out):
    return [ln for ln in out.splitlines()
            if not ln.startswith(("=== guid", "[Finetune]", "[mesh]"))]


def _losses(out):
    import re

    line = next(ln for ln in out.splitlines() if ln.startswith("[Finetune] steps"))
    return [float(v) for v in re.findall(r"'(-?[\d.]+)'", line)]


def _tiny_model(d):
    """The verify recipe's tiny HF LLaMA with a byte-level tokenizer, and a
    json list of training strings."""
    import transformers
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=4, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).float().save_pretrained(d / "model",
                                                               safe_serialization=True)
    vocab = {chr(i): (i - 32) for i in range(32, 127)}
    vocab["<unk>"] = len(vocab)
    Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
        str(d / "model" / "tokenizer.json"))
    (d / "model" / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "PreTrainedTokenizerFast"}))
    (d / "prompts.json").write_text(json.dumps(["hello world", "abc def"]))
    (d / "texts.json").write_text(json.dumps(
        ["the quick brown fox jumps over the lazy dog", "lorem ipsum dolor sit amet"]))
    return d


def test_four_ranks_two_by_two_lora_serving(tmp_path, unfused_jax):
    """data=2 x model=2: the two adapters' served tokens equal JAX's engine
    on make_mesh(data=2, model=2); the -1 row keeps the base output."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    prompts = _prompts(5)
    tokens = np.random.RandomState(8).randint(1, SPEC["vocab_size"], (3, 9)).astype(np.int32)
    js, jparams = _jax_base(SPEC, 3)
    stacks = _stacks(SPEC, 3)
    cases = [dict(kind="serve", name="d2t2", spec=SPEC, params=_numpy_tree(jparams),
                  stacks=stacks, prompts=prompts, max_new=10, tokens=tokens, mesh=(2, 2))]
    started = _start(tmp_path, 4, cases, runner=run_lora_cases)
    want = _jax_serve(js, jparams, stacks, prompts, 10, j_make_mesh(data=2, model=2))
    logits = _jax_logits(js, jparams, stacks, tokens)
    res = _join(tmp_path, 4, started)
    _check_serve(res, "d2t2", want, logits)
