"""The utilities (A12) against the JAX package's modules on the CPU:
``utils/debug_dump`` (traces and the dump tree, float32, atol 1e-5),
``utils/alignment`` (layer-wise reports against tiny in-process HF models,
the JAX harness's tolerance 2e-3), ``utils/recompile`` (buckets),
``utils/native_scheduler`` (the native core, its plain loop and JAX's
wrapper on seeded horizons; served tokens through the request manager),
``utils/native_safetensors`` (against the port's pure-Python reader and
JAX's native reader, exact) and ``utils/native_tokenizer`` (against JAX's
on the same vocab and merges, exact)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.serving.engine import InferenceEngine as JEngine
from flexflow_tpu.serving.request_manager import GenerationConfig as JGen
from flexflow_tpu.serving.request_manager import RequestManager as JRM
from flexflow_tpu.utils import alignment as j_align
from flexflow_tpu.utils import debug_dump as j_dump
from flexflow_tpu.utils import native_safetensors as j_stx
from flexflow_tpu.utils import native_scheduler as j_sched
from flexflow_tpu.utils import native_tokenizer as j_bpe
from flexflow_tpu.utils import recompile as j_recompile
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.serving.engine import InferenceEngine as TEngine
from flexflow_tpu_torch.serving.request_manager import GenerationConfig as TGen
from flexflow_tpu_torch.serving.request_manager import RequestManager as TRM
from flexflow_tpu_torch.utils import alignment as t_align
from flexflow_tpu_torch.utils import debug_dump as t_dump
from flexflow_tpu_torch.utils import hf_weights as t_hf
from flexflow_tpu_torch.utils import native_safetensors as t_stx
from flexflow_tpu_torch.utils import native_scheduler as t_sched
from flexflow_tpu_torch.utils import native_tokenizer as t_bpe
from flexflow_tpu_torch.utils import recompile as t_recompile

torch.set_num_threads(2)
transformers = pytest.importorskip("transformers")

TINY = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128, max_position_embeddings=128,
            norm_eps=1e-6)
ATOL = 2e-3  # tests/test_fine_grained_alignment.py


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_debug_traces_and_dump_tree_match_jax(tmp_path):
    """tests/test_aux.py::test_debug_traces_match_forward's case: the port's
    traces hold JAX's keys and values, its logits equal its untraced
    forward's bitwise, and the two dump trees hold the same files."""
    from flexflow_tpu_torch.models import decoder as td

    js, ts = jspecs.ModelSpec(**TINY), tspecs.ModelSpec(**TINY)
    jparams = jp.init_params(js, jax.random.PRNGKey(0))
    tparams = tp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    tokens = np.asarray([[3, 17, 91, 5]], np.int32)
    pos = np.arange(4, dtype=np.int32)[None]
    jlog, jtr = j_dump.forward_with_traces(js, jparams, jnp.asarray(tokens), jnp.asarray(pos))
    tlog, ttr = t_dump.forward_with_traces(ts, tparams, torch.tensor(tokens), torch.tensor(pos))
    assert set(ttr) == set(jtr)
    for k, v in jtr.items():
        np.testing.assert_allclose(ttr[k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)
    with torch.no_grad():
        want, _ = td.forward(ts, tparams, torch.tensor(tokens), torch.tensor(pos))
    assert torch.equal(tlog, want)

    jd, td_ = j_dump.DebugDumper(str(tmp_path / "jax")), t_dump.DebugDumper(str(tmp_path / "port"))
    for dumper, traces in ((jd, jtr), (td_, ttr)):
        assert dumper.dump_step(traces).endswith("fwd_step_0")
        assert dumper.dump_step(traces).endswith("fwd_step_1")
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax") and len(files) == 2 * len(jtr)
    for f in files:
        np.testing.assert_allclose(np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f),
                                   atol=1e-5, err_msg=f)


def _family_cfg(family):
    """tests/test_fine_grained_alignment.py's tiny models."""
    if family == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64)
        cfg.architectures = ["LlamaForCausalLM"]
    elif family == "opt":
        cfg = transformers.OPTConfig(
            vocab_size=256, hidden_size=64, ffn_dim=128, num_hidden_layers=3,
            num_attention_heads=4, max_position_embeddings=64, do_layer_norm_before=True,
            word_embed_proj_dim=64)
        cfg.architectures = ["OPTForCausalLM"]
    elif family == "falcon":
        cfg = transformers.FalconConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
            multi_query=True, parallel_attn=True, new_decoder_architecture=False, bias=False,
            alibi=False)
        cfg.architectures = ["FalconForCausalLM"]
    elif family == "mpt":
        cfg = transformers.MptConfig(vocab_size=256, d_model=64, n_layers=3, n_heads=4,
                                     expansion_ratio=2, max_seq_len=64)
        cfg.architectures = ["MptForCausalLM"]
    elif family == "starcoder":
        cfg = transformers.GPTBigCodeConfig(vocab_size=256, n_embd=64, n_layer=3, n_head=4,
                                            n_positions=64, multi_query=True)
        cfg.architectures = ["GPTBigCodeForCausalLM"]
    else:
        cfg = transformers.MixtralConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2, max_position_embeddings=64)
        cfg.architectures = ["MixtralForCausalLM"]
    return cfg


def _build(family):
    torch.manual_seed(0)
    cfg = _family_cfg(family)
    model = getattr(transformers, cfg.architectures[0])(cfg).eval()
    cfg_dict = dict(cfg.to_dict(), architectures=cfg.architectures)
    tspec = tspecs.from_hf_config(cfg_dict)
    tparams = tp.convert_hf_state_dict(tspec, model.state_dict())
    tokens = np.random.RandomState(0).randint(0, tspec.vocab_size, size=(2, 12))
    return tspec, tparams, model, tokens, cfg_dict


@pytest.mark.parametrize("family", ["llama", "opt", "falcon", "mpt", "starcoder", "mixtral"])
def test_layerwise_alignment_matches_jax(family):
    """The port's report lists JAX's names; both align at every layer."""
    from flexflow_tpu.models import params as jparams_lib

    tspec, tparams, model, tokens, cfg_dict = _build(family)
    got = t_align.compare_with_hf(tspec, tparams, model, tokens)
    jspec = jspecs.from_hf_config(cfg_dict)
    want = j_align.compare_with_hf(jspec, jparams_lib.convert_hf_state_dict(
        jspec, model.state_dict()), model, tokens)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(got) == tspec.num_layers + 1
    assert t_align.first_divergence(got, ATOL) is None, got
    assert j_align.first_divergence(want, ATOL) is None


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_localizes_injected_perturbation(layer):
    """A perturbation of layer k's wq is reported first at layers.k.output,
    the earlier layers still aligned (JAX's gate)."""
    tspec, tparams, model, tokens, _ = _build("llama")
    wq = tparams["layers"]["wq"].clone()
    noise = np.random.RandomState(1).standard_normal(tuple(wq[layer].shape)).astype(np.float32)
    wq[layer] += 0.5 * torch.from_numpy(noise)
    perturbed = {**tparams, "layers": {**tparams["layers"], "wq": wq}}
    report = t_align.compare_with_hf(tspec, perturbed, model, tokens)
    assert t_align.first_divergence(report, ATOL) == f"layers.{layer}.output"
    assert j_align.first_divergence(report, ATOL) == f"layers.{layer}.output"
    assert all(diff <= ATOL for _, diff in report[:layer])


def test_dump_tree_flow_matches(tmp_path):
    """The file-based comparison agrees with the in-memory one, and JAX's
    ``compare_dump_with_hf`` reads the port's tree the same way."""
    tspec, tparams, model, tokens, _ = _build("llama")
    positions = np.broadcast_to(np.arange(tokens.shape[1]), tokens.shape)
    _, traces = t_dump.forward_with_traces(tspec, tparams, torch.tensor(tokens),
                                           torch.tensor(np.ascontiguousarray(positions)))
    t_dump.DebugDumper(str(tmp_path)).dump_step(traces)
    report_f = t_align.compare_dump_with_hf(str(tmp_path), model, tokens)
    report_m = t_align.compare_with_hf(tspec, tparams, model, tokens)
    report_j = j_align.compare_dump_with_hf(str(tmp_path), model, tokens)
    assert [n for n, _ in report_f] == [n for n, _ in report_m] == [n for n, _ in report_j]
    for (_, a), (_, b), (_, c) in zip(report_f, report_m, report_j):
        assert a == pytest.approx(b, abs=1e-6) and a == c
    assert t_align.first_divergence(report_f, ATOL) is None


def test_recompile_state_buckets_match_jax():
    """tests/test_aux.py::test_recompile_state_buckets' sequence: the port's
    RecompileState moves through JAX's buckets, and a step keyed by the
    bucket (a captured graph's key) is built once per new bucket."""
    seqs = {}
    for mod in (t_recompile, j_recompile):
        built = []
        cache = {}
        state = {"capacity_factor": 1.0, "overflow": 0.0}
        rs = mod.RecompileState(
            trigger=lambda s: s["overflow"] > 0.1,
            alter=lambda s, m=mod: s.update(
                capacity_factor=m.round_up_bucket(s["capacity_factor"] * 1.4)))
        seen = []
        for overflow in (0.0, 0.2, 0.0, 0.3, 0.0, 0.0):
            state["overflow"] = overflow
            changed = rs.step(state)
            key = state["capacity_factor"]
            if key not in cache:
                built.append(key)
                cache[key] = int(key * 4)
            seen.append((key, changed))
        seqs[mod.__name__] = (seen, rs.recompilations, built)
    (t_seen, t_n, t_built), (j_seen, j_n, _) = seqs.values()
    assert t_seen == j_seen and t_n == j_n == 2
    assert [k for k, _ in t_seen] == [1.0, 1.5, 1.5, 3.0, 3.0, 3.0]
    assert t_built == [1.0, 1.5, 3.0]
    for x in (0.5, 1.1, 1.3, 1.9, 2.5, 3.5, 9.0):
        assert t_recompile.round_up_bucket(x) == j_recompile.round_up_bucket(x)


def _horizon_case(rng, n=8, b=16):
    """tests/test_native.py's fuzzed batch: EOS, stop ids, max-new and budget."""
    tokens = rng.randint(0, 12, size=(n, b)).astype(np.int32)
    active = (rng.rand(b) < 0.8).astype(np.int32)
    counts = rng.randint(0, 5, size=b).astype(np.int32)
    max_new = rng.randint(3, 12, size=b).astype(np.int32)
    totals = counts + rng.randint(1, 10, size=b).astype(np.int32)
    budget = rng.randint(8, 30, size=b).astype(np.int32)
    stop_ids = np.full((b, 2), -1, np.int32)
    stop_counts = np.zeros(b, np.int32)
    stop_ids[::3, 0] = 5
    stop_counts[::3] = 1
    return tokens, active, counts, max_new, totals, budget, stop_ids, stop_counts


def test_process_horizon_matches_plain_loop_and_jax():
    rng = np.random.RandomState(0)
    eos = np.asarray([2, 7], np.int32)
    for trial in range(20):
        tokens, active, counts, max_new, totals, budget, stop_ids, stop_counts = \
            _horizon_case(rng)
        outs = []
        for fn in (t_sched.process_horizon, t_sched.process_horizon_plain,
                   j_sched.process_horizon):
            c, t = counts.copy(), totals.copy()
            toks, taken, fin = fn(tokens, active, c, max_new, t, budget, 4, eos, stop_ids,
                                  stop_counts)
            outs.append((taken, fin, c, t, [toks[s, :taken[s]].tolist() for s in range(16)]))
        for got in outs[1:]:
            for a, b in zip(outs[0][:4], got[:4]):
                np.testing.assert_array_equal(a, b, err_msg=str(trial))
            assert outs[0][4] == got[4], trial
    assert outs[0][1].sum() > 0


def test_native_scheduler_serves_jax_tokens_with_stops_and_budgets():
    """Pipelined horizons of 4 through the native core: stop ids, max-new
    and a full cache (max_seq_len 24) retire requests at JAX's tokens."""
    kw = dict(TINY, vocab_size=128)
    js, ts = jspecs.ModelSpec(**kw), tspecs.ModelSpec(**kw)
    jparams = jp.init_params(js, jax.random.PRNGKey(5), jnp.float32)
    tparams = tp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    prompts = [[5, 17, 3, 99, 42], [1] * 17, [8, 9, 10, 11]]
    ekw = dict(max_requests_per_batch=2, max_seq_len=24)
    jrm = JRM(JEngine(js, jparams, cache_dtype=jnp.float32, **ekw), decode_horizon=4,
              pipelined=True)
    want = [r.output_tokens for r in jrm.generate(prompts, JGen(max_new_tokens=12))]
    stop = want[0][2]
    trm = TRM(TEngine(ts, tparams, cache_dtype=torch.float32, device="cpu", **ekw),
              decode_horizon=4, pipelined=True)
    try:
        got = [r.output_tokens for r in trm.generate(prompts, TGen(max_new_tokens=12))]
        cut = trm.generate(prompts, TGen(max_new_tokens=12, stop_token_ids=(stop,)))
    finally:
        trm.close()
    jcut = jrm.generate(prompts, JGen(max_new_tokens=12, stop_token_ids=(stop,)))
    assert got == want
    assert len(got[1]) == 24 - 17  # the full cache retired it
    assert [r.output_tokens for r in cut] == [r.output_tokens for r in jcut]
    assert cut[0].output_tokens == want[0][:3]


@pytest.fixture(scope="module")
def st_file(tmp_path_factory):
    """A safetensors file of several dtypes (bf16 and a scalar among them)."""
    import ml_dtypes
    from safetensors.numpy import save_file

    rng = np.random.RandomState(0)
    tensors = {
        "a.weight": rng.randn(16, 8).astype(np.float32),
        "b.bias": rng.randn(8).astype(np.float16),
        "c.ids": rng.randint(0, 100, size=(3, 4, 5)).astype(np.int64),
        "d.flags": rng.randn(6) > 0,
        "e.w16": rng.randn(4, 6).astype(ml_dtypes.bfloat16),
        "f.i8": rng.randint(-100, 100, size=(7,)).astype(np.int8),
        "scalar": np.array(3.5, dtype=np.float32),
    }
    path = str(tmp_path_factory.mktemp("stx") / "test.safetensors")
    save_file(tensors, path)
    return path, tensors


def test_native_safetensors_matches_plain_reader_and_jax(st_file):
    path, tensors = st_file
    native, plain, jax_side = (t_stx.NativeSafetensors(path), t_hf.SafetensorsFile(path),
                               j_stx.NativeSafetensors(path))
    assert set(native.keys()) == set(plain.keys()) == set(tensors)
    for name, want in tensors.items():
        got = native[name]
        assert got.shape == np.shape(want) and got.dtype == plain.get(name).dtype
        np.testing.assert_array_equal(got, plain.get(name))
        np.testing.assert_array_equal(got, jax_side[name])
        np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype))
    assert native["e.w16"].dtype == np.float32
    native.close()
    with pytest.raises(ValueError, match="open failed"):
        t_stx.NativeSafetensors(path + ".missing")


def test_hf_loader_reads_through_the_native_reader(tmp_path):
    """``LazyStateDict`` serves the native reader's arrays; the converted
    parameters equal those read by the pure-Python reader."""
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=2, num_attention_heads=2,
                                   num_key_value_heads=2, max_position_embeddings=64)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).save_pretrained(tmp_path, safe_serialization=True)
    sd = t_hf.LazyStateDict(str(tmp_path))
    assert all(isinstance(f, t_stx.NativeSafetensors) for f in sd._index.values())
    [path] = [str(p) for p in tmp_path.glob("*.safetensors")]
    plain = t_hf.SafetensorsFile(path)
    spec, params = t_hf.load_params(str(tmp_path), dtype=torch.float32)
    want = tp.convert_hf_state_dict(spec, {k: plain.get(k) for k in plain.keys()})
    for k, v in params["layers"].items():
        assert torch.equal(v, want["layers"][k]), k
    assert torch.equal(params["embed_tokens"], want["embed_tokens"])


def test_bpe_tokenizer_matches_jax_and_hf(tmp_path):
    """tests/test_native.py::test_bpe_matches_hf's vocabulary and merges."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=[],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = ["the quick brown fox jumps over the lazy dog",
              "hello world, hello tokenizer! testing byte level bpe merges",
              "speculative decoding verifies token trees on TPUs"] * 20
    tok.train_from_iterator(corpus, trainer)
    vocab = tok.get_vocab()
    tok.save(str(tmp_path / "tok.json"))
    with open(tmp_path / "tok.json") as f:
        merges = [m if isinstance(m, str) else " ".join(m)
                  for m in json.load(f)["model"]["merges"]]
    ours, theirs = t_bpe.NativeBPETokenizer(vocab, merges), j_bpe.NativeBPETokenizer(vocab, merges)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges))
    from_files = t_bpe.NativeBPETokenizer.from_files(str(tmp_path / "vocab.json"),
                                                     str(tmp_path / "merges.txt"))
    for text in ["the quick brown fox", "hello world", "testing bpe merges on TPUs",
                 "numbers 1234 and  spaces, punctuation!?", "café über"]:
        got = ours.encode(text)
        assert got == theirs.encode(text) == from_files.encode(text)
        assert got == tok.encode(text).ids, text
        assert ours.decode(got) == theirs.decode(got) == text
