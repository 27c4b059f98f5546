"""Several drafts against one verifier, and a MoE verifier or draft under
``SpecEngine``, in the port against the JAX package at float32.

- ``serving/tree_merge.py``: JAX's ``tests/test_tree_merge.py`` recipes and
  seeded random trees (several drafts, caps that drop subtrees), array-equal
  to JAX's ``merge_dfs_trees`` / ``merge_batch``;
- ``MultiSSMSpecManager``: rotation and merged verification give JAX's
  tokens and incremental decoding's; each draft cache's committed rows stay
  within 1e-5 of a fresh prefill of the same history (catch-up); merged mode
  refuses sampled requests; the engines share the verifier's tensors and
  cache;
- a tiny Mixtral (4 experts, top-2) as the verifier with a dense draft and as
  the draft of a dense verifier, stepwise and fused, equal to JAX's
  ``SpecEngine`` and to the port's incremental decoding; the ragged form
  captures nothing and gives the same tokens;
- the speculative CLI with two drafts, rotated and merged, prints the
  incremental CLI's text.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.serving import GenerationConfig as JGen
from flexflow_tpu.serving import tree_merge as jtm
from flexflow_tpu.serving.spec_manager import MultiSSMSpecManager as JMulti
from flexflow_tpu.serving.spec_manager import SpecRequestManager as JSRM
from flexflow_tpu.serving.speculative import SpecEngine as JSpecEngine
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import decoder as td
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.serving import tree_merge as ttm
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.serving.graphs import capturable
from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager
from flexflow_tpu_torch.serving.spec_manager import (MERGED_GREEDY, MultiSSMSpecManager,
                                                     SpecRequestManager)
from flexflow_tpu_torch.serving.speculative import SpecEngine

torch.set_num_threads(2)

# tests/test_speculative.py's pair (GQA verifier) and tests/test_tree_merge.py's TINY
LLM_KW = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=3,
              num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
              max_position_embeddings=256, norm_eps=1e-6)
SSM_KW = dict(LLM_KW, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
TINY_KW = dict(LLM_KW, num_layers=2, num_kv_heads=4)


def _pair(kw, key):
    """(JAX params, the port's copy) of ``kw`` from ``PRNGKey(key)``."""
    j = jp.init_params(jspecs.ModelSpec(**kw), jax.random.PRNGKey(key))
    return j, tp.params_from_numpy(jax.tree.map(np.asarray, j))


@pytest.fixture(scope="module")
def models():
    return {"llm": _pair(LLM_KW, 0), "ssm": _pair(SSM_KW, 1), "ssm2": _pair(SSM_KW, 7),
            "tiny": _pair(TINY_KW, 0)}


# ---------------------------------------------------------------------------
# tree merge
# ---------------------------------------------------------------------------

def _t(tokens, parents):
    return np.asarray(tokens), np.asarray(parents)


# tests/test_tree_merge.py: (trees, cap, pad_to, expected tokens, parents, depths)
RECIPES = {
    "dedups_shared_prefix": ([_t([7, 3, 4, 5], [-1, 0, 0, 1]), _t([7, 3, 9, 6], [-1, 0, 0, 1])],
                             16, 16, [7, 3, 4, 5, 9, 6], [-1, 0, 0, 1, 0, 1], [0, 1, 1, 2, 1, 2]),
    "identical_trees_collapse": ([_t([7, 3, 4, 5], [-1, 0, 0, 1])] * 3, 8, 8,
                                 [7, 3, 4, 5], [-1, 0, 0, 1], [0, 1, 1, 2]),
    "respects_cap": ([_t([7, 1, 2, 3], [-1, 0, 0, 0]), _t([7, 4, 5, 6], [-1, 0, 0, 0])], 5, 8,
                     [7, 1, 2, 3, 4], [-1, 0, 0, 0, 0], [0, 1, 1, 1, 1]),
    "drops_orphaned_subtrees": ([_t([7, 1, 2], [-1, 0, 0]), _t([7, 4, 9], [-1, 0, 1])], 4, 8,
                                [7, 1, 2, 4], [-1, 0, 0, 0], [0, 1, 1, 1]),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_merge_recipes_equal_jax(name):
    trees, cap, pad_to, tokens, parents, depths = RECIPES[name]
    got = ttm.merge_dfs_trees(trees, cap, pad_to)
    for g, w in zip(got, jtm.merge_dfs_trees(trees, cap, pad_to)):
        np.testing.assert_array_equal(g, w)
    n = len(tokens)
    np.testing.assert_array_equal(got[0][:n], tokens)
    np.testing.assert_array_equal(got[1][:n], parents)
    np.testing.assert_array_equal(got[2][:n], depths)
    assert (got[0][n:] == 0).all() and (got[1][n:] == -2).all() and (got[2][n:] == 0).all()


def _beam_trees(rng, b, width, depth, vocab, root):
    """[B, 1 + width x depth] trees in ``SpecEngine.draft_tree``'s layout
    (slot 1 + (d - 1) W + w; parents in the previous depth), tokens from a
    small vocabulary so that the drafts share prefixes."""
    t = 1 + width * depth
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    tokens[:, 0] = root
    parents = np.full((b, t), -1, np.int32)
    parents[:, 1:1 + width] = 0
    for d in range(2, depth + 1):
        base, prev = 1 + (d - 1) * width, 1 + (d - 2) * width
        parents[:, base:base + width] = prev + rng.integers(0, width, (b, width))
    return tokens, parents


@pytest.mark.parametrize("seed", range(6))
def test_merge_random_trees_equal_jax(seed):
    """Two to four drafts of random widths and depths, four rows, caps from
    one node to more than every tree holds (a small cap drops subtrees whose
    parents did not make it)."""
    rng = np.random.default_rng(seed)
    b, roots = 4, rng.integers(0, 5, 4)
    per_ssm = [_beam_trees(rng, b, int(rng.integers(1, 4)), int(rng.integers(1, 5)), 4, roots)
               for _ in range(int(rng.integers(2, 5)))]
    full = 1 + sum(tk.shape[1] - 1 for tk, _ in per_ssm)
    for cap in (1, 3, full // 2, full, 64):
        pad_to = max(cap, full)
        got = ttm.merge_batch(per_ssm, cap, pad_to)
        want = jtm.merge_batch(per_ssm, cap, pad_to)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.shape == (b, pad_to) and g.dtype == np.int32
        n = (got[1] != -2).sum(-1)
        assert (n <= cap).all() and (n >= 1).all()
    with pytest.raises(ValueError, match="share their root"):
        ttm.merge_dfs_trees([_t([1, 2], [-1, 0]), _t([3, 2], [-1, 0])], 4, 4)


# ---------------------------------------------------------------------------
# several drafts
# ---------------------------------------------------------------------------

def _incr(spec_kw, params, prompts, max_new, slots=2):
    rm = RequestManager(InferenceEngine(tspecs.ModelSpec(**spec_kw), params,
                                        max_requests_per_batch=slots, max_seq_len=160,
                                        cache_dtype=torch.float32, device="cpu"))
    try:
        return [r.output_tokens for r in rm.generate(prompts, GenerationConfig(
            max_new_tokens=max_new))]
    finally:
        rm.close()


def _engines(llm_kw, llm, drafts, slots=2, seq=160):
    """One engine a draft (``drafts``: (kw, params, width, depth)), the later
    ones on the first engine's verifier tensors and cache, as ``LLM.compile``
    builds them."""
    engines = []
    for kw, params, w, d in drafts:
        first = engines[0] if engines else None
        engines.append(SpecEngine(
            tspecs.ModelSpec(**llm_kw), first.llm_params if first else llm,
            tspecs.ModelSpec(**kw), params, beam_width=w, beam_depth=d,
            max_requests_per_batch=slots, max_seq_len=seq, cache_dtype=torch.float32,
            device="cpu", llm_cache=first.llm_cache if first else None))
    return engines


def _jax_engines(llm_kw, llm, drafts, slots=2, seq=160):
    return [JSpecEngine(jspecs.ModelSpec(**llm_kw), llm, jspecs.ModelSpec(**kw), params,
                        beam_width=w, beam_depth=d, max_requests_per_batch=slots,
                        max_seq_len=seq, cache_dtype=jnp.float32)
            for kw, params, w, d in drafts]


def _fresh_kv(spec, params, tokens):
    """A fresh prefill's K/V of ``tokens``: [L, KH, T, D] each."""
    toks = torch.tensor([tokens])
    pos = torch.arange(len(tokens), dtype=torch.int32)[None]
    with torch.no_grad():
        _, (k, v) = td.forward(spec, params, toks, pos, return_kv=True)
    return k[:, 0].permute(0, 2, 1, 3), v[:, 0].permute(0, 2, 1, 3)


def _run_checking_catchup(rm, prompts, max_new):
    """Serve ``prompts`` step by step; after every step, each draft cache's
    rows below its length must be within 1e-5 of a fresh prefill of the
    request's history (the catch-up, the draft's own commits and its
    admission). Returns the tokens and the number of rows checked."""
    guids = [rm.register_request(p, GenerationConfig(max_new_tokens=max_new)) for p in prompts]
    checked = 0
    while rm.step():
        for i, eng in enumerate(rm.engines):
            for s, req in enumerate(rm._slots):
                n = int(rm._ssm_lens[i][s])
                if req is None or n == 0:
                    continue
                k, v = _fresh_kv(eng.ssm_spec, eng.ssm_params, req.tokens[:n])
                np.testing.assert_allclose(eng.ssm_cache.k[:, s, :, :n], k, atol=1e-5, rtol=0)
                np.testing.assert_allclose(eng.ssm_cache.v[:, s, :, :n], v, atol=1e-5, rtol=0)
                checked += 1
    return [rm.get_request(g).output_tokens for g in guids], checked


ROTATION = {  # tests/test_speculative.py::test_multi_ssm_rotation, and widths and depths apart
    "jax_recipe": [("ssm", 2, 3), ("ssm2", 2, 3)],
    "apart": [("ssm", 2, 3), ("ssm2", 1, 4)],
}


@pytest.mark.parametrize("case", sorted(ROTATION))
def test_rotation_equals_jax_and_incremental(models, case):
    prompts = [[3, 17, 91, 5], [8, 13, 21]]
    drafts = [(SSM_KW, models[m], w, d) for m, w, d in ROTATION[case]]
    want = _incr(LLM_KW, models["llm"][1], prompts, 14)
    jrm = JMulti(_jax_engines(LLM_KW, models["llm"][0], [(k, p[0], w, d)
                                                         for k, p, w, d in drafts]), fused=True)
    jax_tokens = [r.output_tokens for r in jrm.generate(prompts, JGen(max_new_tokens=14))]
    rm = MultiSSMSpecManager(_engines(LLM_KW, models["llm"][1],
                                      [(k, p[1], w, d) for k, p, w, d in drafts]), fused=True)
    got, checked = _run_checking_catchup(rm, prompts, 14)
    assert got == want == jax_tokens
    assert rm.num_processed_requests == jrm.num_processed_requests == 2
    assert rm.total_decoding_steps == jrm.total_decoding_steps
    assert checked > 0 and rm._rr > 2  # both drafts took turns and caught up


def test_rotation_serves_sampled_requests(models):
    """Rotation verifies a sampled request stochastically (each turn's fused
    iteration); the greedy request beside it keeps its incremental tokens."""
    prompts = [[3, 17, 91, 5], [8, 13, 21]]
    want = _incr(LLM_KW, models["llm"][1], prompts[:1], 10)
    rm = MultiSSMSpecManager(_engines(LLM_KW, models["llm"][1],
                                      [(SSM_KW, models["ssm"][1], 2, 3),
                                       (SSM_KW, models["ssm2"][1], 1, 4)]), fused=True)
    g = rm.register_request(prompts[0], GenerationConfig(max_new_tokens=10))
    s = rm.register_request(prompts[1], GenerationConfig(max_new_tokens=10, temperature=0.9))
    rm.run_until_idle()
    assert rm.get_request(g).output_tokens == want[0]
    sampled = rm.get_request(s).output_tokens
    assert len(sampled) == 10 and all(0 <= t < 96 for t in sampled)
    assert rm._temperature.max() == 0.0  # retirement reset the slot's sampling settings


# tests/test_tree_merge.py's recipe (the verifier drafts for itself, twice), and a
# random draft's tree first with the verifier's own behind it (an irregular merged
# layout whose accepted paths run through the second tree's nodes), more requests
# than slots
MERGED = {
    "jax_recipe": ("tiny", TINY_KW, [("tiny", TINY_KW, 2, 3), ("tiny", TINY_KW, 1, 4)],
                   [[3, 17, 91, 5], [2, 4, 8, 16, 32]], 24),
    "random_then_own": ("llm", LLM_KW, [("ssm", SSM_KW, 2, 3), ("llm", LLM_KW, 1, 4)],
                        [[3, 17, 91, 5], [8, 13, 21], [2, 40, 41, 42, 43]], 14),
}


@pytest.mark.parametrize("case", sorted(MERGED))
def test_merged_equals_jax_and_incremental(models, case):
    llm, llm_kw, drafts, prompts, max_new = MERGED[case]
    drafts = [(kw, models[m], w, d) for m, kw, w, d in drafts]
    want = _incr(llm_kw, models[llm][1], prompts, max_new)
    jrm = JMulti(_jax_engines(llm_kw, models[llm][0], [(k, p[0], w, d)
                                                       for k, p, w, d in drafts]), merged=True)
    jax_tokens = [r.output_tokens for r in jrm.generate(prompts, JGen(max_new_tokens=max_new))]
    rm = MultiSSMSpecManager(_engines(llm_kw, models[llm][1],
                                      [(k, p[1], w, d) for k, p, w, d in drafts]), merged=True)
    got, checked = _run_checking_catchup(rm, prompts, max_new)
    assert got == want == jax_tokens
    assert rm.mean_verified_tokens_per_step == jrm.mean_verified_tokens_per_step > 1.0
    assert rm.total_decoding_steps == jrm.total_decoding_steps
    assert rm.num_processed_requests == len(prompts)
    assert rm._merged_t == jrm._merged_t == 1 + sum(w * d for *_, w, d in drafts)
    assert checked > 0


def test_merged_refuses_sampled_requests(models):
    rm = MultiSSMSpecManager(_engines(LLM_KW, models["llm"][1],
                                      [(SSM_KW, models["ssm"][1], 2, 3),
                                       (SSM_KW, models["ssm2"][1], 1, 4)]), merged=True)
    with pytest.raises(NotImplementedError, match="merged draft trees verify greedily"):
        rm.register_request([3, 17, 91], GenerationConfig(max_new_tokens=4, temperature=0.7))
    assert "deliberate differences" in MERGED_GREEDY
    # greedy requests go on being served
    [r] = rm.generate([[3, 17, 91]], GenerationConfig(max_new_tokens=4))
    assert r.output_tokens == _incr(LLM_KW, models["llm"][1], [[3, 17, 91]], 4)[0]


def _ptrs(tree):
    if isinstance(tree, dict):
        return {k: _ptrs(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.data_ptr()
    return tuple(_ptrs(x) for x in (tree.q, tree.scale, tree.offset) if x is not None)


def test_engines_share_the_verifier(models):
    engines = _engines(LLM_KW, models["llm"][1], [(SSM_KW, models["ssm"][1], 2, 3),
                                                  (SSM_KW, models["ssm2"][1], 1, 4),
                                                  (SSM_KW, models["ssm"][1], 3, 2)])
    first = engines[0]
    for e in engines[1:]:
        assert _ptrs(e.llm_params) == _ptrs(first.llm_params)
        assert e.llm_cache.k.data_ptr() == first.llm_cache.k.data_ptr()
        assert e.llm_cache.v.data_ptr() == first.llm_cache.v.data_ptr()
        assert e.ssm_cache.k.data_ptr() != first.ssm_cache.k.data_ptr()
    # a manager over engines that each own a verifier cache is refused
    alone = _engines(LLM_KW, models["llm"][1], [(SSM_KW, models["ssm"][1], 2, 3)])
    with pytest.raises(ValueError, match="share one verifier cache"):
        MultiSSMSpecManager([first, alone[0]], fused=True)
    with pytest.raises(ValueError, match="does not fit"):
        SpecEngine(tspecs.ModelSpec(**LLM_KW), first.llm_params, tspecs.ModelSpec(**SSM_KW),
                   models["ssm"][1], beam_width=2, beam_depth=3, max_requests_per_batch=4,
                   max_seq_len=160, cache_dtype=torch.float32, device="cpu",
                   llm_cache=first.llm_cache)
    with pytest.raises(ValueError, match="fused=True"):
        MultiSSMSpecManager(engines, fused=False)
    with pytest.raises(ValueError, match="stepwise"):
        MultiSSMSpecManager(engines, merged=True, fused=True)


# ---------------------------------------------------------------------------
# a MoE verifier or draft under SpecEngine (A6b)
# ---------------------------------------------------------------------------

MOE_KW = dict(LLM_KW, arch="MixtralForCausalLM", num_layers=2, norm_eps=1e-5, rope_theta=1e6)
E, K = 4, 2


def _moe_specs(impl):
    return (jspecs.ModelSpec(**MOE_KW, moe=jspecs.MoESpec(E, K, impl=impl)),
            tspecs.ModelSpec(**MOE_KW, moe=tspecs.MoESpec(E, K, impl=impl)))


@pytest.fixture(scope="module")
def moe():
    j = jp.init_params(_moe_specs("dense")[0], jax.random.PRNGKey(3), jnp.float32)
    return j, tp.params_from_numpy(jax.tree.map(np.asarray, j))


PROMPTS = [[3, 17, 91, 5], [8, 13, 21], [2, 40, 41, 42, 43]]


def _moe_roles(role, models, moe, impl="dense"):
    """((JAX spec, params), (port spec, params)) for the verifier and the draft."""
    js, ts = _moe_specs(impl)
    m = ((js, moe[0]), (ts, moe[1]))
    d = ((jspecs.ModelSpec(**SSM_KW), models["ssm"][0]),
         (tspecs.ModelSpec(**SSM_KW), models["ssm"][1]))
    if role == "moe_verifier":
        return m, d
    return ((jspecs.ModelSpec(**LLM_KW), models["llm"][0]),
            (tspecs.ModelSpec(**LLM_KW), models["llm"][1])), m


def _spec_tokens(verifier, draft, prompts, max_new, fused, slots=4):
    engine = SpecEngine(*verifier, *draft, beam_width=2, beam_depth=3,
                        max_requests_per_batch=slots, max_seq_len=128,
                        cache_dtype=torch.float32, device="cpu")
    rm = SpecRequestManager(engine, fused=fused)
    return [r.output_tokens for r in rm.generate(prompts, GenerationConfig(
        max_new_tokens=max_new))], engine


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
@pytest.mark.parametrize("role", ["moe_verifier", "moe_draft"])
def test_moe_under_spec_engine_equals_jax_and_incremental(models, moe, role, fused):
    (jv, tv), (jd_, td_) = _moe_roles(role, models, moe)
    rm = RequestManager(InferenceEngine(*tv, max_requests_per_batch=4, max_seq_len=128,
                                        cache_dtype=torch.float32, device="cpu"))
    try:
        want = [r.output_tokens for r in rm.generate(PROMPTS, GenerationConfig(
            max_new_tokens=10))]
    finally:
        rm.close()
    jrm = JSRM(JSpecEngine(*jv, *jd_, beam_width=2, beam_depth=3, max_requests_per_batch=4,
                           max_seq_len=128, cache_dtype=jnp.float32), fused=fused)
    jax_tokens = [r.output_tokens for r in jrm.generate(PROMPTS, JGen(max_new_tokens=10))]
    got, _ = _spec_tokens(tv, td_, PROMPTS, 10, fused)
    assert got == want == jax_tokens


@pytest.mark.parametrize("role", ["moe_verifier", "moe_draft"])
def test_ragged_moe_spec_engine_captures_nothing(models, moe, role):
    """The ragged form reads its group sizes on the host: an engine with a
    ragged verifier or draft would capture nothing on the card, a dense one
    would. Its tokens equal the dense form's."""
    (_, dense_v), (_, dense_d) = _moe_roles(role, models, moe)
    (_, ragged_v), (_, ragged_d) = _moe_roles(role, models, moe, impl="ragged")
    cuda = torch.device("cuda")
    assert capturable(cuda, dense_v[0], dense_d[0])
    assert not capturable(cuda, ragged_v[0], ragged_d[0])
    assert not capturable(torch.device("cpu"), dense_v[0], dense_d[0])
    dense, _ = _spec_tokens(dense_v, dense_d, PROMPTS, 10, fused=True)
    ragged, engine = _spec_tokens(ragged_v, ragged_d, PROMPTS, 10, fused=True)
    assert engine.graphs is None
    assert ragged == dense


def test_moe_verifier_with_two_drafts(models, moe):
    """Mixtral verifying for two dense drafts, rotated and merged: the
    incremental tokens."""
    (_, tv), (_, tdr) = _moe_roles("moe_verifier", models, moe)
    rm = RequestManager(InferenceEngine(*tv, max_requests_per_batch=2, max_seq_len=160,
                                        cache_dtype=torch.float32, device="cpu"))
    try:
        want = [r.output_tokens for r in rm.generate(PROMPTS[:2], GenerationConfig(
            max_new_tokens=10))]
    finally:
        rm.close()
    for merged in (False, True):
        engines = []
        for params, w, d in ((models["ssm"][1], 2, 3), (models["ssm2"][1], 1, 4)):
            first = engines[0] if engines else None
            engines.append(SpecEngine(
                tv[0], first.llm_params if first else tv[1], tdr[0], params, beam_width=w,
                beam_depth=d, max_requests_per_batch=2, max_seq_len=160,
                cache_dtype=torch.float32, device="cpu",
                llm_cache=first.llm_cache if first else None))
        mgr = MultiSSMSpecManager(engines, merged=merged, fused=not merged)
        assert [r.output_tokens for r in mgr.generate(PROMPTS[:2], GenerationConfig(
            max_new_tokens=10))] == want


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """A tiny HF LLaMA directory and a smaller draft's, one character
    tokenizer."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers import models as tok_models

    dirs = []
    for name, seed, d, layers in (("verifier", 0, 64, 2), ("draft", 1, 32, 1)):
        path = tmp_path_factory.mktemp(f"tiny_{name}")
        torch.manual_seed(seed)
        cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=d, intermediate_size=2 * d,
                                       num_hidden_layers=layers, num_attention_heads=4,
                                       num_key_value_heads=4, max_position_embeddings=128)
        cfg.architectures = ["LlamaForCausalLM"]
        transformers.LlamaForCausalLM(cfg).save_pretrained(path, safe_serialization=True)
        vocab = {chr(i): (i - 32) for i in range(32, 127)}
        vocab["<unk>"] = len(vocab)
        Tokenizer(tok_models.BPE(vocab=vocab, merges=[], unk_token="<unk>")).save(
            str(path / "tokenizer.json"))
        with open(path / "tokenizer_config.json", "w") as f:
            json.dump({"tokenizer_class": "PreTrainedTokenizerFast"}, f)
        dirs.append(str(path))
    return dirs


@pytest.mark.parametrize("merge", [False, True], ids=["rotation", "merged"])
def test_cli_two_drafts_match_incremental(model_dirs, tmp_path, capsys, merge):
    from flexflow_tpu_torch.inference import incr_decoding, spec_infer

    verifier, draft = model_dirs
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", verifier, "-prompt", str(prompts), "--max-new-tokens", "16",
            "--max-sequence-length", "128", "--max-requests-per-batch", "2",
            "--full-precision", "--device", "cpu"]
    assert incr_decoding.main(argv) == 0
    want = capsys.readouterr().out
    assert spec_infer.main(argv + ["-ssm-model", draft, "-ssm-model", verifier]
                           + (["--merge-ssm-trees"] if merge else [])) == 0
    got = capsys.readouterr().out
    assert got.count("=== guid") == 2 and "verified/step" in got
    texts = [[line for line in out.splitlines() if not line.startswith("=== guid")]
             for out in (got, want)]
    assert texts[0] == texts[1]
