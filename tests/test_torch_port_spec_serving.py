"""Tree-speculative serving in the port: lossless against the port's own
incremental greedy decoding at float32, and equal to the JAX package's
SpecRequestManager tokens on the same tiny (verifier, draft) pair, in the
stepwise, fused, horizon and pipelined modes; EOS, continuous batching, a
perfect draft and the seq-room cap at the cache boundary (analogues of
tests/test_speculative.py); and the INT4/bf16 pair against JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.serving import GenerationConfig as JGen
from flexflow_tpu.serving.spec_manager import SpecRequestManager as JSRM
from flexflow_tpu.serving.speculative import SpecEngine as JSpecEngine
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.serving.engine import InferenceEngine
from flexflow_tpu_torch.serving.request_manager import GenerationConfig, RequestManager
from flexflow_tpu_torch.serving.spec_manager import SpecRequestManager
from flexflow_tpu_torch.serving.speculative import SpecEngine

torch.set_num_threads(2)

LLM_KW = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=3,
              num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
              max_position_embeddings=256, norm_eps=1e-6)
SSM_KW = dict(LLM_KW, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
LLM, SSM = tspecs.ModelSpec(**LLM_KW), tspecs.ModelSpec(**SSM_KW)
PROMPTS = [[3, 17, 91, 5], [8, 13, 21], [2, 40, 41, 42, 43]]
CHURN = [[i + 1, i + 2, i + 3] for i in range(5)]  # more requests than slots


@pytest.fixture(scope="module")
def jax_params():
    return (jp.init_params(jspecs.ModelSpec(**LLM_KW), jax.random.PRNGKey(0)),
            jp.init_params(jspecs.ModelSpec(**SSM_KW), jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def params(jax_params):
    return tuple(tp.params_from_numpy(jax.tree.map(np.asarray, p)) for p in jax_params)


def incr(lp, prompts, max_new, max_seq_len=128):
    rm = RequestManager(InferenceEngine(LLM, lp, max_requests_per_batch=4,
                                        max_seq_len=max_seq_len, cache_dtype=torch.float32,
                                        device="cpu"))
    try:
        return [r.output_tokens for r in rm.generate(prompts, GenerationConfig(max_new_tokens=max_new))]
    finally:
        rm.close()


def spec(lp, sp, prompts, max_new, *, ssm=SSM, slots=4, max_seq_len=128, eos=(), **kw):
    engine = SpecEngine(LLM, lp, ssm, sp, beam_width=2, beam_depth=3,
                        max_requests_per_batch=slots, max_seq_len=max_seq_len,
                        cache_dtype=torch.float32, device="cpu")
    rm = SpecRequestManager(engine, eos_token_ids=eos, **kw)
    return [r.output_tokens for r in rm.generate(prompts, GenerationConfig(max_new_tokens=max_new))], rm


MODES = {
    "stepwise": (PROMPTS, 4, 128, {}),
    "fused": (PROMPTS, 4, 128, dict(fused=True)),
    "fused_h3": (PROMPTS[:2], 2, 200, dict(fused=True, spec_horizon=3)),
    "pipelined_h2_churn": (CHURN, 2, 200, dict(fused=True, spec_horizon=2, pipelined=True)),
    "pipelined_h4_down": (CHURN, 2, 200, dict(fused=True, spec_horizon=4, pipelined=True)),
    "pipelined_windowed": (CHURN, 2, 512, dict(fused=True, spec_horizon=2, pipelined=True)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_spec_equals_incremental(params, mode):
    prompts, slots, s, kw = MODES[mode]
    want = incr(params[0], prompts, 10)
    got, rm = spec(*params, prompts, 10, slots=slots, max_seq_len=s, **kw)
    assert got == want
    assert rm.num_processed_requests == len(prompts)
    assert rm.mean_verified_tokens_per_step >= 1.0
    if mode == "pipelined_windowed":
        assert rm.engine.attn_window_bucket(10) == 128  # the run really windows


@pytest.mark.parametrize("mode", ["fused", "fused_h3", "pipelined_h2_churn"])
def test_spec_equals_jax_spec_manager(jax_params, params, mode):
    prompts, slots, s, kw = MODES[mode]
    jengine = JSpecEngine(jspecs.ModelSpec(**LLM_KW), jax_params[0], jspecs.ModelSpec(**SSM_KW),
                          jax_params[1], beam_width=2, beam_depth=3,
                          max_requests_per_batch=slots, max_seq_len=s, cache_dtype=jnp.float32)
    jrm = JSRM(jengine, **kw)
    want = [r.output_tokens for r in jrm.generate(prompts, JGen(max_new_tokens=10))]
    got, rm = spec(*params, prompts, 10, slots=slots, max_seq_len=s, **kw)
    assert got == want
    assert rm.total_decoding_steps == jrm.total_decoding_steps
    assert rm.mean_verified_tokens_per_step == jrm.mean_verified_tokens_per_step


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "pipelined"])
def test_spec_eos(params, fused):
    [full] = incr(params[0], [PROMPTS[0]], 12)
    first = {}
    for i, t in enumerate(full):
        first.setdefault(t, i)
    eos, cut = max(first.items(), key=lambda kv: kv[1])  # a token at its first occurrence
    kw = dict(fused=True, pipelined=True, spec_horizon=2) if fused else {}
    [got], _ = spec(*params, [PROMPTS[0]], 12, slots=2, max_seq_len=200, eos=[eos], **kw)
    assert got == full[:cut + 1]


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_perfect_draft_accepts_depth_plus_one(params, fused):
    """The verifier as its own draft: every speculated token verifies, so
    each step yields depth + 1 = 4 tokens and 12 tokens take 3 steps."""
    want = incr(params[0], [PROMPTS[0]], 12)
    got, rm = spec(params[0], params[0], [PROMPTS[0]], 12, ssm=LLM, fused=fused)
    assert got == want
    assert rm.total_decoding_steps <= 4
    assert rm.mean_verified_tokens_per_step >= 3.0


def test_pipelined_seq_room_cap_at_the_cache_boundary(params):
    """Four horizons in flight, each up to depth + 1 tokens per iteration
    before the host sees them: the dispatch cap keeps worst-case acceptance
    inside a 64-position cache, and outputs stay a lossless prefix."""
    prompts = [[5, 9, 2], [7, 1]]
    want = incr(params[0], prompts, 40)
    got, rm = spec(*params, prompts, 40, slots=2, max_seq_len=64, fused=True, spec_horizon=4,
                   pipelined=True, pipeline_depth=4)
    for g, w in zip(got, want):
        assert len(g) >= 1 and g == w[:len(g)]
    assert (rm._cache_lens <= 64).all()


def test_int4_bf16_first_tokens_equal_jax(jax_params):
    """INT4 verifier (group 32) and bf16 draft, fused and pipelined: the first
    20 tokens of each request equal the JAX package's."""
    jl = j_quant_params(jspecs.ModelSpec(**LLM_KW), jax_params[0], bits=4, group_size=32,
                        compute_dtype=jnp.bfloat16)
    js = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jax_params[1])
    kw = dict(fused=True, spec_horizon=2, pipelined=True)
    jengine = JSpecEngine(jspecs.ModelSpec(**LLM_KW), jl, jspecs.ModelSpec(**SSM_KW), js,
                          beam_width=2, beam_depth=3, max_requests_per_batch=4, max_seq_len=128,
                          cache_dtype=jnp.bfloat16)
    want = [r.output_tokens for r in JSRM(jengine, **kw).generate(PROMPTS, JGen(max_new_tokens=20))]
    lp = tp.params_from_numpy(jl, dtype=torch.bfloat16)
    sp = tp.params_from_numpy(jax.tree.map(np.asarray, js), dtype=torch.bfloat16)
    assert lp["layers"]["wq"].bits == 4 and lp["layers"]["wq"].q.dtype == torch.uint8
    engine = SpecEngine(LLM, lp, SSM, sp, beam_width=2, beam_depth=3, max_requests_per_batch=4,
                        max_seq_len=128, cache_dtype=torch.bfloat16, device="cpu")
    got = [r.output_tokens
           for r in SpecRequestManager(engine, **kw).generate(PROMPTS, GenerationConfig(max_new_tokens=20))]
    assert [g[:20] for g in got] == [w[:20] for w in want]
