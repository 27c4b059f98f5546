"""Tensor and data parallel serving of the port over two gloo ranks on the
CPU (the helpers of ``test_torch_port_mesh_serving.py``):

- LLaMA, Mixtral (TP within each expert), MQA (one KV head, replicated),
  MPT (ALiBi), OPT (biases) and Falcon (attention whole, FFN cut) at T = 2
  give the JAX package's one-device greedy tokens at float32;
- INT8 and INT4 (the planar two-block cut) and chunked prefill at T = 2
  and D = 2 give JAX's one-device tokens on the same parameters (JAX's
  chunked engine for chunked prefill), and the port's one-device tokens;
- a sampled run gives both ranks the same tokens, and at D = 2
  (incremental and speculative) the one-device run's;
- a degree product that is not the world size is refused.

``LLM.compile`` and the CLIs under a mesh are in
``test_torch_port_mesh_cli.py``.
"""

from test_torch_port_mesh_serving import (MIXTRAL, MQA, SPEC, _all_ranks, _jax_params,
                                          _jax_tokens, _join, _prompts, _start,
                                          unfused_jax)  # noqa: F401 (a fixture)


# the other architectures' layouts at T = 2: ALiBi slopes of the rank's own
# heads with tied (vocab-cut) embeddings and a plain GELU MLP (MPT); biases
# on every projection, the row-parallel ones added once after the sum, with
# learned positions (OPT); five heads, so attention whole on each rank beside
# a cut FFN, in parallel (Falcon, one KV head)
OTHERS = {
    "mpt": dict(SPEC, arch="MPTForCausalLM", pos="alibi", norm="layernorm", act="gelu",
                tie_word_embeddings=True),
    "opt": dict(SPEC, arch="OPTForCausalLM", pos="learned", learned_pos_offset=2,
                norm="layernorm", norm_bias=True, act="relu", qkv_bias=True,
                attn_out_bias=True, mlp_bias=True, tie_word_embeddings=True),
    "falcon": dict(SPEC, arch="FalconForCausalLM", hidden_size=40, num_heads=5,
                   num_kv_heads=1, intermediate_size=160, parallel_attn=True,
                   norm="layernorm", norm_bias=True, act="gelu", tie_word_embeddings=True),
}


def test_two_ranks_mixtral_mqa_quantized_sampled(tmp_path, unfused_jax):
    """Over 2 ranks: LLaMA, Mixtral, MQA, MPT, OPT and Falcon layouts at
    T = 2 against JAX; INT8,
    INT4 and chunked prefill at T = 2 and D = 2 against JAX's one-device
    engine and the port's one-device run; a sampled run the same on both ranks, and at D = 2 the
    one-device run's; a degree product that is not the world size
    refused."""
    prompts = _prompts(4)
    js, jparams, npp = _jax_params(SPEC, 0)
    jm, jmix, nmix = _jax_params(MIXTRAL, 2)
    jq, jmqa, nmqa = _jax_params(MQA, 4)
    others = {name: _jax_params(kw, 6) for name, kw in OTHERS.items()}
    base = dict(kind="serve", prompts=prompts, max_new=12)
    cases = [dict(base, name="t2", spec=SPEC, params=npp, mesh=(1, 1, 2)),
             dict(base, name="mixtral", spec=MIXTRAL, params=nmix, mesh=(1, 1, 2)),
             dict(base, name="mqa", spec=MQA, params=nmqa, mesh=(1, 1, 2)),
             *(dict(base, name=name, spec=OTHERS[name], params=others[name][2],
                    mesh=(1, 1, 2)) for name in OTHERS),
             dict(base, name="sampled", spec=SPEC, params=npp, mesh=(1, 1, 2), temp=0.8),
             dict(base, name="sampled-one", spec=SPEC, params=npp, mesh=None, temp=0.8),
             dict(base, name="sampled-d2", spec=SPEC, params=npp, mesh=(2, 1, 1), temp=0.8),
             dict(base, name="spec-sampled-one", spec=SPEC, params=npp, ssm=npp, mesh=None,
                  temp=0.8),
             dict(base, name="spec-sampled-d2", spec=SPEC, params=npp, ssm=npp, mesh=(2, 1, 1),
                  temp=0.8),
             dict(kind="indivisible", name="indivisible")]
    chunk = dict(max_tokens_per_batch=8)
    chunked = dict(base, spec=SPEC, params=npp, engine=chunk)
    cases += [dict(chunked, name=f"chunked-{n}", mesh=m)
              for n, m in (("one", None), ("t2", (1, 1, 2)), ("d2", (2, 1, 1)))]
    quantized = {bits: _jax_params(SPEC, 5, bits) for bits in (8, 4)}
    for bits, (_, _, q) in quantized.items():
        cases += [dict(base, name=f"int{bits}-{n}", spec=SPEC, params=q, mesh=m)
                  for n, m in (("one", None), ("t2", (1, 1, 2)), ("d2", (2, 1, 1)))]
    started = _start(tmp_path, 2, cases)
    want = {"t2": _jax_tokens(js, jparams, prompts, 12),
            "mixtral": _jax_tokens(jm, jmix, prompts, 12),
            "mqa": _jax_tokens(jq, jmqa, prompts, 12),
            **{name: _jax_tokens(*others[name][:2], prompts, 12) for name in OTHERS}}
    # the same carriers through JAX's engine; chunked prefill through JAX's
    # chunked engine
    for bits, (qs, qp, _) in quantized.items():
        want[f"int{bits}"] = _jax_tokens(qs, qp, prompts, 12)
    want["chunked"] = _jax_tokens(js, jparams, prompts, 12, engine=chunk)
    res = _join(tmp_path, 2, started)
    for name in ("t2", "mixtral", "mqa", *OTHERS):
        assert _all_ranks(res, name) == want[name], name
    sampled = _all_ranks(res, "sampled")
    assert all(len(t) == 12 for t in sampled) and sampled != want["t2"]
    # a data rank's sampled rows draw from their global rows' seeds: D = 2
    # samples the one-device tokens, incremental and speculative
    assert _all_ranks(res, "sampled-d2") == _all_ranks(res, "sampled-one")
    assert _all_ranks(res, "spec-sampled-d2") == _all_ranks(res, "spec-sampled-one")
    # quantized, and chunked prefill (8-token chunks: the owning data rank's
    # slot alone): each layout JAX's tokens and the port's one-device tokens
    for name in ("int8", "int4", "chunked"):
        one = _all_ranks(res, f"{name}-one")
        assert one == want[name], name
        for layout in ("t2", "d2"):
            assert _all_ranks(res, f"{name}-{layout}") == want[name] == one, (name, layout)
    assert "needs 4 ranks, the world has 2" in res[0]["indivisible"]
