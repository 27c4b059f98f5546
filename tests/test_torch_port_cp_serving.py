"""Context-parallel serving of the port (the verifier's KV cache cut on the
``seq`` axis) over gloo ranks on the CPU, held token for token against the
JAX package's engines at float32 (the helpers of
``test_torch_port_mesh_serving.py``; the ranks import no JAX):

- ``InferenceEngine`` at C = 2 (horizons 1 and 4, a chunked prefill, GQA,
  ALiBi, a logit softcap, JAX's INT8 and INT4 carriers, requests whose
  prompt or decode crosses the shard boundary, and ``S % C != 0``, where
  the cache stays whole) against JAX's one-device engine and JAX's
  ``make_mesh(model=2, seq=4)`` engine; at T = 2 x C = 2 and D = 2 x C = 2;
- ``SpecEngine`` at C = 2 with one draft (fused and stepwise), two drafts
  rotated and merged, against JAX's one-device managers, JAX's
  ``SpecEngine(mesh=make_mesh(seq=2))`` and incremental decoding;
- ``LLM.compile(context_parallel_degree=2)`` with and without a draft and
  ``incr_decoding --cp 2`` against JAX's ``LLM`` and CLI at one device;
- ``decoder.forward_cached`` under a seq cut in every form of its seq
  path (the kernel's and the plain path's: a chunk, a kv mask, extra draft
  columns, an attention window) against the one-device call;
- the cache writes of a seq rank's block against the whole cache's, and
  the surfaces that take a context degree beside the plain engines
  (``test_torch_port_cp_layouts.py`` and ``test_torch_port_pp_cp.py``
  hold them against JAX).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from test_torch_port_mesh_cli import _texts, _tiny_model
from test_torch_port_mesh_serving import (SPEC, _all_ranks, _cli_text, _jax_params, _join,
                                          _start, _tspec, unfused_jax)  # noqa: F401 (a fixture)

GQA = dict(SPEC, num_kv_heads=2)
MPT = dict(SPEC, arch="MPTForCausalLM", pos="alibi", norm="layernorm", act="gelu",
           tie_word_embeddings=True)
SOFTCAP = dict(GQA, attn_logit_softcap=3.0)
SLOTS, SEQ = 4, 128  # at C = 2 each rank holds 64 positions of every slot
NEW = 24
# 50 + 24 new tokens cross position 64 while decoding, a 70-token prompt in
# its prefill, 64 lands on the boundary itself
LENS = (5, 50, 70, 64)
DRAFT = (2, 3)  # beam width, depth


def _prompts(lens=LENS, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=n).tolist() for n in lens]


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _port_incr(case, mesh):
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    spec = _tspec(case["spec"])
    eng = InferenceEngine(spec, tp.params_from_numpy(case["params"], spec=spec, mesh=mesh),
                          cache_dtype=torch.float32, device="cpu", mesh=mesh,
                          max_requests_per_batch=SLOTS, **{"max_seq_len": SEQ,
                                                           **case.get("engine", {})})
    rm = RequestManager(eng, **case.get("rm", {}))
    try:
        out = [r.output_tokens for r in rm.generate(case["prompts"], _gen(case))]
    finally:
        rm.close()
    return dict(tokens=out, cache_positions=eng.cache.k.shape[3])


def _gen(case):
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig

    return GenerationConfig(max_new_tokens=case.get("max_new", NEW))


def _port_spec(case, mesh):
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.serving.spec_manager import MultiSSMSpecManager, SpecRequestManager
    from flexflow_tpu_torch.serving.speculative import SpecEngine

    spec = _tspec(case["spec"])
    llm = tp.params_from_numpy(case["params"], spec=spec, mesh=mesh)
    engines = []
    for params, (w, d) in zip(case["drafts"], case["shapes"]):
        first = engines[0] if engines else None
        engines.append(SpecEngine(
            spec, first.llm_params if first else llm, spec,
            tp.params_from_numpy(params, spec=spec, mesh=mesh), beam_width=w, beam_depth=d,
            max_requests_per_batch=SLOTS, max_seq_len=SEQ, cache_dtype=torch.float32,
            device="cpu", mesh=mesh, llm_cache=first.llm_cache if first else None))
    mode = case["mode"]
    if mode in ("one", "stepwise"):
        rm = SpecRequestManager(engines[0], fused=mode == "one")
    else:
        rm = MultiSSMSpecManager(engines, merged=mode == "merged", fused=mode == "rotation")
    reqs = rm.generate(case["prompts"], _gen(case))
    return dict(tokens=[r.output_tokens for r in reqs],
                cache_positions=engines[0].llm_cache.k.shape[3],
                draft_positions=engines[0].ssm_cache.k.shape[3])


def _port_llm(case, model_dir):
    from flexflow_tpu_torch.inference import incr_decoding
    from flexflow_tpu_torch.serve import LLM, SSM

    out = {}
    for name, ssms in (("llm-cp2", ()), ("spec-cp2", (SSM(model_dir, data_type="float32",
                                                          device="cpu"),))):
        llm = LLM(model_dir, data_type="float32", device="cpu")
        llm.compile(max_requests_per_batch=2, max_seq_length=128, context_parallel_degree=2,
                    ssms=ssms)
        engine = llm.rm.engine
        cache = engine.llm_cache if ssms else engine.cache
        out[name] = [r.output_tokens for r in llm.generate(case["prompts"], max_new_tokens=8)]
        out[f"{name}-positions"] = cache.k.shape[3]
    out["cli-cp2"] = _cli_text(incr_decoding, case["argv"] + ["--device", "cpu", "--cp", "2"])
    return out


def run_cp(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    meshes, out = {}, {}
    for case in cases:
        if case["kind"] == "llm":
            out.update(_port_llm(case, model_dir))
            continue
        shape = case["mesh"]
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device="cpu")
        run = _port_spec if case["kind"] == "spec" else _port_incr
        out[case["name"]] = run(case, meshes[shape])
    return out


# ---------------------------------------------------------------------------
# JAX's side
# ---------------------------------------------------------------------------


def _jax_incr(spec, params, prompts, mesh=None, engine=None, **rm_kw):
    import jax.numpy as jnp

    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager

    eng = InferenceEngine(spec, params, cache_dtype=jnp.float32, mesh=mesh,
                          max_requests_per_batch=SLOTS, **{"max_seq_len": SEQ, **(engine or {})})
    return [r.output_tokens for r in RequestManager(eng, **rm_kw).generate(
        prompts, GenerationConfig(max_new_tokens=NEW))]


def _jax_spec(spec, params, drafts, mode, prompts, mesh=None):
    import jax.numpy as jnp

    from flexflow_tpu.serving import GenerationConfig
    from flexflow_tpu.serving.spec_manager import MultiSSMSpecManager, SpecRequestManager
    from flexflow_tpu.serving.speculative import SpecEngine

    engines = [SpecEngine(spec, params, spec, d, beam_width=w, beam_depth=dd,
                          max_requests_per_batch=SLOTS, max_seq_len=SEQ,
                          cache_dtype=jnp.float32, mesh=mesh)
               for d, (w, dd) in zip(drafts, [DRAFT, (1, 4)])]
    if mode == "one":
        rm = SpecRequestManager(engines[0], fused=True)
    else:
        rm = MultiSSMSpecManager(engines, merged=mode == "merged", fused=mode == "rotation")
    return [r.output_tokens for r in rm.generate(prompts, GenerationConfig(max_new_tokens=NEW))]


def _tokens(results, name):
    """Every rank's tokens of case ``name`` (all equal)."""
    return _all_ranks([{name: r[name]["tokens"]} for r in results], name)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_cp2_engines_equal_jax(tmp_path, unfused_jax):
    """C = 2 over 2 gloo ranks: the incremental engine (horizons 1 and 4, a
    chunked prefill, ALiBi, softcap, INT8, INT4, S % C != 0) and SpecEngine
    (one draft fused and stepwise, two drafts rotated and merged) give JAX's
    one-device tokens; the incremental run also JAX's seq-mesh engine's, and
    the speculative runs JAX's ``SpecEngine(mesh=make_mesh(seq=2))``'s and
    incremental decoding's. Each rank holds 64 of the 128 positions (all
    127 where 127 % 2 != 0); the drafts' caches stay whole."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    prompts = _prompts()
    c2 = (1, 1, 1, 2)
    jg, gq, ng = _jax_params(GQA, 0)
    jd, draft, nd = _jax_params(GQA, 3)
    _, draft2, nd2 = _jax_params(GQA, 7)
    jm, mpt, nmpt = _jax_params(MPT, 6)
    jsc, sc, nsc = _jax_params(SOFTCAP, 8)
    quant = {bits: _jax_params(SPEC, 5, bits) for bits in (8, 4)}
    base = dict(kind="incr", spec=GQA, params=ng, prompts=prompts, mesh=c2)
    cases = [dict(base, name="h1"), dict(base, name="h4", rm=dict(decode_horizon=4)),
             dict(base, name="chunked", engine=dict(max_tokens_per_batch=16)),
             dict(base, name="odd", engine=dict(max_seq_len=SEQ - 1)),
             dict(base, name="alibi", spec=MPT, params=nmpt),
             dict(base, name="softcap", spec=SOFTCAP, params=nsc),
             *(dict(base, name=f"int{b}", spec=SPEC, params=q[2]) for b, q in quant.items())]
    sbase = dict(kind="spec", spec=GQA, params=ng, prompts=prompts, mesh=c2)
    cases += [dict(sbase, name="spec", mode="one", drafts=[nd], shapes=[DRAFT]),
              dict(sbase, name="stepwise", mode="stepwise", drafts=[nd], shapes=[DRAFT]),
              *(dict(sbase, name=m, mode=m, drafts=[nd, nd2], shapes=[DRAFT, (1, 4)])
                for m in ("rotation", "merged"))]
    started = _start(tmp_path, 2, cases, runner=run_cp)
    want = _jax_incr(jg, gq, prompts)
    assert want == _jax_incr(jg, gq, prompts, mesh=j_make_mesh(model=2, seq=4),
                             decode_horizon=4)
    refs = {"h1": want, "h4": _jax_incr(jg, gq, prompts, decode_horizon=4),
            "chunked": _jax_incr(jg, gq, prompts, engine=dict(max_tokens_per_batch=16)),
            "odd": _jax_incr(jg, gq, prompts, engine=dict(max_seq_len=SEQ - 1)),
            "alibi": _jax_incr(jm, mpt, prompts), "softcap": _jax_incr(jsc, sc, prompts),
            **{f"int{b}": _jax_incr(q[0], q[1], prompts) for b, q in quant.items()},
            "spec": _jax_spec(jg, gq, [draft], "one", prompts)}
    refs["stepwise"] = refs["spec"]
    assert refs["spec"] == _jax_spec(jg, gq, [draft], "one", prompts, mesh=j_make_mesh(seq=2))
    for mode in ("rotation", "merged"):
        refs[mode] = _jax_spec(jg, gq, [draft, draft2], mode, prompts)
    res = _join(tmp_path, 2, started)
    for name, w in refs.items():
        assert _tokens(res, name) == w, name
    for name in ("spec", "stepwise", "rotation", "merged"):
        assert _tokens(res, name) == want, name  # lossless: incremental decoding's tokens
    assert res[0]["h1"]["cache_positions"] == SEQ // 2
    assert res[0]["odd"]["cache_positions"] == SEQ - 1  # 127 % 2 != 0: the cache whole
    assert res[0]["spec"]["cache_positions"] == SEQ // 2
    assert res[0]["spec"]["draft_positions"] == SEQ  # the draft's cache whole on every rank


def test_cp2_with_tensor_and_data_axes_equal_jax(tmp_path, unfused_jax):
    """T = 2 x C = 2 and D = 2 x C = 2 over 4 gloo ranks (incremental, and
    the speculative engine at T = 2 x C = 2) give JAX's one-device tokens."""
    prompts = _prompts()
    jg, gq, ng = _jax_params(GQA, 1)
    _, draft, nd = _jax_params(GQA, 3)
    base = dict(kind="incr", spec=GQA, params=ng, prompts=prompts)
    cases = [dict(base, name="t2c2", mesh=(1, 1, 2, 2)),
             dict(base, name="d2c2", mesh=(2, 1, 1, 2), rm=dict(decode_horizon=4)),
             dict(base, kind="spec", name="spec-t2c2", mesh=(1, 1, 2, 2), mode="one",
                  drafts=[nd], shapes=[DRAFT])]
    started = _start(tmp_path, 4, cases, runner=run_cp)
    want = _jax_incr(jg, gq, prompts)
    res = _join(tmp_path, 4, started)
    for name in ("t2c2", "d2c2", "spec-t2c2"):
        assert _tokens(res, name) == want, name
    assert all(r["t2c2"]["cache_positions"] == SEQ // 2 for r in res)


def test_llm_compile_and_cli_with_a_context_degree_equal_jax(tmp_path):
    """``LLM.compile(context_parallel_degree=2)`` with and without a draft
    and ``incr_decoding --cp 2`` over two gloo ranks: JAX's ``LLM`` tokens
    at one device, and on rank 0 JAX's CLI text (nothing on rank 1)."""
    from flexflow_tpu.serve import LLM as JLLM
    from flexflow_tpu.serving import GenerationConfig as JGen
    from inference import incr_decoding as j_cli

    d = _tiny_model(tmp_path)
    prompts_file = tmp_path / "prompts.json"
    prompts_file.write_text(json.dumps(["hello world", "abc def"]))
    argv = ["-llm-model", str(d), "-prompt", str(prompts_file), "--max-new-tokens", "12",
            "--max-sequence-length", "64", "--max-requests-per-batch", "2", "--full-precision"]
    prompts = [[1, 5, 9, 12] * 15, [3, 4]]  # 60 + 8 tokens cross position 64 at C = 2
    started = _start(tmp_path, 2, [dict(kind="llm", prompts=prompts, argv=argv)], str(d),
                     runner=run_cp)
    jllm = JLLM(str(d), data_type="float32")
    jllm.compile(max_requests_per_batch=2, max_seq_length=128)
    want = [r.output_tokens for r in jllm.rm.generate(  # token ids, as the port's LLM takes
        prompts, JGen(max_new_tokens=8))]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_cli.main(argv) == 0
    res = _join(tmp_path, 2, started)
    assert len(want[0]) == 8
    assert _all_ranks(res, "llm-cp2") == want
    assert _all_ranks(res, "spec-cp2") == want
    assert res[0]["llm-cp2-positions"] == res[0]["spec-cp2-positions"] == 64
    assert len(_texts(res[0]["cli-cp2"])) == 2 and res[1]["cli-cp2"] == ""
    assert _texts(res[0]["cli-cp2"]) == _texts(out.getvalue())


DECODER_SPECS = {"gqa": GQA, "alibi": MPT, "softcap": SOFTCAP}


def run_decoder_paths(cases, model_dir):
    """Every rank: ``forward_cached`` under a seq cut of a 128-position
    cache against the one-device call on the whole cache, in each form of
    the decoder's seq path: the kernel's (decode, a tree; their plain
    versions on the CPU) and the plain one's (a chunk at a host window, a
    kv mask, extra draft columns, an attention window). Returns each
    case's logits' max |err| over their magnitude and the written block's
    max |err| against the whole cache's."""
    from flexflow_tpu_torch.models import decoder as td
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.sharding import tree_shard, with_seq

    mesh = make_mesh(seq=2, device="cpu")
    out = {}
    for name, kw in DECODER_SPECS.items():
        spec = _tspec(kw)
        params = tp.init_params(spec, 0, dtype=torch.float32)
        shard = with_seq(tree_shard(spec, params, mesh), SEQ)
        lo, hi = shard.seq.lo, shard.seq.hi
        g = torch.Generator().manual_seed(1)
        nl, b, kh, d = spec.num_layers, 3, spec.num_kv_heads, spec.head_dim
        whole = [torch.randn(nl, b, kh, SEQ, d, generator=g) for _ in range(2)]
        lens = torch.tensor([10, 60, 40], dtype=torch.int32)  # 60 + 8 crosses 64
        eye = torch.eye(2, dtype=torch.bool)[None].expand(b, 2, 2)
        tree = torch.tril(torch.ones(4, 4, dtype=torch.bool))[None].repeat(b, 1, 1)
        tree[:, 2, 1] = False  # siblings 1 and 2
        extra = [torch.randn(nl, b, 3, kh, d, generator=g) for _ in range(2)]
        forms = {
            "decode": dict(t=1),
            "tree": dict(t=4, tree_mask=tree, write_cache=False),
            "chunk": dict(t=8, write_start=lens.numpy()),
            "kv_mask": dict(t=2, tree_mask=eye, write_start=lens.numpy(),
                            kv_mask=torch.rand(b, 2, SEQ, generator=g) < 0.3),
            "extra": dict(t=2, tree_mask=eye, write_cache=False, extra_kv=tuple(extra),
                          extra_mask=torch.ones(b, 2, 3, dtype=torch.bool),
                          extra_positions=(lens[:, None] + torch.arange(3)).int()),
            "window": dict(t=1, attn_window=64, lens=torch.tensor([10, 60, 40])),
        }
        for form, kw2 in forms.items():
            kw2 = dict(kw2)
            t, ln = kw2.pop("t"), kw2.pop("lens", lens).int()
            toks = torch.randint(1, spec.vocab_size, (b, t), generator=g)
            one = td.KVCache(*(c.clone() for c in whole))
            blk = td.KVCache(*(c[:, :, :, lo:hi].clone() for c in whole))
            with torch.no_grad():
                want, _ = td.forward_cached(spec, params, toks, one, ln, **kw2)
                got, _ = td.forward_cached(spec, params, toks, blk, ln, shard=shard, **kw2)
            out[f"{name}-{form}"] = (
                ((got - want).abs().max() / want.abs().max()).item(),
                max((bc - oc[:, :, :, lo:hi]).abs().max().item()
                    for bc, oc in zip(blk, one)))
    return out


def test_decoder_seq_path_equals_one_device(tmp_path):
    """``decoder.forward_cached`` at C = 2 (GQA, ALiBi, softcap) in every
    form of its seq path (decode, a tree, a chunk at a host window, a kv
    mask, extra draft columns with their ALiBi positions, an attention
    window ending inside rank 0's block) gives the one-device logits within
    1e-5 of their magnitude, the same on both ranks, and writes its block
    of the cache as the one-device call writes it (1e-5)."""
    res = _join(tmp_path, 2, _start(tmp_path, 2, [None], runner=run_decoder_paths))
    assert len(res[0]) == 18
    for key, (logits_rel, _) in res[0].items():  # each rank: the same logits, its own block
        assert logits_rel == res[1][key][0] and logits_rel <= 1e-5, (key, logits_rel)
        assert all(r[key][1] <= 1e-5 for r in res), (key, [r[key][1] for r in res])


@pytest.mark.parametrize("first", [0, 16, 32, 48])
def test_block_writes_equal_the_whole_cache(first):
    """A seq rank's block (16 positions from ``first`` of a 64-position
    cache) written by ``device_window``, ``commit_kv_windows``, ``insert_kv``
    and ``commit_from_buffer`` equals the same block of the whole cache
    written by the same calls (windows that start before, inside, across
    and past the block, and past S)."""
    from flexflow_tpu_torch.models import decoder as td
    from flexflow_tpu_torch.serving.speculative import commit_from_buffer

    g = torch.Generator().manual_seed(first)
    L, B, KH, S, D, W, T = 2, 5, 2, 64, 4, 16, 6

    def caches():
        whole = td.KVCache(torch.randn(L, B, KH, S, D, generator=g),
                           torch.randn(L, B, KH, S, D, generator=g))
        block = td.KVCache(whole.k[:, :, :, first:first + W].clone(),
                           whole.v[:, :, :, first:first + W].clone())
        return whole, block

    lens = torch.tensor([0, first - 3, first + 5, first + W - 2, S - 2]).clamp(0, S)
    upd = torch.randn(L, B, KH, T, D, generator=g), torch.randn(L, B, KH, T, D, generator=g)
    whole, block = caches()
    td.commit_kv_windows(whole.k, whole.v, *upd, lens.numpy())
    td.commit_kv_windows(block.k, block.v, *upd, lens.numpy(), first=first)
    checks = [(whole, block)]
    whole, block = caches()
    for cache, f in ((whole, 0), (block, first)):
        slots, pos, keep = td.device_window(lens, T, cache.max_seq_len, f)
        k = keep[:, :, None, None, None]
        cache.k[:, slots, :, pos] = torch.where(k, upd[0].permute(1, 3, 0, 2, 4),
                                                cache.k[:, slots, :, pos])
    checks.append((whole, block))
    whole, block = caches()
    pre = torch.randn(L, 40, KH, D, generator=g), torch.randn(L, 40, KH, D, generator=g)
    td.insert_kv(whole, *pre, slot=3)
    td.insert_kv(block, *pre, slot=3, first=first)
    checks.append((whole, block))
    whole, block = caches()
    buf = torch.randn(L, B, 9, KH, D, generator=g), torch.randn(L, B, 9, KH, D, generator=g)
    path = torch.randint(0, 9, (B, 4), generator=g)
    commit_from_buffer(whole, lens, *buf, path)
    commit_from_buffer(block, lens, *buf, path, first)
    checks.append((whole, block))
    for whole, block in checks:
        assert torch.equal(whole.k[:, :, :, first:first + W], block.k)
        assert torch.equal(whole.v[:, :, :, first:first + W], block.v)


def test_surfaces_under_a_context_degree_construct():
    """Under a context degree (a seq rank's ``Mesh.fake``) the surfaces
    build: the Trainer, FFModel, the pipeline engine under ``pipe x seq``
    (its stage's layers, its whole cache), LoRA / offload / hybrid_ffn in
    the incremental engine (the cache cut on ``seq``) and FinetuneSession
    on a LoRA engine; ``make_mesh(pipe=2, seq=2)`` and ``LLM.compile``
    with pipeline stages, offload or LoRA adapters under
    ``context_parallel_degree=2`` go on to ask for the process group.
    ``seq_cut`` keeps the cache whole where the length does not divide."""
    from flexflow_tpu_torch.ffmodel.model import FFModel
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.models.layer_store import LayerStore
    from flexflow_tpu_torch.parallel.mesh import Mesh, make_mesh
    from flexflow_tpu_torch.parallel.sharding import seq_cut
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.serve import LLM
    from flexflow_tpu_torch.serving.engine import InferenceEngine
    from flexflow_tpu_torch.serving.pp_engine import PipelineInferenceEngine
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer

    asks = pytest.raises(RuntimeError, match="a 4-rank mesh needs a process group")
    with asks:
        make_mesh(pipe=2, seq=2, device="cpu")
    spec = _tspec(SPEC)
    params = tp.init_params(spec, 0)
    cp = Mesh.fake(1, 1, 1, seq=2)
    assert Trainer(spec, params, SGDOptimizer(lr=0.1), mesh=cp).mesh is cp
    assert FFModel(mesh=cp)._mesh is cp
    pp = PipelineInferenceEngine(spec, params, mesh=Mesh.fake(1, 1, 3, pipe=2, seq=2),
                                 max_requests_per_batch=2, max_seq_len=SEQ,
                                 cache_dtype=torch.float32)
    assert pp.layers == (1, 2) and pp.cache.k.shape[:4] == (1, 2, 8, SEQ)  # the whole cache
    lora = {"wq": {"a": torch.zeros(2, 1, 64, 4), "b": torch.zeros(2, 1, 4, 64)}}
    kw = dict(device="cpu", mesh=cp, max_seq_len=SEQ, max_requests_per_batch=2)
    for extra in (dict(lora=lora), dict(offload=True), dict(hybrid_ffn=True)):
        eng = InferenceEngine(spec, params, **kw, **extra)
        assert eng.shard.seq.lo == SEQ // 2 and eng.cache.k.shape[3] == SEQ // 2
        assert isinstance(eng.params["layers"], LayerStore) == ("offload" in extra)
    session = FinetuneSession(spec, LoraConfig(target_modules=("wq",)), 0, [])
    session._build(InferenceEngine(spec, params, lora=lora, **kw))
    assert session.params["wq"]["a"].shape == (2, 64, 4)

    def llm(peft=()):
        out = LLM.__new__(LLM)
        out._ssms, out._peft = [], list(peft)
        out.quant_bits, out.device = None, torch.device("cpu")
        return out

    for model, extra in ((llm(), dict(pipeline_parallelism_degree=2)),
                         (llm(), dict(offload=True, tensor_parallelism_degree=2)),
                         (llm(peft=[(LoraConfig(), None)]), dict(tensor_parallelism_degree=2))):
        with asks:
            model.compile(context_parallel_degree=2, **extra)
    assert seq_cut(Mesh.fake(1, 1, 1, seq=2), 128).lo == 64
    assert seq_cut(Mesh.fake(1, 1, 1, seq=2), 127) is None
    assert seq_cut(Mesh.fake(1, 1, 0), 128) is None
