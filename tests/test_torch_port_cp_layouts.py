"""Context parallelism (a ``seq`` mesh axis) with the layouts and the
training surfaces that take it besides the plain engines, over gloo ranks
on the CPU (the spawn helpers of ``test_torch_port_mesh_serving.py``), held
against the JAX package at float32 (the ranks import no JAX: the parent
computes JAX's side while they run):

- LoRA serving with JAX's two adapters (B drawn), per-request adapter ids,
  horizons 1 and 4, prompts and decodes that cross the shard boundary, at
  C = 2 and T = 2 x C = 2 against JAX's ``InferenceEngine(lora=)`` on
  ``make_mesh(seq=2)`` / ``(model=2, seq=2)`` and at one device, with JAX's
  INT8 and INT4 carriers once; each rank's cache holds S / C positions;
- CPU offload at C = 2 against JAX's offload engine on ``make_mesh(seq=2)``
  and the port's resident C = 2 engine (bitwise);
- ``hybrid_ffn`` at D = 2 x C = 2 and T = 2 x C = 2 against JAX's hybrid
  engine on the matching mesh and on ``make_mesh(data=2, model=2, seq=2)``;
- co-scheduled LoRA finetuning on a C = 2 engine (JAX's
  ``tests/test_peft.py::test_finetune_coscheduled`` set-up): tokens equal
  JAX's, losses within 1e-5 of JAX's seq = 2 run, both ranks' adapters
  equal bit for bit;
- the Trainer at C = 2 and D = 2 x C = 2 against JAX's ``Trainer(mesh=)``
  (``test_torch_port_mesh_training.py``'s tolerances), every seq rank's
  parameters equal bit for bit, and at C = 2 its losses and parameters
  bitwise the port's one-device Trainer's;
- ``FFModel(mesh=)`` with a seq mesh trains as without it;
- ``LLM.compile(context_parallel_degree=2)`` with ``offload=True`` and with
  an HF PEFT adapter against JAX's ``LLM`` at one device.
"""

import numpy as np
import torch

from test_torch_port_cp_serving import _prompts
from test_torch_port_mesh_layouts import HYBRID, OFFLOAD, _hybrid_prompts, _offload_prompts
from test_torch_port_mesh_serving import (SPEC, _join, _numpy_tree, _start, _tspec,
                                          unfused_jax)  # noqa: F401 (a fixture)
from test_torch_port_mesh_training import TSPEC, _batches, _jax_train
from test_torch_port_mesh_training import _train as _rank_train
from test_torch_port_pp_serving import LORA_CFG

GQA = dict(SPEC, num_kv_heads=2)
SEQ, NEW = 128, 24
IDS = [0, 1, -1, 0]  # the requests' adapters (cp_serving's LENS prompts)
# tests/test_peft.py: TINY, CFG and test_finetune_coscheduled's session
PEFT_TINY = dict(arch="LlamaForCausalLM", vocab_size=96, hidden_size=64, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
                 max_position_embeddings=128, norm_eps=1e-6)
FT_CFG = dict(rank=4, alpha=8.0, target_modules=("wq", "wv", "wd"))
FT_SESSION = dict(FT_CFG, learning_rate=5e-2)
FT_EPOCHS, FT_PROMPTS, FT_IDS = 8, [[3, 17, 91], [5, 6, 7, 8, 9]], (-1, 0)
# the tiny HF LLaMA the LLM cases load (test_torch_port_mesh_cli's geometry)
HF_TINY = dict(arch="LlamaForCausalLM", vocab_size=128, hidden_size=64, num_layers=2,
               num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
               max_position_embeddings=128, norm_eps=1e-6)


def _ft_data():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, PEFT_TINY["vocab_size"], size=(4, 12)).astype(np.int32)
    return [(toks, np.roll(toks, -1, axis=1))]


# ---------------------------------------------------------------------------
# the ranks (no JAX)
# ---------------------------------------------------------------------------


def _engine(case, mesh):
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.peft.lora import LoraConfig
    from flexflow_tpu_torch.serving.engine import InferenceEngine

    spec = _tspec(case["spec"])
    kw = dict(max_requests_per_batch=4, max_seq_len=case.get("seq", SEQ),
              cache_dtype=torch.float32, device="cpu", mesh=mesh, **case.get("engine", {}))
    if "lora" in case:
        kw.update(lora=tp.lora_from_numpy(case["lora"]),
                  lora_config=LoraConfig(**case.get("lora_cfg", LORA_CFG)))
    return spec, InferenceEngine(spec, tp.params_from_numpy(case["params"]), **kw)


def _requests(rm, case, ids):
    from flexflow_tpu_torch.serving.request_manager import GenerationConfig

    g = [rm.register_request(p, GenerationConfig(max_new_tokens=case["max_new"], adapter_id=a))
         for p, a in zip(case["prompts"], ids)]
    rm.run_until_idle()
    return [rm.get_request(i).output_tokens for i in g]


def _serve(case, mesh):
    """The served tokens (each request through its adapter id), and what
    the rank holds: its cache's positions, its slots, whether its layers
    are a LayerStore, and its FFN's group."""
    from flexflow_tpu_torch.models.layer_store import LayerStore
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    _, eng = _engine(case, mesh)
    rm = RequestManager(eng, **case.get("rm", {}))
    try:
        tokens = _requests(rm, case, case.get("ids", [-1] * len(case["prompts"])))
    finally:
        rm.close()
    return dict(tokens=tokens, positions=eng.cache.k.shape[3],
                slots=(eng.slots.lo, eng.slots.hi),
                store=isinstance(eng.params["layers"], LayerStore),
                ffn_axis=str(eng.shard.ffn_axis))


def _finetune(case, mesh):
    """A FinetuneSession co-scheduled on the engine (slot 0) while a base
    request and an adapter-0 request are served: tokens, losses, the slot."""
    from flexflow_tpu_torch.peft.finetune import FinetuneSession
    from flexflow_tpu_torch.peft.lora import LoraConfig, unroute_lora
    from flexflow_tpu_torch.serving.request_manager import RequestManager

    spec, eng = _engine(case, mesh)
    rm = RequestManager(eng)
    sess = FinetuneSession(spec, LoraConfig(**FT_SESSION), 0, case["data"], epochs=FT_EPOCHS)
    rm.register_finetune(sess)
    try:
        tokens = _requests(rm, case, FT_IDS)
    finally:
        rm.close()
    return dict(tokens=tokens, losses=sess.losses, positions=eng.cache.k.shape[3],
                slot={m: {k: v[:, 0].numpy() for k, v in ab.items()}
                      for m, ab in unroute_lora(eng.lora).items()})


def _llm(case, mesh, model_dir):
    """``LLM.compile(context_parallel_degree=2)`` with offload, and with an
    HF PEFT adapter served through its slot."""
    from flexflow_tpu_torch.models.layer_store import LayerStore
    from flexflow_tpu_torch.serve import LLM

    out = {}
    for name, kw in (("offload", dict(offload=True)), ("peft", {})):
        llm = LLM(model_dir, data_type="float32", device="cpu")
        slot = -1
        if name == "peft":
            slot = llm.register_peft_adapter(case["adapter"])
        llm.compile(max_requests_per_batch=2, max_seq_length=SEQ, context_parallel_degree=2,
                    **kw)
        eng = llm.rm.engine
        res = llm.generate(case["prompts"], max_new_tokens=8, adapter_id=slot)
        out[name] = dict(tokens=[r.output_tokens for r in res], positions=eng.cache.k.shape[3],
                         store=isinstance(eng.params["layers"], LayerStore))
        llm.rm.close()
    return out


def run_cp_layout_cases(cases, model_dir):
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    meshes, out = {}, {}
    for case in cases:
        shape = case.get("mesh", (1, 1, 1, 2))
        if case["kind"] == "llm":
            out[case["name"]] = _llm(case, None, model_dir)
            continue
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape, device="cpu")
        run = {"serve": _serve, "finetune": _finetune, "train": _rank_train}[case["kind"]]
        out[case["name"]] = run(case, meshes[shape])
    return out


# ---------------------------------------------------------------------------
# JAX's side
# ---------------------------------------------------------------------------


def _tree(kw, seed, bits=None):
    """(JAX's spec, JAX's tree, the ranks' numpy tree) of the port's seeded
    init (drawn by torch: no JAX compile before the ranks start); with
    ``bits``, JAX's carriers of it (group 16)."""
    import jax
    import jax.numpy as jnp

    from flexflow_tpu import specs as jspecs
    from flexflow_tpu.quant import quantize_params
    from flexflow_tpu_torch.models import params as tp

    tree = _numpy_tree(jax.tree.map(lambda t: t.numpy(), tp.init_params(_tspec(kw), seed)))
    spec, params = jspecs.ModelSpec(**kw), jax.tree.map(jnp.asarray, tree)
    if bits:
        params = quantize_params(spec, params, bits=bits, group_size=16,
                                 compute_dtype=jnp.float32)
        tree = _numpy_tree(params)
    return spec, params, tree


def _lora(kw, seed, modules=("wq", "wv", "wd"), n=2, b_std=0.05):
    """numpy adapter stacks in JAX's layout ([L, N, D_in, r], [L, N, r,
    D_out]; r = 4), A scaled by 1 / sqrt(D_in), B drawn (``b_std`` 0: B
    zero, JAX's fresh adapter), and JAX's copy."""
    import jax
    import jax.numpy as jnp

    d, q, kv, f = (kw["hidden_size"], kw["num_heads"] * kw["head_dim"],
                   kw["num_kv_heads"] * kw["head_dim"], kw["intermediate_size"])
    dims = {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d), "wg": (d, f),
            "wu": (d, f), "wd": (f, d)}
    rng = np.random.RandomState(seed)
    stacks = {m: {"a": (rng.standard_normal((kw["num_layers"], n, dims[m][0], 4))
                        / np.sqrt(dims[m][0])).astype(np.float32),
                  "b": (rng.standard_normal((kw["num_layers"], n, 4, dims[m][1]))
                        * b_std).astype(np.float32)} for m in modules}
    return jax.tree.map(jnp.asarray, stacks), stacks


def _hf_dir(d, kw, seed=0):
    """An HF LLaMA directory of ``kw``'s geometry (config.json, float32
    safetensors of the port's seeded init under HF names, a byte-level
    tokenizer), written without building a transformers model."""
    import json

    import safetensors.numpy

    from flexflow_tpu_torch.models import params as tp
    from test_torch_port_mesh_layouts import _tokenizer

    d.mkdir(parents=True)
    p = tp.init_params(_tspec(kw), seed)
    lay, n = p["layers"], kw["num_layers"]
    hf = {"model.embed_tokens.weight": p["embed_tokens"], "model.norm.weight":
          p["final_norm_scale"], "lm_head.weight": p["lm_head"].T}
    for i in range(n):
        pre = f"model.layers.{i}."
        hf.update({pre + "input_layernorm.weight": lay["ln1_scale"][i],
                   pre + "post_attention_layernorm.weight": lay["ln2_scale"][i],
                   pre + "self_attn.o_proj.weight": lay["wo"][i].reshape(-1, kw["hidden_size"]).T,
                   pre + "mlp.gate_proj.weight": lay["wg"][i].T,
                   pre + "mlp.up_proj.weight": lay["wu"][i].T,
                   pre + "mlp.down_proj.weight": lay["wd"][i].T})
        for m in ("q", "k", "v"):
            hf[pre + f"self_attn.{m}_proj.weight"] = lay[f"w{m}"][i].reshape(
                kw["hidden_size"], -1).T
    safetensors.numpy.save_file({k: v.contiguous().numpy() for k, v in hf.items()},
                                str(d / "model.safetensors"), metadata={"format": "pt"})
    (d / "config.json").write_text(json.dumps(dict(
        architectures=["LlamaForCausalLM"], model_type="llama", vocab_size=kw["vocab_size"],
        hidden_size=kw["hidden_size"], intermediate_size=kw["intermediate_size"],
        num_hidden_layers=n, num_attention_heads=kw["num_heads"],
        num_key_value_heads=kw["num_kv_heads"], rms_norm_eps=kw["norm_eps"],
        max_position_embeddings=kw["max_position_embeddings"], rope_theta=10000.0,
        tie_word_embeddings=False, torch_dtype="float32")))
    _tokenizer(d)
    return d


def _jax_serve(spec, params, prompts, max_new, ids=None, mesh=None, lora=None,
               lora_cfg=LORA_CFG, seq=SEQ, rm=None, **engine):
    import jax.numpy as jnp

    from flexflow_tpu.peft import LoraConfig
    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager

    kw = dict(max_requests_per_batch=4, max_seq_len=seq, cache_dtype=jnp.float32, mesh=mesh,
              **engine)
    if lora is not None:
        kw.update(lora=lora, lora_config=LoraConfig(**lora_cfg))
    mgr = RequestManager(InferenceEngine(spec, params, **kw), **(rm or {}))
    g = [mgr.register_request(p, GenerationConfig(max_new_tokens=max_new, adapter_id=a))
         for p, a in zip(prompts, ids or [-1] * len(prompts))]
    mgr.run_until_idle()
    return [mgr.get_request(i).output_tokens for i in g]


def _jax_finetune(spec, params, lora, data, mesh=None):
    import jax
    import jax.numpy as jnp

    from flexflow_tpu.peft import LoraConfig
    from flexflow_tpu.peft.finetune import FinetuneSession
    from flexflow_tpu.serving import GenerationConfig, InferenceEngine, RequestManager

    eng = InferenceEngine(spec, params, max_requests_per_batch=4, max_seq_len=64,
                          cache_dtype=jnp.float32, mesh=mesh,
                          lora=jax.tree.map(jnp.array, lora),  # a copy: a step donates it
                          lora_config=LoraConfig(**FT_CFG))
    rm = RequestManager(eng)
    sess = FinetuneSession(spec, LoraConfig(**FT_SESSION), 0, data, epochs=FT_EPOCHS)
    rm.register_finetune(sess)
    g = [rm.register_request(p, GenerationConfig(max_new_tokens=4, adapter_id=a))
         for p, a in zip(FT_PROMPTS, FT_IDS)]
    rm.run_until_idle()
    return dict(tokens=[rm.get_request(i).output_tokens for i in g],
                losses=[float(x) for x in sess.losses],
                slot={m: {k: np.asarray(v)[:, 0] for k, v in ab.items()}
                      for m, ab in eng.lora.items()})


def _tokens(res, name, key="tokens"):
    """Every rank's ``key`` of case ``name`` (all equal)."""
    got = [r[name][key] for r in res]
    assert all(g == got[0] for g in got), name
    return got[0]


def _close(got, want, tol):
    for k, w in want.items():
        if isinstance(w, dict):
            _close(got[k], w, tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(w), atol=tol, rtol=tol, err_msg=k)


def _one_device_train(params, batches):
    """The port's one-device Trainer on the "train" case: its losses and
    final parameters (numpy)."""
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.training import SGDOptimizer, Trainer

    tr = Trainer(_tspec(TSPEC), tp.params_from_numpy(params), SGDOptimizer(lr=0.05),
                 device="cpu")
    losses = [tr.train_step(toks, labels) for toks, labels in batches]
    full = tr.full_params()

    def numpy(tree):
        return ({k: numpy(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.detach().numpy().copy())

    return dict(losses=losses, full=numpy(full))


def _equal_on_ranks(res, name, key):
    """``key`` of case ``name`` bitwise the same on every rank."""
    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {k2: v for k, sub in tree.items() for k2, v in flat(sub, f"{pre}{k}.").items()}
        return {pre: np.asarray(tree)}

    first = flat(res[0][name][key])
    for r in res[1:]:
        other = flat(r[name][key])
        assert all(np.array_equal(first[k], other[k]) for k in first), (name, key)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def test_two_seq_ranks_lora_offload_finetune_trainer_llm(tmp_path, unfused_jax):
    """C = 2 over 2 gloo ranks: LoRA serving (horizons 1 and 4; INT8 and
    INT4 carriers) against JAX's seq-mesh and one-device engines, offload
    against JAX's seq-mesh offload engine and the resident C = 2 engine,
    co-scheduled finetuning against JAX's seq = 2 session, the Trainer
    against JAX's ``Trainer(mesh=make_mesh(seq=2))``, and ``LLM.compile``
    with offload and with a PEFT adapter against JAX's one-device ``LLM``."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh
    from flexflow_tpu.serve import LLM as JLLM
    from flexflow_tpu.serving import GenerationConfig as JGen
    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.peft import lora as tl

    prompts = _prompts()
    jg, gq, ng = _tree(GQA, 0)
    jlora, nlora = _lora(GQA, 1)
    quant = {bits: _tree(SPEC, 5, bits) for bits in (8, 4)}
    qlora = _lora(SPEC, 2)
    jo, joff, noff = _tree(OFFLOAD, 2)
    fs, fparams, nft = _tree(PEFT_TINY, 3)
    flora, nflora = _lora(PEFT_TINY, 3, n=1, b_std=0.0)  # a fresh adapter: B zero
    js, jtrain_p, ntrain = _tree(TSPEC, 4)
    batches = _batches(TSPEC["vocab_size"], seed=3)
    model_dir = _hf_dir(tmp_path / "model", HF_TINY)
    _, stacks = _lora(HF_TINY, 4, n=1, b_std=0.5)
    tl.export_hf_adapter(str(tmp_path / "adapter"), _tspec(HF_TINY), tp.lora_from_numpy(stacks),
                         0, tl.LoraConfig(**LORA_CFG))
    llm_prompts = [[1, 5, 9, 12] * 15, [3, 4]]  # 60 + 8 tokens cross position 64 at C = 2
    lbase = dict(kind="serve", spec=GQA, params=ng, prompts=prompts, max_new=NEW, lora=nlora,
                 ids=IDS)
    cases = [dict(lbase, name="lora-h1"), dict(lbase, name="lora-h4", rm=dict(decode_horizon=4)),
             *(dict(lbase, name=f"lora-int{b}", spec=SPEC, params=q[2], lora=qlora[1])
               for b, q in quant.items()),
             *(dict(kind="serve", name=f"offload-{e}", spec=OFFLOAD, params=noff,
                    prompts=_offload_prompts(), max_new=NEW, seq=64, rm=dict(decode_horizon=4),
                    engine=dict(offload=e == "on")) for e in ("on", "off")),
             dict(kind="finetune", name="ft", spec=PEFT_TINY, params=nft, lora=nflora,
                  lora_cfg=FT_CFG, prompts=FT_PROMPTS, max_new=4, data=_ft_data(), seq=64),
             dict(kind="train", name="train", spec=TSPEC, params=ntrain, opt="sgd",
                  batches=batches, full=True),
             dict(kind="llm", name="llm", prompts=llm_prompts, adapter=str(tmp_path / "adapter"))]
    started = _start(tmp_path, 2, cases, str(model_dir), runner=run_cp_layout_cases)
    seq2 = j_make_mesh(seq=2)
    want = _jax_serve(jg, gq, prompts, NEW, IDS, lora=jlora)
    assert want == _jax_serve(jg, gq, prompts, NEW, IDS, mesh=seq2, lora=jlora)
    assert want != _jax_serve(jg, gq, prompts, NEW, IDS)  # the adapters act
    want_h4 = _jax_serve(jg, gq, prompts, NEW, IDS, lora=jlora, rm=dict(decode_horizon=4))
    want_q = {b: _jax_serve(q[0], q[1], prompts, NEW, IDS, lora=qlora[0])
              for b, q in quant.items()}
    want_off = _jax_serve(jo, joff, _offload_prompts(), NEW, mesh=seq2, seq=64, offload=True,
                          rm=dict(decode_horizon=4))
    ft_seq = _jax_finetune(fs, fparams, flora, _ft_data(), mesh=seq2)
    ft_one = _jax_finetune(fs, fparams, flora, _ft_data())
    jtrain = _jax_train(js, jtrain_p, batches, "sgd", seq2)
    jtrain_one = _jax_train(js, jtrain_p, batches, "sgd")
    jllm = JLLM(str(model_dir), data_type="float32")
    jllm.compile(max_requests_per_batch=2, max_seq_length=SEQ)
    want_llm = [r.output_tokens for r in jllm.rm.generate(llm_prompts, JGen(max_new_tokens=8))]
    jpeft = JLLM(str(model_dir), data_type="float32")
    slot = jpeft.register_peft_adapter(str(tmp_path / "adapter"))
    jpeft.compile(max_requests_per_batch=2, max_seq_length=SEQ)
    want_peft = [r.output_tokens for r in jpeft.rm.generate(
        llm_prompts, JGen(max_new_tokens=8, adapter_id=slot))]
    res = _join(tmp_path, 2, started)

    assert _tokens(res, "lora-h1") == want
    assert _tokens(res, "lora-h4") == want_h4
    for b in (8, 4):
        assert _tokens(res, f"lora-int{b}") == want_q[b], b
    assert res[0]["lora-h1"]["positions"] == SEQ // 2
    assert _tokens(res, "offload-on") == want_off == _tokens(res, "offload-off")
    assert [r["offload-on"]["store"] for r in res] == [True, True]
    assert all(r[f"offload-{e}"]["positions"] == 32 for r in res for e in ("on", "off"))
    assert _tokens(res, "ft") == ft_seq["tokens"] == ft_one["tokens"]
    for r in res:
        np.testing.assert_allclose(r["ft"]["losses"], ft_seq["losses"], atol=1e-5, rtol=1e-5)
        _close(r["ft"]["slot"], ft_seq["slot"], 1e-4)
    assert len(res[0]["ft"]["losses"]) == FT_EPOCHS and res[0]["ft"]["positions"] == 32
    np.testing.assert_allclose(ft_seq["losses"], ft_one["losses"], atol=2e-6, rtol=1e-5)
    _equal_on_ranks(res, "ft", "losses")
    _equal_on_ranks(res, "ft", "slot")
    for r in res:
        np.testing.assert_allclose(r["train"]["losses"], jtrain["losses"], atol=1e-5, rtol=1e-5)
        _close(r["train"]["full"], jtrain["params"], 1e-4)
    np.testing.assert_allclose(jtrain["losses"], jtrain_one["losses"], atol=1e-5, rtol=1e-5)
    _equal_on_ranks(res, "train", "losses")
    _equal_on_ranks(res, "train", "full")
    # and bitwise the port's one-device Trainer: no sum runs over seq, and a
    # mesh of one model rank takes the one-device products (C6)
    one = {"train": _one_device_train(ntrain, batches)}
    for r in res:
        assert r["train"]["losses"] == one["train"]["losses"]
        _equal_on_ranks([r, one], "train", "full")
    llm = [r["llm"] for r in res]
    assert all(x == llm[0] for x in llm)
    assert llm[0]["offload"]["tokens"] == want_llm and llm[0]["offload"]["store"]
    assert llm[0]["peft"]["tokens"] == want_peft != want_llm
    assert llm[0]["offload"]["positions"] == llm[0]["peft"]["positions"] == SEQ // 2


def test_four_ranks_lora_hybrid_trainer_with_a_seq_axis(tmp_path, unfused_jax):
    """4 gloo ranks: LoRA at T = 2 x C = 2 against JAX's engine on
    ``make_mesh(model=2, seq=2)``; ``hybrid_ffn`` at D = 2 x C = 2 and T = 2
    x C = 2 against JAX's hybrid engine on the matching mesh and on
    ``make_mesh(data=2, model=2, seq=2)`` (and one device's); the Trainer at
    D = 2 x C = 2 against JAX's ``Trainer(mesh=make_mesh(data=2, seq=2))``."""
    from flexflow_tpu.parallel import make_mesh as j_make_mesh

    prompts = _prompts()
    jg, gq, ng = _tree(GQA, 1)
    jlora, nlora = _lora(GQA, 5)
    jh, jhyb, nhyb = _tree(HYBRID, 2)
    hprompts = _hybrid_prompts()
    js, jtrain_p, ntrain = _tree(TSPEC, 6)
    batches = _batches(TSPEC["vocab_size"], seed=4)
    hbase = dict(kind="serve", spec=HYBRID, params=nhyb, prompts=hprompts, max_new=20, seq=64,
                 engine=dict(hybrid_ffn=True), rm=dict(decode_horizon=4))
    cases = [dict(kind="serve", name="lora-t2c2", spec=GQA, params=ng, prompts=prompts,
                  max_new=NEW, lora=nlora, ids=IDS, mesh=(1, 1, 2, 2)),
             dict(hbase, name="hybrid-d2c2", mesh=(2, 1, 1, 2)),
             dict(hbase, name="hybrid-t2c2", mesh=(1, 1, 2, 2)),
             dict(kind="train", name="train-d2c2", spec=TSPEC, params=ntrain, opt="sgd",
                  batches=batches, full=True, mesh=(2, 1, 1, 2))]
    started = _start(tmp_path, 4, cases, runner=run_cp_layout_cases)
    want_lora = _jax_serve(jg, gq, prompts, NEW, IDS, mesh=j_make_mesh(model=2, seq=2),
                           lora=jlora)
    assert want_lora == _jax_serve(jg, gq, prompts, NEW, IDS, lora=jlora)
    hkw = dict(seq=64, rm=dict(decode_horizon=4))
    want_hyb = {name: _jax_serve(jh, jhyb, hprompts, 20, mesh=j_make_mesh(**m), hybrid_ffn=True,
                                 **hkw)
                for name, m in (("d2c2", dict(data=2, seq=2)), ("t2c2", dict(model=2, seq=2)),
                                ("d2t2c2", dict(data=2, model=2, seq=2)))}
    one = _jax_serve(jh, jhyb, hprompts, 20, **hkw)
    jtrain = _jax_train(js, jtrain_p, batches, "sgd", j_make_mesh(data=2, seq=2))
    res = _join(tmp_path, 4, started)
    assert _tokens(res, "lora-t2c2") == want_lora
    assert all(r["lora-t2c2"]["positions"] == SEQ // 2 for r in res)
    assert want_hyb["d2c2"] == want_hyb["t2c2"] == want_hyb["d2t2c2"] == one
    for name in ("d2c2", "t2c2"):
        assert _tokens(res, f"hybrid-{name}") == want_hyb[name], name
        assert all(r[f"hybrid-{name}"]["slots"] == (0, 4) for r in res)  # every slot
        assert all(r[f"hybrid-{name}"]["positions"] == 32 for r in res)
    assert res[0]["hybrid-d2c2"]["ffn_axis"] == str(("model", "data"))
    for r in res:
        np.testing.assert_allclose(r["train-d2c2"]["losses"], jtrain["losses"], atol=1e-5,
                                   rtol=1e-5)
        _close(r["train-d2c2"]["full"], jtrain["params"], 1e-4)
    # the seq ranks of one data rank: the same parameters, bit for bit
    for pair in ((0, 1), (2, 3)):
        _equal_on_ranks([res[i] for i in pair], "train-d2c2", "full")


def test_ffmodel_with_a_seq_mesh_trains_as_without():
    """``FFModel(mesh=)`` keeps a seq mesh unread, as JAX does: the same
    builder calls train to the same losses with and without it (bitwise),
    and ``compile(auto_parallel=True)`` counts the world's ranks, not the
    mesh's axes: in one process it plans for one device and trains as
    without the search."""
    import pytest

    from flexflow_tpu_torch.ffmodel import FFModel, SGDOptimizer
    from flexflow_tpu_torch.parallel.mesh import Mesh

    rng = np.random.RandomState(5)
    x = rng.randn(32, 16).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.int32)

    def build(ff, **kw):
        t = ff.dense(ff.create_tensor((8, 16)), 32, activation="relu")
        ff.dense(t, 4)
        ff.compile(optimizer=SGDOptimizer(lr=0.1), **kw)
        return ff

    mesh = Mesh.fake(1, 1, 1, seq=2)
    got = []
    for kw in (dict(device="cpu"), dict(mesh=mesh)):
        ff = build(FFModel(seed=0, **kw))
        got.append([h["loss"] for h in ff.fit(x, y, batch_size=8, epochs=2)])
        assert ff.device == torch.device("cpu")
    assert ff._mesh is mesh and got[0] == got[1]
    auto = build(FFModel(seed=0, mesh=mesh), auto_parallel=True)
    assert not auto._pending_auto and auto._cut is None
    assert [h["loss"] for h in auto.fit(x, y, batch_size=8, epochs=2)] == got[0]
