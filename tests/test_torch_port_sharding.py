"""Each rank's cut of a parameter tree (``flexflow_tpu_torch.parallel.sharding``)
against the shard JAX places at that rank's mesh coordinate
(``flexflow_tpu.parallel.sharding.shard_params`` on the 8-device CPU mesh),
with no process group (``Mesh.fake``):

- plain leaves (f32, bf16, Mixtral, MQA, ``H % T != 0``, tied embeddings)
  and INT8 ``q`` equal JAX's shard;
- every quantized rank carrier (INT8 and INT4, halved groups included)
  dequantizes bit for bit to its cut of the one-device weight, and INT4's
  row-parallel ``q`` equals JAX's shard byte for byte (the two-block
  planar layout);
- the initialisers and loaders cut as they go: ``init_params``, ``init_quantized_params``,
  ``params_from_numpy`` and the HF loader under a mesh equal
  ``shard_params`` of their one-device trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.parallel import make_mesh as j_make_mesh
from flexflow_tpu.parallel.sharding import shard_params as j_shard_params
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.parallel.mesh import Mesh
from flexflow_tpu_torch.parallel.sharding import (_LAYER_AXES, _TOP_AXES, _blocks_of, _take,
                                                  rank_shard, shard_leaf, shard_params,
                                                  slot_block, tree_shard)
from flexflow_tpu_torch.quant.weight_only import QuantizedArray, dequantize, quantize

torch.set_num_threads(2)

BASE = dict(arch="LlamaForCausalLM", vocab_size=256, hidden_size=64, num_layers=2,
            num_heads=8, num_kv_heads=8, head_dim=8, intermediate_size=128,
            max_position_embeddings=256, norm_eps=1e-6)
TREES = {
    "f32": (BASE, None, jnp.float32),
    "bf16": (BASE, None, jnp.bfloat16),
    "int8": (BASE, 8, jnp.float32),
    "int4": (BASE, 4, jnp.float32),
    "gqa-int4": (dict(BASE, num_kv_heads=4), 4, jnp.float32),
    "mixtral-int8": (dict(BASE, arch="MixtralForCausalLM", num_kv_heads=4,
                          moe=jspecs.MoESpec(num_experts=4, top_k=2)), 8, jnp.float32),
    "mixtral": (dict(BASE, arch="MixtralForCausalLM", num_kv_heads=4,
                     moe=jspecs.MoESpec(num_experts=4, top_k=2)), None, jnp.float32),
    "mqa": (dict(BASE, num_kv_heads=1), None, jnp.float32),
    "heads-indivisible": (dict(BASE, hidden_size=40, num_heads=5, num_kv_heads=1), None,
                          jnp.float32),
    "tied": (dict(BASE, tie_word_embeddings=True), None, jnp.float32),
}
MESHES = [(2, 4), (1, 2)]  # (data, model)


def _tspec(kw):
    kw = dict(kw)
    if "moe" in kw:
        kw["moe"] = tspecs.MoESpec(num_experts=kw["moe"].num_experts, top_k=kw["moe"].top_k)
    return tspecs.ModelSpec(**kw)


def _trees(name):
    kw, bits, dtype = TREES[name]
    js = jspecs.ModelSpec(**kw)
    jparams = jp.init_params(js, jax.random.PRNGKey(3), dtype)
    if bits:
        jparams = j_quant_params(js, jparams, bits=bits, group_size=16,
                                 compute_dtype=jnp.float32)
    tparams = tp.params_from_numpy(jparams if bits else jax.tree.map(np.asarray, jparams))
    return js, jparams, _tspec(kw), tparams


def _shard_at(arr, device) -> np.ndarray:
    for s in arr.addressable_shards:
        if s.device == device:
            return np.asarray(s.data.astype(jnp.float32) if s.data.dtype == jnp.bfloat16
                              else s.data)
    raise AssertionError(f"no shard on {device}")


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _check_leaf(name, mine, full, placed, shard, device, top):
    """``mine``: the port's rank cut; ``full``: the port's one-device leaf;
    ``placed``: JAX's leaf placed on the mesh."""
    rule = (_TOP_AXES if top else _LAYER_AXES).get(name)
    blocks = None if rule is None else _blocks_of(shard, rule[1])
    if not isinstance(mine, QuantizedArray):
        assert np.array_equal(_np(mine), _shard_at(placed, device)), name
        return
    # the dequantized rule: bit for bit the cut of the one-device weight
    want = dequantize(full)
    if blocks is not None:
        want = _take(want, want.dim() + rule[0], blocks)
    assert torch.equal(dequantize(mine), want), name
    rows = rule is not None and rule[1] in ("heads", "ffn") and name in ("wo", "wd")
    if mine.bits == 8 or rows:
        # INT8 q, and INT4's row-parallel q (two half-plane blocks), byte
        # for byte JAX's shard
        assert np.array_equal(mine.q.numpy(), _shard_at(placed.q, device)), name


@pytest.mark.parametrize("data,model", MESHES, ids=["d2m4", "m2"])
@pytest.mark.parametrize("tree", list(TREES))
def test_rank_cut_equals_jax_placement(tree, data, model):
    js, jparams, ts, tparams = _trees(tree)
    jmesh = j_make_mesh(data=data, model=model)
    placed = j_shard_params(js, jparams, jmesh)
    devices = list(jmesh.devices.reshape(-1))
    for rank in range(data * model):
        mesh = Mesh.fake(data, model, rank)
        mine = shard_params(ts, tparams, mesh)
        shard = tree_shard(ts, tparams, mesh)
        assert shard.mesh.model_rank == rank % model
        assert "_shard" not in mine  # the tree carries no mark of its cut
        _assert_trees_equal(shard_params(ts, mine, mesh), mine)  # idempotent
        for name, leaf in tparams["layers"].items():
            _check_leaf(name, mine["layers"][name], leaf, placed["layers"][name], shard,
                        devices[rank], top=False)
        for name, leaf in tparams.items():
            if name != "layers":
                _check_leaf(name, mine[name], leaf, placed[name], shard, devices[rank],
                            top=True)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("model", [2, 4])
def test_llama7b_wd_width_rank_carriers(model, bits):
    """LLaMA-2-7B's down projection width (11008 rows, group 128) cut over
    2 and 4 ranks: 2752 (INT8 at 4 ranks) or 2 x 2752 / 2 x 1376 (INT4 half
    planes) rows a rank fall inside groups, so those rank carriers take a
    smaller group size; each dequantizes bit for bit to its rows of the
    whole."""
    group = {(2, 8): 128, (4, 8): 64, (2, 4): 64, (4, 4): 32}[(model, bits)]
    spec = tspecs.ModelSpec(**dict(BASE, intermediate_size=11008))
    w = torch.randn((1, 11008, 64), generator=torch.Generator().manual_seed(0))
    qa = quantize(w, bits, 128, batch_dims=1, compute_dtype=torch.float32)
    full = dequantize(qa)
    rows = []
    for r in range(model):
        shard = rank_shard(spec, Mesh.fake(1, model, r), int4_wd=bits == 4)
        mine = shard_leaf("wd", qa, shard)
        assert mine.shape == (1, 11008 // model, 64)
        assert mine.group_size == group
        assert torch.equal(dequantize(mine), _take(full, 1, shard.ffn))
        rows.append(mine.q)
    if bits == 4:  # the packed rows of each rank, in rank order, are the whole q
        assert torch.equal(torch.cat(rows, 1), qa.q)


def test_kv_heads_of_each_rank():
    """GQA whose KV heads do not divide the ranks: K/V projected whole, the
    cache keeps the KV heads the rank's Q heads read (one each when they
    group evenly, else one per Q head); MQA keeps its one head; H % T != 0
    replicates attention."""
    def cut(h, kh, t, r):
        return rank_shard(tspecs.ModelSpec(**dict(BASE, num_heads=h, num_kv_heads=kh)),
                          Mesh.fake(1, t, r))

    s = cut(8, 2, 4, 3)
    assert (s.heads, s.kv_heads, s.kv_take) == (((6, 8),), None, (1,))
    s = cut(12, 3, 2, 0)
    assert s.kv_heads is None and s.kv_take == (0, 0, 0, 0, 1, 1)
    s = cut(8, 4, 2, 1)
    assert (s.heads, s.kv_heads, s.kv_take) == (((4, 8),), ((2, 4),), None)
    s = cut(8, 1, 4, 2)
    assert s.kv_heads is None and s.kv_take is None and s.num_kv_cache(
        tspecs.ModelSpec(**dict(BASE, num_kv_heads=1))) == 1
    assert cut(5, 1, 2, 0).heads is None


def test_slot_blocks():
    """Data rank d owns slots [d B/D, (d+1) B/D); a slot count the data axis
    does not divide stays whole on every rank (JAX's ``_divisible``)."""
    assert [slot_block(8, Mesh.fake(2, 2, r)) for r in range(4)] == [
        (0, 4), (0, 4), (4, 8), (4, 8)]
    assert [slot_block(5, Mesh.fake(2, 1, r)) for r in range(2)] == [(0, 5), (0, 5)]
    assert slot_block(8, None) == (0, 8)


@pytest.mark.parametrize("bits", [None, 8, 4], ids=["f32", "int8", "int4"])
def test_random_inits_cut_as_they_draw(bits):
    """The random initialisers under a mesh give each rank ``shard_params`` of
    the one-device tree from the same seed, bit for bit."""
    ts = _tspec(BASE)
    for rank in range(4):
        mesh = Mesh.fake(2, 2, rank)
        if bits is None:
            whole, mine = tp.init_params(ts, 5), tp.init_params(ts, 5, mesh=mesh)
        else:
            kw = dict(bits=bits, group_size=16, dtype=torch.float32)
            whole = tp.init_quantized_params(ts, 5, **kw)
            mine = tp.init_quantized_params(ts, 5, mesh=mesh, **kw)
        want = shard_params(ts, whole, mesh)
        _assert_trees_equal(mine, want)


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        elif isinstance(a[k], QuantizedArray):
            assert (a[k].shape, a[k].group_size, a[k].rest_pad) == (
                b[k].shape, b[k].group_size, b[k].rest_pad), k
            for f in ("q", "scale", "offset"):
                x, y = getattr(a[k], f), getattr(b[k], f)
                assert (x is None and y is None) or torch.equal(x, y), (k, f)
        else:
            assert torch.equal(a[k], b[k]), k


def test_params_from_numpy_and_hf_loader_cut(tmp_path):
    """``params_from_numpy(mesh=)`` (JAX's parameters) and
    ``hf_weights.load_params(mesh=)`` (an HF directory, INT8 on load) give
    each rank its cut of the one-device tree."""
    import transformers

    from flexflow_tpu_torch.utils import hf_weights

    js, jparams, ts, tparams = _trees("int4")
    for rank in range(2):
        mesh = Mesh.fake(1, 2, rank)
        _assert_trees_equal(tp.params_from_numpy(jparams, spec=ts, mesh=mesh),
                            shard_params(ts, tparams, mesh))
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=128)
    cfg.architectures = ["LlamaForCausalLM"]
    transformers.LlamaForCausalLM(cfg).save_pretrained(tmp_path, safe_serialization=True)
    spec, whole = hf_weights.load_params(str(tmp_path), dtype=torch.float32, quantize_bits=8,
                                         quantize_group_size=16)
    for rank in range(2):
        mesh = Mesh.fake(1, 2, rank)
        _, mine = hf_weights.load_params(str(tmp_path), dtype=torch.float32, quantize_bits=8,
                                         quantize_group_size=16, mesh=mesh)
        _assert_trees_equal(mine, shard_params(spec, whole, mesh))
