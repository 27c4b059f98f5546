"""Checkpoints cross between the packages on the CPU: parameter trees, a
quantized tree, an Adam train state (a resumed Trainer gives the other
package's next loss, rtol 1e-5), LoRA adapter exports, and bfloat16 leaves
(JAX's ``|V2`` arrays read as bfloat16 bits; the port writes the same bytes).
One file written by each package is loaded by the other."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flexflow_tpu import specs as jspecs
from flexflow_tpu.models import params as jp
from flexflow_tpu.quant import quantize_params as j_quant_params
from flexflow_tpu.training import AdamOptimizer as JAdam
from flexflow_tpu.training import Trainer as JTrainer
from flexflow_tpu.utils import checkpoint as jck
from flexflow_tpu_torch import specs as tspecs
from flexflow_tpu_torch.models import params as tp
from flexflow_tpu_torch.quant.weight_only import QuantizedArray
from flexflow_tpu_torch.training import AdamOptimizer, Trainer
from flexflow_tpu_torch.training.optimizers import AdamState, SGDState
from flexflow_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

KW = dict(arch="LlamaForCausalLM", vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
          num_kv_heads=2, head_dim=16, intermediate_size=64, max_position_embeddings=64,
          norm_eps=1e-6)


@pytest.fixture(scope="module")
def model():
    js, ts = jspecs.ModelSpec(**KW), tspecs.ModelSpec(**KW)
    jparams = jp.init_params(js, jax.random.PRNGKey(0), jnp.float32)
    return js, jparams, ts


def _batches(n=3):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        toks = rng.randint(0, KW["vocab_size"], size=(4, 12)).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -100
        out.append((toks, labels))
    return out


def _assert_tree_equal(j, t, path=""):
    """A JAX tree (numpy leaves) and a port tree hold the same values."""
    if isinstance(j, dict):
        assert isinstance(t, dict) and sorted(j) == sorted(t), path
        for k in j:
            _assert_tree_equal(j[k], t[k], f"{path}/{k}")
    elif hasattr(j, "_fields"):
        assert type(t).__name__ == type(j).__name__ and t._fields == j._fields, path
        for f in j._fields:
            _assert_tree_equal(getattr(j, f), getattr(t, f), f"{path}/{f}")
    elif isinstance(j, (list, tuple)):
        assert type(t) is type(j) and len(t) == len(j), path
        for i, (a, b) in enumerate(zip(j, t)):
            _assert_tree_equal(a, b, f"{path}/{i}")
    elif j is None:
        assert t is None, path
    elif hasattr(j, "tree_flatten"):  # a JAX QuantizedArray
        assert isinstance(t, QuantizedArray), path
        for f in ("bits", "group_size", "batch_dims", "contract_dims", "rest_pad"):
            assert getattr(t, f) == getattr(j, f), f"{path}.{f}"
        assert tuple(t.shape) == tuple(j.shape), path
        for f in ("q", "scale", "offset"):
            _assert_tree_equal(getattr(j, f), getattr(t, f), f"{path}.{f}")
    else:
        assert np.array_equal(np.asarray(j), t.numpy()), path


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_params_round_trip(model, tmp_path, direction):
    _, jparams, _ = model
    path = str(tmp_path / "params.npz")
    tree = {"params": jparams, "extra": (jnp.arange(3), None, [jnp.ones(2)])}
    if direction == "jax_to_port":
        jck.save_checkpoint(path, tree)
        _assert_tree_equal(jax.tree.map(np.asarray, tree), tck.load_checkpoint(path))
    else:
        ttree = {"params": tp.params_from_numpy(jax.tree.map(np.asarray, jparams)),
                 "extra": (torch.arange(3, dtype=torch.int32), None, [torch.ones(2)])}
        tck.save_checkpoint(path, ttree)
        _assert_tree_equal(jax.tree.map(np.asarray, jck.load_checkpoint(path)), ttree)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_round_trips(model, tmp_path, bits):
    """JAX's quantized tree -> the port (carriers byte for byte, aux equal,
    compute dtype float32) -> written again -> JAX reads JAX's tree back."""
    js, jparams, _ = model
    jq = j_quant_params(js, jparams, bits=bits, group_size=16, compute_dtype=jnp.float32)
    jck.save_checkpoint(str(tmp_path / "j.npz"), jq)
    tq = tck.load_checkpoint(str(tmp_path / "j.npz"))
    assert tq["layers"]["wq"].dtype == torch.float32
    _assert_tree_equal(jq, tq)
    tck.save_checkpoint(str(tmp_path / "t.npz"), tq)
    back = jck.load_checkpoint(str(tmp_path / "t.npz"))
    _assert_tree_equal(back, tq)
    assert back["layers"]["wq"].dtype == np.float32


def test_quantized_rest_pad_is_read_off_the_carrier(tmp_path):
    """The format has no rest_pad (JAX's aux list stops before it): the port
    reads it from the carrier's width."""
    from flexflow_tpu_torch.quant.weight_only import quantize

    qa = quantize(torch.randn(1024, 600), 8, 128)
    assert qa.rest_pad == 424
    tck.save_checkpoint(str(tmp_path / "q.npz"), {"w": qa})
    back = tck.load_checkpoint(str(tmp_path / "q.npz"))["w"]
    assert back.rest_pad == 424 and torch.equal(back.q, qa.q) and back.shape == qa.shape


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_adam_train_state_resumes_across_packages(model, tmp_path, direction):
    """Two Adam steps in one package, saved as {params, opt_state}, resumed
    in the other: the third step's loss equals the first package's."""
    js, jparams, ts = model
    b = _batches()
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        src = JTrainer(js, jparams, JAdam(lr=1e-2))
        for x, y in b[:2]:
            src.train_step(x, y)
        jck.save_checkpoint(path, {"params": src.params, "opt_state": src.opt_state})
        state = tck.load_checkpoint(path)
        assert isinstance(state["opt_state"], AdamState)
        dst = Trainer(ts, state["params"], AdamOptimizer(lr=1e-2), device="cpu")
        dst.opt_state = state["opt_state"]
    else:
        src = Trainer(ts, tp.params_from_numpy(jax.tree.map(np.asarray, jparams)),
                      AdamOptimizer(lr=1e-2), device="cpu")
        for x, y in b[:2]:
            src.train_step(x, y)
        tck.save_checkpoint(path, {"params": src.params, "opt_state": src.opt_state})
        state = jck.load_checkpoint(path)
        assert type(state["opt_state"]).__name__ == "AdamState"
        dst = JTrainer(js, state["params"], JAdam(lr=1e-2))
        dst.opt_state = state["opt_state"]
    assert int(dst.opt_state.step) == 2
    np.testing.assert_allclose(dst.train_step(*b[2]), src.train_step(*b[2]), rtol=1e-5)


def test_sgd_state_and_registry(tmp_path):
    st = SGDState(velocity={"w": torch.arange(4.0)})
    tck.save_checkpoint(str(tmp_path / "s.npz"), {"s": st, "n": None})
    back = tck.load_checkpoint(str(tmp_path / "s.npz"))
    assert isinstance(back["s"], SGDState) and back["n"] is None
    assert torch.equal(back["s"].velocity["w"], st.velocity["w"])
    assert type(jck.load_checkpoint(str(tmp_path / "s.npz"))["s"]).__name__ == "SGDState"


def test_save_lora_adapter_matches_jax(tmp_path):
    r = np.random.default_rng(0)
    stacks = {m: {"a": r.standard_normal((2, 3, 32, 4)).astype(np.float32),
                  "b": r.standard_normal((2, 3, 4, 48)).astype(np.float32)} for m in ("wq", "wv")}
    jck.save_lora_adapter(str(tmp_path / "j.npz"), jax.tree.map(jnp.asarray, stacks), 1)
    tck.save_lora_adapter(str(tmp_path / "t.npz"), tp.lora_from_numpy(stacks), 1)
    for path in ("j.npz", "t.npz"):
        jt = jax.tree.map(np.asarray, jck.load_checkpoint(str(tmp_path / path)))
        tt = tck.load_checkpoint(str(tmp_path / path))
        for m in stacks:
            for k in ("a", "b"):
                assert np.array_equal(jt[m][k], stacks[m][k][:, 1])
                assert np.array_equal(tt[m][k].numpy(), stacks[m][k][:, 1])


def test_bf16_leaves_cross_as_raw_bits(tmp_path):
    """JAX writes a bf16 leaf as ``|V2``; the port reads those bits as
    bfloat16 and writes its own bf16 tensors as the same bytes. (JAX's loader
    refuses ``|V2``, its own files included.)"""
    vals = np.array([1.5, -2.25, 3.0e-3, 65504.0, -0.0], np.float32)
    jck.save_checkpoint(str(tmp_path / "j.npz"), {"w": jnp.asarray(vals, jnp.bfloat16)})
    got = tck.load_checkpoint(str(tmp_path / "j.npz"))["w"]
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                       want.view(torch.int16))
    tck.save_checkpoint(str(tmp_path / "t.npz"), {"w": want})
    raw_t, raw_j = np.load(tmp_path / "t.npz")["w"], np.load(tmp_path / "j.npz")["w"]
    assert raw_t.dtype == raw_j.dtype == np.dtype("V2")
    assert raw_t.tobytes() == raw_j.tobytes()
    assert np.array_equal(raw_t.view(ml_dtypes.bfloat16).astype(np.float32),
                          vals.astype(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(TypeError, match="V2"):
        jck.load_checkpoint(str(tmp_path / "t.npz"))
