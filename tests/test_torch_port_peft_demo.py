"""The port's PEFT demo (``flexflow_tpu_torch/inference/peft_demo/demo.py``)
against JAX's (``inference/peft_demo/demo.py``) on one tiny float32 LLaMA
directory written in-process (``safetensors.numpy.save_file``, data not
64-byte aligned, which JAX's loader reads), and the port's HF loader on a
file whose data starts 64-byte aligned (C7).

- The demo: both packages run the demo's flags on the same directory, and
  ``--full-precision`` (JAX's demo takes no flags: the test adds it to the
  PEFT CLI's arguments; at bf16 a random tiny model's near-ties part the
  two packages' greedy tokens within a few steps and say nothing of the
  port), and the fresh adapters' A drawn alike in both (jax.random and
  torch draw other numbers; ``test_torch_port_finetune._same_adapters``):
  the served text (a fresh adapter, B zero: the base model's) is equal,
  the four finetuning losses are within 1e-5, and the adapter the port's
  demo saved serves the same greedy tokens from either package (JAX's own
  export writes each transposed view by its buffer, a fault of the
  reference: ``test_torch_port_finetune``).
- C7: the port's ``load_params`` on the default path, with
  ``host_layers=True`` (its layers fused, as offload pins them) and with
  ``mesh=`` (a rank's cut), after the reader is dropped, gives every leaf
  equal to the arrays written.
"""

import contextlib
import gc
import json
import struct

import numpy as np
import pytest
import torch

from test_torch_port_cp_layouts import HF_TINY, _hf_dir
from test_torch_port_finetune import _same_adapters
from test_torch_port_mesh_serving import _tspec


def _data_start(path) -> int:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
    return 8 + n


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = _hf_dir(tmp_path_factory.mktemp("peft_demo") / "model", HF_TINY)
    assert _data_start(d / "model.safetensors") % 64  # JAX's loader reads it
    return str(d)


def _run_demo(main, argv, workdir, monkeypatch, capsys, finetune_module):
    """``main(*argv)`` with its temporary directory kept at ``workdir`` and
    ``finetune_module``'s sessions recorded; (its stdout, the session's
    losses)."""
    import tempfile

    sessions = []

    class Recorded(finetune_module.FinetuneSession):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            sessions.append(self)

    monkeypatch.setattr(finetune_module, "FinetuneSession", Recorded)
    workdir.mkdir()
    monkeypatch.setattr(tempfile, "TemporaryDirectory",
                        lambda *a, **k: contextlib.nullcontext(str(workdir)))
    capsys.readouterr()
    assert main(*argv) == 0
    [session] = sessions
    return capsys.readouterr().out, list(session.losses)


def _served(out: str) -> str:
    """The demo's served text: the line after the request's header."""
    lines = out.splitlines()
    [i] = [k for k, line in enumerate(lines) if line.startswith("=== guid")]
    return lines[i + 1]


def test_demo_matches_jax(model_dir, tmp_path, monkeypatch, capsys):
    import flexflow_tpu.peft.finetune as jft
    import flexflow_tpu_torch.peft.finetune as tft
    from flexflow_tpu.serve import LLM as JLLM
    from flexflow_tpu_torch.inference.peft_demo import demo as tdemo
    from flexflow_tpu_torch.serve import LLM as TLLM
    from inference.peft_demo import demo as jdemo

    import inference.peft as jpeft

    monkeypatch.setenv("FF_MODEL_DIR", model_dir)
    _same_adapters(monkeypatch, 8)  # the demo's --lora-rank default
    with monkeypatch.context() as m:
        jmain = jpeft.main
        m.setattr(jpeft, "main", lambda argv: jmain(argv + ["--full-precision"]))
        jout, jlosses = _run_demo(jdemo.main, (), tmp_path / "jax", m, capsys, jft)
    with monkeypatch.context() as m:
        tout, tlosses = _run_demo(tdemo.main, (["--device", "cpu", "--full-precision"],),
                                  tmp_path / "port", m, capsys, tft)
    assert _served(tout) == _served(jout) and _served(tout).startswith("The quick brown")
    assert "[Finetune] steps 4 losses" in tout and "[Finetune] adapter saved to" in tout
    assert len(tlosses) == len(jlosses) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    # the adapter the port's demo saved, served by each package
    tokens = []
    for cls, kw in ((JLLM, {}), (TLLM, {"device": "cpu"})):
        llm = cls(model_dir, data_type="float32", **kw)
        slot = llm.register_peft_adapter(str(tmp_path / "port" / "adapter"))
        llm.compile(max_requests_per_batch=2, max_seq_length=64)
        [res] = llm.generate(["The quick brown"], max_new_tokens=16, adapter_id=slot)
        tokens.append(list(res.output_tokens))
    assert tokens[0] == tokens[1] and len(tokens[0]) == 16


def _write_aligned(path, tensors):
    """A safetensors file of f32 ``tensors`` whose header is space-padded
    so the data starts at a multiple of 64 bytes (a valid file)."""
    header, blobs, offset = {"__metadata__": {"format": "pt"}}, [], 0
    for name in sorted(tensors):
        blob = np.ascontiguousarray(tensors[name], dtype="<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-(8 + len(head)) % 64)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif v is not None:
            yield prefix + k, v


def test_loader_on_a_64_byte_aligned_file(tmp_path):
    import safetensors.numpy

    from flexflow_tpu_torch.models import params as tp
    from flexflow_tpu_torch.models.decoder import fuse_qkv_params
    from flexflow_tpu_torch.parallel.mesh import Mesh
    from flexflow_tpu_torch.parallel.sharding import shard_params
    from flexflow_tpu_torch.utils import hf_weights

    d = _hf_dir(tmp_path / "model", HF_TINY)
    st = d / "model.safetensors"
    tensors = safetensors.numpy.load_file(str(st))
    _write_aligned(st, tensors)
    assert _data_start(st) % 64 == 0
    spec = _tspec(HF_TINY)
    want = tp.init_params(spec, 0)  # what the directory holds
    mesh = Mesh.fake(1, 2, 1)
    for kw, expect in ((dict(), want), (dict(host_layers=True), want),
                       (dict(mesh=mesh), shard_params(spec, want, mesh))):
        _, got = hf_weights.load_params(str(d), spec, dtype=torch.float32, **kw)
        gc.collect()  # the reader and its mapping are gone
        if "wqkv" in got["layers"]:  # host layers are fused before they are pinned
            expect = fuse_qkv_params(spec, expect)
        got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(expect))
        assert sorted(got_leaves) == sorted(want_leaves), kw
        for name, w in want_leaves.items():
            assert torch.equal(got_leaves[name].cpu(), w), (kw, name)
        del got
