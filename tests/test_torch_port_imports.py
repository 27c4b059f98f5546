"""The PyTorch port imports neither JAX nor the JAX package, nor the
repository's root ``inference`` package (the JAX side's scripts); its own
``flexflow_tpu_torch.inference`` is allowed."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "flexflow_tpu_torch",
    "flexflow_tpu_torch.serve",
    "flexflow_tpu_torch.inference.incr_decoding",
    "flexflow_tpu_torch.models.decoder",
    "flexflow_tpu_torch.models.params",
    "flexflow_tpu_torch.serving.engine",
    "flexflow_tpu_torch.serving.request_manager",
    "flexflow_tpu_torch.serving.speculative",
    "flexflow_tpu_torch.serving.spec_sampling",
    "flexflow_tpu_torch.serving.spec_manager",
    "flexflow_tpu_torch.serving.tree_merge",
    "flexflow_tpu_torch.inference.spec_infer",
    "flexflow_tpu_torch.utils.hf_weights",
    "flexflow_tpu_torch.utils.spec_pair",
    "flexflow_tpu_torch.ops.kernels._build",
    "flexflow_tpu_torch.ops.kernels.quant_matmul",
    "flexflow_tpu_torch.ops.kernels.decode_attention",
    "flexflow_tpu_torch.ops.kernels.flash_prefill",
    "flexflow_tpu_torch.ops.kernels.qmm_variants",
    "flexflow_tpu_torch.benchmarks.tune_quant_kernel",
    "flexflow_tpu_torch.benchmarks.tune_int4_variants",
    "flexflow_tpu_torch.utils.profiling",
    "flexflow_tpu_torch.inference.chat",
    "flexflow_tpu_torch.inference.entrypoint.http_server",
    "flexflow_tpu_torch.inference.entrypoint.openai_server",
    "flexflow_tpu_torch.inference.entrypoint.fastapi_incr",
    "flexflow_tpu_torch.inference.entrypoint.fastapi_specinfer",
    "flexflow_tpu_torch.inference.usecases.langchain_support",
    "flexflow_tpu_torch.inference.usecases.prompt_template_incr",
    "flexflow_tpu_torch.inference.usecases.prompt_template_specinfer",
    "flexflow_tpu_torch.inference.usecases.rag_incr",
    "flexflow_tpu_torch.inference.usecases.rag_specinfer",
    "flexflow_tpu_torch.inference.usecases.gradio_chat",
    "flexflow_tpu_torch.inference.usecases.gradio_incr",
    "flexflow_tpu_torch.inference.usecases.gradio_specinfer",
    "flexflow_tpu_torch.inference.streamlit.app",
    "flexflow_tpu_torch.inference.peft",
    "flexflow_tpu_torch.training",
    "flexflow_tpu_torch.training.losses",
    "flexflow_tpu_torch.training.metrics",
    "flexflow_tpu_torch.training.optimizers",
    "flexflow_tpu_torch.training.dataloader",
    "flexflow_tpu_torch.training.trainer",
    "flexflow_tpu_torch.peft.finetune",
    "flexflow_tpu_torch.utils.checkpoint",
    "flexflow_tpu_torch.models.layer_store",
    "flexflow_tpu_torch.utils.debug_dump",
    "flexflow_tpu_torch.utils.alignment",
    "flexflow_tpu_torch.utils.recompile",
    "flexflow_tpu_torch.utils.native_build",
    "flexflow_tpu_torch.utils.native_scheduler",
    "flexflow_tpu_torch.utils.native_safetensors",
    "flexflow_tpu_torch.utils.native_tokenizer",
]
# "import jax", "from jax.x import", "import flexflow_tpu", "from flexflow_tpu.x
# import", "from inference.x import" — but not the port's own flexflow_tpu_torch
# (nor its flexflow_tpu_torch.inference)
_FORBIDDEN_ROOTS = ("jax", "jaxlib", "flexflow_tpu", "inference")
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:" + "|".join(_FORBIDDEN_ROOTS) + r")(?![\w])", re.MULTILINE)


def test_import_loads_no_jax_module():
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in PORT_MODULES)
        + f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN_ROOTS!r})\n"
        "print(repr(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "flexflow_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_source_has_no_jax_import(path):
    src = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(src), f"{path} imports JAX or the JAX package"


def test_forbidden_pattern_catches_and_spares():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from flexflow_tpu.ops import attention")
    assert _FORBIDDEN.search("    import flexflow_tpu")
    assert not _FORBIDDEN.search("from flexflow_tpu_torch.ops import attention")
    assert not _FORBIDDEN.search("import flexflow_tpu_torch")
    assert _FORBIDDEN.search("from inference.usecases.langchain_support import SimpleChain")
    assert _FORBIDDEN.search("    import inference.entrypoint.openai_server")
    assert _FORBIDDEN.search("from inference import chat")
    assert not _FORBIDDEN.search(
        "from flexflow_tpu_torch.inference.usecases.rag_incr import build_rag")
    assert not _FORBIDDEN.search("import flexflow_tpu_torch.inference.chat")
    assert not _FORBIDDEN.search("    from inference_tools import x")


def test_entry_points_refuse_missing_gpu():
    import torch

    from flexflow_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
