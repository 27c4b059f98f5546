"""The layer-graph DSL on one device (port of ``flexflow_tpu/ffmodel``)."""

from flexflow_tpu_torch.ffmodel.model import FFModel, Tensor  # noqa: F401
from flexflow_tpu_torch.training.optimizers import AdamOptimizer, SGDOptimizer  # noqa: F401
