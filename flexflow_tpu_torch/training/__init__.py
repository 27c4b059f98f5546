"""Training on one device or over a ``data x model`` mesh (port of
``flexflow_tpu/training``): losses, metrics, the SGD and Adam optimizers,
the data loader and the Trainer."""

from flexflow_tpu_torch.training.losses import LOSSES  # noqa: F401
from flexflow_tpu_torch.training.metrics import PerfMetrics  # noqa: F401
from flexflow_tpu_torch.training.optimizers import AdamOptimizer, SGDOptimizer  # noqa: F401
from flexflow_tpu_torch.training.trainer import Trainer  # noqa: F401
