"""Keras-compatible frontend (port of ``flexflow_tpu/keras``): a
Sequential / functional API that lowers onto the FFModel DSL and trains on
its device.
"""

from flexflow_tpu_torch.keras.layers import (  # noqa: F401
    Activation,
    Add,
    AveragePooling2D,
    BatchNormalization,
    Concatenate,
    Conv2D,
    Conv2DTranspose,
    Dense,
    Dropout,
    Embedding,
    Flatten,
    GroupNormalization,
    Input,
    LayerNormalization,
    Maximum,
    MaxPooling2D,
    Minimum,
    Multiply,
    Permute,
    Reshape,
    Subtract,
)
from flexflow_tpu_torch.keras.models import Model, Sequential  # noqa: F401
from flexflow_tpu_torch.keras.optimizers import SGD, Adam  # noqa: F401
from flexflow_tpu_torch.keras import callbacks  # noqa: F401
from flexflow_tpu_torch.keras import datasets  # noqa: F401
from flexflow_tpu_torch.keras import initializers  # noqa: F401
from flexflow_tpu_torch.keras import losses  # noqa: F401
from flexflow_tpu_torch.keras import metrics  # noqa: F401
from flexflow_tpu_torch.keras import preprocessing  # noqa: F401
from flexflow_tpu_torch.keras import regularizers  # noqa: F401
