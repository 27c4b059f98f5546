"""Keras loss classes (port of ``flexflow_tpu/keras/losses.py``)."""


class Loss:
    type: str = ""


class CategoricalCrossentropy(Loss):
    type = "categorical_crossentropy"


class SparseCategoricalCrossentropy(Loss):
    type = "sparse_categorical_crossentropy"


class MeanSquaredError(Loss):
    type = "mean_squared_error"


class Identity(Loss):
    type = "identity"
