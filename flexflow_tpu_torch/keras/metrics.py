"""Keras metric classes (port of ``flexflow_tpu/keras/metrics.py``)."""


class Metric:
    type: str = ""


class Accuracy(Metric):
    type = "accuracy"


class CategoricalCrossentropy(Metric):
    type = "categorical_crossentropy"


class SparseCategoricalCrossentropy(Metric):
    type = "sparse_categorical_crossentropy"


class MeanSquaredError(Metric):
    type = "mean_squared_error"


class RootMeanSquaredError(Metric):
    type = "root_mean_squared_error"


class MeanAbsoluteError(Metric):
    type = "mean_absolute_error"
