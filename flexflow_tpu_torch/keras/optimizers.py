"""Keras-style optimizer wrappers (port of ``flexflow_tpu/keras/optimizers.py``)."""

from flexflow_tpu_torch.training.optimizers import AdamOptimizer, SGDOptimizer


def SGD(learning_rate=0.01, momentum=0.0, nesterov=False, weight_decay=0.0):
    return SGDOptimizer(lr=learning_rate, momentum=momentum,
                        nesterov=nesterov, weight_decay=weight_decay)


def Adam(learning_rate=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8):
    return AdamOptimizer(lr=learning_rate, beta1=beta_1, beta2=beta_2,
                         eps=epsilon)
