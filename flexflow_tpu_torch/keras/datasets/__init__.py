from flexflow_tpu_torch.keras.datasets import cifar10, mnist  # noqa: F401
