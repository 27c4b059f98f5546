from flexflow_tpu_torch.keras.preprocessing import sequence, text  # noqa: F401
