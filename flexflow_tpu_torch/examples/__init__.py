"""The training examples on the port's graph layer (mirrors of the root
``examples/`` package): ``python -m flexflow_tpu_torch.examples.<name>`` runs one
on the GPU; each ``main`` takes ``device="cpu"`` for the CPU."""
