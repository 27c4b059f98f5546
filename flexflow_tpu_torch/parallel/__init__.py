"""The mesh and its sharding rules (``mesh``, ``sharding``: tensor and data
parallelism over ``torch.distributed`` ranks, for serving and training,
with collectives autograd understands; ``hybrid_ffn`` and expert
parallelism for serving) and the search over placements on one device
(port of ``flexflow_tpu/parallel``'s ``mesh``, ``sharding``, ``auto``,
``joint``, ``topology`` and ``pipeline.balance_stages``). Pipeline stages,
the multi-process controller and the search on a mesh are ROADMAP
A9–A11c."""
