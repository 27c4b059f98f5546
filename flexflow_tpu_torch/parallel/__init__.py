"""The serving mesh and its sharding rules (``mesh``, ``sharding``: tensor and
data parallelism over ``torch.distributed`` ranks) and the search over
placements on one device (port of ``flexflow_tpu/parallel``'s ``mesh``,
``sharding``, ``auto``, ``joint``, ``topology`` and
``pipeline.balance_stages``). A training mesh, pipeline stages and the
multi-process controller are ROADMAP A8b–A10."""
