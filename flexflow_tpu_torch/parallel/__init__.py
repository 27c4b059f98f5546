"""The search over placements on one device (port of ``flexflow_tpu/parallel``'s
``auto``, ``joint``, ``topology`` and ``pipeline.balance_stages``). The mesh,
sharding, pipeline and multi-process modules are ROADMAP A8–A10."""
