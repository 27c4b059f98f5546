"""The mesh and its sharding rules (``mesh``, ``sharding``: tensor and data
parallelism over ``torch.distributed`` ranks, for serving and training,
with collectives autograd understands; ``hybrid_ffn`` and expert
parallelism for serving; pipeline stages for serving, speculation included,
and for training, with the stage hops of ``mesh`` and the stage cut and
GPipe loop of ``pipeline``; context parallelism, the incremental and
speculative engines' KV cache cut on the ``seq`` axis, with the ring hops
of ``mesh`` for ``ops/ring_attention``, and every other surface, the
pipeline stages included, replicated over ``seq``), the search over
placements (``joint``, ``topology``) and over layouts of the ranks of a
``torch.distributed`` world (``auto``: every rank builds and times each
candidate alike and keeps the same choice; port of ``flexflow_tpu/
parallel``'s ``mesh``, ``sharding``, ``auto``, ``joint``, ``topology`` and
``pipeline``), and the multi-process controller (``distributed``:
``init_distributed`` and the request broadcaster that feeds a mesh's
followers the controller's requests)."""
