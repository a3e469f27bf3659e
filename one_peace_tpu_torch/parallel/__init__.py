"""Data parallelism and FSDP across processes (counterpart of
``one_peace_tpu/parallel``): the mesh (``mesh.py``), the sharding rules and
their FSDP2 placement (``sharding.py``), and the per-rank batch helpers the
trainer and the criterions use (``data.py``)."""
