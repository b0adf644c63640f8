"""Parallelism over several ranks (port of ``tfmesos_tpu/parallel``
without the pipeline): the dp/fsdp x ep x sp x tp mesh, its collectives
and the sharding rules, expert parallelism (``moe``), and sequence
parallelism (``ring_attention``, ``ulysses``)."""
