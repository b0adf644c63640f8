"""Parallelism over several ranks (port of ``tfmesos_tpu/parallel``): the
dp/fsdp x pp x ep x sp x tp mesh, its collectives and the sharding
rules, pipeline parallelism (``pipeline``), expert parallelism
(``moe``), and sequence parallelism (``ring_attention``, ``ulysses``)."""
