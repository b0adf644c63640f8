"""Parallelism over several ranks (port of ``tfmesos_tpu/parallel``):
the dp/fsdp x tp mesh, its collectives and the sharding rules."""
