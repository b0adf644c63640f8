"""Parallelism over several ranks: the data mesh (port of
``tfmesos_tpu/parallel``)."""
