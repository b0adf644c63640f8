"""Small helpers of the port (copies of ``tfmesos_tpu/utils`` modules
that import no JAX)."""
