"""Compute primitives of the port (counterparts of ``tailored_avsr_tpu/ops/``)."""
