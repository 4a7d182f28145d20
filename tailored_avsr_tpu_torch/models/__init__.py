"""Model tree of the port (counterparts of ``tailored_avsr_tpu/models/``)."""
