"""Config -> model factories (counterparts of ``tailored_avsr_tpu/tasks/``)."""
