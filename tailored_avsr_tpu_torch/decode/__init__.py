"""Decoding (counterparts of ``tailored_avsr_tpu/decode/``)."""
