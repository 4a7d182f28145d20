"""WER / CER evaluation (counterpart of ``tailored_avsr_tpu/evaluation/``)."""
