"""Data path: tokenizers, host transforms, the split CSV dataset and the bucketed loader (counterpart of ``tailored_avsr_tpu/data/``)."""
