"""Training: the loss graph's optimizer, steps and checkpoints (counterpart of ``tailored_avsr_tpu/train/``)."""
