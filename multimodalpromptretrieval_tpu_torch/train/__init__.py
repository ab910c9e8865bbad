"""Training: the step, AdamW, checkpoints and the experiment."""
