"""Training and evaluation: the step, AdamW, checkpoints, the test metrics
and the experiment."""
