"""Training: the optimizer and its step, checkpoints and the loop."""
