"""Training: the optimizer, the train step and its metrics."""
