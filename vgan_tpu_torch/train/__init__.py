"""Training: Adadelta and the no-kl train steps."""
