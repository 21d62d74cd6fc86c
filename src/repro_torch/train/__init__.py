"""Step factories of the port. So far the serving steps (prefill and
one-token decode); the training step comes with the optimizer."""
