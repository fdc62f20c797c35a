"""Training of the port: losses, the optimizer, the train step and chunk,
the training profile, and checkpoint evaluation."""
