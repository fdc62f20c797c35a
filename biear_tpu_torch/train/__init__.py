"""Training of the port: losses, the optimizer, the train step and chunk,
and the training profile."""
