"""Training of the port: losses, the optimizer, the train step and chunk,
the runner and its checkpoints, the training profile, and checkpoint
evaluation."""
