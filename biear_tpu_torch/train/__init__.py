"""Training of the port: losses, the optimizer, the train step and chunk
(captured as CUDA graphs on the card, ``graph.py``), the runner and its checkpoints, the training profile, and checkpoint
evaluation."""
