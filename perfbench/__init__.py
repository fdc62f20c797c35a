"""The benchmark of the PyTorch and CUDA port (``biear_tpu_torch``) on
the card: harness, inputs, reference, bounds and metric readers."""
