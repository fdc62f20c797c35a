"""Entry point of the Q-trajectory plots, as ``visualize_q.py`` is for the
JAX package: ``visualize_Q_LR(model, batches, save_dir)`` lives in
``biear_tpu_torch.utils.qvis``; the training runner calls it for active
runs."""

from .utils.qvis import visualize_Q_LR  # noqa: F401
