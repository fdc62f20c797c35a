"""BiEAR in PyTorch and CUDA, for one NVIDIA H100.

The port of ``biear_tpu`` (JAX on a TPU), which stays beside it as the
reference. It imports torch, numpy and scipy, and nothing of JAX or of
``biear_tpu``. Layout mirrors the JAX package: ``ops/``, ``models/``,
``serve/``, ``train/``, plus ``kernels/`` for the hand-written CUDA
kernels. This slice serves the flagship active model:
``serve.infer.predict``.
"""
