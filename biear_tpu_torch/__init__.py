"""BiEAR in PyTorch and CUDA, for one NVIDIA H100.

The port of ``biear_tpu`` (JAX on a TPU), which stays beside it as the
reference. It imports torch, numpy, scipy and PyYAML, and nothing of JAX
or of ``biear_tpu``. Layout mirrors the JAX package: ``ops/``,
``models/``, ``data/``, ``serve/``, ``train/``, ``utils/``,
``parallel/`` (training over several GPUs, one process each), plus
``kernels/`` for the hand-written CUDA kernels. The active models (dual or
single Q-controller, or fixed Q) run on five paths: serving
(``serve.infer.predict``), streaming one hop at a time
(``serve.streaming``), the fused synthesize -> train step
(``data.synth.AnechoicSynthesizer`` and ``train.loop.make_train_chunk``),
training runs (``train_biear`` and ``train.runner.train``) and checkpoint
evaluation (``train.evaluate``).
"""
