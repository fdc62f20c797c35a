"""Device choice and the matmul precision policy of the port.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` and no card they raise rather than carry on quietly on the CPU.

MATMUL_PRECISION (the JAX package's ``apply_matmul_precision`` and
``jax_default_matmul_precision``) names the precision of the products
that JAX leaves at the process default: the GRUs, Linears and attention
products of the models. On the card:

  * "default", "highest", "float32": full f32 (TF32 off for cuBLAS and
    cuDNN), the port's parity surface. "default" differs from a TPU by
    design: there it is one-pass bf16 for those products.
  * "high", "tensorfloat32": TF32 on for cuBLAS and cuDNN ("high" is
    JAX's alias of "tensorfloat32").
  * "bfloat16": bf16 operands with f32 sums, by ``torch.autocast("cuda",
    torch.bfloat16)`` with its cast cache off: a cached bf16 copy of a
    weight lives until the outermost autocast block ends, so across the
    optimizer's in-place updates of a run it would go stale, and inside
    a CUDA graph capture it would outlive the capture.

The products JAX pins to ``Precision.HIGHEST`` (the filterbank, the DFT,
the fixed-Q, AuralNet and passive filterbanks, the plain CC, the mixes,
streaming) run under ``precision_highest``, which no policy moves. Only
CUDA state is touched, so on the CPU every name computes the same bits.
"""

from __future__ import annotations

import contextlib
import functools

import torch

PRECISION_NAMES = ("default", "bfloat16", "tensorfloat32", "high",
                   "highest", "float32")
TF32_NAMES = ("high", "tensorfloat32")

_policy = "default"          # the process-wide name, as JAX's config holds it


def constant_cache(build):
    """``functools.lru_cache`` for a function that makes constant tensors
    (host arrays copied to a device once, not on every call). The tensors are
    made outside inference mode: one made inside it could not be saved
    for a backward, and a cached one outlives the block that made it."""
    @functools.lru_cache(maxsize=None)
    @functools.wraps(build)
    def cached(*args):
        with torch.inference_mode(False):
            return build(*args)
    return cached


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, or RuntimeError without one;
    anything else is passed to ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def check_matmul_precision(name: str) -> str:
    """The lower-cased MATMUL_PRECISION name; ValueError for any other."""
    name = str(name).lower()
    if name not in PRECISION_NAMES:
        raise ValueError(f"MATMUL_PRECISION must be one of "
                         f"{PRECISION_NAMES}, got {name!r}")
    return name


def apply_matmul_precision(name: str) -> str:
    """Set the process-wide policy that ``matmul_precision()`` applies
    (the JAX package's ``apply_matmul_precision``). Returns the name."""
    global _policy
    _policy = check_matmul_precision(name)
    return _policy


def matmul_precision_name() -> str:
    """The process-wide policy."""
    return _policy


def precision_key() -> tuple:
    """Everything of the precision policy that changes what a forward
    computes: the process-wide name, the TF32 flags and CUDA autocast (on,
    at which dtype). A captured graph replays the surface it was captured
    under, so its cache key holds this."""
    return (_policy, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"))


@contextlib.contextmanager
def _tf32(on: bool):
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


@contextlib.contextmanager
def matmul_precision(name: str | None = None):
    """Run the block under MATMUL_PRECISION `name` (default: the
    process-wide policy), which is also the process-wide policy inside
    it: the TF32 flags and the CUDA autocast of the name. Everything is
    restored on exit."""
    global _policy
    name = _policy if name is None else check_matmul_precision(name)
    bf16 = name == "bfloat16" and torch.cuda.is_available()
    prev, _policy = _policy, name
    try:
        with _tf32(name in TF32_NAMES), torch.autocast(
                "cuda", dtype=torch.bfloat16, enabled=bf16,
                cache_enabled=False):
            yield
    finally:
        _policy = prev


@contextlib.contextmanager
def precision_highest():
    """JAX's ``Precision.HIGHEST`` pin: full f32 products inside the block
    (TF32 off for cuBLAS and cuDNN, CUDA autocast off) under every policy.
    The previous settings are restored on exit."""
    with _tf32(False), torch.autocast("cuda", enabled=False):
        yield


def autocast_bf16(x: torch.Tensor) -> bool:
    """Whether the bf16 policy's autocast is on for `x`'s device."""
    return (x.is_cuda and torch.is_autocast_enabled("cuda")
            and torch.get_autocast_dtype("cuda") == torch.bfloat16)
