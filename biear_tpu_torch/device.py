"""Device choice and the f32 numerics policy of the port.

Entry points run on the card unless the caller asks for the CPU: with no
``device`` and no card they raise rather than carry on quietly on the CPU.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, or RuntimeError without one;
    anything else is passed to ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@contextlib.contextmanager
def no_tf32():
    """Full f32 products inside the block (TF32 off for cuBLAS and cuDNN).

    The JAX reference runs its f32 surfaces (filterbank, DFT, CC, GRUs) at
    full f32 precision; TF32 keeps about three decimal digits. The previous
    settings are restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
