"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file in this directory with a plain C interface
(no PyTorch headers, so ``nvcc`` takes seconds, not minutes). At first use
``torch.utils.cpp_extension.load`` compiles it for ``sm_90a`` into
``_build/`` beside this file (git-ignored), and ``ctypes`` binds its C
functions. Nothing is built at import time: the CPU tests import every
module of the package on a machine without ``nvcc``.

A build or launch failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]


def build(name: str) -> str:
    """Compile ``<name>.cu`` into ``_build/`` and return the library path."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    return load(name=f"biear_{name}",
                sources=[os.path.join(KERNEL_DIR, f"{name}.cu")],
                build_directory=BUILD_DIR, extra_cuda_cflags=CUDA_FLAGS,
                is_python_module=False)


@functools.cache
def cc_lags_lib() -> ctypes.CDLL:
    """The cross-correlation lag kernel (cc_lags.cu), built and bound."""
    lib = ctypes.CDLL(build("cc_lags"))
    lib.cc_lags_partial_floats.argtypes = [ctypes.c_int] * 3
    lib.cc_lags_partial_floats.restype = ctypes.c_int64
    lib.cc_lags_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p])
    lib.cc_lags_launch.restype = ctypes.c_int
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {err}")
