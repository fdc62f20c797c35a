"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file in this directory with a plain C interface
(no PyTorch headers, so ``nvcc`` takes seconds, not minutes). At first use
``torch.utils.cpp_extension.load`` compiles it for ``sm_90a`` into its own
directory ``_build/<name>/`` beside this file (git-ignored; ninja skips an
unchanged source), and ``ctypes`` binds its C functions. One directory per
kernel lets ``build_all`` run the nine builds (``cc_lags``,
``gather_windows``, ``gather_mix_kb``, the recorder's ``trace_mark``, the
optimizer's ``fused_update``, the adaptive filterbank's ``fb_gauss``, the
adaptive frontends' reverse recurrence ``frontend_bwd``, the dual
frontend's controller step ``controller_fwd`` and the frame spectra
``spectra``) at once;
``build_all_with_report`` also returns what ``ptxas -v`` said of each
entry function (registers, spills, shared memory). Nothing is built at
import time: the CPU tests import every module of the package on a
machine without ``nvcc``.

A build or launch failure raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import sys
import tempfile

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
# -Xptxas=-v: the register and shared-memory report, shown when verbose and
# parsed by ptxas_report
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas=-v"]
KERNELS = ("cc_lags", "gather_windows", "gather_mix_kb", "trace_mark",
           "fused_update", "fb_gauss", "frontend_bwd", "controller_fwd",
           "spectra")


def build_dir(name: str) -> str:
    return os.path.join(BUILD_DIR, name)


def build(name: str, verbose: bool = False) -> str:
    """Compile ``<name>.cu`` into ``_build/<name>/`` and return the library
    path; `verbose` prints the compiler's output."""
    from torch.utils.cpp_extension import load

    os.makedirs(build_dir(name), exist_ok=True)
    return load(name=f"biear_{name}",
                sources=[os.path.join(KERNEL_DIR, f"{name}.cu")],
                build_directory=build_dir(name), extra_cuda_cflags=CUDA_FLAGS,
                is_python_module=False, verbose=verbose)


@functools.cache
def cc_lags_lib() -> ctypes.CDLL:
    """The cross-correlation lag kernel (cc_lags.cu), built and bound."""
    lib = ctypes.CDLL(build("cc_lags"))
    lib.cc_lags_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                   + [ctypes.c_void_p])
    lib.cc_lags_launch.restype = ctypes.c_int
    return lib


@functools.cache
def gather_windows_lib() -> ctypes.CDLL:
    """The sample-granular window gather (gather_windows.cu)."""
    lib = ctypes.CDLL(build("gather_windows"))
    lib.gather_windows_launch.argtypes = ([ctypes.c_void_p] * 4
                                          + [ctypes.c_int] * 3
                                          + [ctypes.c_void_p])
    lib.gather_windows_launch.restype = ctypes.c_int
    return lib


@functools.cache
def gather_mix_kb_lib() -> ctypes.CDLL:
    """The fused window gather + HRIR mix (gather_mix_kb.cu)."""
    lib = ctypes.CDLL(build("gather_mix_kb"))
    lib.gather_mix_kb_launch.argtypes = ([ctypes.c_void_p] * 6
                                         + [ctypes.c_int] * 6
                                         + [ctypes.c_void_p])
    lib.gather_mix_kb_launch.restype = ctypes.c_int
    return lib


@functools.cache
def trace_mark_lib() -> ctypes.CDLL:
    """The recorder's device-timed stage mark (trace_mark.cu)."""
    lib = ctypes.CDLL(build("trace_mark"))
    lib.trace_mark_launch.argtypes = ([ctypes.c_void_p] * 2
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
    lib.trace_mark_launch.restype = ctypes.c_int
    return lib


@functools.cache
def fused_update_lib() -> ctypes.CDLL:
    """The optimizer step and its telemetry (fused_update.cu)."""
    lib = ctypes.CDLL(build("fused_update"))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_update_table_bytes.argtypes = []
    lib.fused_update_table_bytes.restype = i32
    lib.fused_update_stats_launch.argtypes = [ptr] * 5
    lib.fused_update_stats_launch.restype = i32
    lib.fused_update_finalize_launch.argtypes = (
        [i32] * 5 + [f32] * 2 + [ptr] * 10)
    lib.fused_update_finalize_launch.restype = i32
    lib.fused_update_adam_launch.argtypes = (
        [ptr] * 3 + [f32] * 7 + [ptr, i32, ptr])
    lib.fused_update_adam_launch.restype = i32
    return lib


@functools.cache
def fb_gauss_lib() -> ctypes.CDLL:
    """The adaptive filterbank's Gaussian build and contraction
    (fb_gauss.cu)."""
    lib = ctypes.CDLL(build("fb_gauss"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fb_gauss_launch.argtypes = ([ptr, i32, ptr, i32, i32] + [ptr] * 9
                                    + [i32] * 3 + [ptr])
    lib.fb_gauss_launch.restype = i32
    return lib


@functools.cache
def frontend_bwd_lib() -> ctypes.CDLL:
    """The adaptive frontends' reverse recurrence, one frame a launch
    (frontend_bwd.cu: the dual frontend's entry and the single's)."""
    lib = ctypes.CDLL(build("frontend_bwd"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for entry in (lib.frontend_bwd_launch, lib.single_bwd_launch):
        entry.argtypes = [ptr, i32, ptr, i32, ptr, i32, ptr]
        entry.restype = i32
    return lib


@functools.cache
def controller_fwd_lib() -> ctypes.CDLL:
    """Both ears' Q-controller step, one frame a launch
    (controller_fwd.cu)."""
    lib = ctypes.CDLL(build("controller_fwd"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.controller_fwd_launch.argtypes = [ptr, i32, ptr, i32, ptr, i32, ptr]
    lib.controller_fwd_launch.restype = i32
    return lib


@functools.cache
def spectra_lib() -> ctypes.CDLL:
    """The frame spectra, both ears' filterbank operand or one ear's f32
    spectra a launch (spectra.cu)."""
    lib = ctypes.CDLL(build("spectra"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.spectra_launch.argtypes = ([ptr, i32, i32] * 2 + [i32] * 5
                                   + [ptr] * 8)
    lib.spectra_launch.restype = i32
    return lib


def build_all(verbose: bool = False) -> dict:
    """Build every kernel of the port, one ``nvcc`` per source, all
    started together; returns {name: library path}."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = pool.map(lambda name: build(name, verbose), KERNELS)
        return dict(zip(KERNELS, paths))


def ptxas_report(text: str) -> list:
    """The ``ptxas -v`` lines of a compiler log as one dict per entry
    function: kernel (the name in KERNELS its symbol holds), entry (the
    mangled symbol), registers, stack, spill_stores, spill_loads (bytes)
    and smem (static bytes; dynamic shared memory is set at launch)."""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)' for", line)
        if m:
            entry = m.group(1)
            kernel = next((k for k in sorted(KERNELS, key=len, reverse=True)
                           if k in entry), None)
            cur = {"kernel": kernel, "entry": entry, "smem": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(smem.group(1)) if smem else 0
            out.append(cur)
            cur = None
    return out


def build_all_with_report() -> tuple:
    """build_all with the compiler's output caught on its way to the
    process's standard output: ({name: library path}, the output's text,
    ptxas_report of it). A build that ninja finds up to date compiles
    nothing and reports nothing."""
    sys.stdout.flush()
    with tempfile.TemporaryFile() as log:
        saved = os.dup(1)
        os.dup2(log.fileno(), 1)
        try:
            libs = build_all(verbose=True)
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        log.seek(0)
        text = log.read().decode(errors="replace")
    return libs, text, ptxas_report(text)


def check_launch(err: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed, cudaError_t {err}")
