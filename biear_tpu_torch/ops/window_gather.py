"""The three kernels of ``biear_tpu/ops/window_gather.py``, dispatched.

Counterparts of ``cc_kept_lags``, ``gather_windows`` and ``gather_mix_kb``
of the JAX module. The tensor's device picks the implementation: a CUDA
tensor launches the hand-written kernel (``kernels/cc_lags.cu``,
``kernels/gather_windows.cu``, ``kernels/gather_mix_kb.cu``), a CPU tensor
takes the plain version beside it. A kernel that fails to build or launch
raises; it never falls back, and there is no size-based fallback either.

Window contract (both gathers): pool rows are pre-padded to
``[0]*left_pad ++ row ++ 0s`` by ``pad_pool_for_windows`` and viewed as
(NP, n_blocks, 128); window x is ``pool3[rows[x]].reshape(-1)[offs[x] :
offs[x] + 16384]``. Indices are clamped into range the way
``lax.dynamic_slice`` clamps them (a row index into [0, NP), an offset so
that the window stays inside the row, a measurement into [0, M)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import count_launch

MAX_KEPT = 63          # the lag window 2K+1 must fit the kernel's 128 lags
WIN_BLOCKS = 128       # output window: 128 blocks of 128 = 16384 samples
WIN = WIN_BLOCKS * 128


def pad_pool_for_windows(pool: np.ndarray, left_pad: int,
                         max_off: int) -> np.ndarray:
    """Host-side: pad (NP, T) rows to ``[0]*left_pad ++ row ++ 0s`` and
    reshape to the (NP, n_blocks, 128) block view the gathers read.
    n_blocks covers max_off + the window + one lookahead block."""
    NP, T = pool.shape
    need = left_pad + T
    min_width = left_pad + max_off + WIN
    n_blocks = -(-max(need, min_width) // 128) + 1
    out = np.zeros((NP, n_blocks * 128), pool.dtype)
    out[:, left_pad:left_pad + T] = pool
    return out.reshape(NP, n_blocks, 128)


# ---------------- kept-lag cross-correlation ----------------

def _check(lf: torch.Tensor, rf: torch.Tensor, max_kept: int) -> None:
    if lf.ndim != 2 or lf.shape != rf.shape:
        raise ValueError(f"cc kernel needs two (B, n) tensors of one shape, "
                         f"got {tuple(lf.shape)} and {tuple(rf.shape)}")
    n = lf.shape[1]
    if not (n % 128 == 0 and 0 < max_kept <= MAX_KEPT):
        raise ValueError(f"cc kernel needs n%128==0 and max_kept<={MAX_KEPT}, "
                         f"got n={n}, max_kept={max_kept}")


def cc_kept_lags_cuda(lf: torch.Tensor, rf: torch.Tensor,
                      max_kept: int) -> torch.Tensor:
    """Launch ``cc_lags.cu`` on the current stream, one kernel launch with
    one block per row: (B, n) x2 -> (B, 2K+1)."""
    from ..kernels.build import cc_lags_lib, check_launch

    _check(lf, rf, max_kept)
    if not (lf.is_cuda and rf.is_cuda and lf.device == rf.device):
        raise ValueError("cc_kept_lags_cuda needs both inputs on one CUDA "
                         "device")
    if lf.dtype != torch.float32 or rf.dtype != torch.float32:
        raise TypeError(f"cc kernel takes float32, got {lf.dtype}/{rf.dtype}")
    lf, rf = lf.contiguous(), rf.contiguous()
    B, n = lf.shape
    out = torch.empty((B, 2 * max_kept + 1), dtype=torch.float32,
                      device=lf.device)
    if B == 0:
        return out
    with torch.cuda.device(lf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = cc_lags_lib().cc_lags_launch(lf.data_ptr(), rf.data_ptr(),
                                           out.data_ptr(), B, n, max_kept,
                                           stream)
    check_launch(err, "cc_lags")
    count_launch("cc_lags")
    return out


def cc_kept_lags(lf: torch.Tensor, rf: torch.Tensor,
                 max_kept: int) -> torch.Tensor:
    """corr[l] for l in [-max_kept, max_kept]: (B, n) x2 -> (B, 2K+1) with
    corr[b, s - K] = sum_m rf[b, m] lf[b, m + s - K] (lf zero outside).

    Needs n % 128 == 0 and 0 < max_kept <= 63 (ValueError otherwise), the
    contract of the TPU kernel. CUDA tensors run the CUDA kernel; CPU
    tensors the plain version."""
    _check(lf, rf, max_kept)
    if lf.is_cuda:
        return cc_kept_lags_cuda(lf, rf, max_kept)
    from .xcorr import cc_kept_lags_plain
    return cc_kept_lags_plain(lf, rf, max_kept)


# ---------------- sample-granular window gather ----------------

def _check_gather(pool3: torch.Tensor, rows: torch.Tensor,
                  offs: torch.Tensor) -> None:
    if pool3.ndim != 3 or pool3.shape[2] != 128 or pool3.shape[1] * 128 < WIN:
        raise ValueError(f"pool3 must be (NP, n_blocks >= {WIN_BLOCKS}, 128), "
                         f"got {tuple(pool3.shape)}")
    if rows.ndim != 1 or rows.shape != offs.shape:
        raise ValueError(f"rows and offs must be two (X,) vectors, got "
                         f"{tuple(rows.shape)} and {tuple(offs.shape)}")


def _clamped(pool3: torch.Tensor, rows: torch.Tensor, offs: torch.Tensor):
    """Row and offset indices clamped like lax.dynamic_slice, as int64."""
    NP, nb, _ = pool3.shape
    return (rows.long().clamp(0, NP - 1),
            offs.long().clamp(0, nb * 128 - WIN))


def gather_windows_plain(pool3: torch.Tensor, rows: torch.Tensor,
                         offs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gather_windows.cu``: pick the rows, then gather
    the sample window of each along the row -> (X, 128, 128)."""
    _check_gather(pool3, rows, offs)
    rows, offs = _clamped(pool3, rows, offs)
    flat = pool3.reshape(pool3.shape[0], -1).index_select(0, rows)
    t = offs[:, None] + torch.arange(WIN, device=pool3.device)[None, :]
    return torch.gather(flat, 1, t).reshape(-1, WIN_BLOCKS, 128)


def check_pool_aligned(pool3: torch.Tensor) -> None:
    """Raise unless pool3's data starts on the 16-byte grid: the window
    gather reads it in 16-byte aligned pieces, which a view off that grid
    would break (its rows, n_blocks x 512 bytes, are always on it)."""
    if pool3.data_ptr() % 16:
        raise ValueError("window gather needs pool3 16-byte aligned, got a "
                         "view at a storage offset of "
                         f"{pool3.storage_offset()} elements")


def gather_windows_cuda(pool3: torch.Tensor, rows: torch.Tensor,
                        offs: torch.Tensor) -> torch.Tensor:
    """Launch ``gather_windows.cu`` on the current stream -> (X, 128, 128)."""
    from ..kernels.build import check_launch, gather_windows_lib

    _check_gather(pool3, rows, offs)
    if not (pool3.is_cuda and rows.device == pool3.device
            and offs.device == pool3.device):
        raise ValueError("gather_windows_cuda needs pool3, rows and offs on "
                         "one CUDA device")
    if pool3.dtype != torch.float32:
        raise TypeError(f"window gather takes a float32 pool, got "
                        f"{pool3.dtype}")
    if not pool3.is_contiguous():
        raise ValueError("window gather needs a contiguous pool3")
    check_pool_aligned(pool3)
    NP, nb, _ = pool3.shape
    X = rows.shape[0]
    rows = rows.to(torch.int32).contiguous()
    offs = offs.to(torch.int32).contiguous()
    out = torch.empty((X, WIN_BLOCKS, 128), dtype=torch.float32,
                      device=pool3.device)
    if X == 0:
        return out
    with torch.cuda.device(pool3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = gather_windows_lib().gather_windows_launch(
            pool3.data_ptr(), rows.data_ptr(), offs.data_ptr(),
            out.data_ptr(), NP, nb * 128, X, stream)
    check_launch(err, "gather_windows")
    count_launch("gather_windows")
    return out


def gather_windows(pool3: torch.Tensor, rows: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """(X,) rows + (X,) sample offsets -> (X, 128, 128) window blocks:
    out[x].reshape(16384)[t] == pool3[rows[x]].reshape(-1)[offs[x] + t].

    Bit-exact copy. CUDA tensors run the CUDA kernel; CPU tensors the
    plain version."""
    if pool3.is_cuda:
        return gather_windows_cuda(pool3, rows, offs)
    return gather_windows_plain(pool3, rows, offs)


# ---------------- fused window gather + block-Toeplitz mix ----------------

def _check_mix(pool3, rows, offs, meas, kb, nf: int) -> None:
    _check_gather(pool3, rows, offs)
    if meas.shape != rows.shape:
        raise ValueError(f"meas must match rows, got {tuple(meas.shape)}")
    if kb.ndim != 3:
        raise ValueError(f"kb must be (M, ncol, 2*128), got {tuple(kb.shape)}")
    ncol = kb.shape[1]
    if ncol % 128:
        raise ValueError(f"kb rows must be 128-padded, got {tuple(kb.shape)}")
    if nf + ncol // 128 - 1 > WIN_BLOCKS:
        # frame nf-1 reads blocks [nf-1, nf-1 + ncol/128), which must
        # stay inside the gathered window
        raise ValueError(
            f"window coverage exceeded: nf={nf} with ncol={ncol} needs "
            f"{nf + ncol // 128 - 1} blocks > WIN_BLOCKS={WIN_BLOCKS}")


def frame_windows(win: torch.Tensor, nf: int, ncol: int) -> torch.Tensor:
    """(X, 128, 128) window blocks -> (X, nf, ncol) halo frames: frame f
    is the ncol samples from 128 f on (ncol / 128 consecutive blocks)."""
    return torch.cat([win[:, k:k + nf] for k in range(ncol // 128)], dim=-1)


def gather_mix_kb_plain(pool3, rows, offs, meas, kb,
                        nf: int) -> torch.Tensor:
    """Plain version of ``gather_mix_kb.cu`` (the JAX ``_gather_mix_xla``
    composition): gather, cast the window to kb's dtype, halo framing, KB
    row gather, one batched product -> (X, nf, 256) f32. The operands are
    widened to float64 and the sums rounded to f32 once: the exactly
    rounded result, which any order of f32 sums approaches (an f32
    product here differs from JAX's by up to 6e-5 on sums of ~80, the
    f64 one by 3e-5)."""
    _check_mix(pool3, rows, offs, meas, kb, nf)
    win = gather_windows_plain(pool3, rows, offs).to(kb.dtype)
    fw = frame_windows(win, nf, kb.shape[1]).double()
    kx = kb.index_select(0, meas.long().clamp(0, kb.shape[0] - 1)).double()
    return torch.matmul(fw, kx).float()


def gather_mix_kb_cuda(pool3, rows, offs, meas, kb, nf: int) -> torch.Tensor:
    """Launch ``gather_mix_kb.cu`` on the current stream -> (X, nf, 256).

    The products run on the bf16 tensor cores. The bank streams through
    a ring of shared-memory tiles, so its size is not limited by the
    kernel; kb must be bfloat16 (the bf16 mix policy) with 256 columns,
    16-byte aligned."""
    from ..kernels.build import check_launch, gather_mix_kb_lib

    _check_mix(pool3, rows, offs, meas, kb, nf)
    dev = pool3.device
    if not (pool3.is_cuda and kb.device == dev and rows.device == dev
            and offs.device == dev and meas.device == dev):
        raise ValueError("gather_mix_kb_cuda needs every input on one CUDA "
                         "device")
    if pool3.dtype != torch.float32 or kb.dtype != torch.bfloat16:
        raise TypeError(f"mix kernel takes a float32 pool and a bfloat16 "
                        f"bank, got {pool3.dtype}/{kb.dtype}")
    if kb.shape[2] != 256:
        raise ValueError(f"mix kernel needs kb (M, ncol, 256), got "
                         f"{tuple(kb.shape)}")
    if not (pool3.is_contiguous() and kb.is_contiguous()):
        raise ValueError("mix kernel needs contiguous pool3 and kb")
    if kb.data_ptr() % 16:
        # the kernel copies the bank in 16-byte words (cp.async)
        raise ValueError("mix kernel needs kb 16-byte aligned, got a view "
                         "at a storage offset of "
                         f"{kb.storage_offset()} elements")
    if pool3.data_ptr() % 16:
        # the kernel reads the windows with aligned 16-byte loads
        raise ValueError("mix kernel needs pool3 16-byte aligned, got a "
                         "view at a storage offset of "
                         f"{pool3.storage_offset()} elements")
    NP, nb, _ = pool3.shape
    M, ncol, _ = kb.shape
    X = rows.shape[0]
    rows, offs, meas = (a.to(torch.int32).contiguous()
                        for a in (rows, offs, meas))
    out = torch.empty((X, nf, 256), dtype=torch.float32, device=dev)
    if X == 0 or nf == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = gather_mix_kb_lib().gather_mix_kb_launch(
            pool3.data_ptr(), rows.data_ptr(), offs.data_ptr(),
            meas.data_ptr(), kb.data_ptr(), out.data_ptr(),
            NP, nb * 128, M, ncol, X, nf, stream)
    check_launch(err, "gather_mix_kb")
    count_launch("gather_mix_kb")
    return out


def gather_mix_kb(pool3, rows, offs, meas, kb, nf: int) -> torch.Tensor:
    """Fused window gather + block-Toeplitz HRIR contraction:
    (X,) rows / offsets / measurement ids -> (X, nf, 256) f32 with
    out[x] = frame(window_x) @ kb[meas[x]] (window cast to kb's dtype,
    f32 sums). kb rows must be zero-padded to a multiple of 128 and the
    frames must stay inside the window (ValueError otherwise).

    CUDA tensors run the CUDA kernel; CPU tensors the plain version."""
    if pool3.is_cuda:
        return gather_mix_kb_cuda(pool3, rows, offs, meas, kb, nf)
    return gather_mix_kb_plain(pool3, rows, offs, meas, kb, nf)
