"""The arithmetic of the two redesigned CUDA kernels, emulated on the CPU.

A CUDA kernel cannot run without a card, but the order in which it forms
its sums can be written out in plain tensors. These tests hold

  * the mix kernel's decomposition on the UNFRAMED window,
    ``out[f] = sum_k bf16(blk[f + k]) @ kb[128 k : 128 k + 128]`` in tiles
    of 64 bank rows with f32 sums (``kernels/gather_mix_kb.cu``), and
  * the CC kernel's chunk-looped, fixed-order sum (``kernels/cc_lags.cu``:
    40 terms per lane and chunk, chunk sums added to a running total, a
    fixed xor tree over the 32 lanes)

to the port's plain versions and to the JAX package (the XLA composition
``_gather_mix_xla``; the Pallas CC kernel in interpret mode), with the
kernels' own tolerances (mix atol 5e-5; CC rtol 2e-5 / atol 2e-4). Inputs
come from numpy seeds. The ptxas report parser of ``kernels/build.py`` is
tested on a recorded compiler log.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from biear_tpu.ops import window_gather as jwg

from biear_tpu_torch.kernels import build
from biear_tpu_torch.ops import window_gather as twg
from biear_tpu_torch.ops.xcorr import cc_kept_lags_plain

WIN = 16384
MIX_TILE_ROWS = 64                  # kTileRows of gather_mix_kb.cu
CC_RUN, CC_PASSES = 20, 2           # kRun, kPasses of cc_lags.cu
CC_CHUNK = 32 * CC_RUN * CC_PASSES


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------- the mix kernel's decomposition ----------------

def mix_toeplitz_emulation(pool3, rows, offs, meas, kb, nf):
    """What gather_mix_kb.cu computes, in its order: one unframed bf16
    window per x, then per 64-row bank tile t (bank rows 64 t .. 64 t + 63,
    i.e. window block f + t // 2, columns 64 (t % 2) ..) one f32 product
    added to the running f32 sum."""
    NP, nb, _ = pool3.shape
    M, ncol, _ = kb.shape
    rows = rows.long().clamp(0, NP - 1)
    offs = offs.long().clamp(0, nb * 128 - WIN)
    meas = meas.long().clamp(0, M - 1)
    flat = pool3.reshape(NP, -1)
    idx = offs[:, None] + torch.arange(WIN)[None, :]
    blk = (flat[rows[:, None], idx].to(torch.bfloat16).float()
           .reshape(-1, 128, 128))                    # rounded once
    bank = kb[meas].float()
    out = torch.zeros((rows.shape[0], nf, 256), dtype=torch.float32)
    for t in range(ncol // MIX_TILE_ROWS):
        k, c = divmod(t * MIX_TILE_ROWS, 128)
        a = blk[:, k:k + nf, c:c + MIX_TILE_ROWS]
        b = bank[:, t * MIX_TILE_ROWS:(t + 1) * MIX_TILE_ROWS]
        out = out + torch.bmm(a, b)
    return out


def _mix_inputs(seed, ncol, x=6, m=3):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((3, 17000)).astype(np.float32)
    pool3 = jwg.pad_pool_for_windows(pool, 383, 1200)
    width = pool3.shape[1] * 128
    kb = (rng.standard_normal((m, ncol, 256)) * 0.5).astype(np.float32)
    # in range, then above their ranges, where the JAX composition clamps
    # too (it wraps a negative index, numpy-style; the port clamps it to
    # the first entry, which its own test below holds)
    rows = np.array([0, 2, 1, 1, 3 + 4, 3 + 1][:x], np.int32)
    offs = np.array([0, 1582, 37, width - WIN + 1, width, 129][:x], np.int32)
    meas = np.array([0, m - 1, 1 % m, m + 2, m, 0][:x], np.int32)
    return pool3, rows, offs, meas, kb


@pytest.mark.parametrize("nf", [1, 61, 125])
@pytest.mark.parametrize("ncol", [128, 256, 384])
def test_mix_toeplitz_decomposition_matches_plain_and_jax(ncol, nf):
    pool3, rows, offs, meas, kb = _mix_inputs(ncol + nf, ncol)
    kb16 = _t(kb).to(torch.bfloat16)
    args = [_t(a) for a in (pool3, rows, offs, meas)]
    got = mix_toeplitz_emulation(*args, kb16, nf).numpy()
    plain = twg.gather_mix_kb_plain(*args, kb16, nf).numpy()
    assert got.shape == plain.shape == (len(rows), nf, 256)
    np.testing.assert_allclose(got, plain, rtol=0, atol=5e-5)
    xla = np.asarray(jwg._gather_mix_xla(
        *(jnp.asarray(a) for a in (pool3, rows, offs, meas)),
        jnp.asarray(kb).astype(jnp.bfloat16), nf))
    np.testing.assert_allclose(got, xla, rtol=0, atol=5e-5)


def test_mix_indices_below_their_range_clamp_to_the_first_entry():
    pool3, rows, offs, meas, kb = _mix_inputs(5, 256, x=4)
    kb16 = _t(kb).to(torch.bfloat16)
    low = [_t(a) for a in (pool3, rows - 9, offs * 0 - 7, meas - 9)]
    zero = [_t(a) for a in (pool3, rows * 0, offs * 0, meas * 0)]
    for fn in (mix_toeplitz_emulation, twg.gather_mix_kb_plain):
        np.testing.assert_array_equal(fn(*low, kb16, 7).numpy(),
                                      fn(*zero, kb16, 7).numpy())


def test_mix_emulation_reads_no_sample_past_the_covered_blocks():
    """Frames stay inside nf + ncol / 128 - 1 window blocks: samples past
    them may hold anything."""
    pool3, rows, offs, meas, kb = _mix_inputs(6, 384, x=3)
    nf = 61
    kb16 = _t(kb).to(torch.bfloat16)
    args = [_t(a) for a in (pool3, rows * 0, offs * 0, meas)]
    want = mix_toeplitz_emulation(*args, kb16, nf)
    poisoned = _t(pool3).clone().reshape(pool3.shape[0], -1)
    poisoned[0, (nf + 2) * 128:] = float("nan")
    got = mix_toeplitz_emulation(poisoned.reshape(pool3.shape), *args[1:],
                                 kb16, nf)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------- the CC kernel's order of sums ----------------

def cc_chunked_emulation(lf, rf, max_kept):
    """What cc_lags.cu computes, in its order, for every lag at once: lane
    t of a warp owns samples 20 t .. 20 t + 19 of each 640-sample pass;
    a chunk is two passes. Per lane the 40 products of a chunk are summed
    in m order from zero, the chunk sum is added to the lane's running
    total, and the 32 totals meet in a xor-shuffle tree."""
    B, n = lf.shape
    K = max_kept
    n_chunks = -(-n // CC_CHUNK)
    padded = n_chunks * CC_CHUNK
    rfp = torch.zeros((B, padded), dtype=torch.float32)
    rfp[:, :n] = rf
    lfp = torch.zeros((B, padded + 2 * K), dtype=torch.float32)
    lfp[:, K:K + n] = lf                          # lfp[j] = lf[j - K]
    out = torch.empty((B, 2 * K + 1), dtype=torch.float32)
    for s in range(2 * K + 1):
        prod = rfp * lfp[:, s:s + padded]          # rf[m] lf[m + s - K]
        prod = prod.reshape(B, n_chunks, CC_PASSES, 32, CC_RUN)
        total = torch.zeros((B, 32), dtype=torch.float32)
        for c in range(n_chunks):
            acc = torch.zeros((B, 32), dtype=torch.float32)
            for p in range(CC_PASSES):
                for i in range(CC_RUN):
                    acc = acc + prod[:, c, p, :, i]
            total = total + acc
        lanes = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            total = total + total[:, lanes ^ o]
        out[:, s] = total[:, 0]
    return out


@pytest.mark.parametrize("max_kept", [1, 48, 63])
def test_cc_chunked_sum_matches_plain_and_jax(max_kept):
    rng = np.random.default_rng(max_kept)
    B, n = 2, 2 * CC_CHUNK + 384                   # not a multiple of a chunk
    assert n % 128 == 0 and n % CC_CHUNK
    lf = rng.standard_normal((B, n)).astype(np.float32)
    rf = rng.standard_normal((B, n)).astype(np.float32)
    got = cc_chunked_emulation(_t(lf), _t(rf), max_kept).numpy()
    plain = cc_kept_lags_plain(_t(lf), _t(rf), max_kept).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=2e-4)
    kern = np.asarray(jwg.cc_kept_lags(jnp.asarray(lf), jnp.asarray(rf),
                                       max_kept, use_kernel=True,
                                       interpret=True))
    np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-4)


def test_cc_lag_groups_cover_every_kept_lag_once():
    """cc_lags.cu gives warp g the lags S g .. S g + S with S the smallest
    of 8, 16, 24, 32 with 4 S >= 2 K; warp g writes S g .. S g + S - 1 and
    the last warp its last lag too."""
    for K in range(1, 64):
        S = next(s for s in (8, 16, 24, 32) if 4 * s >= 2 * K)
        written = [S * g + j for g in range(4) for j in range(S + 1)
                   if (j < S or g == 3) and S * g + j < 2 * K + 1]
        assert written == list(range(2 * K + 1)), K


# ---------------- the compiler's resource report ----------------

PTXAS_LOG = """\
[1/2] nvcc -c cc_lags.cu -o cc_lags.cuda.o
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__9982415f_10_cc_lags_cu_bf0fde7f14cc_lags_kernelILi24ELi4EEEvPKfS2_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__9982415f_10_cc_lags_cu_bf0fde7f14cc_lags_kernelILi24ELi4EEEvPKfS2_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 94 registers, used 1 barriers, 31872 bytes smem
ptxas info    : Compile time = 219.418 ms
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__e2fea4ab_16_gather_mix_kb_cu_7cda5c6220gather_mix_kb_kernelILi1ELb1EEEvPKfPKiS4_S4_PK13__nv_bfloat16Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__e2fea4ab_16_gather_mix_kb_cu_7cda5c6220gather_mix_kb_kernelILi1ELb1EEEvPKfPKiS4_S4_PK13__nv_bfloat16Pfiiiii
    16 bytes stack frame, 24 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers
[2/2] g++ cc_lags.cuda.o -shared -o biear_cc_lags.so
"""


def test_ptxas_report_reads_registers_spills_and_shared_memory():
    cc, mix = build.ptxas_report(PTXAS_LOG)
    assert cc["kernel"] == "cc_lags" and "cc_lags_kernel" in cc["entry"]
    assert (cc["registers"], cc["smem"], cc["stack"], cc["spill_stores"],
            cc["spill_loads"]) == (94, 31872, 0, 0, 0)
    assert mix["kernel"] == "gather_mix_kb"
    assert (mix["registers"], mix["smem"], mix["stack"], mix["spill_stores"],
            mix["spill_loads"]) == (106, 0, 16, 24, 28)
    assert build.ptxas_report("ninja: no work to do.\n") == []


def test_build_all_with_report_catches_the_compilers_output(monkeypatch,
                                                           tmp_path):
    """The report is read from what the build writes to the process's
    standard output (file descriptor 1), as ninja's children do."""
    import torch.utils.cpp_extension as cpp

    def fake_load(**kw):
        if kw["name"] == "biear_cc_lags":
            os.write(1, PTXAS_LOG.encode())
        return os.path.join(kw["build_directory"], "lib.so")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cpp, "load", fake_load)
    libs, text, report = build.build_all_with_report()
    assert sorted(libs) == sorted(build.KERNELS)
    assert "Used 94 registers" in text
    assert [e["kernel"] for e in report] == ["cc_lags", "gather_mix_kb"]
