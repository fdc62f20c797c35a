"""The arithmetic and schedules of the redesigned CUDA kernels, emulated
on the CPU.

A CUDA kernel cannot run without a card, but the order in which it forms
its sums, and the order in which it moves its tiles, can be written out in
plain tensors. These tests hold

  * the mix kernel's decomposition on the UNFRAMED window,
    ``out[f] = sum_k bf16(blk[f + k]) @ kb[128 k : 128 k + 128]`` in tiles
    of 64 bank rows with f32 sums (``kernels/gather_mix_kb.cu``),
  * the CC kernel's chunk-looped, fixed-order sum (``kernels/cc_lags.cu``:
    40 terms per lane and chunk, chunk sums added to a running total, a
    fixed xor tree over the 32 lanes), and
  * the window gather's tile schedule (``kernels/gather_windows.cu``: the
    grid-stride walk over 16 KB tiles, each thread's pieces, the aligned
    spans and the shift)

to the port's plain versions and to the JAX package (the XLA compositions
``_gather_mix_xla`` and ``_gather_windows_xla``; the Pallas CC and window
kernels in interpret mode), with the kernels' own tolerances (mix atol
5e-5; CC rtol 2e-5 / atol 2e-4; the gather bit for bit). Inputs come from
numpy seeds. The ptxas report parser of ``kernels/build.py`` is tested on
a recorded compiler log, and the port of ``tools/bench_win_kernel.py``'s
ladder runs on the CPU at a small batch.
"""

import json
import os
import re

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


# ---------------- the window gather's tile schedule ----------------

def _cu_constants(name, *keys):
    """The named `constexpr int` values of kernels/<name>.cu."""
    src = open(os.path.join(build.KERNEL_DIR, f"{name}.cu")).read()
    return [int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in keys]


GW_WIN, GW_CHUNK, GW_THREADS, GW_BLOCKS_PER_SM = _cu_constants(
    "gather_windows", "kWin", "kChunk", "kThreads", "kBlocksPerSm")
H100_SMS = 132


def window_gather_emulation(pool3, rows, offs,
                            blocks_per_sm=GW_BLOCKS_PER_SM,
                            sms=H100_SMS):
    """What gather_windows.cu does, block by block: tiles of GW_CHUNK
    samples (tile t = chunk t % 4 of window t / 4) walked with a grid
    stride over min(tiles, blocks_per_sm * sms) blocks; thread i of
    GW_THREADS takes 16-byte pieces i + GW_THREADS j of the tile (which
    must be each piece once), loads that aligned piece of the tile's span
    (first sample rounded down to a multiple of 4) and, when the tile's
    start is not on that grid, the piece after it, and stores the 4
    samples `shift` into the pair. Returns (out (X, 128, 128), writes per
    output sample, the pool's flat [lo, hi) span each tile's loads read,
    by window)."""
    pool3, rows, offs = (np.asarray(a) for a in (pool3, rows, offs))
    NP, nb, _ = pool3.shape
    flat = pool3.reshape(-1)
    X = rows.shape[0]
    n_tiles = X * (GW_WIN // GW_CHUNK)
    grid = min(n_tiles, blocks_per_sm * sms)
    per_thread = GW_CHUNK // 4 // GW_THREADS
    order = np.array([i + GW_THREADS * j for i in range(GW_THREADS)
                      for j in range(per_thread)])
    assert np.array_equal(np.sort(order), np.arange(GW_CHUNK // 4))
    out = np.full(X * GW_WIN, np.nan, np.float32)
    writes = np.zeros(X * GW_WIN, np.uint8)
    reads = [[] for _ in range(X)]
    for b in range(grid):
        for t in range(b, n_tiles, grid):
            x, c = divmod(t, GW_WIN // GW_CHUNK)
            row = min(max(int(rows[x]), 0), NP - 1)
            off = min(max(int(offs[x]), 0), nb * 128 - GW_WIN)
            first = row * nb * 128 + off + c * GW_CHUNK
            shift = first & 3
            n = GW_CHUNK + (4 if shift else 0)
            span = flat[first - shift:first - shift + n]
            reads[x].append((first - shift, first - shift + n))
            pieces = span[:GW_CHUNK].reshape(-1, 4)
            after = span[4:].reshape(-1, 4) if shift else pieces
            both = np.concatenate([pieces, after], axis=1)
            tile = out[t * GW_CHUNK:(t + 1) * GW_CHUNK].reshape(-1, 4)
            tile[order] = both[order, shift:shift + 4]
            writes[t * GW_CHUNK:(t + 1) * GW_CHUNK] += 1
    return out.reshape(X, 128, 128), writes, reads


def _gather_pool(seed, NP):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((NP, 16128)).astype(np.float32)
    return rng, jwg.pad_pool_for_windows(pool, 255, 383)


@pytest.mark.parametrize("case", ["X=1", "X=3", "X=192", "X=1536", "edges"])
def test_window_gather_schedule_writes_each_sample_once(case):
    """On the kernel's grid of kBlocksPerSm blocks per SM: every
    output sample written once, every load read from inside its
    window's clamped [row * row_len + off, + 16384) widened to the 16-byte
    grid (which stays inside the row), the result bit-equal to the plain
    version and to JAX (the Pallas kernel in interpret mode where its
    lookahead block keeps it in range, the XLA composition at every
    case)."""
    rng, pool3 = _gather_pool(len(case), 7)
    NP, nb, _ = pool3.shape
    row_len = nb * 128
    top = row_len - WIN
    if case == "edges":          # rows and offsets at and past the clamps
        rows = np.array([-5, 0, NP - 1, NP, NP + 40, 1, -1, 2], np.int32)
        offs = np.array([0, -7, top, top + 1, 10 ** 6, top - 1, 3, 129],
                        np.int32)
    else:
        X = int(case[2:])
        rows = rng.integers(0, NP, X).astype(np.int32)
        offs = rng.integers(0, top - 128 + 1, X).astype(np.int32)
        offs[:min(X, 2)] = [top - 128, 1][:min(X, 2)]
    got, writes, reads = window_gather_emulation(pool3, rows, offs)
    assert writes.min() == writes.max() == 1
    for x, spans in enumerate(reads):
        r = min(max(int(rows[x]), 0), NP - 1)
        o = min(max(int(offs[x]), 0), top)
        lo, hi = r * row_len + o, r * row_len + o + WIN
        lo4, hi4 = lo // 4 * 4, -(-hi // 4) * 4     # the 16-byte grid
        assert all(lo4 <= a and b <= hi4 for a, b in spans)
        assert r * row_len <= lo4 and hi4 <= (r + 1) * row_len
        assert sum(b - a for a, b in spans) >= WIN and len(spans) == 4
    plain = twg.gather_windows_plain(_t(pool3), _t(rows), _t(offs)).numpy()
    np.testing.assert_array_equal(got, plain)
    # JAX wraps a negative row or offset numpy-style; the port clamps it
    # to 0 (test_mix_indices_below_their_range_clamp_to_the_first_entry)
    jrows, joffs = (jnp.asarray(np.maximum(a, 0)) for a in (rows, offs))
    np.testing.assert_array_equal(got, np.asarray(jwg._gather_windows_xla(
        jnp.asarray(pool3), jrows, joffs)))
    if case in ("X=1", "X=3", "X=192"):
        np.testing.assert_array_equal(got, np.asarray(
            jwg._gather_windows_pallas(jnp.asarray(pool3), jrows, joffs,
                                       True)))


@pytest.mark.parametrize("blocks_per_sm", [1, 3, 8])
def test_window_gather_schedule_holds_for_other_grids(blocks_per_sm):
    """The grid-stride walk stays sound for other grids (other blocks per
    SM, another card's SM count), with a ragged last lap."""
    rng, pool3 = _gather_pool(3, 5)
    rows = rng.integers(0, 5, 1001).astype(np.int32)
    offs = rng.integers(0, 300, 1001).astype(np.int32)
    got, writes, _ = window_gather_emulation(pool3, rows, offs,
                                             blocks_per_sm, sms=7)
    assert writes.min() == writes.max() == 1
    np.testing.assert_array_equal(
        got, twg.gather_windows_plain(_t(pool3), _t(rows), _t(offs)).numpy())


def test_window_gather_refuses_a_misaligned_pool():
    """The kernel reads the pool in 16-byte aligned pieces: a pool3 view
    one float into its storage is refused, an aligned one passes."""
    pool3 = torch.zeros(3 * 134 * 128 + 4)
    twg.check_pool_aligned(pool3[4:4 + 3 * 134 * 128].view(3, 134, 128))
    with pytest.raises(ValueError, match="16-byte aligned"):
        twg.check_pool_aligned(pool3[1:1 + 3 * 134 * 128].view(3, 134, 128))


# ---------------- the ladder of tools/bench_win_kernel.py ----------------

def test_bench_win_kernel_ladder_on_the_cpu(capsys):
    """The port of the tool's ladder at a small batch on the CPU: the
    library and plain lines with times, the kernel's line saying that it
    cannot run here (it takes CUDA tensors only), exit code 0; the inputs
    are the JAX tool's numpy draws."""
    from biear_tpu_torch import bench_win_kernel as bwk
    assert bwk.main(["--batch", "4", "--pool", "8", "--steps", "2",
                     "--windows", "2", "--device", "cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["part"] for d in lines] == ["win:library", "win:plain",
                                          "win:cuda"]
    for d in lines[:2]:
        assert d["X"] == 12 and d["ms"] > 0 and d["GBps"] > 0
        assert d["device"] == "cpu"
    assert "CUDA" in lines[2]["not_run"] and "error" not in lines[2]
    pool, rows, offs = bwk.tool_pool(4, 8)
    assert pool.shape == (8, 17024) and rows.shape == offs.shape == (12,)
    assert offs.max() <= (16128 - 16000) + 255
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(pool, rng.standard_normal(
        (8, 17024)).astype(np.float32))
    np.testing.assert_array_equal(rows, rng.integers(0, 8, 12))
    assert bwk.main(["--batch", "2", "--pool", "4", "--steps", "1",
                     "--windows", "1", "--device", "cpu", "--only",
                     "plain"]) == 0
    assert [json.loads(s)["part"] for s in
            capsys.readouterr().out.splitlines()] == ["win:plain"]


def test_bench_win_kernel_exits_1_when_a_variant_is_wrong(monkeypatch,
                                                         capsys):
    """A variant that is not bit-exact prints its error, the others still
    run, and the run exits with 1."""
    from biear_tpu_torch import bench_win_kernel as bwk
    monkeypatch.setattr(bwk, "gather_windows_plain",
                        lambda p3, r, o: twg.gather_windows_plain(p3, r, o)
                        + 1.0)
    assert bwk.main(["--batch", "2", "--pool", "4", "--steps", "1",
                     "--windows", "1", "--device", "cpu",
                     "--only", "plain,library"]) == 1
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["part"] for d in lines] == ["win:library", "win:plain"]
    assert lines[0]["ms"] > 0 and "bit-exact" in lines[1]["error"]


def test_bench_win_kernel_without_a_card_raises(monkeypatch):
    from biear_tpu_torch import bench_win_kernel as bwk
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bwk.main(["--batch", "2", "--pool", "4"])


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
