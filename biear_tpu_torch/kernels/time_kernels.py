"""Time the port's CUDA kernels on the card, alone or against another
checkout, at the shapes of the main paths.

    python biear_tpu_torch/kernels/time_kernels.py
    python biear_tpu_torch/kernels/time_kernels.py --compare OTHER_CHECKOUT

Without ``--compare`` it builds the kernels of the checkout named by
``--repo`` (default: the one this file lies in), holds the CC and mix
kernels to their plain versions and the window gather bit for bit, checks
that two launches give the same bits, times them with CUDA events (median
of 7 x 20 launches) and prints one JSON line. The window gather is timed
at every X the main paths launch it at and at tools/bench_win_kernel.py's
shape: through its wrapper (``ms``, int32 indices; ``int64_indices_ms``
with the synthesizer's int64 ones, which the wrapper casts), per launch in
a CUDA graph (``graph_ms``: the same inputs again and again, so the pool
may stay in L2 from one launch to the next) and per launch in a CUDA
graph that cycles over copies of the pool too large together for the L2
(``cold_ms``: each launch finds its pool out of L2, as on the main path,
where other kernels run between two gathers), each beside its plain
version, its library call (one advanced-indexing gather) and its bound:
the pool span its windows cover plus the indices read once and the
windows written once, over the HBM rate. At X = 1536 three floors are
timed too: a fill of the output (writes only), a copy of a tensor of its
size (reads and writes, no reuse), and the kernel with every window on
one pool row (no pool bytes from device memory). With ``--compare`` it
runs itself as four processes in turn (other, this, this, other), so that
two commits are timed on one card in one call, each in a process of its
own (an L2 eviction priority set by one kernel's hints outlives it, so
kernels timed in one process are not independent); the other checkout
needs only the wrappers ``cc_kept_lags_cuda``, ``gather_windows_cuda`` and
``gather_mix_kb_cuda``, not this file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

H100_HBM_BYTES_S = 3.35e12    # HBM3, H100 SXM data sheet
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CC_SHAPES = ((512, 16000, 48), (64, 16000, 48), (1, 16000, 48))
# tools/bench_win_kernel.py's pool: segments of 16128 samples at 16 kHz,
# HRIRs of 256 taps, three sources a batch row
TOOL_SOURCES, TOOL_FS, TOOL_IR_LEN, TOOL_SEG_LEN = 3, 16000, 256, 16128
# copies of the pool that cold_ms cycles over: 5 x 17.4 MB, more than the
# 50 MB L2 between two uses of one copy; a divisor of graph_ms's launches
COLD_COPIES = 5


def cuda_ms(torch, fn, reps: int = 7, inner: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(torch, fn, launches: int = 20) -> float:
    """Device time per call without the host's share: `launches` calls
    captured in one CUDA graph, replayed (median of cuda_ms's replays),
    over `launches`. At small sizes cuda_ms times the host wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                     # first call outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    ms = cuda_ms(torch, graph.replay, inner=5) / launches
    del graph
    return ms


def window_bytes(rows, offs, row_len: int, win: int = 16384) -> float:
    """Bytes of pool the windows cover: per distinct row, the span from its
    smallest to its largest offset plus one window (read once)."""
    import numpy as np
    r, o = rows.cpu().numpy(), offs.cpu().numpy().clip(0, row_len - win)
    span = sum(min(int(o[r == u].max() - o[r == u].min()) + win, row_len)
               for u in np.unique(r))
    return 4.0 * span


def tool_pool(batch: int, pool: int, win: int = 16384):
    """tools/bench_win_kernel.py's inputs, drawn from numpy seed 0 as it
    draws them: (pool (NP, row_len) f32, rows (X,) int32, offs (X,)
    int32), X = 3 * batch."""
    import numpy as np
    X = batch * TOOL_SOURCES
    offmax = (TOOL_SEG_LEN - TOOL_FS) + TOOL_IR_LEN - 1
    row_len = -(-(TOOL_IR_LEN - 1 + TOOL_SEG_LEN) // 128) * 128
    while TOOL_IR_LEN - 1 + offmax + win > row_len:
        row_len += 128
    rng = np.random.default_rng(0)
    pool_np = rng.standard_normal((pool, row_len)).astype(np.float32)
    rows = rng.integers(0, pool, X).astype(np.int32)
    offs = rng.integers(0, offmax + 1, X).astype(np.int32)
    return pool_np, rows, offs


def measure(repo: str, verbose: bool = False) -> dict:
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.kernels import build
    from biear_tpu_torch.ops import window_gather as wg
    from biear_tpu_torch.ops.xcorr import cc_kept_lags_plain

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all(verbose)
    res = {"repo": repo, "card": smi, "cc_lags": {}, "gather_mix_kb": {}}

    rng = np.random.default_rng(0)
    for B, n, K in CC_SHAPES:
        lf, rf = (torch.tensor(rng.standard_normal((B, n)),
                               dtype=torch.float32, device="cuda")
                  for _ in range(2))
        with precision_highest():
            want = cc_kept_lags_plain(lf, rf, K)
        got = wg.cc_kept_lags_cuda(lf, rf, K)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
        res["cc_lags"][f"B={B}"] = {
            "ms": cuda_ms(torch, lambda: wg.cc_kept_lags_cuda(lf, rf, K)),
            "max_abs_err": float((got - want).abs().max()),
            "same_bits": bool(torch.equal(got,
                                          wg.cc_kept_lags_cuda(lf, rf, K)))}

    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(256),
                                fs=16000, num_lags=100, mix_dtype="bfloat16")
    pool3, kb = synth.bank["pool3"], synth.bank["KB"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    _, _, meas, seg_idx, qoff, crop = synth.scene_batched(gen, 512)
    rows, offs, meas = ((seg_idx * synth.n_q + qoff).reshape(-1)
                        .to(torch.int32).contiguous(),
                        crop.reshape(-1).to(torch.int32).contiguous(),
                        meas.reshape(-1).to(torch.int32).contiguous())
    nf = 125
    with precision_highest():
        want = wg.gather_mix_kb_plain(pool3, rows, offs, meas, kb, nf)
    run = lambda: wg.gather_mix_kb_cuda(pool3, rows, offs, meas, kb, nf)
    got = run()
    err = float((got - want).abs().max())
    if not err <= 5e-5:
        raise RuntimeError(f"gather_mix_kb disagrees with plain: {err}")
    res["gather_mix_kb"]["X=1536 nf=125"] = {
        "ms": cuda_ms(torch, run), "max_abs_err": err,
        "same_bits": bool(torch.equal(got, run()))}

    res["gather_windows"] = gather_windows_timing(torch, wg, synth)
    return res


def windows_of(torch, synth, gen, batch: int):
    """The rows and offsets of one batch of the synthesizer's scenes: 3
    windows a row, int32 as the wrapper hands them to the kernel."""
    _, _, _, seg_idx, qoff, crop = synth.scene_batched(gen, batch)
    return ((seg_idx * synth.n_q + qoff).reshape(-1).to(torch.int32),
            crop.reshape(-1).to(torch.int32))


def tool_windows(torch):
    """tools/bench_win_kernel.py's shape on the card: 1024 x 3 windows
    from a 256-row pool of 133 blocks (tool_pool)."""
    pool_np, rows, offs = tool_pool(1024, 256)
    return (torch.tensor(pool_np, device="cuda").view(256, -1, 128),
            torch.tensor(rows, device="cuda"),
            torch.tensor(offs, device="cuda"))


def edge_windows(torch, pool3):
    """Indices at and past the edges, which must clamp: rows below 0 and
    past NP, offsets below 0, at the last window and past it."""
    NP, nb, _ = pool3.shape
    top = nb * 128 - 16384
    rows = torch.tensor([-5, 0, NP - 1, NP, NP + 40, 1, -1, 2],
                        dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, -7, top, top + 1, 10 ** 6, top - 1, 3, 129],
                        dtype=torch.int32, device="cuda")
    return rows, offs


def gather_windows_timing(torch, wg, synth) -> dict:
    """The window gather at every X the main paths launch (the demo's 3,
    the runner's 192 / 63 / 66, the writer's 768, training's 1536) and at
    the tool's 3072, bit-exact against the plain version and the library
    call at each, and at the edges and X = 1; timed through the wrapper
    (int32 and int64 indices), per launch in a CUDA graph (warm and cold,
    see the module's text) beside its bound, its plain version and its
    library call (one advanced-indexing gather). At X = 1536 three floors:
    a fill of the output (writes only), a copy of a tensor of its size
    (reads and writes, no reuse), and the kernel itself with every window
    on row 0, per launch in a CUDA graph (its 68 KB of pool surely in L2:
    the same writes and L2 reads with no pool read from device memory)."""
    pool3 = synth.bank["pool3"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = {f"X={3 * b}": (pool3, *windows_of(torch, synth, gen, b))
             for b in (1, 64, 21, 22, 256, 512)}
    cases["X=3072 tool"] = tool_windows(torch)
    t = torch.arange(16384, device="cuda")
    res = {}
    for name, (p3, rows, offs) in cases.items():
        flat = p3.reshape(p3.shape[0], -1)
        run = lambda: wg.gather_windows_cuda(p3, rows, offs)
        lib = lambda: flat[rows.long()[:, None], offs.long()[:, None] + t]
        g = run()
        if not torch.equal(g, wg.gather_windows_plain(p3, rows, offs)):
            raise RuntimeError(f"gather_windows {name}: not bit-exact")
        if not torch.equal(g.reshape(-1, 16384), lib()):
            raise RuntimeError(f"gather_windows {name}: the library gather "
                               "differs")
        copies = [p3.clone() for _ in range(COLD_COPIES)]
        turn = iter(range(10 ** 9))
        cold = lambda: wg.gather_windows_cuda(
            copies[next(turn) % COLD_COPIES], rows, offs)
        r64, o64 = rows.long(), offs.long()
        X = rows.numel()
        nbytes = (window_bytes(rows, offs, flat.shape[1]) + 8.0 * X
                  + 4.0 * X * 16384)
        plain = lambda: wg.gather_windows_plain(p3, rows, offs)
        res[name] = {"ms": cuda_ms(torch, run),
                     "int64_indices_ms": cuda_ms(
                         torch, lambda: wg.gather_windows_cuda(p3, r64, o64)),
                     "graph_ms": graph_ms(torch, run),
                     "cold_ms": graph_ms(torch, cold),
                     "plain_ms": cuda_ms(torch, plain),
                     "library_ms": cuda_ms(torch, lib),
                     "bound_ms": nbytes / H100_HBM_BYTES_S * 1e3,
                     "bound_by": "bytes",
                     "same_bits": bool(torch.equal(g, run()))}
        del copies
    one = cases["X=3"]
    edge = [(pool3, *edge_windows(torch, pool3)),
            (pool3, one[1][:1], one[2][:1])]
    res["edges_and_X=1_bit_exact"] = all(
        torch.equal(wg.gather_windows_cuda(*c), wg.gather_windows_plain(*c))
        for c in edge)
    out = torch.empty((1536, 16384), device="cuda")
    src = torch.randn((1536, 16384), device="cuda")
    p3, rows, offs = cases["X=1536"]
    one_row = torch.zeros_like(rows)
    res["floors X=1536"] = {
        "fill_ms": cuda_ms(torch, out.zero_),
        "copy_ms": cuda_ms(torch, lambda: out.copy_(src)),
        "one_row_graph_ms": graph_ms(torch, lambda: wg.gather_windows_cuda(
            p3, one_row, offs)),
        "bytes_written": 4.0 * out.numel()}
    moved = torch.empty(pool3.numel() + 4, device="cuda")[1:pool3.numel() + 1]
    try:
        wg.gather_windows_cuda(moved.view(pool3.shape), *one[1:])
        res["refuses_misaligned_pool"] = False
    except ValueError:
        res["refuses_misaligned_pool"] = True
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=ROOT, help="checkout to measure")
    ap.add_argument("--compare", help="another checkout: time it, this "
                    "one, this one, it, each in its own process")
    ap.add_argument("--out", help="also write the JSON here")
    ap.add_argument("--verbose", action="store_true",
                    help="show the compiler's output (ptxas resources)")
    args = ap.parse_args(argv)
    if args.compare:
        other = os.path.abspath(args.compare)
        results = []
        for repo in (other, args.repo, args.repo, other):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--repo", repo],
                capture_output=True, text=True)
            if out.returncode:
                sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
                return out.returncode
            results.append(json.loads(out.stdout.strip().splitlines()[-1]))
        line = json.dumps({"runs": results})
    else:
        line = json.dumps(measure(os.path.abspath(args.repo), args.verbose))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
