"""Time the port's CUDA kernels on the card, alone or against another
checkout, at the shapes of the main paths.

    python biear_tpu_torch/kernels/time_kernels.py
    python biear_tpu_torch/kernels/time_kernels.py --compare OTHER_CHECKOUT

Without ``--compare`` it builds the kernels of the checkout named by
``--repo`` (default: the one this file lies in), holds the CC and mix
kernels to their plain versions and the window gather bit for bit, checks
that two launches give the same bits, times them with CUDA events (median
of 7 x 20 launches) and prints one JSON line. The window gather is also
timed beside its library call (one advanced-indexing gather) and its
bound: the pool span its windows cover plus the indices read once and the
windows written once, over the HBM rate. With ``--compare`` it runs itself as four processes in
turn (other, this, this, other), so that two commits are timed on one card
in one call; the other checkout needs only the wrappers
``cc_kept_lags_cuda`` and ``gather_mix_kb_cuda``, not this file.
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


def window_bytes(rows, offs, row_len: int, win: int = 16384) -> float:
    """Bytes of pool the windows cover: per distinct row, the span from its
    smallest to its largest offset plus one window (read once)."""
    import numpy as np
    r, o = rows.cpu().numpy(), offs.cpu().numpy().clip(0, row_len - win)
    span = sum(min(int(o[r == u].max() - o[r == u].min()) + win, row_len)
               for u in np.unique(r))
    return 4.0 * span


def measure(repo: str, verbose: bool = False) -> dict:
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.device import no_tf32
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
        with no_tf32():
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
    with no_tf32():
        want = wg.gather_mix_kb_plain(pool3, rows, offs, meas, kb, nf)
    run = lambda: wg.gather_mix_kb_cuda(pool3, rows, offs, meas, kb, nf)
    got = run()
    err = float((got - want).abs().max())
    if not err <= 5e-5:
        raise RuntimeError(f"gather_mix_kb disagrees with plain: {err}")
    res["gather_mix_kb"]["X=1536 nf=125"] = {
        "ms": cuda_ms(torch, run), "max_abs_err": err,
        "same_bits": bool(torch.equal(got, run()))}

    gather = lambda: wg.gather_windows_cuda(pool3, rows, offs)
    g = gather()
    if not torch.equal(g, wg.gather_windows_plain(pool3, rows, offs)):
        raise RuntimeError("gather_windows is not bit-exact")
    flat = pool3.reshape(pool3.shape[0], -1)
    t = torch.arange(wg.WIN, device="cuda")
    lib = lambda: flat[rows.long()[:, None], offs.long()[:, None] + t]
    X = rows.numel()
    nbytes = (window_bytes(rows, offs, flat.shape[1], wg.WIN) + 8.0 * X
              + 4.0 * X * wg.WIN)
    res["gather_windows"] = {"X=1536": {
        "ms": cuda_ms(torch, gather), "library_ms": cuda_ms(torch, lib),
        "bound_ms": nbytes / H100_HBM_BYTES_S * 1e3, "bound_by": "bytes",
        "max_abs_err": 0.0, "same_bits": bool(torch.equal(g, gather()))}}
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
