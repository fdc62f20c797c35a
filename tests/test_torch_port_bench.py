"""The port's benchmark and measurement entry points at tiny sizes (CPU).

``biear_tpu_torch.bench`` prints ``bench.py``'s line and never writes
``BENCH_BASELINE.json``; its FLOP count is the hand count of the train
step's products; the batch sweep, the DFT probe and the input-pipeline
bench write their JSON and never a pre-port ``docs/*.json`` file. The
probe's product spectra are held to the rFFT (f32: 1e-5 of the
spectrum's largest value; bf16 operands with f32 sums: the ~1e-3 class
that ``biear_tpu/models/frontend.py:130-132`` states; bf16 results: their
own rounding, 2^-8 of a value, above it) and to the JAX tool's. Rates on
the CPU say nothing of the card; the card runs these in ``chip_smoke.py``
phase 17 and through each script's own command line.
"""

import ast
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.models import BiEARConfig as JaxConfig

from biear_tpu_torch import bench, bench_batch_sweep, bench_input_pipeline
from biear_tpu_torch import device as tdev
from biear_tpu_torch import probe_dft_matmul as probe
from biear_tpu_torch.ops.framing import frame_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_bands=16, latent_dim=16, ctrl_hidden=16, timesteps=3)
WINDOWS = dict(chunk=1, steps=1, dispatches=1, windows=1, segments=4)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bench_py_keys() -> list:
    """The keys of the line ``bench.py`` prints."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            return [k.value for k in node.keys]
    raise AssertionError("bench.py prints no line")


# ---------------- bench ----------------

def test_measure_gives_bench_py_keys_and_never_writes_the_baseline():
    path = bench.BASELINE_CACHE
    stat, text = os.stat(path), open(path).read()
    cfg = bench.flagship_config("bfloat16", **TINY)
    out = bench.measure(device="cpu", batch=2, chunk=1, steps=2,
                        chunk_dispatches=1, windows=2, model_cfg=cfg,
                        segments=4)
    assert list(out) == bench_py_keys() + ["power_limit", "flops_by_op"]
    assert os.stat(path).st_mtime_ns == stat.st_mtime_ns
    assert open(path).read() == text
    base = json.loads(text)
    assert out["baseline_device"] == base["baseline_device"]
    # both sides rounded to 0.01 from the same median
    assert abs(out["vs_baseline"]
               - out["value"] / base["reference_utterances_per_sec"]) < 0.006
    assert len(out["windows"]) == len(out["model_step_windows"]) == 2
    assert out["value"] > 0 and out["model_step_utt_s"] > 0
    assert (out["device"], out["mfu"], out["power_limit"], out["sync"]) == (
        "cpu", None, None, None)
    assert out["batch"] == 2 and out["fb_w_dtype"] == "bfloat16"
    assert out["flops_per_utt"] == round(sum(out["flops_by_op"].values()))


def test_main_prints_one_line_under_each_policy(monkeypatch, capsys):
    """main() uses bench.py's constants; --f32-parity switches both the
    filterbank and the mix policy; stdout holds the line alone."""
    seen = []
    real = bench.measure

    def tiny(**kw):
        seen.append(kw)
        assert set(kw) == {"trace_dir", "fb_w_dtype", "mix_dtype"}
        return real(device="cpu", batch=2, chunk=1, steps=1,
                    chunk_dispatches=1, windows=1, segments=4,
                    model_cfg=bench.flagship_config(kw["fb_w_dtype"],
                                                    **TINY),
                    mix_dtype=kw["mix_dtype"])

    monkeypatch.setattr(bench, "measure", tiny)
    for argv, dtype in (([], "bfloat16"), (["--f32-parity"], "float32")):
        bench.main(argv)
        out, err = capsys.readouterr()
        (line,) = out.strip().splitlines()
        got = json.loads(line)
        assert list(got) == bench_py_keys() + ["power_limit"]
        assert got["fb_w_dtype"] == got["synth_mix_dtype"] == dtype
        assert "flops_by_op" in json.loads(err.strip().splitlines()[-1])
    assert [kw["fb_w_dtype"] for kw in seen] == ["bfloat16", "float32"]
    assert (bench.BATCH, bench.CHUNK, bench.STEPS, bench.CHUNK_DISPATCHES,
            bench.WINDOWS) == (512, 16, 20, 3, 3)        # bench.py:54-58


def test_trace_writes_a_profile(tmp_path):
    cfg = bench.flagship_config("float32", **TINY)
    bench.bare_step_rates(cfg, bench.TrainHyper(), 2, 1, 1, "cpu",
                          trace_dir=str(tmp_path / "t"))
    assert json.load(open(tmp_path / "t" / "bench_trace.json"))


def hand_flops_per_utt(cfg) -> int:
    """The products of one train step of the dual active model, per
    utterance, counted by hand (2 FLOPs per multiply-add; a Linear's
    backward is a weight product and, where its input needs a gradient,
    an input product):

      * DFT (dft_mode "matmul"): 2 ears x (re, im) of (T, W) x (W, F); no
        backward (the waveforms need none);
      * filterbank, per frame, both ears: (N, F) x (F, 4) products; bf16
        policy ("bf16|noxg"): two in the forward, none in the backward;
        f32 ("f32|noxg"): one forward, one backward on every frame but
        the first (its Q is Q0, a constant);
      * controllers, both ears, every frame but the last (whose new Q is
        never used, so the frame loop runs no step there): the GRU cell
        (2N -> 3H, H -> 3H), q_out (H -> H twice, H -> N); backward on
        frames 0..T-2, input products from frame 1 on (frame 0's Y and
        state are constants). Under the bf16 policy the recurrence
        Function's (models/frontend_bwd.py) GRU input product reaches
        only the N inputs that take a gradient (the memory half is
        detached);
      * encoders x2: GRU N -> 200 and 200 -> L over T frames (input
        products on all frames at once; the state products' input
        gradient on frames 1..T-1);
      * backend: cc_proj (x3 needs no gradient), the body 3L -> 512 ->
        400 -> 200 and S heads (200 -> 100, two 100 -> 50 -> 10 -> 1
        branches, one 100 -> 50 -> 10 -> C), forward and two backward
        products each.
    """
    T, N, F = cfg.timesteps, cfg.n_bands, cfg.n_freq
    H, L, E = cfg.ctrl_hidden, cfg.latent_dim, 200
    W = frame_params(cfg.fs, T, cfg.hop_ratio)[0]
    lin = lambda i, o: 2 * i * o
    dft = 2 * 2 * 2 * T * W * F if cfg.use_dft_matmul else 0
    fb_dot = 2 * lin(N, 4) * F
    fb = (2 * T if cfg.fb_w_dtype == "bfloat16" else 2 * T - 1) * fb_dot
    cell = lin(2 * N, 3 * H) + lin(H, 3 * H)
    head = 2 * lin(H, H) + lin(H, N)
    if cfg.fb_w_dtype == "bfloat16":
        ctrl = 2 * ((T - 1) * (cell + head) + (T - 1) * (cell + 2 * head)
                    + (T - 2) * (lin(N, 3 * H) + lin(H, 3 * H)))
    else:
        ctrl = 2 * ((T - 1) * (cell + head) + (T - 1) * (cell + 2 * head)
                    + (T - 2) * cell)

    def gru(i, h):
        return T * 3 * lin(i, 3 * h) + 2 * T * lin(h, 3 * h) \
            + (T - 1) * lin(h, 3 * h)

    enc = 2 * (gru(N, E) + gru(E, L))
    branch = lambda o: lin(100, 50) + lin(50, 10) + lin(10, o)
    heads = lin(200, 100) + 2 * branch(1) + branch(cfg.n_dist_class)
    body = lin(3 * L, 512) + lin(512, 400) + lin(400, 200)
    back = 2 * lin(N, L) + 3 * body + 3 * cfg.n_sectors * heads
    return dft + fb + ctrl + enc + back


@pytest.mark.parametrize("policy", ["bfloat16", "float32"])
def test_flops_per_utt_is_the_hand_count_of_the_products(policy):
    cfg = bench.flagship_config(policy, **TINY)
    hp = bench.TrainHyper()
    got, by_op = bench.train_flops_per_utt(cfg, hp, rows=2)
    assert got == hand_flops_per_utt(cfg)
    assert set(by_op) == {"aten.mm", "aten.addmm", "aten.bmm"}
    assert bench.train_flops_per_utt(cfg, hp, rows=3)[0] == got


def test_xla_counts_a_scan_body_once():
    """Why bench.py's XLA count (107,408,536 per utterance) is below the
    port's: XLA's cost analysis counts a loop body once, whatever its trip
    count, and the JAX step runs its 19 frames and GRU steps as scans."""
    x, w = jnp.ones((8, 64)), jnp.ones((64, 64))

    def flops(n):
        f = jax.jit(lambda x, w: jax.lax.scan(
            lambda c, _: (jnp.tanh(c @ w), ()), x, None, length=n)[0])
        ca = f.lower(x, w).compile().cost_analysis()
        return (ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"]

    assert flops(10) < 1.01 * flops(2) and flops(2) >= 2 * 8 * 64 * 64


# ---------------- batch sweep ----------------

def test_sweep_rows_at_tiny_size(tmp_path):
    cfg = bench.flagship_config("bfloat16", **TINY)
    out = bench_batch_sweep.sweep(cfg, [2, 3], "bfloat16", device="cpu",
                                  **WINDOWS)
    jax_rows = json.load(open(os.path.join(REPO, "docs",
                                           "batch_sweep.json")))["rows"]
    assert [r["batch"] for r in out["rows"]] == [2, 3]
    for r in out["rows"]:
        assert set(r) == set(jax_rows[0]) | {"peak_memory_bytes"}
        # step_ms comes from the unrounded rate; step_utt_s is rounded to
        # 0.1, which bounds how far the two can disagree
        assert abs(r["step_ms"] * r["step_utt_s"] / (1e3 * r["batch"]) - 1) \
            <= 0.05 / r["step_utt_s"] + 1e-4
    assert (out["device"], out["fb_vjp"], out["matmul_precision"]) == (
        "cpu", "auto", "default")
    p = tmp_path / "s.json"
    p.write_text(json.dumps(out))
    assert json.load(open(p))["rows"] == out["rows"]


def test_sweep_main_sets_vjp_and_precision_and_spares_tpu_files(
        tmp_path, monkeypatch):
    seen = {}

    def stub(cfg, batches, mix_dtype, device=None, **kw):
        seen.update(cfg=cfg, batches=batches, mix=mix_dtype,
                    name=tdev.matmul_precision_name())
        return {"device": "cpu", "rows": []}

    monkeypatch.setattr(bench_batch_sweep, "sweep", stub)
    out = tmp_path / "s.json"
    bench_batch_sweep.main(["--batches", "2,4", "--f32-parity", "--fb-vjp",
                            "autodiff", "--matmul-precision", "tensorfloat32",
                            "--device", "cpu", "--out", str(out)])
    assert seen["cfg"].fb_vjp == "autodiff"
    assert seen["cfg"].fb_w_dtype == seen["mix"] == "float32"
    assert seen["batches"] == [2, 4] and seen["name"] == "tensorfloat32"
    assert tdev.matmul_precision_name() == "default"
    assert json.load(open(out)) == {"device": "cpu", "rows": []}
    tpu = os.path.join(REPO, "docs", "batch_sweep.json")
    before = open(tpu).read()
    with pytest.raises(SystemExit, match="TPU"):
        bench_batch_sweep.main(["--out", tpu, "--device", "cpu"])
    assert open(tpu).read() == before and seen["batches"] == [2, 4]


# ---------------- DFT probe ----------------

def test_probe_spectra_against_the_rfft(tmp_path):
    out = probe.probe(batch=4, iters=2, repeats=1, device="cpu")
    limits = {"dft_f32": 1e-5, "dft_f32_flat": 1e-5, "dft_tf32": 1e-5,
              "dft_bf16_operands": 2e-3, "dft_bf16": 5e-3, "kernel": 1e-5}
    for name, tol in limits.items():
        for comp, acc in out[f"accuracy_{name}"].items():
            assert acc["max_abs_vs_specmax"] <= tol, (name, comp, acc)
    # the bf16 class really is bf16, not f32
    assert out["accuracy_dft_bf16_operands"]["re"]["max_abs_vs_specmax"] \
        > 1e-4
    for name in probe.variants(probe.BiEARConfig()):
        assert out[f"ms_per_call_{name}"]["median"] > 0
    p = tmp_path / "d.json"
    probe.main(["--batch", "2", "--iters", "1", "--device", "cpu", "--out",
                str(p)])
    assert json.load(open(p))["batch_rows"] == 2 * 19


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "probe_dft_tool", os.path.join(REPO, "tools", "probe_dft_matmul.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_probe_matches_the_jax_tool():
    """The bases equal the JAX tool's bit for bit; the bf16-operand and
    rFFT spectra equal its bf16 product and XLA's rFFT within 1e-5 of the
    spectrum's largest value."""
    tool = _jax_tool()
    cfg = probe.BiEARConfig()
    c = tool.F.frontend_constants(JaxConfig())
    want = tool.dft_bases(c["win"], cfg.n_fft, cfg.n_freq, c["window"])
    for g, w in zip(probe.dft_bases(cfg, "cpu"), want):
        np.testing.assert_array_equal(g.numpy(), w)
    wav = probe.probe_waves(3)
    runs = probe.variants(cfg)
    pairs = (("rfft", lambda w: tool.spectra_fft(JaxConfig(), w)),
             ("dft_bf16_operands", tool.make_spectra_dft(JaxConfig(),
                                                          jnp.bfloat16)))
    for name, jax_fn in pairs:
        want = [np.asarray(a, np.float64) for a in jax_fn(jnp.asarray(wav))]
        got = [a.double().numpy() for a in runs[name](torch.as_tensor(wav))]
        scale = max(np.abs(a).max() for a in want)
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 1e-5 * scale, name


# ---------------- input pipeline ----------------

def test_input_pipeline_bench_at_tiny_size(tmp_path, monkeypatch):
    out = bench_input_pipeline.run(rows=40, fs=1600, batch_size=8, epochs=1,
                                   workdir=str(tmp_path / "w"),
                                   device="cpu")
    for schema in ("shard_active", "shard_passive"):
        got = out[schema]
        assert set(got) == {"open_s", "bytes", "cold_rows_per_s",
                            "rows_per_s", "prefetch_rows_per_s"}
        assert all(v > 0 for v in got.values())
    assert out["h5_lazy_rows_per_s"] > 0 and out["h5_preload_rows_per_s"] > 0
    monkeypatch.setitem(sys.modules, "h5py", None)     # the card's machine
    p = tmp_path / "i.json"
    bench_input_pipeline.main(["--rows", "24", "--fs", "1600",
                               "--batch-size", "8", "--epochs", "1",
                               "--device", "cpu", "--json", str(p)])
    got = json.load(open(p))
    for k in ("h5_lazy_rows_per_s", "h5_preload_rows_per_s",
              "h5_preload_s"):
        assert got[k] == "unavailable: no h5py"
    assert got["shard_active"]["rows_per_s"] > 0
