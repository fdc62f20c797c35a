"""Hygiene of the PyTorch port: imports, device rules and kernel dispatch.

``biear_tpu_torch`` and ``chip_smoke.py`` must import neither JAX nor the
JAX package; entry points must refuse to run on the CPU unless asked to;
a CPU tensor must take the plain CC, window gather and mix, and the smoke
script must fail (and print no result) where there is no card or no
repository around it.

The tests marked ``cuda`` need the card and skip without one. This file
imports no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_package.py
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "biear_tpu_torch")
OK_PREFIX = '{"ok": true'


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("banned", ["jax", "jaxlib", "biear_tpu", "optax",
                                    "orbax"])
def test_port_never_imports_jax_or_the_jax_package(banned):
    sources = list(_port_sources())
    assert len(sources) > 15
    scanned = {os.path.relpath(p, PORT) for p in sources}
    assert scanned >= {"config.py", "utils/logging.py", "data/pipeline.py",
                       "data/h5io.py", "train/state.py", "train/runner.py",
                       "train_biear.py", "ops/features.py",
                       "data/passive_synth.py", "data/synth_reverb.py",
                       "models/auralnet.py", "utils/qvis.py",
                       "visualize_q.py", "data/speech.py",
                       "run_full_protocol.py", "protocol_eval.py",
                       "eval_by_snr.py", "data/labels.py", "data/sphere.py",
                       "generate_binaural_data.py", "precompute_h5.py",
                       "h5_to_shard.py", "stream_demo.py",
                       "archive_protocol_run.py", "parallel/mesh.py",
                       "bench.py", "bench_batch_sweep.py",
                       "probe_dft_matmul.py", "bench_input_pipeline.py"}
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_modules(p)
           if m == banned or m.startswith(banned + ".")]
    assert not bad, bad


def _resolved_imports(rel):
    """Every module that the port's file `rel` imports, relative imports
    and imports inside functions too, as absolute names; ``from X import
    y`` gives both X and X.y (y may be a module)."""
    package = ["biear_tpu_torch"] + os.path.dirname(rel).split(os.sep)
    path = os.path.join(PORT, rel)
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level \
                else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


def _imports_frontend(rel):
    target = "biear_tpu_torch.models.frontend"
    return [m for m in _resolved_imports(rel)
            if m == target or m.startswith(target + ".")]


@pytest.mark.parametrize("rel", ["models/frontend_bwd.py",
                                 "models/controller.py"])
def test_modules_below_the_frontend_never_import_it(rel):
    """The frontend imports its hand backward and its controller step,
    never the other way round (no lazy import either)."""
    assert _imports_frontend("models/biear.py")       # the scan sees one
    assert _imports_frontend(rel) == []


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PYTHON", "JAX"))}
    env["PYTHONPATH"] = REPO
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib, pkgutil, biear_tpu_torch\n"
            "for m in pkgutil.walk_packages(biear_tpu_torch.__path__, "
            "'biear_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'biear_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_clean_env(),
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_no_cuda(monkeypatch, tmp_path):
    from biear_tpu_torch.device import resolve_device
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve import infer

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_active(BiEARConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.load_model(str(tmp_path / "missing.pth"), BiEARConfig())
    assert resolve_device("cpu") == torch.device("cpu")
    assert next(build_active(BiEARConfig(), device="cpu").parameters()
                ).device.type == "cpu"


def test_training_entry_points_without_device_raise_when_no_cuda(
        monkeypatch):
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.train import profile_train

    _no_cuda(monkeypatch)
    ir, az, dist = make_test_hrir_bank()
    segs = make_test_segments(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnechoicSynthesizer(ir, az, dist, segs)
    with pytest.raises(SystemExit, match="CUDA card"):
        profile_train.main(["--batch", "2"])
    synth = AnechoicSynthesizer(ir, az, dist, segs, device="cpu")
    assert synth.bank["pool3"].device.type == "cpu"


def test_new_entry_points_without_device_raise_when_no_cuda(monkeypatch,
                                                            tmp_path):
    """evaluate and its CLI, profile_stream, and both profiles' single-
    controller flags refuse to run without a card unless given the CPU."""
    import json
    from biear_tpu_torch.data.shard import write_shard
    from biear_tpu_torch.serve import profile_serve, profile_stream
    from biear_tpu_torch.train import evaluate, profile_train

    _no_cuda(monkeypatch)
    (tmp_path / "settings.json").write_text(json.dumps(
        {"Controller_Mode": "single"}))
    shard = str(tmp_path / "t.shard")
    write_shard(shard, [np.zeros((1, 16000), np.float32)] * 2
                + [np.zeros((1, 100), np.float32),
                   np.zeros((1, 56), np.float32)])
    ckpt = str(tmp_path / "best.pth")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.evaluate(ckpt, test_shard=shard)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(["--checkpoint", ckpt, "--test-shard", shard])
    with pytest.raises(SystemExit, match="CUDA card"):
        profile_stream.main([])
    for prof in (profile_serve, profile_train):
        with pytest.raises(SystemExit, match="CUDA card"):
            prof.main(["--batch", "2", "--controller-mode", "single"])


def test_runner_entry_points_without_device_raise_when_no_cuda(
        monkeypatch, tmp_path):
    """train and the train_biear CLI refuse to run without a card unless
    given the CPU."""
    from biear_tpu_torch import train_biear
    from biear_tpu_torch.config import load_run_config
    from biear_tpu_torch.train.runner import train

    _no_cuda(monkeypatch)
    conf = os.path.join(REPO, "conf", "config.yaml")
    rc = load_run_config(conf)
    rc.runs_root = str(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(rc, datasets={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_biear.main(["--config", conf, "--epochs", "1"])
    assert os.listdir(tmp_path) == []


def test_passive_and_reverb_entry_points_without_device_raise_when_no_cuda(
        monkeypatch, tmp_path):
    """build_passive, the passive runner and train_biear CLI, the
    reverberant build_synthesizer and ReverbSynthesizer refuse to run
    without a card unless given the CPU."""
    from biear_tpu_torch import train_biear
    from biear_tpu_torch.config import load_run_config
    from biear_tpu_torch.data.synth import (build_synthesizer,
                                            make_test_segments)
    from biear_tpu_torch.data.synth_reverb import (ReverbSynthesizer,
                                                   make_test_brir_bank)
    from biear_tpu_torch.models import BiEARConfig, build_passive
    from biear_tpu_torch.train.runner import train

    _no_cuda(monkeypatch)
    cfg = BiEARConfig(n_bands=16, timesteps=3, latent_dim=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_passive(cfg)
    assert next(build_passive(cfg, device="cpu").parameters()
                ).device.type == "cpu"
    conf = os.path.join(REPO, "conf", "config_passive.yaml")
    rc = load_run_config(conf)
    rc.runs_root = str(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(rc, datasets={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_biear.main(["--config", conf, "--epochs", "1"])
    assert os.listdir(tmp_path) == []
    segs = make_test_segments(2)
    for scene in ("spirit", "auditorium", "room"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_synthesizer(scene, None, segs, 16000)
    ir, yaw, sxy = make_test_brir_bank(n_yaw=2, ir_len=200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReverbSynthesizer(ir, yaw, sxy, segs)
    synth = ReverbSynthesizer(ir, yaw, sxy, segs, device="cpu")
    assert synth.bank["H"].device.type == "cpu"


def test_auralnet_and_protocol_entry_points_without_device_raise_when_no_cuda(
        monkeypatch, tmp_path):
    """build_auralnet, run_full_protocol, protocol_eval, eval_by_snr and
    both profiles' AuralNet flags refuse to run without a card unless
    given the CPU, before they write anything."""
    from biear_tpu_torch import eval_by_snr, protocol_eval, run_full_protocol
    from biear_tpu_torch.models import BiEARConfig, build_auralnet
    from biear_tpu_torch.serve import profile_serve
    from biear_tpu_torch.train import profile_train

    _no_cuda(monkeypatch)
    cfg = BiEARConfig(n_bands=16, timesteps=3, d_model=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_auralnet(cfg)
    assert next(build_auralnet(cfg, device="cpu").parameters()
                ).device.type == "cpu"
    conf = os.path.join(REPO, "conf", "config_auralnet_deepear.yaml")
    for main, argv in (
            (run_full_protocol.main, ["--config", conf, "--runs-root",
                                      str(tmp_path)]),
            (protocol_eval.main, [str(tmp_path)]),
            (eval_by_snr.main, [str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert os.listdir(tmp_path) == []
    for main in (profile_train.main, profile_serve.main):
        with pytest.raises(SystemExit, match="CUDA card"):
            main(["--model", "auralnet", "--batch", "2"])


def test_dataset_and_demo_entry_points_without_device_raise_when_no_cuda(
        monkeypatch, tmp_path):
    """generate_binaural_data, precompute_h5 (both sources and both
    builders) and stream_demo refuse to run without a card unless given
    the CPU, before they write anything; with --device cpu they run."""
    from biear_tpu_torch import (generate_binaural_data, precompute_h5,
                                 stream_demo)

    _no_cuda(monkeypatch)
    out = str(tmp_path / "out")
    wav = np.zeros((1, 16000), np.float32)
    for call in (
            lambda: generate_binaural_data.main(["--out-root", out,
                                                 "--num", "1"]),
            lambda: precompute_h5.main(["--synth", "1", "--out-active",
                                        out + ".shard"]),
            lambda: precompute_h5.build_active(wav, wav, wav[:, :56], 16000,
                                               out + ".shard"),
            lambda: precompute_h5.build_passive(wav, wav, wav[:, :56], 16000,
                                                out + ".shard"),
            lambda: stream_demo.main(["--json", out + ".json",
                                      "--png", out + ".png"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert os.listdir(tmp_path) == []
    y = generate_binaural_data.main(["--out-root", out, "--num", "1",
                                     "--device", "cpu"])
    assert y.shape == (1, 56) and len(os.listdir(out + "/anechoic_train")) == 2


def test_bench_entry_points_without_device_raise_when_no_cuda(monkeypatch,
                                                              tmp_path):
    """The bench, the batch sweep, the DFT probe and the input-pipeline
    bench refuse to run without a card unless given the CPU, before they
    write anything."""
    from biear_tpu_torch import (bench, bench_batch_sweep,
                                 bench_input_pipeline, probe_dft_matmul)

    _no_cuda(monkeypatch)
    out = str(tmp_path / "out.json")
    for call in (bench.measure, lambda: bench.main([]),
                 lambda: bench_batch_sweep.main(["--batches", "2",
                                                 "--out", out]),
                 lambda: probe_dft_matmul.main(["--out", out]),
                 lambda: bench_input_pipeline.main(["--rows", "2",
                                                    "--json", out])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert os.listdir(tmp_path) == []


def test_streaming_state_lives_on_the_model_device():
    """The streaming functions follow the model: a CPU model keeps a CPU
    state, and numpy hops are moved to the model's device."""
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve import streaming

    cfg = BiEARConfig(controller_mode="single", fs=1600, timesteps=4,
                      n_fft=256, n_bands=24, fmax=700.0, latent_dim=8,
                      ctrl_hidden=8)
    model = build_active(cfg, seed=0, device="cpu")
    state = streaming.stream_init(model, 2)
    hop = streaming.stream_plan(cfg)["hop"]
    state = streaming.stream_step(model, state,
                                  np.zeros((2, hop), np.float32),
                                  np.zeros((2, hop), np.float32))
    leaves = [state["t"], *state["fe"], *state["ild"].values(),
              *state["cc"].values()]
    assert all(t.device.type == "cpu" for t in leaves)
    assert [tuple(t.shape) for t in state["fe"]] == [(2, 24), (2, 8),
                                                     (2, 24), (2, 24)]
    out = streaming.stream_readout(model, state)
    assert out[0].shape == (2, 8) and out[0].device.type == "cpu"


def test_cli_without_device_raises_when_no_cuda(monkeypatch, tmp_path):
    import json
    from biear_tpu_torch.serve import infer

    _no_cuda(monkeypatch)
    (tmp_path / "meta").mkdir()
    (tmp_path / "meta" / "settings.json").write_text(json.dumps({}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--checkpoint", str(tmp_path / "best.pth"), "x.wav"])


def test_cpu_tensors_take_the_plain_cc_and_count_no_launch(monkeypatch):
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.ops import window_gather as wg
    from biear_tpu_torch.ops.xcorr import (cc_kept_lags_plain,
                                           cross_correlation_feature)

    calls = []
    monkeypatch.setattr(wg, "cc_kept_lags_cuda",
                        lambda *a: calls.append(a) or None)
    LAUNCHES.clear()
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((3, 16000)), dtype=torch.float32)
    y = torch.roll(x, 5, 1)
    feat = cross_correlation_feature(x, y, 16000)
    assert feat.shape == (3, 100) and bool(torch.isfinite(feat).all())
    assert calls == [] and LAUNCHES["cc_lags"] == 0
    torch.testing.assert_close(wg.cc_kept_lags(x, y, 48),
                               cc_kept_lags_plain(x, y, 48), rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    from biear_tpu_torch.ops.window_gather import cc_kept_lags_cuda
    x = torch.zeros((2, 1280))
    with pytest.raises(ValueError, match="CUDA"):
        cc_kept_lags_cuda(x, x, 8)


def _small_pool(seed=0, X=5):
    from biear_tpu_torch.ops.window_gather import pad_pool_for_windows
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((3, 16000)).astype(np.float32)
    pool3 = torch.tensor(pad_pool_for_windows(pool, 255, 255))
    rows = torch.tensor(rng.integers(0, 3, X), dtype=torch.int32)
    offs = torch.tensor(rng.integers(0, 256, X), dtype=torch.int32)
    meas = torch.tensor(rng.integers(0, 4, X), dtype=torch.int32)
    kb = torch.tensor(rng.standard_normal((4, 384, 256)) * 0.1,
                      dtype=torch.float32).to(torch.bfloat16)
    return pool3, rows, offs, meas, kb


@pytest.mark.parametrize("name", ["gather_windows", "gather_mix_kb"])
def test_window_kernel_wrappers_refuse_cpu_tensors(name):
    from biear_tpu_torch.ops import window_gather as wg
    pool3, rows, offs, meas, kb = _small_pool()
    with pytest.raises(ValueError, match="CUDA"):
        if name == "gather_windows":
            wg.gather_windows_cuda(pool3, rows, offs)
        else:
            wg.gather_mix_kb_cuda(pool3, rows, offs, meas, kb, 13)


def test_cpu_tensors_take_the_plain_mix_and_gather_and_count_no_launch(
        monkeypatch):
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.ops import window_gather as wg

    calls = []
    for fn in ("gather_windows_cuda", "gather_mix_kb_cuda"):
        monkeypatch.setattr(wg, fn, lambda *a: calls.append(a) or None)
    LAUNCHES.clear()
    pool3, rows, offs, meas, kb = _small_pool(1)
    win = wg.gather_windows(pool3, rows, offs)
    mix = wg.gather_mix_kb(pool3, rows, offs, meas, kb, 13)
    assert win.shape == (5, 128, 128) and mix.shape == (5, 13, 256)
    assert calls == [] and sum(LAUNCHES.values()) == 0
    torch.testing.assert_close(win, wg.gather_windows_plain(pool3, rows,
                                                            offs),
                               rtol=0, atol=0)
    torch.testing.assert_close(mix, wg.gather_mix_kb_plain(
        pool3, rows, offs, meas, kb, 13), rtol=0, atol=0)


def test_kernel_sources_ship_with_the_package():
    """The build reads only repository sources, into a git-ignored dir;
    each source names the TPU kernel it replaces, or (the recorder's
    mark, the optimizer's fused update, the adaptive filterbank's build
    and contraction, the dual frontend's reverse recurrence and its
    controller step, the frame spectra) that it replaces none."""
    from biear_tpu_torch.kernels import build
    assert build.KERNELS == ("cc_lags", "gather_windows", "gather_mix_kb",
                             "trace_mark", "fused_update", "fb_gauss",
                             "frontend_bwd", "controller_fwd", "spectra")
    assert build.BUILD_DIR.startswith(PORT)
    assert "sm_90a" in " ".join(build.CUDA_FLAGS)
    gitignore = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "biear_tpu_torch/kernels/_build/" in gitignore
    for name in build.KERNELS:
        path = os.path.join(build.KERNEL_DIR, f"{name}.cu")
        assert os.path.isfile(path)
        src = open(path).read()
        for lib in ("cublas", "cudnn", "cufft", "torch/"):
            assert lib not in src.lower()
        assert ("replaces no tpu kernel"
                if name in ("trace_mark", "fused_update", "fb_gauss",
                            "frontend_bwd", "controller_fwd", "spectra")
                else "replaces the tpu kernel") in src.lower()
        assert 'extern "C"' in src
        assert build.build_dir(name).startswith(build.BUILD_DIR)


def test_build_all_builds_each_kernel_in_its_own_directory(monkeypatch,
                                                          tmp_path):
    """build_all hands every source to cpp_extension.load with its own
    build directory (so the builds can run together) and the sm_90a
    flags; a failing build raises."""
    import torch.utils.cpp_extension as cpp
    from biear_tpu_torch.kernels import build

    calls = []
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cpp, "load", lambda **kw: calls.append(kw)
                        or os.path.join(kw["build_directory"], "lib.so"))
    libs = build.build_all()
    assert sorted(libs) == sorted(build.KERNELS)
    dirs = {kw["build_directory"] for kw in calls}
    assert len(dirs) == len(build.KERNELS) == len(calls)
    for kw in calls:
        assert kw["sources"][0].endswith(kw["name"][len("biear_"):] + ".cu")
        assert "-gencode=arch=compute_90a,code=sm_90a" in \
            kw["extra_cuda_cflags"]
        assert kw["is_python_module"] is False

    def fail(**kw):
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(cpp, "load", fail)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=dict(_clean_env(), CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert OK_PREFIX not in out.stdout


def test_chip_smoke_fails_alone_without_the_repository(tmp_path):
    """Copied alone into an empty directory, the script fails on the
    missing package even where a card is reported."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in _clean_env().items() if k != "PYTHONPATH"}
    code = ("import runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "No module named 'biear_tpu_torch'" in out.stderr
    assert OK_PREFIX not in out.stdout


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")


@pytest.mark.cuda
def test_cc_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version, TF32 off, at the serving
    shapes, at batch 1 and 3, n = 128 and 16000, K = 1, 17 and 63 (rtol
    2e-5 / atol 2e-4, the JAX kernel's tolerance); two launches on the same
    inputs give the same bits."""
    _need_card()
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.ops.window_gather import cc_kept_lags
    from biear_tpu_torch.ops.xcorr import cc_kept_lags_plain

    rng = np.random.default_rng(8)
    LAUNCHES.clear()
    shapes = ((512, 16000, 48), (1, 16000, 48), (7, 1024, 63), (3, 2560, 1),
              (3, 16000, 63), (1, 128, 1), (3, 128, 63), (1, 16000, 1),
              (5, 2560, 17))
    for B, n, mk in shapes:
        lf, rf = (torch.tensor(rng.standard_normal((B, n)),
                               dtype=torch.float32, device="cuda")
                  for _ in range(2))
        with precision_highest():
            want = cc_kept_lags_plain(lf, rf, mk)
            got = cc_kept_lags(lf, rf, mk)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
        assert torch.equal(got, cc_kept_lags(lf, rf, mk))
    assert LAUNCHES["cc_lags"] == 2 * len(shapes)
    # rows off the 16-byte grid (a view one float into its storage) and a K
    # that is no multiple of 4 take the 4-byte staging copies
    lf, rf = (torch.tensor(rng.standard_normal(1 + 2 * 1280),
                           dtype=torch.float32, device="cuda")[1:].view(2, -1)
              for _ in range(2))
    with precision_highest():
        torch.testing.assert_close(cc_kept_lags(lf, rf, 48),
                                   cc_kept_lags_plain(lf, rf, 48),
                                   rtol=2e-5, atol=2e-4)


@pytest.mark.cuda
def test_window_kernels_match_plain_on_card():
    """gather_windows.cu bit-exact and gather_mix_kb.cu within 5e-5 (the
    JAX kernel-vs-XLA tolerance) of their plain versions, on the
    synthesizer's pool and bf16 bank, at 1536 windows and a ragged shape."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.ops import window_gather as wg

    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(64),
                                mix_dtype="bfloat16")
    pool3, kb = synth.bank["pool3"], synth.bank["KB"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    LAUNCHES.clear()
    for B, nf in ((512, 125), (3, 61), (1, 1)):
        _, _, meas, seg, qoff, crop = synth.scene_batched(gen, B)
        rows = (seg * synth.n_q + qoff).reshape(-1)
        offs, meas = crop.reshape(-1), meas.reshape(-1)
        assert torch.equal(wg.gather_windows(pool3, rows, offs),
                           wg.gather_windows_plain(pool3, rows, offs))
        with precision_highest():
            torch.testing.assert_close(
                wg.gather_mix_kb(pool3, rows, offs, meas, kb, nf),
                wg.gather_mix_kb_plain(pool3, rows, offs, meas, kb, nf),
                rtol=0, atol=5e-5)
    assert LAUNCHES["gather_windows"] == 3 and LAUNCHES["gather_mix_kb"] == 3
    # a contiguous bank view off the 16-byte grid is refused, not launched,
    # and so is such a pool
    shifted = torch.empty(kb.numel() + 8, dtype=kb.dtype, device="cuda")
    shifted = shifted[1:kb.numel() + 1].view(kb.shape)
    with pytest.raises(ValueError, match="aligned"):
        wg.gather_mix_kb(pool3, rows, offs, meas, shifted, 1)
    moved = torch.empty(pool3.numel() + 4, dtype=pool3.dtype, device="cuda")
    moved = moved[1:pool3.numel() + 1].view(pool3.shape)
    with pytest.raises(ValueError, match="aligned"):
        wg.gather_mix_kb(moved, rows, offs, meas, kb, 1)
    assert LAUNCHES["gather_mix_kb"] == 3


@pytest.mark.cuda
def test_window_gather_clamps_and_refuses_a_misaligned_pool_on_card():
    """gather_windows.cu bit-exact at rows and offsets past the clamps and
    at X = 1, two launches equal; a pool3 view one float into its storage
    (the kernel reads 16-byte aligned pieces) is refused, not launched."""
    _need_card()
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.ops import window_gather as wg

    gen = torch.Generator(device="cuda").manual_seed(2)
    NP, nb = 5, 134
    pool3 = torch.randn((NP, nb, 128), generator=gen, device="cuda")
    top = nb * 128 - wg.WIN
    rows = torch.tensor([-5, 0, NP - 1, NP, NP + 40, 1, -1, 2],
                        dtype=torch.int32, device="cuda")
    offs = torch.tensor([0, -7, top, top + 1, 10 ** 6, top - 1, 3, 129],
                        dtype=torch.int32, device="cuda")
    LAUNCHES.clear()
    for r, o in ((rows, offs), (rows[3:4], offs[3:4])):
        got = wg.gather_windows(pool3, r, o)
        assert torch.equal(got, wg.gather_windows_plain(pool3, r, o))
        assert torch.equal(got, wg.gather_windows(pool3, r, o))
    assert LAUNCHES["gather_windows"] == 4
    moved = torch.empty(pool3.numel() + 4, device="cuda")
    moved = moved[1:pool3.numel() + 1].view(pool3.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wg.gather_windows(moved, rows, offs)
    assert LAUNCHES["gather_windows"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("X,nf,ncol,M,wild", [
    (1, 1, 384, 1, False), (5, 64, 384, 4, False), (5, 65, 384, 4, False),
    (7, 61, 128, 1, False), (4, 125, 512, 3, False), (6, 128, 128, 2, False),
    (9, 33, 256, 5, True), (300, 125, 384, 32, True)])
def test_mix_kernel_ragged_shapes_on_card(X, nf, ncol, M, wild):
    """gather_mix_kb.cu within 5e-5 of its plain version at one window, 1,
    64, 65 and 128 frames, banks of 128 to 512 rows and of one measurement,
    and with indices out of range (`wild`), which clamp; two launches on
    the same inputs give the same bits."""
    _need_card()
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.ops import window_gather as wg

    gen = torch.Generator(device="cuda").manual_seed(X + nf + ncol)
    NP, nb = 6, 140
    pool3 = torch.randn((NP, nb, 128), generator=gen, device="cuda")
    kb = (torch.randn((M, ncol, 256), generator=gen, device="cuda")
          * 0.1).to(torch.bfloat16)
    draw = lambda lo, hi: torch.randint(lo, hi, (X,), generator=gen,
                                        device="cuda")
    if wild:
        rows, offs, meas = (draw(-3, NP + 3), draw(-500, nb * 128 + 500),
                            draw(-2, M + 2))
    else:
        rows, offs, meas = (draw(0, NP), draw(0, nb * 128 - wg.WIN + 1),
                            draw(0, M))
    with precision_highest():
        got = wg.gather_mix_kb(pool3, rows, offs, meas, kb, nf)
        want = wg.gather_mix_kb_plain(pool3, rows, offs, meas, kb, nf)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-5)
    assert torch.equal(got, wg.gather_mix_kb(pool3, rows, offs, meas, kb, nf))


def _fb_case(R, N=100, F=513, seed=0):
    """The flagship's fc and f_fft (N = 100, F = 513) or a small odd
    geometry, Q log-uniform over [q_min, q_max] = [0.05, 30] (bandwidths
    from far wider than the spectrum to a few bins, so every G from 1 to
    the subnormals and 0 occurs), and bf16 spectra rows [|X|, re, im, 1]."""
    from biear_tpu_torch.models import BiEARConfig
    from biear_tpu_torch.models.frontend import frontend_constants
    from biear_tpu_torch.ops.filterbank import stack_rhs

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if (N, F) == (100, 513):
        c = frontend_constants(BiEARConfig())
        fc, f_fft = (torch.tensor(c[k], device="cuda")
                     for k in ("fc", "f_fft"))
    else:
        fc = torch.sort(torch.rand(N, generator=gen, device="cuda")
                        * 7000 + 50).values
        f_fft = torch.linspace(0, 8000, F, device="cuda")
    Q = torch.exp(torch.rand((R, N), generator=gen, device="cuda")
                  * float(np.log(600.0))) * 0.05
    re, im = (torch.randn((R, F), generator=gen, device="cuda")
              for _ in range(2))
    return Q, stack_rhs(torch.sqrt(re * re + im * im), re, im, True), fc, f_fft


def _fb_sum_bounds(Q, rhs, fc, f_fft):
    """Per (row, band): the worst-case error of each f32 sum over F terms
    is at most F u sum_f |term| (u = 2^-24; the plain path's GEMM sums its
    F terms in one chain, the kernel in chains of at most 9 tensor-core
    steps), so the kernel and the plain path differ by at most twice that:
    (bound of out (R, N, 4), bound of T (R, N, 4))."""
    from biear_tpu_torch.ops.filterbank import _gauss_fast

    _, t, G = _gauss_fast(Q, fc, f_fft)
    a = rhs.double().abs()
    bnd = lambda w: (2.0 * w.shape[-1] * 2.0 ** -24
                     * torch.einsum("rnf,rcf->rnc",
                                    w.to(torch.bfloat16).double().abs(), a))
    return bnd(G), bnd(G * (-2.0 * t))


def _fb_check(got, want, bounds):
    """got / want (Y, Zre, Zim, den, finite, bw, T): bw and finite bit for
    bit; den and T within the sums' bound; Y, Zre, Zim within the bound
    carried through the division (numerator and den), plus two float32
    roundings of the quotient."""
    b_out, b_t = bounds
    Y, Zre, Zim, den, finite, bw, T = want
    assert torch.equal(got[4], finite)
    assert torch.equal(got[5], bw) or (torch.equal(got[5].isnan(),
                                                   bw.isnan())
                                       and torch.equal(got[5][~bw.isnan()],
                                                       bw[~bw.isnan()]))
    u = 2.0 ** -23

    def close(g, w, lim):
        nan = w.isnan()
        assert torch.equal(g.isnan(), nan)
        assert bool(((g - w).abs().double() <= lim)[~nan].all())
    close(got[3], den, b_out[..., 3] + u * den.abs())
    if T is not None:
        close(got[6], T, b_t + u * T.abs())
    for k, (g, w) in enumerate(zip(got[:3], (Y, Zre, Zim))):
        lim = ((b_out[..., k] + w.abs().double() * b_out[..., 3])
               / den.abs().double() * 1.01 + 2 * u * w.abs().double())
        close(g, w, torch.where(finite, lim, 0.0))   # Y = 0 where not
    assert bool((got[0][~finite] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,F", [(1024, 100, 513), (128, 100, 513),
                                   (1, 100, 513), (3, 7, 33), (5, 20, 48)])
def test_fb_gauss_kernel_matches_plain_on_card(R, N, F):
    """fb_gauss.cu against the plain ops on the card at the flagship's
    training frame (R = 2B = 1,024), the spirit cell's (128), one row and
    two ragged geometries, with and without T: bw and the finite mask bit
    for bit, the sums within _fb_sum_bounds; two launches give the same
    bits; one launch each, counted."""
    _need_card()
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.ops import filterbank as fb

    Q, rhs, fc, f_fft = _fb_case(R, N, F, seed=R + N + F)
    bounds = _fb_sum_bounds(Q, rhs, fc, f_fft)
    LAUNCHES.clear()
    for with_t in (True, False):
        with precision_highest():
            want = fb.gauss_contract_plain(Q, rhs, fc, f_fft, with_t)
        got = fb.gauss_contract(Q, rhs, fc, f_fft, with_t)
        _fb_check(got, want, bounds)
        again = fb.gauss_contract(Q, rhs, fc, f_fft, with_t)
        for a, b in zip(got, again):
            assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(got[0], again[0])
    assert LAUNCHES["fb_gauss"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("R,N,F", [(1024, 100, 513), (128, 100, 513),
                                   (3, 7, 33)])
def test_fb_gauss_bf16_operands_are_the_plain_bits_on_card(R, N, F):
    """One-hot probes: with rhs channel c = e_f (c < 3) and channel 3 = 0,
    each sum holds one term, so out_c = bf16(G)[f] and T_c = bf16(Gz2)[f]
    exactly. den is then 1e-8, and Y, Zre, Zim = out_c / 1e-8 in float32:
    two different bf16 values give different quotients, so equal quotients
    are equal bf16 operands. Held bit for bit, at every bin, against the
    plain path's G.to(bf16) and (G * (-2 t)).to(bf16) on the card."""
    _need_card()
    from biear_tpu_torch.ops import filterbank as fb

    Q, _, fc, f_fft = _fb_case(R, N, F, seed=7)
    _, t, G = fb._gauss_fast(Q, fc, f_fft)
    Gb = G.to(torch.bfloat16).float()
    Zb = (G * (-2.0 * t)).to(torch.bfloat16).float()
    den = torch.full((R, N), 1e-8, dtype=torch.float32, device="cuda")
    assert bool((Gb > 0).any() and (Gb == 0).any())
    if R >= 128:                                          # subnormals too
        assert bool(((Gb > 0) & (Gb < 1.1754944e-38)).any())
    for f0 in range(0, F, 3):
        bins = [min(f0 + c, F - 1) for c in range(3)]
        rhs = torch.zeros((R, 4, F), dtype=torch.bfloat16, device="cuda")
        for c, f in enumerate(bins):
            rhs[:, c, f] = 1.0
        Y, Zre, Zim, d, _, _, T = fb.gauss_contract(Q, rhs, fc, f_fft, True)
        assert bool((d == den).all())
        for c, (got, f) in enumerate(zip((Y, Zre, Zim), bins)):
            assert torch.equal(got, Gb[..., f] / den), (f, c)
            assert torch.equal(T[..., c], Zb[..., f]), (f, c)


@pytest.mark.cuda
def test_fb_gauss_kernel_edges_on_card():
    """A NaN row and a NaN entry of Q give Y = 0 and finite False there,
    the other entries as the plain path; the frontend's strided frame
    (a view of its (T, 2B, 4, F) stack) gives the bits of a contiguous
    copy; a stride-0 Q (an expanded Q0) is read in place; a bad shape or
    type raises."""
    _need_card()
    from biear_tpu_torch.device import precision_highest
    from biear_tpu_torch.ops import filterbank as fb

    Q, rhs, fc, f_fft = _fb_case(64, seed=3)
    Q[5] = float("nan")
    Q[9, 17] = float("nan")
    with precision_highest():
        want = fb.gauss_contract_plain(Q, rhs, fc, f_fft, True)
    got = fb.gauss_contract(Q, rhs, fc, f_fft, True)
    _fb_check(got, want, _fb_sum_bounds(Q, rhs, fc, f_fft))
    assert not bool(got[4][5].any()) and not bool(got[4][9, 17])
    assert int((~got[4]).sum()) == 101 and bool((got[0][5] == 0).all())

    gen = torch.Generator(device="cuda").manual_seed(4)
    stack = torch.randn((64, 19, 4, 513), generator=gen,
                        device="cuda").to(torch.bfloat16).transpose(0, 1)
    Q = _fb_case(64, seed=4)[0]
    for t in (0, 7, 18):
        a = fb.gauss_contract(Q, stack[t], fc, f_fft, True)
        b = fb.gauss_contract(Q, stack[t].contiguous(), fc, f_fft, True)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    q0 = Q[0].expand(64, -1)
    a = fb.gauss_contract(q0, stack[2], fc, f_fft, False)
    b = fb.gauss_contract(q0.contiguous(), stack[2], fc, f_fft, False)
    assert all(torch.equal(x, y) for x, y in zip(a[:6], b[:6]))

    with pytest.raises(ValueError, match="fb_gauss needs"):
        fb.gauss_contract(Q[:, :99], stack[0], fc, f_fft, True)
    with pytest.raises(ValueError, match="fb_gauss needs"):
        fb.gauss_contract(Q, stack[0][:, :3], fc, f_fft, True)
    with pytest.raises(TypeError, match="bf16"):
        fb.gauss_contract(Q, stack[0].float(), fc, f_fft, True)


@pytest.mark.cuda
def test_fb_gauss_kernel_in_a_cuda_graph():
    """Captured in a CUDA graph and replayed: two replays give the same
    bits, those of an eager launch; the launch counts once per replay."""
    _need_card()
    from biear_tpu_torch.kernels import (LAUNCHES, count_replay,
                                         recording_launches)
    from biear_tpu_torch.ops import filterbank as fb

    Q, rhs, fc, f_fft = _fb_case(1024, seed=5)
    eager = fb.gauss_contract(Q, rhs, fc, f_fft, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fb.gauss_contract(Q, rhs, fc, f_fft, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with recording_launches() as rec, torch.cuda.graph(graph):
        out = fb.gauss_contract(Q, rhs, fc, f_fft, True)
    assert rec["fb_gauss"] == 1
    replays = []
    LAUNCHES.clear()
    for _ in range(2):
        graph.replay()
        count_replay(rec)
        torch.cuda.synchronize()
        replays.append([x.clone() for x in out])
    assert LAUNCHES["fb_gauss"] == 2
    for a, b, c in zip(eager, *replays):
        assert torch.equal(a, b) and torch.equal(b, c)


@pytest.mark.cuda
def test_train_chunk_on_card_launches_the_kernels():
    """Two fused synthesize -> train steps on the card, captured: one mix
    and one CC launch per step (per replay; the first call adds the
    capture's WARMUP_STEPS eager steps), finite losses, nothing
    skipped."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                      fb_w_dtype="bfloat16")
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(16),
                                mix_dtype="bfloat16")
    model = build_active(cfg, seed=2)
    hp = TrainHyper()
    chunk = make_train_chunk(model, hp, make_optimizer(model, hp),
                             synth.batch_fn(8), 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    LAUNCHES.clear()
    chunk(gen)
    assert LAUNCHES["gather_mix_kb"] == 2 + WARMUP_STEPS
    assert LAUNCHES["cc_lags"] == 2 + WARMUP_STEPS
    LAUNCHES.clear()
    ms = chunk(gen)
    assert LAUNCHES["gather_mix_kb"] == 2 and LAUNCHES["cc_lags"] == 2
    assert bool(torch.isfinite(ms["loss"]).all())
    assert float(ms["skipped"].sum()) == 0.0


@pytest.mark.cuda
def test_auralnet_on_card_launches_the_kernels():
    """AuralNet at full width on the card: one predict through cc_lags.cu
    (against the CPU at the bf16 serving tolerance) and one fused
    synthesize -> train step through gather_mix_kb.cu and cc_lags.cu."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.models import BiEARConfig, build_auralnet
    from biear_tpu_torch.serve.infer import predict
    from biear_tpu_torch.serve.profile_serve import AURALNET
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    cfg = BiEARConfig(**AURALNET, fb_w_dtype="bfloat16")
    model = build_auralnet(cfg, seed=3)
    rng = np.random.default_rng(4)
    wavL, wavR = (rng.uniform(-1, 1, (3, 16000)).astype(np.float32)
                  for _ in range(2))
    LAUNCHES.clear()
    got = predict(model, wavL, wavR)
    # a first call captures predict: WARMUP_STEPS eager runs, one replay
    assert LAUNCHES["cc_lags"] == 1 + WARMUP_STEPS
    for g, w in zip(got, predict(build_auralnet(cfg, seed=3, device="cpu"),
                                 wavL, wavR)):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-2, atol=2e-2)
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(16),
                                mix_dtype="bfloat16")
    hp = TrainHyper()
    chunk = make_train_chunk(model, hp, make_optimizer(model, hp),
                             synth.batch_fn(8), 1)
    LAUNCHES.clear()
    ms = chunk(torch.Generator(device="cuda").manual_seed(0))
    assert LAUNCHES["gather_mix_kb"] == 1 + WARMUP_STEPS
    assert LAUNCHES["cc_lags"] == 1 + WARMUP_STEPS
    assert bool(torch.isfinite(ms["loss"]).all())
    assert float(ms["skipped"].sum()) == 0.0


@pytest.mark.cuda
def test_passive_chunk_on_card_launches_the_kernels():
    """Two fused synthesize -> passive-features -> train steps on the card:
    one mix and one CC launch per step, finite losses, nothing skipped,
    and the features on the card against the CPU port (wrapped phase 1e-3
    rad and magnitude 8.7e-3 dB above -60 dB, tests/test_torch_port_
    passive.py)."""
    _need_card()
    from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.graph import WARMUP_STEPS
    from biear_tpu_torch.models import BiEARConfig, build_passive
    from biear_tpu_torch.ops.features import passive_features
    from biear_tpu_torch.train.loop import make_train_chunk
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    ir, az, dist = make_test_hrir_bank()
    synth = PassiveFeatureSynth(AnechoicSynthesizer(
        ir, az, dist, make_test_segments(16), mix_dtype="bfloat16"))
    model = build_passive(BiEARConfig(), seed=2)
    hp = TrainHyper()
    chunk = make_train_chunk(model, hp, make_optimizer(model, hp),
                             synth.batch_fn(8), 2)
    LAUNCHES.clear()
    ms = chunk(torch.Generator(device="cuda").manual_seed(0))
    assert LAUNCHES["gather_mix_kb"] == 2 + WARMUP_STEPS
    assert LAUNCHES["cc_lags"] == 2 + WARMUP_STEPS
    assert bool(torch.isfinite(ms["loss"]).all())
    assert float(ms["skipped"].sum()) == 0.0
    wav = synth.inner.sample_batch(torch.Generator(device="cuda")
                                   .manual_seed(1), 8)[0]
    mag, ph = (a.cpu() for a in passive_features(wav))
    cmag, cph = passive_features(wav.cpu())
    strong = cmag > -60.0
    assert float((mag - cmag)[strong].abs().max()) <= 8.7e-3
    d = torch.remainder(ph - cph + np.pi, 2 * np.pi) - np.pi
    assert float(d[strong].abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["spirit", "anechoic-long-pool"])
def test_reverb_and_general_paths_on_card(scene):
    """A batch of the spirit scene and of the anechoic general path (a
    1.2 s pool) on the card against the CPU port on the same draws
    (waveforms 2e-5, labels bit for bit); one CC launch per batch and no
    window or mix launch."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            build_synthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.kernels import LAUNCHES

    if scene == "spirit":
        segs = make_test_segments(4)
        card = build_synthesizer("spirit", None, segs, 16000)
        cpu = build_synthesizer("spirit", None, segs, 16000, device="cpu")
    else:
        ir, az, dist = make_test_hrir_bank()
        segs = make_test_segments(4, seg_len=19200)
        card = AnechoicSynthesizer(ir, az, dist, segs)
        cpu = AnechoicSynthesizer(ir, az, dist, segs, device="cpu")
        assert not card.fast and card.n_q == 26
    draws = card.scene_batched(torch.Generator(device="cuda").manual_seed(3),
                               16)
    if scene == "spirit":
        head, active, sectors, speakers, seg_idx, qoff = draws
        got = card.mix(head, active, speakers, seg_idx, qoff)
        want = cpu.mix(*(d.cpu() for d in (head, active, speakers, seg_idx,
                                           qoff)))
        labels = (card.labels_batched(head, active, sectors, speakers),
                  cpu.labels_batched(*(d.cpu() for d in (head, active,
                                                         sectors, speakers))))
    else:
        active, sectors, meas, seg_idx, qoff, crop = draws
        got = card.mix_general(active, meas, seg_idx, qoff, crop)
        want = cpu.mix_general(*(d.cpu() for d in (active, meas, seg_idx,
                                                   qoff, crop)))
        labels = (card.labels_batched(active, sectors, meas),
                  cpu.labels_batched(*(d.cpu() for d in (active, sectors,
                                                         meas))))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-5)
    assert torch.equal(labels[0].cpu(), labels[1])
    LAUNCHES.clear()
    batch = card.sample_batch(torch.Generator(device="cuda").manual_seed(4),
                              16)
    assert LAUNCHES["cc_lags"] == 1 and LAUNCHES["gather_windows"] == 0
    assert LAUNCHES["gather_mix_kb"] == 0
    assert all(bool(torch.isfinite(b).all()) for b in batch)


@pytest.mark.cuda
def test_runner_trains_an_epoch_on_card(tmp_path):
    """train on the card for one 2-step synthesised epoch at a small
    width: the run tree, finite losses, nothing skipped, and both hand-
    written kernels of the f32 path launched (CC and window gather, no
    bf16 mix)."""
    _need_card()
    import json
    from biear_tpu_torch import train_biear
    from biear_tpu_torch.config import load_run_config
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig
    from biear_tpu_torch.train.runner import train

    rc = load_run_config(os.path.join(REPO, "conf", "config.yaml"))
    rc.runs_root, rc.epochs, rc.batch_size = str(tmp_path), 1, 8
    rc.synth_on_device = True
    rc.raw = dict(rc.raw, SYNTH_STEPS_PER_EPOCH=2, SYNTH_EVAL_SAMPLES=16)
    rc.model_cfg = BiEARConfig(n_bands=32, timesteps=5, latent_dim=32,
                               ctrl_hidden=32, deltaQ_mode="relative")
    synth = train_biear.make_synth(rc)
    LAUNCHES.clear()
    out = train(rc, synth=synth, quiet=True, run_id="card")
    run = out["run_dir"]
    for rel in ("meta/settings.json", "logs_json/history.json",
                "logs_json/scalars.jsonl", "logs_json/test_metrics.json",
                "checkpoints/best/params.pth", "checkpoints/last/opt_state.pt"):
        assert os.path.isfile(os.path.join(run, rel)), rel
    with open(os.path.join(run, "logs_json", "history.json")) as f:
        h = json.load(f)
    assert len(h["train"]) == 1 and h["train"][0]["skipped"] == 0
    assert np.isfinite(h["train"][0]["loss"]) and np.isfinite(
        h["val"][0]["loss"])
    assert LAUNCHES["gather_windows"] >= 2 and LAUNCHES["cc_lags"] >= 2
    assert LAUNCHES["gather_mix_kb"] == 0
    assert next(out["model"].parameters()).device.type == "cuda"


@pytest.mark.cuda
def test_split_and_shard_built_on_card(tmp_path):
    """A 256-row anechoic split written on the card (one window gather and
    one CC launch for its one batch), then its active ``.shard`` (one more
    CC launch): 256 wav + npz pairs, and the shard's labels equal the
    split's."""
    _need_card()
    from biear_tpu_torch import generate_binaural_data, precompute_h5
    from biear_tpu_torch.data.shard import ShardDataset
    from biear_tpu_torch.kernels import LAUNCHES

    LAUNCHES.clear()
    y = generate_binaural_data.main(["--out-root", str(tmp_path), "--name",
                                     "s", "--num", "256", "--seed", "3"])
    assert LAUNCHES["gather_windows"] == 1 and LAUNCHES["cc_lags"] == 1
    assert LAUNCHES["gather_mix_kb"] == 0
    assert len(os.listdir(tmp_path / "s")) == 512
    shard = str(tmp_path / "s.shard")
    LAUNCHES.clear()
    precompute_h5.main(["--from-dir", str(tmp_path / "s"), "--out-active",
                        shard])
    assert LAUNCHES["cc_lags"] == 1 and LAUNCHES["gather_windows"] == 0
    rows = ShardDataset(shard).rows(np.arange(256))
    np.testing.assert_array_equal(rows[3], y)
    assert all(np.isfinite(r).all() for r in rows)


def _write_shard_splits(root, fs, n_bands, rows):
    """train / val / test ``.shard`` files of uniform waveforms and CC and
    structurally valid labels, under the names ``data_paths`` gives."""
    from biear_tpu_torch.data.shard import write_shard
    rng = np.random.default_rng(13)
    for name, n in rows.items():
        y = np.zeros((n, 8, 7), np.float32)
        y[:, :, 2] = 1.0
        for b in range(n):
            for s in rng.choice(8, size=rng.integers(1, 4), replace=False):
                y[b, s] = 0.0
                y[b, s, :2] = (1.0, rng.uniform())
                y[b, s, 2 + rng.integers(1, 5)] = 1.0
        write_shard(os.path.join(root, f"anechoic_{name}_active_wav.shard"),
                    [rng.uniform(-1, 1, (n, fs)).astype(np.float32),
                     rng.uniform(-1, 1, (n, fs)).astype(np.float32),
                     rng.uniform(-1, 1, (n, n_bands)).astype(np.float32),
                     y.reshape(n, 56)], ["i16", "i16", "f32", "f32"])


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_runner_trains_an_epoch_on_shard_splits(device, tmp_path,
                                                 monkeypatch):
    """DATA_FORMAT: shard, the dataset path of ``train``: the splits are
    opened from SHARD_ROOT and fed through the prefetcher (pinned host
    memory and side-stream copies on the card), the last train batch
    padded with weight-0 rows (10 rows, batch 4). One epoch: the run tree,
    3 steps, finite losses, nothing skipped."""
    import json
    from biear_tpu_torch.config import load_run_config
    from biear_tpu_torch.models import BiEARConfig
    from biear_tpu_torch.train.runner import train

    if device == "cuda":
        _need_card()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc = load_run_config(os.path.join(REPO, "conf", "config.yaml"))
        rc.runs_root, rc.epochs, rc.batch_size = str(tmp_path / "runs"), 1, 4
        rc.data_format, rc.shard_root = "shard", str(tmp_path)
        rc.model_cfg = BiEARConfig(fs=1600, timesteps=3, n_fft=256,
                                   n_bands=16, fmin=50.0, fmax=700.0,
                                   latent_dim=16, ctrl_hidden=16,
                                   deltaQ_mode="relative")
        _write_shard_splits(str(tmp_path), 1600, 16,
                            {"train": 10, "val": 6, "test1": 6})
        out = train(rc, quiet=True, run_id="shard", device=device)
    finally:
        torch.set_num_threads(threads)
    run = out["run_dir"]
    for rel in ("logs_json/history.json", "logs_json/test_metrics.json",
                "checkpoints/best/params.pth", "checkpoints/last/opt_state.pt"):
        assert os.path.isfile(os.path.join(run, rel)), rel
    with open(os.path.join(run, "logs_json", "history.json")) as f:
        h = json.load(f)
    assert out["global_step"] == 3 and h["train"][0]["skipped"] == 0
    assert all(np.isfinite(h[s][0]["loss"]) for s in ("train", "val"))
    assert np.isfinite(out["test"]["loss"])
    assert next(out["model"].parameters()).device.type == device


@pytest.mark.cuda
def test_prefetcher_copies_batches_to_the_card():
    """The prefetcher's pinned, side-stream copies arrive on the card equal
    to the host batches, in order, padding weights included."""
    _need_card()
    from biear_tpu_torch.data.pipeline import Prefetcher, batch_iterator

    class Mem:
        def __init__(self, a):
            self.a = a

        def __len__(self):
            return len(self.a[0])

        def rows(self, idx):
            return tuple(x[idx] for x in self.a)

    rng = np.random.default_rng(12)
    ds = Mem([rng.standard_normal((37, 16000)).astype(np.float32),
              rng.standard_normal((37, 56)).astype(np.float32)])
    want = list(batch_iterator(ds, 8, shuffle=True))
    pf = Prefetcher(batch_iterator(ds, 8, shuffle=True), "cuda")
    got = []
    for batch in pf:
        got.append([(t * 2.0).cpu() for t in batch])   # used on the main stream
    pf.close()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), 2.0 * b)


@pytest.mark.cuda
def test_predict_on_card_matches_cpu():
    """The served slice on the card against the same weights on the CPU."""
    _need_card()
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve.infer import predict
    from biear_tpu_torch.graph import WARMUP_STEPS

    rng = np.random.default_rng(9)
    wavL, wavR = (rng.uniform(-1, 1, (3, 16000)).astype(np.float32)
                  for _ in range(2))
    for policy, tol in (("float32", 2e-3), ("bfloat16", 2e-2)):
        cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative",
                          deltaQ_base=1.0, deltaQ_low_factor=0.3,
                          deltaQ_high_factor=5.0, fb_w_dtype=policy)
        gpu = build_active(cfg, seed=1)
        cpu = build_active(cfg, seed=1, device="cpu")
        LAUNCHES.clear()
        got = predict(gpu, wavL, wavR)
        # a first call captures predict: WARMUP_STEPS eager runs, a replay
        assert LAUNCHES["cc_lags"] == 1 + WARMUP_STEPS
        for g, w in zip(got, predict(cpu, wavL, wavR)):
            torch.testing.assert_close(g.cpu(), w, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_single_predict_on_card_matches_cpu():
    """The single-controller model served on the card against the same
    weights on the CPU (one CC launch per replay)."""
    _need_card()
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve.infer import predict
    from biear_tpu_torch.graph import WARMUP_STEPS

    rng = np.random.default_rng(10)
    wavL, wavR = (rng.uniform(-1, 1, (3, 16000)).astype(np.float32)
                  for _ in range(2))
    for policy, tol in (("float32", 2e-3), ("bfloat16", 2e-2)):
        cfg = BiEARConfig(controller_mode="single", deltaQ_mode="absolute",
                          deltaQ_base=2.0, deltaQ_low_factor=0.5,
                          deltaQ_high_factor=5.0, fb_w_dtype=policy)
        gpu = build_active(cfg, seed=1)
        cpu = build_active(cfg, seed=1, device="cpu")
        LAUNCHES.clear()
        got = predict(gpu, wavL, wavR)
        # a first call captures predict: WARMUP_STEPS eager runs, a replay
        assert LAUNCHES["cc_lags"] == 1 + WARMUP_STEPS
        for g, w in zip(got, predict(cpu, wavL, wavR)):
            torch.testing.assert_close(g.cpu(), w, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,fixed", [("dual", False), ("single", False),
                                        ("dual", True)])
def test_stream_apply_on_card_matches_forward(mode, fixed):
    """stream_apply on the card against the model's forward on the same
    crop, to 2e-4 (tests/test_streaming.py), f32 with TF32 off; the state
    stays on the card."""
    _need_card()
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.ops.xcorr import cross_correlation_feature
    from biear_tpu_torch.serve.streaming import stream_apply, stream_init

    cfg = BiEARConfig(controller_mode=mode, fixed_frontend_q=fixed,
                      deltaQ_mode="relative")
    model = build_active(cfg, seed=2)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for ctrl in model.bifb.controllers():
            w = ctrl.q_out[8].weight
            w.copy_(0.25 * torch.randn(w.shape, generator=gen).cuda())
    rng = np.random.default_rng(11)
    wavL, wavR = (torch.tensor(rng.uniform(-1, 1, (4, 16000)),
                               dtype=torch.float32, device="cuda")
                  for _ in range(2))
    with torch.inference_mode():
        want = model(wavL, wavR, cross_correlation_feature(wavL, wavR,
                                                           16000))[:3]
    got = stream_apply(model, wavL, wavR)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4)
    assert stream_init(model, 2)["t"].device.type == "cuda"


@pytest.mark.cuda
def test_bench_measure_on_card_at_reduced_windows():
    """bench.measure at full width on the card with one window of one
    chunk and of 2 bare steps: bench.py's keys, the card's name and power
    limit, an MFU, and the mix and CC kernels launched on the fused path."""
    _need_card()
    import ast
    from biear_tpu_torch import bench
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.graph import WARMUP_STEPS

    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    keys = next([k.value for k in n.keys] for n in ast.walk(tree)
                if isinstance(n, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "metric"
                    for k in n.keys))
    LAUNCHES.clear()
    out = bench.measure(batch=64, chunk=2, steps=2, chunk_dispatches=1,
                        windows=1)
    # the warm-up chunk (the capture's WARMUP_STEPS eager steps, then 2
    # replays) and one timed chunk
    assert LAUNCHES["gather_mix_kb"] == 4 + WARMUP_STEPS
    assert LAUNCHES["cc_lags"] == 4 + WARMUP_STEPS
    assert list(out) == keys + ["power_limit", "flops_by_op"]
    assert out["device"] == torch.cuda.get_device_name()
    assert out["power_limit"].endswith("W")
    assert out["sync"] == "torch.cuda.synchronize"
    assert out["value"] > 0 and out["model_step_utt_s"] > 0
    if out["device"] in bench.PEAK_FLOPS:
        assert 0 < out["mfu"] < 1


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_tensorfloat32_flags_inside_a_train_step(device):
    """A train step under "tensorfloat32" runs its unpinned products with
    TF32 on (forward and backward) and the filterbank's with TF32 off;
    the flags are back as they were after the step. (The flags are
    global, so the CPU run checks the same switching.)"""
    if device == "cuda":
        _need_card()
    from biear_tpu_torch.device import matmul_precision
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.ops import filterbank
    from biear_tpu_torch.train.loop import train_step
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer
    from biear_tpu_torch.train.profile_train import fixed_batch

    cfg = BiEARConfig(controller_mode="dual", deltaQ_mode="relative")
    model = build_active(cfg, seed=0, device=device)
    hp = TrainHyper()
    opt = make_optimizer(model, hp)
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    seen = {}

    def note(key):                     # a hook that changes nothing
        return lambda *a: seen.setdefault(key, flags()) and None

    model.body[0].register_forward_hook(note("body"))
    model.body[0].weight.register_hook(note("body_backward"))
    fn = filterbank.FilterbankFn._backward

    def spy(ctx, *g):
        seen.setdefault("filterbank_backward", flags())
        return fn(ctx, *g)

    before = flags()
    filterbank.FilterbankFn._backward = staticmethod(spy)
    try:
        with matmul_precision("tensorfloat32"):
            m = train_step(model, hp, opt, fixed_batch(4, 100, 0, device),
                           torch.Generator(device=device).manual_seed(0))
    finally:
        filterbank.FilterbankFn._backward = staticmethod(fn)
    assert seen == {"body": (True, True), "body_backward": (True, True),
                    "filterbank_backward": (False, False)}
    assert flags() == before
    assert bool(torch.isfinite(m["loss"])) and float(m["skipped"]) == 0.0
