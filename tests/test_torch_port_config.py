"""The port's run config, input pipeline, H5 reader, logger,
``build_synthesizer`` and runner helpers held against the JAX package (CPU).

Each case feeds the same inputs, made from a seed with numpy, to the JAX
function and its port. These are copies, so the results must be equal:
the parsed config of every ``conf/*.yaml``, the settings and experiment
names, the data
paths, the batches' row order, padding and weights, the best-tuple choice,
the epoch metric sums, the JSONL records and the rows read from an H5.

It also holds the runner's resume of a JAX checkpoint for the two
optimizer shapes other than two groups, the fixed-Q bare chain and the
frozen controller (tests/_torch_runner_common.py; the two-group case and
the rest of the runner are in tests/test_torch_port_runner.py, so that
their JAX runs go to different workers): the JAX run's epoch-1 state,
converted, trains epoch 2 as JAX does, losses within 5e-5 and parameters
within 3e-3.
"""

import dataclasses
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from biear_tpu import config as jcfg
from biear_tpu.data import pipeline as jpipe
from biear_tpu.data.h5io import ActiveH5Dataset as JaxH5
from biear_tpu.data.h5io import save_active_h5
from biear_tpu.train import loop as jloop
from biear_tpu.train import runner as jrun
from biear_tpu.utils import logging as jlog

from biear_tpu_torch import config as tcfg
from biear_tpu_torch import train_biear
from biear_tpu_torch.data import h5io as th5
from biear_tpu_torch.data import pipeline as tpipe
from biear_tpu_torch.data import synth as tsynth
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import runner as trun
from biear_tpu_torch.utils import logging as tlog

import _torch_runner_common as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFS = sorted(glob.glob(os.path.join(REPO, "conf", "*.yaml")))
CONF_IDS = [os.path.basename(p)[:-5] for p in CONFS]


# ---------------- YAML and the run config ----------------

def _plain_fields(rc):
    return {f.name: getattr(rc, f.name) for f in dataclasses.fields(rc)
            if f.name not in ("model_cfg", "hyper")}


@pytest.mark.parametrize("path", CONFS, ids=CONF_IDS)
def test_run_config_settings_and_paths_match_jax(path):
    rj, rt = jcfg.load_run_config(path), tcfg.load_run_config(path)
    assert _plain_fields(rt) == _plain_fields(rj)
    assert dataclasses.asdict(rt.model_cfg) == dataclasses.asdict(rj.model_cfg)
    assert dataclasses.asdict(rt.hyper) == dataclasses.asdict(rj.hyper)
    assert tcfg.make_exp_name(rt, "X") == jcfg.make_exp_name(rj, "X")
    assert tcfg.settings_dict(rt, "X", "n") == jcfg.settings_dict(rj, "X", "n")
    assert tcfg.h5_paths(rt) == jcfg.h5_paths(rj)
    assert tcfg.data_paths(rt) == jcfg.data_paths(rj)
    for rc in (rj, rt):
        rc.data_format, rc.shard_root = "shard", "/shards"
    assert tcfg.data_paths(rt) == jcfg.data_paths(rj)


@pytest.mark.parametrize("key,value", [("FB_W_DTYPE", "bf16"),
                                       ("FB_VJP", "jvp"), ("DFT_MODE", "dct"),
                                       ("DATA_FORMAT", "tfrecord")])
def test_eager_validators_refuse_like_jax(tmp_path, key, value):
    text = open(CONFS[0]).read() + f'\n{key}: "{value}"\n'
    p = tmp_path / "c.yaml"
    p.write_text(text)
    with pytest.raises(ValueError, match=key):
        jcfg.load_run_config(str(p))
    with pytest.raises(ValueError, match=key):
        tcfg.load_run_config(str(p))


@pytest.mark.parametrize("name", ["default", "high", "highest", "float32",
                                  "tensorfloat32", "bfloat16", "HIGHEST"])
def test_matmul_precision_maps_to_the_f32_policy(name):
    """Every name of JAX's MATMUL_PRECISION is accepted, lower-cased as
    JAX's apply_matmul_precision returns it; TF32 is on under "high" and
    "tensorfloat32" only ("bfloat16" is CUDA autocast, the rest the f32
    policy); an unknown name raises."""
    import jax
    from biear_tpu_torch.device import check_matmul_precision, matmul_precision
    assert check_matmul_precision(name) == name.lower()
    prev = jax.config.jax_default_matmul_precision
    try:
        assert jcfg.apply_matmul_precision(name) == name.lower()
    finally:
        jax.config.update("jax_default_matmul_precision",
                          prev if prev is not None else "default")
    with matmul_precision(name):
        assert torch.backends.cuda.matmul.allow_tf32 is (
            name.lower() in ("high", "tensorfloat32"))
    with pytest.raises(ValueError, match="MATMUL_PRECISION"):
        check_matmul_precision("fast")


@pytest.mark.parametrize("settings", [
    {}, {"Controller_Mode": "single", "DELTAQ_MODE": "absolute",
         "DELTAQ_BASE": 2.0, "GEOMETRY": {"FB_W_DTYPE": "bfloat16"}},
    {"FIXED_FRONTEND_Q": True, "GEOMETRY": {"N_BANDS": 24, "FS": 1600,
                                            "FMAX": 700.0, "DFT_MODE": "auto"}}],
    ids=["defaults", "single-bf16", "fixed-small"])
def test_settings_walk_and_model_config_match_jax(tmp_path, settings):
    meta = tmp_path / "run" / "meta"
    meta.mkdir(parents=True)
    (meta / "settings.json").write_text(json.dumps(settings))
    ck = str(tmp_path / "run" / "checkpoints" / "best" / "params.pth")
    assert (tcfg.load_settings_near_checkpoint(ck)
            == jcfg.load_settings_near_checkpoint(ck) == settings)
    assert (dataclasses.asdict(tcfg.config_from_settings(settings))
            == dataclasses.asdict(jcfg.config_from_settings(settings)[0]))


# ---------------- input pipeline ----------------

def _mem(n, seed=0):
    rng = np.random.default_rng(seed)
    return C.Mem([rng.standard_normal((n, 5)).astype(np.float32),
                  np.arange(n, dtype=np.float32)])


@pytest.mark.parametrize("n,bs,shuffle", [
    (12, 4, True), (13, 4, True), (13, 4, False), (13, 5, True),
    (3, 8, True)])
def test_batch_iterator_matches_jax(n, bs, shuffle):
    """The JAX iterator with pad_to_full=True, as its runner calls it."""
    ds = _mem(n)
    for epoch in (1, 2):
        kw = dict(shuffle=shuffle, seed=7, epoch=epoch)
        got = list(tpipe.batch_iterator(ds, bs, **kw))
        want = list(jpipe.batch_iterator(ds, bs, pad_to_full=True, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_prefetcher_yields_the_batches_and_raises_the_workers_error():
    ds = _mem(13)
    want = list(tpipe.batch_iterator(ds, 4, shuffle=True))
    pf = tpipe.Prefetcher(tpipe.batch_iterator(ds, 4, shuffle=True), "cpu")
    got = list(pf)
    pf.close()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)

    def broken():
        yield (np.zeros(2, np.float32),)
        raise OSError("disk gone")

    pf = tpipe.Prefetcher(broken(), "cpu")
    assert next(pf)[0].shape == (2,)
    with pytest.raises(OSError, match="disk gone"):
        next(pf)
    pf.close()

    def endless():
        while True:
            yield (np.zeros(2, np.float32),)

    pf = tpipe.Prefetcher(endless(), "cpu")
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_h5_reader_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    n = 7
    arrays = dict(x1=rng.uniform(-1, 1, (n, 160)), x2=rng.uniform(-1, 1, (n, 160)),
                  x3=rng.uniform(-1, 1, (n, 16)), y=rng.uniform(0, 1, (n, 56)))
    path = str(tmp_path / "s.h5")
    save_active_h5(path, **arrays)
    idx = np.array([5, 1, 1, 6, 0])
    for preload in (True, False):
        t, j = th5.ActiveH5Dataset(path, preload), JaxH5(path, preload)
        assert len(t) == len(j) == n
        for a, b in zip(t.rows(idx), j.rows(idx)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        t.close()
        j.close()
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="DATA_FORMAT: shard.*|h5_to_shard"):
        th5.ActiveH5Dataset(path)


# ---------------- runner helpers ----------------

def test_is_better_tuple_matches_jax():
    rng = np.random.default_rng(4)
    vals = [0.25, 0.5, 0.5 + 5e-13, 0.75]
    for _ in range(400):
        curr = tuple(float(rng.choice(vals)) for _ in range(3))
        best = (None if rng.uniform() < 0.1
                else tuple(float(rng.choice(vals)) for _ in range(3)))
        assert tloop.is_better_tuple(curr, best) == jloop.is_better_tuple(
            curr, best), (curr, best)


@pytest.mark.parametrize("stacked", [False, True], ids=["steps", "chunks"])
def test_accumulate_and_finalize_match_jax(stacked):
    import jax.numpy as jnp
    rng = np.random.default_rng(5 + stacked)
    sj, st = {}, {}
    for i in range(5):
        shape = (3,) if stacked else ()
        m = {k: rng.uniform(0, 1, shape).astype(np.float32)
             for k in ("loss", "sound_acc", "aoa_mae", "dist_acc")}
        m["skipped"] = (rng.uniform(0, 1, shape) < 0.2).astype(np.float32)
        if i == 2:
            m["loss"] = np.full(shape, np.nan, np.float32)
        if i == 4:
            del m["skipped"]                 # eval metrics have none
        bs = 4 if i % 2 else float(rng.integers(1, 5))
        sj = jrun._accumulate(sj, {k: jnp.asarray(v) for k, v in m.items()},
                              jnp.float32(bs))
        st = trun._accumulate(st, {k: torch.tensor(v) for k, v in m.items()},
                              torch.tensor(bs, dtype=torch.float32))
    got, want = trun._finalize(st), jrun._finalize(sj)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7), k
    assert trun._finalize({}).keys() == jrun._finalize({}).keys()


@pytest.mark.parametrize("steps,cfg", [(128, -1), (8, -1), (7, -1),
                                       (257, -1), (1000, -1), (8, 4),
                                       (3, 16), (8, 1), (8, 0), (1, -1)])
def test_synth_chunk_rule_matches_jax(steps, cfg):
    # the JAX runner's rule, runner.py:508-518; its per-step path (a chunk
    # of 0 or 1) is a chunk of one in the port
    if cfg < 0:
        want = max((d for d in range(2, min(128, steps) + 1)
                    if steps % d == 0), default=min(128, steps))
        want = 128 if want < 16 and steps > 128 else want
    else:
        want = min(cfg, steps)
    assert trun.synth_chunk_steps(steps, cfg) == max(1, want)


def test_metric_logger_writes_jaxs_records(tmp_path):
    rng = np.random.default_rng(6)
    edges = tloop.GRAD_HIST_EDGES
    hist = {"a.weight": rng.integers(0, 9, len(edges) + 1),
            "b.bias": rng.integers(0, 9, len(edges) + 1)}
    lines = []
    for name, mod in (("t", tlog), ("j", jlog)):
        lg = mod.MetricLogger(str(tmp_path / name), None)
        lg.scalars("train_step", {"loss": np.float32(0.5), "x": 2}, 3)
        lg.histograms("grads", hist, edges, 3)
        lg.close()
        recs = [json.loads(s) for s in
                open(tmp_path / name / "scalars.jsonl").read().splitlines()]
        for r in recs:
            r.pop("t")
        lines.append(recs)
    assert lines[0] == lines[1]


def test_refused_configs_name_their_roadmap_items():
    base = tcfg.load_run_config(CONFS[0])
    # a mesh larger than the world of one process raises, naming WORLD_SIZE
    for kw in ({"mesh_data": 4}, {"mesh_model": 2}):
        rc = dataclasses.replace(base, **kw)
        with pytest.raises(ValueError, match="WORLD_SIZE 1"):
            trun.check_supported(rc)
    assert trun.check_supported(base) == (1, 1)
    # AuralNet, once refused, is ported
    trun.check_supported(dataclasses.replace(base, model_kind="auralnet"))
    # every MATMUL_PRECISION name, once reduced ones were refused, runs;
    # an unknown one is refused
    trun.check_supported(dataclasses.replace(base,
                                             matmul_precision="bfloat16"))
    with pytest.raises(ValueError, match="MATMUL_PRECISION"):
        trun.check_supported(dataclasses.replace(base,
                                                 matmul_precision="fast"))
    passive = dataclasses.replace(base, model_kind="passive", active=False)
    trun.check_supported(passive)
    assert tcfg.is_passive(passive) and not tcfg.is_passive(base)
    for settings, want in (({}, False), ({"Active": False}, True),
                           ({"MODEL_KIND": "passive"}, True),
                           ({"MODEL_KIND": "auralnet"}, False)):
        assert tcfg.is_passive(settings) == want, settings


# ---------------- the synthesizer of the run config ----------------

def test_build_synthesizer_anechoic_and_refusals():
    """The anechoic scene over the built-in bank; the reverberant scenes,
    once refused, now build over their built-in banks with their speaker
    geometry (their banks against JAX's: tests/test_torch_port_reverb.py);
    an unknown scene is refused."""
    from biear_tpu.data import synth as jsynth
    from biear_tpu_torch.data.synth_reverb import ReverbSynthesizer
    segs = tsynth.make_test_segments(4)
    sy = tsynth.build_synthesizer("anechoic", None, segs, 16000,
                                  num_lags=24, device="cpu")
    ir, az, dist = jsynth.make_test_hrir_bank()
    ref = tsynth.AnechoicSynthesizer(ir, az, dist, segs, num_lags=24,
                                     device="cpu")
    assert sy.mix_dtype == "float32" and sy.num_lags == 24
    for k in ref.bank:
        torch.testing.assert_close(sy.bank[k], ref.bank[k], rtol=0, atol=0)
    for scene, n_speakers in (("auditorium", 6), ("spirit", 3)):
        rs = tsynth.build_synthesizer(scene, None, segs, 16000, num_lags=24,
                                      device="cpu")
        assert isinstance(rs, ReverbSynthesizer)
        assert (rs.n_speakers, rs.num_lags, rs.fs) == (n_speakers, 24, 16000)
    with pytest.raises(ValueError, match="unknown room scene"):
        tsynth.build_synthesizer("garden", None, segs, 16000, device="cpu")


def test_sofa_loader_matches_the_tool(tmp_path):
    import h5py
    sys.path.insert(0, REPO)
    from tools.sofa_io import load_sofa_hrir as tool_load
    rng = np.random.default_rng(8)
    path = str(tmp_path / "h.sofa")
    with h5py.File(path, "w") as f:
        f["Data.IR"] = rng.standard_normal((6, 2, 96))
        f["Data.SamplingRate"] = np.array([48000.0])
        f["SourcePosition"] = np.stack([np.arange(6) * 70.0 - 30.0,
                                        np.zeros(6), np.full(6, 1.5)], 1)
    for a, b in zip(tsynth.load_sofa_hrir(path, 16000),
                    tool_load(path, 16000)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_make_synth_reads_the_run_config(tmp_path, capsys):
    rc = tcfg.load_run_config(CONFS[0])
    segs = tsynth.make_test_segments(3, seed=4)
    np.save(tmp_path / "pool.npy", segs)
    rc.raw = dict(rc.raw, SOFA_FILE=str(tmp_path / "missing.sofa"),
                  SEGMENT_POOL=str(tmp_path / "pool.npy"))
    rc.model_cfg = dataclasses.replace(rc.model_cfg, n_bands=16)
    sy = train_biear.make_synth(rc, "cpu")
    assert "not found; using the built-in anechoic test bank" in \
        capsys.readouterr().out
    assert sy.num_lags == 16 and sy.bank["segments"].shape[0] == 3
    rc.raw = dict(rc.raw, SCENE="room")
    sy = train_biear.make_synth(rc, "cpu")
    assert "using the built-in auditorium test bank" in \
        capsys.readouterr().out
    assert type(sy).__name__ == "ReverbSynthesizer" and sy.n_speakers == 6
    rc.active, rc.model_kind = False, "passive"
    sy = train_biear.make_synth(rc, "cpu")
    assert type(sy).__name__ == "PassiveFeatureSynth"
    assert sy.inner.n_speakers == 6 and sy.timesteps == rc.model_cfg.timesteps


def test_synth_eval_split_thirds_and_spill():
    """The test split's batches keep to its source-count thirds (14 rows,
    batch 4: 4 | 4 | 4 + 2), and a split spilled to host memory yields the
    same batches, bit for bit, as one kept on the device."""
    sy = tsynth.build_synthesizer("anechoic", None,
                                  tsynth.make_test_segments(4), 16000,
                                  num_lags=24, device="cpu")
    kept = trun.SynthEvalDataset(sy, 14, 3, 4, test_thirds=True,
                                 keep_on_device=True)
    spilled = trun.SynthEvalDataset(sy, 14, 3, 4, test_thirds=True,
                                    keep_on_device=False)
    assert len(kept) == len(spilled) == 14
    got = list(spilled.device_batches())
    want = list(kept.device_batches())
    assert [b[0].shape[0] for b in want] == [4, 4, 4, 2]
    n_src = [b[3].reshape(b[3].shape[0], 8, 7)[..., 0].sum(-1) for b in want]
    assert [sorted(set(n.tolist())) for n in n_src] == [[1], [2], [3], [3]]
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# ---------------- a JAX run resumed in the port: the other shapes ----------

OTHER_SHAPES = ["fixed-q", "frozen"]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    with C.small_cpu():
        root = tmp_path_factory.mktemp("jax_runs")
        yield {shape: C.jax_run(shape, root) for shape in OTHER_SHAPES}


@pytest.mark.parametrize("shape", OTHER_SHAPES)
def test_adam_state_from_optax_reads_the_other_shapes(jax_runs, shape):
    C.check_adam_conversion(shape, jax_runs[shape])


@pytest.mark.parametrize("shape", OTHER_SHAPES)
def test_port_resumes_a_jax_checkpoint_of_the_other_shapes(jax_runs, shape,
                                                           tmp_path):
    with C.small_cpu():
        C.check_port_resume(shape, jax_runs[shape], tmp_path)
