"""The port's checkpoint evaluator and shard reader held against the JAX
package (CPU).

The metric functions are numpy copies and must agree exactly. The
``.shard`` reader must read what JAX ``write_shard`` writes (f32 and i16
fields) as the native loader does, and write the same bytes. ``evaluate``
on a 64-row shard must reproduce JAX ``evaluate`` on the same shard:
predictions equal row by row, except rows whose sound logit or
distance-argmax margin lies within the forward's tolerance of a decision
boundary; at most one such row may differ. With seeded weights that
tolerance is the forward's 2e-2 (the checkpoint's bf16 policy, as in
tests/test_torch_port_model.py) and MAE agrees to 1e-4. For
docs/protocol_r3/singlectrl/best.pth it is JAX's own spread under
rounding-level input noise where that is larger, and MAE agrees to 1e-4
or 3x JAX's own change. The passive family (docs/protocol_r3/passive/
best.pth on a 6-field shard of features) is held to the seeded weights'
limits.
"""

import json
import os

import numpy as np
import pytest
import torch

from biear_tpu.config import config_from_settings as jax_config
from biear_tpu.data.native_loader import ShardDataset as JaxShardDataset
from biear_tpu.data.native_loader import write_shard as jax_write_shard
from biear_tpu.train import evaluate as jev
from biear_tpu.utils import torch_import as ti

from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
from biear_tpu_torch.data.pipeline import batch_iterator
from biear_tpu_torch.data.shard import ShardDataset, write_shard
from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                        make_test_hrir_bank,
                                        make_test_segments)
from biear_tpu_torch.models import BiEARConfig, build_active
from biear_tpu_torch.train import evaluate as tev

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "docs", "protocol_r3", "singlectrl", "best.pth")
FWD_TOL = 2e-2
WITNESS_FACTOR = 3.0     # as chip_smoke.py's train-step witness
ROWS = 64


def _fake_y(rng, n):
    y = np.zeros((n, 8, 7), np.float32)
    y[:, :, 2] = 1.0
    for b in range(n):
        for s in rng.choice(8, size=rng.integers(1, 4), replace=False):
            y[b, s, :2] = (1.0, rng.uniform())
            y[b, s, 2:] = 0.0
            y[b, s, 2 + rng.integers(1, 5)] = 1.0
    return y.reshape(n, 56)


# ---------------- metrics ----------------

def test_metric_functions_match_jax_exactly():
    rng = np.random.default_rng(0)
    n = 300
    y = _fake_y(rng, n)
    s = rng.standard_normal((n, 8)).astype(np.float32) * 3
    a = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    d = rng.standard_normal((n, 8, 5)).astype(np.float32)
    for g, w in zip(tev.extract_gt_arrays(y), jev.extract_gt_arrays(y)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tev.extract_pred_arrays(s, a, d),
                    jev.extract_pred_arrays(s, a, d)):
        np.testing.assert_array_equal(g, w)
    args_t = (*tev.extract_gt_arrays(y), *tev.extract_pred_arrays(s, a, d))
    sg, an, ad, dg = args_t[:4]
    sp, ap, apd, dp = args_t[4:]
    want = jev.compute_metrics_like_train(sg, sp, an, ap, dg, dp, ad, apd)
    got = tev.compute_metrics_like_train(sg, sp, an, ap, dg, dp, ad, apd)
    assert got == want
    assert got["aoa_masked_sectors"] > 0
    assert (tev.compute_metrics_like_train(sg, sp, an, ap, dg, dp)
            == jev.compute_metrics_like_train(sg, sp, an, ap, dg, dp))
    split = tev.metrics_from_predictions(s, a, d, y)
    assert set(split) == {"overall", "1spk", "2spk", "3spk"}
    assert split["overall"] == want


def test_padded_batches_drop_nothing_and_pad_with_weight_zero():
    class DS:
        def __len__(self):
            return 10

        def rows(self, idx):
            return (np.asarray(idx, np.float32)[:, None],)

    got = list(batch_iterator(DS(), 4, shuffle=False))
    assert [len(b[0]) for b in got] == [4, 4, 4]
    np.testing.assert_array_equal(got[-1][0][:, 0], [8, 9, 8, 9])
    np.testing.assert_array_equal(got[-1][1], [1, 1, 0, 0])


# ---------------- shards ----------------

@pytest.mark.parametrize("dtypes", [["f32", "f32"], ["i16", "f32"]])
def test_shard_reader_reads_jax_write_shard(tmp_path, dtypes):
    rng = np.random.default_rng(1)
    arrays = [rng.uniform(-1, 1, (9, 3, 5)).astype(np.float32),
              rng.standard_normal((9, 4)).astype(np.float32)]
    p_jax, p_port = str(tmp_path / "j.shard"), str(tmp_path / "t.shard")
    jax_write_shard(p_jax, arrays, dtypes)
    write_shard(p_port, arrays, dtypes)
    assert open(p_jax, "rb").read() == open(p_port, "rb").read()
    idx = [4, 0, 8, 8, 2, 11, -1]
    shapes = [(3, 5), (4,)]
    got = ShardDataset(p_jax, shapes=shapes).rows(idx)
    want = JaxShardDataset(p_jax, shapes=shapes).rows(idx)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert len(ShardDataset(p_jax)) == 9
    flat = ShardDataset(p_jax).rows([1])[0]
    assert flat.shape == (1, 15)
    with pytest.raises(ValueError, match="geometry"):
        ShardDataset(p_jax, shapes=[(3, 4), (4,)])
    with pytest.raises(ValueError, match="fields"):
        ShardDataset(p_jax, shapes=[(15,)])


def test_shard_reader_refuses_other_files(tmp_path):
    p = tmp_path / "x.shard"
    p.write_bytes(b"\0" * 40)
    with pytest.raises(ValueError, match="shard"):
        ShardDataset(str(p))


# ---------------- evaluate ----------------

def _settings():
    with open(os.path.join(os.path.dirname(CKPT), "settings.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def test_shard(tmp_path_factory):
    """64 rows of the model tests' inputs (uniform waveforms in each ear,
    stored as int16, and a uniform CC feature) with random 1-3 source
    labels."""
    rng = np.random.default_rng(0)
    wav = rng.uniform(-1, 1, (2, ROWS, 16000)).astype(np.float32)
    x3 = rng.uniform(-1, 1, (ROWS, 100)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("shard") / "test.shard")
    write_shard(path, [wav[0], wav[1], x3, _fake_y(rng, ROWS)],
                ["i16", "i16", "f32", "f32"])
    return path


class _Jittered:
    """A dataset whose waveforms carry relative noise of `rel` rms."""

    def __init__(self, ds, rel: float, seed: int):
        self.ds, self.rel = ds, rel
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.ds)

    def rows(self, idx):
        r = list(self.ds.rows(idx))
        for i in (0, 1):
            noise = 1 + self.rel * self.rng.standard_normal(r[i].shape)
            r[i] = (r[i] * noise).astype(np.float32)
        return tuple(r)


def _row_spread(a, b):
    """Largest change of a row's sound or distance logits."""
    return np.maximum(np.abs(a[0] - b[0]).max(1),
                      np.abs(a[2] - b[2]).max((1, 2)))


def _flips(got, want, tol):
    """Per (row, sector) prediction changes, presence then distance, and
    whether each lies near its boundary in `want`: a presence logit within
    tol (per row) of 0, a distance top-2 margin within 2 tol."""
    top2 = np.sort(want[2], axis=-1)[..., -2:]
    flip = np.concatenate([(got[0] > 0) != (want[0] > 0),
                           got[2].argmax(-1) != want[2].argmax(-1)], 1)
    near = np.concatenate([np.abs(want[0]) <= tol[:, None],
                           top2[..., 1] - top2[..., 0] <= 2 * tol[:, None]],
                          1)
    return flip, near


def _check_against_jax(got, want, tol, got_metrics, j_metrics, mae_tol):
    """Predictions equal row by row except near-boundary ones (at most one
    row); over all rows the accuracies of the two evaluate runs differ by
    no more than the flipped presence / distance decisions; MAE within
    mae_tol[split]."""
    flip, near = _flips(got, want, tol)
    assert not (flip & ~near).any(), np.nonzero(flip & ~near)
    assert flip.any(1).sum() <= 1, flip.any(1).sum()
    n_el = got[0].size
    for k, f in (("sound_acc", flip[:, :8]), ("dist_acc", flip[:, 8:])):
        d = abs(got_metrics["overall"][k] - j_metrics["overall"][k]) * n_el
        assert round(d) <= f.sum(), (k, d, f.sum())
    assert set(got_metrics) == set(j_metrics) == {"overall", "1spk", "2spk",
                                                  "3spk"}
    for split in j_metrics:
        assert abs(got_metrics[split]["aoa_mae"]
                   - j_metrics[split]["aoa_mae"]) <= mae_tol[split], split


def test_evaluate_seeded_weights_match_jax(test_shard, tmp_path):
    """Seeded weights at the checkpoint's geometry and bf16 policy, the
    controller's output layer perturbed so Q moves, saved as a .pth that
    both sides evaluate: predictions equal except at most one row within
    the forward's 2e-2 of a boundary, MAE to 1e-4."""
    settings = _settings()
    model = build_active(tev.config_from_settings(settings), seed=4,
                         device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for ctrl in model.bifb.controllers():
            for p in (ctrl.q_out[8].weight, ctrl.q_out[8].bias):
                p.copy_(torch.rand(p.shape, generator=gen) * 0.1 - 0.05)
    ckpt = str(tmp_path / "best.pth")
    torch.save(model.state_dict(), ckpt)
    cfg_j = jax_config(settings)[0]
    shapes = [(16000,), (16000,), (100,), (56,)]
    jds = JaxShardDataset(test_shard, shapes=shapes)
    params = ti.import_active(ti.load_state_dict(ckpt), cfg_j)
    want = jev._collect_predictions(params, cfg_j, jds, 32, True, "active")
    j_all = jev.evaluate(ckpt, dataset=jds, batch_size=32, settings=settings,
                         out_path=str(tmp_path / "j.json"), quiet=True)
    got_metrics = tev.evaluate(ckpt, settings=settings, test_shard=test_shard,
                               batch_size=48,
                               out_path=str(tmp_path / "t.json"),
                               device="cpu")
    got = tev.collect_predictions(model, ShardDataset(test_shard, shapes), 48)
    np.testing.assert_array_equal(got[3], want[3])
    assert _row_spread(got, want).max() <= FWD_TOL
    _check_against_jax(got, want, np.full(ROWS, FWD_TOL), got_metrics, j_all,
                       dict.fromkeys(j_all, 1e-4))


def test_evaluate_reference_checkpoint_matches_jax(test_shard, tmp_path):
    """The trained checkpoint's forward is ill-conditioned at the rounding
    level: JAX's own logits move by up to ~0.6 under relative waveform
    noise of 1e-6 (the phase of bands whose |Z| is near zero feeds the
    IPD encoder), so the forward's 2e-2 does not bound two
    implementations here (the seeded case above holds it). The witness is
    that spread: per row, the decision boundary tolerance is max(2e-2,
    JAX's own spread); the port may not differ from JAX by more than JAX
    differs from itself, and MAE agrees to max(1e-4, WITNESS_FACTOR x
    JAX's own MAE change)."""
    settings = _settings()
    cfg_j = jax_config(settings)[0]
    shapes = [(16000,), (16000,), (100,), (56,)]
    params = ti.import_active(ti.load_state_dict(CKPT), cfg_j)
    jds = JaxShardDataset(test_shard, shapes=shapes)
    want = jev._collect_predictions(params, cfg_j, jds, 32, True, "active")
    wit = jev._collect_predictions(params, cfg_j, _Jittered(jds, 1e-6, 5),
                                   32, True, "active")
    out_path = str(tmp_path / "metrics.json")
    got_metrics = tev.evaluate(CKPT, test_shard=test_shard, batch_size=48,
                               out_path=out_path, device="cpu")
    assert json.load(open(out_path)) == json.loads(json.dumps(got_metrics))
    model = tev.load_model(CKPT, tev.config_from_settings(settings), "cpu")
    got = tev.collect_predictions(model, ShardDataset(test_shard, shapes),
                                  48)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[0].shape == (ROWS, 8) and got[2].shape == (ROWS, 8, 5)

    spread = _row_spread(wit, want)
    assert _row_spread(got, want).max() <= spread.max()
    j_all = jev.evaluate(CKPT, dataset=jds, batch_size=32, settings=settings,
                         out_path=str(tmp_path / "j.json"), quiet=True)
    j_wit = tev.metrics_from_predictions(*wit)
    mae_tol = {split: max(1e-4, WITNESS_FACTOR * abs(
        j_wit[split]["aoa_mae"] - j_all[split]["aoa_mae"]))
        for split in j_all}
    _check_against_jax(got, want, np.maximum(FWD_TOL, spread), got_metrics,
                       j_all, mae_tol)


def test_evaluate_cli_on_the_cpu(tmp_path, capsys):
    """A small run laid out like docs/protocol_r3/*/ (settings.json beside
    the checkpoint), through the CLI on the CPU."""
    geom = {"FS": 1600, "TIMESTEPS": 4, "N_FFT": 256, "N_BANDS": 24,
            "FMAX": 700.0, "LATENT_DIM": 16}
    settings = {"Active": True, "Controller_Mode": "single",
                "DELTAQ_MODE": "absolute", "DELTAQ_BASE": 2.0,
                "DELTAQ_LOW_FACTOR": 0.5, "DELTAQ_HIGH_FACTOR": 5.0,
                "GEOMETRY": geom}
    cfg = tev.config_from_settings(settings)
    assert cfg.controller_mode == "single" and cfg.n_bands == 24
    model = build_active(cfg, seed=2, device="cpu")
    run = tmp_path / "run"
    run.mkdir()
    torch.save(model.state_dict(), run / "best.pth")
    (run / "settings.json").write_text(json.dumps(settings))
    rng = np.random.default_rng(3)
    n = 5
    shard = str(tmp_path / "t.shard")
    write_shard(shard, [rng.uniform(-1, 1, (n, 1600)).astype(np.float32),
                        rng.uniform(-1, 1, (n, 1600)).astype(np.float32),
                        rng.uniform(-1, 1, (n, 24)).astype(np.float32),
                        _fake_y(rng, n)])
    out = str(tmp_path / "m.json")
    tev.main(["--checkpoint", str(run / "best.pth"), "--test-shard", shard,
              "--device", "cpu", "--batch-size", "2", "--out", out])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.load(open(out))
    direct = tev.metrics_from_predictions(*tev.collect_predictions(
        model, ShardDataset(shard, [(1600,), (1600,), (24,), (56,)]), 2))
    assert printed == json.loads(json.dumps(direct))


PASSIVE_CKPT = os.path.join(REPO, "docs", "protocol_r3", "passive",
                            "best.pth")


@pytest.fixture(scope="module")
def passive_shard(tmp_path_factory):
    """ROWS rows of passive features made on the CPU port from synthesised
    mixtures (1-3 sources, their labels), as a 6-field .shard."""
    ir, az, dist = make_test_hrir_bank()
    synth = PassiveFeatureSynth(AnechoicSynthesizer(
        ir, az, dist, make_test_segments(8), device="cpu"))
    batch = synth.sample_batch(torch.Generator().manual_seed(2), ROWS)
    path = str(tmp_path_factory.mktemp("pshard") / "test.shard")
    write_shard(path, [b.numpy() for b in batch])
    return path


@pytest.mark.parametrize("settings", [
    {"Active": False}, {"MODEL_KIND": "auralnet"}, {"MODEL_KIND": "passive"}])
def test_evaluate_refuses_the_unported_families(settings, passive_shard,
                                                 tmp_path):
    """The archived AuralNet checkpoint, docs/protocol_r3/auralnet/best.pth,
    holds no attention weights: evaluate refuses it and names the first
    missing key, as JAX's import_auralnet does. Either passive marker
    (Active false, or MODEL_KIND passive) evaluates
    docs/protocol_r3/passive/best.pth on a 6-field shard as JAX evaluate
    does (its settings: Active false, MODEL_KIND passive): predictions
    equal except at most one row within the forward's 2e-2 of a boundary,
    MAE to 1e-4, as for seeded weights above."""
    if settings.get("MODEL_KIND") == "auralnet":
        ckpt = os.path.join(REPO, "docs", "protocol_r3", "auralnet",
                            "best.pth")
        with open(os.path.join(os.path.dirname(ckpt), "settings.json")) as f:
            a_settings = json.load(f)
        key = "attn_L.encoder.layers.0.self_attn.in_proj_weight"
        with pytest.raises(KeyError, match=key):
            ti.import_auralnet(ti.load_state_dict(ckpt),
                               jax_config(a_settings)[0])
        with pytest.raises(RuntimeError, match=key):
            tev.evaluate(ckpt, settings=a_settings, test_shard="x.shard",
                         device="cpu")
        return
    j_settings = {"Active": False, "MODEL_KIND": "passive"}
    cfg_j = jax_config(j_settings)[0]
    tb = (cfg_j.timesteps, cfg_j.n_bands)
    shapes = [tb, tb, (cfg_j.n_bands,), tb, tb, (56,)]
    jds = JaxShardDataset(passive_shard, shapes=shapes)
    params = ti.import_passive(ti.load_state_dict(PASSIVE_CKPT), cfg_j)
    want = jev._collect_predictions(params, cfg_j, jds, 32, False, "passive")
    j_all = jev.evaluate(PASSIVE_CKPT, dataset=jds, batch_size=32,
                         settings=j_settings,
                         out_path=str(tmp_path / "j.json"), quiet=True)
    got_metrics = tev.evaluate(PASSIVE_CKPT, settings=settings,
                               test_shard=passive_shard, batch_size=48,
                               out_path=str(tmp_path / "t.json"),
                               device="cpu")
    model = tev.load_model(PASSIVE_CKPT, tev.config_from_settings(settings),
                           "cpu", kind="passive")
    got = tev.collect_predictions(model, ShardDataset(passive_shard, shapes),
                                  48)
    np.testing.assert_array_equal(got[3], want[3])
    assert _row_spread(got, want).max() <= FWD_TOL
    _check_against_jax(got, want, np.full(ROWS, FWD_TOL), got_metrics, j_all,
                       dict.fromkeys(j_all, 1e-4))
