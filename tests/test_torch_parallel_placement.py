"""The port's mesh rules held against the JAX package, in one process (CPU).

  * ``param_placement`` names the same tensors as cut, on the same
    dimension (or head), as JAX's ``param_pspecs`` under the name map of
    ``models/weights.py``, for the active, passive and AuralNet models;
    an unknown top-level module raises under model parallelism
    (tests/test_sharding.py's rule);
  * ``batch_iterator``'s host slices are JAX's ``pad_to_full=True``
    slices bit for bit, with the cases of tests/test_multihost.py;
  * the synthesised rows of a global batch do not depend on how it is
    split: two ranks' rows, concatenated, are the whole batch bit for bit
    (anechoic with noise, auditorium, spirit, passive features);
  * ``config.mesh_shape`` refuses a mesh that does not fit WORLD_SIZE and
    a BATCH_SIZE the data axis does not divide.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
from jax.sharding import PartitionSpec as P

from biear_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from biear_tpu.models.auralnet import init_auralnet
from biear_tpu.models.biear import init_active, init_passive
from biear_tpu.models.config import BiEARConfig as JaxConfig
from biear_tpu.parallel.mesh import param_pspecs

from biear_tpu_torch import config as tcfg
from biear_tpu_torch.data.passive_synth import PassiveFeatureSynth
from biear_tpu_torch.data.pipeline import batch_iterator
from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                        build_synthesizer,
                                        make_test_hrir_bank,
                                        make_test_segments)
from biear_tpu_torch.models import (ActiveBiEAR, AuralNet, BiEARConfig,
                                    PassiveBiEAR)
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.parallel.mesh import Head, Split, param_placement

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(fs=1600, timesteps=3, n_fft=256, n_bands=16, fmin=50.0,
             fmax=700.0, latent_dim=16, ctrl_hidden=16, d_model=32,
             attn_heads=4, attn_layers=2)
FAMILIES = {"active": (init_active, ActiveBiEAR, {}),
            "single": (init_active, ActiveBiEAR,
                       {"controller_mode": "single"}),
            "passive": (init_passive, PassiveBiEAR, {}),
            "auralnet": (init_auralnet, AuralNet,
                         {"fixed_frontend_q": True})}


# ---------------- placement ----------------

def _code(spec, stacked_heads: bool) -> float:
    """A JAX PartitionSpec as a number: 0 replicated, d + 1 cut on
    dimension d, -1 cut on the stacked head axis."""
    if all(a is None for a in spec):
        return 0.0
    if stacked_heads:
        assert tuple(spec)[0] == "model"
        return -1.0
    return float(tuple(spec).index("model") + 1)


def _port_code(placement) -> float:
    if placement is None:
        return 0.0
    if isinstance(placement, Head):
        return -1.0
    return float(placement.dim + 1)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_placement_matches_jax_param_pspecs(family):
    init, cls, over = FAMILIES[family]
    cfg_j, cfg_t = JaxConfig(**SMALL, **over), BiEARConfig(**SMALL, **over)
    params = init(jax.random.PRNGKey(0), cfg_j)
    specs = param_pspecs(params, True)
    codes = {top: jax.tree.map(
        lambda p, s, heads=top == "subheads": np.full(np.shape(p),
                                                      _code(s, heads)),
        params[top], specs[top]) for top in params}
    want = {k: float(v.reshape(-1)[0]) for k, v in
            state_dict_from_jax(codes, cfg_t).items()}
    got = param_placement(cls(cfg_t), True)
    assert set(got) == set(want)
    assert {k: _port_code(v) for k, v in got.items()} == want
    for name, pl in got.items():
        if isinstance(pl, Head):
            assert name.startswith(f"subheads.{pl.index}.")
    cut = {k: v for k, v in got.items() if isinstance(v, Split)}
    assert cut == {"body.0.weight": Split(0), "body.0.bias": Split(0),
                   "body.3.weight": Split(1)}
    assert all(v is None for v in param_placement(cls(cfg_t),
                                                  False).values())


def test_unknown_top_level_module_raises_under_model_parallelism():
    model = ActiveBiEAR(BiEARConfig(**SMALL))
    model.mystery_subsystem = nn.Linear(4, 4)
    with pytest.raises(ValueError, match="mystery_subsystem"):
        param_placement(model, True)
    assert all(v is None for v in param_placement(model, False).values())


# ---------------- host slices ----------------

class _IndexDataset:
    """rows(sel) returns the selected indices themselves."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def rows(self, sel):
        return (np.asarray(sel, np.float32),)


@pytest.mark.parametrize("n,bs,hosts,shuffle,epoch", [
    (1000, 64, 2, True, 5), (1000, 64, 4, True, 5), (997, 32, 2, True, 5),
    (997, 32, 4, True, 5), (130, 32, 2, False, 5), (256, 32, 2, True, 0),
    (256, 32, 2, True, 1), (13, 2, 2, True, 2), (130, 32, 2, True, 2),
    (64, 8, 4, True, 2), (65, 8, 4, True, 2), (3, 4, 4, True, 0)])
def test_host_slices_match_jax_bit_for_bit(n, bs, hosts, shuffle, epoch):
    ds = _IndexDataset(n)
    counts = set()
    for h in range(hosts):
        kw = dict(shuffle=shuffle, seed=3, epoch=epoch, host_id=h,
                  host_count=hosts)
        ours = list(batch_iterator(ds, bs, **kw))
        theirs = list(jax_batch_iterator(ds, bs, pad_to_full=True, **kw))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert len(a) == len(b) == 2
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        counts.add(len(ours))
    assert len(counts) == 1                    # equal everywhere


def test_one_host_is_the_whole_epoch():
    ds = _IndexDataset(70)
    a = list(batch_iterator(ds, 16, shuffle=True, seed=1, epoch=2))
    b = list(batch_iterator(ds, 16, shuffle=True, seed=1, epoch=2,
                            host_id=0, host_count=1))
    assert all(np.array_equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p, q))


# ---------------- synthesised rows ----------------

def _synth(scene: str):
    segs = make_test_segments(6)
    if scene == "anechoic":
        ir, az, dist = make_test_hrir_bank()
        return AnechoicSynthesizer(ir, az, dist, segs, num_lags=16,
                                   noise_snr_db=(5.0, 20.0), device="cpu")
    if scene == "passive":
        return PassiveFeatureSynth(build_synthesizer(
            "anechoic", None, segs, 16000, num_lags=16, device="cpu"),
            data_dim=16, timesteps=5)
    return build_synthesizer(scene, None, segs, 16000, num_lags=16,
                             device="cpu")


@pytest.mark.parametrize("scene", ["anechoic", "auditorium", "spirit",
                                   "passive"])
def test_synthesised_global_batch_does_not_depend_on_the_split(scene):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        synth, B = _synth(scene), 6
        whole = synth.sample_batch(torch.Generator().manual_seed(4), B)
        parts = [synth.sample_batch(torch.Generator().manual_seed(4), B,
                                    rows=r) for r in ((0, 3), (3, 6))]
        fn = synth.batch_fn(B, rows=(3, 6))
        again = fn(torch.Generator().manual_seed(4))
    finally:
        torch.set_num_threads(threads)
    assert len(whole) == len(parts[0])
    for w, a, b, c in zip(whole, *parts, again):
        assert torch.equal(torch.cat([a, b]), w)
        assert torch.equal(c, b)


# ---------------- the mesh of a run config ----------------

def test_mesh_shape_fits_the_world_and_the_batch():
    base = tcfg.load_run_config(os.path.join(REPO, "conf", "config.yaml"))
    shape = lambda world, **kw: tcfg.mesh_shape(
        dataclasses.replace(base, **kw), world)
    assert shape(1) == (1, 1)
    assert shape(4) == (4, 1)
    assert shape(4, mesh_model=2) == (2, 2)
    assert shape(8, mesh_data=4, mesh_model=2) == (4, 2)
    for world, kw in ((1, {"mesh_data": 4}), (1, {"mesh_model": 2}),
                      (4, {"mesh_data": 2}), (6, {"mesh_model": 4}),
                      (4, {"mesh_model": 0})):
        with pytest.raises(ValueError, match="WORLD_SIZE"):
            shape(world, **kw)
    with pytest.raises(ValueError, match="BATCH_SIZE 6"):
        shape(4, batch_size=6)
