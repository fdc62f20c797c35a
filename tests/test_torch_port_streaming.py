"""The port's streaming server held to the port's forward and to JAX's
streaming path (CPU).

The port's cases of tests/test_streaming.py, at its tolerances: a 1 s crop
fed as T hop-chunks plus the residual tail reproduces the forward on the
same crop to 2e-4 with the CC feature (dual, single and fixed-Q; bf16 with
the matmul DFT too), to 2e-6 without it; the streamed CC feature alone
matches the batch feature to 5e-5; a reset slot equals a fresh stream bit
for bit. Against JAX ``stream_apply`` (same weights through
``state_dict_from_jax``) the outputs agree to 2e-4, at a narrow config
with the 100 lags JAX's streaming plan fixes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from biear_tpu.models import BiEARConfig as JaxConfig
from biear_tpu.models.biear import init_active
from biear_tpu.serve import stream_apply as jax_stream_apply

from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig, build_active
from biear_tpu_torch.models.weights import state_dict_from_jax
from biear_tpu_torch.ops.xcorr import cross_correlation_feature
from biear_tpu_torch.serve import streaming as S
from biear_tpu_torch.serve.streaming import (stream_apply, stream_init,
                                             stream_plan, stream_readout,
                                             stream_reset, stream_step)

FS = 16000
FLAGSHIP = dict(deltaQ_mode="relative", deltaQ_base=1.0,
                deltaQ_low_factor=0.3, deltaQ_high_factor=5.0)
MODES = [("dual", False), ("single", False), ("dual", True)]
NARROW = dict(FLAGSHIP, fs=1600, timesteps=4, n_fft=256, n_bands=100,
              fmin=50.0, fmax=700.0, latent_dim=16, ctrl_hidden=16)


def _wavs(rng, B, fs=FS):
    """Ear-correlated noise plus a delayed tone, so CC, ILD and IPD all
    carry signal."""
    t = np.arange(fs) / fs
    base = rng.standard_normal((B, fs)).astype(np.float32)
    tone = np.sin(2 * np.pi * 700.0 * t)[None].astype(np.float32)
    wavL = 0.3 * base + tone * rng.uniform(0.2, 1.0, (B, 1)).astype(np.float32)
    wavR = 0.3 * np.roll(base, 7, axis=1) + 0.8 * np.roll(tone, 11, axis=1)
    return torch.tensor(wavL), torch.tensor(wavR.astype(np.float32))


def _model(mode, fixed, seed=3, **kw):
    """A seeded port model whose controllers' output layers are non-zero,
    so Q moves and the streamed feedback loop is exercised."""
    cfg = BiEARConfig(controller_mode=mode, fixed_frontend_q=fixed,
                      **dict(FLAGSHIP, **kw))
    model = build_active(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for ctrl in model.bifb.controllers():
            w = ctrl.q_out[8].weight
            w.copy_(0.25 * torch.randn(w.shape, generator=gen))
    return model


def _forward(model, wavL, wavR):
    with torch.no_grad():
        x3 = (cross_correlation_feature(wavL, wavR, model.cfg.fs,
                                        num_lags=model.cfg.n_bands)
              if model.cfg.use_cc else None)
        return model(wavL, wavR, x3)[:3]


def _assert_match(got, want, atol):
    for name, g, w in zip(("sound_logits", "aoa", "dist_logits"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("mode,fixed", MODES)
def test_stream_matches_forward(mode, fixed):
    model = _model(mode, fixed)
    wavL, wavR = _wavs(np.random.default_rng(11), B=2)
    _assert_match(stream_apply(model, wavL, wavR),
                  _forward(model, wavL, wavR), atol=2e-4)


def test_stream_matches_forward_bf16_matmul_dft():
    model = _model("dual", False, fb_w_dtype="bfloat16", dft_mode="matmul")
    assert model.cfg.use_dft_matmul
    wavL, wavR = _wavs(np.random.default_rng(13), B=2)
    _assert_match(stream_apply(model, wavL, wavR),
                  _forward(model, wavL, wavR), atol=2e-4)


@pytest.mark.parametrize("mode,fixed", MODES)
def test_stream_matches_jax_stream_apply(mode, fixed):
    kw = dict(NARROW, controller_mode=mode, fixed_frontend_q=fixed)
    cfg_j, cfg_t = JaxConfig(**kw), BiEARConfig(**kw)
    params = init_active(jax.random.PRNGKey(3), cfg_j)
    if not fixed:
        p = params["bifb"]["fb" if mode == "dual" else "ctrl"]
        p["q_out"]["l3"]["w"] = 0.25 * jax.random.normal(
            jax.random.PRNGKey(7), p["q_out"]["l3"]["w"].shape)
    model = ActiveBiEAR(cfg_t)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), cfg_t), strict=True)
    wavL, wavR = _wavs(np.random.default_rng(17), B=3, fs=cfg_t.fs)
    with jax.default_matmul_precision("highest"):
        want = jax_stream_apply(params, cfg_j, jnp.asarray(wavL.numpy()),
                                jnp.asarray(wavR.numpy()))
    got = stream_apply(model, wavL, wavR)
    _assert_match(got, want, atol=2e-4)
    _assert_match(got, _forward(model, wavL, wavR), atol=2e-4)


@pytest.mark.parametrize("mode", ["dual", "single"])
def test_stream_step_by_step_no_cc_is_exact(mode):
    """Without the CC feature the streamed ops are the forward's own, one
    frame at a time: agreement at f32 round-off."""
    model = _model(mode, False, use_cc=False)
    wavL, wavR = _wavs(np.random.default_rng(5), B=2)
    plan = stream_plan(model.cfg)
    hop = plan["hop"]
    state = stream_init(model, 2)
    assert "cc" not in state
    for t in range(model.cfg.timesteps):
        sl = slice(t * hop, (t + 1) * hop)
        state = stream_step(model, state, wavL[:, sl].numpy(),
                            wavR[:, sl].numpy())
    _assert_match(stream_readout(model, state), _forward(model, wavL, wavR),
                  atol=2e-6)


def test_stream_cc_matches_batch_feature():
    """The incremental CC accumulator and its mean-removal correction
    against cross_correlation_feature, over uneven chunks and with
    non-zero means."""
    cfg = BiEARConfig()
    plan = stream_plan(cfg)
    wavL, wavR = _wavs(np.random.default_rng(2), B=4)
    wavL, wavR = wavL + 0.37, wavR - 0.21
    ref = cross_correlation_feature(wavL, wavR, FS)
    K = plan["K"]
    assert K == 48 and plan["win"] == plan["hop"] == 842
    assert plan["tail_len"] == 2
    cc = stream_init(_model("dual", True), 4)["cc"]
    edges = [0, 842, 3000, 3100, 9000, 15998, 16000]
    for a, b in zip(edges[:-1], edges[1:]):
        cc = S._cc_accumulate(cc, wavL[:, a:b], wavR[:, a:b], K)
    np.testing.assert_allclose(S._cc_readout(cc, plan).numpy(), ref.numpy(),
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize("w,S_", [(842, 49), (2, 49), (100, 7), (49, 49)])
def test_lagged_dots_equal_the_shifted_products(w, S_):
    rng = np.random.default_rng(w)
    x = torch.tensor(rng.standard_normal((3, w)), dtype=torch.float64)
    ext = torch.tensor(rng.standard_normal((3, w + S_ - 1)),
                       dtype=torch.float64)
    want = torch.stack([(x * ext[:, s:s + w]).sum(1) for s in range(S_)], 1)
    torch.testing.assert_close(S._lagged_dots(x, ext, S_), want, rtol=1e-12,
                               atol=1e-12)


def test_stream_readout_is_anytime():
    model = _model("single", False)
    hop = stream_plan(model.cfg)["hop"]
    wavL, wavR = _wavs(np.random.default_rng(9), B=2)
    state = stream_init(model, 2)
    for t in range(3):
        sl = slice(t * hop, (t + 1) * hop)
        state = stream_step(model, state, wavL[:, sl], wavR[:, sl])
    sound, aoa, dist = stream_readout(model, state)
    assert sound.shape == (2, 8) and aoa.shape == (2, 8)
    assert dist.shape == (2, 8, 5)
    for x in (sound, aoa, dist):
        assert bool(torch.isfinite(x).all())
    assert state["t"].dtype == torch.int32 and state["t"].tolist() == [3, 3]
    assert state["cc"]["n"].tolist() == [3 * hop] * 2


@pytest.mark.parametrize("mode,fixed", MODES)
def test_stream_reset_slot_equals_fresh_stream(mode, fixed):
    """After stream_reset of slot j mid-stream, slot j's hops and readout
    are bit-identical to a fresh stream fed the same audio, and the other
    slots to a run without the reset."""
    model = _model(mode, fixed)
    hop = stream_plan(model.cfg)["hop"]
    B, j = 3, 1
    wavL, wavR = _wavs(np.random.default_rng(21), B=B)
    wavL2, wavR2 = _wavs(np.random.default_rng(22), B=B)

    def hops(state, wl, wr, n):
        for t in range(n):
            sl = slice(t * hop, (t + 1) * hop)
            state = stream_step(model, state, wl[:, sl], wr[:, sl])
        return state

    pre = hops(stream_init(model, B), wavL, wavR, 4)
    mask = torch.tensor([i == j for i in range(B)])
    reset = stream_reset(model, pre, mask)
    fresh = stream_init(model, B)
    flat = lambda st: [a for v in st.values() for a in
                       (v.values() if isinstance(v, dict)
                        else v if isinstance(v, tuple) else [v])]
    axis = 1 if (mode == "dual" and not fixed) else 0
    for k in reset:
        for r, f, p in zip(flat({k: reset[k]}), flat({k: fresh[k]}),
                           flat({k: pre[k]})):
            sel = lambda a, i: a.select(axis if k == "fe" else 0, i)
            assert torch.equal(sel(r, j), sel(f, j)), k
            for i in range(B):
                if i != j:
                    assert torch.equal(sel(r, i), sel(p, i)), k
    got = stream_readout(model, hops(reset, wavL2, wavR2, 5))
    ref = stream_readout(model, hops(stream_init(model, B), wavL2, wavR2, 5))
    ref_b = stream_readout(model, hops(pre, wavL2, wavR2, 5))
    for g, r, rb in zip(got, ref, ref_b):
        assert torch.equal(g[j], r[j])
        keep = [i for i in range(B) if i != j]
        assert torch.equal(g[keep], rb[keep])


def test_stream_rejects_overlapping_frames():
    with pytest.raises(NotImplementedError, match="hop_ratio"):
        stream_plan(BiEARConfig(hop_ratio=0.5))
