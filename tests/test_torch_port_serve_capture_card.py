"""The captured inference programs on the card, against their eager paths.

Needs an NVIDIA GPU: every test is marked ``cuda`` and skips without one.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_port_serve_capture_card.py

``predict``, ``stream_step``, ``make_eval_step`` / ``make_eval_chunk`` and
``eval_forward`` replay CUDA graphs on the card by default; here each is
held against ``capture=False`` from one state: outputs within
CAPTURE_WITNESS times the spread of two eager runs (bit for bit where the
two eager runs agree). ``cc_lags`` counts one launch per ``predict``
replay (WARMUP_STEPS more on the first call), a new MATMUL_PRECISION
captures a new graph, a held stream state is unchanged by later hops, and
an eval graph reads the parameters a captured train chunk updated in
place. A stacked split is held on the card once: the eval chunk reads it
in place. ``chip_smoke.py`` phase 19 runs the same checks at full width.
"""

import pytest
import torch

CAPTURE_WITNESS = 3.0   # chip_smoke.py's


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the captured path runs only there")


def _model(**kw):
    from biear_tpu_torch.models import BiEARConfig, build_active
    from biear_tpu_torch.serve.profile_serve import GEOMETRY
    cfg = BiEARConfig(**GEOMETRY["dual"], fb_w_dtype="bfloat16", n_bands=32,
                      latent_dim=32, ctrl_hidden=32, **kw)
    model = build_active(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        for ctrl in model.bifb.controllers():
            w = ctrl.q_out[8].weight
            w.copy_(0.1 * torch.rand(w.shape, generator=gen,
                                     device="cuda") - 0.05)
    return model


def _max_abs(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def _within_witness(got, eager, witness):
    return _max_abs(got, eager) <= CAPTURE_WITNESS * _max_abs(witness, eager)


@pytest.mark.cuda
def test_captured_predict_matches_eager_on_card():
    _need_card()
    from biear_tpu_torch.device import matmul_precision
    from biear_tpu_torch.kernels import LAUNCHES
    from biear_tpu_torch.serve.infer import predict
    from biear_tpu_torch.graph import WARMUP_STEPS

    model = _model()
    gen = torch.Generator(device="cuda").manual_seed(2)
    wl, wr = (torch.rand((8, 16000), generator=gen, device="cuda") * 2 - 1
              for _ in range(2))
    eager = predict(model, wl, wr, capture=False)
    witness = predict(model, wl.cpu().numpy(), wr.cpu().numpy(),
                      capture=False)
    LAUNCHES.clear()
    first = predict(model, wl.cpu().numpy(), wr.cpu().numpy())
    again = predict(model, wl, wr)
    torch.cuda.synchronize()
    assert LAUNCHES["cc_lags"] == 2 + WARMUP_STEPS
    for got in (first, again):
        assert _within_witness(got, eager, witness)
    fwd = model.__dict__["_captured_forwards"]["predict"]
    assert len(fwd.graphs) == 1
    with matmul_precision("bfloat16"):
        bf16 = predict(model, wl, wr)
        bf16_eager = predict(model, wl, wr, capture=False)
    assert len(fwd.graphs) == 2
    assert _max_abs(bf16, bf16_eager) <= 2e-2
    assert all(bool(torch.isfinite(t).all()) for t in bf16)
    # the first call's outputs are its own: later replays leave them
    held = [t.clone() for t in first]
    predict(model, wr, wl)
    assert all(torch.equal(a, b) for a, b in zip(first, held))


@pytest.mark.cuda
def test_captured_stream_hops_match_eager_on_card():
    _need_card()
    from biear_tpu_torch.serve.streaming import (stream_init, stream_plan,
                                                 stream_readout, stream_reset,
                                                 stream_step, _leaves)

    model = _model()
    B = 4
    hop = stream_plan(model.cfg)["hop"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    chunks = [[torch.rand((B, hop), generator=gen, device="cuda") * 2 - 1
               for _ in range(2)] for _ in range(model.cfg.timesteps)]
    cap = eag = wit = stream_init(model, B)
    held = []
    for i, (l, r) in enumerate(chunks):
        if i == 5:
            mask = torch.tensor([True, False, True, False], device="cuda")
            cap, eag, wit = (stream_reset(model, s, mask)
                             for s in (cap, eag, wit))
        cap = stream_step(model, cap, l, r)
        eag = stream_step(model, eag, l, r, capture=False)
        wit = stream_step(model, wit, l, r, capture=False)
        assert _within_witness(_leaves(cap), _leaves(eag), _leaves(wit)), i
        held.append((cap, [t.clone() for t in _leaves(cap)]))
    for state, snap in held:
        assert all(torch.equal(a, b) for a, b in zip(_leaves(state), snap))
    got, want, w2 = (stream_readout(model, s) for s in (cap, eag, wit))
    assert _within_witness(got, want, w2)


@pytest.mark.cuda
def test_eval_graphs_read_the_parameters_a_captured_chunk_trains():
    """A captured train chunk and a captured eval chunk / eval step over
    the same parameters (the runner's case): after each training chunk the
    eval graphs give what the eager eval gives on the updated
    parameters."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.train.loop import (make_eval_chunk, make_eval_step,
                                            make_train_chunk)
    from biear_tpu_torch.train.optim import TrainHyper, make_optimizer

    model = _model()
    hp = TrainHyper()
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(16),
                                num_lags=model.cfg.n_bands,
                                mix_dtype="bfloat16")
    chunk = make_train_chunk(model, hp, make_optimizer(model, hp),
                             synth.batch_fn(8), 2)
    gen = torch.Generator(device="cuda")
    batches = [synth.sample_batch(torch.Generator(device="cuda")
                                  .manual_seed(10 + i), 8) for i in range(3)]
    stacks = tuple(torch.stack(f) for f in zip(*batches))
    ev_chunk, ev_step = make_eval_chunk(model, hp), make_eval_step(model, hp)
    eager_chunk = make_eval_chunk(model, hp, capture=False)
    for c in range(2):
        gen.manual_seed(c)
        chunk(gen)
        got, want = ev_chunk(stacks), eager_chunk(stacks)
        witness = eager_chunk(stacks)
        for k in want:
            assert _within_witness([got[k]], [want[k]], [witness[k]]), k
        step = ev_step(batches[1])
        assert all(abs(float(step[k]) - float(want[k][1])) <= 1e-5
                   for k in step)


@pytest.mark.cuda
def test_a_stacked_split_is_held_once_on_card():
    """After the first eval of a stacked split through the captured eval
    chunk, the card holds beyond the split only the graph's pool and the
    metric stacks: the graph reads the split in place, it does not copy
    it into static buffers."""
    _need_card()
    from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                            make_test_hrir_bank,
                                            make_test_segments)
    from biear_tpu_torch.graph import pool_stats
    from biear_tpu_torch.train.loop import make_eval_chunk
    from biear_tpu_torch.train.optim import TrainHyper

    model = _model()
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(16),
                                num_lags=model.cfg.n_bands,
                                mix_dtype="bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(4)
    stacks = tuple(torch.stack(f) for f in zip(
        *[synth.sample_batch(gen, 8) for _ in range(32)]))
    split = sum(t.numel() * t.element_size() for t in stacks)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    chunk = make_eval_chunk(model, TrainHyper())
    metrics = chunk(stacks)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    assert metrics["loss"].shape == (32,)
    assert held - pool_stats(model)["pool_bytes"] < split // 2
