"""The port's recorder (``biear_tpu_torch/trace.py``) on the CPU: spans
and their nesting, ring and aggregates, the profiler's view of them, the
stage marks of the eager and the captured train chunk (the captured one
on the stand-in graph of ``tests/_torch_graph_stand_in.py``), the mark's
row bound on the plain path, the replay summary, and the benchmark's
readers of the recorder (``perfbench/metrics``)."""

import json

import numpy as np
import pytest
import torch

from _torch_graph_stand_in import StandInGraph
from _torch_graph_stand_in import install as install_stand_ins
from biear_tpu_torch import trace
from biear_tpu_torch.data.synth import (AnechoicSynthesizer,
                                        make_test_hrir_bank,
                                        make_test_segments)
from biear_tpu_torch.models import ActiveBiEAR, BiEARConfig, build_auralnet
from biear_tpu_torch.train import graph as tgraph
from biear_tpu_torch.train import loop as tloop
from biear_tpu_torch.train import optim as topt
from perfbench import harness

SMALL = dict(controller_mode="dual", deltaQ_mode="relative", n_bands=16,
             latent_dim=16, ctrl_hidden=16, timesteps=3)
READERS = {"replay_synthesis_ms": "synthesis_ms",
           "replay_forward_ms": "forward_ms",
           "replay_backward_ms": "backward_ms",
           "replay_update_ms": "update_ms", "replay_gap_ms": "gap_ms",
           "replay_launch_ms": "launch_ms",
           "replay_gap_launch_ms": "gap_launch_ms",
           "replay_frontend_ms": "frontend_ms",
           "replay_frontend_grad_ms": "frontend_grad_ms"}
CARD = {"device_kind": "NVIDIA H100 80GB HBM3"}


@pytest.fixture(autouse=True)
def fresh_recorder():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(threads)


def _model_and_synth(seed: int = 1):
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(8),
                                num_lags=16, mix_dtype="bfloat16",
                                device="cpu")
    return ActiveBiEAR(BiEARConfig(**SMALL)).init_weights_(seed), synth


# the slots in the order the stream reaches them in a waveform BiEAR step
STREAM_ORDER = ("start", "synthesis", "frontend", "forward", "frontend_grad",
                "backward", "update", "recorded")


def _check_marks(marks: np.ndarray) -> None:
    """Every slot written, each row non-decreasing in stream order, rows
    in step order."""
    assert marks.shape[1] == len(trace.SLOTS) and (marks >= 0).all()
    order = [trace.SLOTS.index(s) for s in STREAM_ORDER]
    assert sorted(order) == list(range(len(trace.SLOTS)))
    assert (np.diff(marks[:, order], axis=1) >= 0).all()
    recorded = trace.SLOTS.index("recorded")
    assert (marks[1:, 0] >= marks[:-1, recorded]).all()


# ---------------- spans ----------------

def test_spans_nest_with_parent_ids_in_a_bounded_ring_beside_aggregates():
    rec = trace.Recorder(ring=3)
    with rec.span("outer", k=1) as outer:
        with rec.span("inner") as a:
            pass
        with rec.span("inner") as b:
            with rec.span("leaf") as leaf:
                pass
    with rec.span("inner") as c:
        pass
    assert outer.parent is None and c.parent is None
    assert a.parent == b.parent == outer.id and leaf.parent == b.id
    assert len({outer.id, a.id, b.id, leaf.id, c.id}) == 5
    assert outer.attrs == {"k": 1}
    assert outer.start_ns <= a.start_ns <= a.end_ns <= b.start_ns
    assert leaf.end_ns <= b.end_ns <= outer.end_ns <= c.start_ns
    # the ring keeps the last three spans to close, the totals all five
    assert [s.name for s in rec.spans] == ["inner", "outer", "inner"]
    assert [s.id for s in rec.spans] == [b.id, outer.id, c.id]
    t = rec.totals["inner"]
    durs = [s.end_ns - s.start_ns for s in (a, b, c)]
    assert t == [3, sum(durs), max(durs)]
    assert rec.total_ns("inner", "leaf") == sum(durs) + (leaf.end_ns
                                                          - leaf.start_ns)
    assert rec.total_ns("never") is None
    assert outer.ms == (outer.end_ns - outer.start_ns) / 1e6


def test_a_span_is_on_the_profilers_timeline_only_while_it_records(
        monkeypatch):
    """Under the profiler a span is a host event of its name, not a user
    annotation (for which the profiler would lay a device-side range over
    the kernels launched inside it); outside, no profiler range opens."""
    opened = []
    real = trace._profiler_range

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(trace, "_profiler_range", counted)
    with trace.span("outside.profiler") as off:
        torch.ones(2).add_(1)
    assert opened == [] and off.profiled is False
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("inside.profiler") as on:
            torch.ones(2).add_(1)
    events = {e.name: e for e in prof.events()}
    assert opened == ["inside.profiler"] and on.profiled is True
    assert "outside.profiler" not in events
    ev = events["inside.profiler"]
    assert ev.device_type == torch.autograd.DeviceType.CPU
    assert not ev.is_user_annotation


def test_snapshot_is_plain_data_and_reset_forgets_it():
    with trace.span("chunk.call", steps=2):
        pass
    snap = trace.snapshot()
    assert json.loads(json.dumps(snap)) == snap
    assert [s["name"] for s in snap["spans"]] == ["chunk.call"]
    assert snap["spans"][0]["attrs"] == {"steps": 2}
    assert snap["totals"]["chunk.call"]["count"] == 1
    assert isinstance(snap["launches"], dict)
    trace.reset()
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["totals"] == {}
    assert snap["chunks"] == []


# ---------------- marks ----------------

def test_the_mark_writes_only_inside_the_stack_on_the_plain_path():
    marks = torch.full((3, len(trace.SLOTS)), -1, dtype=torch.long)
    for r, slot in ((1, 2), (3, 0), (-1, 1), (7, 5)):
        trace.write_mark(marks, torch.tensor([r]), slot)
    written = (marks >= 0).nonzero().tolist()
    assert written == [[1, 2]]
    with pytest.raises(ValueError, match="slot"):
        trace.write_mark(marks, torch.tensor([0]), len(trace.SLOTS))
    with pytest.raises(ValueError, match="int64"):
        trace.write_mark(marks.int(), torch.tensor([0]), 0)
    trace.mark("start")                      # no sink: nothing happens
    with trace.step_sink(marks, torch.tensor([0])):
        trace.mark("recorded")
        assert trace.active_sink()[0] is marks
    assert trace.active_sink() is None
    assert int(marks[0, 5]) >= int(marks[1, 2]) >= 0


def test_the_eager_chunk_marks_six_stages_per_step_in_order():
    """make_train_chunk(..., capture=False) on the CPU: one record per
    call, chunk_steps rows of the six stage marks and the frontend's two,
    in stream order, rows in step order; an eager step outside a chunk
    marks nothing."""
    model, synth = _model_and_synth()
    hp = topt.TrainHyper()
    opt = topt.make_optimizer(model, hp)
    chunk = tloop.make_train_chunk(model, hp, opt, synth.batch_fn(2), 3,
                                   capture=False)
    chunk(torch.Generator().manual_seed(0))
    (rec,) = trace.chunk_records()
    assert (rec["steps"], rec["rows"], rec["profiled"]) == (3, 3, False)
    _check_marks(rec["marks"])
    call = [s for s in trace.RECORDER.spans if s.id == rec["call"]]
    assert [s.name for s in call] == ["chunk.call"]
    assert call[0].start_ns <= rec["marks"][0, 0]
    assert rec["marks"][-1, -1] <= call[0].end_ns
    step = tloop.make_train_step(model, hp, opt)
    step(synth.sample_batch(torch.Generator().manual_seed(1), 2),
         torch.Generator().manual_seed(2))
    assert len(trace.chunk_records()) == 1


def test_a_captured_chunk_marks_one_row_per_replay_under_launch_spans(
        monkeypatch):
    """CapturedChunk on the stand-in graph: a call writes one row of six
    marks per replay and closes chunk_steps ``graph.launch`` spans (graph
    "train_chunk") under its ``chunk.call`` span; a call of fewer steps
    leaves the unused row at -1 and is not a full record; the first call,
    which captures, is left out of the summary; the stats' warm-up ms is
    its span's."""
    install_stand_ins(monkeypatch.setattr)
    model, synth = _model_and_synth()
    hp = topt.TrainHyper()
    opt = topt.make_optimizer(model, hp)
    step_fn = lambda b, g, lr: tloop.train_step(model, hp, opt, b, g, lr)
    chunk = tgraph.CapturedChunk(step_fn, synth.batch_fn(2), 3,
                                 tgraph.train_state(model, opt))
    gen = torch.Generator()
    for seed in (100, 101):
        gen.manual_seed(seed)
        chunk(gen)
    first, rec = trace.chunk_records()
    assert (first["captured"], rec["captured"]) == (True, False)
    assert (rec["steps"], rec["rows"]) == (3, 3)
    _check_marks(rec["marks"])
    launches = [s for s in trace.RECORDER.spans if s.id in rec["spans"]]
    assert [s.name for s in launches] == ["graph.launch"] * 3
    assert {s.attrs["graph"] for s in launches} == {"train_chunk"}
    assert all(s.parent == rec["call"] for s in launches)
    assert chunk.stats["warmup_ms"] == trace.RECORDER.totals[
        "graph.warm_up"][1] / 1e6
    chunk.chunk_steps = 2
    chunk(gen)
    assert (chunk.marks[2] == -1).all() and (chunk.marks[:2] >= 0).all()
    short = trace.chunk_records()[-1]
    assert (short["steps"], short["rows"]) == (2, 3)
    assert len(trace.chunk_records(full=True)) == 2
    summary = trace.replay_summary(profiled=False)
    assert (summary["chunks"], summary["steps"]) == (1, 3)
    call = [s for s in trace.RECORDER.spans if s.id == rec["call"]][0]
    assert summary["wall_ms"] == pytest.approx(call.ms / 3)


def test_only_a_named_graph_opens_a_launch_span_per_replay():
    """A graph given its owner's name (the train chunk's) is a
    ``graph.launch`` span around each replay, named in attribute
    ``graph``; an unnamed graph (serving, the train step, eval) opens no
    span; both count their replays."""
    x = torch.zeros(2)
    step = lambda: {"y": x.add_(1).clone()}
    unnamed = StandInGraph(step, [x], [])
    named = StandInGraph(step, [x], [], name="train_chunk")
    unnamed.replay()
    named.replay()
    named.replay()
    spans = [s for s in trace.RECORDER.spans if s.name == "graph.launch"]
    assert [s.attrs for s in spans] == [{"graph": "train_chunk"}] * 2
    assert float(named.out["y"][0]) == 3.0


# ---------------- the summary and the readers ----------------

def _hand_built(rec: trace.Recorder) -> None:
    """Two replays of one profiled chunk call (marks on the CPU clock, ns)
    and their launch spans; one unprofiled call that must be left out."""
    call = rec.span("chunk.call")
    call.__enter__()
    spans = []
    for _ in range(2):
        with rec.span("graph.launch", graph="train_chunk") as s:
            spans.append(s)
    marks = torch.tensor([[100_000, 102_000, 110_000, 114_000, 117_000,
                           118_000],
                          [124_000, 126_000, 134_000, 138_000, 141_000,
                           142_000]], dtype=torch.long)
    call.profiled = True
    rec.record_chunk(marks, call, 2, "train_chunk")
    call.__exit__(None, None, None)
    for s, start in zip(spans, (1_000, 50_000)):
        s.start_ns, s.end_ns = start, start + 40_000
    other = rec.span("chunk.call")
    with other:
        rec.record_chunk(marks + 10**9, other, 2, "train_chunk")


def test_the_replay_summary_of_hand_built_records():
    rec = trace.Recorder()
    _hand_built(rec)
    s = rec.replay_summary(profiled=True)
    assert (s["chunks"], s["steps"], s["gaps"]) == (1, 2, 1)
    assert s["synthesis_ms"] == pytest.approx(0.002)
    assert s["forward_ms"] == pytest.approx(0.008)
    assert s["backward_ms"] == pytest.approx(0.004)
    assert s["update_ms"] == pytest.approx(0.004)
    assert s["gap_ms"] == pytest.approx(0.006)             # 118 -> 124 us
    assert s["launch_ms"] == pytest.approx(0.04)
    # the second launch (50-90 us) covers none of the gap; the first
    # (1-41 us) neither: a gap of 118-124 us lies outside both
    assert s["gap_launch_ms"] == 0.0
    assert s["clock_width_ms"] == 0.0          # CPU marks: the spans' clock
    assert rec.replay_summary(profiled=False)["chunks"] == 1
    assert trace.Recorder().replay_summary() is None


def test_a_gap_is_covered_by_the_launch_spans_that_overlap_it():
    rec = trace.Recorder()
    call = rec.span("chunk.call")
    with call:
        with rec.span("graph.launch", graph="train_chunk") as s:
            pass
        with rec.span("graph.launch", graph="other") as o:
            pass
        marks = torch.tensor([[0, 1, 2, 3, 4, 118_000],
                              [124_000] * 6], dtype=torch.long)
        rec.record_chunk(marks, call, 2, "train_chunk")
    s.start_ns, s.end_ns = 115_000, 121_000
    o.start_ns, o.end_ns = 118_000, 124_000         # another graph's launch
    s = rec.replay_summary(profiled=False)
    assert s["gap_ms"] == pytest.approx(0.006)
    assert s["gap_launch_ms"] == pytest.approx(0.003)      # 118-121 us
    assert s["launch_ms"] == pytest.approx(0.006)


@pytest.mark.parametrize("name", [*READERS, "setup_bank_s",
                                  "setup_capture_s"])
def test_each_recorder_reader_is_none_on_a_cpu_ctx_or_without_records(
        name):
    read = harness.reader(name)
    assert read({"device_kind": "cpu"}) is None
    assert read(dict(CARD)) is None


def test_the_recorder_readers_read_a_hand_built_recorder_state():
    _hand_built(trace.RECORDER)
    with trace.span("synth.bank") as bank:
        pass
    with trace.span("graph.warm_up") as warm:
        pass
    with trace.span("graph.capture") as cap:
        pass
    want = trace.replay_summary(profiled=True)
    for name, key in READERS.items():
        got = harness.reader(name)(dict(CARD))
        assert got == want[key], name
        assert harness.reader(name)({"device_kind": "cpu"}) is None
    assert harness.reader("replay_forward_ms")(dict(CARD)) == \
        pytest.approx(0.008)
    assert harness.reader("setup_bank_s")(dict(CARD)) == \
        (bank.end_ns - bank.start_ns) / 1e9
    assert harness.reader("setup_capture_s")(dict(CARD)) == \
        pytest.approx((warm.end_ns - warm.start_ns
                       + cap.end_ns - cap.start_ns) / 1e9)


def test_the_summary_reports_the_widest_calibration_and_skips_a_capture():
    """A record on a calibrated clock reports its bracket's width; a call
    with a ``graph.capture`` span under it (its wall holds the warm-up and
    the capture) is kept as a record but left out of the summary."""
    rec = trace.Recorder()
    marks = torch.tensor([[0, 1, 2, 3, 4, 5], [7] * 6], dtype=torch.long)
    with rec.span("chunk.call") as first:
        with rec.span("graph.capture"):
            pass
        rec.record_chunk(marks, first, 2, "train_chunk")
    assert rec.replay_summary(profiled=False) is None
    with rec.span("chunk.call") as second:
        rec.record_chunk(marks, second, 2, "train_chunk")
    rec.clocks["cpu"] = {"offset_ns": 0, "width_ns": 12_500}
    s = rec.replay_summary(profiled=False)
    assert (s["chunks"], s["steps"]) == (1, 2)
    assert s["wall_ms"] == pytest.approx(second.ms / 2)
    assert s["clock_width_ms"] == pytest.approx(0.0125)
    assert [c["captured"] for c in rec.chunk_records()] == [True, False]


# ---------------- the frontend's marks and span ----------------

FRONTEND_PATHS = {
    "dual-bf16": (dict(SMALL, fb_w_dtype="bfloat16"), "recurrence"),
    "dual-f32": (dict(SMALL, fb_w_dtype="float32"), "autograd"),
    "single-bf16": (dict(SMALL, controller_mode="single",
                         deltaQ_mode="absolute", fb_w_dtype="bfloat16"),
                    "recurrence"),
}


def _eager_chunk(model, steps: int = 2):
    ir, az, dist = make_test_hrir_bank()
    synth = AnechoicSynthesizer(ir, az, dist, make_test_segments(8),
                                num_lags=16, mix_dtype="bfloat16",
                                device="cpu")
    hp = topt.TrainHyper()
    chunk = tloop.make_train_chunk(model, hp, topt.make_optimizer(model, hp),
                                   synth.batch_fn(2), steps, capture=False)
    chunk(torch.Generator().manual_seed(0))
    (rec,) = trace.chunk_records()
    return rec


@pytest.mark.parametrize("name", list(FRONTEND_PATHS))
def test_the_frontend_marks_lie_in_stream_order_on_each_path(name):
    """synthesis <= frontend <= forward <= frontend_grad <= backward in
    every step of an eager chunk: the dual frontend under
    ``RecurrenceFn`` (bf16) and under the autograd frame loop (f32),
    the single frontend under ``RecurrenceFn`` (bf16); the
    ``frontend.loop`` span names the path, once a step."""
    kw, path = FRONTEND_PATHS[name]
    rec = _eager_chunk(ActiveBiEAR(BiEARConfig(**kw)).init_weights_(1))
    _check_marks(rec["marks"])
    loops = [s for s in trace.RECORDER.spans if s.name == "frontend.loop"]
    assert [s.attrs for s in loops] == [{"path": path}] * 2
    summary = trace.replay_summary(profiled=False)
    m = rec["marks"]
    S = trace.SLOTS.index
    assert summary["frontend_ms"] == pytest.approx(
        float(np.mean(m[:, S("frontend")] - m[:, S("synthesis")])) / 1e6)
    assert summary["frontend_grad_ms"] == pytest.approx(
        float(np.mean(m[:, S("backward")] - m[:, S("frontend_grad")])) / 1e6)


def test_auralnet_keeps_its_six_marks_and_summary():
    """AuralNet writes no frontend mark: its two columns stay -1, the
    summary's earlier keys read its six marks as before and the frontend
    keys are None."""
    cfg = BiEARConfig(**SMALL, d_model=16)
    rec = _eager_chunk(build_auralnet(cfg, device="cpu"))
    m = rec["marks"]
    six = trace.STEP_SLOTS
    assert (m[:, :six] >= 0).all() and (m[:, six:] == -1).all()
    assert (np.diff(m[:, :six], axis=1) >= 0).all()
    s = trace.replay_summary(profiled=False)
    d = np.diff(m[:, :six], axis=1)
    for key, col in (("synthesis_ms", d[:, 0]), ("forward_ms", d[:, 1]),
                     ("backward_ms", d[:, 2]),
                     ("update_ms", m[:, 5] - m[:, 3]),
                     ("gap_ms", m[1:, 0] - m[:-1, 5])):
        assert s[key] == pytest.approx(float(np.mean(col)) / 1e6), key
    assert (s["chunks"], s["steps"], s["gaps"]) == (1, 2, 1)
    assert s["frontend_ms"] is None and s["frontend_grad_ms"] is None
    assert not [x for x in trace.RECORDER.spans if x.name == "frontend.loop"]


def test_the_frontend_grad_mark_goes_to_the_forwards_sink():
    """The backward mark is written into the sink active at the forward,
    whichever sink (none) is active where the backward runs, as on a
    card, where autograd's backward thread has none; outside a sink the
    outputs pass through unmarked."""
    marks = torch.full((2, len(trace.SLOTS)), -1, dtype=torch.long)
    row = torch.tensor([1])
    x = torch.ones(3, requires_grad=True)
    with trace.step_sink(marks, row):
        y, z = trace.frontend_marks(x * 2.0, x * 3.0)
    written = (marks >= 0).nonzero().tolist()
    assert written == [[1, trace.SLOTS.index("frontend")]]
    (g,) = torch.autograd.grad((y + z).sum(), [x])
    assert g.tolist() == [5.0] * 3
    assert int(marks[1, trace.SLOTS.index("frontend_grad")]) >= int(
        marks[1, trace.SLOTS.index("frontend")])
    a = torch.ones(2)
    assert trace.frontend_marks(a)[0] is a
    assert (marks[0] == -1).all()


def test_the_summary_reads_the_frontend_over_the_records_that_wrote_it():
    """Hand-built records: one of eight marks a row, one of six (a model
    without a frontend mark): the stage keys over both, the frontend keys
    over the first alone."""
    rec = trace.Recorder()
    full = torch.tensor([[0, 2_000, 10_000, 14_000, 17_000, 18_000, 5_000,
                          11_000],
                         [20_000, 22_000, 30_000, 34_000, 37_000, 38_000,
                          26_000, 32_000]], dtype=torch.long)
    six = torch.cat([full[:, :6] + 100_000,
                     torch.full((2, 2), -1, dtype=torch.long)], 1)
    for m in (full, six):
        with rec.span("chunk.call") as call:
            rec.record_chunk(m, call, 2, "train_chunk")
    s = rec.replay_summary(profiled=False)
    assert (s["chunks"], s["steps"]) == (2, 4)
    assert s["forward_ms"] == pytest.approx(0.008)
    assert s["frontend_ms"] == pytest.approx(0.0035)     # 3 and 4 us
    assert s["frontend_grad_ms"] == pytest.approx(0.0025)  # 3 and 2 us

