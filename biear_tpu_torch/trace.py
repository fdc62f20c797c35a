"""The port's recorder: host spans, device-timed stage marks inside the
captured training step, and one clock for both.

Counterpart of ``biear_tpu/utils/profiler.py`` (``annotate``, ``trace``),
and the only tracing system of the port. Nothing is written to disk; a
caller takes ``snapshot()`` (plain data) or ``replay_summary()`` when it
wants them.

Spans. ``span(name, **attrs)`` is a context manager that records the
name, its host start and end (``time.perf_counter_ns``), an id, the id of
the span enclosing it on this thread (so a layer's self time is its span
less its children's) and the attributes, into a ring of the last RING
spans, beside per-name aggregates (count, total and longest ns) that
cover every span. Only while ``torch.profiler`` records does a span also
open a profiler range of its name (``_profiler_range``): that puts it on
the profiler's host timeline, beside the device ops CUPTI correlates
with it. Outside the profiler a span costs two clock reads and one
append.
The names the port uses are fixed: ``chunk.call``, ``graph.launch``
(attribute ``graph``, the train chunk's name), ``graph.warm_up``,
``graph.capture``, ``synth.bank``, ``runner.checkpoint``,
``runner.eval_splits``, ``frontend.loop`` (attribute ``path``: the
adaptive frontend's frames as "recurrence", the dual frontend's one
autograd node, "autograd" or "no_grad").

Marks. ``mark(slot)`` stamps, into row ``row[0]`` and column ``slot`` of
the active step sink's (rows, len(SLOTS)) int64 stack, the time at which
the stream reaches it: on a card one thread of ``kernels/trace_mark.cu``
reads the card's %globaltimer (ns), inside a captured graph at every
replay; on the CPU the plain version writes ``perf_counter_ns``. A row
outside the stack is not written. Without an active sink (``step_sink``)
a mark does nothing, so an eager call outside a train chunk is not
marked. The slots are SLOTS; the train chunks
(``train/graph.py::CapturedChunk``, the eager loop of
``loop.make_train_chunk``) hold the sink. Every marked step writes the
first six (STEP_SLOTS), in stream order; the waveform BiEAR model's step
also writes ``frontend`` (its frontend's outputs made, before the
encoders) and ``frontend_grad`` (their gradient complete, before the
frontend's own backward), through ``frontend_marks``: in stream order
synthesis <= frontend <= forward <= frontend_grad <= backward.

Chunk records. After its replays a chunk call hands ``record_chunk`` the
rows it wrote (cloned on the device: no sync), its ``chunk.call`` span
and its graph's name; the record keeps the ``graph.launch`` spans of
that graph under the call, whether the call captured its graph (a
``graph.capture`` span under it: its wall then holds the warm-up, the
capture and the clock's calibration) and whether the profiler recorded.
The records are kept in a ring of RING.

One clock. At the first chunk record on a card the recorder calibrates
the card's timer against ``perf_counter_ns``: CALIBRATION_MARKS eager
marks, each launched and synchronised between two host clock reads; the
tightest bracket's midpoint gives the offset, its width the uncertainty.
A mark plus the offset is a time on the spans' clock; a time laid across
the two clocks is not resolved below the width.

Counters: ``kernels.LAUNCHES`` counts kernel launches (``trace_mark``
among them, six or eight per marked step); ``snapshot`` reads it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import numpy as np
import torch

from .kernels import LAUNCHES, count_launch

RING = 4096             # spans, and chunk records, kept
SLOTS = ("start", "synthesis", "forward", "backward", "update", "recorded",
         "frontend", "frontend_grad")
STEP_SLOTS = 6          # the slots every marked step writes
CALIBRATION_MARKS = 5
_SLOT = {s: i for i, s in enumerate(SLOTS)}


def profiling() -> bool:
    """Whether torch.profiler (or the autograd profiler) records."""
    return torch._C._autograd._profiler_enabled()


def _profiler_range(name: str):
    """A range named `name` on the profiler's host timeline: an operator-
    scope record function. ``torch.profiler.record_function`` is a user
    annotation, for which the profiler also lays a device-side range over
    every kernel launched inside it; a trace reader that takes the
    device's events as its busy time would then see a chunk call or a
    replay's launch as one long device op."""
    return torch._C._profiler._RecordFunctionFast(name)


# ---------------- the mark kernel and its plain version ----------------

def _check_stack(marks: torch.Tensor, row: torch.Tensor, slot: int) -> None:
    if (marks.ndim != 2 or marks.dtype != torch.int64
            or not marks.is_contiguous()):
        raise ValueError(f"marks must be a contiguous (rows, slots) int64 "
                         f"stack, got {tuple(marks.shape)} {marks.dtype}")
    if row.dtype != torch.int64 or row.device != marks.device:
        raise ValueError(f"row must be an int64 counter on {marks.device}")
    if not 0 <= slot < marks.shape[1]:
        raise ValueError(f"slot {slot} outside the stack's "
                         f"{marks.shape[1]} columns")


def launch_mark(marks: torch.Tensor, row: torch.Tensor, slot: int) -> None:
    """``trace_mark.cu`` on the current stream, uncounted:
    marks[row[0], slot] = the card's timer, unless row[0] lies outside the
    stack."""
    from .kernels.build import check_launch, trace_mark_lib

    _check_stack(marks, row, slot)
    with torch.cuda.device(marks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = trace_mark_lib().trace_mark_launch(
            marks.data_ptr(), row.data_ptr(), marks.shape[0],
            marks.shape[1], slot, stream)
    check_launch(err, "trace_mark")


def write_mark_plain(marks: torch.Tensor, row: torch.Tensor,
                     slot: int) -> None:
    """The plain version: marks[row[0], slot] = perf_counter_ns(), unless
    row[0] lies outside the stack. It reads and writes the CPU tensors'
    memory through numpy, as the kernel does on the card: no op is
    dispatched."""
    _check_stack(marks, row, slot)
    m = marks.numpy()
    r = int(row.numpy().reshape(-1)[0])
    if 0 <= r < m.shape[0]:
        m[r, slot] = time.perf_counter_ns()


def write_mark(marks: torch.Tensor, row: torch.Tensor, slot: int) -> None:
    """One mark: the kernel for a stack on a card (counted in
    ``LAUNCHES["trace_mark"]``), the plain version on the CPU."""
    if marks.is_cuda:
        launch_mark(marks, row, slot)
        count_launch("trace_mark")
    else:
        write_mark_plain(marks, row, slot)


# ---------------- the recorder ----------------

class Span:
    """One span; ``ms`` is its duration once closed."""

    __slots__ = ("recorder", "name", "attrs", "id", "parent", "start_ns",
                 "end_ns", "profiled", "_fn")

    def __init__(self, recorder, name: str, attrs: dict):
        self.recorder, self.name, self.attrs = recorder, name, attrs
        self.end_ns = None
        self._fn = None

    def __enter__(self) -> "Span":
        stack = self.recorder._stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(self.recorder._ids)
        stack.append(self)
        self.profiled = profiling()
        if self.profiled:
            self._fn = _profiler_range(self.name)
            self._fn.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
        self.recorder._close(self)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def as_dict(self) -> dict:
        return {"id": self.id, "parent": self.parent, "name": self.name,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "profiled": self.profiled, "attrs": dict(self.attrs)}


class Recorder:
    """Spans, chunk records and clock calibrations of one process (the
    module's functions are those of ``RECORDER``)."""

    def __init__(self, ring: int = RING):
        self.spans = collections.deque(maxlen=ring)
        self.chunks = collections.deque(maxlen=ring)
        self.totals = {}        # name -> [count, total ns, longest ns]
        self.clocks = {}        # device -> {"offset_ns", "width_ns"}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def reset(self) -> None:
        """Forget every span, record and calibration (tests)."""
        with self._lock:
            self.spans.clear()
            self.chunks.clear()
            self.totals.clear()
            self.clocks.clear()

    # spans

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, /, **attrs) -> Span:
        """A context manager recording one span named `name`."""
        return Span(self, name, attrs)

    def _close(self, s: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
        dt = s.end_ns - s.start_ns
        with self._lock:
            self.spans.append(s)
            t = self.totals.setdefault(s.name, [0, 0, 0])
            t[0] += 1
            t[1] += dt
            t[2] = max(t[2], dt)

    def total_ns(self, *names: str):
        """The summed ns of every span named in `names`, or None where
        none was recorded."""
        hit = [self.totals[n] for n in names if n in self.totals]
        return sum(t[1] for t in hit) if hit else None

    # marks

    @contextlib.contextmanager
    def step_sink(self, marks: torch.Tensor, row: torch.Tensor):
        """Marks on this thread go to row ``row[0]`` of `marks` (a
        (rows, len(SLOTS)) int64 stack beside the device counter `row`)
        inside the block."""
        prev = getattr(self._local, "sink", None)
        self._local.sink = (marks, row)
        try:
            yield
        finally:
            self._local.sink = prev

    def active_sink(self):
        """(marks, row) of this thread's active sink, or None."""
        return getattr(self._local, "sink", None)

    def mark(self, slot: str) -> None:
        """Stamp stage boundary `slot` (one of SLOTS) into the active sink;
        nothing without one."""
        sink = getattr(self._local, "sink", None)
        if sink is not None:
            write_mark(sink[0], sink[1], _SLOT[slot])

    # chunk records and the clock

    def record_chunk(self, marks: torch.Tensor, call: Span, steps: int,
                     graph: str | None = None) -> None:
        """Keep a train chunk call's marks: the first min(steps, rows) rows
        of its stack, cloned where they lie; `call` is its open
        ``chunk.call`` span, `steps` the steps it ran, `graph` the name of
        the graph it replays (None: eager). Kept beside them: the ids of
        the ``graph.launch`` spans of `graph` closed under the call, and
        whether a ``graph.capture`` span closed under it."""
        device = str(marks.device)
        if marks.is_cuda and device not in self.clocks:
            self.calibrate(marks.device)
        launches, captured = [], False
        with self._lock:
            for s in reversed(self.spans):
                if s.end_ns < call.start_ns:
                    break
                if s.parent != call.id:
                    continue
                captured |= s.name == "graph.capture"
                if s.name == "graph.launch" and s.attrs["graph"] == graph:
                    launches.append(s.id)
        rows = marks.shape[0]
        self.chunks.append({
            "marks": marks[:min(steps, rows)].clone(), "rows": rows,
            "steps": int(steps), "call": call.id, "spans": launches[::-1],
            "captured": captured, "profiled": call.profiled,
            "device": device})

    def calibrate(self, device) -> dict:
        """The card's timer against perf_counter_ns: CALIBRATION_MARKS eager
        marks, each bracketed by host clock reads around its launch and a
        synchronise of its stream; the tightest bracket's midpoint less its
        mark is the offset, its width the uncertainty (both ns). Kept per
        device. Inside a bracket there is only the C launcher's call and
        the synchronise."""
        from .kernels.build import check_launch, trace_mark_lib

        device = torch.device(device)
        n = CALIBRATION_MARKS
        stamps = torch.full((n, 1), -1, dtype=torch.int64, device=device)
        rows = torch.arange(n, dtype=torch.int64, device=device)
        launch = trace_mark_lib().trace_mark_launch
        stream = torch.cuda.current_stream(device)
        sync, handle = stream.synchronize, stream.cuda_stream
        at, row_at = stamps.data_ptr(), rows.data_ptr()
        torch.cuda.synchronize(device)
        brackets = []
        with torch.cuda.device(device):
            for i in range(n):
                t0 = time.perf_counter_ns()
                err = launch(at, row_at + 8 * i, n, 1, 0, handle)
                sync()
                brackets.append((t0, time.perf_counter_ns()))
                check_launch(err, "trace_mark")
        dev = stamps[:, 0].tolist()
        i = min(range(n), key=lambda k: brackets[k][1] - brackets[k][0])
        t0, t1 = brackets[i]
        clock = {"offset_ns": (t0 + t1) // 2 - dev[i], "width_ns": t1 - t0}
        self.clocks[str(device)] = clock
        return clock

    def offset_ns(self, device: str) -> int:
        """What turns a mark on `device` into perf_counter_ns: the card's
        calibrated offset, 0 on the CPU."""
        if not device.startswith("cuda"):
            return 0
        return self.clocks[device]["offset_ns"]

    def chunk_records(self, profiled=None, full: bool = False) -> list:
        """The chunk records (marks on the host, as perf_counter_ns), those
        made while the profiler recorded (`profiled` True) or not (False)
        or all (None); with `full`, those that ran their stack's rows
        (the chunk's own chunk_steps)."""
        keep = [c for c in list(self.chunks)
                if (profiled is None or c["profiled"] == profiled)
                and (not full or c["steps"] == c["rows"])]
        return [dict(c, marks=(c["marks"].cpu().numpy()
                               + self.offset_ns(c["device"])))
                for c in keep]

    def snapshot(self) -> dict:
        """The recorder as plain data: the ring's spans, the per-name
        aggregates, the chunk records (marks as perf_counter_ns lists),
        the clock calibrations and ``kernels.LAUNCHES``."""
        with self._lock:
            spans = [s.as_dict() for s in self.spans]
            totals = {k: {"count": v[0], "total_ns": v[1], "max_ns": v[2]}
                      for k, v in self.totals.items()}
        chunks = [dict(c, marks=c["marks"].tolist())
                  for c in self.chunk_records()]
        return {"spans": spans, "totals": totals, "chunks": chunks,
                "clocks": {k: dict(v) for k, v in self.clocks.items()},
                "launches": dict(LAUNCHES)}

    def replay_summary(self, profiled=True) -> dict | None:
        """Per-step means (ms) over the chunk records at their full
        chunk_steps (`profiled` as in ``chunk_records``) of calls that did
        not capture their graph, or None without one whose STEP_SLOTS
        marks are all written:

          * synthesis_ms, forward_ms, backward_ms, update_ms: synthesis -
            start, forward - synthesis, backward - forward, recorded -
            backward (the update, its telemetry and the metric row; in a
            mesh chunk also the pack, the all-reduce and the unpack);
          * frontend_ms, frontend_grad_ms: frontend - synthesis (spectra
            and the frontend's frames) and backward - frontend_grad (the
            frontend's own backward), over the records that wrote both
            frontend marks in every row (None without one);
          * gap_ms: from one replay's recorded to the next replay's start
            within a call (the card waiting between replays);
          * launch_ms: the ``graph.launch`` spans' host duration;
          * gap_launch_ms: per gap, the ms of it (on the host clock) that
            a ``graph.launch`` span covers;
          * wall_ms: the ``chunk.call`` spans over the steps (the host's
            time in the call, which returns once its replays are queued:
            below the stages where the host runs ahead of the card);
          * clock_width_ms: the widest calibration bracket of the records'
            cards (0 on the CPU, whose marks are on the spans' clock):
            gap_launch_ms does not resolve less;
          * chunks, steps, gaps: what the means are over."""
        recs = [c for c in self.chunk_records(profiled, full=True)
                if not c["captured"] and len(c["marks"])
                and (c["marks"][:, :STEP_SLOTS] >= 0).all()]
        if not recs:
            return None
        with self._lock:
            by_id = {s.id: s for s in self.spans}
        stages = [[] for _ in range(4)]
        gaps, covered, launches, walls = [], [], [], []
        for c in recs:
            m = c["marks"]
            d = np.diff(m, axis=1)
            for k in range(3):
                stages[k].append(d[:, k])
            stages[3].append(m[:, 5] - m[:, 3])
            spans = [by_id[i] for i in c["spans"] if i in by_id]
            launches += [s.end_ns - s.start_ns for s in spans]
            for a, b in zip(m[:-1, 5], m[1:, 0]):
                gaps.append(b - a)
                covered.append(sum(max(0, min(b, s.end_ns)
                                       - max(a, s.start_ns))
                                   for s in spans))
            if c["call"] in by_id:
                walls.append(by_id[c["call"]].end_ns
                             - by_id[c["call"]].start_ns)
        steps = sum(len(c["marks"]) for c in recs)
        mean_ms = lambda xs: float(np.mean(xs)) / 1e6 if len(xs) else None
        out = {name: mean_ms(np.concatenate(v)) for name, v in zip(
            ("synthesis_ms", "forward_ms", "backward_ms", "update_ms"),
            stages)}
        fe = [c["marks"] for c in recs if c["marks"].shape[1] == len(SLOTS)
              and (c["marks"][:, STEP_SLOTS:] >= 0).all()]

        def fe_ms(a: str, b: str):
            """Mean ms from mark `a` to mark `b` over the records in fe."""
            return mean_ms(np.concatenate(
                [m[:, _SLOT[b]] - m[:, _SLOT[a]] for m in fe])) if fe else None
        out.update(frontend_ms=fe_ms("synthesis", "frontend"),
                   frontend_grad_ms=fe_ms("frontend_grad", "backward"))
        widths = [self.clocks[c["device"]]["width_ns"] / 1e6
                  if c["device"] in self.clocks else 0.0 for c in recs]
        out.update(gap_ms=mean_ms(gaps), launch_ms=mean_ms(launches),
                   gap_launch_ms=mean_ms(covered),
                   wall_ms=(sum(walls) / 1e6 / steps
                            if len(walls) == len(recs) else None),
                   clock_width_ms=max(widths),
                   chunks=len(recs), steps=steps, gaps=len(gaps))
        return out


class _GradMark(torch.autograd.Function):
    """Identity on tensors whose backward writes the ``frontend_grad``
    mark into the sink given to the forward: autograd runs a card's
    backward on a thread of its own, where no sink is active. Its
    backward runs once every output's gradient is complete."""

    @staticmethod
    def forward(ctx, sink, *xs):
        ctx.sink = sink
        ctx.set_materialize_grads(False)
        return xs

    @staticmethod
    def backward(ctx, *gs):
        write_mark(ctx.sink[0], ctx.sink[1], _SLOT["frontend_grad"])
        return (None, *gs)


RECORDER = Recorder()
span = RECORDER.span
mark = RECORDER.mark
step_sink = RECORDER.step_sink
active_sink = RECORDER.active_sink
record_chunk = RECORDER.record_chunk
chunk_records = RECORDER.chunk_records
replay_summary = RECORDER.replay_summary
snapshot = RECORDER.snapshot
total_ns = RECORDER.total_ns
reset = RECORDER.reset


def frontend_marks(*xs: torch.Tensor) -> tuple:
    """`xs`, the frontend's outputs, with the ``frontend`` mark written
    after them and, where autograd records them, the ``frontend_grad``
    mark written once their gradient is complete (``_GradMark``).
    Without an active sink, `xs` unchanged and nothing written."""
    sink = active_sink()
    if sink is None:
        return xs
    mark("frontend")
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        xs = _GradMark.apply(sink, *xs)
    return xs
