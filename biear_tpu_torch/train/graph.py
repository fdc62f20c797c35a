"""The train step and the fused train chunk as captured CUDA graphs.

Counterpart of the JAX package's one-dispatch programs:
``make_train_step`` under ``jax.jit(donate_argnums=(0, 1))`` and
``make_train_chunk``'s one jitted ``lax.scan`` (``biear_tpu/train/
loop.py:191-260``), which JAX runs the same way over its ('data',
'model') mesh. On a CUDA device with no mesh or a mesh without a model
axis, ``loop.make_train_step`` and ``loop.make_train_chunk`` return the
objects of this module, built on the package's capture machinery
(``biear_tpu_torch/graph.py``):

  * ``CapturedStep``: a ``graph.Captured`` over the train step, one graph
    per batch signature and precision surface, as ``jax.jit`` keeps one
    compilation per shape. A call copies the batch into that graph's
    static buffers and replays it.
  * ``CapturedChunk``: one graph of synthesis -> train step, replayed
    ``chunk_steps`` times per call. Replay i writes its metrics into row i
    of preallocated (chunk_steps, ...) stacks (a row counter on the
    device, advanced by the graph itself), and the device times of its
    stage boundaries into row i of a (chunk_steps, 6) mark stack: the
    recorder's sink (``trace.step_sink``) is active while the chunk
    captures, so the graph holds six ``trace_mark`` nodes per step
    (``trace.SLOTS``: start, synthesis, forward, backward, update,
    recorded). A call is a ``chunk.call`` span; it fills the mark stack
    with -1, replays, and hands the recorder a clone of the rows
    (``trace.record_chunk``).
  * ``CapturedMeshStep`` and ``CapturedMeshChunk``: the same over D > 1
    data ranks, each step two graphs (``graph.SplitGraph``) around the
    one collective of a step without a model axis, the flat all-reduce
    of the gradients over 'data' (``loop.send_half``, then
    ``Mesh.data_sum_`` eagerly, NCCL or gloo alike, then
    ``loop.receive_half``). Graph A holds the synthesis (in the chunk),
    the forward and backward and the packing into one static flat
    buffer; graph B the update, the telemetry and (in the chunk) row i of
    the metric stacks. Over one data rank nothing is sent, and the
    one-graph classes run.

Each graph has a private memory pool. The warm-up runs whole steps (every
rank joins their all-reduces) and puts every parameter, Adam moment and
count and the generator states back as they were. Replays update the
parameters and the Adam state in place (JAX's donation). ``lr_scale`` is
a 0-dim device tensor that each replay reads, and every distinct
generator (a mesh rank's ``RankGenerators`` holds up to three) is
registered with the graphs, so every replay draws what the eager step
draws from the same states: per step the synthesis first, then the
dropout. The eager loop (``loop.train_step``) stays the path of the CPU
and of a model axis, whose collectives run inside autograd's forward and
backward.
"""

from __future__ import annotations

import torch

from .. import graph as core
from .. import trace


def train_state(model, optimizer) -> list:
    """Every tensor a train step updates in place: the parameters, then
    each trained group's Adam moments and step count."""
    out = list(model.parameters())
    for g in optimizer.groups:
        if not g.frozen and g.params:
            out += [*g.m, *g.v, g.count]
    return out


def set_scalar(dst: torch.Tensor, value) -> None:
    """Write a float or a 0-dim tensor into the 0-dim device tensor
    `dst`."""
    if isinstance(value, torch.Tensor):
        dst.copy_(value)
    else:
        dst.fill_(float(value))


class CapturedStep(core.Captured):
    """(batch, gen, lr_scale) -> metrics: ``step_fn(batch, gen, lr)`` (the
    eager train step) replayed from one CUDA graph per batch signature and
    precision surface. The metrics are fresh tensors (copies of the
    graph's outputs)."""

    def __init__(self, step_fn, state: list):
        self.lr = torch.ones((), device=state[0].device)
        super().__init__(lambda batch, gen: step_fn(batch, gen, self.lr),
                         state)

    def __call__(self, batch, gen, lr_scale=1.0) -> dict:
        set_scalar(self.lr, lr_scale)
        return super().__call__(batch, gen)


class CapturedMeshStep(CapturedStep):
    """CapturedStep over D > 1 data ranks: per key two graphs around the
    eager flat all-reduce of `mesh`'s data group (``graph.SplitGraph``),
    send(batch, gen) -> the flat buffer, receive(flat, lr) -> metrics."""

    def __init__(self, send, receive, mesh, state: list):
        self.send, self.receive, self.mesh = send, receive, mesh
        super().__init__(
            lambda batch, gen, lr: receive(mesh.data_sum_(send(batch, gen)),
                                           lr), state)

    def graph_of(self, run, static: tuple, gen, gens: list):
        return core.SplitGraph(lambda: self.send(static, gen),
                               self.mesh.data_sum_,
                               lambda flat: self.receive(flat, self.lr),
                               self.state, gens)


class CapturedChunk:
    """(gen, lr_scale, dropout_gen) -> metrics stacked over `chunk_steps`
    synthesize -> train steps: ``step_fn(synth_batch_fn(gen), drop, lr)``
    (drop: `dropout_gen`, else `gen`) captured once, with the generators
    of the first call, and replayed `chunk_steps` times per call.
    ``stats`` holds the warm-up and capture ms and the pool's bytes;
    ``marks`` the last call's stage marks (-1 where none was written)."""

    name = "train_chunk"

    def __init__(self, step_fn, synth_batch_fn, chunk_steps: int,
                 state: list):
        self.step_fn = step_fn
        self.synth_batch_fn = synth_batch_fn
        self.chunk_steps = chunk_steps
        self.state = state
        self.device = state[0].device
        self.lr = torch.ones((), device=self.device)
        self.row = torch.zeros(1, dtype=torch.long, device=self.device)
        self.marks = torch.full((chunk_steps, len(trace.SLOTS)), -1,
                                dtype=torch.long, device=self.device)
        self.gen = self.dropout_gen = self.graph = self.stacks = None
        self.stats = {}

    def capture(self, gen, dropout_gen=None) -> None:
        """Warm up and capture the step with generator `gen` and the
        dropout streams `dropout_gen` (the first call does it when this
        was not called); trains nothing."""
        drop = gen if dropout_gen is None else dropout_gen
        gens = core.generators_of(gen, dropout_gen)
        body = lambda: self.step_fn(self.synthesize(gen), drop, self.lr)
        with trace.step_sink(self.marks, self.row):
            warm, warm_ms = core.warm_up(body, self.state, gens, self.device)
            self.stacks = {k: torch.empty((self.chunk_steps, *v.shape),
                                          dtype=v.dtype, device=self.device)
                           for k, v in warm.items()}
            del warm
            self.graph = self.graph_of(gen, drop, gens)
        self.gen, self.dropout_gen = gen, dropout_gen
        self.stats = {"warmup_ms": warm_ms,
                      "capture_ms": self.graph.capture_ms,
                      "pool_bytes": self.graph.pool_bytes}

    def synthesize(self, gen):
        """The step's batch, between the start and synthesis marks."""
        trace.mark("start")
        batch = self.synth_batch_fn(gen)
        trace.mark("synthesis")
        return batch

    def record(self, metrics: dict) -> None:
        """Write one step's metrics into row ``row`` of the stacks, mark
        it recorded and advance the row (on the device)."""
        for k, v in metrics.items():
            self.stacks[k].index_copy_(0, self.row, v[None])
        trace.mark("recorded")
        self.row.add_(1)

    def graph_of(self, gen, drop, gens: list):
        """The graph of one synthesize -> step iteration."""
        return core.Graph(lambda: self.record(self.step_fn(
            self.synthesize(gen), drop, self.lr)), self.state, gens,
            name=self.name)

    def __call__(self, gen, lr_scale=1.0, dropout_gen=None) -> dict:
        with trace.span("chunk.call") as call:
            set_scalar(self.lr, lr_scale)
            if self.graph is None:
                self.capture(gen, dropout_gen)
            else:
                core.check_generator(gen, self.gen)
                core.check_generator(dropout_gen, self.dropout_gen)
            self.row.zero_()
            self.marks.fill_(-1)
            for _ in range(self.chunk_steps):
                self.graph.replay()
            trace.record_chunk(self.marks, call, self.chunk_steps,
                               self.name)
            return {k: v.clone() for k, v in self.stacks.items()}


class CapturedMeshChunk(CapturedChunk):
    """CapturedChunk over D > 1 data ranks: each iteration two graphs
    around the eager flat all-reduce of `mesh`'s data group
    (``graph.SplitGraph``): A the synthesis and send(batch, drop) -> the
    flat buffer, B receive(flat, lr) and the metric stacks' row (the
    pack, the all-reduce and the unpack lie between the backward and the
    update marks)."""

    def __init__(self, send, receive, mesh, synth_batch_fn,
                 chunk_steps: int, state: list):
        self.send, self.receive, self.mesh = send, receive, mesh
        super().__init__(
            lambda batch, gen, lr: receive(mesh.data_sum_(send(batch, gen)),
                                           lr),
            synth_batch_fn, chunk_steps, state)

    def graph_of(self, gen, drop, gens: list):
        return core.SplitGraph(
            lambda: self.send(self.synthesize(gen), drop),
            self.mesh.data_sum_,
            lambda flat: self.record(self.receive(flat, self.lr)),
            self.state, gens, name=self.name)
