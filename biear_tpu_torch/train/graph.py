"""The train step and the fused train chunk as captured CUDA graphs.

Counterpart of the JAX package's one-dispatch programs:
``make_train_step`` under ``jax.jit(donate_argnums=(0, 1))`` and
``make_train_chunk``'s one jitted ``lax.scan`` (``biear_tpu/train/
loop.py:191-260``). On a CUDA device with no mesh, ``loop.make_train_step``
and ``loop.make_train_chunk`` return the objects of this module:

  * ``CapturedStep``: one graph per batch signature (shapes and dtypes),
    as ``jax.jit`` keeps one compilation per shape. A call copies the
    batch into that graph's static buffers and replays it.
  * ``CapturedChunk``: one graph of synthesis -> train step, replayed
    ``chunk_steps`` times per call. Replay i writes its metrics into row i
    of preallocated (chunk_steps, ...) stacks (a row counter on the
    device, advanced by the graph itself).

A capture runs the function WARMUP_STEPS times on a side stream (cuDNN,
cuBLAS and cuFFT plans, the allocator's blocks, the kernels' first-use
set-up), puts every parameter, Adam moment and count and the generator
state back as they were, and captures the function under
``torch.cuda.graph`` in a private memory pool. Replays update the
parameters and the Adam state in place (JAX's donation). ``lr_scale`` is
a 0-dim device tensor that each replay reads, and the generator is
registered with the graph, so every replay draws what the eager step
draws from the same state: per step the synthesis first, then the
dropout. A kernel inside the graph counts one launch per replay
(``kernels.count_replay``). As a jitted JAX function keeps the precision
it was traced under, a graph replays the MATMUL_PRECISION it was captured
under.

Before each replay the storage of every parameter and state tensor is
checked against the capture's: new storage (``load_state_dict(...,
assign=True)``, ``.to()``, ``p.data = ...``) would leave the graph
reading stale memory, so it raises. A failed capture or replay raises;
there is no eager fallback. The eager loop (``loop.train_step``) stays
the path of the CPU and of a mesh.
"""

from __future__ import annotations

import time

import torch

from ..kernels import count_replay, recording_launches

WARMUP_STEPS = 2     # eager runs on a side stream before a capture


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


def warm_up(fn, state: list, generators: list):
    """Run fn() WARMUP_STEPS times on a side stream, then put `state` and
    the generators' states back as they were. Returns (the last run's
    output, host ms)."""
    device = state[0].device
    t0 = time.perf_counter()
    with torch.no_grad():
        saved = [t.detach().clone() for t in state]
    gen_states = [g.get_state() for g in generators]
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            out = fn()
    main.wait_stream(side)
    with torch.no_grad():
        for t, s in zip(state, saved):
            t.copy_(s)
    for g, s in zip(generators, gen_states):
        g.set_state(s)
    torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


class Graph:
    """fn() captured as one CUDA graph in a private memory pool, its
    output in ``out``; `generators` are registered with it. ``capture_ms``
    (host ms of the capture) and ``pool_bytes`` (the device memory the
    capture reserved) describe it."""

    def __init__(self, fn, state: list, generators: list):
        device = state[0].device
        self.state = state
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        with recording_launches() as rec, torch.cuda.graph(self.graph):
            self.out = fn()
        torch.cuda.synchronize(device)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = rec
        self._ptrs = [t.data_ptr() for t in state]

    def replay(self) -> None:
        """One replay; RuntimeError if a state tensor has new storage."""
        if [t.data_ptr() for t in self.state] != self._ptrs:
            raise RuntimeError(
                "a parameter or optimizer state tensor has new storage since "
                "the train step was captured (load_state_dict(assign=True), "
                ".to(), p.data = ...): the graph would read stale memory; "
                "copy into the tensors in place, or build a new train step")
        self.graph.replay()
        count_replay(self.launches)


def _check_generator(gen, captured) -> None:
    if gen is not captured:
        raise ValueError("a captured train step draws from the generator it "
                         "was captured with: re-seed that generator "
                         "(manual_seed) rather than passing another")


class CapturedStep:
    """(batch, gen, lr_scale) -> metrics: ``step_fn(batch, gen, lr)`` (the
    eager train step) replayed from one CUDA graph per batch signature.
    The metrics are fresh tensors (copies of the graph's outputs)."""

    def __init__(self, step_fn, state: list):
        self.step_fn = step_fn
        self.state = state
        self.device = state[0].device
        self.lr = torch.ones((), device=self.device)
        self.graphs = {}        # signature -> (static batch, gen, Graph)
        self.stats = {}         # signature -> warm-up / capture ms, pool

    def _capture(self, sig, batch, gen) -> None:
        static = tuple(torch.empty(b.shape, dtype=b.dtype,
                                   device=self.device) for b in batch)
        for s, b in zip(static, batch):
            s.copy_(b)
        gens = [] if gen is None else [gen]
        run = lambda: self.step_fn(static, gen, self.lr)
        _, warm_ms = warm_up(run, self.state, gens)
        graph = Graph(run, self.state, gens)
        self.graphs[sig] = (static, gen, graph)
        self.stats[sig] = {"warmup_ms": warm_ms,
                           "capture_ms": graph.capture_ms,
                           "pool_bytes": graph.pool_bytes}

    def __call__(self, batch, gen, lr_scale=1.0) -> dict:
        batch = tuple(batch)
        sig = tuple((tuple(b.shape), b.dtype) for b in batch)
        set_scalar(self.lr, lr_scale)
        if sig not in self.graphs:
            self._capture(sig, batch, gen)
        static, captured, graph = self.graphs[sig]
        _check_generator(gen, captured)
        for s, b in zip(static, batch):
            s.copy_(b, non_blocking=True)
        graph.replay()
        return {k: v.clone() for k, v in graph.out.items()}


class CapturedChunk:
    """(gen, lr_scale) -> metrics stacked over `chunk_steps` synthesize ->
    train steps: ``step_fn(synth_batch_fn(gen), gen, lr)`` captured once
    (with the generator of the first call) and replayed `chunk_steps`
    times per call. ``stats`` holds the warm-up and capture ms and the
    pool's bytes."""

    def __init__(self, step_fn, synth_batch_fn, chunk_steps: int,
                 state: list):
        self.step_fn = step_fn
        self.synth_batch_fn = synth_batch_fn
        self.chunk_steps = chunk_steps
        self.state = state
        self.device = state[0].device
        self.lr = torch.ones((), device=self.device)
        self.row = torch.zeros(1, dtype=torch.long, device=self.device)
        self.gen = self.graph = self.stacks = None
        self.stats = {}

    def capture(self, gen) -> None:
        """Warm up and capture the step with generator `gen` (the first
        call does it when this was not called); trains nothing."""
        gens = [] if gen is None else [gen]
        body = lambda: self.step_fn(self.synth_batch_fn(gen), gen, self.lr)
        warm, warm_ms = warm_up(body, self.state, gens)
        self.stacks = {k: torch.empty((self.chunk_steps, *v.shape),
                                      dtype=v.dtype, device=self.device)
                       for k, v in warm.items()}
        del warm

        def step():
            for k, v in body().items():
                self.stacks[k].index_copy_(0, self.row, v[None])
            self.row.add_(1)

        self.graph = Graph(step, self.state, gens)
        self.gen = gen
        self.stats = {"warmup_ms": warm_ms,
                      "capture_ms": self.graph.capture_ms,
                      "pool_bytes": self.graph.pool_bytes}

    def __call__(self, gen, lr_scale=1.0, dropout_gen=None) -> dict:
        if dropout_gen is not None:
            raise ValueError("a captured chunk draws its dropout from `gen`; "
                             "a mesh rank's streams run the eager chunk")
        set_scalar(self.lr, lr_scale)
        if self.graph is None:
            self.capture(gen)
        else:
            _check_generator(gen, self.gen)
        self.row.zero_()
        for _ in range(self.chunk_steps):
            self.graph.replay()
        return {k: v.clone() for k, v in self.stacks.items()}
