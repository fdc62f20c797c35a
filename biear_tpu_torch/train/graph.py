"""The train step and the fused train chunk as captured CUDA graphs.

Counterpart of the JAX package's one-dispatch programs:
``make_train_step`` under ``jax.jit(donate_argnums=(0, 1))`` and
``make_train_chunk``'s one jitted ``lax.scan`` (``biear_tpu/train/
loop.py:191-260``). On a CUDA device with no mesh, ``loop.make_train_step``
and ``loop.make_train_chunk`` return the objects of this module, built on
the package's capture machinery (``biear_tpu_torch/graph.py``):

  * ``CapturedStep``: a ``graph.Captured`` over the train step, one graph
    per batch signature and precision surface, as ``jax.jit`` keeps one
    compilation per shape. A call copies the batch into that graph's
    static buffers and replays it.
  * ``CapturedChunk``: one graph of synthesis -> train step, replayed
    ``chunk_steps`` times per call. Replay i writes its metrics into row i
    of preallocated (chunk_steps, ...) stacks (a row counter on the
    device, advanced by the graph itself).

Each graph has a private memory pool. The warm-up puts every parameter,
Adam moment and count and the generator state back as they were. Replays
update the parameters and the Adam state in place (JAX's donation).
``lr_scale`` is a 0-dim device tensor that each replay reads, and the
generator is registered with the graph, so every replay draws what the
eager step draws from the same state: per step the synthesis first, then
the dropout. The eager loop (``loop.train_step``) stays the path of the
CPU and of a mesh.
"""

from __future__ import annotations

import torch

from .. import graph as core


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
        warm, warm_ms = core.warm_up(body, self.state, gens, self.device)
        self.stacks = {k: torch.empty((self.chunk_steps, *v.shape),
                                      dtype=v.dtype, device=self.device)
                       for k, v in warm.items()}
        del warm

        def step():
            for k, v in body().items():
                self.stacks[k].index_copy_(0, self.row, v[None])
            self.row.add_(1)

        self.graph = core.Graph(step, self.state, gens)
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
            core.check_generator(gen, self.gen)
        self.row.zero_()
        for _ in range(self.chunk_steps):
            self.graph.replay()
        return {k: v.clone() for k, v in self.stacks.items()}
