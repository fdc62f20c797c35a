"""Captured CUDA graphs: the port's counterpart of a jitted JAX program.

A JAX entry point that is ``jax.jit`` (or a ``lax.scan`` inside one) runs
as one dispatch; on a CUDA device with no mesh or a mesh without a model
axis (``use_capture``) the port's entry points replay CUDA graphs built
here:

  * ``Captured``: fn(inputs, generator) replayed from one graph per key
    (``Captured.key``: the inputs' shapes and dtypes, the MATMUL_PRECISION
    surface ``device.precision_key()`` and, for a model's graphs, its
    training flag), as ``jax.jit`` keeps one compilation per signature.
    A call copies the inputs into that graph's static buffers (a numpy
    array from pinned memory, ``host_input``), replays and returns clones
    of the graph's outputs, so a later replay never changes what an
    earlier call returned (JAX's value semantics). The train step
    (``train/graph.py::CapturedStep``) and the inference forwards
    (``predict``, the eval step and eval forward, the stream hop) are
    ``Captured``.
  * ``SplitGraph``: a step as two graphs around an eager call, the train
    step over D > 1 data ranks (``train/graph.py::CapturedMeshStep`` and
    ``CapturedMeshChunk``): graph A the forward, backward and the packing
    of the gradients into a static flat buffer, then the data group's
    all-reduce of that buffer (NCCL or gloo, eagerly), then graph B the
    update.
  * ``CapturedEvalChunk``: the eval of row r of a stack of same-shape
    batches (r a device counter the graph advances), captured once per
    stack and replayed once per row into preallocated metric stacks (JAX's
    ``lax.scan`` over ``make_eval_chunk``'s stacks). It reads the stacks
    in place, as the scan does, so a split is held on the card once.

A capture runs fn WARMUP_STEPS times on a side stream (cuDNN, cuBLAS and
cuFFT plans, the allocator's blocks, the kernels' first-use set-up), puts
every state tensor and generator state back as they were, and captures fn
under ``torch.cuda.graph``: in a private memory pool, or, for the graphs
of one model (``graph_pool``), in the pool they share, since they never
replay at the same time and each output is cloned or written outside the
pool as its replay ends. As a jitted JAX function keeps the precision it
was traced under, a graph replays the surface it was captured under. A
kernel inside a graph counts one launch per replay
(``kernels.count_replay``). Before each replay the storage of every state
tensor is checked against the capture's: new storage
(``load_state_dict(..., assign=True)``, ``.to()``, ``p.data = ...``)
would leave the graph reading stale memory, so it raises. A failed
capture or replay raises; there is no eager fallback.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch
import torch.distributed as dist

from .device import precision_key
from .kernels import count_replay, recording_launches

WARMUP_STEPS = 2     # eager runs on a side stream before a capture


def on_card(model) -> bool:
    """Whether `model` lives on a CUDA device."""
    return next(model.parameters()).is_cuda


def use_capture(model, mesh, capture: bool | None) -> bool:
    """Whether an entry point replays captured CUDA graphs: by default
    exactly on a CUDA device without a mesh or under a mesh without a
    model axis (MESH_MODEL 1), whose one collective, the train step's
    flat all-reduce over 'data', runs eagerly between two graphs;
    ``capture=False`` takes the eager path on the card; ``capture=True``
    under a model axis (its collectives run inside autograd's forward and
    backward, which no graph splits around) or on the CPU raises."""
    model_axis = mesh is not None and mesh.model > 1
    if capture and model_axis:
        raise ValueError("capture=True under a model axis (MESH_MODEL > 1): "
                         "its collectives run inside autograd's forward and "
                         "backward (parallel/mesh.py), so the step runs "
                         "eagerly")
    if capture and not on_card(model):
        raise ValueError("capture=True needs the model on a CUDA device: "
                         "the CPU runs the eager path")
    if capture is None:
        return on_card(model) and not model_axis
    return bool(capture)


def warm_up(fn, state: list, generators: list, device):
    """Run fn() WARMUP_STEPS times on a side stream of `device`, then put
    `state` and the generators' states back as they were. Returns (the
    last run's output, host ms)."""
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
    """fn() captured as one CUDA graph in a private memory pool (or in
    `pool`, shared), its output in ``out``; `generators` are registered
    with it. ``capture_ms`` (host ms of the capture) and ``pool_bytes``
    (the device memory the capture reserved) describe it."""

    def __init__(self, fn, state: list, generators: list, pool=None):
        device = state[0].device
        self.state = state
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        # in a process group, the collectives' watchdog thread queries
        # their events while this thread captures: only this thread's
        # unsafe calls may end the capture
        mode = "thread_local" if dist.is_initialized() else "global"
        with recording_launches() as rec, torch.cuda.graph(
                self.graph, pool=pool, capture_error_mode=mode):
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
                "the graph was captured (load_state_dict(assign=True), "
                ".to(), p.data = ...): the graph would read stale memory; "
                "copy into the tensors in place, or build a new model, "
                "train step or eval step")
        self.graph.replay()
        count_replay(self.launches)


class SplitGraph:
    """A step captured as two CUDA graphs around an eager call: graph A
    runs before(), which returns a static buffer (the same tensor at every
    call), graph B runs after(buffer); a replay is A, between(buffer), B.
    `between` is what a graph cannot hold, such as a gloo or NCCL
    collective over several processes. ``out`` is B's output;
    ``launches``, ``capture_ms`` and ``pool_bytes`` are the pair's."""

    def __init__(self, before, between, after, state: list,
                 generators: list):
        a = Graph(lambda: {"sent": before()}, state, generators)
        sent = a.out["sent"]
        b = Graph(lambda: after(sent), state, generators)
        self.graphs, self.between, self.sent = (a, b), between, sent
        self.out = b.out
        self.launches = a.launches + b.launches
        self.capture_ms = a.capture_ms + b.capture_ms
        self.pool_bytes = a.pool_bytes + b.pool_bytes

    def replay(self) -> None:
        a, b = self.graphs
        a.replay()
        self.between(self.sent)
        b.replay()


def generators_of(*gens) -> list:
    """The distinct torch.Generators behind `gens` (each None, a generator
    or a mesh rank's ``RankGenerators``), in order: those a graph
    registers and a warm-up puts back."""
    out = []
    for g in gens:
        for x in ([] if g is None else [g] if isinstance(g, torch.Generator)
                  else g.generators()):
            if not any(x is y for y in out):
                out.append(x)
    return out


def check_generator(gen, captured) -> None:
    if gen is not captured:
        raise ValueError("a captured graph draws from the generator it was "
                         "captured with: re-seed that generator "
                         "(manual_seed) rather than passing another")


def host_input(x):
    """A numpy array as a tensor in pinned host memory (when there is a
    card), so its copy into a graph's static buffer runs asynchronously;
    a tensor as it is."""
    if isinstance(x, torch.Tensor):
        return x
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.pin_memory() if torch.cuda.is_available() else t


def tree_clone(tree):
    """Clones of the tensors of a tensor, tuple or dict (nested)."""
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_clone(v) for v in tree)
    return tree.clone()


def graph_pool(model):
    """The memory pool the graphs of `model`'s forwards share, made at the
    first capture and kept on the model."""
    if "_graph_pool" not in model.__dict__:
        model.__dict__["_graph_pool"] = torch.cuda.graph_pool_handle()
    return model.__dict__["_graph_pool"]


class Captured:
    """fn(inputs, gen) -> outputs (a tensor, or a tuple or dict of them)
    replayed from one CUDA graph per ``key``. `state` is every tensor fn
    reads or updates in place besides its inputs (checked per replay, put
    back after the warm-up). With `model`, the graphs are the model's
    forwards `name`: they go into the model's shared pool, count in
    ``pool_stats(model)``, and the key holds ``model.training``. A
    generator passed at the first call is registered with the graph; a
    later call must pass the same one. ``stats`` holds each graph's
    warm-up and capture ms and pool bytes."""

    def __init__(self, fn, state: list, *, model=None, name: str = ""):
        self.fn = fn
        self.state = state
        self.device = state[0].device
        self.model = model
        self.pool = None if model is None else graph_pool(model)
        self.name = name
        self.graphs = {}        # key -> (static inputs, gen, Graph, outputs)
        self.stats = {}         # key -> warm-up / capture ms, pool bytes
        if model is not None:
            model.__dict__.setdefault("_graphs", weakref.WeakSet()).add(self)

    def key(self, inputs: tuple) -> tuple:
        """What changes what the graph computes: the inputs' shapes and
        dtypes, the precision surface and the model's training flag."""
        mode = () if self.model is None else (self.model.training,)
        return (tuple((tuple(x.shape), x.dtype) for x in inputs),
                precision_key(), *mode)

    def static(self, inputs: tuple) -> tuple:
        """The graph's own input buffers (normal tensors: copied into from
        inference mode or not)."""
        with torch.inference_mode(False):
            return tuple(torch.empty(x.shape, dtype=x.dtype,
                                     device=self.device) for x in inputs)

    def load(self, static: tuple, inputs: tuple) -> None:
        for s, x in zip(static, inputs):
            s.copy_(x, non_blocking=True)

    def capture(self, static: tuple, gen):
        """(Graph, its outputs, warm-up ms) of fn on the static inputs."""
        gens = generators_of(gen)
        run = lambda: self.fn(static, gen)
        _, warm_ms = warm_up(run, self.state, gens, self.device)
        graph = self.graph_of(run, static, gen, gens)
        return graph, graph.out, warm_ms

    def graph_of(self, run, static: tuple, gen, gens: list):
        """The graph of run() (fn on the static inputs)."""
        return Graph(run, self.state, gens, self.pool)

    def replay(self, graph: Graph, static: tuple) -> None:
        graph.replay()

    def __call__(self, inputs, gen=None):
        inputs = tuple(inputs)
        key = self.key(inputs)
        if key not in self.graphs:
            static = self.static(inputs)
            self.load(static, inputs)
            graph, out, warm_ms = self.capture(static, gen)
            self.graphs[key] = (static, gen, graph, out)
            self.stats[key] = {"warmup_ms": warm_ms,
                               "capture_ms": graph.capture_ms,
                               "pool_bytes": graph.pool_bytes}
        static, captured, graph, out = self.graphs[key]
        check_generator(gen, captured)
        self.load(static, inputs)
        self.replay(graph, static)
        return tree_clone(out)


def model_state(model) -> list:
    """The tensors a forward of `model` reads: parameters and buffers."""
    return [*model.parameters(), *model.buffers()]


def no_grad(fn):
    """fn run without gradients: a forward's graph records none."""
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def forward(model, name: str, fn) -> Captured:
    """`model`'s captured forward `name`: (inputs) -> fn(*inputs), without
    gradients."""
    return Captured(no_grad(lambda inputs, gen: fn(*inputs)),
                    model_state(model), model=model, name=name)


def captured_forward(model, name: str, fn) -> Captured:
    """The captured forward `name` of `model` (``forward``), made from `fn`
    at the first call and kept on the model, so its graphs go away with
    it."""
    cache = model.__dict__.setdefault("_captured_forwards", {})
    if name not in cache:
        cache[name] = forward(model, name, fn)
    return cache[name]


class CapturedEvalChunk(Captured):
    """stacks -> metrics stacked over the stacks' leading (n_batches,)
    axis: ``fn(batch)`` of stack row r (a device counter the graph
    advances) captured once per stack and replayed n_batches times per
    call, row r's metrics written into row r of preallocated stacks (JAX's
    ``lax.scan`` over the stacked batches). The graph reads the caller's
    stacks in place: it keeps them (they are part of its key, by address)
    and copies nothing in, so a stacked split is held once."""

    def __init__(self, fn, model, name: str = "eval_chunk"):
        super().__init__(no_grad(lambda batch, gen: fn(batch)),
                         model_state(model), model=model, name=name)
        self.row = torch.zeros(1, dtype=torch.long, device=self.device)

    def key(self, stacks: tuple) -> tuple:
        return (super().key(stacks),
                tuple((x.data_ptr(), x.stride()) for x in stacks))

    def static(self, stacks: tuple) -> tuple:
        if any(x.device != self.device for x in stacks):
            raise ValueError("a captured eval chunk reads its stacks in "
                             f"place: they must be on {self.device}")
        return stacks

    def load(self, static: tuple, stacks: tuple) -> None:
        pass

    def capture(self, stacks: tuple, gen):
        body = lambda: self.fn(tuple(s.index_select(0, self.row)[0]
                                     for s in stacks), gen)
        self.row.zero_()
        warm, warm_ms = warm_up(body, self.state, [], self.device)
        with torch.inference_mode(False):
            out = {k: torch.empty((stacks[0].shape[0], *v.shape),
                                  dtype=v.dtype, device=self.device)
                   for k, v in warm.items()}
        del warm

        def step():
            for k, v in body().items():
                out[k].index_copy_(0, self.row, v[None])
            self.row.add_(1)

        return Graph(step, self.state, [], self.pool), out, warm_ms

    def replay(self, graph: Graph, stacks: tuple) -> None:
        self.row.zero_()
        for _ in range(stacks[0].shape[0]):
            graph.replay()


def pool_stats(model) -> dict:
    """{name: [each graph's warm-up ms, capture ms, pool bytes]} of every
    live captured forward and eval chunk of `model` (the graphs of its
    shared pool), and the bytes of that pool (their sum)."""
    out = {}
    for c in list(model.__dict__.get("_graphs", ())):
        out.setdefault(c.name, []).extend(c.stats.values())
    out["pool_bytes"] = sum(s["pool_bytes"] for v in out.values()
                            for s in v)
    return out
