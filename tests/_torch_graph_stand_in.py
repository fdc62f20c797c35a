"""CPU stand-ins for the CUDA calls of the port's capture machinery
(``biear_tpu_torch/graph.py``), so its capture logic (warm-up, restore,
the graphs' replays, the metric stacks, the stage marks) runs on a
machine without a card.

``StandInGraph`` is a ``graph.Graph`` whose CUDA graph is a stand-in:
its 'capture' runs fn once and puts the state and generators back (a
capture runs nothing); each replay (``Graph.replay``: the storage check,
the ``graph.launch`` span, the launch counts) runs fn again, writing its
output into the first run's tensors, inside the recorder's step sink
that was active at the capture (a captured graph holds its mark nodes).
``install(setattr)`` puts the stand-ins in place through a ``setattr``
(pytest's ``monkeypatch.setattr``, or the builtin in a worker process).
"""

import contextlib

import torch

from biear_tpu_torch import graph as cgraph
from biear_tpu_torch import trace
from biear_tpu_torch.kernels import recording_launches


class StandInCUDAGraph:
    """torch.cuda.CUDAGraph's replay on the CPU: fn run again, its output
    copied into the capture's, under the capture's step sink."""

    def __init__(self, fn, out, sink):
        self.fn, self.out, self.sink = fn, out, sink

    def replay(self):
        with (trace.step_sink(*self.sink) if self.sink
              else contextlib.nullcontext()):
            out = self.fn()
        if out is not None:
            for k, v in out.items():
                self.out[k].copy_(v)


class StandInGraph(cgraph.Graph):
    """Graph on the CPU: the 'capture' (a ``graph.capture`` span, as
    Graph's) runs fn once and puts the state and generators back (a
    capture runs nothing); each replay runs fn again, writing its output
    into the first run's tensors."""

    def __init__(self, fn, state, generators, pool=None,
                 name=None):
        saved = [t.detach().clone() for t in state]
        gen_states = [g.get_state() for g in generators]
        with trace.span("graph.capture"), recording_launches() as rec:
            self.out = fn()
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        for g, s in zip(generators, gen_states):
            g.set_state(s)
        self.graph = StandInCUDAGraph(fn, self.out, trace.active_sink())
        self.state, self.name, self.launches = state, name, rec
        self._ptrs = [t.data_ptr() for t in state]
        self.capture_ms, self.pool_bytes = 0.0, 0


class NoStream:
    def wait_stream(self, other):
        pass


def install(setattr_) -> None:
    """graph.py's CUDA calls as the CPU stand-ins above."""
    setattr_(cgraph, "Graph", StandInGraph)
    setattr_(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    setattr_(torch.cuda, "current_stream", lambda *a: NoStream())
    setattr_(torch.cuda, "Stream", lambda *a: NoStream())
    setattr_(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    setattr_(torch.cuda, "synchronize", lambda *a: None)
