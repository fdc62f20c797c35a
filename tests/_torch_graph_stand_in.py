"""CPU stand-ins for the CUDA calls of the port's capture machinery
(``biear_tpu_torch/graph.py``), so its capture logic (warm-up, restore,
the graphs' replays, the metric stacks) runs on a machine without a card.

``StandInGraph`` has ``graph.Graph``'s interface: its 'capture' runs fn
once and puts the state and generators back (a capture runs nothing);
each replay runs fn again, writing its output into the first run's
tensors. ``install(setattr)`` puts the stand-ins in place through a
``setattr`` (pytest's ``monkeypatch.setattr``, or the builtin in a worker
process).
"""

import contextlib

import torch

from biear_tpu_torch import graph as cgraph
from biear_tpu_torch.kernels import count_replay, recording_launches


class StandInGraph:
    """Graph's interface on the CPU: the 'capture' runs fn once and puts
    the state and generators back (a capture runs nothing); each replay
    runs fn again, writing its output into the first run's tensors."""

    def __init__(self, fn, state, generators, pool=None):
        saved = [t.detach().clone() for t in state]
        gen_states = [g.get_state() for g in generators]
        with recording_launches() as rec:
            self.out = fn()
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        for g, s in zip(generators, gen_states):
            g.set_state(s)
        self.fn, self.launches = fn, rec
        self.capture_ms, self.pool_bytes = 0.0, 0

    def replay(self):
        out = self.fn()
        if out is not None:
            for k, v in out.items():
                self.out[k].copy_(v)
        count_replay(self.launches)


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
