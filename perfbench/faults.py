"""Faults planted in the program under a run, to see `correct` come out
false: a step that returns its state unchanged, half of the batch left
out (the mean over the rest), an answer altered where it is produced.
(One chip: there is no exchange between chips to leave out.)

``plant(fault)`` patches the training program's module attributes for
the block."""

from __future__ import annotations

import contextlib

FAULTS = ("state unchanged", "half the batch", "answer altered")


def _patches(fault: str) -> list:
    from biear_tpu_torch.data import synth
    from biear_tpu_torch.train import loop, optim
    if fault == "state unchanged":
        return [(optim.Adam, "step", lambda self, *a, **k: None)]
    if fault == "half the batch":
        loss = loop.model_loss
        return [(loop, "model_loss", lambda m, hp, b, g: loss(
            m, hp, tuple(t[:t.shape[0] // 2] for t in b), g))]
    cc = synth.cross_correlation_feature
    return [(synth, "cross_correlation_feature",
             lambda *a, **k: 0.5 * cc(*a, **k))]


@contextlib.contextmanager
def plant(fault: str):
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    patches = _patches(fault)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, new in patches:
        setattr(obj, name, new)
    try:
        yield
    finally:
        for obj, name, old in saved:
            setattr(obj, name, old)
