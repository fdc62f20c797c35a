"""Hand-written CUDA kernels of the port and their launch counts.

``LAUNCHES[name]`` goes up by one each time kernel ``name`` runs on the
card, and nowhere else, so a run can show that its main path went through
the kernels: clear it, drive the path, read it.

A wrapper counts its launch with ``count_launch``. Under stream capture
(``train/graph.py``) the kernel is recorded, not run: the launch goes to
the capture's ``recording_launches`` counter, and every replay of the
graph adds that counter to ``LAUNCHES`` (``count_replay``), so a kernel
inside a graph counts once per replay.
"""

from __future__ import annotations

import collections
import contextlib

LAUNCHES: collections.Counter = collections.Counter()
_recording: list = []          # counters of the captures in progress


def count_launch(name: str) -> None:
    """One launch of kernel `name`: run now, or recorded by a capture."""
    (_recording[-1] if _recording else LAUNCHES)[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Count the launches of the block in a counter of their own (the
    kernels a graph captured in the block holds), yielded."""
    rec = collections.Counter()
    _recording.append(rec)
    try:
        yield rec
    finally:
        _recording.remove(rec)


def count_replay(recorded: collections.Counter) -> None:
    """One replay of a graph that holds the `recorded` launches."""
    LAUNCHES.update(recorded)
