"""Hand-written CUDA kernels of the port and their launch counts.

``LAUNCHES[name]`` goes up by one each time a wrapper launches kernel
``name`` on the card, and nowhere else, so a run can show that its main
path went through the kernels: clear it, drive the path, read it.
"""

from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()
