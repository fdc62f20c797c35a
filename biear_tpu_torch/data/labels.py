"""Label layout: the 56-dim per-sample target vector.

A copy of the constants of ``biear_tpu/data/labels.py`` (the port imports
nothing of the JAX package). Layout: 8 sectors x [sound_presence,
angle_norm, 5-way one-hot distance], where distance index 0 = no source
and 1..4 are the classes {0.5, 1, 2, 3} m shifted by +1.
"""

from __future__ import annotations

import numpy as np

N_SECTORS = 8
N_DIST_CLASSES = 5
DIST_CLASSES = np.array([0.5, 1.0, 2.0, 3.0], dtype=np.float64)
