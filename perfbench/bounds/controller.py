"""The dual frontend's forward controller kernel's yardstick: its
multiply-adds and bytes from its shape.

``biear_tpu_torch/kernels/controller_fwd.cu`` takes one frame of both
ears' Q-controller steps forward in one launch. Its least time is the
larger of its products' multiply-adds at the card's f32 FMA rate
(``perfbench.bounds.frontend.fma_peak``) and its bytes at the HBM
bandwidth (``perfbench.bounds.least_time``).
"""

from __future__ import annotations


def controller_fwd(rows: int, bands: int, hidden: int, n_in: int) -> tuple:
    """(multiply-adds, bytes) of one launch over `rows` rows (both ears'
    B), N `bands`, H `hidden` and `n_in` GRU inputs.

    Per row, the GRU's input and hidden products (3 H n_in + 3 H^2),
    Linear 0 and 4 (H^2 each) and Linear 8 (N H). It reads the row's band
    energies (N) and hidden state (H), float32, and its two dropout
    keep-masks (2 H bytes); it writes the step's saved set (the features
    n_in, the GRU workspace 5 H, hy, both LayerNorms' inputs, outputs,
    dropout outputs (7 H), their means and 1 / std (4), tanh's output and
    Q before the clamp (2 N)), Q' (N) and h' (H), float32. Each ear's
    weights, biases and LayerNorm parameters are read once."""
    N, H = bands, hidden
    macs = 3 * H * n_in + 3 * H * H + 2 * H * H + N * H
    floats = (N + H) + (n_in + 13 * H + 4 + 2 * N) + (N + H)
    weights = macs + 12 * H + N
    nbytes = 4.0 * rows * floats + rows * 2.0 * H + 4.0 * 2 * weights
    return float(rows) * macs, nbytes
