"""The single frontend's reverse-recurrence kernel's yardstick: its
multiply-adds and bytes from its shape.

``biear_tpu_torch/kernels/frontend_bwd.cu``'s single entry takes one
frame of the shared Q-controller and both ears' filterbank back in one
launch. Its least time is the larger of the data-gradient path's
multiply-adds at the card's f32 FMA rate
(``perfbench.bounds.frontend.fma_peak``) and its bytes at the HBM
bandwidth (``perfbench.bounds.least_time``). As for the dual entry
(``perfbench.bounds.frontend``), only the data-gradient path counts, not
a recompute of the forward nor the weight gradients, which run after the
launches.
"""

from __future__ import annotations


def single_bwd(rows: int, bands: int, hidden: int, n_in: int,
               with_ctrl: bool, with_input: bool) -> tuple:
    """(multiply-adds, bytes) of one launch over `rows` controller rows
    (the batch B; the filterbank's rows are both ears' 2B), N `bands`, H
    `hidden` and `n_in` GRU inputs (4N: [YL, memL, YR, memR]).

    with_ctrl, the controller step's backward: the products with Linear
    8's, 4's and 0's weights (N H + 2 H^2 a row); it reads each row's GRU
    workspace (5 H), both LayerNorms' inputs and outputs (4 H), their
    means and 1 / std (4), tanh's output and Q before the clamp (2 N) and
    the carried gradient of Q (N), and writes the row's activation
    gradients (12 H + N). with_input besides, the products with the GRU's
    hidden weights and its two ears' N input columns (3 H (H + 2 N) a
    row) and the gradient of h it writes (H). with_input, the filterbank's
    VJP over 2B rows reads Q, bw, Y, Zre, Zim, den (6 N), T (4 N), the
    finite mask (N bytes) and the outputs' gradients (3 N), and each
    controller row writes its gradient of Q (N). The weights the launch
    uses are read once; all float32. The dropout masks and the carried
    gradient of h, which not every launch reads, are left out."""
    N, H = bands, hidden
    macs = 0
    floats = 0
    weights = 0
    if with_ctrl:
        macs += N * H + 2 * H * H
        floats += 5 * H + 4 * H + 4 + 2 * N + N + 12 * H + N
        weights += N * H + 2 * H * H + 2 * H
        if with_input:
            macs += 3 * H * (H + 2 * N)
            floats += H
            weights += 3 * H * (H + 2 * N)
    nbytes = 4.0 * rows * floats + 4.0 * weights
    if with_input:
        nbytes += 2 * rows * (4.0 * 13 * N + N) + 4.0 * rows * N
    return float(rows) * macs, nbytes
