"""The dual frontend's reverse-recurrence kernel's yardstick: its
multiply-adds and bytes from its shape, and the card's f32 FMA rate.

``biear_tpu_torch/kernels/frontend_bwd.cu`` takes one frame of both ears'
Q-controllers and filterbank back in one launch. Its least time is the
larger of the data-gradient path's multiply-adds at the card's f32 FMA
rate and its bytes at the HBM bandwidth (``perfbench.bounds.least_time``).
Only the data-gradient path counts (the products with the transposed
weights), not a recompute of the forward nor the weight gradients, which
run after the launches: the share reads the same work whatever
implements it.
"""

from __future__ import annotations

# One f32 FMA per lane a clock: 128 on each SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0) x 132
# SMs x 1,980 MHz, the H100 SXM's boost clock.
FMA_PEAKS = {"NVIDIA H100 80GB HBM3": 132 * 128 * 1.98e9}


def fma_peak(kind: str):
    """f32 multiply-adds a second of card `kind`, or None for a card not
    in the table."""
    return FMA_PEAKS.get(kind)


def frontend_bwd(rows: int, bands: int, hidden: int, n_in: int,
                 with_ctrl: bool, with_input: bool) -> tuple:
    """(multiply-adds, bytes) of one launch over `rows` rows (both ears'
    B), N `bands`, H `hidden` and `n_in` GRU inputs.

    with_ctrl, the controller step's backward: the products with Linear
    8's, 4's and 0's weights (N H + 2 H^2 a row); it reads each row's GRU
    workspace (5 H), both LayerNorms' inputs and outputs (4 H), their
    means and 1 / std (4), tanh's output and Q before the clamp (2 N) and
    the carried gradient of Q (N), and writes the row's activation
    gradients (12 H + N). with_input besides, the products with the GRU's
    hidden weights and its first N input columns (3 H (H + N) a row) and
    the gradient of h it writes (H); the filterbank's VJP reads Q, bw, Y,
    Zre, Zim, den (6 N), T (4 N), the finite mask (N bytes) and the
    outputs' gradients (3 N), and writes the gradient of Q (N). Each
    weight the launch uses is read once an ear; all float32. The dropout
    masks and the carried gradient of h, which not every launch reads,
    are left out."""
    N, H = bands, hidden
    macs = 0
    floats = 0
    weights = 0
    if with_ctrl:
        macs += N * H + 2 * H * H
        floats += 5 * H + 4 * H + 4 + 2 * N + N + 12 * H + N
        weights += N * H + 2 * H * H + 2 * H
        if with_input:
            macs += 3 * H * (H + N)
            floats += H
            weights += 3 * H * (H + N)
    nbytes = 4.0 * rows * floats + 4.0 * 2 * weights
    if with_input:
        nbytes += rows * (4.0 * (6 * N + 4 * N + 3 * N + N) + N)
    return float(rows) * macs, nbytes
