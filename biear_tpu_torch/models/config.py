"""Model configuration.

A copy of ``biear_tpu/models/config.py::BiEARConfig`` (the port imports
nothing of the JAX package): one frozen dataclass for the experiment
matrix of the reference builders, with the same defaults, properties and
validation. The training fields mean the same in both packages, except
that ``fb_vjp="auto"`` is the hand backward at every batch here:
``fb_vjp`` picks the filterbank backward ("custom" hand backward or
"autodiff"), ``fb_x_grad`` whether it returns spectra gradients, and
``remat_frontend`` whether the "autodiff" filterbank is recomputed in the
backward instead of keeping every frame's Gaussian.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BiEARConfig:
    # signal / framing
    fs: int = 16000
    timesteps: int = 19
    n_fft: int = 1024
    n_bands: int = 100
    fmin: float = 50.0
    fmax: float | None = None          # None -> fs/2 * 0.9
    hop_ratio: float = 1.0

    # backbone dims
    latent_dim: int = 100
    n_sectors: int = 8
    n_dist_class: int = 5

    # features
    use_cc: bool = True

    # frontend Q control
    fixed_frontend_q: bool = False
    controller_mode: str = "dual"      # "dual" | "single"
    freeze_q: bool = False             # force Q = Q0 at runtime
    ctrl_hidden: int = 128
    alpha: float = 0.2                 # kept for settings parity (unused)

    # deltaQ profile
    deltaQ_base: float = 2.0
    deltaQ_low_factor: float = 0.5
    deltaQ_high_factor: float = 1.0
    deltaQ_mode: str = "absolute"      # "absolute" | "relative"

    # Q clamp
    q_min: float = 0.05
    q_max: float = 30.0

    # dropout rates
    ctrl_dropout: float = 0.1
    backend_dropout: float = 0.2

    remat_frontend: bool = True

    # filterbank operand dtype: "float32" = the f32 parity surface;
    # "bfloat16" = the production policy (both operands rounded to bf16,
    # f32 accumulation).
    fb_w_dtype: str = "float32"
    fb_vjp: str = "auto"
    fb_x_grad: bool = False

    # frame spectra: "fft" = rFFT; "matmul" = windowed DFT as a product;
    # "auto" = the product's contract exactly under the bf16 policy: the
    # product on the CPU, kernels/spectra.cu on the card.
    dft_mode: str = "auto"

    # AuralNet baseline
    d_model: int = 128
    attn_heads: int = 4
    attn_layers: int = 2
    attn_dropout: float = 0.1

    def __post_init__(self):
        if self.fb_w_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"fb_w_dtype must be 'float32' or 'bfloat16', "
                f"got {self.fb_w_dtype!r}")
        if self.fb_vjp not in ("auto", "custom", "autodiff"):
            raise ValueError(
                f"fb_vjp must be 'auto', 'custom' or 'autodiff', "
                f"got {self.fb_vjp!r}")
        if self.dft_mode not in ("auto", "fft", "matmul"):
            raise ValueError(
                f"dft_mode must be 'auto', 'fft' or 'matmul', "
                f"got {self.dft_mode!r}")

    @property
    def use_dft_matmul(self) -> bool:
        """Resolve dft_mode: 'auto' ties the DFT product to the bf16
        policy (run as the product on the CPU and as
        ``kernels/spectra.cu`` on the card, ``models/frontend.py::
        spectra_on_kernel``); the f32 parity surface keeps the rFFT."""
        if self.dft_mode == "auto":
            return self.fb_w_dtype == "bfloat16"
        return self.dft_mode == "matmul"

    @property
    def fmax_eff(self) -> float:
        return self.fs / 2.0 * 0.9 if self.fmax is None else self.fmax

    @property
    def f_nyq(self) -> float:
        return self.fs / 2.0

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1
