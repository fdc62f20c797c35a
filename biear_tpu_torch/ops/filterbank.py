"""Gaussian filterbank: forward, and the hand backward for training.

Counterpart of ``biear_tpu/ops/filterbank.py``: per frame and ear, a
(B, N, F) Gaussian G is built from the current Q and contracted against
the stacked rhs [mag, re, im, 1] (B, 4, F). The ones row carries sum_f G,
so the row normalisation happens after the contraction (divide-after
form): Y = sum_f G |X| / den, Z = sum_f G X / den.

The JAX filterbank is plain XLA, not a Pallas kernel, so this stays plain
PyTorch. ``FilterbankFn`` is the JAX custom VJP as a
``torch.autograd.Function``: both gradients are contractions of
forward-sized shape, so the (B, N, F) cotangent of G never exists:

    dL/dQ_bn   = -fc_n / (Q + eps)^2 / bw_bn * sum_c g4_bnc T_bnc,
                 T = sum_f G z^2 rhs                      (B, N, 4)
    dL/drhs    = sum_n G g4                               (B, 4, F)

with g4 the cotangents of the pre-division numerators. Modes: "f32" and
"bf16", each with "|noxg" when the spectra are off the gradient path; in
"bf16|noxg" the forward computes T from its own G and saves only (B, N)
and (B, N, 4) tensors.

Precision policies:
  * f32: the exact association exp(-0.5 ((f - fc) / bw)^2), f32 product.
  * bf16: the divide-free build exp(D / bw^2), D = -0.5 (f - fc)^2; both
    operands are rounded to bf16 and contracted in f32, which is what
    JAX's bf16 operands with an f32 result compute (a bf16 torch matmul
    would round the result too).
Every product is pinned to full f32 with TF32 off on the card, forward
and backward, whatever MATMUL_PRECISION says (JAX pins them to HIGHEST).

Under the bf16 policy the forward's build and contraction go through one
contract, ``gauss_contract``: on a CUDA tensor one launch of
``kernels/fb_gauss.cu`` (the Gaussian built in registers, its bf16 values
bit for bit the plain path's, the contraction on the tensor cores with f32
sums, the normalisation), on a CPU tensor ``gauss_contract_plain``, the
plain ops above. ``FilterbankFn``'s forward (both bf16 modes) and
``fb_forward`` without a gradient to take (predict, evaluation,
streaming) call it; the f32 policy, ``fb_forward`` under autograd and the
recomputing backward of the "bf16" mode stay plain.
"""

from __future__ import annotations

import collections

import torch

from ..device import precision_highest
from ..kernels import count_launch

EPS_Q = 1e-8
EPS_BW = 1e-8
EPS_NORM = 1e-8


def _gauss(Q: torch.Tensor, fc: torch.Tensor, f_fft: torch.Tensor):
    """Reference association: (bw (B, N, 1), z (B, N, F), G (B, N, F))."""
    bw = (fc / (Q + EPS_Q))[..., None] + EPS_BW
    z = (f_fft[None, :] - fc[:, None]) / bw
    return bw, z, torch.exp(-0.5 * z * z)


def _gauss_fast(Q: torch.Tensor, fc: torch.Tensor, f_fft: torch.Tensor):
    """Divide-free build: (bw, t = log G, G = exp(D s)), s = 1 / bw^2."""
    bw = (fc / (Q + EPS_Q))[..., None] + EPS_BW
    D = -0.5 * torch.square(f_fft[None, :] - fc[:, None])    # (N, F)
    t = D * (1.0 / torch.square(bw))
    return bw, t, torch.exp(t)


def fb_gauss(Q: torch.Tensor, fc: torch.Tensor,
             f_fft: torch.Tensor) -> torch.Tensor:
    """Unnormalised Gaussian G (B, N, F), reference association (f32)."""
    return _gauss(Q, fc, f_fft)[2]


def fb_gauss_fast(Q: torch.Tensor, fc: torch.Tensor,
                  f_fft: torch.Tensor) -> torch.Tensor:
    """Divide-free G = exp(D * s), D = -0.5 (f - fc)^2, s = 1 / bw^2 (bf16)."""
    return _gauss_fast(Q, fc, f_fft)[2]


def stack_rhs(Xmag: torch.Tensor, Xre: torch.Tensor, Xim: torch.Tensor,
              bf16: bool = False) -> torch.Tensor:
    """Contraction rhs (..., 4, F) = [mag, re, im, 1], in bf16 under the
    bf16 policy."""
    rhs = torch.stack([Xmag, Xre, Xim, torch.ones_like(Xmag)], dim=-2)
    return rhs.to(torch.bfloat16) if bf16 else rhs


class _HighestEinsum(torch.autograd.Function):
    """Two-operand einsum with f32 sums and TF32 off on the card, forward
    and backward, under every MATMUL_PRECISION (JAX pins the filterbank's
    products, and so their transposes, to HIGHEST). Every index of
    ``sub`` appears in two of its three terms."""

    @staticmethod
    def forward(ctx, sub: str, lhs, rhs):
        ctx.terms = sub.replace("->", ",").split(",")
        ctx.save_for_backward(lhs, rhs)
        with precision_highest():
            return torch.einsum(sub, lhs, rhs)

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.terms
        lhs, rhs = ctx.saved_tensors
        with precision_highest():
            ga = (torch.einsum(f"{out},{b}->{a}", g, rhs)
                  if ctx.needs_input_grad[1] else None)
            gb = (torch.einsum(f"{out},{a}->{b}", g, lhs)
                  if ctx.needs_input_grad[2] else None)
        return None, ga, gb


def _dot(lhs: torch.Tensor, rhs: torch.Tensor, bf16: bool,
         sub: str) -> torch.Tensor:
    """einsum with f32 sums; under bf16 both operands are rounded first."""
    if bf16:
        lhs = lhs.to(torch.bfloat16).float()
        rhs = rhs.to(torch.bfloat16).float()
    return _HighestEinsum.apply(sub, lhs, rhs.float())


def _normalise(out: torch.Tensor):
    """(B, N, 4) numerators -> (Y, Zre, Zim, den, finite mask of Y)."""
    den = out[..., 3] + EPS_NORM
    Y_raw = out[..., 0] / den
    Y = torch.nan_to_num(Y_raw, nan=0.0, posinf=0.0, neginf=0.0)
    return Y, out[..., 1] / den, out[..., 2] / den, den, torch.isfinite(Y_raw)


# (rows, bands, bins, with_t) of every fb_gauss.cu launch made or captured
# in this process, counted (the benchmark's roofline reader takes the
# kernel's shape from here)
LAUNCH_SHAPES: collections.Counter = collections.Counter()


def gauss_contract_plain(Q: torch.Tensor, rhs: torch.Tensor,
                         fc: torch.Tensor, f_fft: torch.Tensor,
                         with_t: bool) -> tuple:
    """The bf16 forward of one frame in plain ops: Q (R, N), rhs (R, 4, F)
    -> (Y, Zre, Zim, den, finite, bw, T), each (R, N) but T (R, N, 4), or
    None without `with_t`."""
    bw, t, G = _gauss_fast(Q, fc, f_fft)
    out = _dot(G, rhs, True, "bnf,bcf->bnc")
    T = (_dot(G * (-2.0 * t), rhs, True, "bnf,bcf->bnc") if with_t
         else None)
    return (*_normalise(out), bw[..., 0], T)


def gauss_contract_cuda(Q: torch.Tensor, rhs: torch.Tensor,
                        fc: torch.Tensor, f_fft: torch.Tensor,
                        with_t: bool) -> tuple:
    """gauss_contract_plain as one launch of ``fb_gauss.cu`` on the current
    stream. rhs is bf16 with contiguous bins and any row and channel
    strides (a frame of the frontend's (T, 2B, 4, F) stack is read in
    place); Q float32 with contiguous bands and any row stride."""
    from ..kernels.build import check_launch, fb_gauss_lib

    shapes = [tuple(x.shape) for x in (Q, rhs, fc, f_fft)]
    if not ([len(x) for x in shapes] == [2, 3, 1, 1]
            and shapes[1][:2] == (shapes[0][0], 4)
            and shapes[2][0] == shapes[0][1]
            and shapes[3][0] == shapes[1][2] and min(shapes[1]) > 0
            and shapes[0][1] > 0):
        raise ValueError("fb_gauss needs Q (R, N), rhs (R, 4, F), fc (N) "
                         f"and f_fft (F), got {shapes}")
    dev = Q.device
    if not (Q.is_cuda and all(x.device == dev for x in (rhs, fc, f_fft))):
        raise ValueError("gauss_contract_cuda needs every input on one CUDA "
                         "device")
    if rhs.dtype != torch.bfloat16 or any(
            x.dtype != torch.float32 for x in (Q, fc, f_fft)):
        raise TypeError("fb_gauss takes bf16 rhs and float32 Q, fc, f_fft; "
                        f"got {rhs.dtype}, {Q.dtype}, {fc.dtype}, "
                        f"{f_fft.dtype}")
    if Q.stride(1) != 1:
        Q = Q.contiguous()
    if rhs.stride(2) != 1:
        rhs = rhs.contiguous()
    fc, f_fft = fc.contiguous(), f_fft.contiguous()
    R, N = Q.shape
    F = rhs.shape[2]
    if max(Q.stride(0), rhs.stride(0), rhs.stride(1)) >= 2 ** 31:
        raise ValueError("fb_gauss needs strides below 2**31 elements")
    Y, Zre, Zim, den, bw = (torch.empty((R, N), dtype=torch.float32,
                                        device=dev) for _ in range(5))
    finite = torch.empty((R, N), dtype=torch.bool, device=dev)
    T = (torch.empty((R, N, 4), dtype=torch.float32, device=dev) if with_t
         else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fb_gauss_lib().fb_gauss_launch(
            Q.data_ptr(), Q.stride(0), rhs.data_ptr(), rhs.stride(0),
            rhs.stride(1), fc.data_ptr(), f_fft.data_ptr(), Y.data_ptr(),
            Zre.data_ptr(), Zim.data_ptr(), den.data_ptr(), bw.data_ptr(),
            finite.data_ptr(), None if T is None else T.data_ptr(), R, N, F,
            stream)
    check_launch(err, "fb_gauss")
    count_launch("fb_gauss")
    LAUNCH_SHAPES[(R, N, F, bool(with_t))] += 1
    return Y, Zre, Zim, den, finite, bw, T


def gauss_contract(Q: torch.Tensor, rhs: torch.Tensor, fc: torch.Tensor,
                   f_fft: torch.Tensor, with_t: bool) -> tuple:
    """The bf16 forward of one frame, (Y, Zre, Zim, den, finite, bw, T):
    the kernel for a CUDA tensor (a build or launch failure raises), the
    plain ops for a CPU tensor. No autograd."""
    if Q.is_cuda:
        return gauss_contract_cuda(Q, rhs, fc, f_fft, with_t)
    return gauss_contract_plain(Q, rhs, fc, f_fft, with_t)


def fb_forward(Q: torch.Tensor, fc: torch.Tensor, f_fft: torch.Tensor,
               rhs: torch.Tensor, bf16: bool = False):
    """Divide-after filterbank for one frame: Q (B, N), rhs (B, 4, F) ->
    (Y, Zre, Zim), each (B, N). nan_to_num applies to Y only. Plain
    autograd differentiates it (the "autodiff" VJP); under bf16 with no
    gradient to take it is ``gauss_contract``."""
    if bf16 and not (torch.is_grad_enabled()
                     and (Q.requires_grad or rhs.requires_grad)):
        return gauss_contract(Q, rhs, fc, f_fft, False)[:3]
    G = (_gauss_fast if bf16 else _gauss)(Q, fc, f_fft)[2]
    return _normalise(_dot(G, rhs, bf16, "bnf,bcf->bnc"))[:3]


class FilterbankFn(torch.autograd.Function):
    """fb_forward with the JAX package's hand backward (custom VJP).

    apply(Q, rhs, fc, f_fft, mode) -> (Y, Zre, Zim); mode is "f32" or
    "bf16", with "|noxg" when no gradient is wanted for rhs (then rhs gets
    a zero gradient, or none if it does not require one)."""

    @staticmethod
    def forward(ctx, Q, rhs, fc, f_fft, mode: str):
        bf16 = mode.startswith("bf16")
        x_grad = not mode.endswith("|noxg")
        fwd_T = bf16 and not x_grad
        if bf16:
            Y, Zre, Zim, den, finite, bw, T = gauss_contract(Q, rhs, fc,
                                                             f_fft, fwd_T)
        else:
            G = _gauss(Q, fc, f_fft)[2]
            Y, Zre, Zim, den, finite = _normalise(
                _dot(G, rhs, False, "bnf,bcf->bnc"))
        if fwd_T:
            ctx.save_for_backward(Q, fc, bw, T, Y, Zre, Zim, den, finite)
            ctx.rhs_meta = (rhs.shape, rhs.dtype)
        else:
            ctx.save_for_backward(Q, fc, f_fft, rhs, Y, Zre, Zim, den, finite)
        ctx.mode = (bf16, x_grad, fwd_T)
        return Y, Zre, Zim

    @staticmethod
    def backward(ctx, gY, gZre, gZim):
        with precision_highest():
            return FilterbankFn._backward(ctx, gY, gZre, gZim)

    @staticmethod
    def _backward(ctx, gY, gZre, gZim):
        bf16, x_grad, fwd_T = ctx.mode
        if fwd_T:
            Q, fc, bw0, T, Y, Zre, Zim, den, finite = ctx.saved_tensors
        else:
            Q, fc, f_fft, rhs, Y, Zre, Zim, den, finite = ctx.saved_tensors
        # nan_to_num passes a zero cotangent where it zeroed
        gY = torch.where(finite, gY, 0.0)
        gden = -(gY * Y + gZre * Zre + gZim * Zim) / den
        g4 = torch.stack([gY / den, gZre / den, gZim / den, gden], dim=-1)

        gRhs = None
        if fwd_T:
            dQ = -fc / torch.square(Q + EPS_Q) / bw0 * torch.sum(g4 * T, -1)
            if ctx.needs_input_grad[1]:
                shape, dtype = ctx.rhs_meta
                gRhs = torch.zeros(shape, dtype=dtype, device=Q.device)
            return dQ, gRhs, None, None, None

        if bf16:
            bw, t, G = _gauss_fast(Q, fc, f_fft)
            Gz2 = G * (-2.0 * t)                       # z^2 = -2 log G
        else:
            bw, z, G = _gauss(Q, fc, f_fft)
            Gz2 = G * (z * z)
        T = _dot(Gz2, rhs, bf16, "bnf,bcf->bnc")
        dQ = (-fc / torch.square(Q + EPS_Q) / bw[..., 0]
              * torch.sum(g4 * T, dim=-1))
        if ctx.needs_input_grad[1]:
            gRhs = (_dot(G, g4, bf16, "bnf,bnc->bcf").to(rhs.dtype) if x_grad
                    else torch.zeros_like(rhs))
        return dQ, gRhs, None, None, None


def resolve_fb_vjp(vjp: str) -> str:
    """The filterbank VJP to run: "auto" is "custom" at every batch (the
    JAX package's batch crossover to "autodiff" was measured on a TPU; none
    has been measured on the card)."""
    if vjp == "auto":
        vjp = "custom"
    if vjp not in ("custom", "autodiff"):
        raise ValueError(f"fb_vjp must be 'auto', 'custom' or 'autodiff', "
                         f"got {vjp!r}")
    return vjp


def filterbank_apply_rhs(Q: torch.Tensor, fc: torch.Tensor,
                         f_fft: torch.Tensor, rhs: torch.Tensor,
                         bf16: bool, vjp: str = "custom",
                         x_grad: bool = True):
    """fb_forward on a pre-stacked rhs, differentiated by the resolved VJP:
    "custom" -> FilterbankFn, "autodiff" -> plain autograd. `vjp` must be
    resolved already (resolve_fb_vjp). Forward values are the same."""
    if vjp == "autodiff":
        return fb_forward(Q, fc, f_fft, rhs, bf16)
    mode = ("bf16" if bf16 else "f32") + ("" if x_grad else "|noxg")
    return FilterbankFn.apply(Q, rhs, fc, f_fft, mode)


def band_phase(Zre: torch.Tensor, Zim: torch.Tensor,
               eps_mag: float = 1e-3) -> torch.Tensor:
    """Per-band phase: |Z| floored at eps_mag, then atan2 of the
    normalised components."""
    mag = torch.clamp(torch.sqrt(Zre * Zre + Zim * Zim), min=eps_mag)
    return torch.atan2(Zim / mag, Zre / mag)
