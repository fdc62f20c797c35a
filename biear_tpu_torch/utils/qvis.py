"""Q-trajectory plots of the adaptive frontends.

Counterpart of ``biear_tpu/utils/qvis.py``: ``visualize_Q_LR`` runs the
active model's eval forward on a few batches and writes, per batch, the
per-ear Q(t, band) of the first samples beside Q0 and the band centres
as ``q_batchNNN.npz`` (QL, QR, fc, Q0), and where matplotlib imports one
PNG per sample (Q(t, band) of each ear, and the time-mean Q against Q0
over the ERB frequency axis).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.frontend import frontend_constants


@torch.inference_mode()
def visualize_Q_LR(model, batches, save_dir: str, max_batches: int = 5,
                   sample_per_batch: int = 1) -> None:
    """Dump Q plots of up to `max_batches` batches for an ``ActiveBiEAR``.

    batches: an iterable of (wavL, wavR, x3, ...) tuples (numpy or
    tensors); they go to the model's device unsanitised, as JAX's
    ``active_forward`` gets them."""
    os.makedirs(save_dir, exist_ok=True)
    c = frontend_constants(model.cfg)
    fc, Q0 = np.asarray(c["fc"]), np.asarray(c["Q0"])
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None

    device = next(model.parameters()).device
    model.eval()
    for bi, batch in enumerate(batches):
        if bi >= max_batches:
            break
        wavL, wavR, x3 = (torch.as_tensor(a, device=device)
                          for a in batch[:3])
        aux = model(wavL, wavR, x3)[3]
        QL = aux["QL"][:sample_per_batch].cpu().numpy()
        QR = aux["QR"][:sample_per_batch].cpu().numpy()
        np.savez(os.path.join(save_dir, f"q_batch{bi:03d}.npz"),
                 QL=QL, QR=QR, fc=fc, Q0=Q0)
        if plt is None:
            continue
        for si in range(QL.shape[0]):
            fig, axes = plt.subplots(1, 3, figsize=(15, 4))
            for ax, Q, name in ((axes[0], QL[si], "left"),
                                (axes[1], QR[si], "right")):
                im = ax.imshow(Q, aspect="auto", origin="lower",
                               extent=[0, len(fc) - 1, 0, Q.shape[0]])
                ax.set_title(f"Q(t, band) {name} ear")
                ax.set_xlabel("band")
                ax.set_ylabel("frame")
                fig.colorbar(im, ax=ax)
            axes[2].semilogx(fc, Q0, "k--", label="Q0")
            axes[2].semilogx(fc, QL[si].mean(0), label="mean QL")
            axes[2].semilogx(fc, QR[si].mean(0), label="mean QR")
            axes[2].set_xlabel("fc (Hz)")
            axes[2].set_ylabel("Q")
            axes[2].legend()
            axes[2].set_title("time-mean Q vs Q0")
            fig.tight_layout()
            fig.savefig(os.path.join(save_dir, f"q_batch{bi:03d}_s{si}.png"),
                        dpi=110)
            plt.close(fig)
