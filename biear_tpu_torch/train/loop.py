"""Train and eval steps with a masked nonfinite skip, and the fused
synthesize -> train chunk.

Counterpart of ``biear_tpu/train/loop.py`` for the active, AuralNet and
passive models (the step dispatches on the model's class, as JAX on
``model``; ``PassiveBiEAR`` batches are (x1, x2, x3, x4, x5, y[, w])). A train
step always runs the update; one device-side predicate ``ok`` (the loss
and every gradient finite) decides whether it lands, so a nonfinite batch
leaves the parameters and the whole Adam state untouched and counts as
``skipped``, with no host sync. Gradient telemetry (per-group global
norms, absolute maxima, finite flags, per-leaf magnitude histograms) is
computed in the same step.

The chunk runs ``chunk_steps`` iterations of synthesize -> step in a
Python loop; each step's generator draws the synthesis first and the
dropout second. TF32 is off for the whole step, forward and backward.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import no_tf32
from ..models.auralnet import AuralNet
from ..models.biear import ActiveBiEAR, PassiveBiEAR
from ..models.frontend import device_constants
from .losses import q_regularizers, sanitize_wav, sanitize_x3, task_loss
from .optim import Adam, TrainHyper, is_frontend

_Model = ActiveBiEAR | AuralNet | PassiveBiEAR

# Magnitude-decade histogram edges shared by every gradient leaf: 16 bins
# over |g| in [1e-12, 1e4), plus underflow (zeros) and overflow buckets.
GRAD_HIST_EDGES = np.logspace(-12.0, 4.0, 17).astype(np.float32)


def is_better_tuple(curr, best, eps: float = 1e-12) -> bool:
    """Lexicographic checkpoint selection: sound_acc up, then aoa_mae
    down, then dist_acc up; ties within eps go to the next key."""
    if best is None:
        return True
    cs, ca, cd = curr
    bs, ba, bd = best
    if cs > bs + eps:
        return True
    if abs(cs - bs) <= eps:
        if ca < ba - eps:
            return True
        if abs(ca - ba) <= eps and cd > bd + eps:
            return True
    return False


def grad_hist_names(model, max_leaves: int) -> list:
    """Parameter names in the row order of the train step's grad_hist."""
    return [n for n, _ in model.named_parameters()][:max_leaves]


def _all_finite(tensors) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def group_norms(grads: dict) -> dict:
    """Global gradient norms split frontend (bifb) / backend, their
    absolute maxima and finite flags (0-dim tensors on the device)."""
    dev = next(iter(grads.values())).device
    zero = torch.zeros((), device=dev)
    out = {}
    for label, leaves in (
            ("fb", [g for n, g in grads.items() if is_frontend(n)]),
            ("backend", [g for n, g in grads.items() if not is_frontend(n)])):
        if leaves:
            norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
            absmax = torch.stack([g.abs().max() for g in leaves]).max()
            finite = _all_finite(leaves).float()
        else:
            norm, absmax, finite = zero, zero, torch.ones((), device=dev)
        out[f"grad_{label}_norm"] = norm
        out[f"grad_{label}_absmax"] = absmax
        out[f"grad_{label}_finite"] = finite
    return out


def grad_histograms(grads: list, max_leaves: int) -> torch.Tensor:
    """(n_leaves, 18) float32 counts of |g| per decade bucket for the first
    `max_leaves` gradients: bucket k counts edges[k-1] < |g| <= edges[k],
    with the underflow bucket first and the overflow bucket last."""
    rows = []
    for g in grads[:max_leaves]:
        a = g.abs().reshape(-1)
        edges = torch.as_tensor(GRAD_HIST_EDGES, device=a.device)
        gt = (a[None, :] > edges[:, None]).sum(dim=1).float()
        n = torch.full((1,), float(a.numel()), device=a.device)
        rows.append(torch.cat([n - gt[:1], gt[:-1] - gt[1:], gt[-1:]]))
    if not rows:
        return torch.zeros((0, len(GRAD_HIST_EDGES) + 1))
    return torch.stack(rows)


def active_loss(model: ActiveBiEAR | AuralNet, hp: TrainHyper, batch,
                gen: torch.Generator | None):
    """(loss, metrics) of a waveform model on (wavL, wavR, x3, y[, w]),
    in whichever mode the model is in (training needs `gen`); the Q
    regularisers where the model reports a Q (AuralNet has none)."""
    w = batch[4] if len(batch) == 5 else None
    wavL, wavR, x3, y = batch[:4]
    wavL, wavR = sanitize_wav(wavL, wavR)
    x3 = sanitize_x3(x3)
    s, a, d, aux = model(wavL, wavR, x3, gen=gen)
    cfg = model.cfg
    loss, metrics = task_loss(s, a, d, y.float(), hp.loss_w_sound,
                              hp.loss_w_aoa, hp.loss_w_dist,
                              cfg.n_dist_class, w=w)
    if aux["Q"] is not None:
        Q0 = device_constants(cfg, wavL.device)["Q0"]
        loss = loss + q_regularizers(aux["Q"], Q0, hp.reg_q_w,
                                     hp.reg_smooth_w, w=w)
        metrics["loss"] = loss.detach()
    return loss, metrics


def passive_loss(model: PassiveBiEAR, hp: TrainHyper, batch,
                 gen: torch.Generator | None):
    """(loss, metrics) of the passive model on (x1, x2, x3, x4, x5, y[,
    w]): the features cast to f32, no sanitising, no Q regulariser."""
    w = batch[6].float() if len(batch) == 7 else None
    x1, x2, x3, x4, x5, y = (b.float() for b in batch[:6])
    s, a, d, _ = model(x1, x2, x3, x4, x5, gen=gen)
    return task_loss(s, a, d, y, hp.loss_w_sound, hp.loss_w_aoa,
                     hp.loss_w_dist, model.cfg.n_dist_class, w=w)


def model_loss(model, hp: TrainHyper, batch, gen: torch.Generator | None):
    """The loss of the model's family (JAX ``_loss_fn``)."""
    fn = passive_loss if isinstance(model, PassiveBiEAR) else active_loss
    return fn(model, hp, batch, gen)


def train_step(model: _Model, hp: TrainHyper, optimizer: Adam, batch,
               gen: torch.Generator, lr_scale=1.0,
               max_param_log: int = 200) -> dict:
    """One training step on `batch`, in place on the model's parameters
    and the optimizer's state. Returns the metrics as device tensors,
    with "skipped" (1.0 when the update was masked out) and "grad_hist"
    (rows in ``model.named_parameters()`` order)."""
    model.train()
    names, params = zip(*model.named_parameters())
    with no_tf32():
        loss, metrics = model_loss(model, hp, batch, gen)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    ok = torch.isfinite(loss) & _all_finite(grads)
    named = dict(zip(names, grads))
    optimizer.step(named, ok, lr_scale)
    metrics.update(group_norms(named))
    metrics["skipped"] = 1.0 - ok.float()
    metrics["grad_hist"] = grad_histograms(grads, max_param_log)
    return metrics


def make_train_step(model: _Model, hp: TrainHyper, optimizer: Adam,
                    max_param_log: int = 200):
    """(batch, gen, lr_scale) -> metrics, training `model` in place."""
    def step(batch, gen: torch.Generator, lr_scale=1.0) -> dict:
        return train_step(model, hp, optimizer, batch, gen, lr_scale,
                          max_param_log)
    return step


def make_eval_step(model: _Model, hp: TrainHyper):
    """batch -> metrics, in eval mode without gradients."""
    @torch.no_grad()
    def step(batch) -> dict:
        model.eval()
        with no_tf32():
            return model_loss(model, hp, batch, None)[1]
    return step


def make_train_chunk(model: _Model, hp: TrainHyper, optimizer: Adam,
                     synth_batch_fn, chunk_steps: int,
                     max_param_log: int = 200):
    """Fused dispatch: (gen, lr_scale) -> metrics stacked over
    `chunk_steps` (synthesize -> train step) iterations. synth_batch_fn is
    gen -> batch (``AnechoicSynthesizer.batch_fn``, ``ReverbSynthesizer``'s
    or ``PassiveFeatureSynth``'s for the passive model); per step the
    generator draws the synthesis first, then the dropout. (fb_vjp "auto"
    is "custom" at every batch, which the JAX chunk forces.)"""
    def run_chunk(gen: torch.Generator, lr_scale=1.0) -> dict:
        ms = []
        for _ in range(chunk_steps):
            batch = synth_batch_fn(gen)
            ms.append(train_step(model, hp, optimizer, batch, gen, lr_scale,
                                 max_param_log))
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return run_chunk
