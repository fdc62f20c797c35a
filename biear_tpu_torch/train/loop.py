"""Train and eval steps with a masked nonfinite skip, and the fused
synthesize -> train chunk and the stacked eval chunk.

Counterpart of ``biear_tpu/train/loop.py`` for the active, AuralNet and
passive models (the step dispatches on the model's class, as JAX on
``model``; ``PassiveBiEAR`` batches are (x1, x2, x3, x4, x5, y[, w])). A train
step always runs the update; one device-side predicate ``ok`` (the loss
and every gradient finite) decides whether it lands, so a nonfinite batch
leaves the parameters and the whole Adam state untouched and counts as
``skipped``, with no host sync. Gradient telemetry (per-group global
norms, absolute maxima, finite flags, per-leaf magnitude histograms) is
computed in the same step: on a card in three launches of
``kernels/fused_update.cu`` (``fused_update.py``), on the CPU by the plain
version (``plain_update``), their contract.

The chunk runs ``chunk_steps`` iterations of synthesize -> step; each
step's generator draws the synthesis first and the dropout second. The
whole step, forward and backward, runs under the process-wide
MATMUL_PRECISION (``device.matmul_precision``). On a CUDA device without
a mesh or under a D x 1 one, ``make_train_step``, ``make_train_chunk``,
``make_eval_step`` and ``make_eval_chunk`` replay captured CUDA graphs of
these steps (``train/graph.py``, ``graph.py``), JAX's one-dispatch
programs; the CPU and a model axis run them eagerly, in a Python loop
(the model axis's collectives run inside autograd's forward and backward,
where a graph cannot leave them out).

Under a mesh (``parallel.mesh.Mesh``) each rank's loss and gradients are
means over its rows; one flat all-reduce over the data group turns them
into the global batch's weighted mean, and ``ok`` is taken on the reduced
values, so every rank skips a nonfinite step together. The step splits
at that all-reduce (``send_half``, ``receive_half``): a captured step is
two graphs with the eager all-reduce between them, over NCCL or gloo. With a model axis M > 1 the group norms (and so the clip), the
finite flags and the histograms are those of the whole tensors: a cut
tensor's squares and counts are summed over the model group, a
replicated one counted once.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..device import constant_cache, matmul_precision
from ..models.auralnet import AuralNet
from ..models.biear import ActiveBiEAR, PassiveBiEAR
from ..models.frontend import device_constants
from ..parallel.mesh import (Mesh, flat_numel, layout_of, pack_grads,
                             unpack_grads)
from .losses import q_regularizers, sanitize_wav, sanitize_x3, task_loss
from ..graph import CapturedEvalChunk, forward, use_capture
from .graph import (CapturedChunk, CapturedMeshChunk, CapturedMeshStep,
                    CapturedStep, train_state)
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


METRICS = ("loss", "sound_acc", "aoa_mae", "dist_acc")


def grad_hist_names(model, max_leaves: int) -> list:
    """Parameter names in the row order of the train step's grad_hist (the
    whole model's, when it is cut over a model axis)."""
    layout = layout_of(model)
    names = (list(layout.entries) if layout is not None
             else [n for n, _ in model.named_parameters()])
    return names[:max_leaves]


def _all_finite(tensors) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


def _counted(layout, name: str) -> bool:
    """Whether this rank counts `name` in the model group's sums: every
    leaf without a layout; with one, a cut tensor on every rank (its
    piece) and a replicated one on model rank 0."""
    return (layout is None or layout.entries[name][1] is not None
            or layout.mesh.model_rank == 0)


def group_norms(grads: dict, layout=None) -> dict:
    """Global gradient norms split frontend (bifb) / backend, their
    absolute maxima and finite flags (0-dim tensors on the device); with
    the `layout` of a model cut over M > 1 model ranks, those of the
    whole tensors (two all-reduces over the model group)."""
    zero = torch.zeros((), device=next(iter(grads.values())).device)
    sq, mx = [], []
    for front in (True, False):
        leaves = [(n, g) for n, g in grads.items() if is_frontend(n) == front]
        sq.append(sum((torch.sum(g.float() ** 2) for n, g in leaves
                       if _counted(layout, n)), zero))
        mx.append(torch.stack([g.abs().max() for _, g in leaves]).max()
                  if leaves else zero)
        mx.append(zero if not leaves else
                  1.0 - _all_finite([g for _, g in leaves]).float())
    sq, mx = torch.stack(sq), torch.stack(mx)
    if layout is not None:
        sq, mx = layout.mesh.model_sum_(sq), layout.mesh.model_max_(mx)
    out = {}
    for i, label in enumerate(("fb", "backend")):
        out[f"grad_{label}_norm"] = torch.sqrt(sq[i])
        out[f"grad_{label}_absmax"] = mx[2 * i]
        out[f"grad_{label}_finite"] = 1.0 - mx[2 * i + 1]
    return out


@constant_cache
def _device_edges(device: torch.device) -> torch.Tensor:
    """GRAD_HIST_EDGES on `device`, copied there once."""
    return torch.as_tensor(GRAD_HIST_EDGES, device=device)


def _hist_row(g: torch.Tensor) -> torch.Tensor:
    """(18,) counts of |g| per decade bucket: bucket k counts edges[k-1] <
    |g| <= edges[k], the underflow bucket first, the overflow bucket
    last."""
    a = g.abs().reshape(-1)
    edges = _device_edges(a.device)
    gt = (a[None, :] > edges[:, None]).sum(dim=1).float()
    n = torch.full((1,), float(a.numel()), device=a.device)
    return torch.cat([n - gt[:1], gt[:-1] - gt[1:], gt[-1:]])


def grad_histograms(grads: dict, max_leaves: int,
                    layout=None) -> torch.Tensor:
    """(n_leaves, 18) float32 counts of |g| per decade bucket
    (``_hist_row``) for the first `max_leaves` gradients (name ->
    gradient); with the `layout` of a model cut over the model axis, those
    of the whole tensors in ``grad_hist_names`` order: each rank's counts,
    summed over the model group."""
    names = list(grads if layout is None else layout.entries)[:max_leaves]
    device = next(iter(grads.values())).device
    if not names:
        return torch.zeros((0, len(GRAD_HIST_EDGES) + 1), device=device)
    zero = torch.zeros(len(GRAD_HIST_EDGES) + 1, device=device)
    rows = torch.stack([_hist_row(grads[n])
                        if n in grads and _counted(layout, n) else zero
                        for n in names])
    return rows if layout is None else layout.mesh.model_sum_(rows)


def batch_weight(batch) -> torch.Tensor:
    """W = the sum of a batch's row weights (its rows when it has none)."""
    if len(batch) in (5, 7):
        return batch[-1].float().sum()
    return batch[0].new_full((), float(batch[0].shape[0]),
                             dtype=torch.float32)


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


def sends(mesh: Mesh | None) -> bool:
    """Whether a train step under `mesh` sends its gradients: over D > 1
    data ranks (over one, the step is the step without a mesh)."""
    return mesh is not None and mesh.data > 1


def forward_backward(model: _Model, hp: TrainHyper, batch, gen):
    """(gradients in parameter order, zeros where unused; the metrics;
    the batch's weight W) of one training forward and backward."""
    model.train()
    params = list(model.parameters())
    with matmul_precision():
        loss, metrics = model_loss(model, hp, batch, gen)
        trace.mark("forward")
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        trace.mark("backward")
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return grads, metrics, batch_weight(batch)


def plain_update(model: _Model, optimizer: Adam, named: dict, loss,
                 lr_scale, max_param_log: int) -> tuple:
    """The plain version of the update and its telemetry, the contract of
    ``fused_update.cu``: the group norms, ``ok`` (the loss and every
    gradient finite), the optimizer step of `named` (name -> gradient)
    where ``ok`` holds, the histograms; returns (norms, skipped,
    grad_hist)."""
    layout = layout_of(model)
    norms = group_norms(named, layout)
    # the whole gradient's flags: the model ranks' differ where it is cut
    ok = (torch.isfinite(loss) & (norms["grad_fb_finite"] > 0)
          & (norms["grad_backend_finite"] > 0))
    # a cut model's clip norms are the whole gradient's; otherwise the
    # optimizer takes them from `named`
    optimizer.step(named, ok, lr_scale, norms=None if layout is None else {
        "frontend": norms["grad_fb_norm"],
        "backend": norms["grad_backend_norm"]})
    return (norms, 1.0 - ok.float(),
            grad_histograms(named, max_param_log, layout))


def apply_update(model: _Model, optimizer: Adam, grads: list, metrics: dict,
                 weight, lr_scale, max_param_log: int) -> dict:
    """The optimizer step of `grads` (parameter order) where ``ok`` (the
    loss and every gradient finite) holds, and the step's telemetry;
    returns `metrics` with the norms, "skipped", "weight" and
    "grad_hist". CUDA gradients take the three launches of
    ``fused_update.cu`` (``fused_update.fused_update``), CPU ones the
    plain version (``plain_update``)."""
    if grads[0].is_cuda:
        from .fused_update import fused_update
        norms, skipped, hist = fused_update(model, optimizer, grads,
                                            metrics["loss"], lr_scale,
                                            max_param_log)
    else:
        names = [n for n, _ in model.named_parameters()]
        norms, skipped, hist = plain_update(
            model, optimizer, dict(zip(names, grads)), metrics["loss"],
            lr_scale, max_param_log)
    metrics.update(norms)
    metrics["skipped"] = skipped
    metrics["weight"] = weight
    metrics["grad_hist"] = hist
    trace.mark("update")
    return metrics


def send_half(model: _Model, hp: TrainHyper, batch, gen,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """A data rank's train step up to the data group's all-reduce: the
    forward and backward, packed into the flat buffer it sends
    (``pack_grads``; into `out` when given)."""
    grads, metrics, weight = forward_backward(model, hp, batch, gen)
    return pack_grads(grads, weight, [metrics[k] for k in METRICS], out)


def receive_half(model: _Model, optimizer: Adam, flat: torch.Tensor,
                 lr_scale, max_param_log: int) -> dict:
    """A data rank's train step after the all-reduce: the global batch's
    gradients and metrics from the summed buffer `flat`
    (``unpack_grads``), then the update and telemetry (``apply_update``),
    so ``ok`` is taken on the reduced values and every rank skips a
    nonfinite step together."""
    grads, scalars, weight = unpack_grads(flat, list(model.parameters()),
                                          len(METRICS))
    return apply_update(model, optimizer, grads, dict(zip(METRICS, scalars)),
                        weight, lr_scale, max_param_log)


def train_step(model: _Model, hp: TrainHyper, optimizer: Adam, batch,
               gen, lr_scale=1.0, max_param_log: int = 200,
               mesh: Mesh | None = None) -> dict:
    """One training step on `batch`, in place on the model's parameters
    and the optimizer's state. Returns the metrics as device tensors,
    with "skipped" (1.0 when the update was masked out), "weight" (the
    batch's W, global under a mesh) and "grad_hist" (rows in
    ``grad_hist_names`` order). Under a mesh the metrics are the global
    batch's; `gen` is then the rank's generator or ``RankGenerators``.
    Over D > 1 data ranks the step is ``send_half``, the flat all-reduce,
    ``receive_half``."""
    if sends(mesh):
        flat = mesh.data_sum_(send_half(model, hp, batch, gen))
        return receive_half(model, optimizer, flat, lr_scale, max_param_log)
    grads, metrics, weight = forward_backward(model, hp, batch, gen)
    return apply_update(model, optimizer, grads, metrics, weight, lr_scale,
                        max_param_log)


def step_halves(model: _Model, hp: TrainHyper, optimizer: Adam,
                max_param_log: int):
    """(send, receive) of a data rank's captured step: send(batch, gen)
    packs into one flat buffer made here (the same tensor every call),
    receive(flat, lr_scale) -> metrics."""
    params = list(model.parameters())
    flat = torch.empty(flat_numel(params, len(METRICS)),
                       device=params[0].device)
    return (lambda batch, gen: send_half(model, hp, batch, gen, flat),
            lambda flat, lr: receive_half(model, optimizer, flat, lr,
                                          max_param_log))


def make_train_step(model: _Model, hp: TrainHyper, optimizer: Adam,
                    max_param_log: int = 200, mesh: Mesh | None = None, *,
                    capture: bool | None = None):
    """(batch, gen, lr_scale) -> metrics, training `model` in place.

    On a CUDA device without a mesh or under one without a model axis the
    step is captured CUDA graphs per batch signature (JAX's jitted step),
    drawing from the generator of its first call: one graph
    (``graph.CapturedStep``), or over D > 1 data ranks two around the
    eager flat all-reduce (``graph.CapturedMeshStep``). The CPU, a model
    axis and ``capture=False`` run the eager step (``use_capture``)."""
    if use_capture(model, mesh, capture):
        state = train_state(model, optimizer)
        if sends(mesh):
            return CapturedMeshStep(
                *step_halves(model, hp, optimizer, max_param_log), mesh,
                state)
        return CapturedStep(
            lambda batch, gen, lr: train_step(model, hp, optimizer, batch,
                                              gen, lr, max_param_log, mesh),
            state)

    def step(batch, gen, lr_scale=1.0) -> dict:
        return train_step(model, hp, optimizer, batch, gen, lr_scale,
                          max_param_log, mesh)
    return step


def make_eval_step(model: _Model, hp: TrainHyper, *,
                   mesh: Mesh | None = None, capture: bool | None = None):
    """batch -> metrics, in eval mode without gradients (JAX's jitted
    ``make_eval_step``).

    On a CUDA device without a model axis (a D x 1 mesh has no
    collective in the eval forward) the forward replays a captured CUDA
    graph per batch signature and precision (``graph.forward``); the
    CPU, a model axis and ``capture=False`` run it eagerly
    (``use_capture``)."""
    if use_capture(model, mesh, capture):
        fwd = forward(model, "eval_step",
                      lambda *batch: model_loss(model, hp, batch, None)[1])

        def captured(batch) -> dict:
            model.eval()
            return fwd(batch)
        return captured

    @torch.no_grad()
    def step(batch) -> dict:
        model.eval()
        return model_loss(model, hp, batch, None)[1]
    return step


def make_eval_chunk(model: _Model, hp: TrainHyper, *,
                    mesh: Mesh | None = None, capture: bool | None = None):
    """Evaluate a whole stack of same-shape batches in one dispatch (JAX's
    ``make_eval_chunk``): stacks, a tuple of tensors with a leading
    (n_batches,) axis (a ``SynthEvalDataset`` stacked group) -> the eval
    metrics stacked on that axis.

    On a CUDA device without a model axis the eval of one stack row is a
    captured CUDA graph replayed once per row, reading the stacks in place
    (``graph.CapturedEvalChunk``); the CPU, a model axis and
    ``capture=False`` loop over the rows eagerly (``use_capture``). Under
    a mesh the caller adds the data ranks' sums (the runner's
    ``_finalize``, once per split)."""
    if use_capture(model, mesh, capture):
        chunk = CapturedEvalChunk(
            lambda batch: model_loss(model, hp, batch, None)[1], model)

        def captured(stacks) -> dict:
            model.eval()
            return chunk(stacks)
        return captured

    @torch.no_grad()
    def eval_chunk(stacks) -> dict:
        model.eval()
        ms = [model_loss(model, hp, tuple(s[r] for s in stacks), None)[1]
              for r in range(stacks[0].shape[0])]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
    return eval_chunk


def make_train_chunk(model: _Model, hp: TrainHyper, optimizer: Adam,
                     synth_batch_fn, chunk_steps: int,
                     max_param_log: int = 200, mesh: Mesh | None = None, *,
                     capture: bool | None = None):
    """Fused dispatch: (gen, lr_scale, dropout_gen) -> metrics stacked
    over `chunk_steps` (synthesize -> train step) iterations.
    synth_batch_fn is gen -> batch (``AnechoicSynthesizer.batch_fn``,
    ``ReverbSynthesizer``'s or ``PassiveFeatureSynth``'s for the passive
    model; under a mesh, of this rank's rows); per step the generator
    draws the synthesis first, then the dropout, from `dropout_gen` when
    given (a rank's ``RankGenerators`` over `gen`). (fb_vjp "auto" is
    "custom" at every batch, which the JAX chunk forces.)

    On a CUDA device without a model axis one synthesize -> step
    iteration is captured and replayed `chunk_steps` times per call (JAX's
    scan is one program): one graph (``graph.CapturedChunk``), or over D >
    1 data ranks two around the eager flat all-reduce
    (``graph.CapturedMeshChunk``). It draws from the generators of its
    first call (`gen` and `dropout_gen`), which the caller re-seeds in
    place between chunks; the CPU, a model axis and ``capture=False`` run
    the eager loop (``use_capture``), a ``chunk.call`` span that stamps
    each step's stage marks (``trace.SLOTS``) into a (chunk_steps,
    len(trace.SLOTS)) stack of its own and hands it to the recorder, as
    the captured chunk does."""
    if use_capture(model, mesh, capture):
        state = train_state(model, optimizer)
        if sends(mesh):
            return CapturedMeshChunk(
                *step_halves(model, hp, optimizer, max_param_log), mesh,
                synth_batch_fn, chunk_steps, state)
        return CapturedChunk(
            lambda batch, gen, lr: train_step(model, hp, optimizer, batch,
                                              gen, lr, max_param_log, mesh),
            synth_batch_fn, chunk_steps, state)

    device = next(model.parameters()).device

    def run_chunk(gen: torch.Generator, lr_scale=1.0,
                  dropout_gen=None) -> dict:
        with trace.span("chunk.call") as call:
            marks = torch.full((chunk_steps, len(trace.SLOTS)), -1,
                               dtype=torch.long, device=device)
            row = torch.zeros(1, dtype=torch.long, device=device)
            ms = []
            for _ in range(chunk_steps):
                with trace.step_sink(marks, row):
                    trace.mark("start")
                    batch = synth_batch_fn(gen)
                    trace.mark("synthesis")
                    ms.append(train_step(
                        model, hp, optimizer, batch,
                        gen if dropout_gen is None else dropout_gen,
                        lr_scale, max_param_log, mesh))
                    trace.mark("recorded")
                row.add_(1)
            trace.record_chunk(marks, call, chunk_steps)
            return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return run_chunk
