"""Checkpoints of the port: the model, the Adam state and the run's meta.

A checkpoint is a directory {params.pth, opt_state.pt, meta.json}:

  * ``params.pth``: the model's state dict in the reference checkpoints'
    format (names of ``biear_tpu/train/state.py::to_torch_state_dict``,
    float32 CPU tensors), which ``serve.infer.load_model``, the port's
    evaluator and the JAX package's evaluator all read;
  * ``opt_state.pt``: ``Adam.state_dict()``, each group's first and
    second moments by parameter name and its int32 step count;
  * ``meta.json``: the runner's epoch, LR scale, step count, best tuple
    and plateau state.

Under a process group every rank calls ``save_checkpoint`` (a model cut
over a model axis gathers its pieces, a collective of its model group)
and rank 0 alone writes; ``load_checkpoint`` reads the whole tensors and
gives each rank its pieces, so a checkpoint of one mesh restores on any
other, or on one device.

``adam_state_from_optax`` turns the JAX runner's optax state (restored
from its orbax checkpoint, leaves already numpy) into ``opt_state.pt``'s
layout, so that a JAX run resumes in the port; the conversion of the
orbax directory to numpy runs where JAX is installed (README.md).
"""

from __future__ import annotations

import json
import os

import torch

from ..models.config import BiEARConfig
from ..models.weights import state_dict_from_jax
from ..parallel.mesh import (full_optimizer_state, full_state_dict, is_main,
                             layout_of, load_full_optimizer_state,
                             load_full_state_dict)


def save_checkpoint(path: str, model, optimizer=None,
                    meta: dict | None = None) -> None:
    """Write the checkpoint directory `path` (created; files replaced)
    with the whole tensors; under a process group every rank calls it and
    rank 0 writes."""
    if layout_of(model) is None and not is_main():
        return
    params = full_state_dict(model)
    opt = None if optimizer is None else full_optimizer_state(optimizer,
                                                              model)
    if not is_main():
        return
    os.makedirs(path, exist_ok=True)
    torch.save(params, os.path.join(path, "params.pth"))
    if opt is not None:
        torch.save(opt, os.path.join(path, "opt_state.pt"))
    if meta is not None:
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)


def load_checkpoint(path: str, model, optimizer=None) -> dict | None:
    """Restore the model (strict) and, when given and saved, the optimizer
    in place on the model's device, each rank taking its pieces; returns
    meta.json's dict or None."""
    sd = torch.load(os.path.join(path, "params.pth"), map_location="cpu",
                    weights_only=True)
    load_full_state_dict(model, sd)
    opt_path = os.path.join(path, "opt_state.pt")
    if optimizer is not None and os.path.exists(opt_path):
        load_full_optimizer_state(optimizer, model, torch.load(
            opt_path, map_location="cpu", weights_only=True))
    mp = os.path.join(path, "meta.json")
    if not os.path.exists(mp):
        return None
    with open(mp) as f:
        return json.load(f)


def _adam_leaves(chain):
    """The scale_by_adam state (count, mu, nu) inside one optax chain
    state, or None for a chain without one (set_to_zero)."""
    for s in chain:
        if all(hasattr(s, a) for a in ("count", "mu", "nu")):
            return s
    return None


def _is_masked(x) -> bool:
    """optax's MaskedNode: an empty tuple standing for a leaf of another
    group."""
    return isinstance(x, tuple) and len(x) == 0


def _merge(trees):
    """One pytree (dicts, lists) from per-group trees whose leaves are
    real in one group and MaskedNode in the others; subtrees with no real
    leaf (masked in every group, or empty) are dropped (None)."""
    real = [t for t in trees if not _is_masked(t)]
    if not real:
        return None
    first = real[0]
    if isinstance(first, dict):
        out = {}
        for k in first:
            v = _merge([t[k] for t in real])
            if v is not None:
                out[k] = v
        return out or None
    if isinstance(first, (list, tuple)):
        out = [_merge([t[i] for t in real]) for i in range(len(first))]
        return None if all(v is None for v in out) else out
    return first


def adam_state_from_optax(opt_state_np, cfg: BiEARConfig) -> dict:
    """The JAX optimizer's state -> ``Adam.state_dict()``'s layout.

    Reads the three shapes of ``biear_tpu/train/optim.py::make_optimizer``
    by their attributes, without optax: the two-group ``multi_transform``
    (labels "frontend" and "backend"), the frozen controller (a
    "frozen" group with no Adam state) and the fixed-Q bare chain (one
    "backend" group). Each group's moments keep that group's parameters
    (named as in ``state_dict_from_jax``); its step count is int32."""
    if hasattr(opt_state_np, "inner_states"):
        groups = {label: _adam_leaves(s.inner_state)
                  for label, s in opt_state_np.inner_states.items()}
    else:
        groups = {"backend": _adam_leaves(opt_state_np)}
    groups = {k: v for k, v in groups.items() if v is not None}
    if not groups:
        raise ValueError("no Adam state (count, mu, nu) in the optax state")
    moments = {}
    for key in ("mu", "nu"):
        full = _merge([getattr(a, key) for a in groups.values()])
        moments[key] = state_dict_from_jax(full, cfg)
    out = {}
    for label, adam in groups.items():
        # the frontend group holds the 'bifb' subtree, the other group the
        # rest of the model (all of it under fixed Q, which has no bifb)
        own = [n for n in moments["mu"]
               if n.startswith("bifb.") == (label == "frontend")]
        out[label] = {
            "count": torch.tensor(int(adam.count), dtype=torch.int32),
            "m": {n: moments["mu"][n] for n in own},
            "v": {n: moments["nu"][n] for n in own}}
    return out
