"""Weights across the two packages.

``state_dict_from_jax`` turns the JAX package's parameter pytree, given as
numpy arrays (``jax.tree.map(np.asarray, params)``), into this package's
state dict. The names are those of the reference checkpoints, the same
that ``biear_tpu/train/state.py::to_torch_state_dict`` writes; the
ear-stacked ``bifb.fb`` leaves (axis 0: fb_L, fb_R) and the head-stacked
``subheads`` leaves (axis 0: sector) are split here; the single
controller's ``bifb.ctrl`` leaves sit directly under ``bifb.``. A passive
tree (and a fixed-Q one) has no ``bifb`` and gives the backend's names
only, as ``utils/torch_import.py::import_passive`` reads them. An AuralNet
tree (``attn_L``, ``attn_R``, ``attn_diff`` in place of the encoders)
gives the names that ``import_auralnet`` reads: its encoder layers'
``in_proj_w`` / ``in_proj_b`` become ``self_attn.in_proj_weight`` /
``in_proj_bias``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import BiEARConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lin(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["w"])
    sd[f"{prefix}.bias"] = _t(p["b"])


def _ln(sd: dict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(p["g"])
    sd[f"{prefix}.bias"] = _t(p["b"])


def _gru(sd: dict, prefix: str, p: dict) -> None:
    for ours, theirs in (("w_ih", "weight_ih_l0"), ("w_hh", "weight_hh_l0"),
                         ("b_ih", "bias_ih_l0"), ("b_hh", "bias_hh_l0")):
        sd[f"{prefix}.{theirs}"] = _t(p[ours])


def _take(tree, i: int):
    """Index `i` of the leading axis of every leaf of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_take(v, i) for v in tree]
    return np.asarray(tree)[i]


def _controller(sd: dict, prefix: str, p: dict) -> None:
    _gru(sd, f"{prefix}.q_rnn", p["q_rnn"])
    q = p["q_out"]
    _lin(sd, f"{prefix}.q_out.0", q["l1"])
    _ln(sd, f"{prefix}.q_out.1", q["ln1"])
    _lin(sd, f"{prefix}.q_out.4", q["l2"])
    _ln(sd, f"{prefix}.q_out.5", q["ln2"])
    _lin(sd, f"{prefix}.q_out.8", q["l3"])


def _attn_block(sd: dict, prefix: str, p: dict) -> None:
    _lin(sd, f"{prefix}.proj", p["proj"])
    for i, lp in enumerate(p["layers"]):
        pre = f"{prefix}.encoder.layers.{i}"
        sa = lp["self_attn"]
        sd[f"{pre}.self_attn.in_proj_weight"] = _t(sa["in_proj_w"])
        sd[f"{pre}.self_attn.in_proj_bias"] = _t(sa["in_proj_b"])
        _lin(sd, f"{pre}.self_attn.out_proj", sa["out_proj"])
        _ln(sd, f"{pre}.norm1", lp["norm1"])
        _ln(sd, f"{pre}.norm2", lp["norm2"])
        _lin(sd, f"{pre}.linear1", lp["linear1"])
        _lin(sd, f"{pre}.linear2", lp["linear2"])


def state_dict_from_jax(params_np: dict, cfg: BiEARConfig) -> dict:
    """JAX active-, passive- or AuralNet-model params (numpy leaves) ->
    this package's state dict."""
    sd: dict = {}
    if "attn_L" in params_np:
        for block in ("attn_L", "attn_R", "attn_diff"):
            _attn_block(sd, block, params_np[block])
    else:
        for enc in ("encoder_ild", "encoder_ipd"):
            _ln(sd, f"{enc}.in_norm", params_np[enc]["in_norm"])
            _gru(sd, f"{enc}.gru1", params_np[enc]["gru1"])
            _gru(sd, f"{enc}.gru2", params_np[enc]["gru2"])
    if cfg.use_cc:
        _lin(sd, "cc_proj", params_np["cc_proj"])
    for i, k in zip((0, 3, 6), ("l1", "l2", "l3")):
        _lin(sd, f"body.{i}", params_np["body"][k])
    sh = params_np["subheads"]
    for k in range(np.asarray(sh["shared"]["w"]).shape[0]):
        head = _take(sh, k)
        _lin(sd, f"subheads.{k}.shared.0", head["shared"])
        for branch in ("sound", "aoa", "dist"):
            for j, i in enumerate((0, 2, 4)):
                _lin(sd, f"subheads.{k}.{branch}.{i}", head[branch][j])
    bifb = params_np.get("bifb") or {}
    if "fb" in bifb:
        for e, ear in enumerate(("fb_L", "fb_R")):
            _controller(sd, f"bifb.{ear}", _take(bifb["fb"], e))
    elif "ctrl" in bifb:
        _controller(sd, "bifb", bifb["ctrl"])
    return sd
