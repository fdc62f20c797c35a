"""Run configuration: the reference YAML contract and the run folders.

A copy of ``biear_tpu/config.py`` for the port: the same ``conf/*.yaml``
key set (mandatory keys raise KeyError, optional ones keep their
defaults), the same eager validators, the slugged experiment name, the
run tree {tb, checkpoints, logs_json, q_vis, meta} and the field set of
``meta/settings.json``, so runs of either package read the same way.

The YAML is read with PyYAML's ``safe_load``, as the JAX package reads it
(the card's machine has PyYAML).

Differences from the JAX package:
  * MATMUL_PRECISION is applied by ``device.matmul_precision`` (the
    JAX ``apply_matmul_precision``; names and their meaning on the card
    in ``device.py``); "default" is full f32 there, one-pass bf16 on a
    TPU.
  * ``config_from_settings`` returns the model config alone, which is all
    the serving CLI and the evaluator need.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from datetime import datetime

import yaml

from .models.config import BiEARConfig
from .train.optim import TrainHyper


@dataclasses.dataclass
class RunConfig:
    """Everything train and evaluate need, parsed from one YAML."""
    root: str
    runs_root: str
    batch_size: int
    epochs: int
    active: bool
    use_cc: bool
    fixed_frontend_q: bool
    controller_mode: str
    freeze_q_controller_only: bool
    alpha: float
    comments: str
    print_every: int
    hist_every: int
    max_param_log: int
    save_every_epoch: bool
    model_cfg: BiEARConfig
    hyper: TrainHyper
    mesh_data: int = -1
    mesh_model: int = 1
    synth_on_device: bool = False
    preload_h5: bool = True
    model_kind: str = "active"      # active | passive | auralnet
    matmul_precision: str = "default"
    data_format: str = "h5"         # h5 | shard
    shard_root: str = ""            # shard dir; defaults to ROOT
    raw: dict = dataclasses.field(default_factory=dict)


def _choice(v, key: str, allowed) -> str:
    """Validate a string option eagerly (a typo must not silently select
    another code path)."""
    s = str(v).lower()
    if s not in allowed:
        raise ValueError(f"{key} must be one of {allowed}, got {v!r}")
    return s


def load_run_config(path: str) -> RunConfig:
    with open(path, "r") as f:
        cfg = yaml.safe_load(f)

    model_cfg = BiEARConfig(
        use_cc=bool(cfg["USE_CC"]),
        fixed_frontend_q=bool(cfg["FIXED_FRONTEND_Q"]),
        controller_mode=str(cfg["Controller_Mode"]).lower(),
        alpha=float(cfg["ALPHA"]),
        deltaQ_base=float(cfg["DELTAQ_BASE"]),
        deltaQ_low_factor=float(cfg["DELTAQ_LOW_FACTOR"]),
        deltaQ_high_factor=float(cfg["DELTAQ_HIGH_FACTOR"]),
        deltaQ_mode=cfg.get("DELTAQ_MODE", "absolute"),
        timesteps=int(cfg.get("TIMESTEPS", 19)),
        n_fft=int(cfg.get("N_FFT", 1024)),
        n_bands=int(cfg.get("N_BANDS", 100)),
        d_model=int(cfg.get("D_MODEL", 128)),
        hop_ratio=float(cfg.get("HOP_RATIO", 1.0)),
        fs=int(cfg.get("FS", 16000)),
        fmin=float(cfg.get("FMIN", 50.0)),
        fmax=cfg.get("FMAX", None),
        latent_dim=int(cfg.get("LATENT_DIM", 100)),
        fb_w_dtype=_choice(cfg.get("FB_W_DTYPE", "float32"), "FB_W_DTYPE",
                           ("float32", "bfloat16")),
        fb_vjp=_choice(cfg.get("FB_VJP", "auto"), "FB_VJP",
                       ("auto", "custom", "autodiff")),
        fb_x_grad=bool(cfg.get("FB_X_GRAD", False)),
        dft_mode=_choice(cfg.get("DFT_MODE", "auto"), "DFT_MODE",
                         ("auto", "fft", "matmul")),
    )
    hyper = TrainHyper(
        lr_fb=float(cfg["LR_FB"]),
        lr_backend=float(cfg["LR_BACKEND"]),
        weight_decay=float(cfg["WEIGHT_DECAY"]),
        grad_clip_norm=float(cfg["GRAD_CLIP_NORM"]),
        reg_q_w=float(cfg["REG_Q_W"]),
        reg_smooth_w=float(cfg["REG_SMOOTH_W"]),
        loss_w_sound=float(cfg["LOSS_WEIGHT_SOUND"]),
        loss_w_aoa=float(cfg["LOSS_WEIGHT_AOA"]),
        loss_w_dist=float(cfg["LOSS_WEIGHT_DIST"]),
    )
    active = bool(cfg["Active"])
    kind = model_kind(cfg)
    return RunConfig(
        root=str(cfg["ROOT"]),
        runs_root=str(cfg["RUNS_ROOT"]),
        batch_size=int(cfg["BATCH_SIZE"]),
        epochs=int(cfg["EPOCHS"]),
        active=active,
        use_cc=bool(cfg["USE_CC"]),
        fixed_frontend_q=bool(cfg["FIXED_FRONTEND_Q"]),
        controller_mode=str(cfg["Controller_Mode"]).lower(),
        freeze_q_controller_only=bool(cfg["FREEZE_Q_CONTROLLER_ONLY"]),
        alpha=float(cfg["ALPHA"]),
        comments=str(cfg.get("COMMENTS", "") or ""),
        print_every=int(cfg["PRINT_EVERY"]),
        hist_every=int(cfg["HIST_EVERY"]),
        max_param_log=int(cfg["MAX_PARAM_LOG"]),
        save_every_epoch=bool(cfg["SAVE_EVERY_EPOCH"]),
        model_cfg=model_cfg,
        hyper=hyper,
        mesh_data=int(cfg.get("MESH_DATA", -1)),
        mesh_model=int(cfg.get("MESH_MODEL", 1)),
        synth_on_device=bool(cfg.get("SYNTH_ON_DEVICE", False)),
        preload_h5=bool(cfg.get("PRELOAD_H5", True)),
        model_kind=kind,
        matmul_precision=str(cfg.get("MATMUL_PRECISION", "default")).lower(),
        data_format=_choice(cfg.get("DATA_FORMAT", "h5"), "DATA_FORMAT",
                            ("h5", "shard")),
        shard_root=str(cfg.get("SHARD_ROOT", "") or ""),
        raw=cfg,
    )


def model_kind(settings: dict) -> str:
    """MODEL_KIND of a YAML config or a settings.json (active, passive or
    auralnet); without the key, passive when Active is false."""
    active = bool(settings.get("Active", True))
    return str(settings.get("MODEL_KIND",
                            "active" if active else "passive")).lower()


def family(settings: dict) -> str:
    """The model a YAML config or settings.json trains or serves:
    "passive" for the passive family (``is_passive``), else MODEL_KIND
    ("active" or "auralnet")."""
    return "passive" if is_passive(settings) else model_kind(settings)


def is_passive(src) -> bool:
    """The passive family, for a RunConfig or a settings / YAML dict:
    Active false or MODEL_KIND passive (the JAX runner's ``model_kind``)."""
    if isinstance(src, RunConfig):
        return not src.active or src.model_kind == "passive"
    return not bool(src.get("Active", True)) or model_kind(src) == "passive"


def _slug(x: str) -> str:
    x = str(x).strip().lower()
    x = re.sub(r"\s+", "-", x)
    x = re.sub(r"[^a-z0-9_\-\.]+", "", x)
    return x[:120]


def make_exp_name(rc: RunConfig, run_id: str | None = None) -> tuple[str, str]:
    """The slugged experiment name of the reference."""
    if run_id is None:
        run_id = datetime.now().strftime("%Y%m%d-%H%M%S")
    hp = rc.hyper
    qtype = "fixedQ" if rc.fixed_frontend_q else "adaptiveQ"
    m = rc.model_cfg
    parts = [
        "active" if rc.active else "passive",
        f"ctrl-{rc.controller_mode}",
        f"fixedq-{int(rc.fixed_frontend_q and rc.active)}",
        f"type-{qtype.lower()}",
        f"alpha{rc.alpha:g}",
        f"cc-{int(rc.use_cc)}",
        f"qctrlfrozen-{int(rc.freeze_q_controller_only and rc.active)}",
        f"bs{rc.batch_size}",
        f"lrfb{hp.lr_fb:g}",
        f"lrbe{hp.lr_backend:g}",
        f"wd{hp.weight_decay:g}",
        f"lossw{hp.loss_w_sound:.2f}_{hp.loss_w_aoa:.2f}_{hp.loss_w_dist:.2f}",
        f"run{run_id}",
        f"dq{m.deltaQ_base:g}_lo{m.deltaQ_low_factor:g}"
        f"_hi{m.deltaQ_high_factor:g}_{m.deltaQ_mode[:3]}",
    ]
    if rc.comments:
        parts.append(_slug(rc.comments))
    return "_".join(parts), run_id


def make_run_dirs(rc: RunConfig, exp_name: str, create: bool = True) -> dict:
    """The run tree under RUNS_ROOT, created unless `create` is false."""
    run_dir = os.path.join(rc.runs_root, exp_name)
    dirs = {"run": run_dir}
    for sub in ("tb", "checkpoints", "logs_json", "q_vis", "meta"):
        dirs[sub] = os.path.join(run_dir, sub)
    if create:
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
    return dirs


def mesh_shape(rc: RunConfig, world_size: int) -> tuple[int, int]:
    """(data, model) of MESH_DATA x MESH_MODEL over WORLD_SIZE processes,
    one per GPU; MESH_DATA -1 is WORLD_SIZE / MESH_MODEL. A mesh that does
    not fill the world, or a BATCH_SIZE (the global batch) that the data
    axis does not divide, raises. (JAX's single process shrinks its data
    axis to gcd(BATCH_SIZE, devices); with one process per device there is
    no counterpart, as JAX's runner raises for processes.)"""
    model = rc.mesh_model
    data = (world_size // max(model, 1) if rc.mesh_data == -1
            else rc.mesh_data)
    if model < 1 or data < 1 or data * model != world_size:
        raise ValueError(f"MESH_DATA {rc.mesh_data} x MESH_MODEL {model} "
                         f"does not fit WORLD_SIZE {world_size} (one process "
                         "per GPU, launched by torchrun)")
    if rc.batch_size % data:
        raise ValueError(f"BATCH_SIZE {rc.batch_size} must divide evenly "
                         f"over the {data} data ranks")
    return data, model


def settings_dict(rc: RunConfig, run_id: str, exp_name: str) -> dict:
    """meta/settings.json, the reference's field set plus MODEL_KIND,
    MATMUL_PRECISION and the full signal geometry."""
    hp = rc.hyper
    m = rc.model_cfg
    return dict(
        ROOT=rc.root,
        BATCH_SIZE=rc.batch_size,
        EPOCHS=rc.epochs,
        USE_CC=rc.use_cc,
        Active=rc.active,
        FIXED_FRONTEND_Q=rc.fixed_frontend_q,
        Controller_Mode=rc.controller_mode,
        ALPHA=rc.alpha,
        WEIGHT_DECAY=hp.weight_decay,
        GRAD_CLIP_NORM=hp.grad_clip_norm,
        LR_FB=hp.lr_fb,
        LR_BACKEND=hp.lr_backend,
        REG_Q_W=hp.reg_q_w,
        REG_SMOOTH_W=hp.reg_smooth_w,
        FREEZE_Q_CONTROLLER_ONLY=rc.freeze_q_controller_only,
        LOSS_WEIGHT_SOUND=hp.loss_w_sound,
        LOSS_WEIGHT_AOA=hp.loss_w_aoa,
        LOSS_WEIGHT_DIST=hp.loss_w_dist,
        run_id=run_id,
        exp_name=exp_name,
        DELTAQ_BASE=m.deltaQ_base,
        DELTAQ_LOW_FACTOR=m.deltaQ_low_factor,
        DELTAQ_HIGH_FACTOR=m.deltaQ_high_factor,
        DELTAQ_MODE=m.deltaQ_mode,
        MODEL_KIND=rc.model_kind,
        MATMUL_PRECISION=rc.matmul_precision,
        comments=rc.comments,
        GEOMETRY=dict(FS=m.fs, TIMESTEPS=m.timesteps, N_FFT=m.n_fft,
                      N_BANDS=m.n_bands, FMIN=m.fmin, FMAX=m.fmax,
                      HOP_RATIO=m.hop_ratio, LATENT_DIM=m.latent_dim,
                      D_MODEL=m.d_model, FB_W_DTYPE=m.fb_w_dtype,
                      FB_VJP=m.fb_vjp, FB_X_GRAD=m.fb_x_grad,
                      DFT_MODE=m.dft_mode),
    )


def h5_paths(rc: RunConfig) -> dict:
    """The reference's split -> H5 path convention."""
    if rc.active:
        return {
            "train": f"{rc.root}/anechoic_train_active_wav.h5",
            "val": f"{rc.root}/anechoic_val_active_wav.h5",
            "test": f"{rc.root}/anechoic_test1_active_wav.h5",
        }
    return {
        "train": f"{rc.root}/anechoic_train_gt_group_phase.h5",
        "val": f"{rc.root}/anechoic_val_gt_group_phase.h5",
        "test": f"{rc.root}/anechoic_test2_gt_group_phase.h5",
    }


def data_paths(rc: RunConfig) -> dict:
    """Split -> file under DATA_FORMAT: the H5 convention, or the same
    basenames as ``.shard`` files under SHARD_ROOT (default ROOT), as
    ``precompute_h5`` (a ``.shard`` output) and ``h5_to_shard`` write
    them."""
    paths = h5_paths(rc)
    if rc.data_format == "h5":
        return paths
    root = rc.shard_root or rc.root
    return {k: os.path.join(root, os.path.basename(v)[:-3] + ".shard")
            for k, v in paths.items()}


def load_settings_near_checkpoint(ckpt_path: str) -> dict | None:
    """meta/settings.json beside the checkpoint or up to two levels up."""
    d = os.path.dirname(os.path.abspath(ckpt_path))
    for parent in (d, os.path.dirname(d), os.path.dirname(os.path.dirname(d))):
        p = os.path.join(parent, "meta", "settings.json")
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
    return None


def config_from_settings(s: dict) -> BiEARConfig:
    """Model config from a settings.json dict, with the evaluator's
    defaults. A settings file without DFT_MODE predates that key and
    trained on the rFFT spectra, so it is read as "fft"."""
    g = s.get("GEOMETRY", {})
    return BiEARConfig(
        use_cc=bool(s.get("USE_CC", True)),
        fixed_frontend_q=bool(s.get("FIXED_FRONTEND_Q", False)),
        controller_mode=str(s.get("Controller_Mode", "dual")).lower(),
        alpha=float(s.get("ALPHA", 0)),
        deltaQ_base=float(s.get("DELTAQ_BASE", 1.0)),
        deltaQ_low_factor=float(s.get("DELTAQ_LOW_FACTOR", 0.3)),
        deltaQ_high_factor=float(s.get("DELTAQ_HIGH_FACTOR", 5.0)),
        deltaQ_mode=str(s.get("DELTAQ_MODE", "relative")),
        fs=int(g.get("FS", 16000)),
        timesteps=int(g.get("TIMESTEPS", 19)),
        n_fft=int(g.get("N_FFT", 1024)),
        n_bands=int(g.get("N_BANDS", 100)),
        fmin=float(g.get("FMIN", 50.0)),
        fmax=g.get("FMAX", None),
        hop_ratio=float(g.get("HOP_RATIO", 1.0)),
        latent_dim=int(g.get("LATENT_DIM", 100)),
        d_model=int(g.get("D_MODEL", 128)),
        fb_w_dtype=_choice(g.get("FB_W_DTYPE", "float32"), "FB_W_DTYPE",
                           ("float32", "bfloat16")),
        fb_vjp=_choice(g.get("FB_VJP", "auto"), "FB_VJP",
                       ("auto", "custom", "autodiff")),
        fb_x_grad=bool(g.get("FB_X_GRAD", False)),
        dft_mode=_choice(g.get("DFT_MODE", "fft"), "DFT_MODE",
                         ("auto", "fft", "matmul")),
    )
