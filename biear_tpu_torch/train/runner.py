"""The training runner: the library form of ``train_biear.py``.

Counterpart of ``biear_tpu/train/runner.py`` for every model family
(MODEL_KIND active, auralnet or passive) on one device: the run tree and
``meta/settings.json``, a sanity batch, epochs of training and
validation, the plateau LR scale on the validation loss, the
lexicographic best tuple, best / last / epochNNN checkpoints with the
optimizer state, ``history.json``, ``scalars.jsonl``, the test pass on
the best parameters (``test_metrics.json``), the Q plots of an active run
(``q_vis/``) and crash-resume from ``last``.

Training data comes from a dataset (H5 or ``.shard`` splits, or injected
objects with ``rows()`` / ``len()``) through
``Prefetcher(batch_iterator(...))`` and the train step, or, with SYNTH_ON_DEVICE,
from the on-device synthesizer through ``make_train_chunk`` (a chunk of
one step included); then the validation and test splits are materialised
once on the device (``SynthEvalDataset``) as stacks of same-shape
batches, each evaluated in one dispatch (``make_eval_chunk``, one graph
replay per batch on the card); a split spilled to host memory and the
dataset splits are evaluated batch by batch through the eval step.
Metric sums stay on the device, with skipped and nonfinite batches left
out; the host reads them once per epoch.

Random streams: the synthesised chunks draw their batches and dropout
from one generator re-seeded before each chunk with the seed keyed by
(seed, epoch, chunk index) (``keyed_seed``; one generator, since a
captured chunk is registered with the generator it draws from; a mesh
rank's own dropout streams are likewise made once and re-seeded), so a run
resumed after epoch e equals an uninterrupted one at a fixed
SYNTH_CHUNK_STEPS;
the dataset path draws its dropout from a generator seeded with `seed`
at each call of ``train``, as the JAX runner re-seeds its key. torch's
streams are not JAX's: the two runners draw different batches and masks.

Across processes (``torchrun``, one per GPU, the process group joined by
``parallel.mesh.init_distributed``) the run is one job over a
MESH_DATA x MESH_MODEL mesh: BATCH_SIZE stays the global batch and each
data rank makes or reads its 1 / MESH_DATA of every batch (its rows of
each synthesised batch, drawn whole on every rank; its host slice of each
dataset epoch); the train step reduces the gradients; the evaluation
sums are added over the data ranks once per epoch. Rank 0 alone writes
the run tree (settings, logs, history, checkpoints, test metrics); the
others meet it at the checkpoints' gathers and before the test pass.
Data rank 0 draws its dropout as one process does; data rank d from a
generator keyed (..., d), and activations cut over the model axis from
one keyed (..., d, model rank). The Q plots are drawn in a world of one.
"""

from __future__ import annotations

import json
import math
import os
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..config import (RunConfig, data_paths, is_passive, make_exp_name,
                      make_run_dirs, mesh_shape, settings_dict)
from ..data.pipeline import Prefetcher, batch_iterator
from ..device import check_matmul_precision, matmul_precision, resolve_device
from ..models.auralnet import build_auralnet
from ..models.biear import build_active, build_passive
from ..models.layers import RankGenerators
from ..parallel.mesh import Mesh, shard_model
from ..utils.logging import MetricLogger, NullLogger
from ..utils.qvis import visualize_Q_LR
from . import state as ckpt
from .loop import (GRAD_HIST_EDGES, grad_hist_names, is_better_tuple,
                   make_eval_chunk, make_eval_step, make_train_chunk,
                   make_train_step)
from .optim import PlateauScheduler, make_optimizer

METRICS = ("loss", "sound_acc", "aoa_mae", "dist_acc")
STEP_SCALARS = METRICS + ("grad_fb_norm", "grad_backend_norm")


def keyed_seed(*key: int) -> int:
    """The seed of the non-negative integers `key` (seed, epoch, chunk
    index) through numpy's SeedSequence."""
    s = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0])
    return s >> 1


def keyed_generator(device, *key: int) -> torch.Generator:
    """A generator on `device` seeded with ``keyed_seed(*key)``."""
    return torch.Generator(device=device).manual_seed(keyed_seed(*key))


def dropout_streams(mesh: Mesh | None, shared: torch.Generator, device,
                    *key: int, streams: RankGenerators | None = None
                    ) -> RankGenerators | None:
    """This rank's dropout streams over the generator `shared`: None (draw
    from `shared`) on rank 0 and without a mesh; otherwise data rank d's
    replicated activations draw from a generator keyed (key..., d), or
    from `shared` on data rank 0, and activations cut over the model axis
    from one keyed (key..., d, model rank). Given `streams` (this call's
    earlier result for the same mesh and `shared`), its generators are
    re-seeded in place and it is returned: a captured chunk draws from
    the generators it was captured with, and a re-seeded generator draws
    what a fresh ``keyed_generator`` draws."""
    if mesh is None or mesh.rank == 0:
        return None
    d = mesh.data_rank
    if streams is None:
        rep = shared if d == 0 else torch.Generator(device=device)
        cut = rep if mesh.model == 1 else torch.Generator(device=device)
        streams = RankGenerators(shared, rep, cut)
    if d:
        streams.replicated.manual_seed(keyed_seed(*key, d))
    if mesh.model > 1:
        streams.sharded.manual_seed(keyed_seed(*key, d, mesh.model_rank))
    return streams


def check_supported(rc: RunConfig) -> tuple:
    """Refuse what the port does not run: a mesh that does not fit the
    process group's world (one process without a group is a world of
    one), an unknown MATMUL_PRECISION. Returns the mesh's (data, model)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape(rc, world)
    check_matmul_precision(rc.matmul_precision)
    return shape


def open_datasets(rc: RunConfig) -> dict:
    """The train / val / test splits of DATA_FORMAT (h5 or shard)."""
    paths = data_paths(rc)
    if rc.data_format == "shard":
        from ..data.shard import ShardDataset, shard_shapes
        shapes = shard_shapes(rc.model_cfg, is_passive(rc))
        return {k: ShardDataset(v, shapes=shapes) for k, v in paths.items()}
    from ..data.h5io import ActiveH5Dataset, PassiveH5Dataset
    DS = PassiveH5Dataset if is_passive(rc) else ActiveH5Dataset
    return {k: DS(v, preload=rc.preload_h5) for k, v in paths.items()}


class SynthEvalDataset:
    """A fixed evaluation split made once by a synthesizer, the
    counterpart of the reference's pre-generated val / test H5s.

    By default its batches stay on the synthesizer's device, grouped by
    shape into ``stacked_groups`` (tuples of tensors with a leading
    (n_batches,) axis; ``make_eval_chunk`` evaluates one in one dispatch)
    and held only there. A split whose estimated size exceeds
    SYNTH_EVAL_HBM_BUDGET_MB (read per instance, default 2048) is spilled
    to pinned host memory batch by batch and copied back per epoch, with
    no stacked groups; keep_on_device=True/False forces either.
    ``device_batches()`` yields the split batch by batch (slices of the
    stacks, group by group, or the spilled batches in order).
    test_thirds makes the split 1/3 one source, 1/3 two, 1/3 three, no
    batch straddling a third. Under a mesh every batch is drawn whole and
    this data rank keeps (and stacks) its share of its rows
    (``Mesh.rows``)."""

    def __init__(self, synth, n: int, seed: int, batch_size: int,
                 test_thirds: bool = False,
                 keep_on_device: bool | None = None,
                 mesh: Mesh | None = None):
        self.budget_mb = int(os.environ.get("SYNTH_EVAL_HBM_BUDGET_MB", 2048))
        self.device = synth.device
        if keep_on_device is None:
            # synthesizers of features (PassiveFeatureSynth) declare their
            # own per-row element count
            row = getattr(synth, "row_elems", 2 * synth.fs + synth.num_lags
                          + 56)
            est_mb = n * row * 4 / 2**20
            keep_on_device = est_mb <= self.budget_mb
            if not keep_on_device:
                print(f"[SynthEvalDataset] split of {n} rows ~{est_mb:.0f} "
                      f"MiB exceeds the {self.budget_mb} MiB device budget; "
                      "spilling to pinned host memory (set "
                      "SYNTH_EVAL_HBM_BUDGET_MB or keep_on_device to "
                      "override)")
        pin = self.device.type == "cuda"
        gen = torch.Generator(device=self.device).manual_seed(seed)
        batches = []
        made, third = 0, n // 3
        while made < n:
            take = min(batch_size, n - made)
            ns = None                  # 1, 2 or 3 sources at random
            if test_thirds:
                ns = 1 if made < third else (2 if made < 2 * third else 3)
                boundary = (third if made < third
                            else 2 * third if made < 2 * third else n)
                take = min(take, boundary - made)
            a, z = (0, take) if mesh is None else mesh.rows(take)
            # a rank with no rows of this batch still makes its draws
            b = synth.sample_batch(gen, take, n_src=ns,
                                   rows=(a, z) if z > a else (0, 1))
            made += take
            if z == a:
                continue
            if not keep_on_device:
                b = tuple(t.cpu().pin_memory() if pin else t.cpu() for t in b)
            batches.append(b)
        self.length = made
        self._batches = None if keep_on_device else batches
        groups = {}
        for b in batches if keep_on_device else ():
            groups.setdefault(b[0].shape[0], []).append(b)
        self.stacked_groups = [tuple(torch.stack(parts) for parts in zip(*g))
                               for g in groups.values()]

    def __len__(self) -> int:
        return self.length

    def device_batches(self):
        """The split batch by batch, on the device."""
        if self._batches is not None:
            for b in self._batches:
                yield tuple(t.to(self.device, non_blocking=True) for t in b)
            return
        for g in self.stacked_groups:
            for j in range(g[0].shape[0]):
                yield tuple(a[j] for a in g)


def _accumulate(sums: dict, metrics: dict, bs) -> dict:
    """Add one step's (0-dim) or a chunk's ((n,)) metrics to the device
    sums, weighted by the batch's real rows `bs`; a skipped or nonfinite
    batch adds only to the skip count."""
    ok = torch.isfinite(metrics["loss"])
    if "skipped" in metrics:
        ok = ok & (metrics["skipped"] == 0)
    okf = ok.float()
    for k in METRICS:
        v = torch.where(ok, metrics[k].float(), 0.0) * bs
        sums[k] = sums.get(k, 0.0) + v.sum()
    sums["skipped"] = sums.get("skipped", 0.0) + (1.0 - okf).sum()
    sums["_n"] = sums.get("_n", 0.0) + (okf * bs).sum()
    return sums


def _finalize(sums: dict, mesh: Mesh | None = None) -> dict:
    """Per-row means of the sums: one host read for the whole epoch. With
    a mesh the data ranks' sums are added first (every rank joins, also
    one that saw no batch)."""
    keys = [*METRICS, "skipped", "_n"]
    if mesh is not None:
        zero = torch.zeros((), device=mesh.device)
        vec = torch.stack([sums.get(k, zero) for k in keys]
                          + [zero + bool(sums)])
        vals = mesh.data_sum_(vec).tolist()
        sums = dict(zip(keys, vals)) if vals[-1] else {}
    elif sums:
        sums = dict(zip(keys, torch.stack([sums[k] for k in keys]).tolist()))
    if not sums:
        return {"loss": float("nan"), "sound_acc": 0.0,
                "aoa_mae": float("nan"), "dist_acc": 0.0, "skipped": 0}
    n = max(sums.pop("_n"), 1.0)
    skipped = int(sums.pop("skipped"))
    out = {k: v / n for k, v in sums.items()}
    out["skipped"] = skipped
    return out


def synth_chunk_steps(steps: int, chunk_cfg: int) -> int:
    """SYNTH_CHUNK_STEPS: -1 picks the largest divisor of `steps` up to
    128 (128 and a trailing sub-chunk when only small divisors exist);
    otherwise the configured count, at most `steps`. At least 1: the JAX
    runner's per-step synthesised path (0 or 1) is a chunk of one here."""
    if chunk_cfg >= 0:
        return max(1, min(chunk_cfg, steps))
    chunk = max((d for d in range(2, min(128, steps) + 1) if steps % d == 0),
                default=min(128, steps))
    return max(1, 128 if chunk < 16 and steps > 128 else chunk)


def q_plots(model, test, save_dir: str, batch_size: int, say) -> None:
    """The Q plots of the best parameters on two test batches
    (``utils.qvis.visualize_Q_LR``). Plotting never fails a run: an error
    is reported and the run goes on."""
    try:
        it = (test.device_batches() if hasattr(test, "device_batches")
              else batch_iterator(test, min(batch_size, 8), shuffle=False))
        batches = [b for _, b in zip(range(2), it)]
        visualize_Q_LR(model, batches, save_dir, max_batches=2,
                       sample_per_batch=1)
        say(f"[Q-vis] wrote plots to {save_dir}")
    except Exception as e:
        say(f"[Q-vis] skipped: {e}")


def shared_run_id(mesh: Mesh) -> str:
    """Rank 0's timestamp run id (``make_exp_name``'s format) on every
    rank."""
    stamp = mesh.from_main(int(datetime.now().strftime("%Y%m%d%H%M%S")))
    return f"{stamp // 10**6}-{stamp % 10**6:06d}"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(rc: RunConfig, *, datasets=None, synth=None, seed: int = 0,
          run_id: str | None = None, quiet: bool = False,
          max_steps_per_epoch: int | None = None,
          resume_from: str | None = None, device=None) -> dict:
    """Run the training job on `device` (the card unless device='cpu').

    datasets: optional {"train", "val", "test"} objects with ``rows()`` /
    ``len()``; otherwise opened from DATA_FORMAT's paths, or, with
    SYNTH_ON_DEVICE and a synthesizer on `device`, val and test are
    materialised from it (SYNTH_EVAL_SAMPLES rows each).
    resume_from: a run directory; training continues from its
    checkpoints/last (parameters, Adam state, epoch, LR scale, best tuple,
    plateau state) and appends to its history.

    Returns {"run_dir", "exp_name", "history", "test", "best_tuple",
    "global_step", "model" and "optimizer" (in the state that ``last``
    holds; this rank's pieces under a model axis), "timings" (host seconds
    of the eval splits' materialisation and of each checkpoint write)}.

    In a process group (``parallel.mesh.init_distributed``) every rank
    calls it with the same arguments and `device` its own; the histories
    it returns are the same on every rank.

    The run trains and evaluates under its MATMUL_PRECISION, which is the
    process-wide policy until it returns (``device.matmul_precision``)."""
    n_data, n_model = check_supported(rc)
    with matmul_precision(rc.matmul_precision):
        return _train(rc, n_data, n_model, datasets=datasets, synth=synth,
                      seed=seed, run_id=run_id, quiet=quiet,
                      max_steps_per_epoch=max_steps_per_epoch,
                      resume_from=resume_from, device=device)


def _train(rc: RunConfig, n_data: int, n_model: int, *, datasets, synth,
           seed: int, run_id, quiet: bool, max_steps_per_epoch,
           resume_from, device) -> dict:
    device = resolve_device(device)
    mesh = Mesh(n_data, n_model, device) if dist.is_initialized() else None
    is_main = mesh is None or mesh.is_main
    say = print if is_main and not quiet else (lambda *a: None)
    synthesising = synth is not None and rc.synth_on_device
    if synthesising and synth.device != device:
        raise ValueError(f"the synthesizer lives on {synth.device}, the run "
                         f"on {device}")

    if resume_from is not None:
        exp_name = os.path.basename(os.path.normpath(resume_from))
        rc.runs_root = os.path.dirname(os.path.normpath(resume_from)) or "."
        run_id = run_id or "resume"
    else:
        if run_id is None and mesh is not None:
            run_id = shared_run_id(mesh)
        exp_name, run_id = make_exp_name(rc, run_id)
    dirs = make_run_dirs(rc, exp_name, create=is_main)
    if is_main:
        with open(os.path.join(dirs["meta"], "settings.json"), "w") as f:
            json.dump(settings_dict(rc, run_id, exp_name), f, indent=2)
        logger = MetricLogger(dirs["logs_json"], dirs["tb"])
    else:
        logger = NullLogger()
    say(f"[Run dir] {dirs['run']}")
    say(f"[Device] {device}")
    if rc.matmul_precision != "default":
        say(f"[Precision] MATMUL_PRECISION={rc.matmul_precision}")
    say(f"[Mesh] {{'data': {n_data}, 'model': {n_model}}} over "
        f"{n_data * n_model} device(s)")
    # BATCH_SIZE is the global batch; each data rank makes or reads its rows
    local_bs = rc.batch_size // n_data
    rows = None if mesh is None else mesh.rows(rc.batch_size)
    host = {} if mesh is None else {"host_id": mesh.data_rank,
                                    "host_count": n_data}

    passive = is_passive(rc)
    build = (build_passive if passive else
             build_auralnet if rc.model_kind == "auralnet" else build_active)
    model = build(rc.model_cfg, seed=seed, device=device)
    if mesh is not None:
        mesh.broadcast_module_(model)
        shard_model(model, mesh)
    optimizer = make_optimizer(
        model, rc.hyper, freeze_controller=(
            not passive and rc.freeze_q_controller_only
            and not rc.fixed_frontend_q))
    train_step = make_train_step(model, rc.hyper, optimizer,
                                 rc.max_param_log, mesh)
    eval_step = make_eval_step(model, rc.hyper, mesh=mesh)
    eval_chunk = make_eval_chunk(model, rc.hyper, mesh=mesh)
    hist_names = grad_hist_names(model, rc.max_param_log)
    sched = PlateauScheduler(factor=0.5, patience=10)
    step_gen = torch.Generator(device=device).manual_seed(seed)
    step_drop = dropout_streams(mesh, step_gen, device, seed) or step_gen
    chunk_gen = torch.Generator(device=device)
    chunk_drop = None
    timings = {"eval_splits_s": None, "checkpoint_s": []}

    chunk_runners = {}

    def get_chunk_runner(chunk: int):
        if chunk not in chunk_runners:
            chunk_runners[chunk] = make_train_chunk(
                model, rc.hyper, optimizer,
                synth.batch_fn(rc.batch_size, rows=rows), chunk,
                rc.max_param_log, mesh)
        return chunk_runners[chunk]

    def save(name: str, with_optimizer: bool, meta: dict):
        t0 = time.perf_counter()
        ckpt.save_checkpoint(os.path.join(dirs["checkpoints"], name), model,
                             optimizer if with_optimizer else None, meta)
        timings["checkpoint_s"].append(time.perf_counter() - t0)

    if datasets is None:
        if synthesising:
            n_eval = int(rc.raw.get("SYNTH_EVAL_SAMPLES", 1024))
            on_dev = rc.raw.get("SYNTH_EVAL_ON_DEVICE", None)
            on_dev = None if on_dev is None else bool(on_dev)
            say(f"[Synth] materialising val/test splits ({n_eval} samples "
                f"each, {'auto' if on_dev is None else ('device' if on_dev else 'host')}-resident)")
            t0 = time.perf_counter()
            datasets = {
                "val": SynthEvalDataset(synth, n_eval, seed + 101,
                                        rc.batch_size, keep_on_device=on_dev,
                                        mesh=mesh),
                "test": SynthEvalDataset(synth, n_eval, seed + 202,
                                         rc.batch_size, test_thirds=True,
                                         keep_on_device=on_dev, mesh=mesh),
            }
            _sync(device)
            timings["eval_splits_s"] = time.perf_counter() - t0
        else:
            datasets = open_datasets(rc)

    n_params = sum(p.numel() for p in model.parameters())
    say(f"[Params] total={n_params:,}")

    # ---- sanity batch ----
    if synthesising:
        sb = synth.sample_batch(torch.Generator(device=device).manual_seed(0),
                                rc.batch_size, rows=rows)
    else:
        sb = tuple(torch.as_tensor(a, device=device) for a in next(
            batch_iterator(datasets["train"], local_bs, shuffle=False,
                           **host)))
    first = float(eval_step(sb)["loss"])
    if not math.isfinite(first):
        raise RuntimeError(f"[Sanity] nonfinite loss on the first batch: "
                           f"{first}")
    say(f"[Sanity] first-batch loss={first:.4f} (finite)")

    history = {"train": [], "val": []}
    best_tuple = None
    global_step = 0
    lr_scale = 1.0
    start_epoch = 1

    if resume_from is not None:
        last_dir = os.path.join(dirs["checkpoints"], "last")
        if not os.path.isdir(last_dir):
            raise FileNotFoundError(f"no 'last' checkpoint under "
                                    f"{dirs['checkpoints']} to resume from")
        meta = ckpt.load_checkpoint(last_dir, model, optimizer)
        if meta:
            start_epoch = int(meta.get("epoch", 0)) + 1
            lr_scale = float(meta.get("lr_scale", 1.0))
            if "global_step" in meta:
                global_step = int(meta["global_step"])
            else:
                # metadata from before global_step: derive it, so that the
                # resumed telemetry continues the step axis
                if synthesising:
                    spe = max_steps_per_epoch or int(
                        rc.raw.get("SYNTH_STEPS_PER_EPOCH", 128))
                else:
                    spe = -(-len(datasets["train"]) // rc.batch_size)
                    if max_steps_per_epoch is not None:
                        spe = min(spe, max_steps_per_epoch)
                global_step = (start_epoch - 1) * spe
            if meta.get("best_tuple"):
                best_tuple = tuple(meta["best_tuple"])
            s = meta.get("sched")
            if s:
                sched.best = float(s["best"])
                sched.num_bad = int(s["num_bad"])
                sched.scale = float(s["scale"])
        hist_path = os.path.join(dirs["logs_json"], "history.json")
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                history = json.load(f)
        say(f"[Resume] from epoch {start_epoch - 1}, lr_scale={lr_scale}")

    def log_split(name, epoch, sums, t0, training):
        # a training step's metrics are already the global batch's
        out = _finalize(sums, None if training else mesh)
        out["sec"] = time.time() - t0
        logger.scalars(name, {k: v for k, v in out.items() if k != "sec"},
                       epoch)
        return out

    def run_train_chunked(name, epoch, steps, chunk):
        """An epoch as ceil(steps / chunk) fused synthesize -> train
        chunks; chunk i draws from the chunk generator re-seeded with the
        seed keyed (seed, epoch, i).
        The stream depends on SYNTH_CHUNK_STEPS, so seed-matched runs hold
        it fixed. The HIST_EVERY and PRINT_EVERY marks a chunk crosses are
        logged from its rows, with one host read per chunk."""
        nonlocal global_step, chunk_drop
        sums = {}
        t0 = time.time()
        done = chunk_idx = 0
        while done < steps:
            c = min(chunk, steps - done)
            chunk_gen.manual_seed(keyed_seed(seed, epoch, chunk_idx))
            chunk_drop = dropout_streams(mesh, chunk_gen, device, seed,
                                         epoch, chunk_idx, streams=chunk_drop)
            chunk_idx += 1
            gs_before = global_step
            ms = get_chunk_runner(c)(chunk_gen, lr_scale, chunk_drop)
            _accumulate(sums, ms, rc.batch_size)
            done += c
            global_step += c
            first_mark = -(-gs_before // rc.hist_every) * rc.hist_every
            marks = range(first_mark, global_step, rc.hist_every)
            first_pmark = -(-gs_before // rc.print_every) * rc.print_every
            pmarks = range(first_pmark, global_step, rc.print_every)
            if not (marks or pmarks):
                continue
            flat = torch.cat([torch.stack([ms[k].float() for k in
                                           STEP_SCALARS]).reshape(-1),
                              ms["grad_hist"].reshape(-1)]).cpu().numpy()
            n_s = len(STEP_SCALARS) * c
            sc = dict(zip(STEP_SCALARS, flat[:n_s].reshape(-1, c)))
            hist = flat[n_s:].reshape(ms["grad_hist"].shape)
            for mark in marks:
                row = mark - gs_before
                logger.scalars("train_step", {k: v[row] for k, v in
                                              sc.items()}, mark)
                logger.histograms("grads", dict(zip(hist_names, hist[row])),
                                  GRAD_HIST_EDGES, mark)
            for mark in pmarks:
                row = mark - gs_before
                say(f"[step {mark:06d}] chunk/{c} "
                    f"loss={sc['loss'][row]:.4f}"
                    f" | sound_acc={sc['sound_acc'][row]:.3f}"
                    f" | aoa_mae={sc['aoa_mae'][row]:.3f}"
                    f" | dist_acc={sc['dist_acc'][row]:.3f}")
        return log_split(name, epoch, sums, t0, True)

    def run_eval_stacked(name, epoch, ds):
        """An eval split as one ``eval_chunk`` dispatch per stacked group
        of same-shape batches (every batch: JAX evaluates the stacks
        whole)."""
        sums = {}
        t0 = time.time()
        for g in ds.stacked_groups:
            _accumulate(sums, eval_chunk(g), g[0].shape[1])
        return log_split(name, epoch, sums, t0, False)

    def run_split(name, epoch, training):
        nonlocal global_step
        sums = {}
        padded = False
        if training and synthesising:
            steps = max_steps_per_epoch or int(
                rc.raw.get("SYNTH_STEPS_PER_EPOCH", 128))
            chunk = synth_chunk_steps(
                steps, int(rc.raw.get("SYNTH_CHUNK_STEPS", -1)))
            return run_train_chunked(name, epoch, steps, chunk)
        if not training and getattr(datasets[name], "stacked_groups", None):
            return run_eval_stacked(name, epoch, datasets[name])
        if hasattr(datasets[name], "device_batches"):
            it = datasets[name].device_batches()
        else:
            # the last partial batch is padded with weight-0 rows
            padded = True
            it = Prefetcher(batch_iterator(
                datasets[name], local_bs, shuffle=training, seed=seed,
                epoch=epoch, **host), device)
        t0 = time.time()
        try:
            for i, batch in enumerate(it):
                if (max_steps_per_epoch is not None
                        and i >= max_steps_per_epoch):
                    break
                if not training:
                    # real rows only: padding rows carry weight 0
                    bs = batch[-1].sum() if padded else batch[0].shape[0]
                    _accumulate(sums, eval_step(batch), bs)
                    continue
                m = train_step(batch, step_drop, lr_scale)
                if global_step % rc.hist_every == 0:
                    logger.scalars("train_step", {k: m[k] for k in
                                                  STEP_SCALARS}, global_step)
                    logger.histograms(
                        "grads", dict(zip(hist_names,
                                          m["grad_hist"].cpu().numpy())),
                        GRAD_HIST_EDGES, global_step)
                if global_step % rc.print_every == 0:
                    say(f"[step {global_step:06d}] "
                        f"loss={float(m['loss']):.4f}"
                        f" | sound_acc={float(m['sound_acc']):.3f}"
                        f" | aoa_mae={float(m['aoa_mae']):.3f}"
                        f" | dist_acc={float(m['dist_acc']):.3f}")
                global_step += 1
                _accumulate(sums, m, m["weight"])
        finally:
            # stopping early must release the prefetch worker
            if hasattr(it, "close"):
                it.close()
        return log_split(name, epoch, sums, t0, training)

    def last_meta(epoch):
        return {"epoch": epoch, "lr_scale": lr_scale,
                "global_step": global_step,
                "best_tuple": list(best_tuple) if best_tuple else None,
                "sched": {"best": sched.best, "num_bad": sched.num_bad,
                          "scale": sched.scale}}

    def write_history():
        if is_main:
            with open(os.path.join(dirs["logs_json"], "history.json"),
                      "w") as f:
                json.dump(history, f, indent=2)

    for e in range(start_epoch, rc.epochs + 1):
        tr = run_split("train", e, True)
        va = run_split("val", e, False)
        history["train"].append(tr)
        history["val"].append(va)
        say(f"[{e:03d}] train_loss={tr['loss']:.4f} (skip={tr['skipped']}), "
            f"val_loss={va['loss']:.4f}, val_sound_acc={va['sound_acc']:.3f}, "
            f"val_aoa_mae={va['aoa_mae']:.3f}, "
            f"val_dist_acc={va['dist_acc']:.3f}")

        lr_scale = sched.step(va["loss"])
        curr = (va["sound_acc"], va["aoa_mae"], va["dist_acc"])
        if all(np.isfinite(curr)) and is_better_tuple(curr, best_tuple):
            best_tuple = curr
            save("best", True, {"epoch": e, "val": va, "lr_scale": lr_scale})
            say(f"Saved new best: sound_acc={curr[0]:.4f}, "
                f"aoa_mae={curr[1]:.4f}, dist_acc={curr[2]:.4f}")
        if rc.save_every_epoch:
            save(f"epoch{e:03d}", False, {"epoch": e})
        save("last", True, last_meta(e))       # the crash-resume point
        write_history()

    save("last", True, last_meta(rc.epochs))
    write_history()

    # ---- test with the best parameters; the model then returns to the
    # state that 'last' holds ----
    te = None
    if "test" in datasets:
        trained = {k: v.clone() for k, v in model.state_dict().items()}
        if mesh is not None:
            mesh.barrier()             # rank 0 has written 'best'
        best_dir = os.path.join(dirs["checkpoints"], "best")
        if os.path.isdir(best_dir):
            ckpt.load_checkpoint(best_dir, model)
        te = run_split("test", 0, False)
        if is_main:
            with open(os.path.join(dirs["logs_json"], "test_metrics.json"),
                      "w") as f:
                json.dump(te, f, indent=2)
        say(f"Test metrics: {te}")
        # the plots' forward passes would be collectives of one rank
        if (mesh is None or mesh.world == 1) and rc.active \
                and rc.model_kind == "active":
            q_plots(model, datasets["test"], dirs["q_vis"], rc.batch_size,
                    say)
        with torch.no_grad():
            model.load_state_dict(trained)

    logger.close()
    return {"run_dir": dirs["run"], "exp_name": exp_name,
            "history": history, "test": te, "best_tuple": best_tuple,
            "global_step": global_step, "model": model,
            "optimizer": optimizer, "timings": timings}
