"""The optimizer step and its telemetry on the card: three launches of
``kernels/fused_update.cu`` over every leaf at once.

``loop.apply_update`` takes this path for CUDA gradients and
``loop.plain_update`` (``group_norms``, ``grad_histograms``,
``optim.Adam``), the contract, for CPU ones; a CUDA tensor launches the
kernels or raises. The results are the plain version's: ``grad_hist``, the
finite flags, ``skipped`` and the absolute maxima to the bit, the norms
and the update to float32 rounding (squares summed in another order). The
norm is taken once: a group's reported norm is its clip norm. Where ``ok``
is false the parameters, the moments and the counts keep their bits.

Per call: ``leaf_stats`` (a partial row per TILE-element tile of every
gradient), ``finalize`` (one block: the per-leaf table, the group sums,
the metric scalars and ``grad_hist`` written in place, ``ok``, the clip
factors and bias corrections, the counts advanced where ``ok``) and
``adam`` (the masked update of every trained leaf). Under a model axis
(``layout_of(model)``) the per-leaf table, whose rows are the whole
model's tensors, goes through ``Mesh.model_max_`` and ``model_sum_``
between a phase-A and a phase-B launch of ``finalize``. Every launch
counts as ``LAUNCHES["fused_update"]``.

The leaf tables are kernel parameters, packed here once per set of
addresses (``_plan``, a few kept per optimizer): a captured step keeps
them in its graph nodes and copies nothing from the host at replay.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from ..kernels import count_launch
from ..kernels.build import check_launch
from ..parallel.mesh import layout_of
from .loop import GRAD_HIST_EDGES, _counted
from .optim import B1, B2, is_frontend

TILE = 4096            # elements of a work item (kTile)
MAX_LEAVES = 256       # leaves of one table (kMaxLeaves)
MAX_GROUPS = 4         # trained optimizer groups (kMaxGroups)
PARTIAL = 21           # words of a partial row (kPartial)
TABLE_COLS = 24        # per table row: 2 maxima, 22 sums
NORM_KEYS = ("grad_fb_norm", "grad_fb_absmax", "grad_fb_finite",
             "grad_backend_norm", "grad_backend_absmax",
             "grad_backend_finite")
N_METRICS = len(NORM_KEYS) + 1          # and "skipped"
N_BUCKETS = len(GRAD_HIST_EDGES) + 1
BACKEND, COUNTED, ALIGNED_G, ALIGNED_ALL, GROUP_SHIFT = 1, 2, 4, 8, 8
PLANS_KEPT = 8

_plans: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


@dataclasses.dataclass
class _Plan:
    """What one set of addresses launches: the packed leaf tables (buffer,
    whether a leaf of it trains), the sizes and the scratch offsets (in
    float32 words) of the partial rows, the per-leaf info, the table and
    the coefficients, and the trained groups' arrays."""
    tables: list
    n_leaves: int
    n_rows: int
    n_hist: int
    n_groups: int
    off_info: int
    off_table: int
    off_coef: int
    words: int
    clip: ctypes.Array
    tg: ctypes.Array
    count: ctypes.Array
    neg_lr: ctypes.Array


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _pack(leaf0: int, tile0: int, starts: list, n: list, row: list,
          meta: list, ptrs: list) -> ctypes.Array:
    """A LeafTable: [n_leaves, leaf0, tile0, n_tiles], then tile, n, row
    and meta (int32, MAX_LEAVES each), then g, p, m and v (addresses,
    MAX_LEAVES each). `starts` holds each leaf's first tile and, last, the
    table's tiles."""
    k = len(n)
    ints = np.zeros((4, MAX_LEAVES), np.int32)
    for i, a in enumerate((starts[:-1], n, row, meta)):
        ints[i, :k] = a
    addr = np.zeros((4, MAX_LEAVES), np.uint64)
    addr[:, :k] = np.array(ptrs, np.uint64).reshape(k, 4).T
    data = (np.array([k, leaf0, tile0, starts[-1]], np.int32).tobytes()
            + ints.tobytes() + addr.tobytes())
    return ctypes.create_string_buffer(data, len(data))


def _trained(optimizer, names: list) -> list:
    """(leaf indices, clip, telemetry group, count, lr, m, v) of each
    trained group. A group's clip norm is its telemetry group's (bifb
    frontend or backend), so its leaves must be exactly that group's."""
    index = {n: i for i, n in enumerate(names)}
    out = []
    for g in optimizer.groups:
        if g.frozen or not g.params:
            continue
        leaves = [index[n] for n in g.names]
        front = is_frontend(g.names[0])
        if sorted(leaves) != [i for i, n in enumerate(names)
                              if is_frontend(n) == front]:
            raise ValueError(f"fused update: optimizer group {g.label!r} "
                             "must hold exactly the "
                             f"{'frontend' if front else 'backend'} leaves")
        out.append((leaves, g.clip, 0 if front else 1, g.count, g.lr, g.m,
                    g.v))
    if len(out) > MAX_GROUPS:
        raise ValueError(f"fused update: {len(out)} trained groups, at most "
                         f"{MAX_GROUPS}")
    return out


def _check_state(t: torch.Tensor, device, what: str) -> None:
    if t.dtype != torch.float32 or t.device != device or \
            not t.is_contiguous():
        raise ValueError(f"fused update: {what} must be contiguous float32 "
                         f"on {device}, got {t.dtype} on {t.device}")


def _plan(model, optimizer, grads: list, max_param_log: int,
          layout) -> _Plan:
    """Pack the leaf tables of these gradients and this model's state."""
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    device = grads[0].device
    if len(grads) != len(params):
        raise ValueError(f"fused update: {len(grads)} gradients for "
                         f"{len(params)} parameters")
    L = len(params)
    group = [0] * L
    state = [(0, 0, 0)] * L
    trained = _trained(optimizer, names)
    for gi, (leaves, _, _, count, _, m, v) in enumerate(trained):
        if count.dtype != torch.int32 or count.device != device:
            raise ValueError("fused update: a step count must be int32 on "
                             f"{device}")
        for i, mt, vt in zip(leaves, m, v):
            for t, what in ((params[i], "a parameter"), (mt, "a moment"),
                            (vt, "a moment")):
                _check_state(t, device, what)
            group[i] = gi + 1
            state[i] = (params[i].data_ptr(), mt.data_ptr(), vt.data_ptr())
    rows = (dict(zip(names, range(L))) if layout is None
            else {n: r for r, n in enumerate(layout.entries)})
    n_rows = L if layout is None else len(layout.entries)
    tables, tile0 = [], 0
    for leaf0 in range(0, L, MAX_LEAVES):
        starts, n, row, meta, ptrs = [0], [], [], [], []
        for i in range(leaf0, min(L, leaf0 + MAX_LEAVES)):
            g = grads[i]
            if g.numel() != params[i].numel():
                raise ValueError(f"fused update: gradient {names[i]} has "
                                 f"{g.numel()} elements, its parameter "
                                 f"{params[i].numel()}")
            addr = (g.data_ptr(), *state[i])
            aligned = all(a % 16 == 0 for a in addr)
            n.append(g.numel())
            starts.append(starts[-1] + max(1, -(-g.numel() // TILE)))
            row.append(rows[names[i]])
            meta.append((BACKEND if not is_frontend(names[i]) else 0)
                        | (COUNTED if _counted(layout, names[i]) else 0)
                        | (ALIGNED_G if addr[0] % 16 == 0 else 0)
                        | (ALIGNED_ALL if aligned and group[i] else 0)
                        | group[i] << GROUP_SHIFT)
            ptrs.extend(addr)
        tables.append((_pack(leaf0, tile0, starts, n, row, meta, ptrs),
                       any(group[leaf0:leaf0 + MAX_LEAVES])))
        tile0 += starts[-1]
    off_info = _round4(tile0 * PARTIAL)
    off_table = off_info + 4 * L
    off_coef = _round4(off_table + TABLE_COLS * n_rows)
    G = len(trained)
    pad = lambda vals, ty: (ty * MAX_GROUPS)(*vals)
    return _Plan(tables, L, n_rows, len(range(n_rows)[:max_param_log]), G,
                 off_info, off_table, off_coef, off_coef + 1 + 3 * G,
                 pad([t[1] for t in trained], ctypes.c_float),
                 pad([t[2] for t in trained], ctypes.c_int),
                 pad([t[3].data_ptr() for t in trained], ctypes.c_void_p),
                 pad([-t[4] for t in trained], ctypes.c_float))


def plan_of(model, optimizer, grads: list, max_param_log: int,
            layout) -> _Plan:
    """``_plan`` for these addresses, packed once and kept (the last
    PLANS_KEPT sets per optimizer)."""
    key = (max_param_log, id(layout),
           tuple(g.data_ptr() for g in grads),
           tuple(p.data_ptr() for p in model.parameters()),
           tuple(t.data_ptr() for g in optimizer.groups
                 if not g.frozen for t in (*g.m, *g.v)))
    kept = _plans.setdefault(optimizer, collections.OrderedDict())
    plan = kept.get(key)
    if plan is None:
        plan = kept[key] = _plan(model, optimizer, grads, max_param_log,
                                 layout)
        while len(kept) > PLANS_KEPT:
            kept.popitem(last=False)
    kept.move_to_end(key)
    return plan


_EDGES = (ctypes.c_float * len(GRAD_HIST_EDGES))(*GRAD_HIST_EDGES.tolist())


def fused_update(model, optimizer, grads: list, loss: torch.Tensor,
                 lr_scale, max_param_log: int) -> tuple:
    """The masked Adam step of `grads` (CUDA, parameter order) and its
    telemetry, launched on the current stream: (the norms as
    ``group_norms`` names them, "skipped", "grad_hist"), views of one
    float32 buffer the kernels write. `loss` is the step's 0-dim loss,
    `lr_scale` a float or a 0-dim tensor on the card (read by the kernel,
    so a replay sees its value)."""
    from ..kernels.build import fused_update_lib

    device = grads[0].device
    if device.type != "cuda":
        raise ValueError(f"fused update: gradients on {device}, not a card")
    with torch.cuda.device(device):
        return run_update(fused_update_lib(),
                          torch.cuda.current_stream().cuda_stream, model,
                          optimizer, grads, loss, lr_scale, max_param_log)


def run_update(lib, stream, model, optimizer, grads: list,
               loss: torch.Tensor, lr_scale, max_param_log: int) -> tuple:
    """``fused_update`` through `lib`, the C interface of
    ``fused_update.cu``, on `stream`."""
    device = grads[0].device
    for g in grads:
        if g.dtype != torch.float32 or g.device != device:
            raise ValueError("fused update: gradients must be float32 on "
                             f"one device, got {g.dtype} on {g.device}")
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    loss = loss.to(device, torch.float32)
    scale = (lr_scale.to(device, torch.float32)
             if isinstance(lr_scale, torch.Tensor) else None)
    layout = layout_of(model)
    plan = plan_of(model, optimizer, grads, max_param_log, layout)
    nbytes = lib.fused_update_table_bytes()
    scratch = torch.empty(plan.words, dtype=torch.float32, device=device)
    out = torch.empty(N_METRICS + plan.n_hist * N_BUCKETS,
                      dtype=torch.float32, device=device)
    base = scratch.data_ptr()
    partials, info = base, base + 4 * plan.off_info
    table, coef = base + 4 * plan.off_table, base + 4 * plan.off_coef
    if layout is not None:
        scratch[plan.off_table:plan.off_coef].zero_()

    def launched(err: int) -> None:
        check_launch(err, "fused_update")
        count_launch("fused_update")

    def finalize(mode: int) -> None:
        launched(lib.fused_update_finalize_launch(
            mode, plan.n_leaves, plan.n_rows, plan.n_hist, plan.n_groups,
            B1, B2, partials, info, table, loss.data_ptr(), out.data_ptr(),
            coef, plan.clip, plan.tg, plan.count, stream))

    for buf, _ in plan.tables:
        if len(buf) != nbytes:
            raise RuntimeError(f"fused update: a leaf table of {len(buf)} "
                               f"bytes, the kernel's {nbytes}")
        launched(lib.fused_update_stats_launch(buf, _EDGES, partials, info,
                                               stream))
    if layout is None:
        finalize(3)
    else:
        n = plan.n_rows
        t = scratch[plan.off_table:plan.off_table + TABLE_COLS * n]
        finalize(1)
        layout.mesh.model_max_(t[:2 * n])
        layout.mesh.model_sum_(t[2 * n:])
        finalize(2)
    for buf, trains in plan.tables:
        if trains:
            launched(lib.fused_update_adam_launch(
                buf, coef, None if scale is None else scale.data_ptr(),
                0.0 if scale is not None else float(lr_scale),
                optimizer.weight_decay, optimizer.eps, B1, B2, 1.0 - B1,
                1.0 - B2, plan.neg_lr, plan.n_groups, stream))
    norms = {k: out[i] for i, k in enumerate(NORM_KEYS)}
    return (norms, out[len(NORM_KEYS)],
            out[N_METRICS:].view(plan.n_hist, N_BUCKETS))
