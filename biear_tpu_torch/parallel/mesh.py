"""Process groups, the ('data', 'model') mesh and its placement rules.

Counterpart of ``biear_tpu/parallel/mesh.py`` for ``torch.distributed``,
with one process per GPU, launched by ``torchrun``:

  * the global batch is split over 'data': data rank d holds rows
    [d B / D, (d + 1) B / D) of every batch, and the data ranks' gradients
    meet in one flat all-reduce per step (``pack_grads``, then
    ``Mesh.data_sum_``, then ``unpack_grads``; over one data rank nothing
    is sent);
  * 'model' cuts the body and the sector heads, Megatron style:
    ``body.0`` is column-parallel (its 512 outputs split), ``body.3``
    row-parallel (its partial outputs all-reduced, its bias added once),
    ``body.6`` replicated; the heads are head-parallel (8 / M per rank),
    their outputs gathered by an all-reduce of a zero-filled (B, 8, .)
    tensor. The body's and the heads' inputs enter through an identity
    whose backward all-reduces, so that the replicated parameters upstream
    get the whole gradient.

Rank r sits at (data = r // M, model = r % M), as ``make_mesh``'s
``reshape(data, model)`` places devices. Every collective is an
``all_reduce``, and the initial state is sent by one ``broadcast``: the
operations that NCCL, gloo on the CPU and gloo on CUDA tensors all
support. Parameter names do not change under the mesh, and checkpoints
hold the full tensors (``full_state_dict``, ``load_full_state_dict``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from ..train.optim import is_frontend

TIMEOUT_S = 600.0


def init_distributed(device=None, backend: str | None = None
                     ) -> torch.device:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device.

    On the card (the default) the rank takes card LOCAL_RANK, set before
    the device is resolved, and the group runs over NCCL; with
    device='cpu' over gloo. NCCL that cannot start raises: nothing falls
    back to gloo. `backend` overrides the choice and lets ranks share a
    card (LOCAL_RANK modulo the card count); it exists to run two ranks on
    one card, which NCCL refuses. Collectives that wait longer than
    TIMEOUT_S seconds raise."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        n = torch.cuda.device_count()
        if backend is None and local >= n:
            raise ValueError(f"LOCAL_RANK {local} but {n} card(s): torchrun "
                             "starts one process per card")
        torch.cuda.set_device(local % n)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    # NCCL starts at once on its device, so that a failure shows here
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            **extra)
    return device


def is_main() -> bool:
    """Rank 0 of the process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


class Mesh:
    """The ('data', 'model') grid over the process group's ranks, rank r
    at (r // model, r % model), with this rank's data group (the ranks of
    its model index) and model group (the ranks of its data index)."""

    def __init__(self, data: int, model: int, device):
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        if data * model != self.world:
            raise ValueError(f"mesh {data}x{model} needs WORLD_SIZE "
                             f"{data * model}, have WORLD_SIZE {self.world}")
        self.data, self.model = data, model
        self.device = torch.device(device)
        self.data_rank, self.model_rank = divmod(self.rank, model)
        self.data_group = self._group_of([
            [d * model + m for d in range(data)] for m in range(model)])
        self.model_group = self._group_of([
            [d * model + m for m in range(model)] for d in range(data)])

    def _group_of(self, partition):
        """A group per rank list (every rank creates every group, in the
        same order); returns the one holding this rank."""
        mine = None
        for ranks in partition:
            group = (dist.group.WORLD if len(ranks) == self.world
                     else dist.new_group(ranks))
            if self.rank in ranks:
                mine = group
        return mine

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> tuple:
        """This data rank's share (start, stop) of n rows."""
        return (self.data_rank * n // self.data,
                (self.data_rank + 1) * n // self.data)

    def data_sum_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.data_group)
        return t

    def model_sum_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.model_group)
        return t

    def model_max_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.model_group)
        return t

    def barrier(self) -> None:
        """Every rank waits for the others (an all-reduce of one value)."""
        dist.all_reduce(torch.zeros(1, device=self.device))

    def from_main(self, value: int) -> int:
        """Rank 0's integer `value`, on every rank."""
        t = torch.tensor([value if self.is_main else 0], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t)
        return int(t.item())

    @torch.no_grad()
    def broadcast_module_(self, module: nn.Module) -> None:
        """Every rank takes rank 0's parameters (one flat broadcast)."""
        params = list(module.parameters())
        flat = torch.cat([p.reshape(-1) for p in params])
        dist.broadcast(flat, src=0)
        o = 0
        for p in params:
            p.copy_(flat[o:o + p.numel()].view_as(p))
            o += p.numel()


# ---------------- the collectives of the model region ----------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (each model rank's consumers saw part of the input's use)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum of the model ranks' partial outputs forward; identity backward
    (every model rank holds the whole output's gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherHeads(torch.autograd.Function):
    """(B, h, F) outputs of this rank's heads first..first + h -> (B,
    n_heads, F) of all heads: an all-reduce of a zero-filled tensor. The
    loss is computed identically on every model rank, so the backward
    takes this rank's slice of the gradient and sums nothing."""

    @staticmethod
    def forward(ctx, x, first, n_heads, group):
        ctx.span = (first, x.shape[1])
        full = x.new_zeros((x.shape[0], n_heads, x.shape[2]))
        full[:, first:first + x.shape[1]] = x
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        first, h = ctx.span
        return g[:, first:first + h], None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_heads(x: torch.Tensor, first: int, n_heads: int,
                 mesh: Mesh) -> torch.Tensor:
    return _GatherHeads.apply(x, first, n_heads, mesh.model_group)


def pack_grads(grads: list, weight: torch.Tensor, scalars: list,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The flat buffer a data rank sends, [W_r g ..., W_r, W_r s ...]:
    its gradients and scalars (loss and metrics), means over its rows
    weighted by weights that sum to W_r, each times W_r; written into `out`
    when given (a static buffer a captured graph writes), else new."""
    w = weight.reshape(1).float()
    parts = [*(g.reshape(-1) * w for g in grads), w,
             torch.stack(scalars).float() * w]
    return torch.cat(parts) if out is None else torch.cat(parts, out=out)


def unpack_grads(flat: torch.Tensor, like: list, n_scalars: int):
    """(grads shaped as the tensors `like`, scalars, W) from the data
    group's sum of ``pack_grads`` buffers: each divided by W = sum W_r (at
    least 1e-8, as ``losses.batch_mean``), views of `flat` for W. In exact
    arithmetic that is the global batch's weighted mean, ranks holding
    only padding (W_r = 0) included."""
    n = flat.numel() - 1 - n_scalars
    W = flat[n]
    den = torch.clamp(W, min=1e-8)
    out, o = [], 0
    for t in like:
        out.append((flat[o:o + t.numel()] / den).view_as(t))
        o += t.numel()
    return out, list(flat[n + 1:] / den), W


def flat_numel(params, n_scalars: int) -> int:
    """The length of a ``pack_grads`` buffer."""
    return sum(p.numel() for p in params) + 1 + n_scalars


# ---------------- placement ----------------

@dataclasses.dataclass(frozen=True)
class Split:
    """A tensor cut into M equal pieces along `dim`; model rank m holds
    piece m."""
    dim: int


@dataclasses.dataclass(frozen=True)
class Head:
    """A tensor of sector head `index`, held whole by the model rank that
    owns the head."""
    index: int


# Every top-level module any model family has, and its placement under
# model parallelism. A module outside both sets is a subsystem nobody
# placed: under model parallelism it raises rather than replicate quietly.
_MP_SHARDED = frozenset({"subheads", "body"})
_MP_REPLICATED = frozenset({"encoder_ild", "encoder_ipd", "cc_proj", "bifb",
                            "attn_L", "attn_R", "attn_diff"})
# body.0 column-parallel (out dim), body.3 row-parallel (in dim; its bias
# is added once, after the sum), body.6 replicated
_BODY = {"0.weight": Split(0), "0.bias": Split(0), "3.weight": Split(1)}


def param_placement(model: nn.Module, model_parallel: bool) -> dict:
    """Parameter name -> placement (None replicated, ``Split(dim)`` or
    ``Head(k)``) of the whole model, the counterpart of JAX's
    ``param_pspecs``. Without model parallelism everything is replicated;
    with it an unknown top-level module raises."""
    names = [n for n, _ in model.named_parameters()]
    if not model_parallel:
        return dict.fromkeys(names)
    unknown = {n.split(".")[0] for n in names} - _MP_SHARDED - _MP_REPLICATED
    if unknown:
        raise ValueError(
            f"param_placement: unknown top-level modules {sorted(unknown)} "
            "under model parallelism: add them to _MP_SHARDED or "
            "_MP_REPLICATED in parallel/mesh.py with an explicit placement")
    out = {}
    for n in names:
        top, _, rest = n.partition(".")
        out[n] = (_BODY.get(rest) if top == "body" else
                  Head(int(rest.split(".")[0])) if top == "subheads" else
                  None)
    return out


@dataclasses.dataclass
class ShardLayout:
    """The whole model's tensors, name -> (shape, placement) in state-dict
    order, and the mesh they are cut over."""
    mesh: Mesh
    entries: dict


def layout_of(model: nn.Module) -> ShardLayout | None:
    """The layout of a model cut by ``shard_model``, else None."""
    return getattr(model, "shard_layout", None)


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut the body and the sector heads to this model rank's share, in
    place (nothing changes when mesh.model is 1); the model keeps its
    whole layout as ``model.shard_layout``."""
    if mesh.model == 1:
        return model
    placement = param_placement(model, True)
    heads, hidden = len(model.subheads), model.body[0].out_features
    if heads % mesh.model or hidden % mesh.model:
        raise ValueError(f"MESH_MODEL {mesh.model} must divide the "
                         f"{heads} sector heads and the body's {hidden} "
                         "hidden units")
    model.shard_layout = ShardLayout(mesh, {
        n: (tuple(t.shape), placement.get(n))
        for n, t in model.state_dict().items()})
    model.body.shard_(mesh)
    model.subheads.shard_(mesh)
    return model


def _piece(t: torch.Tensor, placement, mesh: Mesh) -> torch.Tensor:
    """This model rank's piece of the whole tensor `t` (a view)."""
    if isinstance(placement, Split):
        k = t.shape[placement.dim] // mesh.model
        return t.narrow(placement.dim, mesh.model_rank * k, k)
    return t


def gather_full(layout: ShardLayout, local: dict, names: list) -> dict:
    """The whole tensors `names` on the CPU from this rank's `local` ones
    (a collective of the model group: every rank passes the same names)."""
    mesh = layout.mesh
    out, cut = {}, []
    for n in names:
        shape, placement = layout.entries[n]
        if placement is None:
            out[n] = local[n].detach().to("cpu", copy=True)
            continue
        full = torch.zeros(shape, device=mesh.device)
        if n in local:
            _piece(full, placement, mesh).copy_(local[n])
        cut.append((n, full))
    if cut:
        flat = mesh.model_sum_(torch.cat([f.reshape(-1) for _, f in cut]))
        o = 0
        for n, f in cut:
            out[n] = flat[o:o + f.numel()].view_as(f).cpu()
            o += f.numel()
    return {n: out[n] for n in names}


def shard_full(layout: ShardLayout, full: dict, names) -> dict:
    """This rank's pieces `names` of the whole tensors `full`."""
    return {n: _piece(full[n], layout.entries[n][1], layout.mesh).clone()
            for n in names}


def _check_names(got, want, what: str) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise RuntimeError(f"{what}: missing {missing}, unexpected {extra}")


def full_state_dict(model: nn.Module) -> dict:
    """The model's whole state dict on the CPU under its usual names,
    whatever the mesh (a model cut over 'model' gathers its pieces)."""
    layout = layout_of(model)
    sd = model.state_dict()
    if layout is None:
        return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}
    return gather_full(layout, sd, list(layout.entries))


def load_full_state_dict(model: nn.Module, sd: dict) -> None:
    """Load a whole state dict strictly, each rank taking its pieces."""
    layout = layout_of(model)
    if layout is not None:
        _check_names(sd, layout.entries, "the state dict")
        sd = shard_full(layout, sd, model.state_dict().keys())
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)


def _group_names(layout: ShardLayout, label: str) -> list:
    """The whole model's names in optimizer group `label` (the frontend
    group holds the 'bifb' subtree, the backend group the rest)."""
    return [n for n in layout.entries
            if is_frontend(n) == (label == "frontend")]


def full_optimizer_state(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the whole moments of every group."""
    state = optimizer.state_dict()
    layout = layout_of(model)
    if layout is not None:
        for label, st in state.items():
            names = _group_names(layout, label)
            for key in ("m", "v"):
                st[key] = gather_full(layout, st[key], names)
    return state


def load_full_optimizer_state(optimizer, model: nn.Module,
                              state: dict) -> None:
    """Load whole moments, each rank taking its pieces."""
    layout = layout_of(model)
    if layout is not None:
        local = {g.label: g.names for g in optimizer.groups if not g.frozen}
        for label, st in state.items():
            if label not in local:
                continue
            for key in ("m", "v"):
                _check_names(st[key], _group_names(layout, label),
                             f"optimizer group {label!r} {key}")
                st[key] = shard_full(layout, st[key], local[label])
    optimizer.load_state_dict(state)
