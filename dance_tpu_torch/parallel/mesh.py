"""Rank mesh, placement and collectives on ``torch.distributed`` (counterpart:
dance_tpu/parallel/mesh.py:14-161).

JAX runs one controller over a device mesh and lets GSPMD insert the
collectives. The port runs one process per rank (:func:`launch`, or
``torchrun``) and calls the collectives itself:

- a :class:`Mesh` lays the world's ranks out row-major over named axes
  (``dp``, ``tp``), as JAX's ``np.asarray(devices).reshape(shape)``, with one
  process group per line of each axis;
- :func:`to_device` and :func:`shard_batch` give a rank its rows of a host
  array, wrap-padded by repeating the last row (mesh.py:53-69, :117-147);
- :class:`RowShard` is a data-parallel fit's view of one row axis: its stored
  rows, its part of each global batch, and the step that sums the
  gradients over ``dp``;
- :func:`shard_params_for_tp` column-shards the large ``nn.Linear`` layers
  over ``tp`` (mesh.py:79-95), each then gathering its outputs.

The rule every sharded fit keeps: it repeats the single fit's math. Every
rank walks the same global batch order and draws the same shuffles, noise
and dropout masks for the whole batch, then takes its own rows; a loss is a
share of the global one (scaled by the global count), and the gradients are
summed across ``dp``. So a sharded fit equals the single fit up to float32
summation order, and never trains on the wrap-padded rows.

Collectives: NCCL runs ``all_gather``/``reduce_scatter`` natively; on gloo
(CPU tensors, and CUDA tensors, which is how one card holds two ranks) every
gather and reduce-scatter is an ``all_reduce`` of a zero-filled buffer,
which gloo carries for either device and which sums exactly (a value plus
zeros).
"""

import contextlib
import datetime
import os
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dance_tpu_torch.utils import resolve_device

_CURRENT_MESH: Optional["Mesh"] = None
_DP_MESH: Optional["Mesh"] = None  # the active data-parallel fit's mesh
_RANK_DEVICE: Optional[torch.device] = None  # set by launch in each rank


class Mesh:
    """This rank's place in a row-major layout of the world's ranks over
    named axes. ``shape`` maps each axis name to its size (as a JAX mesh's
    ``shape``), ``coords`` to this rank's index along it; ``group(axis)`` is
    the process group of the ranks that differ from this one along ``axis``
    only (None for an axis of size 1, where every collective is the
    identity). ``device`` is the rank's device."""

    def __init__(self, shape: Dict[str, int], coords: Dict[str, int], groups: Dict,
                 rank: int, world_size: int, device: Optional[torch.device], backend: str):
        self.shape, self.coords, self._groups = dict(shape), dict(coords), groups
        self.rank, self.world_size = rank, world_size
        self.device, self.backend = device, backend

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend!r}, device={self.device})")


def _world() -> Tuple[int, int, str]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.get_backend()
    return 0, 1, "none"


def get_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("dp", "tp"),
             device=None) -> Mesh:
    """Build (and remember) the mesh of the initialised process group, or of
    this process alone when none is (counterpart: mesh.py:27). The default
    puts every rank on ``dp``. Every rank must call it with the same
    arguments: the groups are made collectively, in one order. ``device``
    defaults to the one :func:`launch` gave this rank, else to the current
    CUDA card (``resolve_device("auto")``, which raises without one): the
    CPU only when named."""
    global _CURRENT_MESH
    rank, world, backend = _world()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match the axes {axis_names}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"Mesh shape {shape} does not match the world size {world}")
    layout = np.arange(world).reshape(shape)
    where = np.argwhere(layout == rank)[0]
    groups = {}
    for ax, name in enumerate(axis_names):
        if shape[ax] == 1:
            groups[name] = None
            continue
        if shape[ax] == world:
            groups[name] = dist.group.WORLD
            continue
        lines = np.moveaxis(layout, ax, -1).reshape(-1, shape[ax])
        for line in lines:  # every rank makes every group, in one order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    if device is not None or _RANK_DEVICE is None:
        device = resolve_device("auto" if device is None else device)
    else:
        device = _RANK_DEVICE
    mesh = Mesh(dict(zip(axis_names, shape)), dict(zip(axis_names, (int(i) for i in where))),
                groups, rank, world, device, backend)
    _CURRENT_MESH = mesh
    return mesh


def current_mesh(device=None) -> Mesh:
    """The mesh :func:`get_mesh` built last, else a new default one on
    ``device``."""
    return _CURRENT_MESH if _CURRENT_MESH is not None else get_mesh(device=device)


def mesh_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """``device`` when given, else the mesh's, else the current CUDA card;
    resolved by ``resolve_device``, so the CPU only when named."""
    if device is None and mesh is not None:
        device = mesh.device
    return resolve_device("auto" if device is None else device)


@contextlib.contextmanager
def dp_context(mesh: Optional[Mesh] = None):
    """Activate data-parallel placement for :func:`to_device` and
    :class:`RowShard` (counterpart: mesh.py:98). ``BaseMethod.fit_distributed``
    runs a model's ``fit`` inside it."""
    global _DP_MESH
    prev, _DP_MESH = _DP_MESH, (mesh or current_mesh())
    try:
        yield _DP_MESH
    finally:
        _DP_MESH = prev


def dp_active() -> bool:
    return _DP_MESH is not None


def active_dp_mesh() -> Optional[Mesh]:
    """The mesh of the surrounding :func:`dp_context`, or None."""
    return _DP_MESH


# ---------------------------------------------------------------------------
# collectives (identity on an axis of size 1)
# ---------------------------------------------------------------------------


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """``t`` summed over the ranks of ``axis`` (in place when ``t`` is
    contiguous: NCCL takes contiguous tensors only)."""
    if mesh.size(axis) > 1:
        t = t.contiguous()
        dist.all_reduce(t, group=mesh.group(axis))
    return t


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """The ranks' equal-sized row blocks of ``axis``, stacked in rank order
    (no gradient)."""
    size = mesh.size(axis)
    if size == 1:
        return x
    x = x.contiguous()
    if mesh.backend == "nccl":
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=mesh.group(axis))
        return torch.cat(parts)
    rows = x.shape[0]
    out = x.new_zeros((size * rows,) + x.shape[1:])
    i = mesh.index(axis)
    out[i * rows:(i + 1) * rows] = x
    dist.all_reduce(out, group=mesh.group(axis))
    return out


def reduce_scatter_rows(x: torch.Tensor, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """``x`` (size * rows, ...) summed over the ranks of ``axis``; returns
    this rank's block of rows."""
    size = mesh.size(axis)
    if size == 1:
        return x
    rows = x.shape[0] // size
    i = mesh.index(axis)
    x = x.contiguous()
    if mesh.backend == "nccl":
        out = x.new_empty((rows,) + x.shape[1:])
        dist.reduce_scatter(out, list(x.split(rows)), group=mesh.group(axis))
        return out
    dist.all_reduce(x, group=mesh.group(axis))
    return x[i * rows:(i + 1) * rows].clone()


def all_gather_cols(y: torch.Tensor, mesh: Mesh, axis: str = "tp") -> torch.Tensor:
    """The ranks' equal-width column blocks (last dimension) concatenated
    in rank order (no gradient)."""
    moved = y.movedim(-1, 0)
    return all_gather_rows(moved, mesh, axis).movedim(0, -1)


class _GatherRows(torch.autograd.Function):
    """All-gather of row blocks whose backward sums each block's gradient
    over the ranks and returns this rank's: for losses that are summed over
    ranks (each rank's loss a share of the global one)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_gather_rows(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_rows(grad.clone(), ctx.mesh, ctx.axis), None, None


class _GatherCols(torch.autograd.Function):
    """All-gather of column blocks whose backward takes this rank's columns
    of the gradient: for a computation that every rank of the axis repeats
    (tensor parallelism), where each holds the whole gradient."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.mesh, ctx.axis, ctx.width = mesh, axis, y.shape[-1]
        return all_gather_cols(y, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        i, w = ctx.mesh.index(ctx.axis), ctx.width
        return grad[..., i * w:(i + 1) * w].contiguous(), None, None


class _ReduceGrad(torch.autograd.Function):
    """Identity whose backward sums the gradient over the ranks of an axis:
    the input of a column-parallel layer, whose ranks each see only their
    columns' share of the input's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.clone(memory_format=torch.contiguous_format), ctx.mesh,
                              ctx.axis), None, None


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """Differentiable :func:`all_gather_rows` (backward: the summed
    gradient of this rank's rows)."""
    if mesh.size(axis) == 1:
        return x
    return _GatherRows.apply(x, mesh, axis)


def sync_grads(params: Sequence[torch.Tensor], mesh: Mesh, axis: str = "dp",
               extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sum the parameters' gradients over ``axis`` in one ``all_reduce``
    (with ``extra``, e.g. this rank's loss share, summed alongside and
    returned). A parameter without a gradient on this rank counts as zero;
    one without a gradient on every rank keeps none, as in the single fit."""
    params = [p for p in params if p.requires_grad]
    if mesh.size(axis) == 1:
        return extra
    dev = params[0].device if params else extra.device
    parts, has = [], []
    for p in params:
        has.append(p.grad is not None)
        parts.append((p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1))
    flags = torch.tensor(has, dtype=torch.float32, device=dev)
    tail = [flags] + ([extra.detach().reshape(1).to(dev, torch.float32)] if extra is not None
                      else [])
    buf = torch.cat([t.to(torch.float32) for t in parts] + tail)
    dist.all_reduce(buf, group=mesh.group(axis))
    off = 0
    for p in params:
        k = p.numel()
        p.grad = buf[off:off + k].view_as(p).to(p.dtype).clone()
        off += k
    flags = buf[off:off + len(params)]
    for p, f in zip(params, flags.tolist()):
        if f == 0:
            p.grad = None
    return buf[-1] if extra is not None else None


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _as_numpy(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    elif hasattr(x, "toarray"):
        x = x.toarray()
    return np.asarray(x, dtype) if dtype is not None else np.asarray(x)


def _np_dtype(dtype):
    if dtype is None or not isinstance(dtype, torch.dtype):
        return dtype
    return torch.empty((), dtype=dtype).numpy().dtype


def _rows_of(x: np.ndarray, size: int, index: int, batch_axis: int = 0) -> np.ndarray:
    """Wrap-pad the axis to a multiple of ``size`` (the last row repeated)
    and take block ``index`` of it."""
    n = x.shape[batch_axis]
    if n % size:
        pad = size - n % size
        tail = np.repeat(np.take(x, [-1], axis=batch_axis), pad, axis=batch_axis)
        x = np.concatenate([x, tail], axis=batch_axis)
    per = x.shape[batch_axis] // size
    return np.take(x, np.arange(index * per, (index + 1) * per), axis=batch_axis)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def to_device(x, dtype: Optional[torch.dtype] = None, *, batch_axis: int = 0,
              pad: bool = True, device=None) -> torch.Tensor:
    """``torch.as_tensor`` on ``device`` that gives this rank its rows inside
    :func:`dp_context` (counterpart: mesh.py:117).

    Outside the context: the whole array on ``device``. Inside: with
    ``pad=True`` the batch axis wrap-padded to a multiple of the ``dp`` size
    and this rank's block of it; with ``pad=False`` (graph node features,
    whose rows must stay in step with an adjacency) an axis that does not
    divide is replicated. Scalars replicate. ``device`` defaults to the
    mesh's, else to the card (:func:`mesh_device`)."""
    mesh = _DP_MESH
    device = mesh_device(mesh, device)
    if mesh is None:
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype) if dtype is not None else x.to(device)
        return _tensor(_as_numpy(x), dtype, device)
    a = _as_numpy(x, _np_dtype(dtype))
    size = mesh.size("dp")
    if a.ndim <= batch_axis or (a.shape[batch_axis] % size and not pad):
        return _tensor(a, dtype, device)
    return _tensor(_rows_of(a, size, mesh.index("dp"), batch_axis), dtype, device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh: Optional[Mesh] = None, axis: str = "dp", device=None):
    """This rank's rows of every array of a batch (a nested tuple, list or
    dict), each wrap-padded to a multiple of the axis size by repeating its
    last row; scalars whole (counterpart: mesh.py:53)."""
    mesh = mesh or current_mesh(device)
    device = mesh_device(mesh, device)
    size, index = mesh.size(axis), mesh.index(axis)

    def put(x):
        a = _as_numpy(x)
        if a.ndim == 0:
            return torch.as_tensor(a).to(device)
        return _tensor(_rows_of(a, size, index), None, device)

    return _tree_map(put, batch)


def replicate(tree, mesh: Optional[Mesh] = None):
    """Every tensor of a nested tuple, list or dict (or every parameter and
    buffer of an ``nn.Module``) overwritten by rank 0's, in place
    (counterpart: mesh.py:72)."""
    mesh = mesh or current_mesh()
    if mesh.world_size == 1:
        return tree
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                dist.broadcast(t.data, src=0)
        return tree

    def put(t):
        if isinstance(t, torch.Tensor):
            dist.broadcast(t, src=0)
        return t

    return _tree_map(put, tree)


# ---------------------------------------------------------------------------
# a data-parallel fit's rows
# ---------------------------------------------------------------------------


class RowShard:
    """A data-parallel fit's view of one row axis of ``n`` rows.

    This rank stores rows ``lo .. lo + rows_per`` (``rows_per = ceil(n /
    dp)``, the layout of :func:`to_device`); ``real`` of them exist (the last
    shards may be short or empty). ``split(rows)`` gives the positions in a
    global batch whose rows this rank stores, and their local indices: each
    rank computes the loss terms of its members of every batch, so the
    batch's rows are split by where they are stored, not by position.
    Outside a data-parallel fit (``RowShard.of(n)`` returns an inactive
    shard) every method is the identity of the single fit."""

    def __init__(self, n: int, mesh: Optional[Mesh] = None):
        self.n, self.mesh = int(n), mesh
        size = mesh.size("dp") if mesh is not None else 1
        index = mesh.index("dp") if mesh is not None else 0
        self.rows_per = -(-self.n // size) if self.n else 0
        self.lo = index * self.rows_per
        self.real = max(0, min(self.rows_per, self.n - self.lo))

    @classmethod
    def of(cls, n: int) -> "RowShard":
        return cls(n, _DP_MESH)

    @property
    def active(self) -> bool:
        return self.mesh is not None

    def rows(self, x, dtype=None, device=None, fill=None) -> torch.Tensor:
        """This rank's ``rows_per`` rows of a host array of ``n`` rows, the
        padding rows wrap-padded (:func:`to_device`'s layout) or, with
        ``fill``, set to it; all rows when inactive."""
        a = _as_numpy(x, _np_dtype(dtype))
        if not self.active:
            return _tensor(a, dtype, device)
        if fill is None:
            return _tensor(_rows_of(a, self.mesh.size("dp"), self.mesh.index("dp")), dtype,
                           device)
        out = np.full((self.rows_per,) + a.shape[1:], fill, dtype=a.dtype)
        out[:self.real] = a[self.lo:self.lo + self.real]
        return _tensor(out, dtype, device)

    def stored(self, device=None) -> Tuple[Optional[torch.Tensor], int]:
        """``(pos, n)``: the global indices of this rank's ``rows_per``
        stored rows (the padding rows repeat the last row's), as
        :func:`~dance_tpu_torch.nn.gnn.flax_dropout` takes them; ``pos`` is
        None when inactive."""
        if not self.active:
            return None, self.n
        pos = torch.arange(self.lo, self.lo + self.rows_per, device=device)
        return pos.clamp_(max=max(self.n - 1, 0)), self.n

    def split(self, rows: torch.Tensor):
        """``(pos, local)`` for a batch of global row indices: the positions
        whose rows this rank stores and their local indices, on ``rows``'
        device. Inactive: ``(None, rows)``."""
        if not self.active:
            return None, rows
        r = rows.cpu()
        pos = torch.nonzero((r >= self.lo) & (r < self.lo + self.rows_per)).reshape(-1)
        return pos.to(rows.device), (r[pos] - self.lo).to(rows.device)

    @staticmethod
    def take(t: torch.Tensor, pos: Optional[torch.Tensor], dim: int = 0) -> torch.Tensor:
        """``t``'s entries at the batch positions ``pos`` (all when None)."""
        return t if pos is None or t is None else t.index_select(dim, pos.to(t.device))

    def share(self, pos: Optional[torch.Tensor], batch: int) -> float:
        """This rank's share of a batch of ``batch`` rows (1 when inactive)."""
        return 1.0 if pos is None else len(pos) / batch

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole axis (n rows) from every rank's stored rows, without
        gradient (``x`` itself when inactive)."""
        if not self.active:
            return x
        return all_gather_rows(x.detach(), self.mesh)[:self.n]

    def gather_grad(self, x: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` with the summed-gradient backward."""
        if not self.active:
            return x
        return gather_rows(x, self.mesh)[:self.n]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ``dp`` ranks (itself when inactive)."""
        return t if not self.active else all_reduce_sum(t.clone(), self.mesh)

    def step(self, loss: Optional[torch.Tensor], params, share: float = 1.0) -> torch.Tensor:
        """Backward of this rank's share of the loss and the gradients
        summed over ``dp``; returns the global loss (detached). ``loss`` is
        this rank's loss on its members of the batch, as the single fit
        would compute it on those rows (None without members); ``share``
        the fraction of the batch they are. Inactive: ``loss.backward()``."""
        if not self.active:
            loss.backward()
            return loss.detach()
        params = list(params)
        if loss is not None:
            loss = loss * share
            loss.backward()
            part = loss.detach()
        else:
            part = torch.zeros((), device=params[0].device)
        return sync_grads(params, self.mesh, extra=part)


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


class ColumnParallelLinear(nn.Module):
    """An ``nn.Linear`` whose output columns are split over the ``tp`` ranks:
    each holds its block of the weight's rows (torch's (out, in) layout),
    computes its block of the outputs and all-gathers the rest; backward,
    each rank takes its columns of the output gradient and the input
    gradient is summed over ``tp``. The bias is replicated and added after
    the gather, as JAX replicates 1-d leaves."""

    def __init__(self, linear: nn.Linear, mesh: Mesh, axis: str = "tp"):
        super().__init__()
        self.mesh, self.axis = mesh, axis
        tp, i = mesh.size(axis), mesh.index(axis)
        self.in_features, self.out_features = linear.in_features, linear.out_features
        k = self.out_features // tp
        self.weight = nn.Parameter(linear.weight.detach()[i * k:(i + 1) * k].clone())
        self.bias = (nn.Parameter(linear.bias.detach().clone())
                     if linear.bias is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _ReduceGrad.apply(x, self.mesh, self.axis)
        y = _GatherCols.apply(nn.functional.linear(x, self.weight), self.mesh, self.axis)
        return y + self.bias if self.bias is not None else y

    def full_weight(self) -> torch.Tensor:
        """The whole (out, in) weight, gathered from the ``tp`` ranks."""
        return all_gather_rows(self.weight.detach(), self.mesh, self.axis)


def shard_params_for_tp(module: nn.Module, mesh: Optional[Mesh] = None, axis: str = "tp",
                        min_size: int = 2048) -> nn.Module:
    """Replace, in place, every ``nn.Linear`` whose output width divides by
    the ``tp`` size and whose weight holds at least ``min_size`` entries by a
    :class:`ColumnParallelLinear`; everything else stays replicated
    (counterpart: mesh.py:79). Returns ``module``."""
    mesh = mesh or current_mesh()
    tp = mesh.size(axis)
    if tp == 1:
        return module
    for name, child in list(module.named_children()):
        if (isinstance(child, nn.Linear) and child.out_features % tp == 0
                and child.weight.numel() >= min_size):
            setattr(module, name, ColumnParallelLinear(child, mesh, axis))
        else:
            shard_params_for_tp(child, mesh, axis, min_size)
    return module


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state dict with every column-parallel weight gathered
    whole, under the ``nn.Linear`` names it replaced."""
    state = module.state_dict()
    for name, sub in module.named_modules():
        if isinstance(sub, ColumnParallelLinear):
            state[f"{name}.weight" if name else "weight"] = sub.full_weight()
    return state


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

BACKENDS = ("nccl", "gloo")


def _check_backend(backend: str, world_size: int, device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    auto = device is None or (isinstance(device, str) and device == "auto")
    cpu = not auto and torch.device(device).type == "cpu"
    if backend == "nccl":
        if cpu:
            raise ValueError("backend='nccl' carries CUDA tensors only; use 'gloo' for "
                             "device='cpu'")
        if not torch.cuda.is_available():
            raise RuntimeError("backend='nccl' needs CUDA cards, but torch.cuda.is_available() "
                               "is False")
        if world_size > torch.cuda.device_count():
            raise RuntimeError(f"backend='nccl' needs one card per rank: {world_size} ranks, "
                               f"{torch.cuda.device_count()} cards")
    elif not cpu and not torch.cuda.is_available():
        raise RuntimeError("the ranks' device defaults to the CUDA card, but "
                           "torch.cuda.is_available() is False; pass device='cpu'")


def _rank_device(local_rank: int, device) -> torch.device:
    if device is None or (isinstance(device, str) and device == "auto"):
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device(device)


def _run_rank(local_rank: int, fn: Callable, world_size: int, backend: str, device,
              init_method: str, timeout: float, num_threads: Optional[int], args: tuple,
              rank: Optional[int] = None):
    """One rank: its device, the process group, ``fn``. ``rank`` is the
    global rank (torchrun's); a spawned rank's is its local one."""
    global _RANK_DEVICE
    if num_threads is not None:
        torch.set_num_threads(num_threads)
    dev = _rank_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = local_rank if rank is None else rank
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    _RANK_DEVICE = dev
    try:
        return fn(rank, *args)
    finally:
        _RANK_DEVICE = None
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, backend: str = "nccl", device="auto", *,
           args: tuple = (), rendezvous_dir: Optional[str] = None, timeout: float = 60.0,
           join_timeout: Optional[float] = None, num_threads: Optional[int] = None):
    """Run ``fn(rank, *args)`` on ``world_size`` ranks of one process group.

    Under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set) this
    process is one rank: it joins through ``env://`` and returns ``fn``'s
    result. Otherwise the ranks are spawned (``torch.multiprocessing``) and
    meet through a ``file://`` store in ``rendezvous_dir`` (a new temporary
    directory when None); ``fn`` must be importable by name. A rank that
    raises makes ``launch`` raise; ranks still running after
    ``join_timeout`` seconds (default ``timeout`` + 120) are killed and
    ``launch`` raises ``TimeoutError``. ``timeout`` bounds every collective.

    The backend is the caller's choice and never switched: ``"nccl"`` needs
    one card per rank and raises without; ``"gloo"`` carries CPU and CUDA
    tensors (several ranks may share one card). A rank's device is
    ``cuda:{local_rank % device_count}`` unless ``device`` names another
    (``"cpu"``): there is no fallback to the CPU."""
    _check_backend(backend, world_size, device)
    if all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        if int(os.environ["WORLD_SIZE"]) != world_size:
            raise ValueError(f"launch({world_size} ranks) under torchrun's WORLD_SIZE="
                             f"{os.environ['WORLD_SIZE']}")
        return _run_rank(int(os.environ["LOCAL_RANK"]), fn, world_size, backend, device,
                         "env://", timeout, num_threads, args, int(os.environ["RANK"]))
    import torch.multiprocessing as mp
    directory = rendezvous_dir or tempfile.mkdtemp(prefix="dtt_rdzv_")
    os.makedirs(directory, exist_ok=True)
    store = os.path.join(directory, f"store_{os.getpid()}_{time.monotonic_ns()}")
    ctx = mp.start_processes(_run_rank, nprocs=world_size, join=False, start_method="spawn",
                             args=(fn, world_size, backend, device, f"file://{store}", timeout,
                                   num_threads, tuple(args)))
    limit = join_timeout if join_timeout is not None else timeout + 120
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"launch: ranks still running after {limit:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
        if os.path.exists(store):
            os.remove(store)
    return None


def is_writer(mesh: Optional[Mesh] = None) -> bool:
    """True on the rank that writes files (global rank 0)."""
    return (mesh.rank if mesh is not None else _world()[0]) == 0


def barrier() -> None:
    """Wait for every rank of the process group (none without one)."""
    if _world()[1] > 1:
        dist.barrier()


__all__ = ["BACKENDS", "ColumnParallelLinear", "Mesh", "RowShard", "active_dp_mesh",
           "all_gather_cols", "all_gather_rows", "all_reduce_sum", "barrier", "current_mesh",
           "dp_active", "dp_context", "full_state_dict", "gather_rows", "get_mesh",
           "is_writer", "launch", "mesh_device", "reduce_scatter_rows", "replicate",
           "shard_batch", "shard_params_for_tp", "sync_grads", "to_device"]
