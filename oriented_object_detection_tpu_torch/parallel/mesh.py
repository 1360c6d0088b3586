"""The (data, model) mesh of the processes, the port of the JAX package's
``parallel/mesh.py``.

The JAX package lays its devices out as ``devices.reshape(n_data,
n_model)``: the batch is sharded over ``data``, so the devices of one
``model`` row see the same rows, and ``shard_model`` splits every
parameter leaf whose trailing dimension divides ``n_model`` over
``model`` (the rest replicate). Params, EMA and SGD momentum then take
1/n_model of their memory on each device (ZeRO-3-style weight sharding);
BatchNorm statistics, step and schedule replicate. With ``n_model == 1``
it is plain data parallelism.

Here one process is one device. Process ``r`` sits at data index ``r //
n_model`` and model index ``r % n_model`` (``make_mesh``), and joins two
groups: the **data group**, the processes with its model index, over
which the global batch's sums run (BatchNorm's moments, the loss
normaliser, the gradient, the metrics), and the **model group**, the
processes with its data index, from whose shards each parameter is
rebuilt before the forward (``Layout.gather``). A train state is laid out
by ``shard_train_state`` (``train/trainer.py`` keeps the parts), and the
reductions follow the mesh that ``train_step`` makes active (``using``):
without one they run over the whole world (data parallelism alone).

Besides, the data axis's arithmetic: which rows of a batch or items of a
list each process takes.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..models.weights import torch_axis
from . import distributed as PD


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in an ``n_data`` x ``n_model`` mesh and its two
    groups. A group is ``None`` where it is the whole world or where this
    process is alone in it (size 1: no collective runs)."""
    n_data: int = 1
    n_model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: object = None
    model_group: object = None


def mesh_coords(rank: int, n_model: int) -> tuple:
    """(data index, model index) of process ``rank``: JAX's
    ``reshape(n_data, n_model)`` of the devices in rank order."""
    return divmod(rank, n_model)


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh of every process of the group: ``n_data``
    defaults to the processes over ``n_model``, and ``n_data * n_model``
    must be the number of processes. Every process makes every group of
    more than one process, members or not, in the same order (data groups
    by model index, then model groups by data index); with ``n_model ==
    1`` the data group is the world's and none is made. Without a process
    group, the 1 x 1 mesh, with no ``torch.distributed`` call."""
    world, rank = PD.world(), PD.rank()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} processes, not {world}")
    d, m = mesh_coords(rank, n_model)
    data_group = model_group = None
    if n_model > 1:
        if n_data > 1:
            for j in range(n_model):
                g = PD.new_group([i * n_model + j for i in range(n_data)],
                                 "data")
                data_group = g if j == m else data_group
        for i in range(n_data):
            g = PD.new_group([i * n_model + j for j in range(n_model)],
                             "model")
            model_group = g if i == d else model_group
    return Mesh(n_data, n_model, d, m, data_group, model_group)


# the mesh of the running train step (``using``); None: the whole world
_ACTIVE: Mesh | None = None


@contextlib.contextmanager
def using(mesh: Mesh | None):
    """Make ``mesh`` the one the global-batch reductions run over inside
    the block (the JAX package's ``with mesh:``); ``None`` changes
    nothing."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, mesh if mesh is not None else _ACTIVE
    try:
        yield
    finally:
        _ACTIVE = before


def data_size() -> int:
    """The processes over which the global batch is split: the active
    mesh's ``n_data``, else the world."""
    return PD.world() if _ACTIVE is None else _ACTIVE.n_data


def _data_alone() -> bool:
    return _ACTIVE is not None and _ACTIVE.n_data == 1


def data_sum_(x: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``x`` over the data axis (``PD.all_reduce_sum_``):
    the active mesh's data group, else the world."""
    if _data_alone():
        return x
    return PD.all_reduce_sum_(x, None if _ACTIVE is None
                              else _ACTIVE.data_group)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``data_sum_`` whose backward sums the gradient over the data axis
    (``PD.all_reduce_sum``)."""
    if _data_alone():
        return x
    return PD.all_reduce_sum(x, None if _ACTIVE is None
                             else _ACTIVE.data_group)


def data_sum_grads(params) -> None:
    """Sum the parameters' gradients over the data axis
    (``PD.all_reduce_grads``)."""
    if PD.active() and not _data_alone():
        PD.all_reduce_grads(params, None if _ACTIVE is None
                            else _ACTIVE.data_group)


# ---------------------------------------------------------------------------
# The model axis: which piece of each parameter this process owns
# ---------------------------------------------------------------------------

def shard_spec(name: str, shape, n_model: int) -> int | None:
    """The dimension of the port's tensor ``name`` that JAX's
    ``shard_model`` splits over ``n_model`` processes, or ``None`` to
    replicate it: the dimension holding the flax leaf's trailing one (a
    conv kernel's output channels, dim 0 of the port's OIHW through the
    converter's transpose ``weights.KERNEL_AXES``; dim 0 of a bias or a
    BatchNorm scale), where its size divides ``n_model``. The 1-channel
    angle-head bias, and at ``n_model = 2`` any odd channel count,
    replicate."""
    if n_model == 1 or len(shape) == 0:
        return None
    dim = torch_axis(name, len(shape), -1)
    return dim if shape[dim] % n_model == 0 else None


class Layout:
    """The model-axis layout of a list of parameter-shaped tensors
    (``names``, ``shapes``) on this process of ``mesh``: each tensor's
    shard dimension (``shard_spec``) or ``None``, and the indices of the
    split tensors (``split``; none at ``n_model == 1``)."""

    def __init__(self, names: list, shapes: list, mesh: Mesh):
        self.mesh = mesh
        self.dims = [shard_spec(n, s, mesh.n_model)
                     for n, s in zip(names, shapes)]
        self.split = [i for i, d in enumerate(self.dims) if d is not None]

    def part(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This process's part of full tensor ``i``: a contiguous copy of
        its shard, or ``full`` itself where it is replicated."""
        if self.dims[i] is None:
            return full
        return self.shard_of(full.detach(), i).clone(
            memory_format=torch.contiguous_format)

    def take(self, tensors: list) -> list:
        """``part`` of each full tensor."""
        return [self.part(t, i) for i, t in enumerate(tensors)]

    def shard_of(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This process's shard of tensor ``i`` as a view of ``full``."""
        d = self.dims[i]
        return full if d is None else full.chunk(self.mesh.n_model,
                                                 d)[self.mesh.model_index]

    def gather(self, parts: list, out: list | None = None) -> list:
        """The full tensors from every model-group process's ``parts``
        (this process's, as ``take`` gives them): the shards go in flat
        buckets of ``PD.GRAD_BUCKET_NUMEL`` elements through one
        ``all_gather_shards`` each and are put together in model-index
        order, into ``out``'s tensors where given; replicated parts are
        copied or passed through."""
        n = self.mesh.n_model
        out = list(out) if out is not None else [None] * len(parts)
        ids = iter(self.split)
        for bucket in PD.buckets([parts[i] for i in self.split]):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            every = PD.all_gather_shards(flat, 0, self.mesh.model_group
                                         ).view(n, -1)
            off = 0
            for t, i in zip(bucket, ids):   # bucket first: ids stays put
                pieces = every[:, off:off + t.numel()].unbind(0)
                full = torch.cat([p.view(t.shape) for p in pieces],
                                 self.dims[i])
                out[i] = full if out[i] is None else out[i].copy_(full)
                off += t.numel()
        for i, d in enumerate(self.dims):
            if d is None:
                out[i] = parts[i] if out[i] is None or out[i] is parts[i] \
                    else out[i].copy_(parts[i])
        return out


def shard_model(tree, mesh: Mesh) -> dict:
    """This process's part of a parameter tree laid out over ``mesh``'s
    model axis (JAX's ``shard_model``, of which each device holds its
    slice): {name: shard} of an ``nn.Module``'s parameters or of a {name:
    tensor} dict, each divisible leaf split along its ``shard_spec``
    dimension, the rest whole."""
    named = dict(tree.named_parameters() if isinstance(tree, torch.nn.Module)
                 else tree)
    layout = Layout(list(named), [t.shape for t in named.values()], mesh)
    return dict(zip(named, layout.take(list(named.values()))))


def shard_train_state(state, mesh: Mesh):
    """Lay out a ``train/trainer.py`` TrainState for (data, model)
    training (JAX's ``shard_train_state``): params, EMA and SGD momentum
    weight-sharded over ``model`` (this process keeps its parts, ``Layout
    .take``; the optimizer is rebuilt over the master parts in the same
    groups), the BatchNorm statistics, step and schedule replicated; its
    steps reduce over ``mesh``'s data group. With ``n_model == 1`` every
    leaf stays whole: data parallelism alone. Every process of the mesh
    calls it on the same state."""
    state.sync()
    ema = state.ema_tensors()
    momentum = state.momentum_tensors() if state.opt.state else None
    named = list(state.model.named_parameters())
    index = {m: i for i, m in enumerate(state.master)}
    old = state.opt
    state.mesh = mesh
    state.layout = Layout([n for n, _ in named], [p.shape for _, p in named],
                          mesh)
    state.master = state.layout.take([p for _, p in named])
    state.ema_shards = state.layout.take(ema)
    state.opt = torch.optim.SGD(
        [{**{k: v for k, v in g.items() if k != "params"},
          "params": [state.master[index[p]] for p in g["params"]]}
         for g in old.param_groups], **old.defaults)
    state.set_momentum(momentum)
    return state


# ---------------------------------------------------------------------------
# The data axis's arithmetic
# ---------------------------------------------------------------------------

def rank_range(n: int, rank: int, world: int) -> tuple:
    """This process's contiguous share ``(start, stop)`` of ``n`` items: the
    first ``n % world`` processes take one item more."""
    per, extra = divmod(n, world)
    start = rank * per + min(rank, extra)
    return start, start + per + (rank < extra)


def batch_rows(batch_size: int, rank: int, world: int) -> tuple:
    """This process's rows ``(start, stop)`` of a global batch, which must
    split evenly over the processes (the JAX package's rule for its
    ``--batch-size``); under a mesh, ``rank`` and ``world`` are the data
    index and ``n_data``."""
    if batch_size % world:
        raise SystemExit(f"--batch-size {batch_size} must divide by the "
                         f"{world} processes")
    rows = batch_size // world
    return rank * rows, (rank + 1) * rows

