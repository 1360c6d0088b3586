"""Data parallelism across processes with ``torch.distributed``, the port of
the JAX package's ``parallel/distributed.py``.

One process per card, as ``torchrun`` launches them: NCCL between cards,
gloo on the CPU, or the backend the caller names; nothing falls back to
another backend or device. The JAX package's data mesh sees one global
batch inside one program and XLA inserts every cross-device reduction; here
each process holds its rows of the global batch, and the reductions that
make the result the global batch's are explicit:

* BatchNorm's training statistics (``models/layers.py``) and the loss
  normaliser (``train/loss.py``) go through ``all_reduce_sum``, whose
  backward all-reduces the gradient, so the gradient is that of one
  global loss;
* the parameter gradients are summed (``all_reduce_grads``), not averaged;
* validation and detection rows are gathered to every process
  (``all_gather_rows``), so every process returns the same results.

The reductions run over the whole world unless the caller names a
``group``: under a (data, model) mesh (``parallel/mesh.py``) the global
batch's sums go over the data group, and the parameters are rebuilt from
the model group's shards (``all_gather_shards``).

Without an initialized group every helper here is the identity and makes
no call into ``torch.distributed``. ``COLLECTIVES`` counts the collective
calls made through this module by kind and by the group they ran over
(``"world"``, or the label given to ``new_group``); ``collective_counts``
sums it by either.
"""

from __future__ import annotations

import collections
import datetime
import os

import torch
import torch.distributed as dist

from ..utils.runtime import resolve_device

# collective calls by (kind, group label)
COLLECTIVES: collections.Counter = collections.Counter()
_GROUP_LABELS: dict = {}
# elements of one flat gradient bucket (64 MiB of float32)
GRAD_BUCKET_NUMEL = 1 << 24
TIMEOUT = datetime.timedelta(minutes=10)


def _local_rank(process_id: int) -> int:
    """The card of this process: torchrun's ``LOCAL_RANK``, else the process
    id modulo the cards this host shows."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count()
    return process_id % n if n else 0


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None) -> torch.device:
    """Join the process group and return this process's device.

    From the JAX package's flags (``coordinator`` as ``host:port`` or a
    ``tcp://`` address, ``num_processes``, ``process_id``), else from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``). A no-op, returning the device, when a
    group is already initialized or when neither is given (one process).
    The device is ``cuda:LOCAL_RANK`` unless ``device`` names another
    (``"cpu"``); without CUDA and without ``device="cpu"`` it raises. The
    backend is ``backend``, else NCCL for a CUDA device and gloo for the
    CPU."""
    flags = (coordinator, num_processes, process_id)
    if dist.is_initialized():
        return resolve_device(device, _local_rank(dist.get_rank()))
    if any(v is not None for v in flags):
        if any(v is None for v in flags):
            raise SystemExit("--coordinator, --num-processes and "
                             "--process-id go together")
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        rank, world = int(process_id), int(num_processes)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return resolve_device(device)
    dev = resolve_device(device, _local_rank(rank))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init, world_size=world, rank=rank, timeout=TIMEOUT)
    return dev


def active() -> bool:
    """Whether a process group is initialized."""
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Process 0, which alone writes files and prints reports."""
    return rank() == 0


def _count(kind: str, group) -> None:
    label = "world" if group is None else _GROUP_LABELS.get(group, "other")
    COLLECTIVES[kind, label] += 1


def collective_counts(by: str = "kind") -> collections.Counter:
    """``COLLECTIVES`` summed by ``"kind"`` (all_reduce, all_gather,
    barrier) or by ``"group"``."""
    pos = ("kind", "group").index(by)
    out = collections.Counter()
    for key, n in COLLECTIVES.items():
        out[key[pos]] += n
    return out


def new_group(ranks: list, label: str):
    """``torch.distributed.new_group`` of ``ranks``, which every process
    must call for every group, in the same order, members or not; the
    group's collectives are counted under ``label``."""
    group = dist.new_group(ranks, timeout=TIMEOUT)
    if rank() in ranks:
        _GROUP_LABELS[group] = label
    return group


def barrier() -> None:
    if dist.is_initialized():
        _count("barrier", None)
        dist.barrier()


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _on_backend(x: torch.Tensor) -> torch.Tensor:
    """``x`` where the group's backend takes it: NCCL only reduces tensors
    on this process's card."""
    if dist.get_backend() == "nccl" and x.device.type != "cuda":
        return x.to(torch.device("cuda", torch.cuda.current_device()))
    return x


def all_reduce_sum_(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``x`` over the processes of ``group`` (the world by
    default; no autograd)."""
    if dist.is_initialized():
        _count("all_reduce", group)
        y = _on_backend(x)
        dist.all_reduce(y, group=group)
        if y is not x:
            x.copy_(y)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes whose backward sums the gradient over them:
    each process's loss depends on every process's input through the
    sum, so the gradient of the global loss with respect to this
    process's input is the sum of the processes' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the processes of ``group`` (the
    world by default); ``x`` itself without a process group."""
    return _AllReduceSum.apply(x, group) if dist.is_initialized() else x


def buckets(tensors: list) -> list:
    """``tensors`` split in order into runs of about ``GRAD_BUCKET_NUMEL``
    elements."""
    out, cur, n = [], [], 0
    for t in tensors:
        cur.append(t)
        n += t.numel()
        if n >= GRAD_BUCKET_NUMEL:
            out.append(cur)
            cur, n = [], 0
    if cur:
        out.append(cur)
    return out


def all_reduce_grads(params, group=None) -> None:
    """Sum every parameter's gradient over the processes of ``group`` (the
    world by default) in flat buckets of about ``GRAD_BUCKET_NUMEL``
    elements (a missing gradient counts as zeros, so every process sends
    the same layout)."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for grads in buckets([p.grad for p in params]):
        flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]),
                               group)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


def all_gather_shards(shard: torch.Tensor, dim: int, group
                      ) -> torch.Tensor:
    """The full tensor whose pieces along ``dim`` the processes of
    ``group`` hold, in their order in the group (a list ``all_gather``,
    which gloo and NCCL both have); ``shard`` itself without a process
    group."""
    if not dist.is_initialized():
        return shard
    y = _on_backend(shard.contiguous())
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    _count("all_gather", group)
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim).to(shard.device)


def all_gather_rows(x: torch.Tensor, counts: list | None = None,
                    group=None) -> torch.Tensor:
    """Every process's rows of ``x`` (first dimension, the rest of the shape
    the same everywhere) concatenated in process order over ``group`` (the
    world by default); each process's rows are padded to the largest count
    for the gather and cut back. ``counts``, every process's row count
    where each process knows them, saves the gather of the counts (and its
    wait for the device)."""
    if not dist.is_initialized():
        return x
    n = dist.get_world_size(group)
    y = _on_backend(x)
    if counts is None:
        count = torch.tensor([len(y)], dtype=torch.int64, device=y.device)
        every = [torch.empty_like(count) for _ in range(n)]
        _count("all_gather", group)
        dist.all_gather(every, count, group=group)
        counts = [int(c) for c in every]
    top = max(max(counts), 1)   # gloo refuses an empty tensor
    pad = y.new_zeros((top,) + tuple(y.shape[1:]))
    pad[:len(y)] = y
    parts = [torch.empty_like(pad) for _ in range(n)]
    _count("all_gather", group)
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(x.device)


def tensor_checksums(tensors) -> torch.Tensor:
    """[len(tensors), 2] int64 checksums of the tensors' bytes: their sum,
    and the sum of each byte times its position."""
    out = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8).long()
        pos = torch.arange(1, len(b) + 1, device=b.device)
        out.append(torch.stack([b.sum(), (b * pos).sum()]))
    return torch.stack(out)


def check_same_across_ranks(named: dict) -> None:
    """Raise if any tensor of ``named`` differs in a bit between the
    processes (one gather of their checksums)."""
    if not dist.is_initialized():
        return
    names = list(named)
    sums = tensor_checksums([named[k] for k in names])
    every = all_gather_rows(sums[None])
    for r in range(1, len(every)):
        bad = (every[r] != every[0]).any(dim=1).nonzero()
        if len(bad):
            raise RuntimeError(
                f"the state differs between process 0 and process {r}: "
                f"{names[int(bad[0])]} (and {len(bad) - 1} more)")
