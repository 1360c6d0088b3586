"""The data-axis arithmetic of data parallelism, the port of what the JAX
package's ``parallel/mesh.py`` does for its ``data`` axis: which rows of a
batch or items of a list each process takes. Parameters are replicated on
every process; the model axis (weight sharding) is not ported."""

from __future__ import annotations


def rank_range(n: int, rank: int, world: int) -> tuple:
    """This process's contiguous share ``(start, stop)`` of ``n`` items: the
    first ``n % world`` processes take one item more."""
    per, extra = divmod(n, world)
    start = rank * per + min(rank, extra)
    return start, start + per + (rank < extra)


def batch_rows(batch_size: int, rank: int, world: int) -> tuple:
    """This process's rows ``(start, stop)`` of a global batch, which must
    split evenly over the processes (the JAX package's rule for its
    ``--batch-size``)."""
    if batch_size % world:
        raise SystemExit(f"--batch-size {batch_size} must divide by the "
                         f"{world} processes")
    rows = batch_size // world
    return rank * rows, (rank + 1) * rows


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def best_data_axis_size(batch_size: int, n_devices: int) -> int:
    """Largest device count <= n_devices that divides the batch size."""
    for d in range(min(n_devices, batch_size), 0, -1):
        if batch_size % d == 0:
            return d
    return 1
