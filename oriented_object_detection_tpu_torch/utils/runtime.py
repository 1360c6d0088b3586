"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None, local_rank: int | None = None
                   ) -> torch.device:
    """``None`` means the CUDA card (``cuda:local_rank`` for one process of
    a data-parallel group); the CPU only when the caller asks for it.
    Raises rather than falling back when CUDA is absent."""
    if device is None or (local_rank is not None and device == "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", local_rank) if local_rank is not None \
            else torch.device("cuda")
    return torch.device(device)
