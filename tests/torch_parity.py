"""Row comparison shared by the port's parity tests."""

import numpy as np


def match_one_to_one(got, ref, skip_near=()):
    """Pair every [N, 11] row of ``got`` with one of ``ref``: same class,
    conf within 1e-3, corners within 0.05 px, Strike angle within 0.01
    degree. Rows whose conf lies within 1e-3 of a threshold in
    ``skip_near`` are left out on both sides: the consensus filter may
    keep or drop them on a last-bit difference."""
    def keep(rows):
        near = np.zeros(len(rows), bool)
        for t in skip_near:
            near |= np.abs(rows[:, 9] - t) < 1e-3
        return rows[~near]

    got, ref = keep(got), keep(ref)
    assert got.shape == ref.shape
    used = np.zeros(len(ref), bool)
    for r in got:
        ok = (~used & (ref[:, 8] == r[8]) & (np.abs(ref[:, 9] - r[9]) <= 1e-3)
              & (np.abs(ref[:, :8] - r[:8]).max(1) <= 0.05))
        assert ok.any(), f"no JAX partner for {r.tolist()}"
        used[np.flatnonzero(ok)[0]] = True
    np.testing.assert_allclose(got[:, 10], ref[:, 10], atol=1e-2)
