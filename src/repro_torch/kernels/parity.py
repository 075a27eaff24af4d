"""Agreement checks between a kernel and its plain PyTorch version.

On the card the two sum f32 dot products in different orders, so scores
agree to a tolerance (about 1e-5 for unit vectors), not bitwise, and a
ranking may swap two entries whose scores lie within that tolerance.  The
rule used by the GPU tests and ``chip_smoke.py``:

  * values: -inf where the other is -inf, otherwise within ``tol``;
  * ids: -1 wherever the score is -inf; equal rank by rank wherever the
    score gap to both neighbouring ranks exceeds ``tol``; within a run of
    ranks closer than ``tol`` the ids agree as a set — except the run that
    reaches the last rank, whose members may be cut differently by the k
    boundary.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.cache_ops import to_numpy

__all__ = ["max_abs_err", "assert_topk_agree", "assert_close"]


def max_abs_err(a, b) -> float:
    """Largest |a - b| over the entries finite in both (0.0 if none)."""
    a, b = to_numpy(a).astype(np.float64), to_numpy(b).astype(np.float64)
    fin = np.isfinite(a) & np.isfinite(b)
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def assert_close(a, b, tol: float, what: str) -> float:
    """Same non-finite pattern, finite entries within ``tol``."""
    a_, b_ = to_numpy(a), to_numpy(b)
    if a_.shape != b_.shape:
        raise AssertionError(f"{what}: shapes {a_.shape} != {b_.shape}")
    if not np.array_equal(np.isneginf(a_), np.isneginf(b_)) or \
            not np.array_equal(np.isnan(a_), np.isnan(b_)):
        raise AssertionError(f"{what}: non-finite entries differ")
    err = max_abs_err(a_, b_)
    if err > tol:
        raise AssertionError(f"{what}: max |diff| {err:.3g} > {tol:.3g}")
    return err


def assert_topk_agree(vals, ids, ref_vals, ref_ids, tol: float,
                      what: str) -> float:
    """The rule of the module docstring for (rows, k) answers; returns the
    largest score difference."""
    err = assert_close(vals, ref_vals, tol, f"{what} scores")
    v, i, ri = to_numpy(ref_vals), to_numpy(ids), to_numpy(ref_ids)
    with np.errstate(invalid="ignore"):       # -inf - -inf in dead runs
        _check_ranks(v, i, ri, tol, what)
    return err


def _check_ranks(v, i, ri, tol, what):
    dead = np.isneginf(v)
    if not (np.all(i[dead] == -1) and np.all(ri[dead] == -1)):
        raise AssertionError(f"{what}: a -inf result carries a real id")
    rows, k = v.shape
    if rows == 0 or k == 0:
        return
    # each rank's run: a run goes on while the gap to the rank before is
    # within tol, or both are -inf
    joined = (v[:, :-1] - v[:, 1:] <= tol) | (dead[:, :-1] & dead[:, 1:])
    run = np.zeros((rows, k), dtype=np.int64)
    run[:, 1:] = np.cumsum(~joined, axis=1)
    # the run reaching rank k is free when it holds more than one rank
    last = run == run[:, -1:]
    free = last & (last.sum(axis=1) > 1)[:, None]
    # runs compared as sets: ids sorted within each run
    lo = min(int(i.min()), int(ri.min()))
    span = max(int(i.max()), int(ri.max())) - lo + 1
    mine = np.where(free, -1, run * span + (i.astype(np.int64) - lo))
    want = np.where(free, -1, run * span + (ri.astype(np.int64) - lo))
    bad = np.flatnonzero(np.any(np.sort(mine, axis=1)
                                != np.sort(want, axis=1), axis=1))
    if bad.size:
        _row_ranks(v[bad[0]], i[bad[0]], ri[bad[0]], tol, f"{what}: row "
                   f"{bad[0]}")
        raise AssertionError(f"{what}: row {bad[0]} ranks differ")


def _row_ranks(row, i, ri, tol, what):
    """One row's runs in order, raising at the first that differs."""
    k = row.shape[0]
    start = 0
    while start < k:
        end = start + 1
        while end < k and (row[end - 1] - row[end] <= tol
                           or (np.isneginf(row[end - 1])
                               and np.isneginf(row[end]))):
            end += 1
        a, b = i[start:end], ri[start:end]
        if end == start + 1:
            ok = a[0] == b[0]
        elif end == k:
            ok = True           # a tied run cut by the k boundary
        else:
            ok = sorted(a.tolist()) == sorted(b.tolist())
        if not ok:
            raise AssertionError(
                f"{what} ranks {start}:{end} ids {a.tolist()} "
                f"!= {b.tolist()}")
        start = end
