"""Exact linear assignment on the device for any K (the port of the JAX
``ops/lap.py``).

The K! permutation product of ``ops/matching.py`` is the fastest exact
matcher up to K=8; past that this module solves the assignment by the
Jonker-Volgenant shortest augmenting path (the algorithm of scipy's
``linear_sum_assignment``, which the reference calls per sample on the
host, ``losses.py:43``), batched over the leading axis in plain PyTorch
on the cost's device, with no host sync.

It mirrors JAX's ``_lap_single`` step for step, in float32: the Dijkstra
relaxation order, ``argmin`` ties to the lowest column, the dual updates
of the scanned rows and columns only, and the backward augmentation. So
it picks the same columns as JAX on tied costs, not merely the same
optimum. JAX's data-dependent ``while_loop``s become fixed trip counts
with masks: when row r is added, r columns are assigned, so its Dijkstra
scans at most r + 1 columns and its augmenting path has at most r + 1
steps, K(K + 1) masked steps in all; a step is a no-op for a sample that
has reached its sink (or the row it augments from).
"""

from __future__ import annotations

import torch

_INF = 1e30  # JAX's float32 sentinel for scanned columns


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for (B, K) x and (B,) idx."""
    return x.gather(1, idx[:, None]).squeeze(1)


def solve_lap_min(cost: torch.Tensor) -> torch.Tensor:
    """Batched exact minimum-cost assignment.

    Args: cost (B, K, K). Returns (B, K) int64, the column of each row.
    """
    cost = cost.to(torch.float32)
    b, k, _ = cost.shape
    dev = cost.device
    cols = torch.arange(k, device=dev)[None, :]
    u = torch.zeros((b, k), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    col4row = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    row4col = torch.full_like(col4row, -1)
    inf = torch.full((b, k), _INF, dtype=torch.float32, device=dev)
    for cur in range(k):
        # Dijkstra from row `cur` over the columns
        sp = inf
        path = torch.full_like(col4row, -1)
        sc = torch.zeros((b, k), dtype=torch.bool, device=dev)
        sr = torch.zeros_like(sc)
        sink = torch.full((b,), -1, dtype=torch.int64, device=dev)
        i = torch.full_like(sink, cur)
        min_val = torch.zeros((b,), dtype=torch.float32, device=dev)
        for _ in range(cur + 1):
            live = (sink < 0)[:, None]
            row_i = cols == i[:, None]
            sr = sr | (live & row_i)
            cost_i = cost.gather(1, i[:, None, None].expand(b, 1, k)).squeeze(1)
            r = min_val[:, None] + cost_i - _take(u, i)[:, None] - v
            better = live & ~sc & (r < sp)
            sp = torch.where(better, r, sp)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(sc, inf, sp)
            j = torch.argmin(masked, dim=1)
            min_val = torch.where(live[:, 0], _take(masked, j), min_val)
            sc = sc | (live & (cols == j[:, None]))
            owner = _take(row4col, j)
            sink = torch.where(live[:, 0] & (owner < 0), j, sink)
            i = torch.where(live[:, 0] & (owner >= 0), owner, i)

        # dual updates of the scanned rows and columns
        mv = min_val[:, None]
        u = torch.where(cols == cur, u + mv, u)
        sp_assigned = torch.where(col4row >= 0, sp.gather(1, col4row.clamp(min=0)),
                                  torch.zeros_like(sp))
        u = torch.where(sr & (cols != cur), u + (mv - sp_assigned), u)
        v = torch.where(sc, v - (mv - sp), v)

        # augment backwards from the sink to row `cur`
        j = sink
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        for _ in range(cur + 1):
            live = ~done
            jc = j.clamp(min=0)
            i = _take(path, jc).clamp(min=0)
            row4col = torch.where(live[:, None] & (cols == jc[:, None]), i[:, None], row4col)
            j_next = _take(col4row, i)
            col4row = torch.where(live[:, None] & (cols == i[:, None]), jc[:, None], col4row)
            done = done | (live & (i == cur))
            j = torch.where(live, j_next, j)
    return col4row


def solve_lap_max(cost: torch.Tensor) -> torch.Tensor:
    """Batched exact maximum-affinity assignment (scipy's
    ``linear_sum_assignment(-cost)`` as used at ``losses.py:43``)."""
    return solve_lap_min(-cost)
