"""H0 persistence by a Prim sweep, and the reference's pre-ripser distance
cleanup (counterpart of the reference package's `ops/homology.py`).

For a Rips filtration the finite H0 deaths are the minimum-spanning-tree
edge weights; components whose merge weight exceeds the threshold never
die.  `h0_diagram` runs Prim's sweep, n − 1 steps of a min/argmin over the
frontier, vectorised over the batch.  Plain PyTorch on whatever device the
tensor is on: the JAX package computes it in XLA, and there is no kernel.
Diagrams are padded (death, valid); zero-persistence merges are dropped as
ripser drops them.
"""

from __future__ import annotations

import torch

_BIG = 3.4e38


def h0_diagram(dm: torch.Tensor, valid: torch.Tensor | None = None,
               thresh: float = 2.0) -> dict:
    """Batched H0 persistence via Prim's MST.

    dm: (..., N, N) symmetric distances (padding rows may hold anything);
    valid: (..., N) bool mask of real points (None → all valid).  The tree
    grows from the first valid vertex; ties go to the lowest index (argmin's
    first minimum).

    Returns dict with
      deaths: (..., N−1) MST merge weights in the order Prim adds them,
              +inf where not a real finite bar;
      dmask:  (..., N−1) True where the death is a real finite bar (a merge
              of valid points, weight ≤ thresh, weight > 0);
      n_essential: (...,) int32, components alive at thresh (merges above
              thresh, plus one for the root's component);
      n_zero: (...,) int32, zero-persistence merges (dropped)."""
    n = dm.shape[-1]
    lead = dm.shape[:-2]
    dev = dm.device
    if valid is None:
        valid = torch.ones(dm.shape[:-1], dtype=torch.bool, device=dev)
    d = dm.reshape(-1, n, n)
    v = valid.reshape(-1, n).to(torch.bool)
    M = d.shape[0]
    big = torch.tensor(_BIG, dtype=d.dtype, device=dev)
    # a NaN distance is no edge (ripser's and the phase-1 sort's reading:
    # NaN <= thresh is false), like an edge to a padding point
    d = torch.where(v[:, :, None] & v[:, None, :] & ~torch.isnan(d), d, big)
    iota = torch.arange(n, device=dev)
    # root = first valid vertex (vertex 0 when none is)
    root = torch.where(v, iota, n).amin(dim=1).remainder(n)
    rows = torch.arange(M, device=dev)
    in_tree = iota[None, :] == root[:, None]
    dist = torch.where(in_tree | ~v, big, d[rows, root])
    deaths = torch.empty((M, max(n - 1, 0)), dtype=d.dtype, device=dev)
    for k in range(n - 1):
        # a tree vertex above every frontier one, so that a frontier with no
        # edge left (all at `big`) still yields a new vertex
        cand = torch.where(in_tree, torch.inf, dist)
        nxt = cand.argmin(dim=1)
        deaths[:, k] = cand[rows, nxt]
        in_tree = in_tree | (iota[None, :] == nxt[:, None])
        dist = torch.minimum(dist, d[rows, nxt])
    n_valid = v.sum(dim=1)
    merge_ok = iota[None, : n - 1] < (n_valid - 1)[:, None]      # real merges only
    finite = merge_ok & (deaths <= thresh)
    n_zero = (finite & (deaths == 0.0)).sum(dim=1)
    dmask = finite & (deaths > 0.0)
    n_essential = 1 + (merge_ok & (deaths > thresh)).sum(dim=1)
    deaths = torch.where(dmask, deaths, torch.inf)
    return {"deaths": deaths.reshape(*lead, n - 1),
            "dmask": dmask.reshape(*lead, n - 1),
            "n_essential": n_essential.to(torch.int32).reshape(lead),
            "n_zero": n_zero.to(torch.int32).reshape(lead)}


def symmetrize_dm(dm: torch.Tensor) -> torch.Tensor:
    """The reference's pre-ripser cleanup (scripts/utils.py:135-139):
    symmetrize, zero diagonal, clamp ≥ 0."""
    d = 0.5 * (dm + dm.transpose(-1, -2))
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    return torch.where(eye, 0.0, d.clamp(min=0.0))
