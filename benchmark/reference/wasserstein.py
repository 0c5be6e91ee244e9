"""Diagram Wasserstein distances of the reference, plain PyTorch in the
caller's dtype (frozen copies of the study's arithmetic):

* the persim cost matrix of two diagrams: L-infinity between bars, each
  bar's own diagonal at (death - birth) / 2, the other diagonal slots
  blocked at the largest cost, an empty diagram as the one bar (0, 0)
  (the reference's `safe_wasserstein`, scripts/utils.py:180-191);
* H0 (every birth 0): the exact matching, an alignment DP over the sorted
  deaths;
* H1: the entropic cost the configuration states, an eps ladder from 3e-2
  to 1e-4 of each pair's largest cost in 6 rungs of 40 iterations with
  uniform marginals, by the log-domain Sinkhorn.  The linear-domain form
  with absorbed duals iterates the same updates and agrees with it to
  ~1e-13 in float64, so this one solver stands for every route a program
  may take to the same cost.
Imports nothing of the program.
"""

from __future__ import annotations

import torch

EPS_HI, EPS_LO, STEPS, ITERS = 3e-2, 1e-4, 6, 40
BIG = 1e9


def cost_matrix(b1, d1, m1, b2, d2, m2):
    """(B, K1) / (B, K2) padded diagrams → (B, K1 + K2, K1 + K2) persim
    costs; pad rows and columns meet each other at cost 0 and everything
    else at BIG, so the valid sub-assignment is persim's."""
    B, K1 = b1.shape
    K2 = b2.shape[1]
    dev = b1.device

    def sentinel(b, d, m):
        z = ~m.any(dim=1, keepdim=True) & (torch.arange(b.shape[1], device=dev) == 0)
        return torch.where(z, 0.0, b), torch.where(z, 0.0, d), m | z

    b1, d1, m1 = sentinel(b1, d1, m1)
    b2, d2, m2 = sentinel(b2, d2, m2)
    dul = torch.maximum((b1[:, :, None] - b2[:, None, :]).abs(),
                        (d1[:, :, None] - d2[:, None, :]).abs())
    vv = m1[:, :, None] & m2[:, None, :]
    blocker = torch.where(vv, dul, 0.0).amax(dim=(1, 2))[:, None, None]
    blocker2 = torch.maximum(
        blocker, torch.where(m1, 0.5 * (d1 - b1), 0.0).amax(dim=1)[:, None, None])
    eye1 = torch.eye(K1, dtype=torch.bool, device=dev)[None]
    eye2 = torch.eye(K2, dtype=torch.bool, device=dev)[None]
    big = torch.tensor(BIG, dtype=b1.dtype, device=dev)
    tl = torch.where(vv, dul, big)
    tr = torch.where(eye1, torch.where(m1[:, :, None], (0.5 * (d1 - b1))[:, :, None], 0.0),
                     torch.where(m1[:, :, None] & m1[:, None, :], blocker, big))
    bl = torch.where(eye2, torch.where(m2[:, None, :], (0.5 * (d2 - b2))[:, None, :], 0.0),
                     torch.where(m2[:, :, None] & m2[:, None, :], blocker2, big))
    br = torch.where(m2[:, :, None] & m1[:, None, :], 0.0, big)
    return torch.cat([torch.cat([tl, tr], dim=2), torch.cat([bl, br], dim=2)], dim=1)


def _scaled(D):
    real = D < 1e8
    scale = torch.where(real, D, 0.0).amax(dim=(1, 2)).clamp(min=1e-9)
    return real, scale, torch.where(real, D, 1e3 * scale[:, None, None])


def _eps(s, scale):
    rel = EPS_HI * (EPS_LO / EPS_HI) ** (s / (STEPS - 1))
    return (rel * scale)[:, None, None]


def sinkhorn_log(D):
    """<P, D> by the log-domain Sinkhorn."""
    B, S, _ = D.shape
    real, scale, Dm = _scaled(D)
    f = D.new_zeros((B, S, 1))
    g = D.new_zeros((B, 1, S))
    for s in range(STEPS):
        eps = _eps(s, scale)
        logK = -Dm / eps
        for _ in range(ITERS):
            f = -eps * torch.logsumexp(logK + g / eps, dim=2, keepdim=True)
            g = -eps * torch.logsumexp(logK + f / eps, dim=1, keepdim=True)
    P = torch.exp((-Dm + f + g) / _eps(STEPS - 1, scale))
    return (P * torch.where(real, D, 0.0)).sum(dim=(1, 2))


def h1_pairs(solver, pairs, dtype, device, chunk: int = 256):
    """Entropic cost of each (bars1, bars2) pair, bars (k, 2) tensors of
    finite H1 bars, each pair at its own width max(k1, k2, 1)."""
    out = torch.empty(len(pairs), dtype=dtype, device=device)
    order = sorted(range(len(pairs)), key=lambda i: max(len(pairs[i][0]), len(pairs[i][1])))
    for c in range(0, len(order), chunk):
        ids = order[c:c + chunk]
        K = max(1, *(max(len(pairs[i][0]), len(pairs[i][1])) for i in ids))
        b1, d1, b2, d2 = (torch.zeros((len(ids), K), dtype=dtype, device=device)
                          for _ in range(4))
        m1, m2 = (torch.zeros((len(ids), K), dtype=torch.bool, device=device)
                  for _ in range(2))
        for r, i in enumerate(ids):
            for bars, b, d, m in ((pairs[i][0], b1, d1, m1), (pairs[i][1], b2, d2, m2)):
                k = len(bars)
                b[r, :k], d[r, :k], m[r, :k] = bars[:, 0], bars[:, 1], True
        out[ids] = solver(cost_matrix(b1, d1, m1, b2, d2, m2))
    return out


def h0_pairs(pairs, dtype, device):
    """Exact persim Wasserstein of each (a, b) pair of H0 diagrams given by
    their finite deaths (1-D tensors; births 0), in one batch: on sorted
    deaths the costs form a Monge array, so the alignment DP is exact.  An
    empty side is the one bar (0, 0).  The DP runs row by row over a's
    deaths; a pair's shorter a leaves its row unchanged, and its answer is
    read at its own b's last column (later columns do not reach it)."""
    def sides(k):
        v = [torch.sort(p[k]).values if len(p[k]) else p[k].new_zeros(1) for p in pairs]
        pad = torch.zeros((len(v), max(len(x) for x in v)), dtype=dtype, device=device)
        ok = torch.zeros(pad.shape, dtype=torch.bool, device=device)
        for r, x in enumerate(v):
            pad[r, :len(x)], ok[r, :len(x)] = x, True
        return pad, ok

    a, a_ok = sides(0)
    b, b_ok = sides(1)
    bcol = torch.cat([b.new_zeros((len(b), 1)), b], dim=1)
    cumw = torch.cumsum(bcol / 2.0, dim=1)
    inf = b.new_full((len(b), 1), torch.inf)
    row = cumw
    for k in range(a.shape[1]):
        ai = a[:, k:k + 1]
        term1 = torch.cat([inf, row[:, :-1] + (ai - bcol[:, 1:]).abs()], dim=1)
        c = torch.minimum(term1, row + ai / 2.0)
        row = torch.where(a_ok[:, k:k + 1], cumw + torch.cummin(c - cumw, dim=1).values, row)
    return row.gather(1, b_ok.sum(dim=1, keepdim=True)).squeeze(1)
