"""Batched diagram Wasserstein distances (counterpart of the reference's
`ops/wasserstein.py`): persim's cost matrix over padded diagrams, the
ε-annealed Sinkhorn for H1 (log-domain, and the stabilized linear-domain
variant the tiered path uses), and the exact monotone-matching DP for H0.

Two routers: `sinkhorn_cost_pairs` (the log-domain Sinkhorn of padded
diagram pairs) and `wasserstein_h0_exact`.  A CPU tensor takes the plain
version; a CUDA tensor launches the hand-written kernel
(`sinkhorn_log_cuda`, `wasserstein_h0_cuda`) or raises — no fallback."""

from __future__ import annotations

import torch

from .wasserstein_h0_cuda import wasserstein_h0_cuda

W_TIERS = (16, 40, 80)    # bar-count buckets of the tiered Sinkhorn
# the ε ladder of `sinkhorn_cost_stab` (and of the CUDA kernel that repeats
# it): ε from 3e-2 to 1e-4 of the cost scale in 6 rungs, 40 iterations a
# rung in blocks of 8 between absorptions
EPS_HI, EPS_LO, STEPS, ITERS, ABSORB = 3e-2, 1e-4, 6, 40, 8
# pairs a piece of the plain un-tiered Sinkhorn: its cost matrix is
# SINKHORN_CHUNK × S² floats (134 MB at the staged pad width S = 256)
SINKHORN_CHUNK = 512


def build_cost_matrix(b1, d1, m1, b2, d2, m2, big: float = 1e9):
    """persim cost matrix for padded diagrams (B, K1) / (B, K2) →
    (B, K1+K2, K1+K2).  Rows: [side-1 points | side-2 diagonal helpers];
    cols: [side-2 points | side-1 diagonal slots]; pad rows/cols are forced
    onto zero-cost pad↔pad matches, so the valid sub-assignment is persim's."""
    B, K1 = b1.shape
    K2 = b2.shape[1]
    dev = b1.device

    def sentinel(b, d, m):
        # an empty diagram becomes the single [[0, 0]] point (reference
        # safe_wasserstein, scripts/utils.py:186-187)
        empty = ~m.any(dim=1, keepdim=True)
        first = torch.arange(b.shape[1], device=dev)[None, :] == 0
        z = empty & first
        return (torch.where(z, 0.0, b), torch.where(z, 0.0, d), m | z)

    b1, d1, m1 = sentinel(b1, d1, m1)
    b2, d2, m2 = sentinel(b2, d2, m2)

    dul = torch.maximum((b1[:, :, None] - b2[:, None, :]).abs(),
                        (d1[:, :, None] - d2[:, None, :]).abs())
    vv = m1[:, :, None] & m2[:, None, :]
    blocker = torch.where(vv, dul, 0.0).amax(dim=(1, 2))[:, None, None]
    blocker2 = torch.maximum(
        blocker,
        torch.where(m1, 0.5 * (d1 - b1), 0.0).amax(dim=1)[:, None, None])

    eye1 = torch.eye(K1, dtype=torch.bool, device=dev)[None]
    eye2 = torch.eye(K2, dtype=torch.bool, device=dev)[None]
    diag1 = (0.5 * (d1 - b1))[:, :, None]
    diag2 = (0.5 * (d2 - b2))[:, None, :]
    inf_ = torch.tensor(big, dtype=torch.float32, device=dev)

    tl = torch.where(vv, dul, inf_)
    tr = torch.where(eye1, torch.where(m1[:, :, None], diag1, 0.0),
                     torch.where(m1[:, :, None] & m1[:, None, :], blocker, inf_))
    bl = torch.where(eye2, torch.where(m2[:, None, :], diag2, 0.0),
                     torch.where(m2[:, :, None] & m2[:, None, :], blocker2, inf_))
    br = torch.where(m2[:, :, None] & m1[:, None, :], 0.0, inf_)
    top = torch.cat([tl, tr], dim=2)
    bot = torch.cat([bl, br], dim=2)
    return torch.cat([top, bot], dim=1)


def sinkhorn_cost(D, eps_hi: float = 3e-2, eps_lo: float = 1e-4,
                  steps: int = 6, iters: int = 40):
    """ε-annealed entropic OT cost <P, D> on the persim cost matrix, by
    log-domain Sinkhorn with uniform marginals; the duals are warm-started
    across a geometric ε ladder (eps_hi → eps_lo relative to each pair's
    cost scale).  The un-tiered solver of the control's exact redo."""
    real = D < 1e8
    scale = torch.clamp(torch.where(real, D, 0.0).amax(dim=(1, 2)), min=1e-9)
    Dm = torch.where(real, D, 1e3 * scale[:, None, None])
    B, S, _ = D.shape
    f = torch.zeros((B, S, 1), device=D.device)
    g = torch.zeros((B, 1, S), device=D.device)
    for s in range(steps):
        eps_rel = eps_hi * (eps_lo / eps_hi) ** (s / (steps - 1))
        eps = (eps_rel * scale)[:, None, None]
        logK = -Dm / eps
        for _ in range(iters):
            f = -eps * torch.logsumexp(logK + g / eps, dim=2, keepdim=True)
            g = -eps * torch.logsumexp(logK + f / eps, dim=1, keepdim=True)
    eps = (eps_lo * scale)[:, None, None]
    P = torch.exp((-Dm + f + g) / eps)
    return (P * torch.where(real, D, 0.0)).sum(dim=(1, 2))


def sinkhorn_cost_pairs(b1, d1, m1, b2, d2, m2):
    """`sinkhorn_cost(build_cost_matrix(...))` of N padded diagram pairs,
    (N, K1) / (N, K2) per side → (N,).  A CPU tensor takes the plain version
    in SINKHORN_CHUNK-pair pieces; a CUDA tensor launches
    `sinkhorn_log_cuda` (one launch, each pair at its own width, no host
    synchronisation) or raises."""
    if b1.device.type == "cpu":
        chunk = SINKHORN_CHUNK
        outs = [sinkhorn_cost(build_cost_matrix(
            *(x[c:c + chunk] for x in (b1, d1, m1, b2, d2, m2))))
            for c in range(0, b1.shape[0], chunk)]
        return torch.cat(outs) if outs else b1.new_zeros(0)
    from .sinkhorn_log_cuda import sinkhorn_log_cuda   # it imports this module

    return sinkhorn_log_cuda(*(x.contiguous() for x in (b1, d1, m1, b2, d2, m2)))


def sinkhorn_cost_stab(D, eps_hi: float = EPS_HI, eps_lo: float = EPS_LO,
                       steps: int = STEPS, iters: int = ITERS, absorb: int = ABSORB):
    """ε-annealed entropic OT cost <P, D> on the persim cost matrix.

    Between dual absorptions the iterations run in the linear domain on the
    stabilized kernel K̃ = exp((−D + f + g)/ε) (one exp pass per `absorb`
    iterations); the ε ladder runs eps_hi → eps_lo relative to each pair's
    cost scale, warm-starting the duals.  Runs in D's dtype (float32 on the
    main path; float64 gives the ladder's value without float32 rounding)."""
    B, S, _ = D.shape
    dev = D.device
    real = D < 1e8
    scale = torch.clamp(torch.where(real, D, 0.0).amax(dim=(1, 2)), min=1e-9)
    Dm = torch.where(real, D, 1e3 * scale[:, None, None])
    f = torch.zeros((B, S, 1), dtype=D.dtype, device=dev)
    g = torch.zeros((B, 1, S), dtype=D.dtype, device=dev)
    tiny = 1e-38
    blocks = [absorb] * (iters // absorb) + \
        ([iters % absorb] if iters % absorb else [])
    for s in range(steps):
        eps_rel = eps_hi * (eps_lo / eps_hi) ** (s / (steps - 1))
        eps = (eps_rel * scale)[:, None, None]
        for blk in blocks:
            Kt = torch.exp((f + g - Dm) / eps)
            u = torch.ones((B, S), dtype=D.dtype, device=dev)
            v = torch.ones((B, S), dtype=D.dtype, device=dev)
            for _ in range(blk):
                u = 1.0 / torch.clamp(torch.bmm(Kt, v[:, :, None])[:, :, 0], min=tiny)
                v = 1.0 / torch.clamp(torch.bmm(u[:, None, :], Kt)[:, 0, :], min=tiny)
            f = f + eps * torch.log(u)[:, :, None]
            g = g + eps * torch.log(v)[:, None, :]
    eps = (eps_lo * scale)[:, None, None]
    P = torch.exp((f + g - Dm) / eps)
    return (P * torch.where(real, D, 0.0)).sum(dim=(1, 2))


BIGF = 3e38


def wasserstein_h0_exact(d1, m1, d2, m2):
    """Exact persim Wasserstein between H0 diagrams: deaths d (B, K) and
    masks m per side → (B,).  A CPU tensor takes the plain loop
    (`wasserstein_h0_exact_plain`); a CUDA tensor launches
    `wasserstein_h0_cuda` (one launch) or raises."""
    if d1.device.type == "cpu":
        return wasserstein_h0_exact_plain(d1, m1, d2, m2)
    return wasserstein_h0_cuda(d1, m1, d2, m2)


def wasserstein_h0_exact_plain(d1, m1, d2, m2):
    """Exact persim Wasserstein between H0 diagrams (all births 0).

    On ascending deaths the pair cost |a_i − b_j| is a Monge array, so the
    alignment DP dp[i][j] = min(dp[i-1][j-1] + |a_i − b_j|, dp[i-1][j] +
    a_i/2, dp[i][j-1] + b_j/2) is exact; its in-row term is a min-plus
    prefix scan: dp_row = cumw + cummin(c − cumw).  Pad slots are (0, 0)
    bars and cost nothing.  d1: (B, K1), m1 mask; likewise side 2 → (B,)."""
    a = torch.sort(torch.where(m1, d1, 0.0), dim=1).values
    b = torch.sort(torch.where(m2, d2, 0.0), dim=1).values
    B, K1 = a.shape
    K2 = b.shape[1]
    dev = a.device
    bcol = torch.cat([torch.zeros((B, 1), device=dev), b], dim=1)   # (B, K2+1)
    cumw = torch.cumsum(bcol / 2.0, dim=1)
    row = cumw
    j0 = torch.arange(K2 + 1, device=dev)[None, :] == 0
    for i in range(K1):
        ai = a[:, i]
        term2 = row + ai[:, None] / 2.0
        prev_shift = torch.cat([torch.full((B, 1), BIGF, device=dev), row[:, :-1]], 1)
        term1 = prev_shift + (ai[:, None] - bcol).abs()
        c = torch.minimum(torch.where(j0, BIGF, term1), term2)
        c = torch.where(j0, term2, c)
        row = cumw + torch.cummin(c - cumw, dim=1).values
    return row[:, K2]
