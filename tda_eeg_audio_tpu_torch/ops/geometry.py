"""Geometry ops: batched Pearson correlation → metric distance matrices, and
padded Euclidean point-cloud distances (counterpart of the reference's
`ops/geometry.py`; same semantics, torch tensors)."""

from __future__ import annotations

import torch


def correlation_matrix(windows: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over channels.  windows: (..., C, T) → (..., C, C).

    np.corrcoef semantics with the reference's NaN→0 handling: any
    correlation involving a zero-variance channel is 0, its diagonal too.
    """
    x = windows - windows.mean(dim=-1, keepdim=True)
    norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    zero_var = (windows.amax(dim=-1) == windows.amin(dim=-1)) | (norm[..., 0] == 0.0)
    z = x / torch.where(norm == 0.0, torch.ones_like(norm), norm)
    r = torch.matmul(z, z.transpose(-1, -2))
    bad = zero_var[..., :, None] | zero_var[..., None, :]
    return torch.where(bad, torch.zeros_like(r), r)


def correlation_to_distance(r: torch.Tensor, method: str = "euclidean") -> torch.Tensor:
    """Correlation → distance; default d = sqrt(2(1−r)), zero diagonal."""
    r = r.clamp(-1.0, 1.0)
    if method == "euclidean":
        d = torch.sqrt(torch.clamp(2.0 * (1.0 - r), min=0.0))
    elif method == "abs":
        d = 1.0 - r.abs()
    elif method == "standard":
        d = 1.0 - r
    elif method == "sqrt":
        d = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    else:
        raise ValueError(f"Unknown method: {method}")
    d = torch.clamp(d, min=0.0)
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    return torch.where(eye, torch.zeros_like(d), d)


def pairwise_distances(points: torch.Tensor, mask: torch.Tensor,
                       pad_value: float) -> torch.Tensor:
    """Euclidean distances for padded clouds (..., N, D) with mask (..., N);
    entries touching an invalid point are `pad_value`, the diagonal 0."""
    sq = (points * points).sum(dim=-1)
    g = torch.matmul(points, points.transpose(-1, -2))
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * g
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    d = torch.where(eye, torch.zeros_like(d), d)
    ok = mask[..., :, None] & mask[..., None, :]
    return torch.where(ok | eye, d, torch.full_like(d, pad_value))
