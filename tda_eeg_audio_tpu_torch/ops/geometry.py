"""Geometry ops: batched Pearson correlation → metric distance matrices, and
padded Euclidean point-cloud distances (counterpart of the reference's
`ops/geometry.py`; same semantics, torch tensors).

`window_distances` is the router of the EEG window → correlation-distance
step: a CPU tensor takes the plain chain (`window_distances_plain`), a CUDA
tensor the hand-written kernel (`ops/window_distance_cuda.py`), which raises
for what it cannot take — there is no fallback."""

from __future__ import annotations

import torch

from .signal import sliding_windows
from .window_distance_cuda import window_distances_cuda


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


def window_distances_plain(banded: torch.Tensor, use_idx: torch.Tensor, method: str,
                           win: int, step: int) -> torch.Tensor:
    """The plain chain of `window_distances`: every window up to the last
    one used (`sliding_windows`, NaN at or past T), the (B, bands, K)
    selected ones gathered, `correlation_matrix`, `correlation_to_distance`."""
    B, C, NB, _ = banded.shape
    K = use_idx.shape[-1]
    if B * NB * K == 0:
        return banded.new_zeros((B, NB, K, C, C))
    wins = sliding_windows(banded, int(use_idx.max()) + 1, win, step)   # (B, C, NB, W, win)
    wins = wins.permute(0, 2, 3, 1, 4)                                  # (B, NB, W, C, win)
    sel = wins.gather(2, use_idx[:, :, :, None, None].expand(-1, -1, -1, C, win))
    return correlation_to_distance(correlation_matrix(sel), method)


def window_distances(banded: torch.Tensor, use_idx: torch.Tensor, method: str,
                     win: int, step: int) -> torch.Tensor:
    """Correlation distances of the selected windows of a banded signal:
    banded (B, C, bands, T), use_idx (B, bands, K) int64; window k of
    (b, band) is samples [use_idx · step, + win) of banded[b, :, band],
    NaN at or past T → (B, bands, K, C, C).  A CPU tensor takes the plain
    chain; a CUDA tensor launches the kernel (one launch, the windows read
    in place through banded's strides) or raises."""
    if banded.device.type == "cpu":
        return window_distances_plain(banded, use_idx, method, win, step)
    return window_distances_cuda(banded, use_idx, method, win, step)
