"""Multi-process steps over a `torch.distributed` group (counterpart of the
reference package's `parallel/sharding.py`).

The reference's only parallelism is process-level data parallelism over
recordings with filesystem-mediated partials (SURVEY §2.3; reference
scripts/tda_eeg_classification_v2.py:54-60,569-576,608-668).  The port's
production multi-process path is the same: one process per card, each
taking `runtime.process_shard` of the recordings and writing a partial
(`cli features --num-processes …`, then `--merge-partials`).

Two steps run across the group:
  * `sharded_stats_step`: the statistics stage's reduction — every rank's
    subject deltas gathered in rank order, then Wilcoxon and BH-FDR
    computed redundantly on every rank (the rank test is global over ≤ 45
    deltas: one gather of a (S, 5) array beats any reduction choreography);
  * `sharded_feature_step`: the window-axis ("wp") split of the features
    stage — each rank reduces a contiguous slice of every recording's
    windows, the feature rows are gathered back, and the window sample is
    applied after the gather, so the result does not depend on the split.
    As in the JAX package, this is a design demo for hypothetical long
    recordings, not a production path: no entry point calls it, and at the
    study's ≤ 23 s recordings it only adds a gather where splitting the
    recordings needs none.

The collectives run over gloo (`runtime.init_distributed`): their payloads
are kilobytes, so each is copied to the host and back; the compute stays on
each rank's device.  Outside a process group both steps run on one process
unchanged.

In one process, the runner has a data-parallel mesh of its own
(`StudyRunner(mesh=...)`, the CLI's `--mesh`): each batch of the fused
features and comparison programs is split into contiguous slices, one a
device, the outputs gathered on the first.

Not ported: the JAX package's `make_mesh` and `shard_batch`, which place
arrays on a GSPMD device mesh for XLA to partition — PyTorch has no
counterpart; the runner splits its batches itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..runtime import process_rank_world, resolve_device


def _all_gather_rows(x: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's x (rows may differ in number, the other axes may not),
    in rank order, on x's device; through the host for gloo."""
    _, world = process_rank_world(group)
    if world == 1:
        return [x]
    host = x.detach().cpu().contiguous()
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(sizes, torch.tensor([host.shape[0]]), group=group)
    rows = max(int(s) for s in sizes)
    padded = torch.zeros((rows, *host.shape[1:]), dtype=host.dtype)
    padded[:host.shape[0]] = host
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    return [p[:int(s)].to(x.device) for p, s in zip(parts, sizes)]


def sharded_stats_step(group=None, device=None):
    """Returns fn(w_h1_delta (S_local, 5)) → (5, 2) [p, p_adj]: every rank's
    subject deltas gathered in rank order, then the per-band two-sided
    Wilcoxon and BH-FDR (α = 0.05) across bands, the same on every rank."""
    from ..ops.stats import bh_fdr, wilcoxon

    dev = resolve_device(device)

    def step(w_h1_delta):
        local = torch.as_tensor(w_h1_delta, device=dev)
        full = torch.cat(_all_gather_rows(local, group))     # (S, bands)
        d = full.T
        _, p = wilcoxon(d, torch.ones_like(d, dtype=torch.bool))
        _, p_adj = bh_fdr(p[None, :], 0.05)
        return torch.stack([p, p_adj[0]], dim=-1)

    return step


def sharded_feature_step(cfg: PipelineConfig = DEFAULT_CONFIG,
                         n_win_max: int = 24, group=None, device=None):
    """Window-axis split of the features stage across the group's ranks.

    Returns fn(eeg (B, 47, T), n_samples (B,), use_idx (B, 5, K),
    use_mask (B, 5, K)) → per-recording feature rows (B, 5, 2, 11, 2), the
    same on every rank.  Every rank filters and windows the whole batch,
    reduces windows [r·w, (r+1)·w) of every recording and band (w =
    n_win_max / world) through the port's H1 router, gathers the window
    features back, and only then applies the K-window sample use_idx
    (reference tda_eeg_classification_v2.py:394-400), so the sample does not
    depend on the split."""
    from ..models.programs import eeg_distance_program, window_tda_features
    from ..ops.features import aggregate_mean_std

    dev = resolve_device(device)
    rank, world = process_rank_world(group)
    if n_win_max % world:
        raise ValueError(f"n_win_max={n_win_max} must divide by the "
                         f"{world} processes")
    w_local = n_win_max // world

    def step(eeg, n_samples, use_idx, use_mask):
        dist_, _, wmask = eeg_distance_program(eeg, n_samples, cfg, n_win_max,
                                               device=dev)
        B, nb, W, n, _ = dist_.shape
        local = dist_[:, :, rank * w_local:(rank + 1) * w_local]
        f, _ = window_tda_features(local.reshape(-1, n, n),
                                   thresh=cfg.max_edge_length)
        f = f.reshape(B, nb, w_local, 22)
        # window axis back from the ranks, in rank order
        parts = _all_gather_rows(f.movedim(2, 0).contiguous(), group)
        f_all = torch.cat(parts).movedim(0, 2)               # (B, nb, W, 22)
        use_idx = torch.as_tensor(use_idx, device=dev).long()
        use_mask = torch.as_tensor(use_mask, device=dev, dtype=torch.bool)
        sel = f_all.gather(2, use_idx[..., None].expand(-1, -1, -1, 22))
        wsel = wmask[:, None, :].expand(B, nb, W).gather(2, use_idx)
        agg = aggregate_mean_std(sel, use_mask & wsel)       # (B, nb, 22, 2)
        return agg.reshape(B, nb, 2, 11, 2)

    return step
