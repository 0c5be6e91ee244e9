"""Worker of tests/test_torch_distributed.py: one rank of a `torch.distributed`
gloo group on the CPU, through the port's `runtime.init_distributed`.

Run: python tests/torch_distributed_worker.py <coordinator> <world> <rank>
Prints one JSON line: the runtime's info, process_shard(10), the sharded
statistics step over this rank's rows of `stats_deltas()`, and the
window-split features step on `feature_batch()`.
"""
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the smoke's phase 11 runs the same statistics step on the same deltas
from chip_smoke import stats_deltas  # noqa: E402

N_WIN_MAX = 4


def feature_batch():
    """(cfg, eeg (2, 47, T), n (2,), use_idx (2, 5, 3), use_mask) at 0.2 s
    windows, 101 taps, N_WIN_MAX windows, from a seed."""
    import dataclasses

    from tda_eeg_audio_tpu_torch.config import DEFAULT_CONFIG

    cfg = dataclasses.replace(DEFAULT_CONFIG, window_sec=0.2, fir_numtaps=101)
    T = cfg.win_samples + (N_WIN_MAX - 1) * cfg.step_samples
    rng = np.random.default_rng(3)
    eeg = rng.standard_normal((2, 47, T)).astype(np.float32)
    n = np.array([T, T - cfg.step_samples])
    use_idx = np.stack([rng.choice(N_WIN_MAX, 3, replace=False)
                        for _ in range(10)]).reshape(2, 5, 3)
    use_mask = np.ones((2, 5, 3), bool)
    use_mask[1, :, 2] = False
    return cfg, eeg, n, use_idx, use_mask


def main():
    import torch

    torch.set_num_threads(1)
    from tda_eeg_audio_tpu_torch import runtime
    from tda_eeg_audio_tpu_torch.parallel.sharding import (sharded_feature_step,
                                                           sharded_stats_step)

    coordinator, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    info = runtime.init_distributed(coordinator, world, rank)
    d = stats_deltas()
    lo, hi = runtime.process_shard(len(d))
    stats = sharded_stats_step(device="cpu")(d[lo:hi])
    cfg, eeg, n, use_idx, use_mask = feature_batch()
    feats = sharded_feature_step(cfg, N_WIN_MAX, device="cpu")(eeg, n, use_idx, use_mask)
    print(json.dumps(dict(info=info, shard=list(runtime.process_shard(10)),
                          rows=[lo, hi], stats=stats.tolist(),
                          feats=feats.tolist())), flush=True)


if __name__ == "__main__":
    main()
