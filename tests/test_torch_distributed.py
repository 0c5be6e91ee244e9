"""Multi-process runs of the port on the CPU: `runtime.init_distributed` /
`process_shard`, the two steps of `parallel/sharding.py` in a real 2-rank
gloo group (spawned processes on a free localhost port, each with a hard
timeout), and the command line's `features` as two processes whose
partials, merged, equal the one-process run.

Tolerances: the sharded steps equal their one-process runs bit for bit (the
same arithmetic on the same rows); the statistics equal the JAX package's
`wilcoxon` + `bh_fdr` on the whole array within test_torch_stats.py's
tolerances (rtol 1e-5 / atol 1e-7: the port counts the exact null in
float64, the reference in float32); the one-process features step equals the
JAX package's `sharded_feature_step` on a one-device mesh within
test_torch_slice.py's features tolerance (rtol 1e-4 / atol 1e-5: float32 FFT
and matmul rounding)."""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tda_eeg_audio_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from tda_eeg_audio_tpu.ops import stats as jstats
from tda_eeg_audio_tpu.parallel import sharding as jsharding
from tda_eeg_audio_tpu_torch import cli, runtime
from tda_eeg_audio_tpu_torch.convert import config_from_jax
from tda_eeg_audio_tpu_torch.parallel.sharding import (sharded_feature_step,
                                                       sharded_stats_step)
from torch_distributed_worker import N_WIN_MAX, feature_batch, stats_deltas
from torch_tiny_data import write_mat_recordings

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_distributed_worker.py"
TIMEOUT = 240
PADS = ["--t-eeg-pad", "600", "--t-audio-pad", "97020", "--n-rs-max", "560"]
CPU = ["--device", "cpu", "--backend", "host", "--batch", "3"] + PADS


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    # the ranks meet at 127.0.0.1; gloo takes its own device from the host
    # name unless told otherwise, so it is pinned to the loopback interface
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    return env


def _run_ranks(cmds):
    """Start every command at once; (rc, stdout, stderr) each, all ended."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_single_process_is_a_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    info = runtime.init_distributed(None, None, None)
    assert info == dict(process_id=0, num_processes=1, local_devices=1, devices=1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert runtime.init_distributed()["num_processes"] == 1
    assert not torch.distributed.is_initialized()
    assert runtime.process_shard(100) == (0, 100)
    assert runtime.process_shard(0) == (0, 0)
    with pytest.raises(ValueError):         # several processes need a coordinator
        runtime.init_distributed(None, 2, 0)
    assert not torch.distributed.is_initialized()


def test_spawned_ranks_pin_gloo_to_loopback():
    """The ranks meet at 127.0.0.1; gloo binds the interface that
    GLOO_SOCKET_IFNAME names, and without it the one the host name resolves
    to.  This file's ranks and chip_smoke.py's phase-11 ranks both pin it."""
    import chip_smoke

    assert _env()["GLOO_SOCKET_IFNAME"] == "lo"
    assert chip_smoke.rank_env()["GLOO_SOCKET_IFNAME"] == "lo"


def test_process_shard_partition_properties(monkeypatch):
    """Balanced (ceil(n / p) each), gap-free and in rank order (the
    reference's BATCH_START/BATCH_END contract, tda_eeg_classification_v2.py
    :54-60), for the runtime's own function at every rank."""
    for n in (0, 1, 7, 45, 1416):
        for world in (1, 2, 3, 8):
            spans = []
            for rank in range(world):
                monkeypatch.setattr(runtime, "process_rank_world",
                                    lambda group=None, r=rank, w=world: (r, w))
                spans.append(runtime.process_shard(n))
            cover = np.concatenate([np.arange(a, b) for a, b in spans])
            np.testing.assert_array_equal(cover, np.arange(n))
            assert max(b - a for a, b in spans) == min(n, -(-n // world))


@pytest.fixture(scope="module")
def two_ranks():
    port = _free_port()
    outs = _run_ranks([[sys.executable, str(WORKER), f"127.0.0.1:{port}", "2",
                        str(r)] for r in range(2)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs]


def test_two_ranks_join_and_shard(two_ranks):
    assert [r["info"] for r in two_ranks] == [
        dict(process_id=i, num_processes=2, local_devices=1, devices=2) for i in (0, 1)]
    assert [r["shard"] for r in two_ranks] == [[0, 5], [5, 10]]
    assert [r["rows"] for r in two_ranks] == [[0, 9], [9, 18]]


def test_sharded_stats_equal_on_both_ranks_and_to_jax(two_ranks):
    d = stats_deltas()
    one = sharded_stats_step(device="cpu")(d).numpy()
    for r in two_ranks:
        np.testing.assert_array_equal(np.asarray(r["stats"], np.float32), one)
    _, p = jstats.wilcoxon(jnp.asarray(d.T), jnp.ones(d.T.shape, bool))
    _, p_adj = jstats.bh_fdr(np.asarray(p)[None], 0.05)
    want = np.stack([np.asarray(p), np.asarray(p_adj)[0]], -1)
    np.testing.assert_allclose(one, want, rtol=1e-5, atol=1e-7)
    assert one[0, 0] > 0.05 and one[4, 1] < 0.05   # no effect / a clear one


def test_sharded_feature_step_world_two_equals_world_one(two_ranks):
    cfg, eeg, n, use_idx, use_mask = feature_batch()
    one = sharded_feature_step(cfg, N_WIN_MAX, device="cpu")(eeg, n, use_idx, use_mask)
    assert one.shape == (2, 5, 2, 11, 2) and bool(torch.isfinite(one).all())
    for r in two_ranks:
        np.testing.assert_array_equal(np.asarray(r["feats"], np.float32), one.numpy())


def test_sharded_feature_step_matches_jax():
    """The port's step in one process against the JAX package's on a
    one-device mesh, on the same seeded inputs and configuration: the
    windows each recording uses (use_idx, the window mask) and their mean /
    std aggregation are the reference's."""
    cfg, eeg, n, use_idx, use_mask = feature_batch()
    jcfg = dataclasses.replace(JAX_CONFIG, window_sec=0.2, fir_numtaps=101)
    assert config_from_jax(dataclasses.asdict(jcfg)) == cfg
    mesh = jsharding.make_mesh(1)
    want = np.asarray(jsharding.sharded_feature_step(mesh, jcfg, N_WIN_MAX)(
        *jsharding.shard_batch(mesh, eeg, n.astype(np.int32),
                               use_idx.astype(np.int32), use_mask)))
    got = sharded_feature_step(cfg, N_WIN_MAX, device="cpu")(
        eeg, n, use_idx, use_mask).numpy()
    assert got.shape == want.shape == (2, 5, 2, 11, 2)
    ratio = np.abs(got - want) / (1e-5 + 1e-4 * np.abs(want))
    worst = tuple(int(i) for i in np.unravel_index(np.argmax(ratio), ratio.shape))
    print(f"sharded features vs JAX: max abs err {np.abs(got - want).max():.3e}; "
          f"worst error / tolerance {ratio[worst]:.3f} at {worst}: port "
          f"{got[worst]:.7g}, JAX {want[worst]:.7g}")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cli_features_as_two_processes_equal_one(tmp_path):
    data = write_mat_recordings(tmp_path / "data")
    port = _free_port()
    common = ["features", "--data", str(data), *CPU]
    outs = _run_ranks([[sys.executable, "-m", "tda_eeg_audio_tpu_torch.cli", *common,
                        "--results", str(tmp_path / "part"), "--coordinator",
                        f"127.0.0.1:{port}", "--num-processes", "2",
                        "--process-id", str(r)] for r in range(2)])
    for r, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        lo, hi = (0, 4) if r == 0 else (4, 8)
        assert f"process shard: recordings [{lo}, {hi})" in out
    assert sorted(p.name for p in (tmp_path / "part" / "partials").iterdir()) == [
        "batch_0_4.npz", "batch_4_8.npz"]
    assert cli.main(["features", "--results", str(tmp_path / "part"),
                     "--merge-partials"]) == 0
    assert cli.main([*common, "--results", str(tmp_path / "one")]) == 0
    for f in ("X.npy", "y.npy", "subjects.npy"):
        a = np.load(tmp_path / "part" / f, allow_pickle=True)
        b = np.load(tmp_path / "one" / f, allow_pickle=True)
        assert a.shape[0] == 8
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tmp_path / "part" / "filenames.txt").read_text() == \
        (tmp_path / "one" / "filenames.txt").read_text()
