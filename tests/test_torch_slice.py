"""The port's study slice end to end against the JAX reference (CPU): one
tiny batch through eeg_feature_program, audio_h1_program (mismatch audio)
and comparison_program, fed the same numpy arrays on both sides.

Tolerances: the features aggregate and the comparison outputs rtol 1e-4 /
atol 1e-5 (float32 FFT, matmul and Sinkhorn rounding); tau, n_pair,
a_degen, overflow, masks and window indices exact.  Takens distances and
the per-bar H1 arrays carry atol 1e-3 besides: sqrt(|p|² + |q|² − 2p·q)
cancels for near-coincident points, so the ~1e-7 envelope differences of
the two FFTs move a distance near 0 by up to ~7e-4 (distances above 0.05
hold rtol 1e-4 / atol 1e-5)."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tda_eeg_audio_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from tda_eeg_audio_tpu.models import programs as jprog
from tda_eeg_audio_tpu.models.classify import window_sample_indices as j_wsi
from tda_eeg_audio_tpu.io.synthetic import synth_recording as j_synth
from tda_eeg_audio_tpu_torch.convert import batch_from_numpy, config_from_jax
from tda_eeg_audio_tpu_torch.io.synthetic import (synth_recording as t_synth,
                                                  window_sample_indices as t_wsi)
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.runtime import timed_spans

# One intra-op thread: MKL picks its sgemm split by machine load, which moves
# the correlation matmul's float32 rounding by ~1e-7, and at near-tied edge
# weights that toggles a zero-persistence bar and jumps the features.  One
# thread fixes the summation order, so the comparison is deterministic.
torch.set_num_threads(1)

B, N_WIN_MAX, N_RS_MAX, K = 2, 12, 300, 5
EXACT = ("tau", "n_pair", "a_degen", "overflow")


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    """The tiny batch of tests/test_fused_comparison.py (0.2 s windows,
    101 taps), plus a seeded features-stage window sample."""
    jcfg = dataclasses.replace(JAX_CONFIG, window_sec=0.2, fir_numtaps=101)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    win, step = jcfg.win_samples, jcfg.step_samples
    n_e = np.array([win + 7 * step, win + 8 * step], np.int32)
    T = win + (N_WIN_MAX - 1) * step
    rng = np.random.default_rng(0)
    eeg = np.zeros((B, 47, T), np.float32)
    for i, n in enumerate(n_e):
        eeg[i, :, :n] = rng.standard_normal((47, n))
    n_a = (n_e * jcfg.fs_audio // jcfg.fs_eeg).astype(np.int32)
    audio = np.zeros((B, int(n_a.max())), np.float32)
    for i, n in enumerate(n_a):
        audio[i, :n] = rng.standard_normal(n)
    use_idx = np.zeros((B, 5, K), np.int32)
    use_mask = np.zeros((B, 5, K), bool)
    for b in range(B):
        nw = (n_e[b] - win) // step + 1
        for bd in range(5):
            use_idx[b, bd] = rng.choice(nw, K, replace=False)
            use_mask[b, bd] = True
    use_mask[1, 2, 4] = False
    return dict(jcfg=jcfg, tcfg=tcfg, eeg=eeg, n_e=n_e, audio=audio, n_a=n_a,
                mis=audio[::-1].copy(), n_mis=n_a[::-1].copy(),
                use_idx=use_idx, use_mask=use_mask)


def test_feature_program_matches_jax(tiny):
    j_agg, j_diag, j_ovf = jprog.eeg_feature_program(
        jnp.asarray(tiny["eeg"]), jnp.asarray(tiny["n_e"]),
        jnp.asarray(tiny["use_idx"]), jnp.asarray(tiny["use_mask"]),
        tiny["jcfg"], N_WIN_MAX, K, chunk=64, return_dm0=True)
    t_agg, t_diag, t_ovf = tprog.eeg_feature_program(
        tiny["eeg"], tiny["n_e"], tiny["use_idx"], tiny["use_mask"],
        tiny["tcfg"], K=K, return_dm0=True, device="cpu")
    assert t_agg.shape == (B, 5, 2, 11, 2)
    _close(t_agg, j_agg, "agg")
    _close(t_ovf, j_ovf, "ovf")
    _close(t_diag, np.asarray(j_diag), "dm0 diagnostics")
    packed = tprog.pack_feature_outputs(t_agg, t_diag, t_ovf).numpy()
    np.testing.assert_allclose(
        packed, np.asarray(jprog.pack_feature_outputs(j_agg, j_diag, j_ovf)),
        rtol=1e-4, atol=1e-5)
    agg2, diag2, ovf2 = tprog.unpack_feature_outputs(packed, B)
    np.testing.assert_array_equal(agg2, t_agg.numpy())
    np.testing.assert_array_equal(ovf2, t_ovf.numpy())


def test_audio_takens_program_matches_jax(tiny):
    cap = np.array([7, 9], np.int32)
    j = jprog.audio_takens_program(jnp.asarray(tiny["audio"]), jnp.asarray(tiny["n_a"]),
                                   tiny["jcfg"], N_RS_MAX, N_WIN_MAX, K,
                                   n_win_cap=jnp.asarray(cap))
    t = tprog.audio_takens_program(tiny["audio"], tiny["n_a"], tiny["tcfg"],
                                   N_RS_MAX, N_WIN_MAX, K, n_win_cap=cap,
                                   device="cpu")
    for k in ("n_pts", "wmask", "tau", "n_win", "use_idx", "n_rs"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    np.testing.assert_allclose(t["envelope"].numpy(), np.asarray(j["envelope"]),
                               rtol=1e-4, atol=1e-5)
    dm_t, dm_j = t["dm"].numpy(), np.asarray(j["dm"])
    np.testing.assert_allclose(dm_t, dm_j, atol=1e-3, equal_nan=True)
    print(f"Takens distances: max abs err {float(np.nanmax(np.abs(dm_t - dm_j))):.3e}")
    far = np.abs(dm_j) > 0.05
    np.testing.assert_allclose(dm_t[far], dm_j[far], rtol=1e-4, atol=1e-5)


def test_slice_end_to_end_matches_jax(tiny):
    mo_j = jprog.audio_h1_program(jnp.asarray(tiny["mis"]), jnp.asarray(tiny["n_mis"]),
                                  tiny["jcfg"], N_RS_MAX, N_WIN_MAX, K, aud_chunk=16)
    out_j = jprog.comparison_program(
        jnp.asarray(tiny["eeg"]), jnp.asarray(tiny["n_e"]),
        jnp.asarray(tiny["audio"]), jnp.asarray(tiny["n_a"]),
        (mo_j["h1_b"], mo_j["h1_d"], mo_j["h1_m"]), mo_j["n_win"],
        mo_j["degen"], tiny["jcfg"], N_WIN_MAX, N_RS_MAX, K,
        eeg_chunk=16, aud_chunk=16)

    # the port consumes the mismatch diagrams it computes itself; they must
    # equal the reference's
    mo_t = tprog.audio_h1_program(tiny["mis"], tiny["n_mis"], tiny["tcfg"],
                                  N_RS_MAX, N_WIN_MAX, K, device="cpu")
    for k in ("h1_m", "n_win", "degen", "overflow"):
        _close(mo_t[k].numpy(), mo_j[k], k)
    for k in ("h1_b", "h1_d"):
        np.testing.assert_allclose(mo_t[k].numpy(), np.asarray(mo_j[k]),
                                   rtol=1e-4, atol=1e-3, err_msg=k)
        print(f"mismatch {k}: max abs err "
              f"{float(np.max(np.abs(mo_t[k].numpy() - np.asarray(mo_j[k])))):.3e}")
    with timed_spans() as parts:
        out_t = tprog.comparison_program(
            tiny["eeg"], tiny["n_e"], tiny["audio"], tiny["n_a"],
            (mo_t["h1_b"], mo_t["h1_d"], mo_t["h1_m"]), mo_t["n_win"],
            mo_t["degen"], tiny["tcfg"], N_WIN_MAX, N_RS_MAX, K, device="cpu")
    assert set(parts) == {"audio_takens", "eeg_pair_distance", "eeg_diagrams",
                          "audio_diagrams", "h0_exact_dp", "h1_tiered_sinkhorn",
                          "stats"}
    assert all(v >= 0.0 for v in parts.values())
    assert set(out_t) == set(out_j)
    for k, v in out_j.items():
        _close(out_t[k].numpy(), v, k)
    for k in EXACT:
        np.testing.assert_array_equal(out_t[k].numpy(), np.asarray(out_j[k]))
    assert np.all(out_t["n_pair"].numpy() == K)
    assert not out_t["overflow"].any()
    flat = tprog.pack_comparison_outputs(out_t).numpy()
    np.testing.assert_allclose(
        flat, np.asarray(jprog.pack_comparison_outputs(out_j)), rtol=1e-4, atol=1e-5)
    back = tprog.unpack_comparison_outputs(flat, B)
    np.testing.assert_array_equal(back["corr_r"], out_t["corr_r"].numpy())
    np.testing.assert_array_equal(back["overflow"], out_t["overflow"].numpy())


def test_entry_points_refuse_missing_cuda(tiny):
    """Without device= the entry points run on CUDA; with no card they raise
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tprog.eeg_feature_program(tiny["eeg"], tiny["n_e"], tiny["use_idx"],
                                  tiny["use_mask"], tiny["tcfg"], K=K)
    with pytest.raises(RuntimeError, match="CUDA"):
        tprog.audio_h1_program(tiny["mis"], tiny["n_mis"], tiny["tcfg"],
                               N_RS_MAX, N_WIN_MAX, K)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_from_numpy(eeg=tiny["eeg"])


def test_convert_and_data_copies():
    fields = dataclasses.asdict(JAX_CONFIG)
    cfg = config_from_jax(fields)
    assert dataclasses.asdict(cfg) == fields
    assert (cfg.win_samples, cfg.step_samples, cfg.max_takens_points) == \
        (JAX_CONFIG.win_samples, JAX_CONFIG.step_samples, JAX_CONFIG.max_takens_points)
    with pytest.raises(ValueError):
        config_from_jax(dict(fields, not_a_field=1))
    for args in ((3, 2, "slow"), (7, 11, "fast")):
        for a, b in zip(t_synth(*args), j_synth(*args)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_wsi("bb01_ut02", "alpha", 60, 39),
                                  j_wsi("bb01_ut02", "alpha", 60, 39))
    batch = batch_from_numpy(n_e=np.array([1, 2], np.int32),
                             use_mask=np.ones((2, 5, 3), bool),
                             mis_h1=(np.zeros((4, 6)), np.zeros((4, 6)),
                                     np.zeros((4, 6), bool)), device="cpu")
    assert batch["n_e"].dtype == torch.int64
    assert batch["use_mask"].dtype == torch.bool
    assert batch["mis_h1"][2].dtype == torch.bool
