"""The union-bank comparison path of the port (CPU) against its own in-call
path and against the JAX reference, on the tiny case of
tests/test_eeg_bank.py (0.2 s windows, 101 taps, B = 2, K = 5, union columns
the md5 sample does not cover).

Tolerances: bank path == in-call path exactly on the CPU (as the reference
pins for itself); against JAX the slice's tolerances — w_h1 / w_h1_mis rtol
2e-4, other floats rtol 1e-4 / atol 1e-5, integers and flags exact; bank
leaves: masks exact, bars rtol 1e-4 / atol 2e-5 (worst observed 1.04e-5),
features rtol 1e-4 / atol 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tda_eeg_audio_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from tda_eeg_audio_tpu.models import programs as jprog
from tda_eeg_audio_tpu.models.study import _paired_window_idx as j_pair_idx
from tda_eeg_audio_tpu_torch.config import BAND_NAMES
from tda_eeg_audio_tpu_torch.convert import config_from_jax
from tda_eeg_audio_tpu_torch.io.synthetic import window_sample_indices
from tda_eeg_audio_tpu_torch.models import programs as tprog
from tda_eeg_audio_tpu_torch.models.study import _paired_window_idx

torch.set_num_threads(1)

B, N_WIN_MAX, N_RS_MAX, K = 2, 12, 300, 5
EXACT = ("tau", "n_pair", "a_degen", "overflow")
LEAVES = ("h1_b", "h1_d", "h1_m", "h0_d", "h0_m", "feats")


@pytest.fixture(scope="module")
def case():
    jcfg = dataclasses.replace(JAX_CONFIG, window_sec=0.2, fir_numtaps=101)
    tcfg = config_from_jax(dataclasses.asdict(jcfg))
    win, step = jcfg.win_samples, jcfg.step_samples
    n_e = np.array([win + 7 * step, win + 8 * step], np.int32)   # 8, 9 windows
    T = win + (N_WIN_MAX - 1) * step
    rng = np.random.default_rng(0)
    eeg = np.zeros((B, 47, T), np.float32)
    for i, n in enumerate(n_e):
        eeg[i, :, :n] = rng.standard_normal((47, n))
    n_a = (n_e * jcfg.fs_audio // jcfg.fs_eeg).astype(np.int32)
    audio = np.zeros((B, int(n_a.max())), np.float32)
    for i, n in enumerate(n_a):
        audio[i, :n] = rng.standard_normal(n)
    mo = tprog.audio_h1_program(audio[::-1].copy(), n_a[::-1].copy(), tcfg,
                                N_RS_MAX, N_WIN_MAX, K, device="cpu")
    mis = ((mo["h1_b"], mo["h1_d"], mo["h1_m"]), mo["n_win"], mo["degen"])

    # features stage under "min" equalization + the paired union columns
    nw = (n_e - win) // step + 1
    n_pair = np.minimum(nw, (n_e - win) // step + 1)
    K_feat = int(nw.min())
    Kx = K_feat + K
    use_idx = np.zeros((B, 5, Kx), np.int32)
    use_mask = np.zeros((B, 5, Kx), bool)
    for b in range(B):
        for bd, band in enumerate(BAND_NAMES):
            sel = window_sample_indices(f"rec{b}", band, int(nw[b]), K_feat,
                                        tcfg.window_sampling,
                                        tcfg.window_sample_seed)
            use_idx[b, bd, :len(sel)] = sel
            use_mask[b, bd, :len(sel)] = True
        use_idx[b, :, K_feat:] = _paired_window_idx(int(n_pair[b]), K)
    assert any(set(use_idx[b, bd, K_feat:]) - set(use_idx[b, bd, :K_feat])
               for b in range(B) for bd in range(5)), \
        "the union columns must hold a window outside the md5 sample"
    gidx = np.zeros((B, 5, K), np.int64)
    for b in range(B):
        for bd in range(5):
            gidx[b, bd] = (b * 5 + bd) * Kx + K_feat + np.arange(K)
    return dict(jcfg=jcfg, tcfg=tcfg, eeg=eeg, n_e=n_e, audio=audio, n_a=n_a,
                mis=mis, use_idx=use_idx, use_mask=use_mask, Kx=Kx, T=T,
                gidx=gidx.reshape(-1))


@pytest.fixture(scope="module")
def torch_banks(case):
    """{na_max: (agg, bank)} of the port's features stage, each run once."""
    return {na_max: tprog.eeg_feature_program(
        case["eeg"], case["n_e"], case["use_idx"], case["use_mask"],
        case["tcfg"], K=case["Kx"], na_max=na_max, return_bank=True,
        device="cpu")[::2] for na_max in (128, 64)}


def _flat(bank):
    assert not bool(bank["ovf"].any())
    return {k: bank[k].flatten(0, 1) for k in LEAVES}


def _from_bank(case, flat):
    out = tprog.comparison_from_bank(
        flat, case["gidx"], case["n_e"], case["audio"], case["n_a"],
        *case["mis"], case["tcfg"], N_WIN_MAX, N_RS_MAX, K,
        t_eeg_pad=case["T"], device="cpu")
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def in_call(case):
    out = tprog.comparison_program(
        case["eeg"], case["n_e"], case["audio"], case["n_a"], *case["mis"],
        case["tcfg"], N_WIN_MAX, N_RS_MAX, K, device="cpu")
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_bank(case):
    agg, ovf, bank = jprog.eeg_feature_program(
        jnp.asarray(case["eeg"]), jnp.asarray(case["n_e"]),
        jnp.asarray(case["use_idx"]), jnp.asarray(case["use_mask"]),
        case["jcfg"], N_WIN_MAX, case["Kx"], chunk=16, na_max=128,
        return_bank=True)
    return np.asarray(agg), {k: np.asarray(v) for k, v in bank.items()}


def test_bank_leaves_match_reference(torch_banks, jax_bank):
    """Every leaf of return_bank, union (mask=False) columns included.
    Bars are the windows' distances themselves: over 0.2 s windows the two
    FFTs' rounding reaches them (worst observed 1.04e-5), hence atol 2e-5."""
    agg_j, bank_j = jax_bank
    agg_t, bank_t = torch_banks[128]
    assert set(bank_t) == set(bank_j)
    np.testing.assert_allclose(agg_t.numpy(), agg_j, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(bank_t["ovf"].numpy(), bank_j["ovf"])
    for k in ("h1_m", "h0_m"):
        np.testing.assert_array_equal(bank_t[k].numpy(), bank_j[k], err_msg=k)
    for k in ("h1_b", "h1_d", "h0_d"):
        assert bank_t[k].shape == bank_j[k].shape, k
        np.testing.assert_allclose(bank_t[k].numpy(), bank_j[k], rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(bank_t["feats"].numpy(), bank_j["feats"],
                               rtol=1e-4, atol=1e-5)
    assert bank_t["h1_m"].shape[-1] == 128


@pytest.mark.parametrize("na_max", [128, 64], ids=["wide", "narrow"])
def test_comparison_from_bank_equals_in_call_path(case, torch_banks, in_call,
                                                  na_max):
    """The bank path reproduces comparison_program exactly on the CPU, from
    a 128-wide bank (sliced to 96) and from a 64-wide one (zero-padded)."""
    flat = _flat(torch_banks[na_max][1])
    assert flat["h1_m"].shape[-1] == na_max
    out = _from_bank(case, flat)
    assert set(out) == set(in_call)
    for k, want in in_call.items():
        np.testing.assert_array_equal(out[k], want, err_msg=k)


def test_comparison_from_bank_matches_reference(case, torch_banks, jax_bank):
    _, bank_j = jax_bank
    flat_j = {k: jnp.asarray(bank_j[k].reshape(-1, *bank_j[k].shape[2:]))
              for k in LEAVES}
    mis_j = (tuple(jnp.asarray(x.numpy()) for x in case["mis"][0]),
             jnp.asarray(case["mis"][1].numpy().astype(np.int32)),
             jnp.asarray(case["mis"][2].numpy()))
    ref = jprog.comparison_from_bank(
        flat_j, jnp.asarray(case["gidx"].astype(np.int32)),
        jnp.asarray(case["n_e"]), jnp.asarray(case["audio"]),
        jnp.asarray(case["n_a"]), *mis_j, case["jcfg"], N_WIN_MAX, N_RS_MAX,
        K, aud_chunk=16, t_eeg_pad=case["T"])
    out = _from_bank(case, _flat(torch_banks[128][1]))
    assert set(out) == set(ref)
    for k, want in ref.items():
        want = np.asarray(want)
        if k in EXACT:
            np.testing.assert_array_equal(out[k], want, err_msg=k)
        else:
            rtol = 2e-4 if k in ("w_h1", "w_h1_mis") else 1e-4
            np.testing.assert_allclose(out[k], want, rtol=rtol, atol=1e-5,
                                       err_msg=k)
            denom = 1e-5 + rtol * np.abs(want)
            print(f"{k}: worst error / tolerance "
                  f"{float((np.abs(out[k] - want) / denom).max()):.3f}")


def test_bank_overflow_flag_and_pack_roundtrip(case, torch_banks):
    """A bar beyond column 96 of a wide bank flags the recording; the packed
    features vector carries bank_ovf behind ovf."""
    flat = _flat(torch_banks[128][1])
    m = flat["h1_m"].clone()
    m[case["gidx"][3], 100] = True          # recording 0
    flat["h1_m"] = m
    out = _from_bank(case, flat)
    assert out["overflow"].tolist() == [True, False]
    agg = torch.arange(B * 5 * 2 * 11 * 2, dtype=torch.float32).reshape(B, 5, 2, 11, 2)
    diag = torch.ones((B, 5, 8))
    packed = tprog.pack_feature_outputs(agg, diag, torch.tensor([True, False]),
                                        torch.tensor([False, True]))
    a, d, o, bo = tprog.unpack_feature_outputs(packed.numpy(), B, has_bank=True)
    np.testing.assert_array_equal(a, agg.numpy())
    assert o.tolist() == [True, False] and bo.tolist() == [False, True]
    assert len(tprog.unpack_feature_outputs(
        tprog.pack_feature_outputs(agg, diag, torch.tensor([True, False])).numpy(), B)) == 3


def test_host_pair_idx_matches_device_selection(case):
    """`_paired_window_idx` == the device's selection for n_pair 0…40, and
    == the reference's host formula."""
    cfg = case["tcfg"]
    win, step = cfg.win_samples, cfg.step_samples
    counts = np.arange(0, 41)
    n_rs = np.where(counts > 0, win + (counts - 1) * step, win - 5)
    n_a = (n_rs * cfg.fs_audio // cfg.fs_eeg).astype(np.int64)
    rng = np.random.default_rng(0)
    audio = np.zeros((len(counts), int(n_a.max())), np.float32)
    for i, n in enumerate(n_a):
        audio[i, :n] = rng.standard_normal(n)
    aud = tprog.audio_takens_program(audio, n_a, cfg, 560, 46, 15, device="cpu")
    np.testing.assert_array_equal(aud["n_win"].numpy(), counts)
    for i, c in enumerate(counts):
        np.testing.assert_array_equal(aud["use_idx"][i].numpy(),
                                      _paired_window_idx(int(c), 15),
                                      err_msg=f"n_pair={c}")
        np.testing.assert_array_equal(_paired_window_idx(int(c), 15),
                                      j_pair_idx(int(c), 15))
