"""The reference's pieces at a tiny size against the port's plain CPU path
and the boundary-matrix oracle.  (A test may import both; the reference
itself imports nothing of the port.)"""

import numpy as np
import pytest
import torch

from benchmark.reference import features as F
from benchmark.reference import oracle
from benchmark.reference import persistence as P
from benchmark.reference import signal as S
from benchmark.reference import stats as RS
from benchmark.reference import wasserstein as W
from tda_eeg_audio_tpu_torch.ops import features as TF
from tda_eeg_audio_tpu_torch.ops import geometry as TG
from tda_eeg_audio_tpu_torch.ops import homology_h1 as TH
from tda_eeg_audio_tpu_torch.ops import signal as TS
from tda_eeg_audio_tpu_torch.ops import stats as TST
from tda_eeg_audio_tpu_torch.ops import wasserstein as TW


@pytest.fixture
def gen():
    return torch.Generator().manual_seed(7)


def test_persistence_equals_the_oracle(gen):
    pts = torch.rand((6, 18, 3), generator=gen, dtype=torch.float64)
    dm = torch.cdist(pts, pts)
    out = P.diagrams(dm)
    for w in range(dm.shape[0]):
        h0, h1 = oracle.rips_persistence_dm(dm[w].numpy(), 1, 2.0)
        fin = out["mask"][w]
        got = sorted(zip(out["births"][w][fin].tolist(), out["deaths"][w][fin].tolist()))
        assert np.allclose(got, sorted(map(tuple, h1.tolist())))
        assert np.allclose(out["h0_deaths"][w][out["h0_mask"][w]].numpy(),
                           np.sort(h0[np.isfinite(h0[:, 1]), 1]))


def test_persistence_of_padded_clouds_equals_the_oracle(gen):
    pts = torch.rand((5, 24, 3), generator=gen, dtype=torch.float64)
    n_pts = torch.tensor([24, 20, 7, 3, 2])
    dm = torch.cdist(pts, pts)
    pad = ~((torch.arange(24)[None, :] < n_pts[:, None])[:, :, None]
            & (torch.arange(24)[None, :] < n_pts[:, None])[:, None, :])
    dm = torch.where(pad, 3.0, dm)
    dm[:, range(24), range(24)] = 0.0
    out = P.diagrams(dm, n_pts)
    for w in range(5):
        k = int(n_pts[w])
        _, h1 = oracle.rips_persistence_dm(dm[w, :k, :k].numpy(), 1, 2.0)
        fin = out["mask"][w]
        got = sorted(zip(out["births"][w][fin].tolist(), out["deaths"][w][fin].tolist()))
        assert np.allclose(got, sorted(map(tuple, h1.tolist())))


def test_persistence_redoes_an_overflowed_window(monkeypatch, gen):
    pts = torch.rand((2, 16, 3), generator=gen, dtype=torch.float64)
    dm = torch.cdist(pts, pts)
    want = P.diagrams(dm)
    monkeypatch.setattr(P, "NA_MAX", 1)
    got = P.diagrams(dm)
    assert got["redone"] >= 1
    for k in ("h0_deaths", "n_tree", "n_essential"):
        assert torch.allclose(got[k].double(), want[k].double())
    for w in range(2):
        a = sorted(got["deaths"][w][got["mask"][w]].tolist())
        b = sorted(want["deaths"][w][want["mask"][w]].tolist())
        assert np.allclose(a, b)


def test_persistence_and_features_equal_the_ports_plain_path(gen):
    x = torch.randn((5, 47, 250), generator=gen, dtype=torch.float64)
    dm = S.correlation_distance(x)
    want_dm = TG.correlation_to_distance(TG.correlation_matrix(x))
    assert torch.allclose(dm, want_dm, atol=1e-14)
    dg = P.diagrams(dm)
    got = F.window_features(dg)
    port = TH.h1_diagrams_plain(dm.float(), n=47, thresh=2.0, na_max=128, h1_max=128)
    n_comp = 47 - port["n_tree"]
    fin = port["mask"] & torch.isfinite(port["deaths"])
    want = torch.stack([
        TF.diagram_features(torch.zeros_like(port["h0_deaths"]), port["h0_deaths"],
                            port["h0_mask"], n_comp),
        TF.diagram_features(port["births"], torch.where(fin, port["deaths"], 0.0), fin,
                            port["n_essential"])], dim=1)
    assert torch.allclose(got.float(), want, rtol=1e-5, atol=1e-6)
    agg = F.mean_std(got.flatten(-2)[None])
    want_agg = TF.aggregate_mean_std(want.flatten(-2)[None].double(),
                                     torch.ones((1, 5), dtype=torch.bool))
    assert torch.allclose(agg, want_agg, rtol=1e-5, atol=1e-6)


def test_signal_chain_equals_the_ports(gen):
    x = torch.randn((2, 47, 5800), generator=gen, dtype=torch.float64)
    bank = torch.as_tensor(TS.design_band_fir_bank(250, 4, 1537))
    assert torch.allclose(S.fir_bank(x, S.band_bank(250, 4, 1537)),
                          TS.bandpass_bank(x, bank), atol=1e-12)
    aud = torch.zeros((1, 44100 * 3), dtype=torch.float64)
    aud[0, :44100 * 2] = torch.randn(44100 * 2, generator=gen, dtype=torch.float64)
    h, up, down = TS.design_resample_poly_filter(250, 44100)
    y, n_out = TS.resample_poly_device(aud, torch.tensor([44100 * 2]), 800, h, up, down)
    h2, up2, down2 = S.resample_filter(250, 44100)
    rs = S.resample_poly(aud[0, :44100 * 2], 44100 * 2, up2, down2, h2)
    assert len(rs) == int(n_out[0]) and torch.allclose(rs, y[0, :len(rs)], atol=1e-12)
    pad = torch.zeros(800, dtype=torch.float64)
    pad[:len(rs)] = rs
    env = S.hilbert_envelope(pad, S.envelope_lowpass(250), S.hilbert_fir())
    want = TS.hilbert_envelope(y, torch.as_tensor(TS.design_envelope_lowpass(250)).double(),
                               torch.as_tensor(TS.design_hilbert_fir()).double(),
                               mask=(torch.arange(800)[None] < n_out[:, None]).double())
    assert torch.allclose(env, want[0], atol=1e-10)
    w = torch.randn((6, 250), generator=gen, dtype=torch.float64)
    assert torch.equal(S.autocorr_tau(w, 125), TS.autocorr_tau(w, 125))
    pts, m = TS.takens_embed(w[:1], torch.tensor([4]), 3, 2, 124)
    cloud = S.takens_cloud(w[0], 4, 3, 2)
    assert cloud.shape[0] == int(m.sum())
    assert torch.allclose(cloud, TS.minmax_normalize_points(pts, m)[0, :cloud.shape[0]])


def test_wasserstein_equals_the_ports(gen):
    K = 12
    b1, b2 = (torch.rand((5, K), generator=gen, dtype=torch.float64) for _ in range(2))
    d1, d2 = (b + torch.rand((5, K), generator=gen, dtype=torch.float64) for b in (b1, b2))
    m1, m2 = (torch.rand((5, K), generator=gen) < 0.6 for _ in range(2))
    m2[0] = False
    D = W.cost_matrix(b1, d1, m1, b2, d2, m2)
    assert torch.equal(D, TW.build_cost_matrix(b1, d1, m1, b2, d2, m2))
    # the one solver stands for both of the program's: the tiered
    # linear-domain form and the log-domain redo
    assert torch.allclose(W.sinkhorn_log(D), TW.sinkhorn_cost_stab(D), rtol=1e-9)
    assert torch.allclose(W.sinkhorn_log(D), TW.sinkhorn_cost(D), rtol=1e-12)
    pairs = [(torch.stack([b1[i][m1[i]], d1[i][m1[i]]], 1),
              torch.stack([b2[i][m2[i]], d2[i][m2[i]]], 1)) for i in range(5)]
    assert torch.allclose(W.h1_pairs(W.sinkhorn_log, pairs, torch.float64, "cpu"),
                          W.sinkhorn_log(D), rtol=1e-9)
    a, b = torch.rand((4, 46), generator=gen, dtype=torch.float64), \
        torch.rand((4, 123), generator=gen, dtype=torch.float64)
    ma = torch.rand((4, 46), generator=gen) < 0.7          # ragged on both sides
    mb = torch.rand((4, 123), generator=gen) < 0.8
    mb[3] = False                                          # an empty side
    want = TW.wasserstein_h0_exact_plain(a, ma, b, mb)
    got = W.h0_pairs([(a[i][ma[i]], b[i][mb[i]]) for i in range(4)], torch.float64, "cpu")
    assert torch.allclose(got, want, rtol=1e-12)


def test_statistics_equal_the_ports(gen):
    d = torch.randn((5, 45), generator=gen, dtype=torch.float64)
    valid = torch.ones_like(d, dtype=torch.bool)
    _, p = TST.wilcoxon(d, valid)
    for b in range(5):
        assert RS.wilcoxon_p(d[b].numpy()) == pytest.approx(float(p[b]), rel=1e-9)
    tied = torch.round(d * 4) / 4          # ties and zeros: the normal branch
    _, p = TST.wilcoxon(tied, valid)
    for b in range(5):
        assert RS.wilcoxon_p(tied[b].numpy()) == pytest.approx(float(p[b]), rel=1e-9)
    signs = (2 * torch.randint(0, 2, (200, 5, 45), generator=gen) - 1).double()
    pf = TST.sign_flip_pvalue(d, valid, signs=signs)
    for b in range(5):
        assert RS.sign_flip_p(d[b].numpy(), signs[:, b].numpy()) == pytest.approx(float(pf[b]))
    cd = TST.cohens_d_paired(d, valid)
    assert RS.cohens_d(d[0].numpy()) == pytest.approx(float(cd[0]), rel=1e-12)
    pv = torch.tensor([[0.01, 0.04, 0.03, 0.5, 0.2]], dtype=torch.float64)
    _, adj = TST.bh_fdr(pv)
    assert np.allclose(RS.bh_adjust(pv[0].numpy()), adj[0].numpy())
