"""`ops.features.diagram_features` does not depend on the arena's width: the
same bars in the same columns of a 96- or a 128-column arena (the runner's
`feature_na_max` knob) give the same features bit for bit, on the CPU and
(`cuda`-marked) on the card, where a float32 sum's order follows the width."""
import pytest
import torch

from tda_eeg_audio_tpu_torch.ops.features import diagram_features

torch.set_num_threads(1)


def _arenas(dev, N=20_000, seed=0):
    """(births, deaths, mask, n_essential) of N diagrams of 0-90 bars in a
    128-column arena; balanced two-bar diagrams (entropy near 1) among them."""
    g = torch.Generator().manual_seed(seed)
    nb = torch.randint(0, 91, (N,), generator=g)
    b = torch.rand((N, 128), generator=g)
    d = b + torch.rand((N, 128), generator=g) ** 3
    nb[:500] = 2
    d[:500, 1] = b[:500, 1] + (d[:500, 0] - b[:500, 0]) * (1 + 1e-6 * torch.rand(500, generator=g))
    m = torch.arange(128)[None] < nb[:, None]
    return [x.to(dev) for x in (b, d, m, torch.zeros(N))]


def _same_at_both_widths(dev):
    b, d, m, ne = _arenas(dev)
    f128 = diagram_features(b, d, m, ne)
    f96 = diagram_features(*(x[:, :96].contiguous() for x in (b, d, m)), ne)
    assert f128.dtype == torch.float32
    assert torch.equal(f128, f96), int((f128 != f96).any(-1).sum())
    ref = diagram_features(b.double(), d.double(), m, ne)      # float64 in, float64 out
    assert ref.dtype == torch.float64
    assert torch.equal(f128, ref.float())


def test_features_do_not_depend_on_the_arena_width():
    _same_at_both_widths(torch.device("cpu"))


@pytest.mark.cuda
def test_features_do_not_depend_on_the_arena_width_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    _same_at_both_widths(torch.device("cuda"))
