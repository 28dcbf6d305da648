"""The benchmark's arithmetic on hand-worked cases."""
import importlib.util
from pathlib import Path

import pytest
import torch

from portbench import yardstick

METRICS = Path(__file__).resolve().parent.parent / "metrics"


def reader_module(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_percentile_nearest_rank():
    v = list(range(1, 11))              # 1..10
    assert yardstick.percentile(v, 90) == 9
    assert yardstick.percentile(v, 91) == 10
    assert yardstick.percentile(v, 50) == 5
    assert yardstick.percentile([3.0], 90) == 3.0
    with pytest.raises(ValueError):
        yardstick.percentile([], 90)


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert yardstick.union_length(iv) == 3.0
    assert yardstick.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert yardstick.gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_conv_flops():
    # 3x3, 2 -> 4 channels on a 5x6 output: 2*2*4*9*30
    assert yardstick.conv_flops(2, 4, 3, 5, 6) == 4320.0


def test_support_taps_clip_at_the_borders():
    # one pixel at (0, 0): its support x, y in [-3, 5) reads [0, 5) each
    c = torch.zeros((1, 1, 1, 2), dtype=torch.float64)
    assert yardstick.support_taps(c, [(10, 10)], [(10, 10)], (1.0,)) == 25
    # in the middle: the whole 8x8 support
    c[..., 0], c[..., 1] = 5.5, 5.5
    assert yardstick.support_taps(c, [(10, 10)], [(16, 10)], (1.0,)) == 64
    # level 1 halves the coords: (2.75, 2.75) -> [-1, 7) -> [0, 5) of 5
    assert yardstick.support_taps(c, [(5, 5)], [(8, 5)], (2.0,)) == 25


def test_lookup_bytes():
    # 2 edge slots of 1x1 pixel, one live, mid-image at one level:
    # 64 bf16 taps + 8 coord bytes + 2 slots x 196 outputs x 2 bytes
    c = torch.full((2, 1, 1, 2), 5.5, dtype=torch.float64)
    b = yardstick.lookup_bytes(c, 1, [(16, 16)], [(16, 16)], 2)
    assert b == 64 * 2 + 8 + 2 * 196 * 2


def test_peaks_by_card_name():
    p = yardstick.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16"] == 989e12 and p["hbm_bytes_s"] == 3.35e12
    assert yardstick.peaks("cpu") is None


def test_encoder_and_update_flops():
    m = reader_module("mfu.track")
    # 16x16 input: stem 7x7/2 3->32 on 8x8, four 32->32 3x3 on 8x8,
    # stage 2 on 4x4, stage 3 on 2x2, 1x1 head 128->128 on 2x2
    c = yardstick.conv_flops
    want = (c(3, 32, 7, 8, 8) + 4 * c(32, 32, 3, 8, 8)
            + c(32, 64, 3, 4, 4) + 3 * c(64, 64, 3, 4, 4)
            + c(32, 64, 1, 4, 4)
            + c(64, 128, 3, 2, 2) + 3 * c(128, 128, 3, 2, 2)
            + c(64, 128, 1, 2, 2) + c(128, 128, 1, 2, 2))
    assert m.encoder_flops(16, 16, 128) == want
    # one edge-iteration at 43x77 is about 12 GFLOP
    assert 10e9 < m.update_flops(43, 77, True) < 14e9
    assert m.call_flops(("volume", 2, 128, 3, 4)) == 2.0 * 2 * 144 * 128
    assert m.call_flops(("update", 3, 43, 77, 1, 1, 0)) == \
        3 * m.update_flops(43, 77, True)


def test_map_step_flops():
    m = reader_module("mfu.map")
    cfg = {"grid": {"n_levels": 16, "n_features": 2}, "hidden": 64,
           "batch_rays": 4096, "n_uniform": 96, "n_depth": 32}
    per_sample = 16 * 8 * 6 + 16 * 8 * 2 + 3 * 2 * (
        32 * 64 + 64 * 16 + 31 * 64 + 64 * 64 + 64 * 3) + 30
    assert m.step_flops(cfg) == 4096 * 128 * per_sample
