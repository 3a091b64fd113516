"""The copies the benchmark keeps equal their originals, and its counts
equal hand counts at small shapes."""

import json

import numpy as np
import pytest
from helpers import ROOT

import chip_smoke
from portbench.harness import flops, fold_bound, generators


@pytest.mark.parametrize("seed", [7, 2147483659])
def test_simulate_demand_is_chip_smokes(seed):
    got = generators.simulate_demand(np, seed=seed, t_train=60)
    want = chip_smoke.simulate_demand(np, seed=seed, t_train=60)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [5, 2147483659])
def test_simulate_long_is_chip_smokes(seed):
    got = generators.simulate_long(np, seed, 6, 300)
    want = chip_smoke.simulate_long(np, seed, 6, 300)
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("periods,kh,kw,lp,seq", [
    ((7, 14), 3, 3, 55, 28), ((4, 27), 5, 5, 55, 28), ((1, 27), 7, 7, 55, 28),
    ((511, 168, 24, 7), 5, 5, 1023, 512), ((25,), 3, 3, 525, 512)])
def test_fold_bound_is_chip_smokes(periods, kh, kw, lp, seq):
    assert fold_bound.valid_taps(periods, kh, kw, lp, seq) == \
        chip_smoke.valid_taps(periods, kh, kw, lp, seq)
    for dtype in ("bfloat16", "float32"):
        for kind in ("fwd", "dh", "dw"):
            assert fold_bound.bound(periods, kh, kw, dtype, 64, kind, lp, seq) == \
                chip_smoke.bound(periods, kh, kw, dtype, 64, kind, lp, seq)


def test_valid_taps_by_hand():
    # period 2 over 4 steps: a 2 x 2 grid; each of its 4 cells sees 2 x 2 taps
    # of a 3 x 3 kernel
    assert fold_bound.valid_taps((2,), 3, 3, lp=4, seq_len=4) == 16
    # a row past the grid (t = 4, row 2) still reads the row above it: 1 x 2 taps
    assert fold_bound.valid_taps((2,), 3, 3, lp=5, seq_len=4) == 18


def test_bound_by_hand():
    # K = 1, B = 1, Lp = 4, C = 2, 1 x 1 kernel, bf16: bytes dominate
    act, w = 1 * 1 * 4 * 2, 1 * 1 * 2 * 2
    nbytes = act * 2 + w * 2 + 2 * 4 + 2 * 1 * 4 + act * 4
    ms, by, _ = fold_bound.bound((2,), 1, 1, "bfloat16", 1, "fwd", 4, 4, channels=2)
    assert by == "bytes" and ms == pytest.approx(1e3 * nbytes / 3.35e12)
    # the multiply-adds: every row valid, 2 x 2 channel pairs, 2 operations each
    ms, by, _ = fold_bound.bound((2,), 1, 1, "float32", 4096, "dw", 4, 4, channels=64)
    ops = 2 * 4096 * 64 * 64 * 4
    assert max(ms, 0) >= 1e3 * ops / 67e12 * (1 - 1e-12)


def test_flops_by_hand():
    model = {"input_len": 8, "pred_len": 2, "d_model": 4, "d_ff": 8, "n_layers": 1,
             "k_periods": 2, "kernel_set": [[3, 3]], "bottleneck_ratio": 2.0,
             "static_proj_dim": 3, "id_embed_dim": 2, "use_zero_mean_context": True,
             "context_rank": 2}
    data = {"static_dim": 5, "time_features": 4}
    # mid = ceil(4 / 2) = 2 in both blocks
    block_in = 4 * 2 + 9 * 2 * 2 + 2 * 8 + 1 * 8 * 8 + 4 * 8  # 8 + 36 + 16 + 64 + 32
    block_out = 8 * 2 + 9 * 2 * 2 + 2 * 4 + 1 * 4 * 4 + 8 * 4  # 16 + 36 + 8 + 16 + 32
    ctx = 5 * 3 + (3 + 2) * 2 + 8 * 2 + (3 + 2) * 2  # static, coefficients, basis, late bias
    macs = ctx + 8 * 5 * 4 + 2 * 8 * (block_in + block_out) + 4 * 8 * 2 + 2 * 2 * 4
    assert flops.forward_flops(model, data) == 2 * macs
    assert flops.step_flops(model, data, 3) == 3 * 3 * 2 * macs


def test_flops_of_the_configurations():
    demand = json.loads((ROOT / "portbench/configs/demand_benchmark.json").read_text())
    long_ = json.loads((ROOT / "portbench/configs/long_context.json").read_text())
    # "0:4,default:2" gives every depth the cap 4: the highest key at or below it
    assert flops.candidates(long_["model"], 1) == 4
    assert flops.forward_flops(demand["model"], {"static_dim": 5, "time_features": 8}) == \
        282_253_440
    assert flops.forward_flops(long_["model"], {"static_dim": 5, "time_features": 4}) == \
        2 * (1_427_975_168 + 5 * 32 + 32 * 8 + 32 * 24)  # the series features' context
