"""The reference against the port on the CPU at small widths: the forward,
and the loss and gradients of a training step with dropout."""

import numpy as np
import pytest
import torch
from helpers import found

from portbench.harness import data as hdata
from portbench.harness import program
from portbench.reference import inputs
from portbench.reference import timesnet as rnet

B = 6


def _case(workload: str, small: bool, dtype: str):
    cell = found(workload, small=small)
    model = cell["config"]["model"]
    model["compute_dtype"] = dtype
    ds = hdata.dataset(cell["config"])
    tn = program.model_config(cell["config"], ds)
    params = program.weights(tn, model, 2147483659, "cpu")
    net = program.Engine(tn, params, "cpu").model
    X, M, marks = hdata.training_fold(ds)
    L, H = int(model["input_len"]), int(model["pred_len"])
    flat = np.random.default_rng(3).permutation(hdata.windows_total(ds, L, H))[:B]
    w = inputs.windows(flat, X, M, marks, L, H)
    s = w["series"]
    batch = {"x": torch.tensor(w["x"]), "x_mark": torch.tensor(w["x_mark"]),
             "static": torch.tensor(ds.static[s][:, None, :]),
             "ids": torch.tensor(s[:, None]), "floor": torch.tensor(ds.floors[s][:, None, None]),
             "y": torch.tensor(w["y"]), "mask": torch.tensor(w["mask"]),
             "row_valid": torch.ones(B)}
    return model, params, net, batch


def _args(batch):
    return (batch["x"], batch["x_mark"], batch["static"], batch["ids"], batch["floor"])


@pytest.mark.parametrize("workload,small", [("flagship.train", False), ("flagship.train", True),
                                            ("long.train", True)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 2e-2)])
def test_forward_matches_the_port(workload, small, dtype, tol):
    model, params, net, batch = _case(workload, small, dtype)
    with torch.no_grad():
        rate, disp = net(*_args(batch))
        want_rate, want_disp = rnet.forward(params, model, *_args(batch), None,
                                            rnet.Rounding(dtype))
    assert float(((rate - want_rate).abs() / want_rate.abs().clamp(min=1e-3)).max()) < tol
    assert float((disp - want_disp).abs().max()) < tol


@pytest.mark.parametrize("workload,small", [("flagship.train", True), ("long.train", True)])
def test_training_step_matches_the_port(workload, small):
    """float32: the same dropout masks from the same seed, the same loss and
    the same gradients."""

    from flow_timesnet_tpu_torch.losses import negative_binomial_mask, negative_binomial_nll

    model, params, net, batch = _case(workload, small, "float32")
    net.train()
    rate, disp = net(*_args(batch), row_valid=batch["row_valid"],
                     generator=torch.Generator().manual_seed(9))
    base = batch["mask"] > 0
    loss = negative_binomial_nll(batch["y"], rate, disp,
                                 negative_binomial_mask(batch["y"], rate, disp, base))
    loss.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = rnet.loss(leaves, model, batch, rnet.Rounding("float32"),
                     rnet.Masks(torch.Generator().manual_seed(9), model["dropout"]))
    want.backward()
    assert loss.item() == pytest.approx(want.item(), rel=1e-5)
    named = dict(net.named_parameters())
    for k, leaf in leaves.items():
        got, ref = named[k].grad, leaf.grad
        assert float((got - ref).norm()) <= 1e-4 * max(float(ref.norm()), 1e-6), k


def test_control_rounds_to_float8():
    x = torch.tensor([1.0 + 2 ** -5, 1000.0, -3.3e-3], requires_grad=True)
    y = rnet.Rounding("float8")(x)
    assert y.tolist() == [1.0, 448.0, -2 * 2 ** -9]  # 1.7 subnormal steps round to 2
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]  # passed through
    assert rnet.Rounding("bfloat16")(torch.tensor([1.0 + 2 ** -9])).item() == 1.0


def test_ties_swap_the_kth_bin_only_within_the_tolerance():
    ties = rnet.Ties(0.01, swap={0, 1})
    score = [float("-inf"), 5.0, 4.999, 3.0]
    ranked = [1, 2, 3, 0]
    assert ties.choose(ranked, score, 1) == [2]  # within 1 %: swapped as asked
    assert ties.choose(ranked, score, 2) == [1, 2]  # 4.999 against 3.0: no tie
    assert ties.tied == [0] and ties.count == 2


def test_tie_branches_enumerate_every_resolution():
    """Each tied selection met along a run (here every selection, with the
    tolerance at 1) doubles the ways, the fewest swaps first."""

    model, params, _, batch = _case("long.train", True, "bfloat16")
    met = []

    def run(ties):
        with torch.no_grad():
            rnet.forward(params, model, *_args(batch), None, rnet.Rounding("bfloat16"), None, ties)
        met.append(sorted(ties.swap))
        return sorted(ties.swap)

    out = rnet.tie_branches(run, 1.0)
    layers = int(model["n_layers"])
    assert out == [[], [0], [1], [0, 1]][:2 ** layers] and met == out


@pytest.mark.parametrize("workload", ["flagship.train", "long.train"])
def test_a_run_that_took_the_other_bin_at_a_tie_is_judged_against_it(workload):
    """A program that resolves a near-tie the other way reads as the
    reference that does: ``closest`` picks that branch from all of them."""

    from portbench import run as prun
    from portbench.harness import train as htrain

    cell = found(workload, small=True)
    run = prun.Run(torch, cell, 2147483659, 0.5, False, device="cpu")
    model, params, _, _ = _case(workload, True, cell["config"]["model"]["compute_dtype"])
    ds = hdata.dataset(cell["config"])
    L, H = int(model["input_len"]), int(model["pred_len"])
    rows = hdata.Plan(hdata.windows_total(ds, L, H), 8, 5).take(3)
    dtype = cell["config"]["model"]["compute_dtype"]
    rnet.Ties.TOL[dtype], tol = 1.0, rnet.Ties.TOL[dtype]  # every selection tied
    try:
        wants = htrain.reference_states(run, params, rows, 11, dtype)
    finally:
        rnet.Ties.TOL[dtype] = tol
    assert len(wants) == 8
    got = wants[5]
    want = htrain.closest(got, wants, cell["limits"])
    assert all(v == 0 for v in htrain.readings(got, want).values())
    by_score = htrain.reference_states(run, params, rows, 11, dtype, ties=False)[0]
    assert any(v > 0 for v in htrain.readings(got, by_score).values())
