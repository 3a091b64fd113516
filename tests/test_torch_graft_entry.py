"""``flow_timesnet_tpu_torch/graft_entry.py``: the port's flagship forward
entry against the JAX package's model on the same weights and inputs, and
its multichip dry run on gloo ranks on the CPU."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import __graft_entry__ as jentry  # noqa: E402

from flow_timesnet_tpu.models.timesnet import TimesNet as JaxTimesNet  # noqa: E402
from flow_timesnet_tpu_torch import convert, graft_entry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as the other port tests run: a pool as wide as the
    machine beside JAX's own threads slows the CPU forward many times over."""

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_forward(dtype, params, args):
    cfg = jentry._flagship_cfg(compute_dtype=dtype)
    tree = convert.params_to_jax(params, graft_entry.flagship_config(compute_dtype=dtype))
    rate, disp = JaxTimesNet(cfg).apply({"params": tree}, *(a.numpy() for a in args),
                                        deterministic=True)
    return np.asarray(rate), np.asarray(disp)


def test_entry_matches_jax_on_the_cpu():
    """The flagship at float32 within 1e-4 of the JAX package's model on the
    same weights and inputs (``test_torch_model.py`` holds the bf16 conv
    islands, within 1e-2)."""

    fn, (params, *args) = graft_entry.entry(device="cpu", compute_dtype="float32")
    assert args[0].shape == (128, 28, 1) and args[3].dtype == torch.int32
    rate, disp = fn(params, *args)
    want_rate, want_disp = _jax_forward("float32", params, args)
    np.testing.assert_allclose(rate.numpy(), want_rate, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(disp.numpy(), want_disp, rtol=1e-4, atol=1e-4)


def test_entry_is_the_bf16_flagship():
    fn, (params, *args) = graft_entry.entry(device="cpu")
    rate, disp = fn(params, *args)
    assert rate.shape == disp.shape == (128, 7, 1)
    assert bool(torch.isfinite(rate).all()) and bool((disp > 0).all())
    assert sum(p.numel() for p in params.values()) == 2_536_356  # PERF.md's flagship count


def test_flagship_config_is_the_recipes():
    cfg = graft_entry.flagship_config()
    want = jentry._flagship_cfg()
    for field in ("d_model", "d_ff", "n_layers", "k_periods", "kernel_set", "compute_dtype",
                  "id_vocab", "static_dim", "time_features", "context_rank", "dropout"):
        assert getattr(cfg, field) == getattr(want, field), field


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()


def test_dryrun_multichip_on_two_gloo_ranks(capsys):
    graft_entry.dryrun_multichip(2)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"dryrun_multichip\(2\): ok, loss=([\d.]+), resident_epoch_losses=\[(.*)\], "
                     r"frozen_epoch_losses=\[(.*)\] \(frozen periods \[(.*)\]\)", line)
    assert m, line
    values = [float(m.group(1))] + [float(v) for g in (2, 3) for v in m.group(g).split(",")]
    assert len(values) == 5 and np.all(np.isfinite(values))
    assert m.group(4)  # at least one frozen period
