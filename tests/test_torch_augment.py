"""Window augmentation (``data.augment``: ``add_noise_std``, ``time_shift``)
in the port's two input pipelines, on the CPU.

- Host (``data/windows.py``): a shuffled batcher draws the shifts before the
  gather and the noise after it from its own generator, as the JAX
  package's does, so every batch of an epoch equals the JAX package's bit
  for bit: several seeds, several folds, strides 1 and 2, a padded last
  batch, two epochs.
- Resident (``data/device_windows.py``): the draws come from a torch
  generator, so no stream can match JAX's; held instead to what they must
  be. Each shift lies in ``[-time_shift, time_shift]`` and is clipped to its
  fold's last start, and each row is the clean window at its shifted start
  (inputs, targets, mask, marks); the noise has mean 0 (4 standard errors)
  and its standard deviation (within 5 %); padded rows stay exactly zero;
  zero augmentation equals none and leaves the generator where it was; a
  knob without a generator raises ``ValueError``. The telemetry probe and
  ``evaluate_resident`` see the clean windows, and a resident epoch equals
  eager steps on batches gathered from the same generator (dropout on: the
  shift, the noise, then dropout, in that order).
- ``train_once`` on the host pipeline with augmentation and dropout 0
  against the JAX package's: every step's loss and each epoch's validation
  metrics within 1e-4 relative.
"""

import copy
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")
jax = pytest.importorskip("jax")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
sys.path.insert(0, os.path.dirname(__file__))

from flow_timesnet_tpu import engine as jengine  # noqa: E402
from flow_timesnet_tpu import train as jtrain  # noqa: E402
from flow_timesnet_tpu.data import windows as jwindows  # noqa: E402
from flow_timesnet_tpu_torch import convert  # noqa: E402
from flow_timesnet_tpu_torch import engine as pengine  # noqa: E402
from flow_timesnet_tpu_torch import train as ptrain  # noqa: E402
from flow_timesnet_tpu_torch.data import device_windows as dw  # noqa: E402
from flow_timesnet_tpu_torch.data import windows  # noqa: E402

from test_torch_train_once import demand_config, one_torch_thread  # noqa: E402,F401

FIELDS = ("x", "y", "mask", "x_mark", "y_mark", "static", "series_ids", "row_valid")
TF_CFG = {"enabled": True, "features": ["day_of_week", "month"], "encoding": "cyclical",
          "normalize": True}
AUGMENT = {"add_noise_std": 0.3, "time_shift": 2}


def _host_batchers(seed, stride):
    rng = np.random.default_rng(seed)
    folds = [(rng.poisson(4.0, (T, 5)).astype(np.float32),
              (rng.random((T, 5)) < 0.9).astype(np.float32),
              np.datetime64(start) + np.arange(T))
             for T, start in ((40, "2024-01-03"), (33, "2024-02-20"), (25, "2024-04-01"))]
    static = rng.standard_normal((5, 3)).astype(np.float32)
    made = []
    for mod, index in ((jwindows, pd.DatetimeIndex), (windows, np.asarray)):
        sources = [mod.SlidingWindowSource(values, 14, 7, "direct", augment=AUGMENT,
                                           stride=stride, valid_mask=mask, series_static=static,
                                           series_ids=np.arange(5), time_index=index(dates),
                                           time_feature_config=TF_CFG)
                   for values, mask, dates in folds]
        made.append(mod.WindowBatcher(sources, 16, True, False, seed, pad_final=True))
    return made


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_host_batches_equal_jax_with_augmentation(seed, stride):
    jbatcher, batcher = _host_batchers(seed, stride)
    clean = copy.deepcopy(batcher)
    for s in clean.sources:
        s.add_noise_std, s.time_shift = 0.0, 0
    for epoch in (1, 2):
        for b in (jbatcher, batcher, clean):
            b.set_epoch(epoch)
        want, got, plain = list(jbatcher), list(batcher), list(clean)
        assert len(got) == len(want) > 2
        for i, (g, w) in enumerate(zip(got, want)):
            for name in FIELDS:
                gv, wv = getattr(g, name), getattr(w, name)
                assert gv.dtype == wv.dtype, (i, name)
                np.testing.assert_array_equal(gv, wv, err_msg=f"epoch {epoch} batch {i} {name}")
        last = got[-1]
        real = int(last.row_valid.sum())
        assert 0 < real < len(last.row_valid) and not last.x[real:].any()  # padded after the noise
        # the augmentation moved the windows and noised the inputs, not the targets' values
        assert not np.array_equal(got[0].x, plain[0].x)


def _staged(augment=None, device="cpu"):
    rng = np.random.default_rng(3)
    arrays = [rng.normal(5.0, 2.0, (T, 4)).astype(np.float32) for T in (40, 31, 52)]
    masks = [(rng.random(a.shape) > 0.1).astype(np.float32) for a in arrays]
    marks = [rng.normal(size=(a.shape[0], 3)).astype(np.float32) for a in arrays]
    staged = dw.stage_windows(arrays, masks, 12, 5, 2, "recursive", recursive_pred_len=5,
                              marks=marks, static=rng.normal(size=(4, 2)).astype(np.float32),
                              sigma_vector=np.full(4, 0.1, np.float32), augment=augment,
                              device=device)
    return staged, arrays, masks, marks


def _windows_at(staged, arrays, masks, marks, idx, starts):
    """The clean windows of flat indices ``idx`` at ``starts``, from the
    fold arrays themselves."""

    offsets = staged.offsets.numpy()
    src = np.searchsorted(offsets, idx, side="right") - 1
    series = (idx - offsets[src]) % staged.num_series
    L, H = staged.input_len, staged.horizon
    out = {k: [] for k in ("x", "y", "mask", "x_mark", "y_mark")}
    for f, s, t in zip(src, series, starts):
        out["x"].append(arrays[f][t:t + L, s, None])
        out["y"].append(arrays[f][t + L:t + L + H, s, None])
        out["mask"].append(masks[f][t + L:t + L + H, s, None])
        out["x_mark"].append(marks[f][t:t + L])
        out["y_mark"].append(marks[f][t + L:t + L + H])
    return {k: np.stack(v) for k, v in out.items()}, src


def test_resident_shift_stays_in_bounds_and_gathers_the_shifted_window():
    staged, arrays, masks, marks = _staged({"time_shift": 3})
    idx = np.arange(staged.total, dtype=np.int32)  # every window, the first and last of each fold
    gen = torch.Generator().manual_seed(1)
    mirror = torch.Generator().manual_seed(1)
    got = dw.gather_batch(staged, torch.from_numpy(idx), torch.ones(len(idx)), with_y_mark=True,
                          generator=gen)
    delta = torch.randint(-3, 4, idx.shape, generator=mirror, dtype=torch.int32).numpy()
    offsets = staged.offsets.numpy()
    src = np.searchsorted(offsets, idx, side="right") - 1
    base = (idx - offsets[src]) // staged.num_series * staged.stride
    last = staged.max_start.numpy()[src]
    starts = np.clip(base + delta, 0, last)
    assert delta.min() == -3 and delta.max() == 3
    assert (starts != base + delta).any()  # some shifts were clipped, at both ends
    assert ((base + delta < 0) & (starts == 0)).any() and ((base + delta > last)
                                                           & (starts == last)).any()
    assert (np.abs(starts - base) <= 3).all() and (starts >= 0).all() and (starts <= last).all()
    want, _ = _windows_at(staged, arrays, masks, marks, idx, starts)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    assert torch.equal(gen.get_state(), mirror.get_state())  # one draw, of the shifts only


def test_resident_noise_statistics_and_padded_rows():
    std = 0.25
    staged, arrays, masks, marks = _staged({"add_noise_std": std, "time_shift": 1})
    clean = dw.strip_augment(staged)
    assert clean.X is staged.X and (clean.noise_std, clean.time_shift) == (0.0, 0)
    idx = np.resize(np.arange(staged.total, dtype=np.int32), 2048)
    rv = np.ones(len(idx), np.float32)
    rv[-37:] = 0.0
    gen = torch.Generator().manual_seed(2)
    got = dw.gather_batch(staged, torch.from_numpy(idx), torch.from_numpy(rv), with_y_mark=True,
                          generator=gen)
    # the same shifts, without the noise: the clean window at each shifted start
    mirror = torch.Generator().manual_seed(2)
    delta = torch.randint(-1, 2, idx.shape, generator=mirror, dtype=torch.int32).numpy()
    offsets = staged.offsets.numpy()
    src = np.searchsorted(offsets, idx, side="right") - 1
    base = (idx - offsets[src]) // staged.num_series * staged.stride
    starts = np.clip(base + delta, 0, staged.max_start.numpy()[src])
    want, _ = _windows_at(staged, arrays, masks, marks, idx, starts)
    real = rv > 0
    noise = (got["x"].numpy() - want["x"])[real].astype(np.float64).ravel()
    n = noise.size
    assert abs(noise.mean()) <= 4 * std / np.sqrt(n), noise.mean()
    assert abs(noise.std() / std - 1.0) <= 0.05, noise.std()
    np.testing.assert_array_equal(got["y"].numpy()[real], want["y"][real])  # targets: no noise
    for key in ("x", "y", "mask", "x_mark", "y_mark", "static", "ids", "floor"):
        if key != "floor":  # the floor follows the series id, 0 on a padded row
            assert not got[key][~torch.from_numpy(real)].any(), key


def test_zero_augmentation_equals_none_and_draws_nothing():
    none, *_ = _staged(None)
    zero, *_ = _staged({"add_noise_std": 0.0, "time_shift": 0})
    idx = torch.arange(none.total, dtype=torch.int32)
    rv = torch.ones(len(idx))
    rv[-3:] = 0.0
    gen = torch.Generator().manual_seed(4)
    before = gen.get_state()
    got = dw.gather_batch(zero, idx, rv, with_y_mark=True, generator=gen)
    want = dw.gather_batch(none, idx, rv, with_y_mark=True)
    assert torch.equal(gen.get_state(), before)
    for key, value in want.items():
        assert (value is None) == (got[key] is None) and (value is None
                                                          or torch.equal(got[key], value)), key
    for knob in ({"add_noise_std": 0.1}, {"time_shift": 1}):
        staged, *_ = _staged(knob)
        with pytest.raises(ValueError, match="generator"):
            dw.gather_batch(staged, idx, rv)


def _engine(dropout):
    from flow_timesnet_tpu_torch.models import timesnet

    cfg = timesnet.TimesNetConfig(input_len=12, pred_len=5, d_model=16, d_ff=32, n_layers=1,
                                  k_periods=2, kernel_set=((3, 3),), bottleneck_ratio=1.0,
                                  min_period_threshold=2, id_embed_dim=2, id_vocab=4,
                                  static_dim=2, time_features=3, dropout=dropout, mode="direct")
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    return pengine.Engine(cfg, params, device="cpu", use_loss_masking=True, num_series=4)


def test_probe_and_evaluation_see_clean_windows_and_the_epoch_draws_in_order():
    staged, *_ = _staged(AUGMENT)
    clean = dw.strip_augment(staged)
    plan, rv = dw.epoch_index_plan(staged.total, 16, shuffle=True, drop_last=False,
                                   rng=np.random.default_rng(0))
    eng = _engine(dropout=0.2)
    got = eng.collect_period_telemetry_staged(None, staged, plan[0], rv[0])
    want = eng.collect_period_telemetry_staged(None, clean, plan[0], rv[0])
    assert got.keys() == want.keys() and got
    for block, info in got.items():
        for key, value in info.items():
            np.testing.assert_array_equal(value, want[block][key], err_msg=f"{block} {key}")
    for key, value in eng.gather_staged_batch(staged, plan[1], rv[1]).items():
        want = eng.gather_staged_batch(clean, plan[1], rv[1])[key]
        assert value is None or torch.equal(value, want), key
    got, want = (eng.evaluate_resident(None, s, plan, rv) for s in (staged, clean))
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    # the resident epoch: each step gathers (shift, noise) and then drops out,
    # all from the one generator, as eager steps on batches gathered in turn
    eager = _engine(dropout=0.2)
    state, estate = eng.init_state(), eager.init_state()
    gen, egen = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    state, losses, _ = eng.train_epoch_resident(state, 1e-3, gen, staged, plan, rv)
    want = []
    for i, r in zip(plan, rv):
        batch = dw.gather_batch(staged, torch.from_numpy(i), torch.from_numpy(r), generator=egen)
        estate, loss, _ = eager.train_step(estate, 1e-3, egen, batch)
        want.append(loss)
    assert torch.equal(losses, torch.stack(want))
    assert torch.equal(gen.get_state(), egen.get_state())
    fresh = _engine(dropout=0.2)
    clean_losses = fresh.train_epoch_resident(fresh.init_state(), 1e-3,
                                              torch.Generator().manual_seed(9), clean, plan, rv)[1]
    assert not torch.equal(clean_losses, losses)


def _record_host(monkeypatch, engine_cls, log):
    step, evaluate = engine_cls.train_step, engine_cls.evaluate

    def train_step(self, *args, **kwargs):
        out = step(self, *args, **kwargs)
        log["losses"].append(float(np.asarray(out[1])))
        return out

    def evaluate_(self, *args, **kwargs):
        out = evaluate(self, *args, **kwargs)
        log["metrics"].append((float(out["nll"]), float(out["smape"])))
        return out

    monkeypatch.setattr(engine_cls, "train_step", train_step)
    monkeypatch.setattr(engine_cls, "evaluate", evaluate_)


def test_train_once_on_the_host_pipeline_with_augmentation_matches_jax(monkeypatch, tmp_path):
    from make_demand_benchmark import write_benchmark

    write_benchmark(str(tmp_path / "data"), seed=7, n_stores=2, n_menus=2, t_train=110)
    cfg = demand_config(tmp_path / "data" / "train.csv", epochs=2)
    cfg["data"]["augment"] = {"add_noise_std": 0.05, "time_shift": 2}
    cfg["model"]["n_layers"] = 1
    cfg["train"].update(input_pipeline="host", freeze_periods=False)
    logs = {}
    for side, eng_cls, train_mod in (("jax", jengine.Engine, jtrain),
                                     ("port", pengine.Engine, ptrain)):
        log = logs[side] = {"losses": [], "metrics": []}
        run = copy.deepcopy(cfg)
        run["artifacts"]["dir"] = str(tmp_path / side)
        with monkeypatch.context() as m:
            _record_host(m, eng_cls, log)
            if side == "jax":
                init_state = jengine.Engine.init_state

                def capture(self, *args, **kwargs):
                    state = init_state(self, *args, **kwargs)
                    logs["init"] = jax.tree_util.tree_map(np.asarray, state.params)
                    return state

                m.setattr(jengine.Engine, "init_state", capture)
            else:
                m.setattr(convert, "init_params",
                          lambda tn_cfg, generator: convert.params_from_jax(logs["init"], tn_cfg))
            log["result"] = train_mod.train_once(run)
    want, got = logs["jax"], logs["port"]
    assert got["result"][1]["metrics"]["input_pipeline"] == "host"
    assert len(got["losses"]) == len(want["losses"]) > 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["metrics"], want["metrics"], rtol=1e-4)
    assert got["result"][0] == pytest.approx(want["result"][0], rel=1e-4)
