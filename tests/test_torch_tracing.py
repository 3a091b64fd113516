"""``flow_timesnet_tpu_torch/tracing.py`` on the CPU, where the regions'
cells take ``time.perf_counter_ns()`` in place of the card's clock.

- Off is inert: one shared no-op, no spans, no region cells touched, and
  every graph key carries the tracing state.
- The traced ``pointwise_conv`` (one autograd node holding the marks) equals
  the untraced one and the plain expression bit for bit: forward, dh, dW
  and db, float32 and bf16, with and without the output type passed.
- A resident step and an eager step count their regions exactly as the
  model's structure says (remat runs the pointwise forwards twice); no two
  regions of one name overlap, and every pointwise region lies inside a
  ``step.*`` one. A traced chunk trains exactly as an untraced one.
- ``Forecaster.forecast`` gives its span tree under one request id, and under
  ``torch.profiler`` each span is a ``user_annotation`` inside ``forecast``.
- The ring keeps its bound; ``EpochTrace`` writes the spans into its trace.
"""

import json

import numpy as np
import pytest
import torch

from flow_timesnet_tpu_torch import convert, tracing
from flow_timesnet_tpu_torch.data import device_windows as dw
from flow_timesnet_tpu_torch.engine import Engine
from flow_timesnet_tpu_torch.forecaster import Forecaster
from flow_timesnet_tpu_torch.models.timesnet import TimesNetConfig
from flow_timesnet_tpu_torch.ops.fold import pointwise_conv

L, H, N, B, S = 28, 7, 6, 4, 2
# two layers of two inceptions, each with two bottlenecked branches (reduce
# and expand) plus its projection and its residual 1x1: 24 pointwise convs
KERNELS = ((3, 3), (5, 5))
POINTWISE = 2 * 2 * (2 * len(KERNELS) + 2)
STEP = ("step.forward", "step.backward", "step.optimizer")


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.enable(False)
    tracing.clear()
    tracing.clear_regions()
    yield
    tracing.enable(False)
    tracing.clear()
    tracing.clear_regions()


def _cfg(**kw):
    return TimesNetConfig(input_len=L, pred_len=H, d_model=8, d_ff=16, n_layers=2,
                          k_periods=2, kernel_set=KERNELS, bottleneck_ratio=4.0,
                          id_embed_dim=4, id_vocab=N, dropout=0.1, **kw)


def _engine(**kw):
    cfg = _cfg(**kw)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    return Engine(cfg, params, "cpu", grad_clip_norm=1.0, weight_decay=1e-4,
                  num_series=N, ema_decay=0.9)


@pytest.fixture(scope="module")
def staged():
    rng = np.random.default_rng(0)
    t = np.arange(44)[:, None]
    x = 3.0 + np.sin(2 * np.pi * t / 7 + rng.uniform(0, 6, (1, N))) + 0.2 * rng.standard_normal(
        (44, N))
    return dw.stage_windows([x.astype(np.float32)], [np.ones((44, N), np.float32)], L, H, 1,
                            "direct", device="cpu")


def _plan(staged):
    idx, rv = dw.epoch_index_plan(staged.total, B, shuffle=True, drop_last=True,
                                  rng=np.random.default_rng(1))
    return idx[:S], rv[:S]


def _resident(eng, staged):
    state = eng.init_state()
    gen = torch.Generator().manual_seed(5)
    state, losses, _ = eng.train_epoch_resident(state, 1e-3, gen, staged, *_plan(staged))
    return state, losses


def _logged(monkeypatch):
    """Every mark as ``(name, end, ns)``, in order."""

    log = []
    real = tracing._mark

    def mark(device, slot, end):
        name = next(n for n, s in tracing._slots.items() if s == slot)
        log.append((name, end, tracing.time.perf_counter_ns()))
        real(device, slot, end)

    monkeypatch.setattr(tracing, "_mark", mark)
    return log


def _intervals(log):
    open_, out = {}, {}
    for name, end, ns in log:
        if end:
            out.setdefault(name, []).append((open_.pop(name), ns))
        else:
            assert name not in open_, f"{name} opened inside itself"
            open_[name] = ns
    assert not open_
    return out


def test_off_is_inert(staged):
    assert tracing.span("a") is tracing.span("b") is tracing.region("x", "cpu")
    eng = _engine()
    _resident(eng, staged)
    assert tracing.spans() == [] and tracing.regions("cpu") == {}
    assert eng._key("forward", ())[-1] is False
    tracing.enable()
    assert eng._key("forward", ())[-1] is True


def test_tracing_off_drops_the_marked_graphs():
    eng = _engine()
    eng._graphs = {("forward", "sig", True): "marked", ("forward", "sig", False): "plain"}
    eng._marked = True
    tracing.enable()
    assert eng._graph(eng._key("forward", "sig")) == "marked" and len(eng._graphs) == 2
    tracing.enable(False)
    assert eng._graph(eng._key("forward", "sig")) == "plain"
    assert list(eng._graphs) == [("forward", "sig", False)] and not eng._marked


@pytest.mark.parametrize("cast", [False, True], ids=["fp32_out", "cast_out"])
@pytest.mark.parametrize("shape", [(27, 12), (3, 9, 12), (3, 3, 3, 12), "expanded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_traced_pointwise_equals_the_plain_expression(dtype, shape, cast):
    """Traced, untraced and the plain expression (with the caller's cast
    where the output type is passed) give the same bits: forward, dh, dW
    and db."""

    gen = torch.Generator().manual_seed(3)
    base = torch.randn(3, 9, 12, generator=gen)
    kernel0, bias0 = torch.randn(12, 20, generator=gen), torch.randn(20, generator=gen)

    def run(on, plain=False):
        tracing.enable(on)
        x = base.clone().requires_grad_()
        kernel, bias = kernel0.clone().requires_grad_(), bias0.clone().requires_grad_()
        if shape == "expanded":  # a candidate axis of stride 0, as a fold's input
            h = x[None].expand(2, 3, 9, 12).to(dtype)
        else:
            h = x.reshape(shape).to(dtype)
        if plain:
            out = h.float() @ kernel.to(h.dtype).float() + bias.float()
            out = out.to(dtype) if cast else out
        else:
            out = pointwise_conv(h, kernel, bias, dtype if cast else None)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(4)).to(out.dtype)
        out.backward(g)
        return out.detach(), x.grad, kernel.grad, bias.grad

    expr, plain, traced = run(False, plain=True), run(False), run(True)
    assert plain[0].dtype == (dtype if cast else torch.float32)
    for a, b, c in zip(expr, plain, traced):
        assert a.dtype == b.dtype == c.dtype and torch.equal(a, b) and torch.equal(a, c)
    assert {k: c for k, (c, _) in tracing.regions("cpu").items()} == {
        "pointwise.fwd": 1, "pointwise.bwd": 1}


def test_region_counts_follow_the_model(monkeypatch, staged):
    log = _logged(monkeypatch)
    tracing.enable()
    _resident(_engine(), staged)
    counts = {k: c for k, (c, _) in tracing.regions("cpu").items()}
    assert counts == {"step.gather": S, **{k: S for k in STEP},
                      "pointwise.fwd": S * POINTWISE, "pointwise.bwd": S * POINTWISE}
    spans = _intervals(log)
    for name, iv in spans.items():
        iv = sorted(iv)
        assert all(a[1] <= b[0] for a, b in zip(iv, iv[1:])), f"{name} regions overlap"
    steps = [iv for k in STEP for iv in spans[k]]
    for a, b in spans["pointwise.fwd"] + spans["pointwise.bwd"]:
        assert any(s <= a and b <= e for s, e in steps)
    assert all(s > 0 for _, s in tracing.regions("cpu").values())


def test_remat_runs_the_pointwise_forwards_twice(staged):
    tracing.enable()
    _resident(_engine(use_checkpoint=True), staged)
    counts = {k: c for k, (c, _) in tracing.regions("cpu").items()}
    assert counts["pointwise.fwd"] == 2 * S * POINTWISE
    assert counts["pointwise.bwd"] == S * POINTWISE and counts["step.backward"] == S


def test_an_eager_step_counts_its_regions(staged):
    eng = _engine()
    state = eng.init_state()
    batch = eng.gather_staged_batch(staged, *(a[0] for a in _plan(staged)))
    tracing.enable()
    eng.train_step(state, 1e-3, torch.Generator().manual_seed(1), batch)
    counts = {k: c for k, (c, _) in tracing.regions("cpu").items()}
    assert counts == {**{k: 1 for k in STEP}, "pointwise.fwd": POINTWISE,
                      "pointwise.bwd": POINTWISE}


@pytest.mark.parametrize("remat", [False, True])
def test_a_traced_chunk_trains_as_an_untraced_one(staged, remat):
    plain_state, plain_losses = _resident(_engine(use_checkpoint=remat), staged)
    tracing.enable()
    state, losses = _resident(_engine(use_checkpoint=remat), staged)
    assert torch.equal(losses, plain_losses)
    for k, p in state.params.items():
        assert torch.equal(p, plain_state.params[k]), k
        assert torch.equal(state.ema[k], plain_state.ema[k]), k
    chunks = [s for s in tracing.spans() if s.name == "train.chunk"]
    replays = [s for s in tracing.spans() if s.name == "engine.replay"]
    assert len(chunks) == 1 and len(replays) == S
    assert all(s.parent == chunks[0].id and s.request == chunks[0].id for s in replays)


def _forecaster():
    cfg = _cfg()
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    ids = [f"s{i}" for i in range(N)]
    scaler = {sid: (2.0, 0.5) for sid in ids}
    return Forecaster(params, cfg, ids, scaler, "zscore", device="cpu")


CHILDREN = ["forecast.prepare", "forecast.upload", "engine.replay", "forecast.fetch",
            "forecast.finish"]


def test_a_forecast_is_one_span_tree():
    fc = _forecaster()
    history = np.random.default_rng(0).uniform(1, 5, (L + 3, N)).astype(np.float32)
    plain = fc.forecast(history)
    tracing.enable()
    assert np.array_equal(fc.forecast(history), plain)
    spans = tracing.spans()
    root = [s for s in spans if s.name == "forecast"]
    assert len(root) == 1 and root[0].parent == 0
    children = [s for s in spans if s.parent == root[0].id]
    assert [s.name for s in sorted(children, key=lambda s: s.start_ns)] == CHILDREN
    assert all(s.request == root[0].id for s in spans)
    assert sum(s.end_ns - s.start_ns for s in children) <= root[0].end_ns - root[0].start_ns
    assert tracing.regions("cpu")["model.forward"][0] == 1


def test_spans_are_user_annotations_under_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    fc = _forecaster()
    history = np.random.default_rng(1).uniform(1, 5, (L, N)).astype(np.float32)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fc.forecast(history)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert set(CHILDREN) <= set(ann) and "forecast" in ann
    root = ann["forecast"]
    for name in CHILDREN:
        e = ann[name]
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]


def test_the_ring_keeps_its_bound():
    tracing.enable()
    for _ in range(tracing.SPAN_RING + 5):
        with tracing.span("s"):
            pass
    spans = tracing.spans()
    assert len(spans) == tracing.SPAN_RING
    assert spans[0].id + tracing.SPAN_RING - 1 == spans[-1].id
    tracing.clear()
    assert tracing.spans() == []


def test_the_epoch_trace_holds_the_program_spans(tmp_path, staged):
    eng = _engine()
    trace = tracing.EpochTrace()
    assert trace.step_regions() == ""
    trace.start(torch.device("cpu"))
    assert tracing.enabled()
    _resident(eng, staged)
    line = trace.step_regions()
    assert line.startswith(" regions_ms_a_step=") and "step.gather:" in line
    assert "pointwise:" in line
    path = trace.stop(str(tmp_path / "t" / "trace.json"))
    assert not tracing.enabled() and not torch.autograd.profiler._is_profiler_enabled
    events = json.loads(open(path).read())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"train.chunk", "engine.replay"} <= names
