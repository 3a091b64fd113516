"""The port's submission writers (``utils/submission.py``) against the JAX
package's, on the same predictions: both writers, with and without a sample
template, under ``warn_fill`` and ``error``, with new ids, unknown and
malformed row keys, missing rows and NaN cells, daily and hourly dates. The
port's CSV must be pandas' ``to_csv`` bytes, and its reader of the template
must give what ``pd.read_csv`` gives."""

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
pytest.importorskip("jax")

from flow_timesnet_tpu.utils import submission as jsub  # noqa: E402
from flow_timesnet_tpu_torch.utils import submission as psub  # noqa: E402

IDS = ["매장A_메뉴01", "매장A_메뉴02", "store b", "x,y"]


def predictions(seed, parts=2, steps=3, ids=IDS):
    """Per-file forecast frames as predict builds them: float32 rates over
    five decades (zeros and sub-1e-4 values included)."""

    rng = np.random.default_rng(seed)
    frames = []
    for p in range(parts):
        values = (10.0 ** rng.uniform(-6, 6, (steps, len(ids)))).astype(np.float32)
        values[rng.random(values.shape) < 0.2] = 0.0
        keys = [f"TEST_{p:02d}+D{d}" for d in range(1, steps + 1)]
        frames.append((keys, values))
    return frames


def row_meta(parts, steps, hourly, dated=True):
    """Both packages' row metadata: the forecast dates, daily or hourly."""

    start = np.datetime64("2024-02-27T00:00:00" if not hourly else "2024-02-28T21:00:00", "s")
    step = np.timedelta64(1, "h" if hourly else "D")
    jmeta, pmeta, order, test_parts = {}, {}, [], {}
    for p in range(parts):
        name = f"TEST_{p:02d}"
        keys = [f"{name}+D{d}" for d in range(1, steps + 1)]
        test_parts[name] = keys
        for d, key in enumerate(keys, start=1):
            stamp = start + (p * 7 + d) * step
            date = stamp if dated or d != 2 else None
            jmeta[key] = jsub.SubmissionRowMeta(name, d, None if date is None
                                                else pd.Timestamp(date))
            pmeta[key] = psub.SubmissionRowMeta(name, d, date)
            order.append(key)
    return jmeta, pmeta, order, test_parts


def contexts(tmp_path, frames, *, sample_rows=None, fmt_cfg=None, new_ids=(), ids=IDS,
             hourly=False, dated=True, drop_rows=()):
    """(JAX predictions, JAX context, port predictions, port context): the
    same per-file frames merged by each package, the sample template (when
    given) written once and read by each package's reader."""

    parts, steps = len(frames), len(frames[0][0])
    jmeta, pmeta, order, test_parts = row_meta(parts, steps, hourly, dated)
    jframes, pframes = [], []
    for keys, values in frames:
        keep = [i for i, k in enumerate(keys) if k not in drop_rows]
        jframes.append(pd.DataFrame(values[keep], columns=ids, index=[keys[i] for i in keep]))
        pframes.append(psub.Forecasts([keys[i] for i in keep], list(ids), values[keep]))
    jpreds, ppreds = jsub.merge_forecasts(jframes), psub.merge_forecasts(pframes)
    jsample = psample = None
    if sample_rows is not None:
        head, rows = sample_rows
        path = tmp_path / "sample_submission.csv"
        pd.DataFrame(rows, columns=head).to_csv(path, index=False, encoding="utf-8-sig")
        jsample = pd.read_csv(path, encoding="utf-8-sig")
        psample = psub.read_submission(str(path), encoding="utf-8-sig")
        assert [psample.key_column, *psample.columns] == list(jsample.columns)
        # a missing key cell: pandas' NaN, the port's None
        assert psample.keys == [None if k != k else k for k in jsample.iloc[:, 0]]
        np.testing.assert_array_equal(psample.values, jsample.iloc[:, 1:].to_numpy(float))
    kw = dict(row_order=order, test_parts=test_parts, ids=list(ids), new_ids=list(new_ids),
              missing_ids=[], missing_by_part={k: [] for k in test_parts},
              submission_cfg=fmt_cfg or {})
    jctx = jsub.build_submission_context(predictions=jpreds, sample_df=jsample, row_meta=jmeta,
                                         **kw)
    pctx = psub.build_submission_context(predictions=ppreds, sample_df=psample, row_meta=pmeta,
                                         **kw)
    assert pctx.output_columns == jctx.output_columns
    return jpreds, jctx, ppreds, pctx


def render_both(tmp_path, fmt, jpreds, jctx, ppreds, pctx, **writer_kw):
    """Render and write with each package; assert equal bytes; the text."""

    jout = jsub.get_submission_writer(fmt)(**writer_kw).render(jpreds, jctx)
    pout = psub.get_submission_writer(fmt)(**writer_kw).render(ppreds, pctx)
    jpath, ppath = tmp_path / "jax.csv", tmp_path / "port.csv"
    jout.to_csv(jpath, index=False, encoding="utf-8-sig")
    psub.write_submission(pout, str(ppath))
    want = jpath.read_bytes()
    assert want.startswith(b"\xef\xbb\xbf")
    assert ppath.read_bytes() == want
    return want.decode("utf-8-sig")


SAMPLE_HEAD = ["영업일자", "매장A_메뉴01", "매장A_메뉴02", "store   b", "x,y"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_sample", [True, False])
def test_row_key_writer_bytes(tmp_path, seed, with_sample):
    frames = predictions(seed)
    sample = None
    if with_sample:
        keys = ["TEST_01+D3", "TEST_00+Day 1", "test_00+2일", "TEST_00+D3", "TEST_01+D1",
                "TEST_01+ D2"]
        sample = (SAMPLE_HEAD, [[k] + [0] * 4 for k in keys])
    text = render_both(tmp_path, "row_key", *contexts(tmp_path, frames, sample_rows=sample))
    if with_sample:  # the template's own keys and headers, in its order
        assert text.splitlines()[0] == '영업일자,매장A_메뉴01,매장A_메뉴02,store   b,"x,y"'
        assert text.splitlines()[2].startswith("TEST_00+Day 1,")


@pytest.mark.parametrize("policy", ["warn_fill", "error"])
def test_unknown_and_malformed_row_keys(tmp_path, policy):
    keys = ["TEST_00+D1", "TEST_09+D1", "garbage", "", "TEST_00+D2", "TEST_00+D99"]
    sample = (SAMPLE_HEAD, [[k] + [0] * 4 for k in keys])
    args = contexts(tmp_path, predictions(3), sample_rows=sample)
    if policy == "error":
        for pkg, (preds, ctx) in ((jsub, args[:2]), (psub, args[2:])):
            with pytest.raises(KeyError, match="Missing prediction"):
                pkg.get_submission_writer("row_key")(missing_policy="error").render(preds, ctx)
        return
    text = render_both(tmp_path, "row_key", *args, default_fill_value=7.0)
    assert text.splitlines()[2] == "TEST_09+D1,7.0,7.0,7.0,7.0"


@pytest.mark.parametrize("policy", ["warn_fill", "error"])
@pytest.mark.parametrize("fmt", ["row_key", "date_menu"])
def test_missing_prediction_rows(tmp_path, policy, fmt):
    args = contexts(tmp_path, predictions(4), drop_rows=("TEST_01+D2",))
    if policy == "error":
        for pkg, (preds, ctx) in ((jsub, args[:2]), (psub, args[2:])):
            with pytest.raises(KeyError, match="TEST_01\\+D2"):
                pkg.get_submission_writer(fmt)(missing_policy="error").render(preds, ctx)
        return
    render_both(tmp_path, fmt, *args, default_fill_value=-1.5)


@pytest.mark.parametrize("hourly", [False, True])
@pytest.mark.parametrize("dated", [True, False])
def test_date_menu_writer_bytes(tmp_path, hourly, dated):
    text = render_both(tmp_path, "date_menu", *contexts(
        tmp_path, predictions(5), fmt_cfg={"date_col": "영업일자"}, hourly=hourly,
        dated=dated, new_ids=["menu_new"]))
    lines = text.splitlines()
    assert lines[0].startswith("영업일자,") and lines[0].endswith(",menu_new")
    if dated:
        assert lines[1].split(",")[0] == ("2024-02-28 22:00:00" if hourly else "2024-02-28")
    else:  # a row with no date takes its row key, and the column holds text
        assert lines[2].split(",")[0] == "TEST_00+D2"


def test_new_ids_and_nan_cells(tmp_path):
    frames = predictions(6)
    frames[0][1][0, 1] = np.nan
    text = render_both(tmp_path, "row_key", *contexts(tmp_path, frames,
                                                      new_ids=["menu_new", IDS[0]]))
    assert text.splitlines()[1].split(",")[2] == ""


def test_required_columns_and_unknown_format(tmp_path):
    frames = [(keys, values[:, :3]) for keys, values in predictions(7)]
    args = contexts(tmp_path, frames, ids=IDS[:3])
    # a sample naming a series the predictions lack
    sample = (SAMPLE_HEAD, [["TEST_00+D1", 0, 0, 0, 0]])
    full = contexts(tmp_path, frames, ids=IDS[:3], sample_rows=sample)
    for pkg, (preds, ctx) in ((jsub, full[:2]), (psub, full[2:])):
        with pytest.raises(ValueError, match="missing required columns: x,y"):
            pkg.get_submission_writer("row_key")().render(preds, ctx)
    render_both(tmp_path, "row_key_long", *args)
    for pkg in (jsub, psub):
        with pytest.raises(KeyError, match="Unknown submission writer"):
            pkg.get_submission_writer("nope")


def test_merge_forecasts_normalises_and_joins_headers():
    a = np.array([[1.0, 2.0]], np.float32)
    b = np.array([[3.0, 4.0]], np.float32)
    want = jsub.merge_forecasts([pd.DataFrame(a, columns=["menu  x", "y"], index=["p+D1"]),
                                 pd.DataFrame(b, columns=["menu_x", "z"], index=["q+D1"])])
    got = psub.merge_forecasts([psub.Forecasts(["p+D1"], ["menu  x", "y"], a),
                                psub.Forecasts(["q+D1"], ["menu_x", "z"], b)])
    assert got.columns == list(want.columns) and got.index == list(want.index)
    np.testing.assert_array_equal(got.values, want.to_numpy())
    assert got.values.dtype == want.to_numpy().dtype


def test_float_text_is_pandas(tmp_path):
    """Every float64 the writer can meet: shortest repr, NaN empty, inf."""

    rng = np.random.default_rng(8)
    values = np.concatenate([
        10.0 ** rng.uniform(-12, 20, 200), rng.standard_normal(50),
        rng.standard_normal(50).astype(np.float32).astype(np.float64),
        [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324, 1e16, 1e15, 1e-4, 1e-5, 0.1, 3333333.25],
    ]).reshape(-1, 2)
    keys = [f"r{i}" for i in range(len(values))]
    jpath, ppath = tmp_path / "jax.csv", tmp_path / "port.csv"
    frame = pd.DataFrame(values, columns=["a", "b c"])
    frame.insert(0, "key", keys)
    frame.to_csv(jpath, index=False, encoding="utf-8-sig")
    psub.SubmissionFrame("key", keys, ["a", "b c"], values).to_csv(str(ppath))
    assert ppath.read_bytes() == jpath.read_bytes()
    # read back: every value, correctly rounded (pandas' default parser may
    # differ in the last bit, its round-trip parser does not)
    back = psub.read_submission(str(ppath), encoding="utf-8-sig")
    np.testing.assert_array_equal(back.values, values)
    np.testing.assert_array_equal(back.values, pd.read_csv(
        jpath, encoding="utf-8-sig", float_precision="round_trip").iloc[:, 1:].to_numpy(float))
