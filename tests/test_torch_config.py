"""The port's config layer (``config.py``, ``build.py`` and the YAML subset
of ``utils/yaml_subset.py``) against the JAX package's and PyYAML.

- Every shipped ``configs/*.yaml`` reads to what ``yaml.safe_load`` reads.
- Plain scalars resolve as PyYAML's YAML 1.1 resolver does (``1e-3`` a
  string, ``1.0e-5`` a float, ``on``/``off``/``yes``/``no`` booleans, ``~``
  None, octal, hexadecimal, sexagesimal, dates), on a table of cases.
- ``PipelineConfig.from_mapping(m).to_dict()`` (and ``describe``) equals the
  JAX package's for every shipped pipeline config.
- ``apply_overrides`` agrees on a table of dotted overrides, and both
  packages raise the same aggregated validation error on
  ``window.input_len=-3``.
- ``timesnet_config_from_dict`` gives the JAX package's fields (less
  ``use_pallas``), and ``merged_config_from_yaml`` / ``time_feature_dim_of``
  agree.
- The writer behind ``save_yaml`` round-trips through ``yaml.safe_load``,
  awkward strings and floats included.
"""

import dataclasses
import math
from pathlib import Path

import pytest

yaml = pytest.importorskip("yaml")
pytest.importorskip("jax")

from flow_timesnet_tpu import build as jbuild  # noqa: E402
from flow_timesnet_tpu import config as jconfig  # noqa: E402
from flow_timesnet_tpu_torch import build as pbuild  # noqa: E402
from flow_timesnet_tpu_torch import config as pconfig  # noqa: E402
from flow_timesnet_tpu_torch.utils import yaml_subset  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))
PIPELINES = [p for p in CONFIGS if not p.name.startswith("search_space")]


def same(a, b):
    """Equal values of equal types (NaN equal to NaN)."""

    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_every_shipped_config_is_checked():
    assert len(CONFIGS) >= 10 and len(PIPELINES) >= 5


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_equals_safe_load(path):
    text = path.read_text(encoding="utf-8")
    assert same(pconfig.load_yaml(str(path)), yaml.safe_load(text))


SCALARS = ["1e-3", "1.0e-5", "1.0e5", "-1.5E+3", "3.", ".5", "1_000.5", "on", "Off", "YES",
           "no", "true", "False", "~", "null", "NULL", "", "0", "-0", "+5", "017", "0o17",
           "0x1F", "0b101", "1_000", "1:20", "-1:30:00", "1.5:3", ".inf", "-.Inf", ".NaN",
           "2024-01-01", "2024-01-01 10:00:00", "2024-1-1", "tpu", "utf-8-sig", "a#b",
           "foo # comment", "'a''b'", '"x\\ty\\u00e9"', "'on'", '"1e-3"', "[3, [5, 5]]",
           "{type: cosine, eta_min: 1.0e-5}", "{a: , b: [1, {c: d}]}", "[]", "{}",
           "영업일자", "a: b", "k:\n- 1\n- [2, 3]\n", "- a: 1\n  b: 2\n- c\n",
           "k:\n  - x\n  - y: 1\n    z: 2\n"]


@pytest.mark.parametrize("text", SCALARS)
def test_plain_and_flow_values_resolve_as_pyyaml_does(text):
    assert same(yaml_subset.loads(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", ["&a 1", "*a", "!!str 1", "k: |\n  x\n", "--- 1", "k: [1,"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        yaml_subset.loads(text)


@pytest.mark.parametrize("path", PIPELINES, ids=lambda p: p.name)
def test_pipeline_config_equals_jax(path):
    want = jconfig.PipelineConfig.from_files(str(path))
    got = pconfig.PipelineConfig.from_files(str(path))
    assert same(got.to_dict(), want.to_dict())
    assert yaml.safe_load(got.describe()) == yaml.safe_load(want.describe())
    for section in ("window", "model", "data", "train"):
        assert dataclasses.asdict(getattr(got, section)) == dataclasses.asdict(
            getattr(want, section)), section


OVERRIDES = [
    ["train.epochs=3"],
    ["train.lr=1e-3", "train.device=cpu"],
    ["train.lr=1.0e-3"],
    ["model.kernel_set=[[3, 3], [5, 5]]"],
    ["train.lr_scheduler={type: cosine, eta_min: 1.0e-6}"],
    ["train.freeze_periods=off", "predict.freeze_periods=auto"],
    ["data.augment.add_noise_std=0.1", "data.augment.time_shift=2"],
    ["model.period_buckets=null", "model.static_proj_dim=~"],
    ["artifacts.dir=/tmp/x y", "noequals", "new.section.key=yes"],
    ["window.input_len=21", "model.input_len=7"],
    ["data.date_col=영업일자"],
    ["train.val.rolling_folds=2", "train.val.strategy=holdout"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: " ".join(o))
def test_apply_overrides_agrees(overrides):
    base = jconfig.load_yaml(str(REPO / "configs" / "demand_benchmark.yaml"))
    want = jconfig.apply_overrides(base, overrides)
    got = pconfig.apply_overrides(base, overrides)
    assert same(got, want)
    assert same(pconfig.PipelineConfig.from_mapping(got).to_dict(),
                jconfig.PipelineConfig.from_mapping(want).to_dict())


def test_the_validation_error_is_the_same():
    path = str(REPO / "configs" / "demand_benchmark.yaml")
    errors = []
    for module in (jconfig, pconfig):
        with pytest.raises(ValueError) as err:
            module.PipelineConfig.from_files(path, overrides=["window.input_len=-3"])
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert "window.input_len must be positive" in errors[1]


@pytest.mark.parametrize("path", PIPELINES, ids=lambda p: p.name)
def test_timesnet_config_from_dict_agrees(path):
    want_cfg = jbuild.merged_config_from_yaml(str(path))
    got_cfg = pbuild.merged_config_from_yaml(str(path))
    assert same(got_cfg, want_cfg)
    kw = dict(static_dim=5, time_feature_dim=pbuild.time_feature_dim_of(got_cfg), id_vocab=192)
    assert kw["time_feature_dim"] == jbuild.time_feature_dim_of(want_cfg)
    want = dataclasses.asdict(jbuild.timesnet_config_from_dict(want_cfg, **kw))
    got = dataclasses.asdict(pbuild.timesnet_config_from_dict(got_cfg, **kw))
    assert want.pop("use_pallas") is False
    assert got == want


def test_writer_round_trips_through_safe_load(tmp_path):
    cfg = pconfig.PipelineConfig.from_files(str(REPO / "configs" / "default.yaml")).to_dict()
    cfg["odd"] = {"strings": ["1e-3", "on", "", "~", "null", "0x10", "2024-01-01", "a\u2028b",
                              "\ufeffx", "tab\there", "quote\"'\\", "# not a comment", "-", "[x"],
                  "floats": [1e-5, 1e20, -0.0, 3.0, 1.5e-300, float("inf"), -float("inf")],
                  "nested": [[[7, 3, True], [14, 2, False]]], "empty": {}, "none": None,
                  1: "int key", True: "bool key", "영업": "일자"}
    path = tmp_path / "config_used.yaml"
    pconfig.save_yaml(cfg, str(path))
    text = path.read_text(encoding="utf-8")
    assert same(yaml.safe_load(text), cfg)
    assert same(pconfig.load_yaml(str(path)), cfg)


@pytest.mark.parametrize("ladder", ["auto", "[7, 14]", "'7 14'", "off"])
def test_timesnet_config_from_dict_agrees_with_period_buckets(ladder):
    """A recipe that sets ``model.period_buckets`` builds the JAX package's
    model config in the port (the ladder is a tuple in the port's, which a
    frozen dataclass needs to hash)."""

    path = str(REPO / "configs" / "demand_benchmark.yaml")
    overrides = [f"model.period_buckets={ladder}"]
    want_cfg = jconfig.apply_overrides(jbuild.merged_config_from_yaml(path), overrides)
    got_cfg = pconfig.apply_overrides(pbuild.merged_config_from_yaml(path), overrides)
    assert same(got_cfg, want_cfg)
    kw = dict(static_dim=5, time_feature_dim=pbuild.time_feature_dim_of(got_cfg), id_vocab=192)
    want = dataclasses.asdict(jbuild.timesnet_config_from_dict(want_cfg, **kw))
    got = dataclasses.asdict(pbuild.timesnet_config_from_dict(got_cfg, **kw))
    assert want.pop("use_pallas") is False
    if isinstance(want["period_buckets"], list):
        want["period_buckets"] = tuple(want["period_buckets"])
    assert got == want and got["period_buckets"] not in (None, "")
