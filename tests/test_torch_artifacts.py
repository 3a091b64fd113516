"""The port's artifacts (``utils/artifacts.py``, ``utils/msgpack_codec.py``,
``utils/metadata.py``) against the JAX package's.

- A checkpoint the port writes is flax's file byte for byte, loads with
  ``flow_timesnet_tpu.utils.artifacts.load_checkpoint``, and the JAX
  forward on it equals the port's within 1e-4; a checkpoint the JAX package
  writes loads in the port, and the port's forward on it equals JAX's.
- The codec reads and writes MessagePack as the ``msgpack`` package does
  (integers of every width, floats, strings and bytes of every header
  size, nested containers, numpy arrays and scalars).
- The port's training state round-trips bit for bit (parameters, AdamW
  moments and step counts, EMA, the loop's counters), into the same tensors.
- The schema artifact, the scaler pickle and the metadata artifact are read
  by the other package; ``validate_normalization_config`` agrees.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")

from port_helpers import MODEL_KW, flat_params, init_tree, model_inputs  # noqa: E402

from flow_timesnet_tpu.data.schema import DataSchema as JSchema  # noqa: E402
from flow_timesnet_tpu.models import timesnet as jtn  # noqa: E402
from flow_timesnet_tpu.utils import artifacts as jart  # noqa: E402
from flow_timesnet_tpu.utils import metadata as jmeta  # noqa: E402
from flow_timesnet_tpu_torch import convert  # noqa: E402
from flow_timesnet_tpu_torch import engine as pengine  # noqa: E402
from flow_timesnet_tpu_torch.data.schema import DataSchema as PSchema  # noqa: E402
from flow_timesnet_tpu_torch.models import timesnet  # noqa: E402
from flow_timesnet_tpu_torch.utils import artifacts as part  # noqa: E402
from flow_timesnet_tpu_torch.utils import metadata as pmeta  # noqa: E402
from flow_timesnet_tpu_torch.utils import msgpack_codec  # noqa: E402

ARGS = ("x", "x_mark", "static", "ids", "floor")
CFG = timesnet.TimesNetConfig(**MODEL_KW)


@pytest.fixture(scope="module")
def tree():
    return init_tree()


def _jax_forward(tree, inp):
    model = jtn.TimesNet(jtn.TimesNetConfig(**MODEL_KW))
    rate, disp = jax.jit(lambda p, x, m, s, i, f: model.apply(
        {"params": p}, x, m, s, i, dispersion_floor=f))(tree, *(inp[k] for k in ARGS))
    return np.asarray(rate), np.asarray(disp)


def _port_forward(state_dict, inp):
    model = timesnet.TimesNet(CFG)
    model.load_state_dict(state_dict)
    with torch.inference_mode():
        rate, disp = model.eval()(*(torch.from_numpy(inp[k]) for k in ARGS))
    return rate.numpy(), disp.numpy()


def _aux():
    return {"min_sigma_effective": np.float32(0.05),
            "min_sigma_vector": np.linspace(0.05, 0.1, 6, dtype=np.float32).reshape(1, 1, -1)}


def test_a_port_checkpoint_is_the_jax_file_and_serves_in_jax(tree, tmp_path):
    state_dict = convert.params_from_jax(tree, CFG)
    port_file, jax_file = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    part.save_checkpoint(str(port_file), convert.params_to_jax(state_dict, CFG), _aux())
    jart.save_checkpoint(str(jax_file), tree, _aux())
    assert port_file.read_bytes() == jax_file.read_bytes()
    params, aux = jart.load_checkpoint(str(port_file))
    np.testing.assert_array_equal(aux["min_sigma_vector"], _aux()["min_sigma_vector"])
    assert float(aux["min_sigma_effective"]) == pytest.approx(0.05)
    inp = model_inputs(3)
    for got, want in zip(_jax_forward(params, inp), _port_forward(state_dict, inp)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_a_jax_checkpoint_serves_in_the_port(tree, tmp_path):
    path = tmp_path / "timesnet.msgpack"
    jart.save_checkpoint(str(path), jax.tree_util.tree_map(jax.numpy.asarray, tree), _aux())
    params, aux = part.load_checkpoint(str(path))
    assert sorted(aux) == ["min_sigma_effective", "min_sigma_vector"]
    assert flat_params(params).keys() == flat_params(tree).keys()
    inp = model_inputs(4)
    got = _port_forward(convert.params_from_jax(params, CFG), inp)
    for g, w in zip(got, _jax_forward(tree, inp)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


VALUES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
          -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, 0.5, -1e300, float("inf"),
          True, False, None, "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65536,
          "영업일자", b"", b"x" * 255, b"y" * 256, b"z" * 65536, list(range(15)),
          list(range(16)), list(range(65536)), {f"{i:02d}": i for i in range(15)},
          {f"{i:02d}": i for i in range(16)}, {"nested": [[1, [2.5, {"k": None}]]]}]


@pytest.mark.parametrize("value", VALUES, ids=lambda v: repr(v)[:24])
def test_the_codec_is_msgpack(value):
    """(Maps in key order: the codec writes keys sorted, as a JAX tree holds them.)"""

    want = msgpack.packb(value, use_bin_type=True)
    assert msgpack_codec.packb(value) == want
    assert msgpack_codec.unpackb(want) == msgpack.unpackb(want, raw=False,
                                                         strict_map_key=False)


@pytest.mark.parametrize("arr", [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
                                 np.zeros((0, 3), np.float32), np.asarray(np.int64(7)),
                                 np.arange(6, dtype=np.int32)[::2], np.float32(1.5),
                                 np.ones((70, 70), np.float64)], ids=str)
def test_arrays_are_flax_extensions(arr):
    from flax import serialization

    tree = {"v": arr}
    assert msgpack_codec.packb(tree) == serialization.msgpack_serialize(tree)
    back = msgpack_codec.unpackb(serialization.msgpack_serialize(tree))["v"]
    np.testing.assert_array_equal(back, arr, strict=True)


@pytest.mark.parametrize("ema", [0.99, 0.0])
def test_train_state_round_trips_bit_for_bit(tree, tmp_path, ema):
    from port_helpers import torch_batch, window_batch

    def engine():
        return pengine.Engine(CFG, convert.params_from_jax(tree, CFG), device="cpu",
                              use_loss_masking=True, grad_clip_norm=1.0, weight_decay=1e-6,
                              num_series=MODEL_KW["id_vocab"], ema_decay=ema)

    eng = engine()
    state = eng.init_state()
    for seed in range(2):
        state, _, _ = eng.train_step(state, 1e-3, None, torch_batch(window_batch(seed)))
    extra = {"epoch": 2, "best_nll": 1.25, "best_sel": float("inf"), "patience": 1,
             "lr_state": {"plateau_lr": 1e-3, "plateau_best": None, "plateau_bad": 0},
             "best_frozen_spec": [[[7, 3, True], [14, 2, False]]]}
    path = tmp_path / part.TRAIN_STATE_FILE
    part.save_train_state(str(path), state, extra)
    fresh = engine()
    template = fresh.init_state()
    before = [t.data_ptr() for t in template.tensors()]
    loaded, got_extra = part.load_train_state(str(path), template)
    assert got_extra == extra
    assert [t.data_ptr() for t in loaded.tensors()] == before  # loaded in place
    want = state.tensors()
    assert len(loaded.tensors()) == len(want)
    for g, w in zip(loaded.tensors(), want):
        assert torch.equal(g, w)
    # the next step from the loaded state is the next step of the original
    batch = torch_batch(window_batch(5))
    _, loss_a, _ = eng.train_step(state, 1e-3, None, batch)
    _, loss_b, _ = fresh.train_step(loaded, 1e-3, None, batch)
    assert torch.equal(loss_a, loss_b)
    # the JAX package's train_state.msgpack is not the port's
    jax_file = tmp_path / "train_state.msgpack"
    jax_file.write_bytes(msgpack_codec.packb({"version": np.asarray(1), "state": {},
                                              "extra": {}}))
    with pytest.raises(ValueError, match="train-state"):
        part.load_train_state(str(jax_file), fresh.init_state())


def test_schema_scaler_and_metadata_artifacts_cross_load(tmp_path):
    schema = PSchema.from_config({"date_col": "d", "id_col": "i", "target_col": "t"})
    norm = {"method": "zscore", "per_series": True, "eps": 1e-8}
    extras = {"time_features": {"enabled": True, "feature_dim": 4, "freq": "h",
                                "config": {"enabled": True, "features": ["hour"]}}}
    part.save_schema_artifact(str(tmp_path / "p.json"), schema, normalization=norm, extras=extras)
    jart.save_schema_artifact(str(tmp_path / "j.json"),
                              JSchema.from_config({"date_col": "d", "id_col": "i",
                                                   "target_col": "t"}),
                              normalization=norm, extras=extras)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    for loader in (jart.load_schema_artifact, part.load_schema_artifact):
        loaded, meta = loader(str(tmp_path / "p.json"))
        assert loaded.as_dict() == {"date": "d", "id": "i", "target": "t"}
        assert meta["normalization"] == norm
    for cfg in ({}, {"normalize": "zscore"}, {"normalize": "minmax"}, {"eps": 1e-3}):
        results = []
        for module in (jart, part):
            c = dict(cfg)
            try:
                module.validate_normalization_config(c, norm)
                results.append(c)
            except ValueError as err:
                results.append(str(err))
        assert results[0] == results[1]
    scaler = {"scaler": {"a": (1.0, 2.0)}, "method": "zscore", "ids": ["a"],
              "static_features": np.zeros((1, 5), np.float32), "feature_names": ["mean"],
              "time_features": extras["time_features"]}
    part.save_pickle(scaler, str(tmp_path / "scaler.pkl"))
    assert jart.load_pickle(str(tmp_path / "scaler.pkl"))["scaler"] == scaler["scaler"]
    meta = pmeta.MetadataArtifact.from_training(
        window={"input_len": 48, "pred_len": 24}, schema=schema,
        time_features=extras["time_features"], static_features={"feature_names": ["mean"]})
    pmeta.save_metadata_artifact(meta, str(tmp_path / "metadata.json"))
    assert jmeta.load_metadata_artifact(str(tmp_path / "metadata.json")).to_payload() == \
        meta.to_payload()
