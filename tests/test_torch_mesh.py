"""``flow_timesnet_tpu_torch/parallel/mesh.py``: batch sharding, the
frozen-spec broadcast, the row-sharded table and the rank launcher.

The helpers without a group run in this process; those of a group on two
gloo ranks on the CPU (``tests/torch_dp_worker.py``). The JAX package's
``parallel/mesh.py`` is the model: ``sync_frozen_spec``'s encoding and its
identity at one process, ``shard_train_state``'s slices, ``make_mesh``'s
check of ``dcn_slices``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp_worker as worker  # noqa: E402

from flow_timesnet_tpu_torch.data.windows import WindowBatch, pad_batch_rows  # noqa: E402
from flow_timesnet_tpu_torch.parallel import mesh  # noqa: E402

SPEC = (((7, 4, True), (27, 1, True)), ((7, 4, True), (14, 2, False)))


@pytest.mark.parametrize("batch,n,want", [(256, 1, 256), (256, 2, 256), (256, 3, 258),
                                          (30, 4, 32), (512, 4, 512), (5, 4, 8)])
def test_dp_batch_rows(batch, n, want):
    assert mesh.dp_batch_rows(batch, n) == want


def _window_batch(B, seed=0):
    b = worker.make_batch(B, seed)
    return WindowBatch(x=b["x"], y=b["y"], mask=b["mask"], x_mark=b["x_mark"], y_mark=None,
                       static=b["static"], series_ids=b["ids"], row_valid=b["row_valid"])


def test_shard_rows_takes_contiguous_rows_of_a_padded_batch():
    """B=5 padded to 8 over 4 ranks: rank r takes rows [2r, 2r + 2); the last
    rank holds only padding (row_valid 0, zero rows, series id 0)."""

    batch = pad_batch_rows(_window_batch(5), mesh.dp_batch_rows(5, 4))
    parts = [mesh.shard_rows(batch, r, 4) for r in range(4)]
    for r, part in enumerate(parts):
        assert isinstance(part, WindowBatch) and part.y_mark is None
        np.testing.assert_array_equal(part.x, batch.x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(part.series_ids, batch.series_ids[2 * r:2 * r + 2])
    assert parts[3].row_valid.tolist() == [0.0, 0.0] and not parts[3].x.any()
    assert parts[2].row_valid.tolist() == [1.0, 0.0]
    # a mapping too, scalars and None kept
    d = mesh.shard_rows({"x": batch.x, "ids": batch.series_ids, "floor": None, "lr": 1.0}, 1, 4)
    assert d["x"].shape[0] == 2 and d["floor"] is None and d["lr"] == 1.0


def test_shard_rows_refuses_an_indivisible_batch():
    with pytest.raises(ValueError, match="do not divide"):
        mesh.shard_rows({"x": np.zeros((5, 3))}, 0, 4)


def test_without_a_group_every_helper_is_the_identity():
    assert mesh.current() is None and mesh.world() == 1 and mesh.rank() == 0
    assert mesh.is_main() and mesh.graphs_allowed() and not mesh.grouped()
    batch = _window_batch(6)
    assert mesh.shard_rows(batch) is batch
    t = torch.arange(6.0)
    assert mesh.all_sum_(t) is t and mesh.gather_rows(t) is t
    assert mesh.agree([1.5]) == [1.5] and mesh.broadcast_object({"a": 1}) == {"a": 1}
    plan = np.arange(12).reshape(3, 4)
    assert mesh.plan_columns(plan) is plan
    mesh.barrier()


def test_sync_frozen_spec_is_the_identity_at_one_process():
    assert mesh.sync_frozen_spec(None, n_layers=2, k=2) is None
    assert mesh.sync_frozen_spec(SPEC, n_layers=2, k=2) is SPEC


def test_shard_train_state_slices_the_table_and_its_moments():
    table = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    named = {mesh.TABLE_NAME: table, "mu_head.kernel": np.ones((4, 1), np.float32)}
    for r in range(4):
        part = mesh.shard_train_state(named, (mesh.TABLE_NAME,), r, 4)
        np.testing.assert_array_equal(part[mesh.TABLE_NAME], table[2 * r:2 * r + 2])
        assert part["mu_head.kernel"] is named["mu_head.kernel"]
    # nothing sharded: every tensor as it was
    assert mesh.shard_train_state(named, (), 1, 4)[mesh.TABLE_NAME] is table
    # a world of one holds the whole table
    np.testing.assert_array_equal(mesh.shard_train_state(named)[mesh.TABLE_NAME], table)


@pytest.mark.parametrize("n,dcn,ok", [(4, 2, True), (4, 1, True), (8, 4, True), (3, 2, False),
                                      (2, 4, False)])
def test_dcn_slices_must_divide_the_world(n, dcn, ok):
    if ok:
        assert mesh.check_dcn(n, dcn) == dcn
    else:
        with pytest.raises(ValueError, match="DCN slices"):
            mesh.check_dcn(n, dcn)


def test_plan_columns_need_a_group_of_several():
    assert mesh.rank_rows(8, 3, 4) == slice(6, 8)
    assert mesh.rank_rows(8, 0, 1) == slice(0, 8)


@pytest.fixture(scope="module")
def two_ranks():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[0], [9], [3], [5], [5], [4], [1], [8]], np.int64)  # both halves, repeats
    ct = rng.standard_normal((8, 1, 4)).astype(np.float32)
    bad = ((SPEC[0][0],), SPEC[1])  # one slot short in layer 0
    return mesh.launch(worker.mesh_helpers, 2, SPEC, bad, table, ids, ct, threads=1)


def test_sync_frozen_spec_broadcasts_rank_0s_spec(two_ranks):
    for out in two_ranks:
        assert out["synced"] == SPEC
        assert out["none"] is None  # rank 0's slot count disagrees: no spec anywhere


def test_agree_gather_and_broadcast(two_ranks):
    for out in two_ranks:
        assert out["agree"] == [0.5, 2.0]
        np.testing.assert_array_equal(out["gather"], np.repeat([[0.0] * 3, [1.0] * 3], 2, axis=0))
        assert out["object"] == {"rank": 0}


def test_sharded_lookup_equals_the_whole_table(two_ranks):
    """Forward bit for bit; the shard's gradient equals its rows of the
    replicated table's gradient summed over the ranks."""

    for out in two_ranks:
        np.testing.assert_array_equal(out["lookup"], out["lookup_ref"])
        np.testing.assert_allclose(out["grad"], out["grad_ref"], rtol=1e-6, atol=1e-7)
    assert two_ranks[0]["grad"].shape == (5, 4)


def test_a_failing_rank_fails_the_launch():
    from torch.multiprocessing import ProcessRaisedException

    with pytest.raises(ProcessRaisedException, match="rank 1 fails"):
        mesh.launch(worker.fail_on_rank, 2, 1, threads=1)


def test_several_cards_without_a_group_name_both_ways_to_launch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4") as err:
        mesh.check_launch({"data_parallel": "auto"}, cuda, "train", "train")
    assert "flow_timesnet_tpu_torch.cli train" in str(err.value)
    for off in ("off", False, "false"):
        mesh.check_launch({"data_parallel": off}, cuda, "predict", "predict")
    mesh.check_launch({}, torch.device("cpu"), "train", "train")  # the CPU is one device


def test_a_sharded_train_state_round_trips_through_its_file(tmp_path):
    """``train.save_train_state`` / ``train.resume`` with the table
    row-sharded over two ranks: the file holds the whole table (what one
    process writes), and loading gives every rank its rows back, moments
    and EMA included, bit for bit."""

    from flow_timesnet_tpu_torch import convert
    from flow_timesnet_tpu_torch.models.timesnet import TimesNetConfig

    cfg = TimesNetConfig(**worker.TINY)
    params = {k: v.numpy() for k, v in
              convert.init_params(cfg, torch.Generator().manual_seed(0)).items()}
    path = str(tmp_path / "state.msgpack")
    out = mesh.launch(worker.train_state_round_trip, 2, params, worker.make_batch(16), path,
                      threads=1)
    for r in out:
        assert r["same"] and r["extra"] == {"epoch": 2}
        assert tuple(r["stored"]) == (worker.TINY["id_vocab"], worker.TINY["id_embed_dim"])
        assert r["rows"] == worker.TINY["id_vocab"] // 2
