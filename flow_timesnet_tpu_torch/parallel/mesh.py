"""Data parallelism over ranks, one process a card (counterpart of
``flow_timesnet_tpu/parallel/mesh.py``).

The JAX package shards the batch over a device mesh and lets XLA insert the
reductions. Here every rank is a process with one card (or one CPU, under
gloo): it holds a full replica of the parameters, except the series table
when that is row-sharded, takes its contiguous rows of every global batch
and sums what must be global over the group:

- the period selector's batch means (``models/period.py``), so that every
  rank selects the periods of the whole batch;
- the loss's count of valid elements, so that each rank divides its own sum
  by the global count and the summed gradients are the global batch's;
- the gradients, in one flat bucket a step (``engine.py``), and the clip's
  norm over a sharded table (``optim.py``);
- the evaluation sums, before the metrics are formed;
- the sharded table's lookups and their gradients (:class:`ShardedLookup`).

Every exchange is an ``all_reduce`` (a sum) or a ``broadcast``: the two
collectives that gloo takes on CUDA tensors, so that one code runs under
NCCL and under gloo. A gather is an ``all_reduce`` of a zero buffer in which
each rank fills its own slot (a sum with zeros is exact).

The group comes from ``torchrun``'s environment (:func:`setup_from_env`) or
from :func:`launch`, which spawns one rank per card (NCCL, a TCP store on
localhost) or gloo ranks on the CPU. Without a group every helper is the
identity and costs nothing (``world()`` is 1, ``rank()`` 0). ``dcn_slices``
is validated as the JAX package's 2-D mesh is (the world must divide into
that many slices); the batch is sharded over the whole world, and how the
reduction crosses nodes is NCCL's business: the numbers are the same.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import shutil
import socket
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Collection, Dict, Iterable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

TABLE_NAME = "series_embedding.embedding"  # the parameter a sharded run splits by rows
# how long a collective waits for a peer before it raises (a rank that died
# or never came): longer than any step, any evaluation and a first build
TIMEOUT = datetime.timedelta(minutes=30)


@dataclass(frozen=True)
class Mesh:
    """This process's place in the group."""

    rank: int
    world: int
    backend: str
    device: torch.device  # where this rank computes
    dcn_slices: int = 1

    @property
    def comm_device(self) -> torch.device:
        """Where host values travel: NCCL takes CUDA tensors only."""

        return self.device if self.backend == "nccl" else torch.device("cpu")

    @property
    def axes(self) -> Dict[str, int]:
        """The JAX package's mesh shape for this world."""

        if self.dcn_slices > 1:
            return {"dcn": self.dcn_slices, "data": self.world // self.dcn_slices}
        return {"data": self.world}


_MESH: Optional[Mesh] = None


def current() -> Optional[Mesh]:
    """This process's group, or None."""

    return _MESH


def world() -> int:
    m = current()
    return m.world if m is not None else 1


def rank() -> int:
    m = current()
    return m.rank if m is not None else 0


def grouped() -> bool:
    """Whether a group is active (of any size, one rank included)."""

    return current() is not None


def is_main() -> bool:
    """Rank 0, which alone logs and writes files (True without a group)."""

    return rank() == 0


def graphs_allowed() -> bool:
    """Whether a step may be captured in a CUDA graph: NCCL's collectives
    can be, gloo's cannot (under gloo the engine runs eagerly)."""

    m = current()
    return m is None or m.backend == "nccl"


def check_dcn(n_ranks: int, dcn_slices: Any) -> int:
    """``train.dcn_slices`` as an int, when the world splits into that many
    slices (as the JAX package's ``make_mesh`` demands)."""

    dcn = max(1, int(dcn_slices or 1))
    if n_ranks % dcn != 0:
        raise ValueError(f"{n_ranks} ranks cannot be split into {dcn} DCN slices")
    return dcn


def setup(rank_: int, world_: int, init_method: str, *, device: str = "cpu",
          backend: Optional[str] = None, local_rank: Optional[int] = None,
          dcn_slices: int = 1) -> Mesh:
    """Join the group as rank ``rank_`` of ``world_``.

    ``device``: ``cpu``, ``cuda`` (card ``local_rank``, made current before
    anything touches CUDA: the hand kernels launch on the current card) or
    ``cuda:N`` (ranks sharing card N). ``backend`` defaults to NCCL on a
    card and gloo on the CPU. One eager ``all_reduce`` follows, before any
    capture: NCCL creates its communicator at the first collective. On a
    card the first local rank builds the hand kernels while the others wait.
    A collective that waits longer than :data:`TIMEOUT` for a peer raises.
    The group is process-wide, as ``torch.distributed``'s own is.
    """

    global _MESH
    if _MESH is not None:
        raise RuntimeError("this process already belongs to a group")
    local = rank_ if local_rank is None else int(local_rank)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dcn = check_dcn(world_, dcn_slices)
    dist.init_process_group(backend, init_method=init_method, rank=int(rank_),
                            world_size=int(world_), timeout=TIMEOUT)
    _MESH = Mesh(int(rank_), int(world_), backend, dev, dcn)
    dist.all_reduce(torch.ones(1, device=_MESH.comm_device))
    if dev.type == "cuda":
        if local == 0:
            from ..ops import _build

            _build.build_all()
        dist.barrier()
    return _MESH


def setup_from_env(device: Optional[str] = None, dcn_slices: int = 1) -> Optional[Mesh]:
    """Join the group that ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); None where it
    describes none."""

    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return setup(int(env["RANK"]), int(env["WORLD_SIZE"]), "env://", device=device,
                 local_rank=int(env.get("LOCAL_RANK", env["RANK"])), dcn_slices=dcn_slices)


def teardown() -> None:
    """Leave the group (nothing without one)."""

    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


# -- collectives (identities without a group) -----------------------------------


def all_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the group in place; returns it."""

    if current() is not None:
        dist.all_reduce(t)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` [b, ...] (the same shape on each) stacked in rank
    order, [world * b, ...], on every rank: an ``all_reduce`` of a zero
    buffer in which each rank fills its own slot."""

    n = world()
    if n == 1:
        return t
    buf = torch.zeros((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    buf[rank()].copy_(t)
    dist.all_reduce(buf)
    return buf.reshape((n * t.shape[0],) + tuple(t.shape[1:]))


def replicate(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Rank 0's values in every rank's tensors (in place)."""

    tensors = list(tensors)
    if current() is not None:
        for t in tensors:
            dist.broadcast(t, src=0)
    return tensors


def agree(values: Sequence[float]) -> List[float]:
    """Rank 0's ``values`` on every rank: decisions (an improvement, a stop,
    a pruning) that every rank must take together."""

    m = current()
    if m is None or m.world == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=m.comm_device)
    dist.broadcast(t, src=0)
    return [float(v) for v in t.cpu().tolist()]


def broadcast_object(obj: Any) -> Any:
    """Rank 0's picklable ``obj`` on every rank."""

    m = current()
    if m is None or m.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=m.comm_device)
    return box[0]


def barrier() -> None:
    if current() is not None:
        dist.barrier()


def dp_enabled(section: Mapping[str, Any]) -> bool:
    """A config section's ``data_parallel`` (``auto``, the default, is on)."""

    return str(section.get("data_parallel", "auto")).lower() not in ("off", "false", "0", "no")


def check_launch(section: Mapping[str, Any], device: torch.device, command: str,
                 name: str) -> None:
    """Refuse to run an entry point where its data parallelism and the
    process disagree: several visible cards and no group (the message names
    both ways to launch one rank per card), or ``data_parallel`` off in a
    rank of a group of several."""

    n_cards = torch.cuda.device_count() if device.type == "cuda" else 1
    on = dp_enabled(section)
    if on and n_cards > 1 and current() is None:
        raise RuntimeError(
            f"{n_cards} cards are visible and {name}.data_parallel is on, but this process is "
            "not a rank of a group. Launch one rank per card with `python -m "
            f"flow_timesnet_tpu_torch.cli {command} ...` (it spawns them) or `torchrun "
            f"--nproc-per-node {n_cards} -m flow_timesnet_tpu_torch.cli {command} ...`; or "
            f"make one card visible (CUDA_VISIBLE_DEVICES), or set {name}.data_parallel=off.")
    if not on and world() > 1:
        raise ValueError(f"{name}.data_parallel is off, but this process is rank {rank()} of "
                         f"{world()}: run it alone")


# -- batches -----------------------------------------------------------------------


def dp_batch_rows(batch_size: int, n: Optional[int] = None) -> int:
    """The global batch padded up to a multiple of the world (JAX ``train.py``)."""

    n = world() if n is None else int(n)
    return -(-int(batch_size) // n) * n


def rank_rows(total: int, r: Optional[int] = None, n: Optional[int] = None) -> slice:
    """Rank ``r``'s contiguous rows of ``total``, which the world must divide."""

    n = world() if n is None else int(n)
    r = rank() if r is None else int(r)
    if total % n != 0:
        raise ValueError(f"{total} rows do not divide over {n} ranks: pad them "
                         "(dp_batch_rows, pad_batch_rows)")
    b = total // n
    return slice(r * b, (r + 1) * b)


def shard_rows(batch: Any, r: Optional[int] = None, n: Optional[int] = None) -> Any:
    """This rank's rows of a global batch: a mapping or a dataclass
    (``WindowBatch``) of arrays or tensors. Leaves whose leading size is the
    batch's are sliced, the rest (None, scalars) kept."""

    if (n if n is not None else world()) == 1:
        return batch
    fields = ({f.name: getattr(batch, f.name) for f in dataclasses.fields(batch)}
              if dataclasses.is_dataclass(batch) else dict(batch))
    lead = fields["x"].shape[0]
    sl = rank_rows(lead, r, n)
    out = {k: (v[sl] if v is not None and getattr(v, "ndim", 0) >= 1 and v.shape[0] == lead
               else v) for k, v in fields.items()}
    return dataclasses.replace(batch, **out) if dataclasses.is_dataclass(batch) else out


def plan_columns(plan: Any) -> Any:
    """This rank's columns of an ``[S, dp_batch_rows]`` epoch plan (the JAX
    package's ``PartitionSpec(None, axes)``)."""

    if world() == 1:
        return plan
    return plan[:, rank_rows(plan.shape[1])]


# -- the row-sharded series table -----------------------------------------------------


def local_rows(full: Any, r: Optional[int] = None, n: Optional[int] = None) -> Any:
    """Rank ``r``'s rows of a full table (the world must divide its rows)."""

    return full[rank_rows(full.shape[0], r, n)]


def shard_train_state(named: Mapping[str, Any], sharded: Collection[str] = (TABLE_NAME,),
                      r: Optional[int] = None, n: Optional[int] = None) -> Dict[str, Any]:
    """``named`` (parameters, or one AdamW moment, or the EMA, by name) with
    each tensor named in ``sharded`` cut to this rank's rows; the rest as
    they are."""

    return {k: (local_rows(v, r, n) if k in sharded else v) for k, v in named.items()}


def host_fetch(named: Mapping[str, torch.Tensor],
               sharded: Collection[str] = ()) -> Dict[str, torch.Tensor]:
    """``named`` with each sharded tensor assembled from every rank's rows,
    on every rank (a collective where a table is sharded): what a
    checkpoint of the whole model holds."""

    return {k: (gather_rows(v.detach()) if k in sharded else v.detach())
            for k, v in named.items()}


class ShardedLookup(torch.autograd.Function):
    """``table[ids]`` where each rank holds ``table``'s rows
    ``[rank * R, (rank + 1) * R)``.

    Forward: every rank's ids gathered, each rank looks up the rows it owns
    (zero elsewhere), and a sum over the group gives each id's vector to
    every rank, which keeps its own slot: a sum with zeros, so the output
    equals the replicated table's bit for bit. Backward: every rank's
    cotangents gathered the same way, each rank adds those of the ids it
    owns into its rows' gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        r, rows = rank(), int(table.shape[0])
        every = gather_rows(ids.long()[None])  # [world, *ids]
        owned = (every >= r * rows) & (every < (r + 1) * rows)
        local = torch.where(owned, every - r * rows, torch.zeros_like(every))
        vals = torch.where(owned[..., None], table[local], torch.zeros((), dtype=table.dtype,
                                                                       device=table.device))
        all_sum_(vals)
        ctx.save_for_backward(local, owned)
        ctx.rows = rows
        return vals[r].clone()

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        local, owned = ctx.saved_tensors
        every = gather_rows(ct.contiguous()[None])  # [world, *ids, D]
        mine = torch.where(owned[..., None], every, torch.zeros((), dtype=ct.dtype,
                                                                device=ct.device))
        grad = torch.zeros((ctx.rows, ct.shape[-1]), dtype=ct.dtype, device=ct.device)
        grad.index_put_((local.reshape(-1),), mine.reshape(-1, ct.shape[-1]), accumulate=True)
        return grad, None


# -- the frozen-period decision ---------------------------------------------------------


def sync_frozen_spec(spec, n_layers: int, k: int):
    """Rank 0's frozen-period spec on every rank (a collective: every rank
    calls it at the same point). The encoding is the JAX package's: one
    int32 flag, then ``n_layers * k`` slots of ``(period, freq_bin,
    valid)``; a spec whose slot count is not ``k`` a layer encodes as no
    spec, so every rank stays on the dynamic path. The identity at world 1."""

    m = current()
    if m is None or m.world == 1:
        return spec
    n_vals = int(n_layers) * int(k) * 3
    enc = torch.zeros(1 + n_vals, dtype=torch.int32)
    if spec is not None:
        flat = [int(v) for layer in spec for slot in layer for v in slot]
        if len(flat) == n_vals:
            enc[0] = 1
            enc[1:] = torch.tensor(flat, dtype=torch.int32)
    enc = enc.to(m.comm_device)
    dist.broadcast(enc, src=0)
    out = enc.cpu().tolist()
    if int(out[0]) != 1:
        return None
    vals = out[1:]
    return tuple(
        tuple((int(vals[(i * k + j) * 3]), int(vals[(i * k + j) * 3 + 1]),
               bool(vals[(i * k + j) * 3 + 2])) for j in range(int(k)))
        for i in range(int(n_layers)))


# -- launching ranks ----------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost for the group's store."""

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _rank_main(local_rank: int, fn: Callable, args: tuple, n: int, port: int, device: str,
               backend: Optional[str], dcn_slices: int, threads: Optional[int],
               out_dir: str) -> None:
    if threads:
        torch.set_num_threads(int(threads))
    setup(local_rank, n, f"tcp://localhost:{port}", device=device, backend=backend,
          dcn_slices=dcn_slices)
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{local_rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        teardown()


def launch(fn: Callable, n: int, *args: Any, device: str = "cpu", backend: Optional[str] = None,
           dcn_slices: int = 1, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``n`` ranks of a new group and return each
    rank's result, in rank order.

    Ranks are processes started with ``spawn`` (never ``fork`` once CUDA is
    up); ``fn`` and ``args`` must be picklable, and ``fn`` importable by
    name. ``device``: ``cpu`` (gloo), ``cuda`` (rank r on card r, NCCL) or
    ``cuda:N`` (every rank on card N; pass ``backend="gloo"``, as NCCL
    refuses two ranks on one card). ``threads``: torch's CPU threads a rank.
    A rank that raises ends the whole run:
    the others are stopped and this call raises.
    """

    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="ranks_")
    try:
        mp.start_processes(_rank_main, args=(fn, tuple(args), int(n), free_port(), device,
                                             backend, int(dcn_slices), threads, out_dir),
                           nprocs=int(n), join=True, start_method="spawn")
        results = []
        for r in range(int(n)):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
