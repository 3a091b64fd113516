"""Sliding-window sampling over wide [T, N] arrays (counterpart of
``flow_timesnet_tpu/data/windows.py``, numpy only).

Samples are (window, series) pairs: ``len = windows_per_series * N``,
``window = idx // N``, ``series = idx % N``, one series per sample (channel
dim 1). A batch is one vectorised numpy gather. Calendar features come from
``datetime64`` dates through ``data/time_features.py``. The shuffle draws
from ``np.random.default_rng`` exactly as the JAX package's batcher does, so
both give the same batches for the same seed and epoch. A shuffled batcher
augments its windows from the same generator, after its shuffle, as the JAX
package's does (``time_shift``: each start moved by a uniform integer in
``[-time_shift, time_shift]`` and clipped to the array; ``add_noise_std``:
Gaussian noise on the inputs), so augmented batches are the JAX package's
bit for bit too. :func:`build_batcher` assembles a batcher over per-fold
arrays as the JAX trainer does. :class:`Prefetcher` assembles the next
batches on a thread while the card steps. The native C++ gather is not
ported: numpy gathers the same values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from .time_features import build_time_features


@dataclass
class WindowBatch:
    """One batch of per-series windows."""

    x: np.ndarray  # [B, L, 1]
    y: np.ndarray  # [B, H, 1]
    mask: np.ndarray  # [B, H, 1]
    x_mark: Optional[np.ndarray]  # [B, L, F] or None
    y_mark: Optional[np.ndarray]  # [B, H, F] or None
    static: Optional[np.ndarray]  # [B, 1, Fs] or None
    series_ids: Optional[np.ndarray]  # [B, 1] int32 or None
    row_valid: np.ndarray  # [B] float32, 0 for padded rows


class SlidingWindowSource:
    """Window index bookkeeping for one contiguous wide array."""

    def __init__(
        self,
        wide_values: np.ndarray,  # [T, N]
        input_len: int,
        pred_len: int,
        mode: str,
        recursive_pred_len: int | None = None,
        augment: Dict[str, Any] | None = None,
        stride: int = 1,
        valid_mask: np.ndarray | None = None,
        series_static: np.ndarray | None = None,
        series_ids: Sequence[int] | np.ndarray | None = None,
        time_index: np.ndarray | None = None,
        time_features: np.ndarray | None = None,
        time_feature_config: Dict[str, Any] | None = None,
        time_frequency: str | None = None,
    ) -> None:
        if mode not in ("direct", "recursive"):
            raise ValueError("mode must be 'direct' or 'recursive'")
        self.X = np.asarray(wide_values, dtype=np.float32)
        if self.X.ndim != 2 or self.X.shape[1] <= 0:
            raise ValueError("wide_values must be a [T, N] array with N >= 1")
        if valid_mask is not None and np.asarray(valid_mask).shape != self.X.shape:
            raise ValueError("valid_mask must match wide_values shape")
        self.M = (
            np.ones_like(self.X, dtype=np.float32)
            if valid_mask is None
            else np.asarray(valid_mask, dtype=np.float32)
        )
        self.T, self.N = self.X.shape
        self.L = int(input_len)
        if mode == "direct":
            self.H = int(pred_len)
        else:
            self.H = int(recursive_pred_len if recursive_pred_len is not None else 1)
        self.mode = mode
        augment = augment or {}
        self.add_noise_std = float(augment.get("add_noise_std", 0.0))
        self.time_shift = int(augment.get("time_shift", 0))
        max_start = self.T - self.L - self.H
        self.stride = max(1, int(stride))
        self.starts = (
            np.zeros(0, dtype=np.int64)
            if max_start < 0
            else np.arange(0, max_start + 1, self.stride, dtype=np.int64)
        )

        self.time_feature_config = dict(time_feature_config or {})
        self.marks: Optional[np.ndarray] = None
        if time_index is not None and len(time_index) != self.T:
            raise ValueError("time_index length must match the first dimension of wide_values")
        if time_features is not None:
            feats = np.asarray(time_features, dtype=np.float32)
            if feats.ndim == 1:
                feats = feats.reshape(-1, 1)
            if feats.ndim != 2 or feats.shape[0] != self.T:
                raise ValueError("time_features must be a [T, F] array aligned with wide_values")
            if feats.shape[1] > 0:
                self.marks = feats
        elif time_index is not None and self.time_feature_config.get("enabled", False):
            feats = build_time_features(np.asarray(time_index), self.time_feature_config)
            if feats.shape[1] > 0:
                self.marks = feats.astype(np.float32)
        elif self.time_feature_config.get("enabled", False):
            raise ValueError(
                "time features enabled but no time_index or precomputed time_features provided"
            )
        self.time_feature_dim = 0 if self.marks is None else int(self.marks.shape[1])
        # the pandas alias of the time index's step (the JAX package reads
        # it off its DatetimeIndex); None where the index has none
        self.time_frequency = time_frequency if time_index is not None else None

        if series_static is not None:
            static = np.asarray(series_static, dtype=np.float32)
            if static.ndim == 1:
                static = static.reshape(-1, 1)
            if static.shape[0] != self.N:
                raise ValueError("series_static must have shape [num_series, num_features]")
            self.static = static
        else:
            self.static = None
        if series_ids is not None:
            ids_arr = np.asarray(series_ids)
            if ids_arr.ndim != 1 or ids_arr.shape[0] != self.N:
                raise ValueError("series_ids must be a 1D sequence of length num_series")
            self.series_ids = ids_arr.astype(np.int32)
        else:
            self.series_ids = None

    @property
    def windows_per_series(self) -> int:
        return int(len(self.starts))

    def __len__(self) -> int:
        return self.windows_per_series * self.N

    def gather(self, sample_idx: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> WindowBatch:
        """Assemble a batch from flat sample indices (vectorised), augmented
        from ``rng`` where it is given: the shifts are drawn before the
        gather, the noise after it, as the JAX package draws them."""

        if self.windows_per_series <= 0:
            raise IndexError("SlidingWindowSource is empty")
        series_idx = (sample_idx % self.N).astype(np.int64)
        starts = self.starts[sample_idx // self.N]
        if self.time_shift > 0 and rng is not None:
            delta = rng.integers(-self.time_shift, self.time_shift + 1, size=starts.shape)
            starts = np.clip(starts + delta, 0, self.T - self.L - self.H)
        t_in = starts[:, None] + np.arange(self.L)[None, :]
        t_out = (starts + self.L)[:, None] + np.arange(self.H)[None, :]
        x = self.X[t_in, series_idx[:, None]][..., None]
        y = self.X[t_out, series_idx[:, None]][..., None]
        mask = self.M[t_out, series_idx[:, None]][..., None]
        if self.add_noise_std > 0 and rng is not None:
            x = x + rng.standard_normal(x.shape).astype(np.float32) * self.add_noise_std
        has_marks = self.marks is not None
        return WindowBatch(
            x=x,
            y=y,
            mask=mask,
            x_mark=self.marks[t_in] if has_marks else None,
            y_mark=self.marks[t_out] if has_marks else None,
            static=self.static[series_idx][:, None, :] if self.static is not None else None,
            series_ids=(
                self.series_ids[series_idx][:, None] if self.series_ids is not None else None
            ),
            row_valid=np.ones(len(sample_idx), dtype=np.float32),
        )


class WindowBatcher:
    """Batch iterator over the concatenation of several window sources."""

    def __init__(
        self,
        sources: List[SlidingWindowSource],
        batch_size: int,
        shuffle: bool,
        drop_last: bool,
        seed: int = 0,
        pad_final: bool = False,
    ) -> None:
        self.sources = [s for s in sources if len(s) > 0]
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.pad_final = bool(pad_final)
        self._seed = int(seed)
        self._rng = np.random.default_rng(seed)
        sizes = [len(s) for s in self.sources]
        self._offsets = np.cumsum([0] + sizes)
        self.total = int(self._offsets[-1]) if sizes else 0

    def __len__(self) -> int:
        if self.total == 0:
            return 0
        if self.drop_last:
            return self.total // self.batch_size
        return (self.total + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Reseed shuffling and augmentation as a pure function of (seed,
        epoch), so an epoch's batches do not depend on how many epochs were
        already iterated."""

        self._rng = np.random.default_rng([self._seed, int(epoch)])

    @property
    def time_feature_dim(self) -> int:
        for s in self.sources:
            if s.time_feature_dim:
                return s.time_feature_dim
        return 0

    @property
    def time_frequency(self) -> Optional[str]:
        for s in self.sources:
            if s.time_frequency:
                return str(s.time_frequency)
        return None

    def _gather_global(self, idx: np.ndarray,
                       rng: Optional[np.random.Generator] = None) -> WindowBatch:
        pieces: List[WindowBatch] = []
        order = np.argsort(idx, kind="stable")
        sorted_idx = idx[order]
        source_of = np.searchsorted(self._offsets, sorted_idx, side="right") - 1
        for s_id in np.unique(source_of):
            local = sorted_idx[source_of == s_id] - self._offsets[s_id]
            pieces.append(self.sources[s_id].gather(local, rng))
        batch = _concat_batches(pieces)
        # restore the requested order
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        return _take_batch(batch, inv)

    def __iter__(self) -> Iterator[WindowBatch]:
        if self.total == 0:
            return
        order = np.arange(self.total)
        rng = self._rng if self.shuffle else None  # augmentation draws after the shuffle
        if self.shuffle:
            self._rng.shuffle(order)
        n_full = self.total // self.batch_size
        for b in range(n_full):
            yield self._gather_global(order[b * self.batch_size : (b + 1) * self.batch_size], rng)
        rem = self.total - n_full * self.batch_size
        if rem > 0 and not self.drop_last:
            batch = self._gather_global(order[n_full * self.batch_size :], rng)
            if self.pad_final and rem < self.batch_size:
                batch = pad_batch_rows(batch, self.batch_size)
            yield batch


class Prefetcher:
    """Batches from any iterable, assembled ahead on a background thread
    (the JAX package's ``Prefetcher``).

    One daemon thread takes the next ``depth`` batches from ``iterable``
    (the numpy gathers and concatenations of a ``WindowBatcher``) while the
    card runs the current step: the host pipeline's counterpart of a data
    loader's prefetch (``train.prefetch_factor``). The batches come out in
    the iterable's order. An exception raised by the producer is raised again
    where the consumer takes the next batch. :meth:`close` releases the
    producer when the consumer stops early.
    """

    _END = object()

    def __init__(self, iterable, depth: int = 2) -> None:
        import queue
        import threading

        self._queue_mod = queue
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._err: Optional[BaseException] = None
        self._stopped = False

        def _run() -> None:
            try:
                for item in iterable:
                    if self._stopped:
                        break
                    self._q.put(item)
                    if self._stopped:
                        break
            except BaseException as e:  # noqa: BLE001 - raised again at the consumer
                self._err = e
            finally:
                while not self._stopped:  # close() owns the shutdown once it is called
                    try:
                        self._q.put(self._END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=_run, name="flow-timesnet-prefetch", daemon=True)
        self._thread.start()

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Release the producer when the consumer stops before the end.

        Sets the stop flag and drains the queue, so that a producer blocked
        on a full queue wakes, sees the flag and ends; then leaves the end
        marker, so that a later ``next`` stops rather than blocks.
        """

        self._stopped = True
        self._drain()
        self._thread.join(timeout=5.0)
        self._drain()  # what the released producer put before it saw the flag
        try:
            self._q.put_nowait(self._END)
        except self._queue_mod.Full:
            pass

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except self._queue_mod.Empty:
            pass


def _map_batch(fn, batch: WindowBatch) -> WindowBatch:
    """Apply ``fn`` to every array field of ``batch`` (None stays None)."""

    return WindowBatch(**{
        name: None if value is None else fn(name, value)
        for name, value in vars(batch).items()
    })


def _concat_batches(pieces: List[WindowBatch]) -> WindowBatch:
    if len(pieces) == 1:
        return pieces[0]
    return _map_batch(
        lambda name, _: np.concatenate([getattr(p, name) for p in pieces], axis=0), pieces[0]
    )


def _take_batch(batch: WindowBatch, idx: np.ndarray) -> WindowBatch:
    return _map_batch(lambda _, v: v[idx], batch)


def pad_batch_rows(batch: WindowBatch, target: int) -> WindowBatch:
    """Pad a batch to ``target`` rows with zero-filled, row_valid=0 rows."""

    pad = target - batch.x.shape[0]
    if pad <= 0:
        return batch
    return _map_batch(lambda _, v: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1)), batch)


def build_batcher(
    arrays: List[np.ndarray],
    masks: List[Optional[np.ndarray]],
    input_len: int,
    pred_len: int,
    stride: int,
    mode: str,
    batch_size: int,
    shuffle: bool,
    drop_last: bool,
    recursive_pred_len: int | None = None,
    augment: Dict[str, Any] | None = None,
    series_static: List[Optional[np.ndarray]] | None = None,
    series_ids: List[Optional[np.ndarray]] | None = None,
    time_indices: List[Optional[np.ndarray]] | None = None,
    time_features: List[Optional[np.ndarray]] | None = None,
    time_feature_config: Dict[str, Any] | None = None,
    seed: int = 0,
    pad_final: bool = False,
    time_frequency: str | None = None,
) -> WindowBatcher:
    """Assemble a :class:`WindowBatcher` over per-fold arrays, as the JAX
    package's ``build_batcher`` does. ``time_indices`` are ``datetime64``
    arrays; ``time_frequency`` is their step's pandas alias (the JAX
    package reads it off each ``DatetimeIndex``)."""

    if len(arrays) != len(masks):
        raise ValueError("arrays and masks must have the same length")
    for name, aux in (
        ("series_static", series_static),
        ("series_ids", series_ids),
        ("time_indices", time_indices),
        ("time_features", time_features),
    ):
        if aux is not None and len(aux) != len(arrays):
            raise ValueError(f"{name} must match arrays length when provided")
    sources = [
        SlidingWindowSource(
            arr,
            input_len,
            pred_len,
            mode,
            recursive_pred_len,
            augment,
            stride=stride,
            valid_mask=msk,
            series_static=series_static[i] if series_static is not None else None,
            series_ids=series_ids[i] if series_ids is not None else None,
            time_index=time_indices[i] if time_indices is not None else None,
            time_features=time_features[i] if time_features is not None else None,
            time_feature_config=time_feature_config,
            time_frequency=time_frequency,
        )
        for i, (arr, msk) in enumerate(zip(arrays, masks))
    ]
    return WindowBatcher(
        sources,
        batch_size=batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        seed=seed,
        pad_final=pad_final,
    )
