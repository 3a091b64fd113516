"""Device-resident window sampling: stage once, gather inside the step
(counterpart of ``flow_timesnet_tpu/data/device_windows.py``).

Every fold's wide arrays are zero-padded to a common ``T_max``, stacked to
``[n_folds, T_max, N]`` and put on the device once. A flat sample index
enumerates ``(fold, window, series)`` as the host
:class:`~flow_timesnet_tpu_torch.data.windows.WindowBatcher` does over its
concatenated sources (``window = local // N``, ``series = local % N``,
``start = window * stride``), so both pipelines sample the same windows.
:func:`gather_batch` assembles a batch from such indices with device ops
only (no value comes back to the host), which is what lets
``Engine.train_epoch_resident`` run it inside a captured CUDA graph.
Augmentation (``add_noise_std``, ``time_shift``) draws from the torch
generator it is given, the training step's, so a graph that registers that
generator draws the next numbers at each replay; the distribution is the
host batcher's, the stream is not (as the JAX package's ``jax.random``
stream is not). :func:`strip_augment` gives the clean view that probes and
evaluation gather from.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch


@dataclass
class StagedWindows:
    """Per-split fold arrays on the device and the static window geometry."""

    X: torch.Tensor  # [F, T_max, N] values (zero rows beyond each fold's T)
    M: torch.Tensor  # [F, T_max, N] validity mask
    marks: Optional[torch.Tensor]  # [F, T_max, Fm] time features or None
    static: Optional[torch.Tensor]  # [N, Fs] or None
    sigma: Optional[torch.Tensor]  # [N] per-series dispersion floor or None
    offsets: torch.Tensor  # [F + 1] int32 cumulative flat-sample counts
    max_start: torch.Tensor  # [F] int32 last valid window start per fold

    input_len: int
    horizon: int
    stride: int
    num_series: int
    total: int
    noise_std: float = 0.0
    time_shift: int = 0

    @property
    def has_marks(self) -> bool:
        return self.marks is not None


def strip_augment(staged: StagedWindows) -> StagedWindows:
    """The augmentation-free view of ``staged`` (the same device tensors):
    what one-off probes and evaluation gather from, with no generator."""

    if staged.noise_std or staged.time_shift:
        return dataclasses.replace(staged, noise_std=0.0, time_shift=0)
    return staged


def stage_windows(
    arrays: List[np.ndarray],
    masks: List[np.ndarray],
    input_len: int,
    pred_len: int,
    stride: int,
    mode: str,
    *,
    recursive_pred_len: Optional[int] = None,
    marks: Optional[List[Optional[np.ndarray]]] = None,
    static: Optional[np.ndarray] = None,
    sigma_vector: Optional[np.ndarray] = None,
    augment: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> Optional[StagedWindows]:
    """Stack per-fold [T, N] arrays and put them on ``device``.

    Folds shorter than one window are left out; ``None`` when none is left.
    Marks are kept only when every kept fold has them. ``augment`` holds
    the host source's knobs (``add_noise_std``, ``time_shift``), which
    :func:`gather_batch` applies.
    """

    augment = augment or {}
    if mode == "direct":
        horizon = int(pred_len)
    else:
        horizon = int(recursive_pred_len if recursive_pred_len is not None else 1)
    L = int(input_len)
    step = max(1, int(stride))

    keep: List[int] = []
    wps: List[int] = []
    for i, arr in enumerate(arrays):
        max_start = int(np.asarray(arr).shape[0]) - L - horizon
        if max_start < 0:
            continue
        keep.append(i)
        wps.append(len(range(0, max_start + 1, step)))
    if not keep:
        return None

    N = int(np.asarray(arrays[keep[0]]).shape[1])
    T_max = max(int(np.asarray(arrays[i]).shape[0]) for i in keep)

    def pad_stack(mats: List[np.ndarray], width: int) -> np.ndarray:
        out = np.zeros((len(mats), T_max, width), dtype=np.float32)
        for j, m in enumerate(mats):
            m = np.asarray(m, dtype=np.float32)
            if m.ndim == 1:
                m = m.reshape(-1, 1)
            out[j, : m.shape[0], :] = m
        return out

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    X = pad_stack([np.asarray(arrays[i]) for i in keep], N)
    M = pad_stack([np.asarray(masks[i]) for i in keep], N)
    marks_stacked = None
    if marks is not None:
        kept_marks = [marks[i] for i in keep]
        if all(m is not None and np.asarray(m).shape[1] > 0 for m in kept_marks):
            Fm = int(np.asarray(kept_marks[0]).shape[1])
            marks_stacked = pad_stack([np.asarray(m) for m in kept_marks], Fm)

    counts = np.asarray([w * N for w in wps], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    max_start_arr = np.asarray(
        [int(np.asarray(arrays[i]).shape[0]) - L - horizon for i in keep], dtype=np.int32
    )
    has_static = static is not None and np.asarray(static).size
    return StagedWindows(
        X=put(X),
        M=put(M),
        marks=put(marks_stacked) if marks_stacked is not None else None,
        static=put(np.asarray(static, dtype=np.float32)) if has_static else None,
        sigma=(put(np.asarray(sigma_vector, dtype=np.float32).reshape(-1))
               if sigma_vector is not None else None),
        offsets=put(offsets),
        max_start=put(max_start_arr),
        input_len=L,
        horizon=horizon,
        stride=step,
        num_series=N,
        total=int(offsets[-1]),
        noise_std=float(augment.get("add_noise_std", 0.0)),
        time_shift=int(augment.get("time_shift", 0)),
    )


def gather_batch(
    staged: StagedWindows,
    flat_idx: torch.Tensor,
    row_valid: torch.Tensor,
    *,
    with_y_mark: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """One batch from flat sample indices [B] on the staged arrays' device,
    with device ops only.

    ``fold = searchsorted(offsets, idx, right) - 1``, ``window = local //
    N``, ``series = local % N``, ``start = window * stride``, as the JAX
    package's. Augmentation draws from ``generator`` (on the staged arrays'
    device), each draw only where its knob is non-zero: first each start's
    shift, uniform in ``[-time_shift, time_shift]`` and clipped to its
    fold's last start, then the inputs' noise; a knob without a generator
    raises ``ValueError``. Rows with ``row_valid`` 0 are then zeroed exactly
    as the host pipeline's ``pad_batch_rows`` pads them (their series id
    becomes 0), noise and all: the period selector pools amplitude
    statistics over the batch, so what a padded row holds reaches every
    row's selection.
    """

    if (staged.noise_std or staged.time_shift) and generator is None:
        raise ValueError("window augmentation (add_noise_std, time_shift) needs a generator")
    flat = flat_idx.to(torch.int32)
    offsets = staged.offsets
    src = torch.clamp(
        torch.searchsorted(offsets, flat, right=True) - 1, 0, offsets.shape[0] - 2
    )
    local = flat - offsets[src]
    N = staged.num_series
    window = torch.div(local, N, rounding_mode="floor")
    series = torch.remainder(local, N).to(torch.int32)
    starts = window * staged.stride
    dev = flat.device
    if staged.time_shift > 0:
        delta = torch.randint(-staged.time_shift, staged.time_shift + 1, starts.shape,
                              generator=generator, device=dev, dtype=torch.int32)
        starts = torch.minimum(torch.clamp(starts + delta, min=0), staged.max_start[src])

    L, H = staged.input_len, staged.horizon
    t_in = starts[:, None] + torch.arange(L, dtype=torch.int32, device=dev)[None, :]  # [B, L]
    t_out = (starts + L)[:, None] + torch.arange(H, dtype=torch.int32, device=dev)[None, :]

    src_b = src[:, None].long()
    ser_b = series[:, None].long()
    t_in, t_out = t_in.long(), t_out.long()
    x = staged.X[src_b, t_in, ser_b][..., None]
    y = staged.X[src_b, t_out, ser_b][..., None]
    mask = staged.M[src_b, t_out, ser_b][..., None]
    if staged.noise_std > 0.0:
        x = x + torch.randn(x.shape, generator=generator, device=dev,
                            dtype=x.dtype) * staged.noise_std

    rv = row_valid.to(torch.float32)
    rv3 = rv[:, None, None]
    series = series * rv.to(torch.int32)
    batch: Dict[str, Any] = {
        "x": x * rv3,
        "y": y * rv3,
        "mask": mask * rv3,
        "row_valid": rv,
        "x_mark": staged.marks[src_b, t_in] * rv3 if staged.marks is not None else None,
        "y_mark": (staged.marks[src_b, t_out] * rv3
                   if with_y_mark and staged.marks is not None else None),
        "static": (staged.static[series.long()][:, None, :] * rv3
                   if staged.static is not None else None),
        "ids": series[:, None],
    }
    if staged.sigma is not None:
        batch["floor"] = staged.sigma[series.long()][:, None, None]
    return batch


def epoch_index_plan(
    total: int,
    batch_size: int,
    padded_batch: Optional[int] = None,
    *,
    shuffle: bool,
    drop_last: bool,
    rng: Optional[np.random.Generator] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side epoch plan: ``(idx [S, B'], row_valid [S, B'])``.

    ``padded_batch`` right-pads every step to that many rows with
    ``row_valid = 0`` rows, as ``pad_batch_rows`` does.
    """

    order = np.arange(total, dtype=np.int64)
    if shuffle:
        if rng is None:
            raise ValueError("shuffle requires a host generator")
        rng.shuffle(order)
    n_full = total // batch_size
    rows: List[np.ndarray] = [
        order[b * batch_size : (b + 1) * batch_size] for b in range(n_full)
    ]
    valid: List[np.ndarray] = [np.ones(batch_size, np.float32) for _ in range(n_full)]
    rem = total - n_full * batch_size
    if rem > 0 and not drop_last:
        tail = order[n_full * batch_size :]
        rows.append(np.concatenate([tail, np.zeros(batch_size - rem, np.int64)]))
        valid.append(
            np.concatenate([np.ones(rem, np.float32), np.zeros(batch_size - rem, np.float32)])
        )
    if not rows:
        return (
            np.zeros((0, padded_batch or batch_size), np.int32),
            np.zeros((0, padded_batch or batch_size), np.float32),
        )
    idx = np.stack(rows).astype(np.int32)
    rv = np.stack(valid)
    if padded_batch is not None and padded_batch > idx.shape[1]:
        pad = padded_batch - idx.shape[1]
        idx = np.pad(idx, ((0, 0), (0, pad)))
        rv = np.pad(rv, ((0, 0), (0, pad)))
    return idx, rv
