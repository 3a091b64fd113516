"""Artifact IO (counterpart of ``flow_timesnet_tpu/utils/artifacts.py``):
checkpoints, the training state, the scaler pickle, the schema JSON and the
submission's row keys.

``save_checkpoint`` / ``load_checkpoint`` write and read the JAX package's
file byte for byte: flax's msgpack of ``{"version", "params", "aux"}``,
each array as flax's extension type 1, the params in the JAX tree layout
(``convert.params_to_jax`` / ``params_from_jax`` carry them to and from the
port's state_dict), written by ``utils/msgpack_codec.py``. So either
package loads the other's checkpoint. The training state of a resumable
run (parameters, AdamW moments and step counts, EMA, accumulator, and the
loop counters) is the port's own layout, in the same codec, in a file of
its own name (:data:`TRAIN_STATE_FILE`): neither package takes the other's.
``scaler.pkl`` holds no pandas object, so both packages read each other's.
Under data parallelism with a row-sharded series table the training state
is written from the assembled table and moments (rank 0 writes, every rank
takes part in the assembly), byte for byte what one card writes, and
loading cuts them to each rank's rows again.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..data.schema import DataSchema
from ..parallel import mesh
from . import msgpack_codec
from .metadata import load_json, save_json

SCHEMA_ARTIFACT_VERSION = "1.0"
CHECKPOINT_VERSION = 1
TRAIN_STATE_FILE = "train_state_torch.msgpack"
TRAIN_STATE_FORMAT = "flow_timesnet_tpu_torch"


# -- generic ---------------------------------------------------------------


def save_pickle(obj: Any, path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def _write(path: str, payload: Any) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_codec.packb(payload))
    os.replace(tmp, path)


def _read(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_codec.unpackb(f.read())


def _numpy_tree(tree: Any) -> Any:
    """Every leaf as a numpy array, as the JAX package's save does."""

    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


# -- model checkpoint --------------------------------------------------------


def save_checkpoint(path: str, params: Any, aux: Optional[Mapping[str, Any]] = None) -> None:
    """Write a param tree in the JAX layout (nested dicts of arrays, as
    ``convert.params_to_jax`` gives) and small aux arrays as the JAX
    package's msgpack checkpoint."""

    _write(path, _numpy_tree({"version": CHECKPOINT_VERSION, "params": params,
                              "aux": dict(aux or {})}))


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """``(params tree, aux)`` of a checkpoint either package wrote."""

    payload = _read(path)
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"Unrecognised checkpoint payload in {path}")
    return payload["params"], dict(payload.get("aux") or {})


# -- full training state (true resume: params + optimizer + loop counters) ---


def _named(tensors: Optional[Mapping[str, torch.Tensor]], sharded=()):
    if tensors is None:
        return None
    return {k: v.cpu().numpy() for k, v in mesh.host_fetch(tensors, sharded).items()}


def save_train_state(path: str, state: Any, extra: Mapping[str, Any], sharded=()) -> None:
    """Persist a port ``TrainState`` and the loop's host state for resume:
    parameters, each parameter's AdamW ``exp_avg``, ``exp_avg_sq`` and
    ``step``, the accumulator and the EMA (each None where off), and
    ``extra`` (epoch, bests, patience, ``LRController.state_dict()``).
    ``sharded`` names the tensors that hold one rank's rows: every rank
    calls this, the whole tensors are assembled and rank 0 writes."""

    opt = state.optimizer.adamw
    moments = {key: _named({name: opt.state[p][key] for name, p in state.params.items()},
                           sharded if key != "step" else ())
               for key in ("exp_avg", "exp_avg_sq", "step")}
    payload = {
        "format": TRAIN_STATE_FORMAT,
        "version": CHECKPOINT_VERSION,
        "params": _named(state.params, sharded),
        "optimizer": moments,
        "grad_accum": _named(state.grad_accum, sharded),
        "ema": _named(state.ema, sharded),
        "extra": dict(extra),
    }
    if mesh.is_main():
        _write(path, payload)


def load_train_state(path: str, template_state: Any, sharded=()) -> Tuple[Any, Dict[str, Any]]:
    """Copy a saved training state into ``template_state``'s tensors in
    place (they keep their storage, so graphs captured on them stay
    valid) and return ``(state, extra)``. An EMA missing from the file
    restarts from the resumed parameters; one the template lacks is
    dropped. The tensors named in ``sharded`` take this rank's rows of the
    stored ones."""

    payload = _read(path)
    if not isinstance(payload, dict) or payload.get("format") != TRAIN_STATE_FORMAT:
        raise ValueError(f"Unrecognised train-state payload in {path}")

    def load_into(dst: Mapping[str, torch.Tensor], src: Mapping[str, np.ndarray], what: str):
        if set(dst) != set(src):
            raise ValueError(f"{path}: the stored {what} are not this model's")
        if what != "optimizer step":
            src = mesh.shard_train_state(src, sharded)
        with torch.no_grad():
            for name, t in dst.items():
                value = torch.from_numpy(np.asarray(src[name])).to(dtype=t.dtype)
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(f"{path}: {what} {name} has shape {tuple(value.shape)}, "
                                     f"the model {tuple(t.shape)}")
                t.copy_(value)

    state = template_state
    load_into(state.params, payload["params"], "parameters")
    opt = state.optimizer.adamw
    for key, stored in payload["optimizer"].items():
        load_into({name: opt.state[p][key] for name, p in state.params.items()}, stored,
                  f"optimizer {key}")
    if state.grad_accum is not None:
        if payload.get("grad_accum") is not None:
            load_into(state.grad_accum, payload["grad_accum"], "accumulator")
        else:
            for t in state.grad_accum.values():
                t.zero_()
    if state.ema is not None:
        load_into(state.ema, payload.get("ema") or payload["params"], "EMA")
    return state, dict(payload.get("extra") or {})


# -- schema artifact ---------------------------------------------------------


def save_schema_artifact(
    path: str,
    schema: DataSchema,
    *,
    normalization: Mapping[str, Any] | None = None,
    extras: Mapping[str, Any] | None = None,
    version: str = SCHEMA_ARTIFACT_VERSION,
) -> None:
    payload: Dict[str, Any] = {
        "version": str(version),
        "fields": schema.as_dict(),
        "sources": dict(schema.sources),
        "detection": dict(schema.detection),
    }
    if normalization is not None:
        payload["normalization"] = dict(normalization)
    if extras is not None:
        payload["extras"] = dict(extras)
    save_json(payload, path)


def load_schema_artifact(path: str) -> Tuple[DataSchema, Dict[str, Any]]:
    payload = load_json(path)
    if not isinstance(payload, dict):
        raise ValueError("Schema artifact must be a JSON object")
    if "fields" in payload:
        fields = payload["fields"]
    else:  # legacy flat layout
        fields = {k: payload.get(k) for k in ("date", "id", "target")}
    schema = DataSchema.from_fields(
        fields, sources=payload.get("sources"), detection=payload.get("detection")
    )
    meta = {
        "version": payload.get("version", "0"),
        "normalization": payload.get("normalization"),
        "extras": payload.get("extras"),
        "raw": payload,
    }
    return schema, meta


def validate_normalization_config(
    preprocess_cfg: Dict[str, Any], normalization_meta: Mapping[str, Any] | None
) -> None:
    """Reconcile configured preprocess settings with the stored normalization.

    Missing configured values inherit the stored ones; conflicting values
    raise.
    """

    if normalization_meta is None:
        return
    mismatches = []
    stored_method = normalization_meta.get("method")
    if stored_method is not None:
        configured = preprocess_cfg.get("normalize")
        if configured is None:
            preprocess_cfg["normalize"] = stored_method
        elif str(configured) != str(stored_method):
            mismatches.append(f"normalize configured='{configured}' stored='{stored_method}'")
    stored_ps = normalization_meta.get("per_series")
    if stored_ps is not None:
        configured = preprocess_cfg.get("normalize_per_series")
        if configured is None:
            preprocess_cfg["normalize_per_series"] = bool(stored_ps)
        elif bool(configured) != bool(stored_ps):
            mismatches.append(
                f"normalize_per_series configured='{configured}' stored='{stored_ps}'"
            )
    stored_eps = normalization_meta.get("eps")
    if stored_eps is not None:
        configured = preprocess_cfg.get("eps")
        if configured is None:
            preprocess_cfg["eps"] = stored_eps
        else:
            try:
                if not np.isclose(float(configured), float(stored_eps)):
                    mismatches.append(f"eps configured='{configured}' stored='{stored_eps}'")
            except (TypeError, ValueError):
                mismatches.append(f"eps configured='{configured}' stored='{stored_eps}'")
    if mismatches:
        raise ValueError(
            "Preprocess normalization settings do not match training artifacts: "
            + "; ".join(mismatches)
        )


# -- submission row keys ------------------------------------------------------


def parse_row_key(row_key: str) -> Tuple[str, int]:
    """Parse ``<part>+D<n>`` / ``<part>+Day n`` / ``<part>+n일`` row keys."""

    pattern = r"^(.*)\+(?:D(?:ay)?\s*)?(\d+)\D*$"
    match = re.match(pattern, row_key.strip(), flags=re.IGNORECASE)
    if not match:
        raise ValueError(f"Unsupported row key format: {row_key}")
    return match.group(1).strip(), int(match.group(2))
