"""ServerState <-> checkpoint payload codec.

A checkpoint is one nested dict (written atomically by
:mod:`repro_torch.checkpoint.msgpack_ckpt`, in the JAX package's format)
with two branches, as the JAX package's ``fl/engine/state.py`` lays it
out, so either package restores the other's checkpoints:

``arrays``
    Every tensor in the state — the scheme-shaped global params, the
    Heroes scheduler counters, and the params of each semi-async
    in-flight result — stored bit-exactly per leaf.

``meta``
    One JSON document (stored as a uint8 leaf so it rides the same
    writer) holding the scalars: round/wall/traffic and its up/down
    split, the BoundState fields, the numpy ``bit_generator.state``
    (PCG64's 128-bit integers are exact in JSON, and Python floats
    round-trip exactly through ``repr``-based JSON), participation
    bookkeeping, the full RoundLog history, and the scalar half of each
    in-flight dispatch record.

Restoring needs a *template* params tree from a freshly constructed
runner: the flattener stringifies dict keys, and Flanc's ``coeffs``
branch is keyed by integer width, so restored keys are re-matched to the
template's key types (:func:`_rekey_like`).  Params and in-flight results
go back onto the run's device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import convergence
from repro_torch.fl.client import ClientResult
from repro_torch.fl.types import InFlight, RoundLog, SchedState, ServerState
from repro_torch.sharding import fl as flsh


def _enc_obj(x: Any) -> Any:
    """JSON-encodable view of small scalar/array structures (assignment
    dicts: widths, taus, block-id index arrays)."""
    if isinstance(x, np.ndarray):
        return {"__nd__": [str(x.dtype), list(x.shape),
                           x.reshape(-1).tolist()]}
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: _enc_obj(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_enc_obj(v) for v in x]
    return x


def _dec_obj(x: Any) -> Any:
    if isinstance(x, dict):
        if set(x) == {"__nd__"}:
            dtype, shape, data = x["__nd__"]
            return np.asarray(data, dtype=np.dtype(dtype)).reshape(shape)
        return {k: _dec_obj(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_dec_obj(v) for v in x]
    return x


def _rekey_like(template: Any, restored: Any) -> Any:
    """Re-match restored dict keys to the template's key types.

    Flattening joins keys into string paths, so non-string keys (Flanc's
    per-width integer coeff keys) come back stringified."""
    if isinstance(template, dict):
        return {k: _rekey_like(template[k], restored[str(k)])
                for k in template}
    return restored


def _on_device(tree: Any, device) -> Any:
    """Nested dicts of host arrays -> the same dicts of tensors on
    ``device``, each leaf's dtype and bits kept."""
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.tensor(np.asarray(tree), device=device)


def state_to_payload(state: ServerState) -> Dict[str, Any]:
    # a coefficient split over a cohort's shards is saved whole; a restore
    # brings it back whole on the run's device, and the next merge splits
    # it again (as the JAX package's msgpack checkpoints do)
    arrays: Dict[str, Any] = {"params": flsh.assemble(state.params)}
    if state.sched is not None:
        arrays["sched"] = {"counters": state.sched.counters,
                           "anchored": state.sched.anchored}
    flights = []
    for i, t in enumerate(state.in_flight):
        arrays[f"inflight_{i}"] = t.result.host_params()
        flights.append({
            "client": int(t.client),
            "finish": float(t.finish),
            "dispatched": int(t.dispatched),
            "assign": _enc_obj(t.assign),
            "estimates": {k: float(v)
                          for k, v in (t.result.estimates or {}).items()},
            "loss_before": float(t.result.loss_before),
            "loss_after": float(t.result.loss_after),
        })
    meta = {
        "round": int(state.round),
        "wall": float(state.wall),
        "traffic": float(state.traffic),
        "traffic_up": float(state.traffic_up),
        "traffic_down": float(state.traffic_down),
        "bound_state": dataclasses.asdict(state.bound_state),
        "rng_state": state.rng.bit_generator.state,
        "participation": {str(k): int(v)
                          for k, v in state.participation.items()},
        "history": [dataclasses.asdict(h) for h in state.history],
        "in_flight": flights,
        "has_sched": state.sched is not None,
    }
    meta_bytes = json.dumps(meta).encode("utf-8")
    return {"arrays": arrays,
            "meta": np.frombuffer(meta_bytes, np.uint8).copy()}


def payload_to_state(payload: Dict[str, Any], template_params: Any,
                     device) -> ServerState:
    meta = json.loads(np.asarray(payload["meta"], np.uint8)
                      .tobytes().decode("utf-8"))
    arrays = payload["arrays"]
    rng = np.random.default_rng()
    rng.bit_generator.state = meta["rng_state"]
    sched = None
    if meta["has_sched"]:
        sched = SchedState(
            counters=np.array(arrays["sched"]["counters"], dtype=np.int64),
            anchored=np.array(arrays["sched"]["anchored"], dtype=np.int64))
    flights = []
    for i, f in enumerate(meta["in_flight"]):
        result = ClientResult(
            params=_on_device(arrays[f"inflight_{i}"], device),
            estimates={k: float(v) for k, v in f["estimates"].items()},
            loss_before=f["loss_before"], loss_after=f["loss_after"])
        flights.append(InFlight(client=f["client"],
                                assign=_dec_obj(f["assign"]),
                                result=result, finish=f["finish"],
                                dispatched=f["dispatched"]))
    return ServerState(
        rng=rng,
        bound_state=convergence.BoundState(**meta["bound_state"]),
        params=_on_device(_rekey_like(template_params, arrays["params"]),
                          device),
        round=meta["round"], wall=meta["wall"], traffic=meta["traffic"],
        traffic_up=float(meta["traffic_up"]),
        traffic_down=float(meta["traffic_down"]),
        sched=sched,
        participation={int(k): int(v)
                       for k, v in meta["participation"].items()},
        in_flight=tuple(flights),
        history=tuple(RoundLog(**h) for h in meta["history"]))
