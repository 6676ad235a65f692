"""Per-device counts of the ops a step actually runs (the reference:
``repro/launch/hlo_analysis.py``, which parses compiled HLO).

There is no HLO in eager PyTorch, so :class:`OpCounter` counts the ops
themselves: a ``TorchDispatchMode`` that sees every op that reaches the
dispatcher on this device, a DTensor's local ops and the functional
collectives DTensor issues included (an op on DTensors is handed back to
DTensor, whose local ops then come through the mode).  Eager execution
runs every layer of a Python loop, so the counts are loop-aware by
construction (the reference scales while bodies by their trip counts).

  * dot_flops        — 2*M*N*K over ``mm``, ``bmm``, ``addmm``,
                       ``baddbmm`` and ``convolution``
  * traffic_bytes    — operand plus result bytes of every op that is not
                       a view
  * collective_bytes — result bytes of all-gather / all-reduce /
                       reduce-scatter / all-to-all, by type

The hand-written kernels launch through ctypes and never reach the
dispatcher: each launch adds its own FLOPs (to ``dot_flops``) and bytes
(to ``traffic_bytes``) through :data:`repro_torch.kernels.LAUNCH_HOOKS`,
by the formulas ``chip_smoke.py``'s ``bound_ms`` uses.  Without that
hook attention and the SSD block would count as zero.  Ops on ``meta``
or fake tensors (DTensor's sharding propagation) are not counted.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {"all_gather_into_tensor": "all-gather",
                   "all_gather_into_tensor_coalesced": "all-gather",
                   "all_reduce": "all-reduce",
                   "all_reduce_coalesced": "all-reduce",
                   "reduce_scatter_tensor": "reduce-scatter",
                   "reduce_scatter_tensor_coalesced": "reduce-scatter",
                   "all_to_all_single": "all-to-all",
                   "broadcast": "collective-permute"}
_aten = torch.ops.aten
_MM = {_aten.mm.default, _aten.addmm.default}
_BMM = {_aten.bmm.default, _aten.baddbmm.default}
_CONV = {_aten.convolution.default}
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def dot_flops(func, args, out) -> int:
    """2*M*N*K of a matrix product or convolution, else 0."""
    if func in _MM:
        a, b = (args[0], args[1]) if func is _aten.mm.default else (args[1],
                                                                    args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if func in _BMM:
        a, b = (args[0], args[1]) if func is _aten.bmm.default else (args[1],
                                                                     args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if func in _CONV:
        w = args[1]  # (out, in / groups, *kernel)
        return 2 * out.numel() * w.shape[1] * math.prod(w.shape[2:])
    return 0


# --------------------------------------------------------------------------
# the hand-written kernels' work, from each launch's operands and sizes
# --------------------------------------------------------------------------


def _attention_pairs(sq: int, sk: int, causal: bool, window: int,
                     kv_len=None) -> int:
    """Query-key pairs a masked attention needs: queries aligned to the end
    of the keys, causal and window masks, and per-row key counts (summed
    over rows, ``kv_len`` given as a list; one row of ``sk`` keys
    without)."""
    pos = np.arange(sq) + (sk - sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window > 0 else np.zeros(sq)
    rows = kv_len if kv_len is not None else [sk]
    values, counts = np.unique(np.asarray(rows), return_counts=True)
    return int(sum(c * np.clip(np.minimum(hi, n - 1) - lo + 1, 0, None).sum()
                   for n, c in zip(values, counts)))


def kernel_cost(name: str, tensors, scalars) -> tuple:
    """(FLOPs, bytes) of one launch of kernel ``name`` with its launcher's
    ``tensors`` and ``scalars``: each input read once and each output
    written once, and the products the launch's data needs."""
    live = [t for t in tensors if t is not None]
    if name in ("flash_attention", "flash_attention_bwd"):
        # forward: q, k, v, out, kv_len[, lse]; backward: q, k, v, out,
        # dout, lse, delta (scratch), dq, dk, dv, kv_len.  Two products of
        # the head size a visible pair forward, five backward (S and dP
        # recomputed, dV, dK, dQ)
        bwd = name == "flash_attention_bwd"
        kv_len = tensors[10] if bwd else tensors[4]
        BH, Sq, Sk, D, G, causal, window = (int(s) for s in scalars[:7])
        lens = None if kv_len is None else kv_len.tolist()
        pairs = _attention_pairs(Sq, Sk, bool(causal), window, lens)
        per_row = pairs if lens is not None else pairs * (BH // G)
        flops = (10 if bwd else 4) * D * G * per_row
        return flops, sum(_bytes(t) for i, t in enumerate(tensors)
                          if t is not None and not (bwd and i == 6))
    if name == "decode_attention":
        q, k, v, lens, out = tensors[:5]
        B, S, KV, G, D = (int(s) for s in scalars[:5])
        n = int(lens.sum())  # keys read per query row, summed
        return 4 * D * n, 2 * _bytes(q) + _bytes(lens) + (
            n // G) * D * (k.element_size() + v.element_size())
    if name == "ssd_chunk":
        R, Q, N, P, heads = (int(s) for s in scalars[:5])
        G = R // heads
        pairs = Q * (Q + 1) // 2  # the causal half
        flops = 2 * G * pairs * N + R * (2 * pairs * P + 2 * Q * N * P)
        return flops, sum(_bytes(t) for t in tensors[:6])
    if name == "rmsnorm":
        rows, d = int(scalars[0]), int(scalars[1])
        return 4 * rows * d, sum(_bytes(t) for t in live)
    if name in ("rank_apply", "compose_apply"):
        C, M, g, I, R, D = (int(s) for s in scalars[:6])
        flops = 2 * C * M * g * I * R + 2 * C * M * g * R * D
        if name == "compose_apply":
            flops = 2 * C * g * I * R * D + 2 * C * M * g * I * D
        return flops, sum(_bytes(t) for t in live)
    if name == "compose":
        C, ksq, I, R, m, O = (int(s) for s in scalars[:6])
        return 2 * C * ksq * I * R * m * O, sum(_bytes(t) for t in live)
    if name == "conv_rank":
        C, N, H, W, g, I, R, D, k = (int(s) for s in scalars[:9])
        Ho, Wo = int(scalars[10]), int(scalars[11])
        pix = C * N * Ho * Wo
        return (2 * pix * (k * k * g * I * R + g * R * D),
                sum(_bytes(t) for t in live))
    raise KeyError(f"no cost formula for kernel {name}")


# --------------------------------------------------------------------------
# the counter
# --------------------------------------------------------------------------


class OpCounter(TorchDispatchMode):
    """Counts, while active, this device's dot FLOPs, traffic bytes and
    collective bytes (:func:`analyze`'s fields), the hand-written
    kernels' launches included."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.elementwise_flops = 0
        self.traffic_bytes = 0
        self.collective_bytes = {c: 0 for c in COLLECTIVES}
        self.collective_counts = {c: 0 for c in COLLECTIVES}
        self.kernel_flops: Dict[str, int] = {}
        self.kernel_launches: Dict[str, int] = {}

    def __enter__(self):
        from repro_torch.kernels import LAUNCH_HOOKS
        LAUNCH_HOOKS.append(self._on_launch)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import LAUNCH_HOOKS
        LAUNCH_HOOKS.remove(self._on_launch)
        return super().__exit__(*exc)

    def _on_launch(self, name, tensors, scalars):
        flops, nbytes = kernel_cost(name, tensors, scalars)
        self.dot_flops += flops
        self.traffic_bytes += nbytes
        self.kernel_flops[name] = self.kernel_flops.get(name, 0) + flops
        self.kernel_launches[name] = self.kernel_launches.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)  # sharding propagation: no work
        if any(t is not torch.Tensor for t in types):
            return NotImplemented  # a subclass (DTensor) unwraps first
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(t.device.type == "meta" for t in ins + outs):
            return out
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _COLLECTIVE_OPS.get(func._opname)
            if kind is not None:
                self.collective_bytes[kind] += sum(_bytes(t) for t in outs)
                self.collective_counts[kind] += 1
            return out
        if getattr(func, "is_view", False) or func in _NO_TRAFFIC:
            return out
        flops = dot_flops(func, args, outs[0] if outs else None)
        self.dot_flops += flops
        if not flops:
            self.elementwise_flops += sum(t.numel() for t in outs)
        self.traffic_bytes += sum(_bytes(t) for t in ins + outs)
        return out

    def result(self) -> dict:
        """The reference's ``loop_scaled`` fields (and the kernels' share)."""
        return {
            "dot_flops": self.dot_flops,
            "traffic_bytes": self.traffic_bytes,
            "collective_bytes": {**self.collective_bytes,
                                 "total": sum(self.collective_bytes.values())},
            "collective_counts": dict(self.collective_counts),
            "kernel_flops": dict(self.kernel_flops),
            "kernel_launches": dict(self.kernel_launches),
        }


def analyze(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under an :class:`OpCounter`: (its result,
    the counts)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.result()
