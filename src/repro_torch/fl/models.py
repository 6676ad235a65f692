"""Width-scalable FL models (paper Sec. VI-A), in PyTorch.

Every model is described by an ordered dict of ``CompositionSpec``s:
hidden weights use the paper's "square" mode (p^2 blocks from the shared
P^2 counter); boundary layers (first conv, classifier) use the anchored
modes with their own P-block counter (Flanc's treatment).

Two parameterisations per model:
  * factorized  — params are (basis, coeff-blocks); used by Heroes.
  * dense       — params are materialised width-P weights; used by FedAvg.

Forward passes are width-polymorphic and parameterisation-aware: each
layer entry in the weight dict is either a composed ``(ksq, pI, pO)``
tensor (applied densely) or the raw ``{"basis", "coeff"}`` factors
(applied in rank space through
:func:`repro_torch.core.composition.apply_factors`, never materialising
the p-width weight).  :meth:`FLModelDef.prepare_weights` builds that dict
under a ``forward_impl`` knob:

  materialize  compose every layer (exactly ``compose_all``);
  rank_space   keep factors for every rank-capable layer;
  auto         pick per (layer, width, batch) by the static FLOPs model
               with the measured calibration
               (:mod:`repro_torch.core.calibration`); weight-shaped dense
               layers take the fused compose+apply kernel
               (``fused_compose``) when the measured gain says so.

Layers reach the card's kernels through those paths: ``compose`` (every
materialised layer), ``conv_rank_apply`` (rank-space convs),
``rank_dense_apply`` (rank-space dense layers) and
``compose_dense_apply`` (``fused_compose`` dense layers).  Only the CNN is
ported so far.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.composition import (CompositionSpec, apply_factors,
                                          apply_flops, compose,
                                          compose_flops, conv_rank_overhead,
                                          dense_apply_flops, gather_blocks,
                                          init_factors, rank_space_wins)
from repro_torch.kernels.conv_rank import _same_conv

Tensor = torch.Tensor

FORWARD_IMPLS = ("auto", "materialize", "rank_space")

# models of the JAX package that later slices of the port bring in
_LATER = {"resnet": "ROADMAP queue A step 7",
          "rnn": "ROADMAP queue A step 7",
          "transformer": "ROADMAP queue A step 10"}


@dataclasses.dataclass(frozen=True)
class LayerHint:
    """Static per-layer facts feeding the ``auto`` forward-impl choice.

    Attributes:
      apps_per_sample: weight applications per input sample per forward
        (conv output positions, 1 for a head) at the model's reference
        input geometry.
      apps_fn: optional ``(data_shape) -> apps_per_sample`` deriving the
        count from the actual input shape ``(B, ...)``.
      rank_capable: False pins the layer to materialisation.
      dense_apply_free: the materialised application costs no FLOPs.
      basis_gather: the rank path's basis projection is a gather.
    """

    apps_per_sample: int = 1
    apps_fn: Optional[Callable[[tuple], int]] = None
    rank_capable: bool = True
    dense_apply_free: bool = False
    basis_gather: bool = False

    def apps(self, data_shape: Optional[tuple] = None) -> int:
        if self.apps_fn is not None and data_shape is not None:
            return max(int(self.apps_fn(data_shape)), 1)
        return self.apps_per_sample


LAYER_KINDS = ("dense", "conv")


@dataclasses.dataclass(frozen=True)
class ComposedLayer:
    """One width-scalable layer: spec + application kind + auto-impl hint.

    Kinds:
      dense  ``x @ W`` on the last axis (any leading shape);
      conv   NHWC SAME conv, ``ksq`` taps, optional stride.
    """

    name: str
    spec: CompositionSpec
    kind: str = "dense"
    stride: int = 1
    hint: LayerHint = LayerHint()

    def __post_init__(self):
        if self.kind == "embed":
            raise NotImplementedError(
                "embed layers are not ported yet (ROADMAP queue A step 7)")
        if self.kind not in LAYER_KINDS:
            raise ValueError(f"unknown layer kind {self.kind!r} "
                             f"(expected one of {LAYER_KINDS})")
        if self.kind != "conv" and self.spec.ksq != 1:
            raise ValueError(f"layer {self.name!r}: ksq={self.spec.ksq} "
                             f"requires kind='conv'")

    def apply(self, entry, x: Tensor, width: int) -> Tensor:
        if self.kind == "conv":
            return _apply_conv(entry, x, width, self.spec, stride=self.stride)
        return _apply_dense(entry, x, width, self.spec)


@dataclasses.dataclass(frozen=True, eq=False)
class FLModelDef:
    """A width-scalable FL model (identity-hashed: the factories below are
    memoized so equal-config models are the same instance)."""

    name: str
    specs: Dict[str, CompositionSpec]  # ordered: forward consumption order
    forward: Callable  # (weights, width, batch) -> logits
    flops_per_sample: Callable  # (width) -> flops of fwd+bwd per sample
    num_classes: int
    hints: Optional[Dict[str, LayerHint]] = None
    input_key: str = "x"
    layers: Optional[Dict[str, ComposedLayer]] = None

    @classmethod
    def from_layers(cls, name: str, layers: Dict[str, ComposedLayer],
                    forward: Callable, flops_per_sample: Callable,
                    num_classes: int, *, input_key: str = "x"
                    ) -> "FLModelDef":
        specs = {n: layer.spec for n, layer in layers.items()}
        hints = {n: layer.hint for n, layer in layers.items()}
        return cls(name, specs, forward, flops_per_sample, num_classes,
                   hints, input_key=input_key, layers=layers)

    # ---- factorized parameterisation -----------------------------------
    def init_factorized(self, seed: int, device=None
                        ) -> Dict[str, Dict[str, Tensor]]:
        """Random factors from ``seed`` (a CPU torch generator, so a seed
        gives the same factors on every device)."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, spec in self.specs.items():
            v, u = init_factors(gen, spec, device)
            out[name] = {"basis": v, "coeff": u}
        return out

    def reduce(self, params, width: int, hidden_ids, anchored_ids):
        """Ship-to-client factors: gather the assigned blocks per layer."""
        out = {}
        for name, spec in self.specs.items():
            ids = hidden_ids if spec.mode == "square" else anchored_ids
            out[name] = {
                "basis": params[name]["basis"],
                "coeff": gather_blocks(params[name]["coeff"], np.asarray(ids)),
            }
        return out

    def compose_all(self, reduced, width: int) -> Dict[str, Tensor]:
        return {
            name: compose(reduced[name]["basis"], reduced[name]["coeff"],
                          width, spec)
            for name, spec in self.specs.items()
        }

    def layer_impls(self, width: int, batch_size: int, forward_impl: str,
                    data_shape: Optional[tuple] = None,
                    calibration=None, device=None) -> Dict[str, str]:
        """Per-layer materialize/rank_space/fused_compose choice.

        ``auto`` compares, per layer, the rank-space application cost
        against compose + dense application over the layer's total
        application count ``batch_size * hint.apps(data_shape)``, with the
        measured calibration of ``device`` (or the ``calibration`` pin)
        supplying what FLOPs cannot see.  A rank-capable dense layer that
        still loses to materialisation is ``"fused_compose"`` when the
        measured ``fused_compose_gain < 1``.
        """
        if forward_impl not in FORWARD_IMPLS:
            raise ValueError(f"unknown forward_impl {forward_impl!r} "
                             f"(expected one of {FORWARD_IMPLS})")
        if forward_impl == "materialize":
            return {name: "materialize" for name in self.specs}
        if forward_impl == "auto" and calibration is None:
            from repro_torch.core.calibration import get_calibration

            calibration = get_calibration(device)
        hints = self.hints or {}
        out = {}
        for name, spec in self.specs.items():
            hint = hints.get(name, LayerHint())
            if not hint.rank_capable:
                out[name] = "materialize"
            elif forward_impl == "rank_space":
                out[name] = "rank_space"
            else:
                apps = max(batch_size, 1) * hint.apps(data_shape)
                ovh = (conv_rank_overhead(calibration)
                       if spec.ksq > 1 else 1.0)
                if rank_space_wins(
                        width, spec, applications=apps,
                        dense_apply_free=hint.dense_apply_free,
                        basis_is_gather=hint.basis_gather,
                        overhead=ovh):
                    out[name] = "rank_space"
                elif (spec.ksq == 1 and not hint.dense_apply_free
                      and calibration.fused_compose_gain < 1.0):
                    out[name] = "fused_compose"
                else:
                    out[name] = "materialize"
        return out

    def prepare_weights(self, reduced, width: int, batch,
                        forward_impl: str = "materialize",
                        calibration=None) -> Dict[str, Any]:
        """The weight dict ``forward`` consumes, per ``forward_impl``.

        ``materialize`` is exactly :meth:`compose_all`.  Otherwise
        rank-space layers pass their raw ``{"basis", "coeff"}`` factors
        through, ``fused_compose`` layers pass the factors with a
        ``"fused"`` marker (the forward routes them through
        ``compose_dense_apply``), and the rest compose as usual.
        """
        if forward_impl == "materialize":
            return self.compose_all(reduced, width)
        data = batch.get(self.input_key) if isinstance(batch, dict) else None
        shape = tuple(data.shape) if data is not None else None
        batch_size = shape[0] if shape else 1
        impls = self.layer_impls(
            width, batch_size, forward_impl, shape, calibration,
            device=data.device if data is not None else None)
        out = {}
        for name, spec in self.specs.items():
            if impls[name] == "rank_space":
                out[name] = reduced[name]
            elif impls[name] == "fused_compose":
                out[name] = {**reduced[name], "fused": True}
            else:
                out[name] = compose(reduced[name]["basis"],
                                    reduced[name]["coeff"], width, spec)
        return out

    def apply_flops_per_sample(self, width: int, batch_size: int,
                               forward_impl: str,
                               data_shape: Optional[tuple] = None,
                               calibration=None, device=None) -> float:
        """Per-sample fwd+bwd FLOPs under the per-layer impl the client
        forward takes (the ``clock_model="rank_aware"`` time model):
        rank-space layers charge :func:`apply_flops`, materialised ones
        their compose amortised over the batch plus the dense application;
        backward ~ 2x forward."""
        impls = self.layer_impls(width, batch_size, forward_impl, data_shape,
                                 calibration, device)
        hints = self.hints or {}
        bs = max(int(batch_size), 1)
        total = 0.0
        for name, spec in self.specs.items():
            hint = hints.get(name, LayerHint())
            apps = hint.apps(data_shape)
            if impls[name] == "rank_space":
                fwd = apply_flops(width, spec, applications=apps,
                                  basis_is_gather=hint.basis_gather)
            else:
                fwd = compose_flops(width, spec) / bs
                if not hint.dense_apply_free:
                    fwd += dense_apply_flops(width, spec, applications=apps)
            total += 3.0 * fwd
        return total

    def factorized_bytes(self, width: int) -> int:
        return 4 * sum(s.params_factorized(width) for s in self.specs.values())

    # ---- dense parameterisation ------------------------------------------
    def init_dense(self, seed: int, device=None) -> Dict[str, Tensor]:
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, spec in self.specs.items():
            ksq, i, o = spec.weight_shape(spec.max_width)
            w = torch.randn((ksq, i, o), generator=gen) / math.sqrt(ksq * i)
            out[name] = w.to(device)
        return out

    def slice_dense(self, params: Dict[str, Tensor],
                    width: int) -> Dict[str, Tensor]:
        """HeteroFL-style sub-model: leading slices of each weight."""
        out = {}
        for name, spec in self.specs.items():
            ksq, i, o = spec.weight_shape(width)
            out[name] = params[name][:, :i, :o]
        return out

    def dense_bytes(self, width: int) -> int:
        return 4 * sum(s.params_materialized(width) for s in self.specs.values())


# ---------------------------------------------------------------------------
# model registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """Registry row: the builder plus the data modality it expects."""

    name: str
    modality: str  # "image" | "text"
    build: Callable[..., FLModelDef]


MODEL_REGISTRY: Dict[str, ModelEntry] = {}


def register_model(name: str, *, modality: str = "image"):
    """Decorator registering a ``build(max_width, meta, **kw)`` factory."""
    def deco(build):
        if name in MODEL_REGISTRY:
            raise ValueError(f"model {name!r} already registered")
        MODEL_REGISTRY[name] = ModelEntry(name, modality, build)
        return build
    return deco


def get_model(name: str) -> ModelEntry:
    if name in _LATER and name not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"model {name!r} is not ported yet ({_LATER[name]})")
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}"
        ) from None


# ---------------------------------------------------------------------------
# forward helpers
# ---------------------------------------------------------------------------

# A composed tensor runs the dense op; a {"basis", "coeff"} factor dict
# runs the rank-space contraction (or, marked "fused", the fused
# compose+apply kernel).


def _apply_conv(entry, x: Tensor, width: int, spec: CompositionSpec,
                stride: int = 1) -> Tensor:
    if isinstance(entry, dict):
        return apply_factors(x, entry["basis"], entry["coeff"], width, spec,
                             "conv", stride=stride)
    return _same_conv(x, entry, stride)


def _apply_dense(entry, x: Tensor, width: int, spec: CompositionSpec) -> Tensor:
    if isinstance(entry, dict):
        if entry.get("fused"):
            from repro_torch.kernels.compose import compose_dense_apply

            return compose_dense_apply(x, entry["basis"], entry["coeff"],
                                       width, spec.mode)
        return apply_factors(x, entry["basis"], entry["coeff"], width, spec,
                             "dense")
    return x @ entry[0]


# ---------------------------------------------------------------------------
# CNN (paper's 4-layer CNN, reduced input 8x8)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def make_cnn(max_width: int = 3, base: int = 8, rank: int = 8,
             num_classes: int = 10, in_ch: int = 3) -> FLModelDef:
    layers = {
        "conv1": ComposedLayer(
            "conv1",
            CompositionSpec(max_width, rank, in_ch, base, ksq=9, mode="grow_out"),
            kind="conv",
            hint=LayerHint(64, lambda s: s[1] * s[2])),
        "conv2": ComposedLayer(
            "conv2", CompositionSpec(max_width, rank, base, base, ksq=9),
            kind="conv", stride=2,
            hint=LayerHint(16, lambda s: -(-s[1] // 2) * (-(-s[2] // 2)))),
        "conv3": ComposedLayer(
            "conv3", CompositionSpec(max_width, rank, base, base, ksq=9),
            kind="conv", stride=2,
            hint=LayerHint(4, lambda s: -(-s[1] // 4) * (-(-s[2] // 4)))),
        "fc": ComposedLayer(
            "fc",
            CompositionSpec(max_width, rank, base, num_classes, ksq=1,
                            mode="grow_in"),
            hint=LayerHint(apps_per_sample=1)),
    }

    def forward(w: Dict[str, Any], width: int, batch) -> Tensor:
        x = batch["x"]
        x = torch.relu(layers["conv1"].apply(w["conv1"], x, width))
        x = torch.relu(layers["conv2"].apply(w["conv2"], x, width))
        x = torch.relu(layers["conv3"].apply(w["conv3"], x, width))
        x = x.mean(dim=(1, 2))  # GAP
        return layers["fc"].apply(w["fc"], x, width)

    def flops(width: int, hw: int = 8) -> int:
        p = width
        f = 0
        f += 2 * 9 * in_ch * (p * base) * hw * hw
        f += 2 * 9 * (p * base) ** 2 * (hw // 2) ** 2
        f += 2 * 9 * (p * base) ** 2 * (hw // 4) ** 2
        f += 2 * (p * base) * num_classes
        return 3 * f  # fwd + bwd ~ 3x

    return FLModelDef.from_layers("cnn", layers, forward, flops, num_classes)


MODELS = {"cnn": make_cnn}


@register_model("cnn", modality="image")
def _build_cnn(max_width: int, meta: Dict[str, Any], **kw) -> FLModelDef:
    return make_cnn(max_width=max_width, num_classes=meta["num_classes"],
                    in_ch=meta["channels"], **kw)
