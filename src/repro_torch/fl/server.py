"""Deprecated legacy runner surface (the reference:
``repro/fl/server.py``).

The monolithic per-scheme runner classes were retired in favour of the
layered engine (:mod:`repro_torch.fl.engine`): a scheme is a bundle of
assignment / payload / aggregator / trainer / loop components threading
an explicit :class:`~repro_torch.fl.types.ServerState`.

What remains is the old entry-point shape: ``RUNNERS[scheme](...)``
still resolves and returns a ready-to-run runner, but it is a thin shim
that emits a :class:`DeprecationWarning` and builds the engine bundle.
New code should call :func:`repro_torch.fl.engine.build_engine` (or
:func:`repro_torch.fl.simulation.build_runner`) directly.
"""

from __future__ import annotations

import warnings

from repro_torch.fl.engine.policies import tier_width
from repro_torch.fl.types import FLConfig, RoundLog

__all__ = ["RUNNERS", "FLConfig", "RoundLog", "tier_width"]


class _RunnerShim:
    """Callable standing in for a retired legacy runner class."""

    def __init__(self, scheme: str):
        self.scheme = scheme

    def __call__(self, model, parts_x, parts_y, test_batch, het, cfg,
                 eval_width=None, *, device=None):
        warnings.warn(
            f"repro_torch.fl.server.RUNNERS[{self.scheme!r}] is deprecated: "
            "the legacy runner classes were retired; this shim builds the "
            "equivalent engine bundle (repro_torch.fl.engine.build_engine).",
            DeprecationWarning, stacklevel=2)
        from repro_torch.fl.engine import build_engine
        return build_engine(self.scheme, model, parts_x, parts_y, test_batch,
                            het, cfg, eval_width, device=device)

    def __repr__(self) -> str:
        return f"<legacy runner shim for {self.scheme!r} (deprecated)>"


RUNNERS = {s: _RunnerShim(s)
           for s in ("fedavg", "adp", "heterofl", "flanc", "heroes")}
