"""Payload models: bytes shipped per client assignment (traffic account).

The loop charges ``2 * bytes(a)`` per dispatch (download + upload).
"""

from __future__ import annotations

from repro_torch.fl.engine.base import Assignment, PayloadModel


class DensePayload(PayloadModel):
    """Materialised weights: the full width-P model (FedAvg)."""

    def bytes(self, assignment: Assignment) -> float:
        return self.eng.model.dense_bytes(self.eng.P)


class FactorizedPayload(PayloadModel):
    """Neural-composition factors: basis + width-p coefficient blocks."""

    def bytes(self, assignment: Assignment) -> float:
        return self.eng.model.factorized_bytes(assignment["width"])
