"""Payload models: bytes shipped per client assignment (traffic account).

The loop charges ``2 * bytes(a)`` per dispatch (download + upload).
"""

from __future__ import annotations

from repro_torch.fl.engine.base import Assignment, PayloadModel


class DensePayload(PayloadModel):
    """Materialised weights.

    ``sliced=False`` ships the full width-P model regardless of the
    assignment (FedAvg/ADP/FedProx); ``sliced=True`` ships the width-p
    sub-model (HeteroFL).
    """

    def __init__(self, sliced: bool = False):
        self.sliced = sliced

    def bytes(self, assignment: Assignment) -> float:
        width = assignment["width"] if self.sliced else self.eng.P
        return self.eng.model.dense_bytes(width)


class FactorizedPayload(PayloadModel):
    """Neural-composition factors: basis + width-p coefficient blocks."""

    def bytes(self, assignment: Assignment) -> float:
        return self.eng.model.factorized_bytes(assignment["width"])
