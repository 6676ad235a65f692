"""Component contracts of the layered FL engine.

A *scheme* (FedAvg, Heroes, ...) is a bundle of independently testable
components wired to a shared :class:`~repro_torch.fl.engine.runner.EngineRunner`:

  AssignmentPolicy        who trains what: (width, tau, block ids) per client
  PayloadModel            traffic accounting: bytes shipped per assignment
  Aggregator              global-state owner: init / client view / merge / eval
  LocalTrainer            client-update backend
  RoundLoop               virtual-clock event loop
  ParticipationScheduler  who is offered the round: cohort sampling policy

Each component is bound to the runner with :meth:`setup` for its static
collaborators.  All round state lives in one explicit
:class:`~repro_torch.fl.types.ServerState` value that
``RoundLoop.run_round(state) -> (state', RoundLog)`` threads through every
contract below; components never stash round state on themselves.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Sequence, Tuple

from repro_torch.fl.client import ClientResult
from repro_torch.fl.types import RoundLog, ServerState

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.fl.engine.runner import EngineRunner

Assignment = Dict[str, Any]  # {"width": int, "tau": int, [block-id keys]}


class Component:
    """Base: every engine component is bound to one runner."""

    eng: "EngineRunner"

    def setup(self, eng: "EngineRunner") -> None:
        self.eng = eng


class AssignmentPolicy(Component):
    """Decides (width, tau, tensor blocks) for a set of sampled clients.

    ``assign`` returns ``(state', assigns)``; control state the policy
    advances (Heroes' per-block counters) is carried in ``state.sched``.
    The dict's insertion order is the order every consumer iterates in.
    """

    def init_state(self, state: ServerState) -> ServerState:
        """Attach policy-owned fields to a fresh state (default: none)."""
        return state

    def assign(self, state: ServerState, clients: Sequence[int],
               ) -> Tuple[ServerState, Dict[int, Assignment]]:
        raise NotImplementedError


class PayloadModel(Component):
    """Bytes shipped one way for one client's assignment."""

    def bytes(self, assignment: Assignment) -> float:
        raise NotImplementedError


class Aggregator(Component):
    """Owns the global model layout: init, per-client view, merge, eval.

    The model lives in ``state.params`` (scheme-shaped tree of tensors on
    the run's device).
    """

    def init_global(self, state: ServerState) -> ServerState:
        raise NotImplementedError

    def client_params(self, state: ServerState, n: int,
                      assignment: Assignment) -> Any:
        """The parameter view shipped to client ``n`` this round."""
        raise NotImplementedError

    def aggregate(
        self,
        state: ServerState,
        results: Dict[int, ClientResult],
        assigns: Dict[int, Assignment],
    ) -> ServerState:
        raise NotImplementedError

    def evaluate(self, state: ServerState) -> float:
        raise NotImplementedError


class LocalTrainer(Component):
    """Runs the local updates for every assigned client of one dispatch;
    the per-client data/rng streams are keyed ``(seed, round, client)``."""

    def train_all(self, state: ServerState,
                  assigns: Dict[int, Assignment]) -> Dict[int, ClientResult]:
        raise NotImplementedError


class RoundLoop(Component):
    """Advances the virtual clock by one aggregation event:
    ``run_round(state)`` returns ``(state', log)``."""

    def run_round(self, state: ServerState,
                  ) -> Tuple[ServerState, RoundLog]:
        raise NotImplementedError


class ParticipationScheduler(Component):
    """Samples one round's cohort: distinct client ids, at most ``k``,
    drawn from ``state.rng``."""

    def sample(self, state: ServerState, k: int) -> list:
        raise NotImplementedError
