"""Error taxonomy for the stable linker.

Mirrors the failure modes discussed in the paper: illegal registry mutation
during an epoch, unresolved symbols at materialization time, and stale /
missing relocation tables at epoch load time.
"""

from __future__ import annotations


class StableLinkingError(Exception):
    """Base class for all stable-linking errors."""


class ModeError(StableLinkingError):
    """Operation attempted in the wrong mode (epoch vs management time)."""


class ImmutableEpochError(ModeError):
    """Registry mutation attempted while the system is in an epoch."""


class UnknownObjectError(StableLinkingError):
    """A referenced object name/uuid is not present in the world view."""


class UnresolvedSymbolError(StableLinkingError):
    """A (strong) symbol reference could not be bound to any provider."""

    def __init__(self, symbol: str, requirer: str, searched: list[str]):
        self.symbol = symbol
        self.requirer = requirer
        self.searched = list(searched)
        super().__init__(
            f"unresolved symbol {symbol!r} required by {requirer!r} "
            f"(searched {len(searched)} objects: {', '.join(searched[:8])}"
            f"{', ...' if len(searched) > 8 else ''})"
        )


class UnknownStrategyError(StableLinkingError):
    """Load-strategy name not present in the strategy registry."""

    def __init__(self, name: str, available: list[str]):
        self.name = name
        self.available = list(available)
        super().__init__(
            f"unknown load strategy {name!r}; registered strategies: "
            f"{', '.join(self.available) or '(none)'} "
            "(add one with repro_torch.link.register_strategy)"
        )


class SymbolMismatchError(StableLinkingError):
    """Provider symbol exists but is ABI-incompatible (shape mismatch)."""


class StaleTableError(StableLinkingError):
    """Relocation table missing or generated under a different world/epoch."""


class PayloadIntegrityError(StableLinkingError):
    """Bundle payload digest does not match its manifest (corrupt store)."""


class StateSchemaError(StableLinkingError):
    """state.json was written by a newer schema than this build supports."""


class RollbackError(StableLinkingError):
    """An epoch rollback was requested but cannot be honoured (no retained
    generation to re-adopt, or the requested generation left the window)."""


class EpochAdoptError(StableLinkingError):
    """A serving engine failed to adopt a newly committed generation."""


class AdoptDeadlineError(EpochAdoptError):
    """``adopt_epoch(deadline_s=...)`` hit its deadline (wedged reload).

    Raised AFTER the engine auto-rolled the store back to the still-live
    previous generation and re-lifted its params — the serving loop that
    catches this resumes admission on known-good weights."""

    def __init__(self, message: str, *, rolled_back_to: int = 0):
        self.rolled_back_to = rolled_back_to
        super().__init__(message)
