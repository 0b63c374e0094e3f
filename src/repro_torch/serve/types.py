"""Serving request/response types and the typed error ladder (DESIGN.md §12).

Every admission outcome is a :class:`ServeResponse` with a machine-readable
``status`` — the server never raises across the submit boundary and never
drops a request silently. The exception classes exist for callers that prefer
control flow over status inspection (``ServeResponse.raise_for_status``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# response status values, in degradation-ladder order
STATUS_OK = "ok"                  # exact path (historical store) answered
STATUS_DEGRADED = "degraded"      # store-free ti path answered (see reason)
STATUS_OVERLOADED = "overloaded"  # shed at admission: queue full
STATUS_TIMEOUT = "timeout"        # deadline expired before an answer
STATUS_TOO_LARGE = "too-large"    # request exceeds the largest pad bucket
STATUS_CLOSED = "closed"          # server was shut down without drain
STATUS_ERROR = "error"            # retries exhausted on a hard failure


class ServeError(RuntimeError):
    """Base class of the serving tier's typed failures."""


class Overloaded(ServeError):
    """Admission queue full — the request was shed, not queued."""


class DeadlineExceeded(ServeError):
    """The per-request deadline expired before a response was produced."""


class RequestTooLarge(ServeError):
    """More target nodes than the largest configured pad bucket."""


class ServerClosed(ServeError):
    """Submitted to (or abandoned by) a server that is shutting down."""


_STATUS_ERRORS = {
    STATUS_OVERLOADED: Overloaded,
    STATUS_TIMEOUT: DeadlineExceeded,
    STATUS_TOO_LARGE: RequestTooLarge,
    STATUS_CLOSED: ServerClosed,
    STATUS_ERROR: ServeError,
}


@dataclasses.dataclass
class ServeRequest:
    """One inference request: predict classes for ``nodes`` (global ids).

    ``deadline_s`` is a relative budget from submission; ``None`` uses the
    server's ``ServeConfig.default_deadline_s``.
    """

    nodes: np.ndarray
    request_id: str = ""
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class ServeResponse:
    """Outcome of one request; always produced, whatever happened.

    ``classes`` aligns with the request's ``nodes`` (argmax logits); ``mode``
    records which rung of the degradation ladder answered ("exact" — the
    historical-store path — or "ti" — the store-free message-invariance
    path), and ``degraded_reason`` says why the ladder dropped a rung
    (staleness budget, crc mismatch, NaN circuit breaker, ...).
    """

    request_id: str
    status: str
    classes: Optional[np.ndarray] = None
    logits: Optional[np.ndarray] = None
    mode: Optional[str] = None
    degraded_reason: Optional[str] = None
    latency_s: float = 0.0
    attempts: int = 0
    batch_seq: int = -1
    detail: str = ""

    @property
    def ok(self) -> bool:
        """True iff the request was answered (exact or degraded)."""
        return self.status in (STATUS_OK, STATUS_DEGRADED)

    def raise_for_status(self) -> "ServeResponse":
        """Raise the matching typed error for non-answer statuses."""
        if not self.ok:
            err = _STATUS_ERRORS.get(self.status, ServeError)
            raise err(f"request {self.request_id or '<anon>'}: "
                      f"{self.status} {self.detail}".rstrip())
        return self
