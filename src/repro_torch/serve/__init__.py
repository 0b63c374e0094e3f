"""Fault-tolerant batched GNN inference over the LMC historical store.

  types.py   — ServeRequest/ServeResponse + the typed error ladder
  gateway.py — arbitrary target sets -> fixed-shape bucket batches
  policy.py  — ServeConfig, degradation ladder (breaker / ρ-staleness / crc)
  server.py  — GNNServer: admission queue, batcher, worker loop, repair
"""
from repro_torch.serve.gateway import StoreGateway, request_pads
from repro_torch.serve.policy import (MODE_EXACT, MODE_TI, CircuitBreaker,
                                      DegradationPolicy, ServeConfig,
                                      StoreIntegrity)
from repro_torch.serve.server import GNNServer, warm_store
from repro_torch.serve.types import (STATUS_CLOSED, STATUS_DEGRADED,
                                     STATUS_ERROR, STATUS_OK,
                                     STATUS_OVERLOADED, STATUS_TIMEOUT,
                                     STATUS_TOO_LARGE, DeadlineExceeded,
                                     Overloaded, RequestTooLarge, ServeError,
                                     ServeRequest, ServeResponse,
                                     ServerClosed)

__all__ = [
    "GNNServer", "warm_store", "StoreGateway", "request_pads",
    "ServeConfig", "DegradationPolicy", "CircuitBreaker", "StoreIntegrity",
    "MODE_EXACT", "MODE_TI",
    "ServeRequest", "ServeResponse", "ServeError", "Overloaded",
    "DeadlineExceeded", "RequestTooLarge", "ServerClosed",
    "STATUS_OK", "STATUS_DEGRADED", "STATUS_OVERLOADED", "STATUS_TIMEOUT",
    "STATUS_TOO_LARGE", "STATUS_CLOSED", "STATUS_ERROR",
]
