"""Serving runtime on PyTorch: the synchronous vision delivery lane.

  api         typed front door: DeliveryRequest / DeliveryResult descriptors
  engine      batched multi-tenant MoLe delivery engine (morph + Aug-Conv)
  queue       weighted-fair request queue + padded-microbatch coalescing
              (FairScheduler: the engine-wide WFQ virtual clock)
  prefetch    per-tenant arrival prediction for slot prefetch
  resilience  failure injection, straggler watch, in-memory engine snapshots

The async engine, the decode lane and the wire protocol of
``repro.runtime`` arrive with later slices of the port.
"""
from .api import DeliveryRequest, DeliveryResult
from .engine import EngineStats, MoLeDeliveryEngine, resolve_device
from .prefetch import ArrivalPredictor
from .queue import FairScheduler, Microbatch, QueuedRequest, RequestQueue
from .resilience import (
    EngineSnapshot, FailureInjector, SimulatedFailure, StragglerMonitor,
)

__all__ = [
    "ArrivalPredictor",
    "DeliveryRequest",
    "DeliveryResult",
    "EngineSnapshot",
    "EngineStats",
    "FailureInjector",
    "FairScheduler",
    "Microbatch",
    "MoLeDeliveryEngine",
    "QueuedRequest",
    "RequestQueue",
    "SimulatedFailure",
    "StragglerMonitor",
    "resolve_device",
]
