"""Serving runtime on PyTorch: the synchronous delivery engine (vision and
LM token lanes) and the continuous-batched decode lane.

  api         typed front door: DeliveryRequest / DeliveryResult descriptors
  engine      batched multi-tenant MoLe delivery engine (morph + Aug-Conv;
              token morph + Aug-Embedding)
  decode      continuous-batched cross-tenant LM decode (K3 logits)
  queue       weighted-fair request queue + padded-microbatch coalescing
              (FairScheduler: the engine-wide WFQ virtual clock; TokenQueue;
              FairAdmissionQueue for decode admission)
  prefetch    per-tenant arrival prediction for slot prefetch
  resilience  failure injection, straggler watch, in-memory engine snapshots

The async engine and the wire protocol of ``repro.runtime`` arrive with
later slices of the port.
"""
from .api import DeliveryRequest, DeliveryResult
from .decode import ContinuousDecodeLane, DecodeRow
from .engine import EngineStats, MoLeDeliveryEngine, resolve_device
from .prefetch import ArrivalPredictor
from .queue import (
    AdmittedSequence, FairAdmissionQueue, FairScheduler, Microbatch,
    QueuedRequest, RequestQueue, TokenQueue,
)
from .resilience import (
    EngineSnapshot, FailureInjector, SimulatedFailure, StragglerMonitor,
)

__all__ = [
    "AdmittedSequence",
    "ArrivalPredictor",
    "ContinuousDecodeLane",
    "DecodeRow",
    "DeliveryRequest",
    "DeliveryResult",
    "EngineSnapshot",
    "EngineStats",
    "FailureInjector",
    "FairAdmissionQueue",
    "FairScheduler",
    "Microbatch",
    "MoLeDeliveryEngine",
    "QueuedRequest",
    "RequestQueue",
    "SimulatedFailure",
    "StragglerMonitor",
    "TokenQueue",
    "resolve_device",
]
