"""Serving runtime on PyTorch: the delivery engine (the vision lane and the
LM token and continuous features lanes), its async front door and wire
codec, and the continuous-batched decode lane.

  api           typed front door: DeliveryRequest / DeliveryResult descriptors
  engine        batched multi-tenant MoLe delivery engine (morph + Aug-Conv;
                token morph + Aug-Embedding; feature morph + Aug-projection)
  async_engine  async front door: deadline flusher, latency SLOs, admission
  decode        continuous-batched cross-tenant LM decode (K3 logits)
  queue         weighted-fair request queue + padded-microbatch coalescing
                (FairScheduler: the engine-wide WFQ virtual clock; TokenQueue;
                FairAdmissionQueue for decode admission)
  prefetch      per-tenant arrival prediction for slot prefetch
  resilience    failure injection (incl. network chaos), straggler watch,
                engine snapshots, ResilientLoop (the training loop's
                checkpoint/restart)
  wire          length-prefixed frame codec for the network front door
                (launch/server.py serves it, launch/client.py speaks it)
"""
from .api import DeliveryRequest, DeliveryResult
from .async_engine import AdmissionError, AsyncDeliveryEngine, EngineDeadError
from .decode import ContinuousDecodeLane, DecodeRow
from .engine import EngineStats, MoLeDeliveryEngine, resolve_device
from .prefetch import ArrivalPredictor
from .queue import (
    AdmittedSequence, FairAdmissionQueue, FairScheduler, Microbatch,
    QueuedRequest, RequestQueue, TokenQueue,
)
from .resilience import (
    EngineSnapshot, FailureInjector, ResilientLoop, SimulatedFailure,
    StragglerMonitor,
)
from .wire import ProtocolError

__all__ = [
    "AdmissionError",
    "AdmittedSequence",
    "ArrivalPredictor",
    "AsyncDeliveryEngine",
    "ContinuousDecodeLane",
    "DecodeRow",
    "DeliveryRequest",
    "DeliveryResult",
    "EngineDeadError",
    "EngineSnapshot",
    "EngineStats",
    "FailureInjector",
    "FairAdmissionQueue",
    "FairScheduler",
    "Microbatch",
    "MoLeDeliveryEngine",
    "ProtocolError",
    "QueuedRequest",
    "RequestQueue",
    "ResilientLoop",
    "SimulatedFailure",
    "StragglerMonitor",
    "TokenQueue",
    "resolve_device",
]
