"""Fault-tolerance pieces of the delivery engine, ported from
``repro.runtime.resilience``.

``FailureInjector(at_phases={"device"})`` raises ``SimulatedFailure`` at a
delivery-engine flush phase boundary (``"coalesce"`` | ``"device"`` |
``"publish"``) — once per phase, so recovery replay runs clean.  Its
step-indexed and network-chaos modes are carried over unchanged for the
front doors of later slices.

``StragglerMonitor`` flags flushes whose device phase runs far above the
running EMA.

``EngineSnapshot`` is the engine's crash image: the registry's secrets +
in-flight request accounting as ``(arrays, meta)``, persisted through
:class:`repro_torch.checkpoint.CheckpointManager` in the reference's
layout.  ``ResilientLoop`` (the training loop's checkpoint/restart) arrives
with the training slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "EngineSnapshot",
    "FailureInjector",
    "NETWORK_PHASES",
    "SimulatedFailure",
    "StragglerMonitor",
]


class SimulatedFailure(RuntimeError):
    pass


# Wire-layer chaos points understood by the server/client loops.
NETWORK_PHASES = ("accept", "read", "write", "stall")


@dataclasses.dataclass
class FailureInjector:
    at_steps: set[int] = dataclasses.field(default_factory=set)
    at_phases: set[str] = dataclasses.field(default_factory=set)
    fired: set = dataclasses.field(default_factory=set)
    # Network chaos: probabilistic and repeating (vs the one-shot step/phase
    # injection above).  Each armed phase independently fires with
    # ``network_rate`` per opportunity; "stall" sleeps ``stall_ms`` instead
    # of failing.  Seeded -> a chaos run is reproducible.
    network_phases: set[str] = dataclasses.field(default_factory=set)
    network_rate: float = 0.2
    stall_ms: float = 200.0
    seed: int = 0
    network_hits: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        unknown = set(self.network_phases) - set(NETWORK_PHASES)
        if unknown:
            raise ValueError(
                f"unknown network phases {sorted(unknown)} "
                f"(known: {NETWORK_PHASES})"
            )
        if not 0.0 <= self.network_rate <= 1.0:
            raise ValueError(f"network_rate must be in [0, 1], "
                             f"got {self.network_rate}")
        self._net_rng = np.random.default_rng(self.seed)

    def maybe_fail(self, step: int) -> None:
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")

    def maybe_fail_phase(self, phase: str) -> None:
        if phase in self.at_phases and phase not in self.fired:
            self.fired.add(phase)
            raise SimulatedFailure(f"injected failure at phase {phase!r}")

    def network_hit(self, phase: str) -> bool:
        """Roll the dice for one wire-layer opportunity at ``phase``.

        Returns True when the fault should fire (the caller drops the
        connection / truncates the frame / sleeps ``stall_ms``); every hit
        is tallied in ``network_hits`` so a chaos run can report what it
        actually injected.
        """
        if phase not in self.network_phases:
            return False
        if self._net_rng.random() >= self.network_rate:
            return False
        self.network_hits[phase] = self.network_hits.get(phase, 0) + 1
        return True


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    ema: float | None = None
    alpha: float = 0.2
    slow_steps: list[tuple[int, float]] = dataclasses.field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.slow_steps.append((step, dt))
            # Cap the flagged sample's contribution to the EMA at the flag
            # threshold: one 100x straggler must not inflate the baseline
            # and mask the next stragglers.
            dt = self.factor * self.ema
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


@dataclasses.dataclass
class EngineSnapshot:
    """A delivery engine's crash-recovery image: flat named host arrays
    (registry secrets + in-flight payloads) and a JSON-able ``meta`` tree
    (slot bookkeeping + request descriptors).  Produced by
    ``MoLeDeliveryEngine.snapshot()`` and persisted through
    :class:`repro_torch.checkpoint.CheckpointManager`'s atomic tmp-dir +
    rename protocol."""

    arrays: dict[str, np.ndarray]
    meta: dict

    def save(self, ckpt, step: int) -> None:
        """Persist through ``ckpt`` (a CheckpointManager) as step ``step``."""
        ckpt.save(step, dict(self.arrays), extra=self.meta)

    @classmethod
    def load(cls, ckpt, step: int | None = None) -> "EngineSnapshot":
        """Load the latest (or a specific) persisted snapshot."""
        arrays, meta = ckpt.load(step)
        return cls(arrays=arrays, meta=meta)
