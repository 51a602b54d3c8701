"""Fault-tolerance runtime on PyTorch, ported from
``repro.runtime.resilience``: failure injection, the training loop's
checkpoint/restart, straggler watch, engine snapshots.

``ResilientLoop`` drives ``(state, batch) -> (state, metrics)`` steps with
periodic and final checkpoints (async, atomic: see
:mod:`repro_torch.checkpoint.manager`), a deterministic data seek (the
pipeline's index rides in each checkpoint's extra) and a restore from the
latest checkpoint when a step fails.  The state's tensors are restored in
place (``CheckpointManager.restore_into``), so the caller's parameters stay
live; a failure before the first checkpoint puts back the state the run
started from, where the reference keeps what it trained so far (see
:meth:`ResilientLoop.run`).  Restore onto another mesh
(``CheckpointManager.restore(shardings=)``) is not ported yet: it is
ROADMAP item 9d, on the meshes of :mod:`repro_torch.launch.mesh`.

``FailureInjector(at_steps={...})`` raises ``SimulatedFailure`` from inside
the loop at chosen steps; ``FailureInjector(at_phases={"device"})`` raises
at a delivery-engine flush phase boundary (``"coalesce"`` | ``"device"`` |
``"publish"``) — once per phase, so recovery replay runs clean.  Its
network-chaos mode serves the front doors.

``StragglerMonitor`` flags steps (the loop's) and flushes (the engine's
device phase) far above the running EMA.

``EngineSnapshot`` is the engine's crash image: the registry's secrets +
in-flight request accounting as ``(arrays, meta)``, persisted through
:class:`repro_torch.checkpoint.CheckpointManager` in the reference's
layout.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from ..checkpoint.manager import tree_leaves

__all__ = [
    "EngineSnapshot",
    "FailureInjector",
    "NETWORK_PHASES",
    "ResilientLoop",
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


def _synchronize(state: Any) -> None:
    """Wait for the device the state lives on (nothing to wait for on the
    CPU): the step's wall time then covers its device work."""
    leaves = tree_leaves(state)
    if leaves and isinstance(leaves[0], torch.Tensor) and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)


class ResilientLoop:
    """Drives (state, batch) -> state steps with checkpoint/restart."""

    def __init__(
        self,
        step_fn: Callable[..., Any],
        ckpt,                       # CheckpointManager
        pipeline,                   # repro_torch.data.pipeline.Pipeline
        ckpt_every: int = 50,
        injector: FailureInjector | None = None,
        max_restarts: int = 8,
        on_restore: Callable[[Any], Any] | None = None,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.pipeline = pipeline
        self.ckpt_every = ckpt_every
        self.injector = injector
        self.max_restarts = max_restarts
        self.on_restore = on_restore
        self.straggler = StragglerMonitor()
        self.restarts = 0

    def _armed(self, start_step: int, n_steps: int) -> bool:
        inj = self.injector
        return inj is not None and any(
            start_step <= s < n_steps for s in inj.at_steps - inj.fired)

    def run(self, state: Any, n_steps: int, start_step: int = 0):
        """Returns (state, metrics_history).  ``state`` is a tree of
        tensors (dicts, lists, :class:`ParamTree`) the step_fn maps to the
        next state given a batch; a history entry is the step's metrics
        with ``step`` and ``wall_s``, or ``{step, event}`` for a restart.

        A failure restores the latest checkpoint into the live state's
        tensors and seeks the pipeline to the index saved with it; the
        writer of a checkpoint still in flight is joined first, so a save
        the loop already made counts.  A failure before any checkpoint
        exists restarts from ``start_step`` with the state the run was
        given, put back in place from a host copy taken at the start (only
        when an injected failure can fire in this run).  The reference
        keeps the state trained so far there and trains those batches
        twice."""
        history: list[dict] = []
        step = start_step
        initial = None
        if self._armed(start_step, n_steps) and self.ckpt.latest_step() is None:
            initial = [leaf.detach().to("cpu", copy=True)
                       for leaf in tree_leaves(state)]
        while step < n_steps:
            try:
                batch = next(self.pipeline)
                if self.injector:
                    self.injector.maybe_fail(step)
                t0 = time.time()
                state, metrics = self.step_fn(state, batch)
                _synchronize(state)
                dt = time.time() - t0
                self.straggler.record(step, dt)
                metrics = dict(metrics, step=step, wall_s=dt)
                history.append(metrics)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state, extra={"data": {"index": self.pipeline.index}})
            except SimulatedFailure as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    # nothing saved yet: restart from scratch deterministically
                    with torch.no_grad():
                        for leaf, saved in zip(tree_leaves(state), initial):
                            leaf.copy_(saved)
                    step = start_step
                    self.pipeline.seek(start_step)
                    history.append({"step": step, "event": f"restart-clean: {e}"})
                    continue
                extra = self.ckpt.restore_into(latest, state)
                if self.on_restore:
                    state = self.on_restore(state)
                step = latest
                self.pipeline.seek(extra["data"]["index"])
                history.append({"step": step, "event": f"restored@{latest}: {e}"})
        self.ckpt.save(n_steps, state, extra={"data": {"index": self.pipeline.index}})
        self.ckpt.wait()
        return state, history
