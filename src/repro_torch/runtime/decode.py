"""Continuous-batched cross-tenant LM decode on PyTorch.

Ported from ``repro.runtime.decode``.  One shared batched decode step runs
over a fixed pool of **rows**:

  * Row ``r`` holds one tenant *sequence* — its morphed token, its absolute
    position, its slice of the ``(R, ...)`` caches (KV slots for attention
    stacks; the recurrent state and token-shift rows for RWKV), and the
    registry slot ``sidx[r]`` whose stacked AugE table / Aug-head serve its
    embedding and logits (the ``(R, d)``-row grouped GEMM, K3:
    ``kernels.ops.lm_head_rows_grouped``).
  * **Continuous batching**: between steps, finished sequences retire and
    queued ones are admitted under weighted fair queueing
    (:class:`repro_torch.runtime.queue.FairAdmissionQueue`) — a joiner
    prefills straight into its row's slice of the caches, and decoding
    resumes with the same step.
  * Inactive rows keep decoding garbage against their stale state; their
    outputs are ignored on the host.  Rows are independent (per-row
    positions, masks and gathers), so garbage rows cannot perturb live ones.

Secrets reach the step through the engine's ``_sync_plan``: stacked
``(S, V, d)`` AugE tables and ``(S, d, V)`` Aug-heads staged on the device,
patched per slot on tenant churn (a tied slot's Aug-head is its staged AugE
table transposed on the device, not a second table sent from the host).
Both are staged in the model's activation type (``cfg.adtype``): the head
product rounds every entry to it anyway (K3 and the admission prefill's
``aug_head.to(h.dtype)``), and each gathered AugE row is cast to it before
the trunk reads it (``.to(cfg.adtype)`` in the steps); torch's cast rounds
to nearest even as those do, so bf16 stacks give the same logits from half
the bytes and half the memory.  The registry and its snapshots stay fp32.
Active tenants are LRU-touched before any admission (``_pin_active``), so
registry eviction never reassigns a slot out from under a running sequence.
The reference also keeps per-slot device arrays (``keep_slots``) so
admission prefills read one slot without slicing the stack; a slot of a
torch stack is already a view, so that is not needed.

**Where the lane runs.**  ``device=None`` means the card; the CPU only when
asked for (``device="cpu"``).  The model and its parameters must live there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.lm import LMSessionRegistry

from .engine import _Plan, _host, _sync_plan, resolve_device
from .queue import FairAdmissionQueue, FairScheduler
from .resilience import EngineSnapshot

__all__ = ["ContinuousDecodeLane", "DecodeRow"]


@dataclasses.dataclass
class DecodeRow:
    """Host-side bookkeeping for one active lane row."""

    seq_id: int
    tenant_id: str
    slot: int
    remaining: int                 # decode steps still owed
    generated: list = dataclasses.field(default_factory=list)  # morphed ids
    # Admission-time descriptor, retained for crash recovery: restore()
    # replays the sequence from scratch (greedy decode is deterministic).
    prompt: np.ndarray | None = None   # morphed prompt as admitted
    max_new_tokens: int = 0
    priority: int = 0


class ContinuousDecodeLane:
    """A fixed pool of decode rows multiplexing many tenants' generations.

    Parameters
    ----------
    model, params:
        The shared trunk (tenant-independent weights), on ``device``.
        Per-tenant embedding/head artifacts come from ``registry``, never
        from ``params``.
    registry:
        :class:`LMSessionRegistry` holding every tenant's secrets.  Its
        slot capacity must be >= ``rows``: an active row pins its tenant's
        slot.
    rows:
        Decode batch width R, fixed for the lane's lifetime.
    max_len:
        KV capacity per row (prompt + generated tokens must fit).
    device:
        ``None`` (the card) or an explicit device such as ``"cpu"``.
    """

    def __init__(
        self,
        model,
        params,
        registry: LMSessionRegistry,
        *,
        rows: int = 16,
        max_len: int,
        device=None,
        injector=None,
        scheduler=None,
    ):
        if registry.capacity < rows:
            raise ValueError(
                f"registry capacity {registry.capacity} < rows {rows}: every "
                f"active row pins a slot, so the lane could deadlock"
            )
        from repro_torch.launch.steps import (
            make_batched_decode_step, make_row_prefill_step,
        )

        self.device = resolve_device(device)
        on = {model.device.type, params["embed"].device.type}
        if on != {self.device.type}:
            raise ValueError(
                f"the lane runs on {self.device}, but the model/params are "
                f"on {sorted(on)}"
            )
        self.model = model
        self.params = params
        self.registry = registry
        self.rows = int(rows)
        self.max_len = int(max_len)
        # Admission charges the scheduler max_new_tokens x decode_step_units
        # per taken sequence; pass the delivery engine's scheduler to count
        # decode appetite against the same engine-wide shares.
        if scheduler is None:
            scheduler = FairScheduler(weight_of=registry.weight_of)
        self.queue = FairAdmissionQueue(scheduler)
        self._plan: _Plan | None = None
        self._results: dict[int, np.ndarray] = {}
        # Crash-safety hook: raises SimulatedFailure at the "retire"/"admit"
        # boundaries of step().
        self.injector = injector
        self._decode = make_batched_decode_step(model)
        self._prefill = make_row_prefill_step(model)
        self._reset_rows()

    def _reset_rows(self) -> None:
        # (R, ...) caches; fresh rows are all-empty (pos = -1, zero RWKV
        # state), so the decode step computes harmlessly on garbage before
        # any admission.
        self._caches = self.model.init_cache(self.rows, self.max_len)
        self._row: list[DecodeRow | None] = [None] * self.rows
        self._sidx = np.zeros(self.rows, np.int32)
        self._tokens = np.zeros(self.rows, np.int32)
        self._t = np.zeros(self.rows, np.int32)

    # -- submission ----------------------------------------------------------
    @property
    def active(self) -> int:
        return sum(r is not None for r in self._row)

    def submit(self, tenant_id: str, prompt, max_new_tokens: int, *,
               priority: int = 0, premorphed: bool = False) -> int:
        """Queue one generation request; returns a ``seq_id`` for take().

        ``prompt`` is a (L,) / (1, L) int sequence.  The provider-side vocab
        morph is applied here unless the caller already routed the prompt
        through the engine's token lane (``premorphed=True``).
        """
        sess = self.registry.session(tenant_id)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_len ({self.max_len})"
            )
        if not premorphed:
            prompt = sess.morpher.perm[prompt].astype(np.int32)
        return self.queue.submit(
            tenant_id, prompt, max_new_tokens, priority=priority
        )

    # -- plan upkeep ---------------------------------------------------------
    def _refresh_plan(self) -> _Plan:
        """Bring the device stacks up to the registry's version: the AugE
        tables through ``_sync_plan`` (changed slots staged from the host),
        then each changed slot's Aug-head.  A tied slot's head is its AugE
        table transposed on the device; an untied one is staged from the
        registry's fused head."""
        reg, dtype = self.registry, self.model.cfg.adtype
        since = None if self._plan is None else self._plan.version
        plan = _sync_plan(self._plan, reg,
                          {"aug_embeds": reg.slot_aug_embedding},
                          self.device, {"aug_embeds": dtype})
        heads = plan.arrays.get("aug_heads")
        if heads is None:           # a new plan: every slot
            heads = torch.empty((reg.capacity, reg.d_model, reg.vocab),
                                dtype=dtype, device=self.device)
            slots = range(reg.capacity)
        else:
            slots = reg.updates_since(since)
            if slots is None:
                slots = range(reg.capacity)
        embeds = plan.arrays["aug_embeds"]
        for s in slots:
            heads[s].copy_(embeds[s].T if reg.slot_head_tied(s)
                           else _host(reg.slot_aug_head(s)))
        plan.arrays["aug_heads"] = heads
        self._plan = plan
        return plan

    def _pin_active(self) -> None:
        """LRU-touch every active tenant, then verify no active row's slot
        was reassigned (shared-registry traffic may evict between steps)."""
        for r in self._row:
            if r is not None:
                self.registry.slot_for(r.tenant_id)
        for r in self._row:
            if r is not None and (
                self.registry._slot_tenant[r.slot] != r.tenant_id
            ):
                raise RuntimeError(
                    f"tenant {r.tenant_id!r} lost slot {r.slot} mid-decode; "
                    f"size the registry capacity >= rows + concurrent "
                    f"morph-lane tenants"
                )

    # -- the continuous-batching loop ----------------------------------------
    def _row_caches(self, row: int) -> dict:
        """Row ``row``'s slice of the (R, ...) caches (views), emptied by
        cache kind: attention slots zeroed and marked empty (``pos`` = -1),
        MLA's latent and roped-key caches (``ckv``, ``kr``), the RG-LRU
        state and conv inputs (``h``, ``conv``: a row's recurrence starts
        from zeros, as a prefill's does), the RWKV state and token-shift
        rows (``s``, ``tm_x``, ``cm_x``) zeroed.  An
        MLA layer masks by position (``arange <= t``), as the reference,
        whose prefill also zeroes the positions past the prompt."""
        view = {"blocks": [
            {name: c[name][row : row + 1] for name in c}
            for c in self._caches["blocks"]
        ]}
        for c in view["blocks"]:
            for name, x in c.items():
                x.fill_(-1 if name == "pos" else 0)
        return view

    def _admit(self) -> None:
        free = [i for i, r in enumerate(self._row) if r is None]
        while free and len(self.queue):
            item = self.queue.take()
            row = free.pop(0)
            # Touch active tenants *before* assigning the joiner's slot, so
            # registry LRU eviction lands on an inactive slot — there is one
            # whenever a row is free, because capacity >= rows > active.
            self._pin_active()
            slot = self.registry.slot_for(item.tenant_id)
            plan = self._refresh_plan()
            tok0, _ = self._prefill(
                self.params,
                plan.arrays["aug_embeds"][slot],
                plan.arrays["aug_heads"][slot],
                torch.from_numpy(item.prompt[None, :]).to(self.device),
                self._row_caches(row),
            )
            first = int(tok0[0])
            self._row[row] = DecodeRow(
                seq_id=item.seq_id, tenant_id=item.tenant_id, slot=slot,
                remaining=item.max_new_tokens - 1, generated=[first],
                prompt=item.prompt, max_new_tokens=item.max_new_tokens,
                priority=item.priority,
            )
            self._sidx[row] = slot
            self._tokens[row] = first
            self._t[row] = item.prompt.size

    def _retire(self) -> None:
        for i, r in enumerate(self._row):
            if r is not None and r.remaining == 0:
                inv = self.registry.session(r.tenant_id).morpher.inv_perm
                self._results[r.seq_id] = inv[
                    np.asarray(r.generated, np.int64)
                ].astype(np.int32)
                self._row[i] = None

    def step(self) -> int:
        """Retire finished rows, admit queued sequences, run one batched
        decode step.  Returns the number of rows still active."""
        if self.injector is not None:
            self.injector.maybe_fail_phase("retire")
        self._retire()
        if self.injector is not None:
            self.injector.maybe_fail_phase("admit")
        self._admit()
        if self.active == 0:
            return 0
        self._pin_active()
        plan = self._refresh_plan()
        dev = self.device
        next_tok, self._caches = self._decode(
            self.params,
            plan.arrays["aug_embeds"], plan.arrays["aug_heads"],
            torch.from_numpy(self._sidx).to(dev),
            torch.from_numpy(self._tokens).to(dev),
            torch.from_numpy(self._t).to(dev), self._caches,
        )
        next_host = next_tok.cpu().numpy()
        for i, r in enumerate(self._row):
            if r is None or r.remaining == 0:
                continue
            r.generated.append(int(next_host[i]))
            r.remaining -= 1
            self._tokens[i] = next_host[i]
            self._t[i] += 1
        return self.active

    def run(self) -> None:
        """Drive steps until every queued/active sequence has finished."""
        while len(self.queue) or self.active:
            self.step()
        self._retire()

    def take(self, seq_id: int) -> np.ndarray:
        """Redeem a finished sequence's unmorphed generated tokens."""
        if seq_id not in self._results:
            raise KeyError(
                f"sequence {seq_id} not finished (or already taken)"
            )
        return self._results.pop(seq_id)

    # -- crash safety: snapshot / restore ------------------------------------
    def snapshot(self) -> EngineSnapshot:
        """Capture a crash-recovery image of the lane: registry secrets
        (under ``lm/``), every unfinished sequence's admitted (morphed)
        prompt and descriptor, and every finished-but-untaken result.  KV
        caches are not kept: :meth:`restore` replays unfinished sequences
        from scratch (greedy decode is deterministic)."""
        arrays: dict[str, np.ndarray] = {}
        rmeta, rarrays = self.registry.snapshot_state()
        for k, v in rarrays.items():
            arrays[f"lm/{k}"] = v
        meta: dict = {
            "registry": rmeta,
            "next_sid": self.queue._next_id,
            "scheduler": self.queue.scheduler.snapshot_state(),
            "sequences": [],
            "finished": sorted(self._results),
        }
        live = [r for r in self._row if r is not None]
        for entry in live + self.queue.snapshot_items():
            sid = int(entry.seq_id)
            meta["sequences"].append({
                "sid": sid, "tenant": entry.tenant_id,
                "max_new_tokens": int(entry.max_new_tokens),
                "priority": int(entry.priority),
            })
            arrays[f"seq/{sid:08d}/prompt"] = np.asarray(entry.prompt)
        for sid in meta["finished"]:
            arrays[f"res/{sid:08d}/tokens"] = self._results[sid]
        # analysis: declassified(crash image: held in memory by the caller)
        return EngineSnapshot(arrays=arrays, meta=meta)

    def restore(self, snap: EngineSnapshot) -> list[int]:
        """Rebuild the lane from a :meth:`snapshot` image; returns the
        unfinished seq_ids that were re-queued (admission order).

        Every unfinished sequence re-enters the admission queue under its
        original seq_id with its original (already morphed) prompt; the next
        :meth:`run` regenerates it.  Rows, caches and positions are reset.
        """
        meta, arrays = snap.meta, snap.arrays
        self.registry.restore_state(
            meta["registry"],
            {k[3:]: v for k, v in arrays.items() if k.startswith("lm/")},
        )
        self._plan = None
        self._reset_rows()
        self.queue.release()   # return backlog refs before swapping queues
        self.queue = FairAdmissionQueue(self.queue.scheduler)
        if meta.get("scheduler") is not None:
            self.queue.scheduler.restore_state(meta["scheduler"])
        self._results = {}
        pending: list[int] = []
        for desc in meta["sequences"]:
            sid = int(desc["sid"])
            # Straight into the raw queue: the stored prompt is already
            # morphed, so submit() would double-morph it.
            self.queue.submit(
                desc["tenant"], arrays[f"seq/{sid:08d}/prompt"],
                int(desc["max_new_tokens"]), priority=int(desc["priority"]),
                sid=sid,
            )
            pending.append(sid)
        for sid in meta["finished"]:
            sid = int(sid)
            self._results[sid] = arrays[f"res/{sid:08d}/tokens"]
        self.queue._next_id = max(self.queue._next_id, int(meta["next_sid"]))
        return pending
