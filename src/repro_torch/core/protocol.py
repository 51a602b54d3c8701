"""End-to-end MoLe protocol roles (paper Fig. 1), PyTorch port of
``repro.core.protocol`` (vision half).

Flow:
  1. Developer trains his network on a *public* dataset and sends the first
     conv layer's kernels ``K`` to the provider.
  2. Provider draws the secret ``M'`` (+ channel permutation), builds
     ``C^{ac} = rand(M^{-1} C)`` and ships it to the developer, then streams
     morphed batches ``T^r = D^r M``.
  3. Developer replaces layer 1 with the fixed ``C^{ac}`` and trains/serves on
     morphed data; the rest of the network is untouched.

Secrets are drawn and fused on the host in numpy, exactly as in the
reference, so the same seeds give byte-equal secrets in both packages and a
reference ``SessionRegistry.snapshot_state()`` loads here through
:meth:`SlotRegistry.restore_state`.  Morphing and the Aug-Conv forward run on
torch, on the device of the data they are given; each party keeps one copy
of its secret matrix per device it has served on, as the reference keeps
its developer matrix on the accelerator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .aug_conv import AugConv, apply_aug_conv, build_aug_conv, random_channel_perm
from .d2r import ConvGeometry, reroll_batch, unroll_batch
from .morphing import MorphCore, make_core, morph
from . import overhead as _overhead
from . import security as _security

__all__ = [
    "DataProvider",
    "Developer",
    "MoLeSession",
    "SessionRegistry",
    "SlotRegistry",
]


def _resident(cache: dict, array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` as a tensor on ``device``, copied there once and reused."""
    t = cache.get(device)
    if t is None:
        host = np.require(array, requirements=("C", "W"))  # copies read-only
        t = cache[device] = torch.from_numpy(host).to(device)
    return t


class DataProvider:
    """Entity A: owns private data + the secrets (M', channel perm)."""

    def __init__(
        self,
        geom: ConvGeometry,
        kappa: int,
        seed: int = 0,
        core_mode: str = "orthogonal",
    ):
        rng = np.random.default_rng(seed)
        core = make_core(rng, geom.in_features, kappa, mode=core_mode)
        self._set_secrets(geom, kappa, core, random_channel_perm(rng, geom.beta))

    @classmethod
    def from_secrets(cls, geom: ConvGeometry, kappa: int, core: MorphCore,
                     perm: np.ndarray) -> "DataProvider":
        """A provider holding given secrets (registry restore)."""
        prov = cls.__new__(cls)
        prov._set_secrets(geom, kappa, core, perm)
        return prov

    def _set_secrets(self, geom, kappa, core, perm) -> None:
        self.geom = geom
        self.kappa = kappa
        self._core: MorphCore = core
        self._perm = perm
        self._core_on: dict = {}      # device -> core tensor
        self._inverse_on: dict = {}

    # -- protocol step 2a: build the developer-facing Aug-Conv artifact ----
    def build_aug_conv(self, dev_kernels: np.ndarray) -> AugConv:
        return build_aug_conv(dev_kernels, self.geom, self._core, self._perm)

    # -- protocol step 2b: stream morphed data ------------------------------
    def morph_batch(self, data: torch.Tensor) -> torch.Tensor:
        """(B, alpha, m, m) -> morphed row vectors (B, alpha*m*m)."""
        return self.morph_rows(unroll_batch(data))

    def morph_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Morph already-unrolled rows (B, F)."""
        core = _resident(self._core_on, self._core.matrix, rows.device)
        return morph(rows, core, self.kappa)

    # -- provider-side utilities (never cross the trust boundary) -----------
    def unmorph_rows(self, rows: torch.Tensor) -> torch.Tensor:
        inv = _resident(self._inverse_on, self._core.inverse, rows.device)
        return morph(rows, inv, self.kappa)

    def morphed_image(self, data: torch.Tensor) -> torch.Tensor:
        """Morph and re-roll to image shape — for SSIM / visualization."""
        t = self.morph_batch(data)
        return reroll_batch(t, self.geom.alpha, self.geom.m)

    def security(self, sigma: float = 0.5) -> _security.MoLeSecurity:
        g = self.geom
        return _security.analyze(
            sigma=sigma, alpha=g.alpha, beta=g.beta, m=g.m, n=g.n, p=g.p,
            kappa=self.kappa,
        )

    def overhead(self, network_macs: int, dataset_images: int) -> _overhead.OverheadReport:
        g = self.geom
        return _overhead.analyze(
            alpha=g.alpha, beta=g.beta, m=g.m, n=g.n, p=g.p, kappa=self.kappa,
            network_macs=network_macs, dataset_images=dataset_images,
        )


class Developer:
    """Entity B: receives only ``C^{ac}``; runs the network on morphed rows."""

    def __init__(self, aug_matrix: np.ndarray, geom: ConvGeometry):
        # NOTE: a real developer receives the ndarray only; AugConv.channel_perm
        # never reaches this class.  Held in fp32, as the reference's
        # jnp.asarray holds it.
        self.aug_matrix = np.asarray(aug_matrix, np.float32)
        self.geom = geom
        self._aug_on: dict = {}       # device -> C^{ac} tensor

    def first_layer(self, morphed_rows: torch.Tensor) -> torch.Tensor:
        """(B, F_in) -> (B, beta, n, n) feature maps for the rest of the net."""
        mat = _resident(self._aug_on, self.aug_matrix, morphed_rows.device)
        fr = apply_aug_conv(morphed_rows, mat)
        return reroll_batch(fr, self.geom.beta, self.geom.n)


@dataclasses.dataclass
class MoLeSession:
    """Convenience bundle wiring both parties for examples/benchmarks."""

    provider: DataProvider
    developer: Developer
    geom: ConvGeometry

    @classmethod
    def create(
        cls,
        dev_kernels: np.ndarray,
        geom: ConvGeometry,
        kappa: int = 1,
        seed: int = 0,
        core_mode: str = "orthogonal",
    ) -> "MoLeSession":
        provider = DataProvider(geom, kappa=kappa, seed=seed, core_mode=core_mode)
        aug = provider.build_aug_conv(dev_kernels)
        developer = Developer(aug.matrix, geom)
        return cls(provider=provider, developer=developer, geom=geom)

    def deliver(self, data: torch.Tensor) -> torch.Tensor:
        """Provider morphs a batch; developer extracts features from it.

        The per-request baseline the delivery engine is held against: two
        plain ``torch.matmul`` calls on ``data``'s device.
        """
        return self.developer.first_layer(self.provider.morph_batch(data))


class SlotRegistry:
    """Shape-stable slot bookkeeping shared by every tenant-session registry.

    A registry maps tenant ids to host-side session objects (the "host
    store") and assigns each *active* tenant a slot in a fixed-capacity slot
    table.  Subclasses decide what a session is (vision ``MoLeSession``, LM
    ``LMSession``, ...) and how a slot's secrets materialize into stacked
    device arrays; this base owns everything churn-related:

      * slot assignment + LRU eviction with host offload (evicted tenants
        keep their secrets in the host store and transparently regain a slot
        on their next ``slot_for`` lookup);
      * auto-capacity growth by doubling when ``capacity=None``;
      * the ``version`` counter + slot changelog consumed by the delivery
        engine's ``updates_since`` incremental device patches, which keep
        tenant churn from ever restaging a whole secret stack.
    """

    # Changelog entries retained per slot of capacity before updates_since
    # gives up and requests a full rebuild.
    _LOG_FACTOR = 4

    def __init__(self, capacity: int | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._auto_capacity = capacity is None
        self._slot_tenant: list[str | None] = [None] * (capacity or 1)
        self._slot_of: dict[str, int] = {}
        self._sessions: dict = {}                     # host store: ALL tenants
        self._weights: dict[str, float] = {}          # WFQ share (default 1.0)
        self._order: list[str] = []
        self._clock = 0
        self._last_used: dict[str, int] = {}
        self.version = 0
        self.evictions = 0
        self._slot_log: list[tuple[int, int]] = []    # (version, slot)

    def __len__(self) -> int:
        return len(self._order)

    def __repr__(self) -> str:
        # Redacted: slot bookkeeping only — never session/secret contents.
        return (
            f"<{type(self).__name__} capacity={len(self._slot_tenant)} "
            f"tenants={len(self._order)} resident={len(self._slot_of)} "
            f"version={self.version} evictions={self.evictions}>"
        )

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self._sessions

    @property
    def tenant_ids(self) -> tuple[str, ...]:
        return tuple(self._order)

    @property
    def capacity(self) -> int:
        return len(self._slot_tenant)

    @property
    def resident_tenants(self) -> tuple[str, ...]:
        return tuple(t for t in self._slot_tenant if t is not None)

    def is_resident(self, tenant_id: str) -> bool:
        return tenant_id in self._slot_of

    # -- slot bookkeeping ----------------------------------------------------
    def _log_slot(self, slot: int) -> None:
        self.version += 1
        self._slot_log.append((self.version, slot))
        if len(self._slot_log) > self._LOG_FACTOR * self.capacity:
            del self._slot_log[: len(self._slot_log) // 2]

    def _touch(self, tenant_id: str) -> None:
        self._clock += 1
        self._last_used[tenant_id] = self._clock

    def _assign_slot(self, tenant_id: str) -> int:
        try:
            slot = self._slot_tenant.index(None)
        except ValueError:
            if self._auto_capacity:
                # Grow by doubling: the engine notices the stacked-shape
                # change and rebuilds; only O(log T) such rebuilds ever occur.
                slot = self.capacity
                self._slot_tenant.extend([None] * self.capacity)
            else:
                victim = min(self._slot_of, key=self._last_used.__getitem__)
                slot = self.evict(victim)
        self._slot_tenant[slot] = tenant_id
        self._slot_of[tenant_id] = slot
        self._log_slot(slot)
        self._touch(tenant_id)
        return slot

    def evict(self, tenant_id: str) -> int:
        """Offload a tenant's secrets back to the host store, freeing its slot.

        The session (and its secrets) survive in host memory; the device-side
        stacked arrays zero the slot on the engine's next plan refresh.
        Returns the freed slot index.
        """
        slot = self._slot_of.pop(tenant_id)
        self._slot_tenant[slot] = None
        self._last_used.pop(tenant_id, None)
        self.evictions += 1
        self._log_slot(slot)
        return slot

    def ensure_resident(self, tenant_id: str) -> int:
        """Give a registered tenant a slot (LRU-evicting if needed)."""
        slot = self._slot_of.get(tenant_id)
        if slot is None:
            if tenant_id not in self._sessions:
                raise KeyError(f"unknown tenant {tenant_id!r}")
            slot = self._assign_slot(tenant_id)
        return slot

    def slot_for(self, tenant_id: str) -> int:
        """Resident slot index for a tenant (activates + LRU-touches it)."""
        slot = self.ensure_resident(tenant_id)
        self._touch(tenant_id)
        return slot

    # Back-compat name from the pre-slot registry.
    tenant_index = slot_for

    def prefetch(self, tenant_ids) -> dict[str, int]:
        """Activate (and LRU-touch) each tenant in order, returning
        {tenant_id: slot} — the registry half of the engine's slot prefetch.

        Prefetching more tenants than there are slots keeps the *last*
        ``capacity`` of them resident: earlier ones are simply the oldest
        LRU entries and get evicted by the later ones.
        """
        return {t: self.slot_for(t) for t in tenant_ids}

    # -- weighted fair queueing shares ---------------------------------------
    def weight_of(self, tenant_id: str) -> float:
        """Tenant's WFQ share (1.0 unless set).  The registry is the single
        place weights resolve: the delivery engine's shared
        ``FairScheduler`` calls this on every submit, so the share is
        **engine-wide** — under saturation a weight-2 tenant is served ~2x a
        weight-1 tenant's service units *summed over every lane* (vision
        rows, LM tokens, continuous features, decode steps), not 2x per
        lane."""
        return self._weights.get(tenant_id, 1.0)

    def set_weight(self, tenant_id: str, weight: float) -> None:
        """Set a registered tenant's WFQ share (provider-side policy: weights
        live on the registry, not on requests, so a tenant cannot grant
        itself a larger share of the fleet).  Takes effect on the tenant's
        next submit — the engine's scheduler re-resolves weights through
        :meth:`weight_of`; no queue needs draining."""
        if tenant_id not in self._sessions:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        if not weight > 0:
            raise ValueError(f"weight must be positive, got {weight}")
        self._weights[tenant_id] = float(weight)

    def updates_since(self, version: int) -> list[int] | None:
        """Slots whose contents changed after ``version`` (deduplicated).

        Returns None when the changelog no longer reaches back that far (or
        the caller's version is from the future) — full rebuild required.
        """
        if version == self.version:
            return []
        if version > self.version:
            return None
        covered_from = self._slot_log[0][0] - 1 if self._slot_log else self.version
        if version < covered_from:
            return None
        return sorted({s for v, s in self._slot_log if v > version})

    @staticmethod
    def _resolve_seed(seed: int | None) -> int:
        if seed is None:
            # Secrets must not be derivable from public identifiers: default
            # to OS entropy.  Pass an explicit seed only for reproducibility
            # in trusted test/benchmark setups.
            import secrets as _secrets

            seed = _secrets.randbits(31)
        return seed

    def _adopt(self, tenant_id: str, sess) -> None:
        """Enter a freshly-built session into the host store + a slot."""
        if tenant_id in self._sessions:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        self._sessions[tenant_id] = sess
        self._order.append(tenant_id)
        self._assign_slot(tenant_id)

    def session(self, tenant_id: str):
        return self._sessions[tenant_id]

    # -- crash-recovery serialization ----------------------------------------
    # Subclasses implement the per-session halves; this base serializes every
    # piece of slot bookkeeping so a restored registry is indistinguishable
    # from the original (same slots, same LRU order, same version/changelog —
    # the engine's incremental device patches keep working across a restore).

    def _session_state(self, sess) -> tuple[dict, dict[str, np.ndarray]]:
        raise NotImplementedError

    def _session_from_state(self, meta: dict, arrays: dict[str, np.ndarray]):
        raise NotImplementedError

    def _config_state(self) -> dict:
        raise NotImplementedError

    def snapshot_state(self) -> tuple[dict, dict[str, np.ndarray]]:
        """Serialize the registry to a JSON-able meta dict + flat named host
        arrays (the secrets).  Inverse of :meth:`restore_state`."""
        arrays: dict[str, np.ndarray] = {}
        sessions: dict[str, dict] = {}
        for i, tenant in enumerate(self._order):
            smeta, sarrays = self._session_state(self._sessions[tenant])
            sessions[tenant] = dict(smeta, index=i)
            for name, arr in sarrays.items():
                arrays[f"s{i:05d}/{name}"] = np.asarray(arr)
        meta = {
            "kind": type(self).__name__,
            "config": self._config_state(),
            "capacity": self.capacity,
            "auto_capacity": self._auto_capacity,
            "order": list(self._order),
            "slot_tenant": list(self._slot_tenant),
            "slot_of": dict(self._slot_of),
            "weights": dict(self._weights),
            "clock": self._clock,
            "last_used": dict(self._last_used),
            "version": self.version,
            "evictions": self.evictions,
            "slot_log": [list(e) for e in self._slot_log],
            "sessions": sessions,
        }
        # analysis: declassified(registry crash image: consumed by restore_state via CheckpointManager only)
        return meta, arrays

    def restore_state(self, meta: dict, arrays: dict[str, np.ndarray]) -> None:
        """Overwrite this registry's state with a snapshot's.  The registry
        must have been constructed with the same config (geometry/kappa/...)
        as the one that snapshotted; tenants registered on this instance are
        discarded."""
        if meta["kind"] != type(self).__name__:
            raise ValueError(
                f"snapshot is a {meta['kind']}, not a {type(self).__name__}"
            )
        if meta["config"] != self._config_state():
            raise ValueError(
                f"registry config mismatch: snapshot {meta['config']} vs "
                f"this registry {self._config_state()}"
            )
        sessions: dict = {}
        for tenant, smeta in meta["sessions"].items():
            i = smeta["index"]
            prefix = f"s{i:05d}/"
            sarrays = {
                k[len(prefix):]: v
                for k, v in arrays.items() if k.startswith(prefix)
            }
            sessions[tenant] = self._session_from_state(smeta, sarrays)
        self._sessions = sessions
        self._order = list(meta["order"])
        self._auto_capacity = bool(meta["auto_capacity"])
        self._slot_tenant = list(meta["slot_tenant"])
        self._slot_of = {t: int(s) for t, s in meta["slot_of"].items()}
        self._weights = {t: float(w) for t, w in meta["weights"].items()}
        self._clock = int(meta["clock"])
        self._last_used = {t: int(c) for t, c in meta["last_used"].items()}
        self.version = int(meta["version"])
        self.evictions = int(meta["evictions"])
        self._slot_log = [(int(v), int(s)) for v, s in meta["slot_log"]]


class SessionRegistry(SlotRegistry):
    """Provider-side registry of per-tenant MoLe sessions (delivery engine hook).

    All tenants share one ``ConvGeometry`` and ``kappa`` — that is what makes
    their secrets *stackable*: the engine stages the cores as a dense
    ``(S, q, q)`` device tensor and the Aug-Conv matrices as
    ``(S, F_in, F_out)``, so ``repro_torch.runtime.engine`` can execute many
    tenants' morph + Aug-Conv as one grouped GEMM per kernel.  Each tenant
    still has its own independent secret core and channel permutation;
    nothing is shared across the trust boundary between tenants.

    **Shape-stable slots** (see :class:`SlotRegistry`).  The stacks have a
    fixed leading dim ``S == capacity``; tenants are assigned to slots on
    registration and evicted LRU (their secrets stay in the host-side session
    store — "host offload") when the slots run out.  ``version`` increments
    on every slot-content change; ``updates_since`` gives the engine the
    changed slots so it patches its device stacks slot by slot.
    """

    def __init__(self, geom: ConvGeometry, kappa: int = 1,
                 core_mode: str = "orthogonal", capacity: int | None = None):
        super().__init__(capacity)
        self.geom = geom
        self.kappa = kappa
        self.core_mode = core_mode

    def register(
        self, tenant_id: str, dev_kernels: np.ndarray, seed: int | None = None,
        weight: float = 1.0,
    ) -> MoLeSession:
        """Create a tenant session: draw fresh secrets, fuse its Aug-Conv.

        ``weight`` is the tenant's weighted-fair-queueing share in the
        delivery engine (see :meth:`SlotRegistry.set_weight`).
        """
        if tenant_id in self._sessions:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        sess = MoLeSession.create(
            dev_kernels, self.geom, kappa=self.kappa,
            seed=self._resolve_seed(seed), core_mode=self.core_mode,
        )
        self._adopt(tenant_id, sess)
        if weight != 1.0:
            self.set_weight(tenant_id, weight)
        return sess

    def session(self, tenant_id: str) -> MoLeSession:
        return self._sessions[tenant_id]

    # -- crash-recovery serialization ----------------------------------------
    def _config_state(self) -> dict:
        g = self.geom
        return {
            "geom": [g.alpha, g.beta, g.m, g.p],
            "kappa": self.kappa,
            "core_mode": self.core_mode,
        }

    def _session_state(self, sess: MoLeSession) -> tuple[dict, dict[str, np.ndarray]]:
        prov = sess.provider
        # analysis: declassified(per-session crash state: packed into the registry snapshot, never serialized elsewhere)
        return {}, {
            "core": np.asarray(prov._core.matrix),
            "core_inv": np.asarray(prov._core.inverse),
            "perm": np.asarray(prov._perm),
            "aug": np.asarray(sess.developer.aug_matrix),
        }

    def _session_from_state(
        self, meta: dict, arrays: dict[str, np.ndarray]
    ) -> MoLeSession:
        core = MorphCore(
            matrix=np.asarray(arrays["core"], np.float32),
            inverse=np.asarray(arrays["core_inv"], np.float32),
            kappa=self.kappa,
            mode=self.core_mode,
        )
        prov = DataProvider.from_secrets(
            self.geom, self.kappa, core, np.asarray(arrays["perm"])
        )
        developer = Developer(arrays["aug"], self.geom)
        return MoLeSession(provider=prov, developer=developer, geom=self.geom)

    # -- per-slot secrets staged by the delivery engine ----------------------
    @property
    def _core_q(self) -> int:
        return self.geom.in_features // self.kappa

    def slot_core(self, slot: int) -> np.ndarray:
        """(q, q) core occupying ``slot`` (zeros when the slot is free)."""
        t = self._slot_tenant[slot]
        if t is None:
            return np.zeros((self._core_q, self._core_q), np.float32)
        return np.asarray(self._sessions[t].provider._core.matrix)

    def slot_aug(self, slot: int) -> np.ndarray:
        """(F_in, F_out) Aug-Conv matrix occupying ``slot`` (zeros if free)."""
        t = self._slot_tenant[slot]
        g = self.geom
        if t is None:
            return np.zeros((g.in_features, g.out_features), np.float32)
        return np.asarray(self._sessions[t].developer.aug_matrix)

    def stacked_cores(self) -> np.ndarray:
        """(S, q, q) — the core of the tenant resident in each slot."""
        return np.stack([self.slot_core(s) for s in range(self.capacity)])

    def stacked_aug_matrices(self) -> np.ndarray:
        """(S, F_in, F_out) — each slot's developer-side Aug-Conv matrix."""
        return np.stack([self.slot_aug(s) for s in range(self.capacity)])
