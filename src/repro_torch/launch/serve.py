"""Serve launcher on PyTorch: ``--mode delivery`` and ``--mode lm``,
synchronous.

``--mode delivery`` (default) — the batched multi-tenant delivery engine
(the paper's data-delivery stage): many tenants register sessions (own
secret core + channel permutation), their requests coalesce into padded
microbatches, and morph + Aug-Conv run as two grouped kernel launches per
microbatch (``repro_torch.runtime.engine``).  Reports throughput against
the per-request ``MoLeSession.deliver`` baseline and the largest difference
between the two, with the same report lines as ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode delivery \
        --tenants 4 --requests 64 --batch 1 --kappa 4

``--mode lm`` — MoLe-secured LM serving.  LM tenants register in an
``LMSessionRegistry`` (each draws its own secret vocab permutation); the
engine's token lane morphs the prompts (provider side), and the
continuous-batched cross-tenant decode lane generates from the morphed
prompts with every tenant's fused Aug-Embedding / Aug-head
(``repro_torch.runtime.decode``, logits through the K3 kernel); the lane
unmorphs the generations for the provider.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch deepseek_7b --smoke --requests 8 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch rwkv6_3b --smoke --requests 4 --prompt-len 13 --gen 6

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
asks for the plain versions on the CPU.  ``--async``, ``--mode serve`` and
``--mole off`` belong to later slices of the port and raise
``NotImplementedError``, as do architectures the port does not run yet;
the reference's ``--backend`` has no counterpart (the device picks the
implementation).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def _weights_of(args, tenants: int) -> list[float]:
    """--weights "2,1" cycled over the tenant count (all 1.0 by default)."""
    ws = [float(w) for w in args.weights.split(",")]
    if any(not w > 0 for w in ws):
        raise SystemExit(f"--weights must be positive, got {args.weights}")
    return [ws[i % len(ws)] for i in range(tenants)]


def _priorities_of(args, requests: int) -> list[int]:
    """--priority "0,1" cycled over the request count (all 0 by default)."""
    ps = [int(p) for p in args.priority.split(",")]
    return [ps[r % len(ps)] for r in range(requests)]


def run_delivery(args) -> dict:
    """Serve image-delivery traffic for many tenants through the engine."""
    from repro_torch.core import ConvGeometry, SessionRegistry
    from repro_torch.runtime import (
        DeliveryRequest, EngineStats, MoLeDeliveryEngine,
    )

    rng = np.random.default_rng(args.seed)
    geom = ConvGeometry(alpha=args.channels, beta=args.out_channels,
                        m=args.image_size, p=3)
    # Default the slot capacity to the tenant count: an exactly-sized slot
    # table keeps the steady-state "all tenants active" microbatch free of
    # padding groups.
    capacity = args.capacity if args.capacity is not None else args.tenants
    registry = SessionRegistry(geom, kappa=args.kappa, capacity=capacity)
    fan_in = geom.alpha * geom.p * geom.p
    weights = _weights_of(args, args.tenants)
    for i in range(args.tenants):
        kernels = rng.standard_normal(
            (geom.alpha, geom.beta, geom.p, geom.p)
        ).astype(np.float32) / np.sqrt(fan_in)
        registry.register(f"tenant-{i}", kernels, weight=weights[i])

    engine = MoLeDeliveryEngine(registry, device=args.device)
    device = engine.device
    priorities = _priorities_of(args, args.requests)
    requests = [
        DeliveryRequest(
            f"tenant-{i % args.tenants}",
            rng.standard_normal((args.batch, geom.alpha, geom.m, geom.m))
            .astype(np.float32),
            priority=priorities[i],
        )
        for i in range(args.requests)
    ]

    def per_request(q):
        data = torch.from_numpy(q.payload).to(device)
        return registry.session(q.tenant_id).deliver(data).cpu().numpy()

    # Warm both paths (kernel build and load, device copies of the secrets)
    # so the timed runs measure steady-state serving.
    for q in requests:
        engine.submit(q)
    engine.flush()
    for q in requests:
        per_request(q)
    # Fresh stats so the report describes the timed run, not the warmup.
    engine.stats = EngineStats()
    engine.stats.service_share_fn = engine.scheduler.service_share

    t0 = time.time()
    rids = [engine.submit(q) for q in requests]
    engine.flush()
    feats = {r: engine.take(r) for r in rids}
    dt_engine = time.time() - t0

    t0 = time.time()
    base = [per_request(q) for q in requests]
    dt_per_request = time.time() - t0

    n_images = args.requests * args.batch
    err = max(
        float(np.max(np.abs(feats[r] - base[i]))) for i, r in enumerate(rids)
    )
    stats = engine.stats
    print(
        f"delivery tenants={args.tenants} requests={args.requests} "
        f"batch={args.batch} kappa={args.kappa} device={device} "
        f"async=False\n"
        f"  engine:      {n_images / dt_engine:9.1f} images/s "
        f"({stats.microbatches} microbatches, "
        f"padding {stats.padding_fraction:.0%})\n"
        f"  per-request: {n_images / dt_per_request:9.1f} images/s\n"
        f"  speedup:     {dt_per_request / dt_engine:9.2f}x   "
        f"max |engine - per-request| = {err:.2e}"
    )
    if args.stats:
        print("engine stats:")
        for line in stats.summary().splitlines():
            print(f"  {line}")
    return {
        "images_per_s_engine": n_images / dt_engine,
        "images_per_s_per_request": n_images / dt_per_request,
        "speedup": dt_per_request / dt_engine,
        "max_err": err,
    }


def run_lm(args, params=None) -> np.ndarray:
    """Serve LM traffic: engine-morphed prompts, continuous-batched decode.

    Provider side: each LM tenant holds its own secret vocab permutation in
    the shared ``LMSessionRegistry``; prompt requests coalesce into
    length-bucketed token microbatches and morph as slot-indexed gathers
    (sync flush).  Developer side: the
    :class:`~repro_torch.runtime.ContinuousDecodeLane` decodes every
    tenant's rows in one shared batched step against the registry's stacked
    AugE tables / Aug-heads.  ``params`` (a :class:`ParamTree` on the
    device) replaces the random weights drawn from ``--seed``.

    Returns the unmorphed generations, request-ordered.
    """
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.lm import LMSessionRegistry
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model, MoLeCfg
    from repro_torch.runtime import (
        ContinuousDecodeLane, DeliveryRequest, MoLeDeliveryEngine,
        resolve_device,
    )

    if args.mole != "token":
        raise NotImplementedError(
            "--mole off (per-tenant plain decode) is not ported yet"
        )
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, mole=MoLeCfg(enabled=True, mode="token"))
    device = resolve_device(args.device)
    model = Model(cfg, device)
    if params is None:
        params = model.init(args.seed)
    embed = params["embed"].float().cpu().numpy()
    head = (None if cfg.tie_embeddings
            else params["head"].float().cpu().numpy())

    tenants = max(1, min(args.tenants, args.requests))
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                                 global_batch=args.requests, seed=args.seed))
    raw_prompts = np.asarray(src.batch(0)["tokens"])
    tenant_of = [f"lm-{i % tenants}" for i in range(args.requests)]

    # ---- provider side: engine-morphed prompts ---------------------------
    capacity = args.capacity if args.capacity is not None else tenants
    registry = LMSessionRegistry(cfg.vocab, embed.shape[1], capacity=capacity)
    weights = _weights_of(args, tenants)
    for i in range(tenants):
        # Tenant lm-i draws the reference's secret (seed = mole seed + i).
        registry.register(
            f"lm-{i}", embed, seed=cfg.mole.seed + i, weight=weights[i],
            head=head,
        )
    engine = MoLeDeliveryEngine(
        lm_registry=registry, device=device,
        # --prompt-len itself is a seq bucket: no sequence padding.
        seq_buckets=tuple(
            sorted({8, 16, 32, 64, 128, 256, 512, args.prompt_len})
        ),
    )
    priorities = _priorities_of(args, args.requests)
    prompt_reqs = [
        DeliveryRequest(tenant_of[r], raw_prompts[r : r + 1], lane="tokens",
                        priority=priorities[r])
        for r in range(args.requests)
    ]
    t0 = time.time()
    rids = [engine.submit(q) for q in prompt_reqs]
    engine.flush()
    served_prompts = np.concatenate([engine.take(r) for r in rids], axis=0)
    dt_morph = time.time() - t0
    stats = engine.stats

    # ---- developer side: continuous-batched decode -----------------------
    # The lane shares the engine's FairScheduler: decode appetite charges
    # the same engine-wide clock as prompt-morph traffic.
    t0 = time.time()
    lane = ContinuousDecodeLane(
        model, params, registry,
        rows=min(args.requests, registry.capacity),
        max_len=args.prompt_len + args.gen + 1, device=device,
        scheduler=engine.scheduler,
    )
    sids = [
        lane.submit(tenant_of[r], served_prompts[r], args.gen,
                    priority=priorities[r], premorphed=True)
        for r in range(args.requests)
    ]
    lane.run()
    final = np.stack([lane.take(sid) for sid in sids]).astype(np.int64)
    dt = time.time() - t0

    tps = args.requests * args.gen / dt
    # analysis: declassified(demo CLI prints the provider-view generation - unmorphed output data, not key material)
    print(
        f"arch={cfg.name} requests={args.requests} tenants={tenants} "
        f"gen={args.gen} mole=token device={device}  "
        f"{dt:.2f}s  {tps:.1f} tok/s\n"
        f"  engine morph: {args.requests / max(dt_morph, 1e-9):9.1f} "
        f"prompts/s ({stats.microbatches} microbatches, "
        f"padding {stats.padding_fraction:.0%}, async=False)\n"
        f"first request generation (provider view): "
        f"{final[0][:12].tolist()}"
    )
    if args.stats:
        print("engine stats:")
        for line in stats.summary().splitlines():
            print(f"  {line}")
    return final


# Mode gating: flag -> (argparse dest, default, modes that accept it).
# Giving a flag outside its mode is an error, not a silent drop.
_FLAGS = {
    "--batch": ("batch", 1, ("delivery",)),
    "--kappa": ("kappa", 1, ("delivery",)),
    "--channels": ("channels", 3, ("delivery",)),
    "--out-channels": ("out_channels", 16, ("delivery",)),
    "--image-size": ("image_size", 16, ("delivery",)),
    "--arch": ("arch", "deepseek_7b", ("lm",)),
    "--smoke": ("smoke", False, ("lm",)),
    "--prompt-len": ("prompt_len", 32, ("lm",)),
    "--gen": ("gen", 16, ("lm",)),
    "--mole": ("mole", "token", ("lm",)),
}


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, with mode-gated flags checked and defaulted."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="delivery",
                    choices=["delivery", "lm", "serve"],
                    help="delivery and lm are ported; serve raises")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="the async front door (not ported yet; raises)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default cuda)")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=None,
                    help="registry slot capacity (default: one slot per "
                         "--tenants); tenants beyond capacity LRU-evict to "
                         "host")
    ap.add_argument("--stats", action="store_true",
                    help="print the engine stats summary after the run")
    ap.add_argument("--weights", default="1", metavar="W0,W1,...",
                    help="per-tenant WFQ weights, cycled over the tenant "
                         "count")
    ap.add_argument("--priority", default="0", metavar="P0,P1,...",
                    help="per-request priorities, cycled over the request "
                         "count (higher dequeues first within a tenant)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=None,
                    help="images per delivery request")
    ap.add_argument("--kappa", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--out-channels", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--arch", default=None, help="--mode lm architecture")
    ap.add_argument("--smoke", action="store_true", default=None,
                    help="--mode lm: the architecture's smoke config")
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--gen", type=int, default=None,
                    help="--mode lm: tokens generated per request")
    ap.add_argument("--mole", default=None, choices=["off", "token"])
    args = ap.parse_args(argv)
    for flag, (dest, default, modes) in _FLAGS.items():
        if getattr(args, dest) is None:
            setattr(args, dest, default)
        elif args.mode not in modes:
            ap.error(f"{flag} does not apply to --mode {args.mode}")
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "serve":
        raise NotImplementedError(
            "--mode serve is not ported yet (a later slice of the port)"
        )
    if args.use_async:
        raise NotImplementedError(
            "--async is not ported yet (the async engine is a later slice)"
        )
    if args.mode == "lm":
        return run_lm(args)
    return run_delivery(args)


if __name__ == "__main__":
    main()
