"""Serve launcher on PyTorch: ``--mode delivery``, synchronous.

The batched multi-tenant delivery engine (the paper's data-delivery stage):
many tenants register sessions (own secret core + channel permutation),
their requests coalesce into padded microbatches, and morph + Aug-Conv run
as two grouped kernel launches per microbatch
(``repro_torch.runtime.engine``).  Reports throughput against the
per-request ``MoLeSession.deliver`` baseline and the largest difference
between the two, with the same report lines as ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode delivery \
        --tenants 4 --requests 64 --batch 1 --kappa 4

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
asks for the plain versions on the CPU.  ``--async``, ``--mode lm`` and
``--mode serve`` belong to later slices of the port and raise
``NotImplementedError``; the reference's ``--backend`` has no counterpart
(the device picks the implementation).
"""
from __future__ import annotations

import argparse
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="delivery",
                    choices=["delivery", "lm", "serve"],
                    help="only delivery is ported; lm and serve raise")
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
    ap.add_argument("--batch", type=int, default=1,
                    help="images per delivery request")
    ap.add_argument("--kappa", type=int, default=1)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--out-channels", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=16)
    args = ap.parse_args(argv)
    if args.mode != "delivery":
        raise NotImplementedError(
            f"--mode {args.mode} is not ported yet (a later slice of the port)"
        )
    if args.use_async:
        raise NotImplementedError(
            "--async is not ported yet (the async engine is the next slice)"
        )
    return run_delivery(args)


if __name__ == "__main__":
    main()
