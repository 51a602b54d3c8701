"""Serve launcher on PyTorch: ``--mode delivery``, ``--mode lm`` (each
sync or ``--async``) and ``--mode serve``.

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
unmorphs the generations for the provider.  A frontend model (the vlm
``llama32_vision_90b``, the audio ``whisper_tiny``) is served one tenant
at a time instead, as the reference serves it: the tenant's fused
parameters, one prefill of its morphed prompts beside all-zero patches or
frames, greedy decode, then the provider unmorphs.  ``--mole off`` serves
the raw model on the raw prompts instead: no registry, no engine, one
prefill and a greedy decode for all requests together (a frontend model
beside zero patches or frames).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch deepseek_7b --smoke --requests 8 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch phi3_mini_3p8b --smoke --requests 4 --prompt-len 16 --gen 4
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch rwkv6_3b --smoke --requests 4 --prompt-len 13 --gen 6
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch deepseek_7b --smoke --requests 4 --prompt-len 16 --mole off
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch deepseek_v2_lite_16b --smoke --requests 4 --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch llama32_vision_90b --smoke --requests 4 --prompt-len 16
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch whisper_tiny --smoke --requests 4 --prompt-len 16

``--mode serve`` — the **network front door**
(``repro_torch.launch.server``): the async delivery engine behind a TCP
wire protocol (``repro_torch.runtime.wire``), with load shedding, deadline
propagation, exactly-once retry semantics, graceful drain on SIGTERM, and
optional network chaos.  Drive it with the client fleet
(``repro_torch.launch.client``):

    PYTHONPATH=src python -m repro_torch.launch.serve --mode serve --port 0 \
        --tenants 4 --kappa 2 --snapshot-dir /tmp/snap --stats
    PYTHONPATH=src python -m repro_torch.launch.client --spawn-server \
        --chaos --requests 64 --report fleet-report.json

``--async`` works in the two **local** modes: traffic goes through the
async front door (``repro_torch.runtime.async_engine``) — a background
flusher with a ``--max-delay-ms`` latency SLO and per-tenant admission
control (``--max-inflight-rows``, ``--admission block|reject``); it
additionally reports p50/p95 completion latency.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode delivery \
        --async --tenants 4 --requests 64 --max-delay-ms 5

Flags that only make sense for another mode are an error, not silently
ignored, as in the reference launcher.  Runs on the card (``--device
cuda``, the default) unless ``--device cpu`` asks for the plain versions on
the CPU.  Architectures the port does not run yet raise
``NotImplementedError``; the reference's ``--backend`` has no counterpart
(the device picks the implementation).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS


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


def _injector_of(args):
    """--inject-failure <phase> -> a one-shot FailureInjector (or None)."""
    if not args.inject_failure:
        return None
    from repro_torch.runtime import FailureInjector

    return FailureInjector(at_phases={args.inject_failure})


def _front_of(args, engine):
    """The async front door over ``engine`` from the --async flags."""
    from repro_torch.runtime import AsyncDeliveryEngine

    return AsyncDeliveryEngine(
        engine, max_delay_ms=args.max_delay_ms,
        max_inflight_rows=args.max_inflight_rows, admission=args.admission,
        snapshot_dir=args.snapshot_dir,
        prefetch_horizon_ms=args.prefetch_horizon_ms,
        injector=_injector_of(args),
    )


def run_delivery(args) -> dict:
    """Serve image-delivery traffic for many tenants through the engine,
    synchronously or through the async front door (``--async``)."""
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
            priority=priorities[i], deadline_ms=args.deadline_ms,
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

    if args.use_async:
        front = _front_of(args, engine)
        t0 = time.time()
        futures = [(r, front.submit(q)) for r, q in enumerate(requests)]
        feats = {r: f.result(timeout=120).payload for r, f in futures}
        dt_engine = time.time() - t0
        rids = [r for r, _ in futures]
        front.close()
    else:
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
    latency = (
        f"  latency:     p50={stats.p50_ms:7.2f}ms p95={stats.p95_ms:7.2f}ms "
        f"(SLO max_delay={args.max_delay_ms}ms, {stats.flushes} flushes)\n"
        if args.use_async else ""
    )
    if args.use_async and (args.snapshot_dir or args.inject_failure):
        latency += (
            f"  resilience:  snapshots={stats.snapshots} "
            f"degraded_flushes={stats.degraded_flushes} "
            f"injected={args.inject_failure or 'none'}\n"
        )
    print(
        f"delivery tenants={args.tenants} requests={args.requests} "
        f"batch={args.batch} kappa={args.kappa} device={device} "
        f"async={args.use_async}\n"
        f"  engine:      {n_images / dt_engine:9.1f} images/s "
        f"({stats.microbatches} microbatches, "
        f"padding {stats.padding_fraction:.0%})\n"
        f"{latency}"
        f"  per-request: {n_images / dt_per_request:9.1f} images/s\n"
        f"  speedup:     {dt_per_request / dt_engine:9.2f}x   "
        f"max |engine - per-request| = {err:.2e}"
    )
    if args.stats:
        print("engine stats:")
        for line in stats.summary().splitlines():
            print(f"  {line}")
    out = {
        "images_per_s_engine": n_images / dt_engine,
        "images_per_s_per_request": n_images / dt_per_request,
        "speedup": dt_per_request / dt_engine,
        "max_err": err,
    }
    if args.use_async:
        out["p50_ms"] = stats.p50_ms
        out["p95_ms"] = stats.p95_ms
    return out


def run_lm(args, params=None, cfg=None) -> np.ndarray:
    """Serve LM traffic: engine-morphed prompts, continuous-batched decode.

    Provider side: each LM tenant holds its own secret vocab permutation in
    the shared ``LMSessionRegistry``; prompt requests coalesce into
    length-bucketed token microbatches and morph as slot-indexed gathers
    (sync flush, or the async deadline flusher with ``--async``).
    Developer side: the
    :class:`~repro_torch.runtime.ContinuousDecodeLane` decodes every
    tenant's rows in one shared batched step against the registry's stacked
    AugE tables / Aug-heads; a frontend model is served one tenant at a
    time on its fused parameters (:func:`_serve_per_tenant`).  With
    ``--mole off`` neither runs: the raw model serves the raw prompts
    (:func:`_serve_plain`).  ``params`` (a :class:`ParamTree` on the
    device) replaces the random weights drawn from ``--seed``; ``cfg`` (a
    :class:`ModelConfig`) replaces ``--arch``'s (``--smoke`` is then
    ignored), which is how a run on the card cuts a published config's
    depth.

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

    if cfg is None:
        cfg = (get_smoke_config(args.arch) if args.smoke
               else get_config(args.arch))
    use_mole = args.mole != "off"
    if use_mole:
        cfg = dataclasses.replace(cfg, mole=MoLeCfg(enabled=True, mode="token"))
    device = resolve_device(args.device)
    model = Model(cfg, device)
    if params is None:
        params = model.init(args.seed)

    tenants = max(1, min(args.tenants, args.requests))
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                                 global_batch=args.requests, seed=args.seed))
    raw_prompts = np.asarray(src.batch(0)["tokens"])
    tenant_of = [f"lm-{i % tenants}" for i in range(args.requests)]

    if not use_mole:
        t0 = time.time()
        final = _serve_plain(model, params, raw_prompts, args, device)
        dt = time.time() - t0
        # analysis: declassified(demo CLI prints the generation of the raw model on the raw prompts - output data, not key material)
        print(
            f"arch={cfg.name} requests={args.requests} tenants={tenants} "
            f"gen={args.gen} mole=off device={device}  {dt:.2f}s  "
            f"{args.requests * args.gen / dt:.1f} tok/s\n"
            f"first request generation (provider view): "
            f"{final[0][:12].tolist()}"
        )
        return final

    # cast on the host: no fp32 copy of the tables on the card; an audio
    # model's tables are its decoder's, and its registry holds no head
    # (the per-tenant path fuses the head from the morpher), as the
    # reference's
    audio = cfg.family == "audio"
    tables = params["dec"] if audio else params
    embed = tables["embed"].cpu().float().numpy()
    head = (None if cfg.tie_embeddings or audio
            else tables["head"].cpu().float().numpy())

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
                        priority=priorities[r], deadline_ms=args.deadline_ms)
        for r in range(args.requests)
    ]
    t0 = time.time()
    if args.use_async:
        front = _front_of(args, engine)
        futures = [front.submit(q) for q in prompt_reqs]
        served_prompts = np.concatenate(
            [f.result(timeout=120).payload for f in futures], axis=0
        )
        front.close()
    else:
        rids = [engine.submit(q) for q in prompt_reqs]
        engine.flush()
        served_prompts = np.concatenate(
            [engine.take(r) for r in rids], axis=0
        )
    dt_morph = time.time() - t0
    stats = engine.stats

    if cfg.frontend is not None:
        # ---- developer side: per-tenant fused serving (frontend models) --
        t0 = time.time()
        final = _serve_per_tenant(model, params, registry, served_prompts,
                                  tenant_of, args, device)
        dt = time.time() - t0
    else:
        # ---- developer side: continuous-batched decode -------------------
        # The lane shares the engine's FairScheduler: decode appetite
        # charges the same engine-wide clock as prompt-morph traffic.
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
    engine_line = (
        f"  engine morph: {args.requests / max(dt_morph, 1e-9):9.1f} "
        f"prompts/s ({stats.microbatches} microbatches, "
        f"padding {stats.padding_fraction:.0%}, async={args.use_async}"
    )
    if args.use_async:
        engine_line += f", p50={stats.p50_ms:.2f}ms p95={stats.p95_ms:.2f}ms"
    # analysis: declassified(demo CLI prints the provider-view generation - unmorphed output data, not key material)
    print(
        f"arch={cfg.name} requests={args.requests} tenants={tenants} "
        f"gen={args.gen} mole=token device={device}  "
        f"{dt:.2f}s  {tps:.1f} tok/s\n"
        f"{engine_line})\n"
        f"first request generation (provider view): "
        f"{final[0][:12].tolist()}"
    )
    if args.stats:
        print("engine stats:")
        for line in stats.summary().splitlines():
            print(f"  {line}")
    return final


def _serve_plain(model, params, prompts: np.ndarray, args,
                 device) -> np.ndarray:
    """``--mole off``: no registry and no engine.  All requests form one
    group: one prefill of the raw prompts on the plain params
    (:func:`~repro_torch.launch.steps.make_prefill_step`), then greedy
    decode from ``prompt_len`` (:func:`make_decode_step`), as the
    reference's plain path does.  Returns the generations, (requests, gen)
    int64."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    return _generate(model, params, make_prefill_step(model),
                     make_decode_step(model), prompts, args, device)


def _serve_per_tenant(model, params, registry, prompts: np.ndarray,
                      tenant_of: list[str], args, device) -> np.ndarray:
    """Frontend models under ``--mole token``, as the reference serves
    them: one tenant at a time, its token morpher fused into the embedding
    and the untied head (``fuse_lm_params``), one prefill of its morphed
    prompts, greedy decode from ``prompt_len``, and the provider unmorphs
    the sampled tokens with the tenant's inverse permutation.  A tenant's
    fused tables and caches are freed before the next tenant's are built.
    Returns the unmorphed generations, (requests, gen) int64 in request
    order."""
    from repro_torch.core import deploy
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(model), make_decode_step(model)
    by_tenant: dict[str, list[int]] = {}
    for r, t in enumerate(tenant_of):
        by_tenant.setdefault(t, []).append(r)
    final = np.zeros((len(prompts), args.gen), np.int64)
    for t, ridx in by_tenant.items():
        morpher = registry.session(t).morpher
        fused = deploy.fuse_lm_params(params, model.cfg, token_morpher=morpher)
        served = _generate(model, fused, prefill, decode, prompts[ridx], args,
                           device)
        del fused
        final[ridx] = morpher.inv_perm[served]
    return final


def _generate(model, params, prefill, decode, prompts: np.ndarray, args,
              device) -> np.ndarray:
    """One prefill of ``prompts`` (a frontend model's beside all-zero bf16
    inputs of the frontend's shape, as the reference feeds them: a vlm's
    ``patches``, an audio model's ``frames``), then ``gen - 1`` greedy
    decode steps; (rows, gen) int64."""
    cfg = model.cfg
    caches = model.init_cache(len(prompts), args.prompt_len + args.gen + 1)
    batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(device)}
    if cfg.frontend is not None:
        batch[cfg.frontend.batch_key] = torch.zeros(
            (len(prompts), cfg.frontend.n_tokens, cfg.frontend.d_in),
            dtype=torch.bfloat16, device=device)
    logits, caches = prefill(params, batch, caches)
    tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
    out = [tok]
    for i in range(args.gen - 1):
        logits, caches = decode(params, tok, args.prompt_len + i, caches)
        tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy().astype(np.int64)


# Mode gating: CLI spelling -> (argparse dest, default, modes that accept
# it).  Giving a flag outside its modes is an error, not a silent drop.
_MODES = ("delivery", "lm", "serve")
_FLAGS = {
    # vision geometry: the batched delivery lane (local run or served)
    "--batch": ("batch", 1, ("delivery",)),
    "--kappa": ("kappa", 1, ("delivery", "serve")),
    "--channels": ("channels", 3, ("delivery", "serve")),
    "--out-channels": ("out_channels", 16, ("delivery", "serve")),
    "--image-size": ("image_size", 16, ("delivery", "serve")),
    # lm-only
    "--arch": ("arch", "deepseek_7b", ("lm",)),
    "--smoke": ("smoke", False, ("lm",)),
    "--prompt-len": ("prompt_len", 32, ("lm",)),
    "--gen": ("gen", 16, ("lm",)),
    "--mole": ("mole", "token", ("lm",)),
    # delivery engine / async front door (under --mode lm --mole off no
    # engine runs at all, so these error there too — checked separately)
    "--tenants": ("tenants", 4, _MODES),
    "--async": ("use_async", False, ("delivery", "lm")),
    "--max-delay-ms": ("max_delay_ms", 5.0, _MODES),
    "--max-inflight-rows": ("max_inflight_rows", 4096, _MODES),
    "--admission": ("admission", "block", ("delivery", "lm")),
    "--capacity": ("capacity", None, _MODES),
    "--stats": ("stats", False, _MODES),
    "--weights": ("weights", "1", _MODES),
    "--priority": ("priority", "0", ("delivery", "lm")),
    "--deadline-ms": ("deadline_ms", None, ("delivery", "lm")),
    "--snapshot-dir": ("snapshot_dir", None, _MODES),
    "--inject-failure": ("inject_failure", None, _MODES),
    "--prefetch-horizon-ms": ("prefetch_horizon_ms", None, _MODES),
    # serve-only: the network front door (launch/server.py).  serve is
    # always async (--async errors), always admission=reject (--admission
    # errors: shedding must be a typed frame, not submitter backpressure),
    # and per-request priority/deadline arrive on the wire (--priority /
    # --deadline-ms error).
    "--host": ("host", "127.0.0.1", ("serve",)),
    "--port": ("port", 0, ("serve",)),
    "--max-pending-rows": ("max_pending_rows", 4096, ("serve",)),
    "--read-timeout-ms": ("read_timeout_ms", 30000.0, ("serve",)),
    "--write-timeout-ms": ("write_timeout_ms", 10000.0, ("serve",)),
    "--drain-timeout-ms": ("drain_timeout_ms", 30000.0, ("serve",)),
    "--warm-batch": ("warm_batch", 8, ("serve",)),
    "--chaos": ("chaos", False, ("serve",)),
    "--chaos-rate": ("chaos_rate", 0.2, ("serve",)),
    "--chaos-seed": ("chaos_seed", 0, ("serve",)),
}
# The engine/front-door subset, for the --mode lm --mole off check.
_ENGINE_FLAGS = (
    "--tenants", "--async", "--max-delay-ms", "--max-inflight-rows",
    "--admission", "--capacity", "--stats", "--weights", "--priority",
    "--deadline-ms", "--snapshot-dir", "--inject-failure",
    "--prefetch-horizon-ms",
)


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, with mode-gated flags checked and defaulted."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="delivery", choices=list(_MODES),
                    help="serve = network front door (launch/server.py)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default cuda)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    # delivery-engine options (every mode, but they require the engine:
    # error under --mode lm --mole off)
    ap.add_argument("--tenants", type=int, default=None)
    ap.add_argument("--async", dest="use_async", action="store_true",
                    default=None,
                    help="serve through the async front door (deadline "
                         "flusher + admission control)")
    ap.add_argument("--max-delay-ms", type=float, default=None,
                    help="async latency SLO: max wait before a flush fires")
    ap.add_argument("--max-inflight-rows", type=int, default=None,
                    help="async per-tenant admission quota (rows in flight)")
    ap.add_argument("--admission", default=None, choices=["block", "reject"],
                    help="over-quota behavior: backpressure or AdmissionError")
    ap.add_argument("--capacity", type=int, default=None,
                    help="registry slot capacity (default: one slot per "
                         "--tenants); tenants beyond capacity LRU-evict to "
                         "host")
    ap.add_argument("--stats", action="store_true", default=None,
                    help="print the engine stats summary after the run")
    ap.add_argument("--weights", default=None, metavar="W0,W1,...",
                    help="per-tenant WFQ weights, cycled over the tenant "
                         "count")
    ap.add_argument("--priority", default=None, metavar="P0,P1,...",
                    help="per-request priorities, cycled over the request "
                         "count (higher dequeues first within a tenant)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline put on every DeliveryRequest "
                         "(overrides --max-delay-ms per request; requires "
                         "--async)")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="persist an engine snapshot between flush rounds "
                         "for crash recovery (atomic CheckpointManager "
                         "layout; requires --async)")
    ap.add_argument("--inject-failure", default=None,
                    choices=["coalesce", "device", "publish"],
                    help="crash the flusher once at this flush phase to "
                         "exercise supervised recovery (requires --async)")
    ap.add_argument("--prefetch-horizon-ms", type=float, default=None,
                    help="predictive prefetch: after each flush round the "
                         "async flusher stages evicted tenants the arrival "
                         "predictor expects within this horizon (requires "
                         "--async)")
    # vision-delivery options
    ap.add_argument("--batch", type=int, default=None,
                    help="[delivery] images per delivery request")
    ap.add_argument("--kappa", type=int, default=None)
    ap.add_argument("--channels", type=int, default=None)
    ap.add_argument("--out-channels", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    # lm-only options
    ap.add_argument("--arch", default=None,
                    help=f"--mode lm architecture: {', '.join(ARCHS)}")
    ap.add_argument("--smoke", action="store_true", default=None,
                    help="--mode lm: the architecture's smoke config")
    ap.add_argument("--prompt-len", type=int, default=None)
    ap.add_argument("--gen", type=int, default=None,
                    help="--mode lm: tokens generated per request")
    ap.add_argument("--mole", default=None, choices=["off", "token"])
    # serve-only options (the network front door)
    ap.add_argument("--host", default=None,
                    help="[serve] bind address (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=None,
                    help="[serve] TCP port; 0 picks an ephemeral one, "
                         "printed as 'serving on host:port'")
    ap.add_argument("--max-pending-rows", type=int, default=None,
                    help="[serve] global load-shed threshold: admitted-but-"
                         "uncompleted rows beyond this get a typed "
                         "OVERLOADED rejection (0 disables)")
    ap.add_argument("--read-timeout-ms", type=float, default=None,
                    help="[serve] per-connection read timeout")
    ap.add_argument("--write-timeout-ms", type=float, default=None,
                    help="[serve] per-connection write/drain timeout")
    ap.add_argument("--drain-timeout-ms", type=float, default=None,
                    help="[serve] graceful-drain budget on SIGTERM")
    ap.add_argument("--warm-batch", type=int, default=None,
                    help="[serve] rows per tenant in the warmup flush")
    ap.add_argument("--chaos", action="store_true", default=None,
                    help="[serve] arm server-side network chaos: dropped "
                         "accepts, requests lost after read, truncated/"
                         "stalled writes")
    ap.add_argument("--chaos-rate", type=float, default=None,
                    help="[serve] per-event probability for --chaos")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="[serve] RNG seed for --chaos")
    # Every None-default flag must belong to the gating table — otherwise a
    # new flag would silently stay None in every mode.
    gated = {dest for dest, _, _ in _FLAGS.values()}
    ungated = {
        a.dest for a in ap._actions if a.default is None and a.dest != "help"
    } - gated
    if ungated:
        raise RuntimeError(f"flags missing from the mode-gating table: {ungated}")
    args = ap.parse_args(argv)

    for flag, (dest, _, modes) in _FLAGS.items():
        if args.mode not in modes and getattr(args, dest) is not None:
            ap.error(
                f"{flag} only applies to --mode {'/'.join(modes)} "
                f"(got --mode {args.mode})"
            )
    if args.mode == "lm" and args.mole == "off":
        for flag in _ENGINE_FLAGS:
            if getattr(args, _FLAGS[flag][0]) is not None:
                ap.error(
                    f"{flag} requires the delivery engine, which --mole off "
                    f"disables"
                )
    # --deadline-ms arms the async flusher's per-request deadlines; without
    # --async nothing ever reads it.  Snapshotting, failure injection and
    # predictive prefetch live in the supervised background flusher, which
    # the sync path does not have.  (serve is always async.)
    if args.mode != "serve" and not args.use_async:
        for flag, what in (
            ("--deadline-ms", "the deadline flusher"),
            ("--snapshot-dir", "the supervised flusher"),
            ("--inject-failure", "the supervised flusher"),
            ("--prefetch-horizon-ms", "the background flusher's slack"),
        ):
            if getattr(args, _FLAGS[flag][0]) is not None:
                ap.error(f"{flag} requires --async ({what})")
    if args.chaos is None and (
        args.chaos_rate is not None or args.chaos_seed is not None
    ):
        ap.error("--chaos-rate/--chaos-seed require --chaos")
    for dest, default, _ in _FLAGS.values():
        if getattr(args, dest) is None:
            setattr(args, dest, default)
    return args


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "serve":
        from repro_torch.launch.server import run_serve

        return run_serve(args)
    if args.mode == "lm":
        return run_lm(args)
    return run_delivery(args)


if __name__ == "__main__":
    main()
