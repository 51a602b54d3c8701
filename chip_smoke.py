#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (written for an H100) and the CUDA toolkit's ``nvcc``.
Imports neither ``jax`` nor the JAX package ``repro``.  Phases, each
printing one JSON line; any failure raises and exits non-zero:

  1. build      compile ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a.
  2. kernels    both grouped kernels against their plain PyTorch versions
                on the card at VGG-16/CIFAR first-layer width (G=4, B=64,
                K=q=3072, N=65536; plus kappa=4) and a ragged shape, for
                every slot-index pattern of the reference's tests plus an
                out-of-range index that must clamp.  Bound:
                max|kernel - plain| <= 1e-4 * max|plain|.  Times kernel,
                plain version and one library call (torch.bmm over the
                pre-gathered weights, a yardstick the port never calls).
  3. main_path  ``MoLeDeliveryEngine`` at alpha=3, beta=64, m=32, p=3,
                kappa=1: 4 tenants at capacity 4, rounds of 256 one-image
                requests (one (4, 64, 3072) microbatch per flush).  Checks
                the features against per-request ``MoLeSession.deliver``
                and eq. 5 against ``conv_reference`` with the channel
                permutation applied, and that both kernels' launch counters
                rose by the number of microbatches.
  4. churn      6 tenants at capacity 4 (alpha=3, beta=16, m=16), so slots
                are evicted inside one flush round and the engine's
                copy-on-write of the secret stacks runs; every result must
                match per-request delivery.
  5. the ``kernels`` line, the card's name and power limit, and the final
     ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
REL_TOL = 1e-4
GIDX_CASES = {      # over a 6-slot table, as in tests/test_grouped_kernels.py
    "identity": [0, 1, 2, 3],
    "partial_table": [0, 1, 2, 4],
    "out_of_order": [4, 0, 5, 2],
    "duplicates": [3, 3, 1, 3],
    "out_of_range": [1, 9, -2, 5],
}
N_SLOTS = 6
# Kernel-check shapes: the main path's (G, B, F_in, F_out) at VGG-16/CIFAR
# first-layer width, and a ragged (B, K, N).
G, B, F_IN, F_OUT = 4, 64, 3072, 65536
RAGGED_B, RAGGED_K, RAGGED_N = 3, 3000, 1000
MAIN_GEOM = dict(alpha=3, beta=64, m=32, p=3)       # kappa = 1
CHURN_GEOM = dict(alpha=3, beta=16, m=16, p=3)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 2 ------------------------------------------------------------------

def kernel_checks(dev, kernels, ref) -> dict:
    """Both kernels vs their plain versions at full width and a ragged
    shape; returns per-kernel error and timing rows."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    rows: dict[str, dict] = {}
    checks = []

    def hold(name, shape_tag, got, want):
        err = float((got - want).abs().max())
        lim = REL_TOL * float(want.abs().max())
        checks.append({"kernel": name, "case": shape_tag, "max_abs_err": err,
                       "limit": lim})
        check(bool(torch.isfinite(got).all()), f"{name} {shape_tag}: non-finite")
        check(err <= lim, f"{name} {shape_tag}: |kernel - plain| {err} > {lim}")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)

    def all_patterns(name, tag, run_kernel, run_plain):
        for case, idx in GIDX_CASES.items():
            gidx = torch.tensor(idx, dtype=torch.int32, device=dev)
            hold(name, f"{tag}/{case}", run_kernel(gidx), run_plain(gidx))

    # K2 (grouped_aug_gemm): VGG-16/CIFAR width, then ragged.
    K, N = F_IN, F_OUT
    t = randn(G, B, K)
    c_acs = randn(N_SLOTS, K, N, scale=K ** -0.5)
    all_patterns("grouped_aug_gemm", f"G{G}_B{B}_K{K}_N{N}",
                 lambda g: kernels.grouped_aug_gemm(t, g, c_acs),
                 lambda g: ref.aug_gemm_grouped_ref(t, g, c_acs))
    # Timed at the main path's shapes: S = G slots (a contiguous prefix of
    # the stack), gidx = arange(G).  The library call is torch.bmm on the
    # same stack, which is the gathered weights for this gidx.
    ident = torch.arange(G, dtype=torch.int32, device=dev)
    c_main = c_acs[:G]
    times = [
        cuda_ms(lambda: kernels.grouped_aug_gemm(t, ident, c_main), 10),
        cuda_ms(lambda: ref.aug_gemm_grouped_ref(t, ident, c_main), 10),
        cuda_ms(lambda: kernels.grouped_aug_gemm(t, ident, c_main), 10),
        cuda_ms(lambda: ref.aug_gemm_grouped_ref(t, ident, c_main), 10),
        cuda_ms(lambda: torch.bmm(t, c_main), 10),
    ]
    b, by = bound_ms(4 * (G * B * K + G * K * N + G * B * N + G),
                     2 * G * B * K * N)
    rows["grouped_aug_gemm"].update(
        ms=(times[0] + times[2]) / 2, plain_ms=(times[1] + times[3]) / 2,
        library_ms=times[4], bound_ms=b, bound_by=by,
        timed_shape=f"t({G},{B},{K}) c_acs({G},{K},{N}) gidx=arange({G})",
        runs_ms=times,
    )
    del c_acs, c_main
    t = randn(G, RAGGED_B, RAGGED_K)
    c_acs = randn(N_SLOTS, RAGGED_K, RAGGED_N, scale=RAGGED_K ** -0.5)
    all_patterns("grouped_aug_gemm",
                 f"ragged_G{G}_B{RAGGED_B}_K{RAGGED_K}_N{RAGGED_N}",
                 lambda g: kernels.grouped_aug_gemm(t, g, c_acs),
                 lambda g: ref.aug_gemm_grouped_ref(t, g, c_acs))

    # K1 (grouped_block_diag_matmul): kappa=1 (the main path), kappa=4,
    # then ragged.
    F = F_IN
    x = randn(G, B, F)
    for kappa in (1, 4):
        q = F // kappa
        cores = randn(N_SLOTS, q, q, scale=q ** -0.5)
        all_patterns("grouped_block_diag_matmul", f"G{G}_B{B}_kappa{kappa}_q{q}",
                     lambda g: kernels.grouped_block_diag_matmul(x, g, cores, kappa),
                     lambda g: ref.block_diag_matmul_grouped_ref(x, g, cores, kappa))
        if kappa == 1:
            c_main = cores[:G]
            times = [
                cuda_ms(lambda: kernels.grouped_block_diag_matmul(x, ident, c_main, 1), 20),
                cuda_ms(lambda: ref.block_diag_matmul_grouped_ref(x, ident, c_main, 1), 20),
                cuda_ms(lambda: kernels.grouped_block_diag_matmul(x, ident, c_main, 1), 20),
                cuda_ms(lambda: ref.block_diag_matmul_grouped_ref(x, ident, c_main, 1), 20),
                cuda_ms(lambda: torch.bmm(x, c_main), 20),
            ]
            b, by = bound_ms(4 * (2 * G * B * F + G * q * q + G),
                             2 * G * B * F * q)
            rows["grouped_block_diag_matmul"].update(
                ms=(times[0] + times[2]) / 2, plain_ms=(times[1] + times[3]) / 2,
                library_ms=times[4], bound_ms=b, bound_by=by,
                timed_shape=f"x({G},{B},{F}) cores({G},{q},{q}) kappa=1 gidx=arange({G})",
                runs_ms=times,
            )
            del c_main
        del cores
    q = RAGGED_N
    x = randn(G, RAGGED_B, RAGGED_K)
    cores = randn(N_SLOTS, q, q, scale=q ** -0.5)
    kappa = RAGGED_K // q
    all_patterns("grouped_block_diag_matmul",
                 f"ragged_G{G}_B{RAGGED_B}_kappa{kappa}_q{q}",
                 lambda g: kernels.grouped_block_diag_matmul(x, g, cores, kappa),
                 lambda g: ref.block_diag_matmul_grouped_ref(x, g, cores, kappa))
    emit({"phase": "kernels", "checks": len(checks),
          "worst": max(checks, key=lambda c: c["max_abs_err"] / c["limit"]),
          "rows": rows})
    return rows


# -- phases 3 and 4 -----------------------------------------------------------

def make_registry(core, geom, tenants: int, capacity: int, rng):
    reg = core.SessionRegistry(geom, kappa=1, capacity=capacity)
    fan_in = geom.alpha * geom.p * geom.p
    kernels = {}
    for i in range(tenants):
        k = rng.standard_normal(
            (geom.alpha, geom.beta, geom.p, geom.p)
        ).astype(np.float32) / np.float32(np.sqrt(fan_in))
        kernels[f"tenant-{i}"] = k
        reg.register(f"tenant-{i}", k, seed=int(rng.integers(2**31)))
    return reg, kernels


def per_request(reg, req, dev) -> np.ndarray:
    data = torch.from_numpy(req.payload).to(dev)
    return reg.session(req.tenant_id).deliver(data).cpu().numpy()


def main_path(dev, core, runtime, kernels) -> dict:
    rng = np.random.default_rng(SEED)
    geom = core.ConvGeometry(**MAIN_GEOM)
    t0 = time.monotonic()
    reg, dev_kernels = make_registry(core, geom, tenants=4, capacity=4, rng=rng)
    secrets_s = time.monotonic() - t0
    engine = runtime.MoLeDeliveryEngine(reg, dev)
    requests = [
        runtime.DeliveryRequest(
            f"tenant-{i % 4}",
            rng.standard_normal((1, geom.alpha, geom.m, geom.m)).astype(np.float32),
        )
        for i in range(256)
    ]
    # Warm-up: stages the secret stacks and each session's device copies.
    for q in requests:
        engine.submit(q)
    engine.flush()
    base = [per_request(reg, q, dev) for q in requests]
    engine.stats = runtime.EngineStats()

    rounds = 5
    kernels.grouped_block_diag_matmul.launches = 0
    kernels.grouped_aug_gemm.launches = 0
    t0 = time.monotonic()
    feats = []
    for _ in range(rounds):
        rids = [engine.submit(q) for q in requests]
        engine.flush()
        feats.append([engine.take(r) for r in rids])
    dt_engine = time.monotonic() - t0
    launches = {
        "grouped_block_diag_matmul": kernels.grouped_block_diag_matmul.launches,
        "grouped_aug_gemm": kernels.grouped_aug_gemm.launches,
    }
    n_mb = engine.stats.microbatches
    check(n_mb >= rounds, f"expected >= {rounds} microbatches, got {n_mb}")
    for name, n in launches.items():
        check(n == n_mb, f"{name} launched {n} times for {n_mb} microbatches")

    t0 = time.monotonic()
    for q in requests:
        per_request(reg, q, dev)
    dt_per_request = time.monotonic() - t0

    # Check 1: engine vs per-request delivery, every round.
    ref_max = max(float(np.abs(b).max()) for b in base)
    err1 = max(
        float(np.abs(f - b).max()) for fs in feats for f, b in zip(fs, base)
    )
    check(all(f.shape == (1, geom.beta, geom.n, geom.n) for f in feats[-1]),
          "engine features have the wrong shape")
    check(all(np.isfinite(f).all() for f in feats[-1]), "non-finite features")
    check(err1 <= REL_TOL * ref_max,
          f"engine vs per-request: {err1} > {REL_TOL * ref_max}")
    # Check 2: eq. 5 — the delivered features are the plain convolution
    # under the tenant's secret channel permutation.
    err2, conv_max = 0.0, 0.0
    for tenant, k in dev_kernels.items():
        idx = [i for i, q in enumerate(requests) if q.tenant_id == tenant]
        data = torch.from_numpy(
            np.concatenate([requests[i].payload for i in idx])
        ).to(dev)
        conv = core.conv_reference(data, torch.from_numpy(k).to(dev), geom)
        perm = torch.from_numpy(reg.session(tenant).provider._perm).to(dev)
        want = conv[:, perm].cpu().numpy()
        got = np.concatenate([feats[-1][i] for i in idx])
        err2 = max(err2, float(np.abs(got - want).max()))
        conv_max = max(conv_max, float(np.abs(want).max()))
    check(err2 <= REL_TOL * conv_max, f"eq. 5: {err2} > {REL_TOL * conv_max}")

    n_images = rounds * len(requests)
    out = {
        "phase": "main_path", "geom": dict(MAIN_GEOM, kappa=1),
        "tenants": 4, "capacity": 4, "requests_per_round": len(requests),
        "rounds": rounds, "microbatches": n_mb,
        "bucket_shapes": sorted(engine.stats.bucket_shapes),
        "launches": launches,
        "images_per_s_engine": n_images / dt_engine,
        "images_per_s_per_request": len(requests) / dt_per_request,
        "device_phase_p50_ms": engine.stats.phase_quantile_ms("device", 0.5),
        "coalesce_phase_p50_ms": engine.stats.phase_quantile_ms("coalesce", 0.5),
        "publish_phase_p50_ms": engine.stats.phase_quantile_ms("publish", 0.5),
        "max_err_vs_per_request": err1, "max_abs_per_request": ref_max,
        "max_err_eq5": err2, "max_abs_conv": conv_max,
        "host_secret_build_s": secrets_s,
    }
    emit(out)
    return out


def churn(dev, core, runtime) -> None:
    rng = np.random.default_rng(SEED + 1)
    geom = core.ConvGeometry(**CHURN_GEOM)
    reg, _ = make_registry(core, geom, tenants=6, capacity=4, rng=rng)
    engine = runtime.MoLeDeliveryEngine(reg, dev)
    worst, cloned_rounds, n_mb = 0.0, 0, 0
    for r in range(3):
        order = [(i + 2 * r) % 6 for i in range(6)]
        reqs = [
            runtime.DeliveryRequest(
                f"tenant-{t}",
                rng.standard_normal((1 + (t + r) % 3, geom.alpha, geom.m, geom.m))
                .astype(np.float32),
            )
            for t in order for _ in range(2)
        ]
        rids = [engine.submit(q) for q in reqs]
        work = engine.begin_flush()
        check(work is not None and len(work.items) >= 2,
              "churn: expected several microbatches in one flush round")
        n_mb += len(work.items)
        # Eviction inside the round leaves earlier items on their own
        # (cloned) stacks.
        if len({id(item.plan) for item in work.items}) > 1:
            cloned_rounds += 1
        engine.execute_flush(work)
        engine.publish_flush(work)
        check(engine.begin_flush() is None, "churn: rows left after one round")
        for rid, q in zip(rids, reqs):
            want = per_request(reg, q, dev)
            got = engine.take(rid)
            err = float(np.abs(got - want).max())
            check(err <= REL_TOL * float(np.abs(want).max()),
                  f"churn round {r}: {q.tenant_id} differs by {err}")
            worst = max(worst, err)
    check(cloned_rounds == 3, f"copy-on-write ran in {cloned_rounds}/3 rounds")
    emit({"phase": "churn", "tenants": 6, "capacity": 4, "rounds": 3,
          "microbatches": n_mb, "rounds_with_copy_on_write": cloned_rounds,
          "evictions": reg.evictions, "max_err_vs_per_request": worst})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, kernels, runtime
    from repro_torch.kernels import build, ref

    dev = runtime.resolve_device(None)
    t0 = time.monotonic()
    report = build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "libraries": {
              n: {"seconds": r["seconds"], "path": str(Path(r["path"]).relative_to(ROOT)),
                  "ptxas": [ln.strip() for ln in r["log"].splitlines()
                            if "registers" in ln or "spill" in ln]}
              for n, r in report.items()}})

    rows = kernel_checks(dev, kernels, ref)
    torch.cuda.empty_cache()
    main = main_path(dev, core, runtime, kernels)
    torch.cuda.empty_cache()
    churn(dev, core, runtime)

    source = "src/repro_torch/kernels/csrc/grouped_gemm.cu"
    replaces = {
        "grouped_block_diag_matmul": "src/repro/kernels/grouped.py:80",
        "grouped_aug_gemm": "src/repro/kernels/grouped.py:157",
    }
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces[name], "launches": main["launches"][name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name in replaces
    ]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
