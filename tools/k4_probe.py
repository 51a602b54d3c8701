"""Probes of K4 (``block_diag_matmul``) on one card, beside ``chip_smoke.py``'s
gates: the measurements behind ``kernels/gemm.py``'s ``morph_route`` and
``tf32_splits``.  Each prints JSON lines; none is gated, but every timed
output is held to a float64 product within ``chip_smoke.FP64_REL_TOL`` of
its max (the split-TF32 route) or to the FFMA route's plain bound.  Inputs
are ``chip_smoke.py``'s (x ~ N(0, 1), core ~ N(0, 1/q), its seed), fp32,
TF32 off for ``torch.matmul``; times are CUDA events over back-to-back calls
through the bindings (which count no launch), taken in turns.

    PYTHONPATH=src python3 tools/k4_probe.py routes
        At each K4 shape chip_smoke.py times (VGG-16's (256, 3072) x
        (3072, 3072), the vlm provider's (2048, 7680) x (7680, 7680),
        whisper's (24000, 384) x (384, 384)) and the other K4_SHAPES: the
        split-TF32 route at its rule's split, the FFMA route (morph_gemm.cu)
        at its rule's split, and torch.matmul, in turns.
    PYTHONPATH=src python3 tools/k4_probe.py splits
        The split-TF32 route at every split from 1 to 16 that leaves no
        slice empty, at the VGG shape and at the vlm and whisper shapes'
        1, 2 and 3, beside the rule's choice.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402

SHAPES = {"vgg": (256, 3072), "vlm_provider": (2048, 7680),
          "whisper_provider": (24000, 384),
          **{f"R{R}_kappa{kappa}_q{q}": (R * kappa, q)
             for R, kappa, q in cs.K4_SHAPES[1:]}}


def operands(dev, M, q):
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    x = torch.randn((1, M, q), generator=gen, device=dev)
    core = torch.randn((1, q, q), generator=gen, device=dev) * q ** -0.5
    return x, core


def iters_for(M, q) -> int:
    return max(3, min(50, int(2e11 // (2 * M * q * q))))


def held_fp64(tag, got, x, core):
    want = torch.bmm(x.double(), core.double())
    err = float((got.double() - want).abs().max()) / float(want.abs().max())
    if err > cs.FP64_REL_TOL:
        raise RuntimeError(f"{tag}: |kernel - fp64| {err} of max > {cs.FP64_REL_TOL}")
    return err


def probe_routes(dev):
    from repro_torch.kernels import gemm

    sms = gemm.sm_count(dev)
    cs.library_fp32_is_full()
    for tag, (M, q) in SHAPES.items():
        x, core = operands(dev, M, q)
        runs = {"tf32": lambda: gemm.morph_tf32("block_diag_matmul", x, core),
                "ffma": lambda: gemm.morph("block_diag_matmul", x, None, core),
                "torch_matmul": lambda: torch.matmul(x[0], core[0])}
        errs = {k: held_fp64(f"{tag} {k}", f().view(1, M, q), x, core)
                for k, f in runs.items() if k != "ffma"}
        want = runs["torch_matmul"]()
        ffma_diff = float((runs["ffma"]()[0] - want).abs().max())
        if ffma_diff > cs.REL_TOL * float(want.abs().max()):
            raise RuntimeError(f"{tag} ffma: |kernel - torch.matmul| {ffma_diff}")
        n = iters_for(M, q)
        order = ["tf32", "ffma", "torch_matmul", "torch_matmul", "ffma", "tf32"]
        times = {k: [] for k in runs}
        for k in order:
            times[k].append(cs.cuda_ms(runs[k], n))
        b, by = cs.bound_ms(4 * (2 * M * q + q * q), 3 * 2 * M * q * q,
                            cs.TF32_FLOP_PER_S)
        cs.emit({"probe": "routes", "shape": tag, "M": M, "q": q,
                 "route": gemm.morph_route(x.dtype, 1, M, q, q),
                 "tf32_splits": gemm.tf32_splits(1, M, q, q, sms),
                 "ffma_splits": gemm.morph_splits(1, M, q, q, sms),
                 "ms": {k: sum(v) / len(v) for k, v in times.items()},
                 "runs_ms": times, "rel_err_fp64": errs,
                 "split_bound_ms": b, "split_bound_by": by,
                 "ffma_bound_ms": cs.bound_ms(4 * (2 * M * q + q * q),
                                              2 * M * q * q)[0]})
        del x, core, want
        torch.cuda.empty_cache()


def probe_splits(dev):
    from repro_torch.kernels import gemm

    sms = gemm.sm_count(dev)
    for tag in ("vgg", "vlm_provider", "whisper_provider"):
        M, q = SHAPES[tag]
        x, core = operands(dev, M, q)
        steps = -(-q // gemm.TF32_BK)
        ok = [s for s in range(1, 17)
              if (s - 1) * -(-steps // s) < steps]
        if tag != "vgg":
            ok = [s for s in ok if s <= 3]
        n = iters_for(M, q)
        sweep = {}
        for s in ok:
            run = lambda: gemm.morph_tf32("block_diag_matmul", x, core, s)  # noqa: B023,E731
            held_fp64(f"{tag} splits {s}", run(), x, core)
            sweep[s] = cs.cuda_ms(run, n)
        again = {s: cs.cuda_ms(lambda: gemm.morph_tf32(  # noqa: B023
            "block_diag_matmul", x, core, s), n) for s in reversed(ok)}
        cs.emit({"probe": "splits", "shape": tag, "M": M, "q": q,
                 "rule": gemm.tf32_splits(1, M, q, q, sms),
                 "ms": {s: (sweep[s] + again[s]) / 2 for s in ok},
                 "first_ms": sweep, "second_ms": again})
        del x, core
        torch.cuda.empty_cache()


def main():
    modes = {"routes": probe_routes, "splits": probe_splits}
    chosen = sys.argv[1:] or list(modes)
    unknown = sorted(set(chosen) - set(modes))
    if unknown:
        sys.exit(f"usage: k4_probe.py [{'|'.join(modes)}]...")
    if not torch.cuda.is_available():
        sys.exit("k4_probe.py: no CUDA device")
    from repro_torch.kernels import build

    for name, rep in build.build_all().items():
        if name == "aug_gemm":
            cs.emit({"probe": "build", "ptxas": [
                ln.strip() for ln in rep["log"].splitlines()
                if "registers" in ln or "spill" in ln or "C75" in ln
                or "entry function" in ln]})
    dev = torch.device("cuda", 0)
    for mode in chosen:
        modes[mode](dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
