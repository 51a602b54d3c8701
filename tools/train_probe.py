"""Runs one or more of ``chip_smoke.py``'s training and LM phases alone on
one card: the kernels built (``train_path``'s gate 4 decode step launches
K3), then each phase's gates and its JSON line, then the card's name and
power limit.

    python3 tools/train_probe.py                      # train_path
    python3 tools/train_probe.py train_resume_path    # launch/train.py
    python3 tools/train_probe.py kernels_k3 gemma2_path command_r_path \
        gemma2_train                                  # vocab 256000
    python3 tools/train_probe.py moe_path mla_path mla_train   # MoE, MLA
    python3 tools/train_probe.py kernels_k3 recurrentgemma_path  # RG-LRU
    python3 tools/train_probe.py recurrentgemma_train   # the hybrid, trained
    python3 tools/train_probe.py kernels_k45 vlm_path vlm_train   # the vlm
    python3 tools/train_probe.py whisper_path whisper_train   # whisper_tiny
    python3 tools/train_probe.py kernels_k6 rwkv_train   # K6's gradient, rwkv6_3b
    python3 tools/train_probe.py sharded_path   # a (1, 1) mesh, NCCL

A quicker loop than the whole smoke run (about two minutes a call against
six) for work on the train step or the training driver; the smoke run
stays the proof.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402

PHASES = {
    "train_path": cs.train_path,
    "train_resume_path": cs.train_resume_path,
    "kernels_k3": lambda dev, kernels: cs.k3_checks(
        dev, kernels, kernels.ref),
    "gemma2_path": lambda dev, kernels: cs.lm_path(
        dev, kernels, phase="gemma2_path", arch=cs.GEMMA2_ARCH,
        prompt_len=cs.GEMMA2_PROMPT, groups=cs.GEMMA2_GROUPS),
    "command_r_path": lambda dev, kernels: cs.lm_path(
        dev, kernels, phase="command_r_path", arch=cs.COMMAND_R_ARCH,
        prompt_len=cs.COMMAND_R_PROMPT, groups=cs.COMMAND_R_LAYERS),
    "gemma2_train": lambda dev, kernels: cs.train_path(
        dev, kernels, phase="gemma2_train", arch=cs.GEMMA2_ARCH,
        peak_limit_gb=cs.PEAK_LIMIT_GB, **cs.GEMMA2_TRAIN),
    "moe_path": lambda dev, kernels: cs.lm_path(
        dev, kernels, phase="moe_path", arch=cs.MOE_ARCH,
        prompt_len=cs.MOE_PROMPT),
    "mla_path": lambda dev, kernels: cs.lm_path(
        dev, kernels, phase="mla_path", arch=cs.MLA_ARCH,
        prompt_len=cs.MLA_PROMPT),
    "recurrentgemma_path": lambda dev, kernels: cs.lm_path(
        dev, kernels, phase="recurrentgemma_path", arch=cs.RG_ARCH,
        prompt_len=cs.RG_PROMPT, twin_groups=cs.RG_TWIN_GROUPS),
    "mla_train": lambda dev, kernels: cs.train_path(
        dev, kernels, phase="mla_train", arch=cs.MLA_ARCH,
        peak_limit_gb=cs.PEAK_LIMIT_GB, **cs.MLA_TRAIN),
    "recurrentgemma_train": lambda dev, kernels: cs.train_path(
        dev, kernels, phase="recurrentgemma_train", arch=cs.RG_ARCH,
        peak_limit_gb=cs.PEAK_LIMIT_GB, **cs.RG_TRAIN),
    "kernels_k45": lambda dev, kernels: cs.k45_checks(
        dev, kernels, kernels.ref),
    "vlm_path": cs.vlm_path,
    "vlm_train": cs.vlm_train,
    "whisper_path": cs.whisper_path,
    "whisper_train": cs.whisper_train,
    "kernels_k6": lambda dev, kernels: cs.k6_checks(
        dev, kernels, kernels.ref, REPORT),
    "rwkv_train": lambda dev, kernels: cs.train_path(
        dev, kernels, phase="rwkv_train", arch=cs.RWKV_ARCH,
        peak_limit_gb=cs.PEAK_LIMIT_GB, **cs.RWKV_TRAIN),
}
REPORT: dict = {}   # build.build_all()'s report: kernels_k6 prints ptxas's


def sharded_path(dev, kernels):
    """chip_smoke's sharded_path on main_path's registry and requests,
    built here as main_path builds them."""
    from repro_torch import core, runtime

    rng = np.random.default_rng(cs.SEED)
    geom = core.ConvGeometry(**cs.MAIN_GEOM)
    reg, _ = cs.make_registry(core, geom, tenants=4, capacity=4, rng=rng)
    requests = [runtime.DeliveryRequest(
        f"tenant-{i % 4}",
        rng.standard_normal((1, geom.alpha, geom.m, geom.m)).astype(np.float32))
        for i in range(256)]
    return cs.sharded_path(dev, core, runtime, kernels, (reg, requests, None))


PHASES["sharded_path"] = sharded_path


def main() -> None:
    phases = sys.argv[1:] or ["train_path"]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        sys.exit(f"train_probe: unknown phases {unknown}; one of {sorted(PHASES)}")
    if not torch.cuda.is_available():
        sys.exit("train_probe: needs a GPU")
    from repro_torch import kernels, runtime
    from repro_torch.kernels import build

    dev = runtime.resolve_device(None)
    REPORT.update(build.build_all())
    for phase in phases:
        PHASES[phase](dev, kernels)
        cs.release()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
