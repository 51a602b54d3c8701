"""Runs one of ``chip_smoke.py``'s training phases alone on one card: the
kernels built (``train_path``'s gate 4 decode step launches K3), then the
phase's gates and its JSON line, then the card's name and power limit.

    python3 tools/train_probe.py                      # train_path
    python3 tools/train_probe.py train_resume_path    # launch/train.py

A quicker loop than the whole smoke run (about two minutes a call against
six) for work on the train step or the training driver; the smoke run
stays the proof.
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

PHASES = {"train_path": cs.train_path,
          "train_resume_path": cs.train_resume_path}


def main() -> None:
    phase = sys.argv[1] if len(sys.argv) > 1 else "train_path"
    if phase not in PHASES:
        sys.exit(f"train_probe: unknown phase {phase!r}; one of {sorted(PHASES)}")
    if not torch.cuda.is_available():
        sys.exit("train_probe: needs a GPU")
    from repro_torch import kernels, runtime
    from repro_torch.kernels import build

    dev = runtime.resolve_device(None)
    build.build_all()
    PHASES[phase](dev, kernels)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
