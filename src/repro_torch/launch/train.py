"""Training driver on PyTorch, ported from ``repro.launch.train``.

Runs an architecture the port trains (full or smoke config) through the
resilient training loop: deterministic pipeline (+ MoLe provider stage),
AdamW, periodic async checkpoints, auto-resume.  Runs on the card unless
``--device cpu`` asks for the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi3_mini_3p8b \
        --smoke --steps 8 --ckpt-every 4 --inject-failures 5 --mole token \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek_moe_16b --smoke --steps 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma_2b --smoke --steps 8 --ckpt-every 4 \
        --inject-failures 5 --mole token --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama32_vision_90b --smoke --steps 4 --mole embedding \
        --kappa 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch whisper_tiny --smoke --steps 4 --mole embedding \
        --kappa 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch rwkv6_3b --smoke --device cpu --steps 2

The flags are the reference's, plus ``--device``.  The step is
:func:`repro_torch.launch.steps.make_train_step`, run eagerly: it updates
the parameters and moments in place, so there is no donation to ask for.
Checkpoints go to ``<ckpt-dir>/<arch>`` (three kept); ``--resume`` restores
the latest one into the freshly built state and seeks the pipeline to the
index saved with it.  Every arch of the registry trains, the hybrid
``recurrentgemma_2b`` (RG-LRU and local layers), the vision-language
``llama32_vision_90b``, the audio encoder-decoder ``whisper_tiny`` and
``rwkv6_3b`` (its scan's gradient through the hand-written kernels of
``kernels/wkv6.py``) included; names outside the registry raise
``NotImplementedError``.
``--mole embedding`` (``--kappa`` blocks of the core) morphs a vlm's patch
stream or an audio model's frame stream in the pipeline's provider stage,
through the morph kernel K4 on ``--device``; a model without a frontend
refuses it (``ValueError``).

``main(argv, cfg=...)`` runs on a given config in place of ``--arch``'s
(``--smoke`` is then ignored; the ``--mole`` flags still apply): that is
how a smoke run on the card cuts a published config's depth, since the
driver has no flag for it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import ARCHS, get_config, get_smoke_config
from ..data.pipeline import DataConfig, Pipeline
from ..models.api import Model
from ..models.base import ModelConfig, MoLeCfg
from ..optim import adamw
from ..runtime.resilience import FailureInjector, ResilientLoop
from .steps import TrainHParams, make_train_step

__all__ = ["build", "main", "parse_args"]


def build(args, cfg: ModelConfig | None = None):
    """``(cfg, model, step_fn, pipeline)`` for ``args``, on ``cfg`` if
    given, else on ``--arch``'s (smoke) config."""
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.mole != "off":
        cfg = dataclasses.replace(
            cfg, mole=MoLeCfg(enabled=True, mode=args.mole, kappa=args.kappa,
                              seed=args.mole_seed)
        )
    model = Model(cfg, args.device)
    hp = TrainHParams(
        optimizer=adamw.AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                                    decay_steps=max(args.steps, 2)),
        microbatch=args.microbatch,
        remat=not args.no_remat,
    )
    step_fn = make_train_step(model, hp)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.batch, seed=args.data_seed)
    pipeline = Pipeline(dcfg, model_cfg=cfg, device=model.device)
    return cfg, model, step_fn, pipeline


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help=f"architecture to train: {', '.join(ARCHS)}")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--mole", default="off", choices=["off", "token", "embedding"])
    ap.add_argument("--kappa", type=int, default=1)
    ap.add_argument("--mole-seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failures", default="", help="comma steps")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None, cfg: ModelConfig | None = None):
    """Train as the flags say; returns ``(state, history)`` with ``state =
    {"params": ParamTree, "opt": AdamW state}`` after the last step."""
    args = parse_args(argv)
    cfg, model, step_fn, pipeline = build(args, cfg)
    params = model.init(0)
    opt = adamw.init_state(params)
    print(f"arch={cfg.name} params={model.param_count()/1e6:.2f}M "
          f"mole={cfg.mole.mode if cfg.mole.enabled else 'off'}")

    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name, keep=3)
    start = 0
    state = {"params": params, "opt": opt}
    if args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        extra = ckpt.restore_into(start, state)
        pipeline.seek(extra["data"]["index"])
        print(f"resumed from step {start}")

    injector = None
    if args.inject_failures:
        injector = FailureInjector(
            at_steps={int(s) for s in args.inject_failures.split(",")}
        )

    def loop_step(state, batch):
        # a morphed patch stream is already on the device
        b = {k: torch.as_tensor(v, device=model.device)
             for k, v in batch.items()}
        p, o, metrics = step_fn(state["params"], state["opt"], b)
        return {"params": p, "opt": o}, metrics

    loop = ResilientLoop(loop_step, ckpt, pipeline,
                         ckpt_every=args.ckpt_every, injector=injector)
    t0 = time.time()
    state, history = loop.run(state, args.steps, start_step=start)
    dt = time.time() - t0

    losses = [h["loss"] for h in history if "loss" in h]
    for h in history:
        if "event" in h:
            print(f"  [FT] step {h['step']}: {h['event']}")
        elif h["step"] % args.log_every == 0:
            print(f"  step {h['step']:5d} loss {float(h['loss']):.4f} "
                  f"gnorm {float(h['grad_norm']):.3f} {h['wall_s']*1e3:.0f}ms")
    if losses:
        print(f"done: steps={len(losses)} first_loss={float(losses[0]):.4f} "
              f"last_loss={float(losses[-1]):.4f} wall={dt:.1f}s "
              f"restarts={loop.restarts} stragglers={len(loop.straggler.slow_steps)}")
    return state, history


if __name__ == "__main__":
    main()
