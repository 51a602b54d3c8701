"""Rank-side work of ``tests/test_torch_distributed.py``: what each spawned
gloo rank runs, without importing JAX (a spawned child imports this module
only).  Each job writes one JSON file a rank (and rank 0 an ``.npz`` of the
arrays the parent compares with the reference) into ``out``.

``spawn`` starts the ranks with ``torch.multiprocessing`` and gives the
join a deadline of its own; every process group has its own timeout, so a
hung collective fails one test instead of the suite.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60        # a collective that waits longer raises
JOIN_DEADLINE_S = 85        # the spawned job as a whole

TRAIN_BATCH = (8, 32)       # tests/test_distributed.py:51-52
MOE_BATCH = (4, 16)
MOE_ODD_BATCH = 3           # does not divide by dp = 2
MOE_TRAIN_BATCH = (4, 16)   # two microbatches of 2 rows: 1 a dp rank
MOE_ODD_TRAIN_BATCH = (3, 16)
TRAIN_PARAMS = "train_params.npz"       # written by the parent
MOE_TRAIN_PARAMS = "moe_train_params.npz"


class Job:
    """Ranks started by :func:`start`; :meth:`join` waits for them (up to
    the deadline counted from the start) and reads their records."""

    def __init__(self, job: str, world: int, tmp_path):
        self.job, self.world, self.out = job, world, str(tmp_path)
        store = os.path.join(self.out, f"{job}.store")
        self.ctx = mp.start_processes(_rank_main,
                                      args=(job, world, store, self.out),
                                      nprocs=world, join=False,
                                      start_method="spawn")
        self.deadline = time.monotonic() + JOIN_DEADLINE_S

    def join(self) -> list[dict]:
        try:
            while not self.ctx.join(
                    timeout=max(0.1, self.deadline - time.monotonic())):
                if time.monotonic() >= self.deadline:
                    raise TimeoutError(f"{self.job}: ranks still running "
                                       f"after {JOIN_DEADLINE_S} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(self.world):
            with open(os.path.join(self.out,
                                   f"{self.job}_rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def start(job: str, world: int, tmp_path) -> Job:
    """Start ``job`` on ``world`` gloo ranks (rendezvous through a file
    under ``tmp_path``, which also holds what the job reads and writes)."""
    return Job(job, world, tmp_path)


def spawn(job: str, world: int, tmp_path) -> list[dict]:
    """Run ``job`` on ``world`` gloo ranks; returns each rank's record."""
    return start(job, world, tmp_path).join()


def train_batch(vocab: int, shape: tuple[int, int]) -> dict:
    """Tokens and targets from a seed (numpy: both packages get them)."""
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, vocab, shape).astype(np.int32)
            for k in ("tokens", "targets")}


def save_params(path, named: dict) -> None:
    """Parameters by ``adamw.named_leaves`` name, for the ranks to load
    (the parent may write them after the ranks started: the file appears
    whole, by a rename)."""
    part = f"{path}.part.npz"
    np.savez(part, **named)
    os.replace(part, path)


def load_params(model, path):
    """``model``'s parameter tree holding the saved values, once the file
    is there (within the group timeout)."""
    from repro_torch.optim import adamw

    deadline = time.monotonic() + GROUP_TIMEOUT_S
    while not os.path.exists(path):
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{path} not written in {GROUP_TIMEOUT_S} s")
        time.sleep(0.05)
    params = model.init(0)
    with np.load(path) as z, torch.no_grad():
        for n, p in adamw.named_leaves(params):
            p.copy_(torch.from_numpy(z[n]))
    return params


def _rank_main(rank: int, job: str, world: int, store: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        record = JOBS[job](rank, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"{job}_rank{rank}.json"), "w") as f:
        json.dump(record, f)


# -- the 8-rank job: (2, 2, 2) and (8, 1) meshes -----------------------------

def _leaf_grads(step, params, opt, batch):
    """The gradients ``adamw.apply`` receives in one step (whole tensors),
    beside the step's outputs."""
    from repro_torch.optim import adamw

    seen = {}
    real = adamw.apply

    def capture(cfg, p, grads, state):
        seen.update({n: (g.full_tensor() if hasattr(g, "full_tensor")
                         else g).detach().clone() for n, g in grads.items()})
        return real(cfg, p, grads, state)

    adamw.apply = capture
    try:
        out = step(params, opt, batch)
    finally:
        adamw.apply = real
    return out, seen


def train_cfg(arch: str):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")


def _sharded_and_plain_steps(arch: str, path: str, mesh, shape,
                             microbatch, watch=None):
    """The train step on the saved parameters, unsharded on this rank and
    sharded on ``mesh`` (inside the context ``watch``, if given):
    ``(plain, sharded)``, each ``((params, opt, metrics), gradients)``."""
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.launch.steps import (TrainHParams, make_train_step,
                                          shard_train_state)
    from repro_torch.models import Model
    from repro_torch.optim import adamw

    model = Model(train_cfg(arch), device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in train_batch(model.cfg.vocab, shape).items()}
    step = make_train_step(model, TrainHParams(microbatch=microbatch))
    params = load_params(model, path)
    plain = _leaf_grads(step, params, adamw.init_state(params), batch)
    params = load_params(model, path)
    sp, so = shard_train_state(model, params, adamw.init_state(params), mesh)
    with mesh_context(mesh), watch or contextlib.nullcontext():
        sharded = _leaf_grads(step, sp, so, batch)
    return plain, sharded


def _grad_rel(got: dict, want: dict) -> dict:
    return {n: float((got[n] - want[n]).abs().max()
                     / want[n].abs().max().clamp_min(1e-30)) for n in want}


def _train(rank: int, out: str) -> dict:
    """deepseek_7b smoke (fp32), batch (8, 32), microbatch=2, on (2, 2, 2)
    against the same step unsharded on this rank; rank 0 keeps the sharded
    gradients for the parent to hold against the reference's."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw
    from torch.distributed.tensor import DTensor

    mesh = make_debug_mesh(2, 2, pods=2, device_type="cpu")
    ((ref_p, _, ref_m), ref_g), ((out_p, out_o, out_m), out_g) = \
        _sharded_and_plain_steps("deepseek_7b",
                                 os.path.join(out, TRAIN_PARAMS), mesh,
                                 TRAIN_BATCH, 2)
    if rank == 0:
        np.savez(os.path.join(out, "job8_grads.npz"),
                 **{n: g.numpy() for n, g in out_g.items()})
    grad_rel = _grad_rel(out_g, ref_g)
    ref_leaves = dict(adamw.named_leaves(ref_p))
    param_err = max(float((p.full_tensor() - ref_leaves[n]).abs().max())
                    for n, p in adamw.named_leaves(out_p))
    return {
        "loss_ref": float(ref_m["loss"]), "loss_sh": float(out_m["loss"]),
        "gnorm_ref": float(ref_m["grad_norm"]),
        "gnorm_sh": float(out_m["grad_norm"]),
        "grad_rel": grad_rel, "param_err": param_err,
        "metrics_plain": not any(isinstance(v, DTensor)
                                 for v in out_m.values()),
        "leaves_dtensor": all(isinstance(p, DTensor)
                              for _, p in adamw.named_leaves(out_p)),
        "moments_like_leaves": all(
            tuple(out_o[k][n].placements) == tuple(p.placements)
            for k in ("m", "v") for n, p in adamw.named_leaves(out_p)),
        "head_placements": [
            str(p) for p in dict(adamw.named_leaves(out_p))["head"].placements],
    }


def _psum(rank: int) -> dict:
    """compressed_psum over "pod" on (2, 2, 2); the dtypes all_gather
    carried."""
    from repro_torch.launch.mesh import make_debug_mesh, mesh_context
    from repro_torch.optim.compress import compressed_psum

    mesh = make_debug_mesh(2, 2, pods=2, device_type="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                         .astype(np.float32))
    wire = []
    real = dist.all_gather

    def gather(tensors, t, group=None, **kw):
        wire.append(str(t.dtype))
        return real(tensors, t, group=group, **kw)

    dist.all_gather = gather
    try:
        with mesh_context(mesh):
            got = compressed_psum(x, "pod", mesh)
    finally:
        dist.all_gather = real
    return {"err": float((got - 2 * x).abs().max()), "wire": wire,
            "dtype": str(got.dtype)}


def _nested_order(rank: int) -> dict:
    """A dim on ("pod", "data") splits pod-major, as JAX splits it."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import shard_tensor

    mesh = make_debug_mesh(2, 2, pods=2, device_type="cpu")
    x = torch.arange(32.0).reshape(16, 2)
    d = shard_tensor(x, mesh, (("pod", "data"), "model"))
    idx = mesh.get_local_rank("pod") * 2 + mesh.get_local_rank("data")
    col = mesh.get_local_rank("model")
    want = x[4 * idx:4 * idx + 4, col:col + 1]
    return {"ok": bool(torch.equal(d.to_local(), want)),
            "placements": [str(p) for p in d.placements]}


def _hint(rank: int) -> dict:
    """hint() on a DTensor under the mesh, on names absent from it, on a
    plain tensor, and with no mesh."""
    from repro_torch.launch.mesh import make_debug_mesh, mesh_context
    from repro_torch.sharding.hints import hint
    from repro_torch.sharding.rules import shard_tensor

    mesh = make_debug_mesh(2, 2, pods=2, device_type="cpu")
    x = shard_tensor(torch.arange(48.0).reshape(8, 6), mesh, (None, None))
    plain = torch.ones(8, 6)
    with mesh_context(mesh):
        both = hint(x, "dp", "model")
        odd = hint(x, "model", "data")       # 6 % 2 == 0, 8 % 2 == 0
        absent = hint(x, "dp", "expert")
        undivided = hint(shard_tensor(torch.ones(6, 3), mesh, (None, None)),
                         "dp", "model")
        same_plain = hint(plain, "dp", "model") is plain
    return {
        "both": [str(p) for p in both.placements],
        "both_value": bool(torch.equal(both.full_tensor(), x.full_tensor())),
        "odd": [str(p) for p in odd.placements],
        "absent": [str(p) for p in absent.placements],
        "undivided": [str(p) for p in undivided.placements],
        "plain": same_plain, "no_mesh": hint(x, "dp") is x,
    }


def vision_registry(core, rng):
    """8 tenants at the reference test's geometry (either package's
    ``core``: the same seeds draw the same secrets)."""
    geom = core.ConvGeometry(alpha=2, beta=4, m=6, p=3)
    reg = core.SessionRegistry(geom, kappa=2, capacity=8)
    fan_in = geom.alpha * geom.p * geom.p
    for i in range(8):
        k = rng.standard_normal((geom.alpha, geom.beta, geom.p, geom.p))
        reg.register(f"t{i}", (k / np.sqrt(fan_in)).astype(np.float32),
                     seed=100 + i)
    return geom, reg


def engine_inputs(rng, geom, tenants) -> dict:
    """Each tenant's three images, drawn after the registry's kernels."""
    return {t: rng.standard_normal((3, geom.alpha, geom.m, geom.m))
            .astype(np.float32) for t in tenants}


def _engine(rank: int, outdir: str) -> dict:
    """The vision lane's group axis over an (8, 1) mesh (the reference's
    tests/test_distributed.py:99), and the token and features lanes
    sharded against the same engine unsharded; rank 0 keeps the flushed
    images for the parent to hold against the reference's per-request
    ``deliver``."""
    import repro_torch.core as core
    from repro_torch.core.lm import LMSessionRegistry
    from repro_torch.launch.mesh import make_debug_mesh, mesh_context
    from repro_torch.runtime import DeliveryRequest, MoLeDeliveryEngine
    from torch.distributed.tensor import DTensor

    rng = np.random.default_rng(0)
    geom, reg = vision_registry(core, rng)
    eng = MoLeDeliveryEngine(reg, "cpu", group_buckets=(1, 2, 4, 8))
    mesh = make_debug_mesh(8, 1, device_type="cpu")
    datas = engine_inputs(rng, geom, reg.tenant_ids)
    with mesh_context(mesh):
        for t, d in datas.items():
            eng.submit(DeliveryRequest(t, d))
        mb = eng.queue.coalesce(reg.slot_for, max_groups=reg.capacity)
        out = eng._execute(mb.x, mb.group_tenant, eng._refresh_plan())
        rids = {t: eng.submit(DeliveryRequest(t, d))
                for t, d in datas.items()}
        done = eng.flush()
    if rank == 0:
        np.savez(os.path.join(outdir, "job8_images.npz"),
                 **{t: done[rids[t]] for t in datas})
    err = max(float(np.max(np.abs(
        done[rids[t]]
        - reg.session(t).deliver(torch.from_numpy(d)).numpy())))
        for t, d in datas.items())
    vision = {
        "dtensor": isinstance(out, DTensor),
        "placements": [str(p) for p in out.placements],
        "local_shape": list(out.to_local().shape),
        "shape": list(out.shape), "coord": mesh.get_local_rank("data"),
        "err": err,
    }

    # token and features lanes: one engine under the mesh, one without
    lm_rng = np.random.default_rng(1)
    V, d_model, d_in = 64, 8, 6
    tables = [(lm_rng.standard_normal((V, d_model)).astype(np.float32),
               lm_rng.standard_normal((d_in, d_model)).astype(np.float32))
              for _ in range(8)]
    requests = []
    for i in range(8):
        toks = lm_rng.integers(0, V, (2, 5)).astype(np.int32)
        requests.append(DeliveryRequest(
            f"l{i}", toks, lane="tokens",
            deliver="embed" if i % 2 else "tokens"))
        requests.append(DeliveryRequest(
            f"l{i}", lm_rng.standard_normal((3, d_in)).astype(np.float32),
            lane="features"))

    def lm_run(sharded: bool):
        lreg = LMSessionRegistry(V, d_model, capacity=8, d_in=d_in,
                                 d_out=d_model)
        for i, (emb, w_in) in enumerate(tables):
            lreg.register(f"l{i}", emb, w_in=w_in, seed=200 + i)
        leng = MoLeDeliveryEngine(lm_registry=lreg, device="cpu",
                                  group_buckets=(1, 2, 4, 8))
        placed = []
        real = leng._execute_tokens

        def spy(*a, **kw):
            morphed, feats = real(*a, **kw)
            placed.append(isinstance(morphed, DTensor))
            return morphed, feats

        leng._execute_tokens = spy
        with mesh_context(mesh) if sharded else contextlib.nullcontext():
            rids = [leng.submit(r) for r in requests]
            done = leng.flush()
        return [done[r] for r in rids], placed

    got, placed = lm_run(True)
    want, _ = lm_run(False)
    lanes = {"same_bits": all(a.dtype == b.dtype and np.array_equal(a, b)
                              for a, b in zip(got, want)),
             "tokens_dtensor": bool(placed) and all(placed)}
    return {"vision": vision, "lanes": lanes}


def job8(rank: int, out: str) -> dict:
    t0 = time.monotonic()
    record = {"psum": _psum(rank), "order": _nested_order(rank),
              "hint": _hint(rank), "engine": _engine(rank, out),
              "train": _train(rank, out)}
    record["seconds"] = time.monotonic() - t0
    return record


# -- the 4-rank job: expert-parallel MoE on (2, 2) ---------------------------

def moe_arrays(cfg, B: int = MOE_BATCH[0], S: int = MOE_BATCH[1]) -> dict:
    """One MoE layer's weights, its input and a cotangent, from a seed
    (numpy: the same arrays reach both packages)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_routed
    rng = np.random.default_rng(7)

    def w(*shape, scale=None):
        s = scale if scale is not None else 1 / np.sqrt(shape[-2])
        return (rng.standard_normal(shape) * s).astype(np.float32)

    fs = m.n_shared * f
    return {"router": w(d, e, scale=0.5), "wg": w(e, d, f), "wu": w(e, d, f),
            "wd": w(e, f, d), "shared.wi_gate": w(d, fs),
            "shared.wi_up": w(d, fs), "shared.wo": w(fs, d),
            "x": rng.standard_normal((B, S, d)).astype(np.float32),
            "cot": rng.standard_normal((B, S, d)).astype(np.float32)}


def _moe_params(a: dict) -> dict:
    t = {k: torch.tensor(v) for k, v in a.items() if k not in ("x", "cot")}
    return {"router": t["router"], "wg": t["wg"], "wu": t["wu"],
            "wd": t["wd"], "shared": {k: t[f"shared.{k}"]
                                      for k in ("wi_gate", "wi_up", "wo")}}


def _placed_moe(p: dict, cfg, mesh):
    """An MoE FFN's weights placed by ``param_rules(fsdp=True)`` as DTensors
    that require grad, and their compute view as the train step takes it
    (dp axes gathered, experts over "model")."""
    from repro_torch.models import blocks
    from repro_torch.models.base import param_axes
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.spmd import Deferred, in_use

    placed = R.shard_tree(R.param_rules(mesh, fsdp=True),
                          param_axes(blocks.schema_moe(cfg)), p)
    for leaf in (placed[k] for k in ("router", "wg", "wu", "wd")):
        leaf.requires_grad_(True)
    for leaf in placed["shared"].values():
        leaf.requires_grad_(True)
    return placed, in_use(Deferred(placed, mesh, True))


def _dp_whole(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows gathered over the dp ranks (plain tensors)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return DTensor.from_local(
        t, mesh, [Shard(0) if n in ("pod", "data") else Replicate()
                  for n in mesh.mesh_dim_names], run_check=False).full_tensor()


def _moe_forms():
    """``(counts, context)``: inside the context the two MoE forms are
    patched to count their calls."""
    from repro_torch.models import blocks

    counts = {"sharded": 0, "dense": 0}
    real = {k: getattr(blocks, f"_apply_moe_{k}") for k in counts}

    def spy(kind):
        def f(*a, **kw):
            counts[kind] += 1
            return real[kind](*a, **kw)
        return f

    @contextlib.contextmanager
    def patched():
        for k in counts:
            setattr(blocks, f"_apply_moe_{k}", spy(k))
        try:
            yield counts
        finally:
            for k, f in real.items():
                setattr(blocks, f"_apply_moe_{k}", f)

    return counts, patched()


def _moe_train(rank: int, out: str, mesh) -> dict:
    """deepseek_moe_16b smoke (fp32) train steps, each against the
    unsharded step: on (2, 2) a batch of (4, 16) in two microbatches (1 row
    a dp rank: expert-parallel, each rank's tokens routed with their own
    capacity) and one of 3 rows (does not split over dp: replicated,
    dense); on (1, 4) the (4, 16) batch again (expert-parallel over every
    token of the microbatch: the dense form's capacity).  Rank 0 keeps the
    first's sharded gradients."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw

    path = os.path.join(out, MOE_TRAIN_PARAMS)
    model4 = make_debug_mesh(1, 4, device_type="cpu")
    rec = {}
    for key, mesh, shape, micro in (
            ("split", mesh, MOE_TRAIN_BATCH, 2),
            ("odd", mesh, MOE_ODD_TRAIN_BATCH, None),
            ("model4", model4, MOE_TRAIN_BATCH, 2)):
        forms, watch = _moe_forms()
        ((_, _, ref_m), ref_g), ((out_p, _, out_m), out_g) = \
            _sharded_and_plain_steps("deepseek_moe_16b", path, mesh, shape,
                                     micro, watch)
        if rank == 0 and key == "split":
            np.savez(os.path.join(out, "job4_train_grads.npz"),
                     **{n: g.numpy() for n, g in out_g.items()})
        rec[key] = {
            "loss_ref": float(ref_m["loss"]), "loss_sh": float(out_m["loss"]),
            "gnorm_ref": float(ref_m["grad_norm"]),
            "gnorm_sh": float(out_m["grad_norm"]),
            "grad_rel": _grad_rel(out_g, ref_g),
            "forms": forms,         # the sharded step's
            "n_leaves": len(adamw.named_leaves(out_p)),
        }
    return rec


def job4(rank: int, out: str) -> dict:
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import blocks
    from repro_torch.sharding.spmd import Deferred, in_use, local_rows

    t0 = time.monotonic()
    cfg = train_cfg("deepseek_moe_16b")
    a = moe_arrays(cfg)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    placed, view = _placed_moe(_moe_params(a), cfg, mesh)
    x = torch.tensor(a["x"], requires_grad=True)
    # this rank's own tokens, as a rank of the train step holds them
    y = blocks.apply_moe(view, local_rows(x, mesh), cfg)
    (y * local_rows(torch.from_numpy(a["cot"]), mesh)).sum().backward()
    whole = _dp_whole(y.detach(), mesh)
    gx = x.grad.clone()         # this rank's rows; the others' are 0
    dist.all_reduce(gx, group=mesh.get_group("data"))
    # B = 3 does not divide by dp = 2: every rank holds all 3 rows, and
    # the compute view gathers the FFN whole (the dense form)
    x3 = torch.from_numpy(moe_arrays(cfg, B=MOE_ODD_BATCH)["x"])
    whole3 = in_use(Deferred(placed, mesh, False))
    y3 = blocks.apply_moe(whole3, local_rows(x3, mesh), cfg)
    dense3 = blocks.apply_moe(_moe_params(a), x3, cfg)
    grads = {"x": gx, **{k: placed[k].grad.full_tensor()
                         for k in ("router", "wg", "wu", "wd")},
             **{f"shared.{k}": v.grad.full_tensor()
                for k, v in placed["shared"].items()}}
    if rank == 0:
        np.savez(os.path.join(out, "job4_arrays.npz"),
                 y=whole.numpy(),
                 **{f"grad_{k}": g.numpy() for k, g in grads.items()})
    return {
        "plain": type(y) is torch.Tensor,
        "local_shape": list(y.shape),
        "odd_plain_weights": all(type(w) is torch.Tensor
                                 for w in (whole3["wg"], whole3["router"])),
        "odd_dense_same_bits": bool(torch.equal(y3, dense3)),
        "train": _moe_train(rank, out, mesh),
        "seconds": time.monotonic() - t0,
    }


JOBS = {"job8": job8, "job4": job4}
