"""The port's training driver on the CPU against the JAX reference:
``runtime/resilience.py`` ``ResilientLoop`` (restore from the latest
checkpoint, restart from scratch, stragglers), ``checkpoint/manager.py`` on
a model's ``ParamTree`` (the reference's paths, ``restore_into`` in place),
``launch/train.py`` (``--inject-failures``, ``--resume``, its output) and
``optim/compress.py``'s int8 quantizer and error feedback.

Unless a test says otherwise the model is the phi3_mini_3p8b smoke config
and the loop is ``tests/test_resilience.py``'s (sequences of 32, batches of
4, data seed 3, AdamW lr 1e-3, warmup 2, decay 20).  Tolerances:

  * the port against itself (a faulty or resumed run against a clean
    one): bit for bit — the same ops on the same inputs in one process;
  * the port against the reference on the same carried weights: losses at
    ``LOSS_RTOL`` 1e-5 and parameters within 2 lr a step (the bounds
    ``tests/test_torch_train.py`` holds a train step to, summed over the
    run's steps), at lr 1e-4.  At the reference test's lr 1e-3 Adam
    amplifies the packages' rounding past 1e-5 by the fourth step (7.6e-6,
    2.9e-5 at the sixth); at 1e-4 the losses stay within 3.1e-7 over 12
    steps and the parameters within 1.0e-4 of their max;
  * int8 codes and scales: bit for bit against the reference.
"""
import dataclasses
import json
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint.manager import (  # noqa: E402
    _flatten_with_paths as j_flatten_with_paths,
)
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import Pipeline as JPipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import TrainHParams as JTrainHParams  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro.runtime import FailureInjector as JFailureInjector  # noqa: E402
from repro.runtime import ResilientLoop as JResilientLoop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import tree_leaves  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import TrainHParams, make_train_step  # noqa: E402
from repro_torch.models import Model, ParamTree, params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.compress import (  # noqa: E402
    ErrorFeedback, dequantize_int8, quantize_int8,
)
from repro_torch.runtime import (  # noqa: E402
    FailureInjector, ResilientLoop, StragglerMonitor,
)

ARCH = "phi3_mini_3p8b"
LOSS_RTOL = 1e-5
PARITY_LR = 1e-4


def _setup(tmp_path, tag, cfg=None, params=None, lr=1e-3):
    """``tests/test_resilience.py``'s ``_setup`` on the port."""
    cfg = cfg or get_smoke_config(ARCH)
    model = Model(cfg, "cpu")
    if params is None:
        params = model.init(0)
    raw_step = make_train_step(model, TrainHParams(
        optimizer=adamw.AdamWConfig(lr=lr, warmup_steps=2, decay_steps=20)))

    def loop_step(state, batch):
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        p, o, m = raw_step(state["params"], state["opt"], b)
        return {"params": p, "opt": o}, m

    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                               seed=3), model_cfg=cfg)
    ckpt = CheckpointManager(tmp_path / tag, keep=3, async_save=False)
    return loop_step, pipe, ckpt, {"params": params,
                                   "opt": adamw.init_state(params)}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def _assert_same_state(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _same_bits(a.detach(), b.detach())


def _losses(history) -> dict:
    """step -> loss of the last run of that step."""
    return {h["step"]: float(h["loss"]) for h in history if "loss" in h}


# -- ResilientLoop: tests/test_resilience.py on the port ----------------------

def test_failure_recovery_is_exact(tmp_path):
    """Failures at steps 6 and 10 with checkpoints every 4: two restores,
    and the run ends with the clean 12-step run's parameters, moments and
    count bit for bit (the reference holds its own to 1e-6), its losses
    equal step for step; each restore keeps every leaf's storage."""
    step, pipe_a, ckpt_a, state_a = _setup(tmp_path, "clean")
    clean, clean_hist = ResilientLoop(step, ckpt_a, pipe_a,
                                      ckpt_every=4).run(state_a, 12)

    step, pipe_b, ckpt_b, state_b = _setup(tmp_path, "faulty")
    ptrs = [leaf.data_ptr() for leaf in tree_leaves(state_b["params"])]
    moments = [leaf.data_ptr() for leaf in tree_leaves(
        {k: state_b["opt"][k] for k in ("m", "v")})]
    seen = []

    def on_restore(state):
        assert [leaf.data_ptr() for leaf in tree_leaves(state["params"])] == ptrs
        assert [leaf.data_ptr() for leaf in tree_leaves(
            {k: state["opt"][k] for k in ("m", "v")})] == moments
        seen.append(int(state["opt"]["count"]))
        return state

    inj = FailureInjector(at_steps={6, 10})
    loop = ResilientLoop(step, ckpt_b, pipe_b, ckpt_every=4, injector=inj,
                         on_restore=on_restore)
    faulty, hist = loop.run(state_b, 12)

    assert loop.restarts == 2
    assert [h["event"] for h in hist if "event" in h] == [
        "restored@4: injected failure at step 6",
        "restored@8: injected failure at step 10"]
    assert seen == [4, 8]
    assert faulty["params"] is state_b["params"]
    assert _losses(hist) == _losses(clean_hist)
    _assert_same_state(faulty, clean)
    assert int(faulty["opt"]["count"]) == 12


def test_failure_before_first_checkpoint(tmp_path):
    """A failure at step 1 with no checkpoint yet restarts from scratch, and
    from scratch means the state the run was given: 4 steps end with the
    uninterrupted run's state, count 4, bit for bit.  The reference keeps
    the state trained so far at its restart-clean branch and trains the
    first batch twice: at this config it ends with AdamW count 5 against
    4, its parameters up to 5.9e-3 from the uninterrupted run's."""
    step, pipe, ckpt, state = _setup(tmp_path, "early")
    given_params = state["params"]
    inj = FailureInjector(at_steps={1})
    loop = ResilientLoop(step, ckpt, pipe, ckpt_every=100, injector=inj)
    out, hist = loop.run(state, 4)
    assert [h.get("event") for h in hist if "event" in h] == [
        "restart-clean: injected failure at step 1"]
    assert loop.restarts == 1
    assert out["params"] is given_params
    assert int(out["opt"]["count"]) == 4

    step, pipe, ckpt, state = _setup(tmp_path, "uninterrupted")
    clean, clean_hist = ResilientLoop(step, ckpt, pipe,
                                      ckpt_every=100).run(state, 4)
    _assert_same_state(out, clean)
    assert _losses(hist) == _losses(clean_hist)


def test_failure_while_a_checkpoint_is_written_restores_it(tmp_path,
                                                           monkeypatch):
    """A failure at step 3 while step 2's checkpoint is still being
    written (a writer slower than a step) waits for that writer and
    restores step 2: the run ends after 6 steps' worth of updates.  The
    reference's loop reads the latest finished checkpoint without waiting
    and, with none yet, restarts from scratch on the state it trained so
    far (its state then counts 9 updates)."""
    write = CheckpointManager._write

    def slow_write(self, *args):
        time.sleep(0.5)
        write(self, *args)

    monkeypatch.setattr(CheckpointManager, "_write", slow_write)

    def step(state, batch):
        return {"w": state["w"] + 1}, {"loss": torch.zeros(())}

    pipe = Pipeline(DataConfig(vocab=16, seq_len=4, global_batch=2))
    loop = ResilientLoop(step, CheckpointManager(tmp_path), pipe,
                         ckpt_every=2, injector=FailureInjector(at_steps={3}))
    state, hist = loop.run({"w": torch.zeros(())}, 6)
    assert [h["event"] for h in hist if "event" in h] == [
        "restored@2: injected failure at step 3"]
    assert float(state["w"]) == 6


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0)
    assert not mon.record(0, 1.0)
    assert not mon.record(1, 1.1)
    assert mon.record(2, 10.0)        # 10x slower than EMA -> flagged
    assert mon.slow_steps[0][0] == 2


def test_straggler_monitor_flags_consecutive_stragglers():
    """A flagged sample's EMA contribution is capped at the flag threshold,
    so the second of two back-to-back stragglers is flagged too."""
    mon = StragglerMonitor(factor=3.0)
    assert not mon.record(0, 1.0)           # ema = 1.0
    assert mon.record(1, 100.0)             # flagged; ema capped -> 1.4
    assert mon.record(2, 50.0)
    assert [s for s, _ in mon.slow_steps] == [1, 2]
    assert mon.ema < 5.0


def test_loop_matches_reference(tmp_path):
    """The port's loop and the reference's on the same carried weights,
    data seed and injector (failures at 6 and 10, checkpoints every 4, 12
    steps): the same events, restarts and history steps; losses at
    ``LOSS_RTOL``; the final parameters within 2 lr a step of the
    reference's, and the same count."""
    jcfg, cfg = j_smoke(ARCH), get_smoke_config(ARCH)
    jmodel = JModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    opt_cfg = dict(lr=PARITY_LR, warmup_steps=2, decay_steps=20)
    jraw = jax.jit(j_make_train_step(jmodel, JTrainHParams(
        optimizer=jadamw.AdamWConfig(**opt_cfg))))

    def jstep(state, batch):
        p, o, m = jraw(state["params"], state["opt"],
                       {k: jnp.asarray(v) for k, v in batch.items()})
        return {"params": p, "opt": o}, m

    jpipe = JPipeline(JDataConfig(vocab=jcfg.vocab, seq_len=32,
                                  global_batch=4, seed=3), model_cfg=jcfg)
    jloop = JResilientLoop(
        jstep, JManager(tmp_path / "ref", keep=3, async_save=False), jpipe,
        ckpt_every=4, injector=JFailureInjector(at_steps={6, 10}))
    jstate, jhist = jloop.run(
        {"params": jparams, "opt": jadamw.init_state(jparams)}, 12)

    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    step, pipe, ckpt, state = _setup(tmp_path, "port", params=params,
                                     lr=PARITY_LR)
    loop = ResilientLoop(step, ckpt, pipe, ckpt_every=4,
                         injector=FailureInjector(at_steps={6, 10}))
    state, hist = loop.run(state, 12)

    assert loop.restarts == jloop.restarts == 2
    assert [(h["step"], h.get("event")) for h in hist] == [
        (h["step"], h.get("event")) for h in jhist]
    for h, jh in zip(hist, jhist):
        if "loss" in h:
            assert float(h["loss"]) == pytest.approx(float(jh["loss"]),
                                                     rel=LOSS_RTOL)
    assert int(state["opt"]["count"]) == int(jstate["opt"]["count"]) == 12
    lr_sum = sum(float(h["lr"]) for h in hist if "lr" in h)
    want = dict(adamw.named_leaves(params_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jstate["params"]),
        cfg, "cpu")))
    for name, p in adamw.named_leaves(state["params"]):
        slack = 1e-6 * float(want[name].abs().max())
        assert float((p - want[name]).abs().max()) <= 2 * lr_sum + slack, name


# -- checkpoints of a ParamTree -----------------------------------------------

def _as_dict(tree):
    """A ParamTree as the nested dicts / lists of numpy arrays it was
    built from."""
    if isinstance(tree, ParamTree):
        return {k: _as_dict(tree[k]) for k in tree.keys()}
    if isinstance(tree, torch.nn.ModuleList):
        return [_as_dict(t) for t in tree]
    return tree.detach().numpy()


def test_param_tree_round_trip_with_reference_paths(tmp_path):
    """A ParamTree saves under the paths the reference's flattener gives
    the dict it was built from (``['blocks']/[0]/['mix']/['wq']``);
    ``restore`` rebuilds a ParamTree with the same keys and bits in new
    storage, and the reference's manager restores the directory into that
    dict."""
    params = Model(get_smoke_config(ARCH), "cpu").init(0)
    ckpt = CheckpointManager(tmp_path, keep=3, async_save=False)
    ckpt.save(7, params, extra={"data": {"index": 7}})
    ref_dict = _as_dict(params)
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json")
                          .read_text())
    paths = [e["path"] for e in manifest["leaves"]]
    want_paths, _, _ = j_flatten_with_paths(ref_dict)
    assert paths == want_paths
    assert "['blocks']/[0]/['mix']/['wq']" in paths
    assert manifest["extra"] == {"data": {"index": 7}}

    back, _ = ckpt.restore(7, like=params)
    assert isinstance(back, ParamTree) and back.keys() == params.keys()
    assert isinstance(back["blocks"], torch.nn.ModuleList)
    for (name, a), (name_b, b) in zip(adamw.named_leaves(back),
                                      adamw.named_leaves(params)):
        assert name == name_b and not a.requires_grad
        assert _same_bits(a, b) and a.data_ptr() != b.data_ptr()

    jback, _ = JManager(tmp_path).restore(7, like=ref_dict)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(ref_dict)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restore_into_keeps_storage_and_bits(tmp_path, dtype):
    """``restore_into`` writes a checkpoint into the live tree: after a
    train step changed every leaf, each parameter, moment and the count
    gets the saved bits back in its own storage; a leaf of another dtype
    or shape is refused."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype,
                              param_dtype=dtype)
    step, pipe, ckpt, state = _setup(tmp_path, dtype, cfg=cfg)
    state, _ = step(state, next(pipe))
    ckpt.save(1, state, extra={"data": {"index": pipe.index}})
    saved = [leaf.detach().clone() for leaf in tree_leaves(state)]
    state, _ = step(state, next(pipe))
    ptrs = [leaf.data_ptr() for leaf in tree_leaves(state)]
    assert not all(_same_bits(a, b) for a, b in zip(tree_leaves(state), saved))

    extra = ckpt.restore_into(1, state)
    assert extra == {"data": {"index": 1}}
    assert [leaf.data_ptr() for leaf in tree_leaves(state)] == ptrs
    for leaf, want in zip(tree_leaves(state), saved):
        assert _same_bits(leaf.detach(), want)
    assert state["params"]["embed"].dtype == getattr(torch, dtype)

    other = {"params": state["params"], "opt": dict(
        state["opt"], count=torch.zeros((), dtype=torch.int64))}
    with pytest.raises(ValueError, match="count"):
        ckpt.restore_into(1, other)


# -- launch/train.py ----------------------------------------------------------

def _main(tmp_path, run, *extra):
    argv = ["--arch", ARCH, "--smoke", "--mole", "token", "--device", "cpu",
            "--seq-len", "32", "--batch", "4", "--log-every", "1",
            "--ckpt-dir", str(tmp_path / run), *extra]
    return train.main(argv)


def test_train_main_failure_and_resume_equal_clean_run(tmp_path, capsys):
    """``--steps 8 --ckpt-every 4 --inject-failures 5`` and ``--steps 4``
    then ``--steps 8 --resume`` end with ``--steps 8``'s state bit for bit,
    and their losses from the restore on equal the clean run's."""
    clean, clean_hist = _main(tmp_path, "clean", "--steps", "8")
    faulty, hist = _main(tmp_path, "faulty", "--steps", "8",
                         "--ckpt-every", "4", "--inject-failures", "5")
    out = capsys.readouterr().out
    assert out.count("[FT]") == 1
    assert "  [FT] step 4: restored@4: injected failure at step 5" in out
    assert _losses(hist) == _losses(clean_hist)
    _assert_same_state(faulty, clean)

    _main(tmp_path, "cut", "--steps", "4")
    resumed, hist = _main(tmp_path, "cut", "--steps", "8", "--resume")
    assert "resumed from step 4" in capsys.readouterr().out
    assert sorted(_losses(hist)) == [4, 5, 6, 7]
    assert all(_losses(hist)[s] == _losses(clean_hist)[s] for s in range(4, 8))
    _assert_same_state(resumed, clean)
    assert int(resumed["opt"]["count"]) == 8


def _shape_of(out: str) -> list[str]:
    return [re.sub(r"-?\d+(\.\d+)?", "#", line) for line in out.splitlines()]


def test_train_main_prints_the_reference_format(tmp_path, capsys,
                                                monkeypatch):
    """The same flags through the reference's driver and the port's: the
    same lines with the numbers taken out, and the same header and
    fault-tolerance lines word for word.  The reference's loop reads the
    latest checkpoint at a failure without joining its asynchronous writer,
    so on a loaded machine it can restart clean where the step-2
    checkpoint is still being written (``ROADMAP.md``, Queue 3); its saves
    are joined here, so that both packages restore that checkpoint."""
    save = JManager.save

    def joined(self, *args, **kwargs):
        save(self, *args, **kwargs)
        self.wait()

    monkeypatch.setattr(JManager, "save", joined)
    argv = ["--arch", ARCH, "--smoke", "--mole", "token", "--seq-len", "32",
            "--batch", "4", "--steps", "6", "--ckpt-every", "2",
            "--inject-failures", "3", "--log-every", "2"]
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    want = capsys.readouterr().out
    train.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                       "--device", "cpu"])
    got = capsys.readouterr().out
    assert _shape_of(got) == _shape_of(want)
    keep = [line for line in want.splitlines()
            if line.startswith(("arch=", "  [FT]"))]
    assert keep and keep == [line for line in got.splitlines()
                             if line.startswith(("arch=", "  [FT]"))]


def test_train_main_gemma2_runs_as_the_reference_driver(tmp_path, capsys):
    """``launch/train.py --arch gemma2_27b --smoke`` (local/global layers,
    window 8, sequences of 32 so every local layer's window slides) through
    the reference's driver and the port's: the same header (the parameter
    count included) word for word, the same lines with the numbers taken
    out, and finite losses.  No failure is injected: whether the
    reference's asynchronous checkpoint is written before the failure
    depends on the machine's load (its fault-tolerance lines are held on
    phi3 by ``test_train_main_prints_the_reference_format``)."""
    argv = ["--arch", "gemma2_27b", "--smoke", "--mole", "token",
            "--seq-len", "32", "--batch", "4", "--steps", "4",
            "--ckpt-every", "2", "--log-every", "1"]
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    want = capsys.readouterr().out
    _, hist = train.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got = capsys.readouterr().out
    assert _shape_of(got) == _shape_of(want)
    keep = [line for line in want.splitlines() if line.startswith("arch=")]
    assert len(keep) == 1 and keep == [
        line for line in got.splitlines() if line.startswith("arch=")]
    assert sorted(_losses(hist)) == [0, 1, 2, 3]
    assert all(np.isfinite(float(v)) for v in _losses(hist).values())


def test_train_main_recurrentgemma_runs_as_the_reference_driver(
        tmp_path, capsys, monkeypatch):
    """``launch/train.py --arch recurrentgemma_2b --smoke`` (RG-LRU and
    local layers, window 8, sequences of 32 so every local window slides;
    tied and scaled embeddings) through the reference's driver and the
    port's, with a failure injected at step 3 after the checkpoint of step
    2: the same header (the parameter count included) and fault-tolerance
    lines word for word, the same lines with the numbers taken out, and
    finite losses.  The reference's saves are joined, as in
    ``test_train_main_prints_the_reference_format``, so that both packages
    restore the step-2 checkpoint."""
    save = JManager.save

    def joined(self, *args, **kwargs):
        save(self, *args, **kwargs)
        self.wait()

    monkeypatch.setattr(JManager, "save", joined)
    argv = ["--arch", "recurrentgemma_2b", "--smoke", "--mole", "token",
            "--seq-len", "32", "--batch", "4", "--steps", "5",
            "--ckpt-every", "2", "--inject-failures", "3", "--log-every", "1"]
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    want = capsys.readouterr().out
    _, hist = train.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got = capsys.readouterr().out
    assert _shape_of(got) == _shape_of(want)
    keep = [line for line in want.splitlines()
            if line.startswith(("arch=", "  [FT]"))]
    assert len(keep) == 2 and keep == [
        line for line in got.splitlines()
        if line.startswith(("arch=", "  [FT]"))]
    assert sorted(_losses(hist)) == [0, 1, 2, 3, 4]
    assert all(np.isfinite(float(v)) for v in _losses(hist).values())


def test_train_main_recurrentgemma_resume_equals_clean_run(tmp_path, capsys):
    """The hybrid through the port's driver: ``--steps 4`` then ``--steps
    6 --resume`` ends with ``--steps 6``'s parameters, moments and count
    bit for bit (``--warmup 4`` so the cut run follows the same learning
    rates), its losses from the restore on equal the clean run's."""
    flags = ["--arch", "recurrentgemma_2b", "--smoke", "--mole", "token",
             "--device", "cpu", "--seq-len", "32", "--batch", "4",
             "--warmup", "4", "--ckpt-every", "2", "--log-every", "1"]
    clean, clean_hist = train.main(flags + ["--steps", "6", "--ckpt-dir",
                                            str(tmp_path / "clean")])
    train.main(flags + ["--steps", "4", "--ckpt-dir", str(tmp_path / "cut")])
    resumed, hist = train.main(flags + ["--steps", "6", "--resume",
                                        "--ckpt-dir", str(tmp_path / "cut")])
    assert "resumed from step 4" in capsys.readouterr().out
    assert sorted(_losses(hist)) == [4, 5]
    assert all(_losses(hist)[s] == _losses(clean_hist)[s] for s in (4, 5))
    _assert_same_state(resumed, clean)
    assert int(resumed["opt"]["count"]) == 6


def test_train_main_rwkv_runs_as_the_reference_train_main(tmp_path, capsys,
                                                      monkeypatch):
    """``launch/train.py --arch rwkv6_3b --smoke`` (the time-mix scan's
    gradient through ``wkv6_scan``; sequences of 30, which pad to the
    chunk of 4) through the reference's ``main`` and the port's, with a
    failure injected at step 3 after the checkpoint of step 2: the same
    header (the parameter count included) and fault-tolerance lines word
    for word, the same lines with the numbers taken out, and finite
    losses.  The reference's saves are joined, as in
    ``test_train_main_prints_the_reference_format``, so that both packages
    restore the step-2 checkpoint."""
    save = JManager.save

    def joined(self, *args, **kwargs):
        save(self, *args, **kwargs)
        self.wait()

    monkeypatch.setattr(JManager, "save", joined)
    argv = ["--arch", "rwkv6_3b", "--smoke", "--mole", "token",
            "--seq-len", "30", "--batch", "4", "--steps", "5",
            "--ckpt-every", "2", "--inject-failures", "3", "--log-every", "1"]
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    want = capsys.readouterr().out
    _, hist = train.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got = capsys.readouterr().out
    assert _shape_of(got) == _shape_of(want)
    keep = [line for line in want.splitlines()
            if line.startswith(("arch=", "  [FT]"))]
    assert len(keep) == 2 and keep == [
        line for line in got.splitlines()
        if line.startswith(("arch=", "  [FT]"))]
    assert sorted(_losses(hist)) == [0, 1, 2, 3, 4]
    assert all(np.isfinite(float(v)) for v in _losses(hist).values())


@pytest.mark.parametrize("extra,error,match", [
    (["--arch", "rwkv6_3b", "--mole", "embedding"], ValueError,
     "needs a frontend"),
    (["--arch", "deepseek_7b", "--mole", "embedding"], ValueError,
     "needs a frontend"),
    (["--arch", "no_such_arch"], NotImplementedError, "not ported"),
], ids=["rwkv6_3b", "mole_embedding", "unported_arch"])
def test_train_main_refuses_what_the_port_does_not_train(tmp_path, extra,
                                                          error, match):
    """Embedding-mode MoLe on a model without a frontend (nothing to morph;
    the reference asserts), RWKV-6's and an attention LM's, and a name
    outside the registry.  RWKV-6 itself trains
    (``test_train_main_rwkv_runs_as_the_reference_train_main``)."""
    with pytest.raises(error, match=match):
        train.main(["--smoke", "--device", "cpu", "--steps", "1",
                    "--ckpt-dir", str(tmp_path), *extra])


# -- optim/compress.py: tests/test_optim.py on the port -----------------------

def test_int8_quantization_roundtrip(rng):
    x = torch.from_numpy(rng.standard_normal((64,)).astype(np.float32))
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.51 + 1e-6


def test_error_feedback_preserves_signal(rng):
    """Sum of compressed grads + final residual == sum of raw grads."""
    grads = [
        {"w": torch.from_numpy(rng.standard_normal((16,)).astype(np.float32))
         * 10 ** (i - 2)}
        for i in range(5)
    ]
    res = ErrorFeedback.init(grads[0])
    total_compressed = torch.zeros(16)
    for g in grads:
        cg, res = ErrorFeedback.compress(g, res)
        total_compressed += cg["w"]
    total_raw = sum(g["w"] for g in grads)
    np.testing.assert_allclose((total_compressed + res["w"]).numpy(),
                               total_raw.numpy(), rtol=1e-4, atol=1e-4)


def test_error_feedback_matches_reference(rng):
    """Three rounds on a flat dict of an fp32 and a bf16 leaf: the
    decompressed gradients and residuals equal the reference's bit for
    bit."""
    shapes = {"a": (5, 3), "b": (7,)}
    res, jres = None, None
    for _ in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32) * 3
             for k, s in shapes.items()}
        tg = {"a": torch.from_numpy(g["a"]),
              "b": torch.from_numpy(g["b"]).to(torch.bfloat16)}
        jg = {"a": jnp.asarray(g["a"]), "b": jnp.asarray(g["b"], jnp.bfloat16)}
        res = res or ErrorFeedback.init(tg)
        jres = jres or jcompress.ErrorFeedback.init(jg)
        out, res = ErrorFeedback.compress(tg, res)
        jout, jres = jcompress.ErrorFeedback.compress(jg, jres)
        for k in shapes:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
            np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]))


@settings(max_examples=40, deadline=None)
@given(
    shape=st.lists(st.integers(1, 9), min_size=1, max_size=3),
    log_scale=st.integers(-30, 30),
    seed=st.integers(0, 2**31 - 1),
    dtype=st.sampled_from(["float32", "bfloat16"]),
)
def test_quantize_int8_equals_reference(shape, log_scale, seed, dtype):
    """Codes and scale bit for bit against the reference's over shapes,
    magnitudes from 1e-30 to 1e30, fp32 and bf16 inputs, and ties at .5
    (every other draw is rounded to a multiple of scale / 2)."""
    g = np.random.default_rng(seed)
    x = (g.standard_normal(shape) * 10.0 ** log_scale).astype(np.float32)
    if seed % 2:
        step = np.abs(x).max() / 127 / 2
        x = (np.round(x / step) * step).astype(np.float32)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        tx, jx = tx.to(torch.bfloat16), jx.astype(jnp.bfloat16)
    q, s = quantize_int8(tx)
    jq, js = jcompress.quantize_int8(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(),
                                  np.asarray(jcompress.dequantize_int8(jq, js)))
