"""The port's front doors as processes, on the CPU: ``python -m
repro_torch.launch.serve --mode serve --device cpu`` under SIGTERM with a
live backlog (graceful drain, snapshot, restart on the same id space),
``python -m repro_torch.launch.client --spawn-server``, and a delivery
engine process killed with SIGKILL after persisting a snapshot, restored by
a second process.  Each subprocess runs at a small width under its own
timeout; these are the port's counterparts of the reference's slow process
tests (``tests/test_serve_net.py``, ``tests/test_engine_resilience.py``).
"""
import asyncio
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.launch import client  # noqa: E402
from repro_torch.launch.client import (  # noqa: E402
    FleetConfig, run_fleet, spawn_server, stop_server,
)

SRC = str(Path(__file__).resolve().parents[1] / "src")
ALPHA, BETA, M = 2, 4, 6
SERVER_FLAGS = ["--tenants", "3", "--kappa", "2", "--channels", str(ALPHA),
                "--out-channels", str(BETA), "--image-size", str(M),
                "--warm-batch", "2"]


@pytest.fixture
def src_path(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", SRC)


@pytest.fixture
def servers():
    """Spawned servers, killed at teardown if a test left one running."""
    procs = []
    yield procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def test_sigterm_drain_snapshot_restart_exactly_once(tmp_path, src_path,
                                                     servers):
    """SIGTERM a served engine with a live backlog: it drains (every
    accepted rid answered), persists a snapshot and exits 0; a restart
    restores the snapshot and resumes the same id space — across both runs
    no rid is lost and no engine id repeats."""
    flags = [*SERVER_FLAGS, "--snapshot-dir", str(tmp_path / "snap")]
    proc, port = spawn_server(flags, device="cpu", timeout=120.0)
    servers.append(proc)
    cfg = FleetConfig(port=port, requests=14, clients=3, tenants=3, batch=2,
                      channels=ALPHA, image_size=M, trace="uniform:40",
                      timeout_ms=6000.0, max_attempts=3)
    box = {}
    t = threading.Thread(
        target=lambda: box.update(report=asyncio.run(run_fleet(cfg))))
    t.start()
    time.sleep(0.15)              # SIGTERM mid-run: some requests in flight
    rc = stop_server(proc, timeout=90.0)
    t.join(timeout=120.0)
    assert not t.is_alive()
    out = proc.stdout.read()
    assert rc == 0, out
    assert "drained: lost_rids=0" in out
    r1 = box["report"]
    r1.assert_exactly_once()
    c1 = r1.counts()
    assert c1.get("ok", 0) >= 1 and sum(c1.values()) == 14
    assert [p for p in os.listdir(tmp_path / "snap") if not p.endswith(".tmp")]

    proc, port = spawn_server(flags, device="cpu", timeout=120.0)
    servers.append(proc)
    cfg2 = FleetConfig(port=port, requests=6, clients=2, tenants=3, batch=2,
                       channels=ALPHA, image_size=M, trace="uniform:200",
                       fleet_id="f1")
    r2 = asyncio.run(run_fleet(cfg2))
    rc = stop_server(proc, timeout=90.0)
    out = proc.stdout.read()
    assert rc == 0, out
    r2.assert_exactly_once()
    assert r2.counts() == {"ok": 6}
    assert min(r2.engine_rids.values()) > max(r1.engine_rids.values())


def test_client_spawn_server_main(tmp_path, src_path, capsys):
    """``client --spawn-server --device cpu``: the fleet against a spawned
    server, the server's clean drain, and the JSON report."""
    report_path = tmp_path / "fleet.json"
    report = client.main([
        "--spawn-server", "--device", "cpu", "--requests", "12",
        "--clients", "3", "--tenants", "3", "--batch", "2",
        "--channels", str(ALPHA), "--image-size", str(M),
        "--server-args", " ".join([*SERVER_FLAGS, "--stats"]),
        "--report", str(report_path),
    ])
    out = capsys.readouterr().out
    assert report.counts() == {"ok": 12}
    assert "drained: lost_rids=0" in out and "security budget" in out
    assert json.loads(report_path.read_text())["counts"] == {"ok": 12}
    with pytest.raises(SystemExit):
        client.main(["--device", "cpu", "--port", "1"])


_COMMON = """
import numpy as np
import torch
from repro_torch.core import ConvGeometry, SessionRegistry
from repro_torch.runtime import DeliveryRequest, EngineSnapshot, MoLeDeliveryEngine
from repro_torch.checkpoint import CheckpointManager

GEOM = ConvGeometry(alpha=2, beta=4, m=6, p=3)
rng = np.random.default_rng(5)           # same seed both sides: same
reg = SessionRegistry(GEOM, kappa=2)     # secrets, same payloads
for i in range(3):
    reg.register(f"t{i}", rng.standard_normal(
        (GEOM.alpha, GEOM.beta, GEOM.p, GEOM.p)
    ).astype(np.float32) / np.sqrt(18), seed=40 + i)
reqs = [(f"t{r % 3}", rng.standard_normal((2, 2, 6, 6)).astype(np.float32))
        for r in range(6)]
"""

_CRASH = _COMMON + """
import os, signal
eng = MoLeDeliveryEngine(reg, "cpu")
for t, d in reqs[:3]:                    # flushed but never taken
    eng.submit(DeliveryRequest(t, d))
eng.flush()
for t, d in reqs[3:]:                    # still queued at crash time
    eng.submit(DeliveryRequest(t, d))
eng.snapshot().save(CheckpointManager(SNAPDIR, async_save=False), 1)
os.kill(os.getpid(), signal.SIGKILL)     # no atexit, no cleanup: a crash
"""

_RESTORE = _COMMON + """
import json
eng = MoLeDeliveryEngine(reg, "cpu")
pending = eng.restore(EngineSnapshot.load(CheckpointManager(SNAPDIR)))
eng.flush()
ok = True
for rid, (t, d) in enumerate(reqs):
    want = reg.session(t).deliver(torch.from_numpy(d)).numpy()
    ok = ok and float(np.abs(eng.take(rid) - want).max()) <= 1e-5
    try:
        eng.take(rid)
        ok = False                        # duplicate redemption
    except KeyError:
        pass
print(json.dumps({"ok": ok, "replayed": len(pending)}))
"""


def test_sigkill_mid_backlog_then_restore(tmp_path):
    """A process dies by SIGKILL mid-backlog after persisting a snapshot; a
    second process restores from disk and delivers every request exactly
    once."""
    env = dict(os.environ, PYTHONPATH=SRC)

    def run(code):
        return subprocess.run(
            [sys.executable, "-c",
             f"SNAPDIR = {str(tmp_path / 'snaps')!r}\n" + textwrap.dedent(code)],
            capture_output=True, text=True, timeout=300, env=env,
        )

    crashed = run(_CRASH)
    assert crashed.returncode == -signal.SIGKILL, crashed.stderr
    restored = run(_RESTORE)
    assert restored.returncode == 0, restored.stderr
    verdict = json.loads(restored.stdout.strip().splitlines()[-1])
    assert verdict == {"ok": True, "replayed": 3}
