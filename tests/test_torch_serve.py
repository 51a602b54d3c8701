"""The port's serve launcher (``python -m repro_torch.launch.serve``) on
the CPU, beside the reference launcher on the same flags: ``--mode
delivery`` with the same report lines, the same microbatches and padding,
and engine features within 1e-5 of per-request delivery; ``--async`` for
``--mode delivery`` and ``--mode lm`` (deepseek_7b and rwkv6_3b smoke, the
generations held as ``tests/test_torch_rwkv_lm.py`` holds the lane's); and
the reference's mode gating of every flag."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.api import Model as JModel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from test_torch_rwkv_lm import _hold_lane  # noqa: E402

FLAGS = ["--tenants", "3", "--requests", "12", "--batch", "2", "--kappa", "2",
         "--channels", "2", "--out-channels", "4", "--image-size", "6",
         "--weights", "2,1", "--priority", "0,1"]
REPORT = re.compile(
    r"engine: +[\d.]+ images/s \((\d+) microbatches, padding (\d+)%\)"
)


def test_delivery_mode_matches_reference_launcher(capsys):
    out = tserve.main(["--device", "cpu", "--stats", *FLAGS])
    port = capsys.readouterr().out
    assert out["max_err"] < 1e-5
    assert out["images_per_s_engine"] > 0 and out["images_per_s_per_request"] > 0
    assert port.startswith(
        "delivery tenants=3 requests=12 batch=2 kappa=2 device=cpu async=False"
    )
    for line in ("  per-request:", "  speedup:", "engine stats:",
                 "flush   device:"):
        assert line in port
    jserve.main(["--mode", "delivery", "--backend", "jnp", *FLAGS])
    ref = capsys.readouterr().out
    assert REPORT.search(port).groups() == REPORT.search(ref).groups()


@pytest.mark.parametrize("argv", [
    ["--async"], ["--mode", "lm", "--async"], ["--mode", "serve"],
])
def test_unported_modes_raise(argv, monkeypatch):
    """The modes that raised NotImplementedError before the async slice are
    ported: without --device they go to the card and, with none, raise as
    every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--tenants", "1", "--requests", "1", *argv])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--tenants", "1", "--requests", "1", "--channels", "1",
                     "--out-channels", "2", "--image-size", "4"])


def test_async_delivery_mode_matches_per_request(capsys, tmp_path):
    """``--async`` delivery, through a snapshot directory and an injected
    device-phase crash: features within 1e-5 of per-request delivery, and
    the reference launcher's async report lines."""
    flags = [*FLAGS, "--async", "--max-delay-ms", "2",
             "--inject-failure", "device"]
    out = tserve.main(["--device", "cpu",
                       "--snapshot-dir", str(tmp_path / "port"), *flags])
    port = capsys.readouterr().out
    assert out["max_err"] < 1e-5
    assert out["p50_ms"] == out["p50_ms"] and out["p95_ms"] >= out["p50_ms"]
    jserve.main(["--mode", "delivery", "--backend", "jnp",
                 "--snapshot-dir", str(tmp_path / "ref"), *flags])
    ref = capsys.readouterr().out
    for text in (port, ref):
        assert "async=True" in text
        assert re.search(r"latency: +p50= *[\d.]+ms p95= *[\d.]+ms "
                         r"\(SLO max_delay=2.0ms, \d+ flushes\)", text)
        assert re.search(r"resilience: +snapshots=[1-9]\d* "
                         r"degraded_flushes=\d+ injected=device", text)


def _lm_async(arch, capsys, extra):
    flags = ["--mode", "lm", "--arch", arch, "--smoke", "--requests", "4",
             "--tenants", "2", "--prompt-len", "9", "--gen", "5", "--async",
             "--max-delay-ms", "2", *extra]
    want = jserve.main([*flags, "--backend", "jnp"])
    ref_out = capsys.readouterr().out
    jcfg = j_smoke(arch)
    jparams = JModel(jcfg).init(jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             get_smoke_config(arch), device="cpu")
    got = tserve.run_lm(tserve.parse_args([*flags, "--device", "cpu"]),
                        params=params)
    port_out = capsys.readouterr().out
    prompts = SyntheticLM(DataConfig(vocab=jcfg.vocab, seq_len=9,
                                     global_batch=4, seed=0)).batch(0)["tokens"]
    _hold_lane(jparams, jcfg, np.asarray(prompts), got, np.asarray(want))
    for text in (ref_out, port_out):
        assert re.search(r"async=True, p50=[\d.]+ms p95=[\d.]+ms\)", text)


@pytest.mark.parametrize("arch,extra", [
    ("deepseek_7b", ["--admission", "reject"]),
    ("rwkv6_3b", ["--deadline-ms", "20"]),
])
def test_async_lm_mode_matches_reference(capsys, arch, extra):
    """``--mode lm --async`` at the smoke configs with the reference's
    weights: the prompts morph through the async front door and the
    generations hold against the reference launcher's."""
    _lm_async(arch, capsys, extra)


@pytest.mark.parametrize("argv,message", [
    (["--mode", "serve", "--async"], "--async only applies"),
    (["--mode", "serve", "--priority", "1"], "--priority only applies"),
    (["--mode", "serve", "--admission", "block"], "--admission only applies"),
    (["--port", "1"], "--port only applies"),
    (["--mode", "lm", "--batch", "2"], "--batch only applies"),
    (["--deadline-ms", "5"], "--deadline-ms requires --async"),
    (["--snapshot-dir", "x"], "--snapshot-dir requires --async"),
    (["--inject-failure", "device"], "--inject-failure requires --async"),
    (["--prefetch-horizon-ms", "5"], "--prefetch-horizon-ms requires --async"),
    (["--mode", "serve", "--chaos-rate", "0.5"], "require --chaos"),
    (["--mode", "lm", "--mole", "off", "--async"], "--mole off"),
])
def test_mode_gating_matches_reference(capsys, argv, message):
    """A flag outside its mode, or one that needs --async without it, is an
    error in both launchers."""
    for main in (tserve.main, jserve.main):
        with pytest.raises(SystemExit):
            main(argv)
        assert message in capsys.readouterr().err


def test_serve_defaults_match_reference():
    args = tserve.parse_args(["--mode", "serve"])
    assert (args.host, args.port, args.max_pending_rows, args.read_timeout_ms,
            args.write_timeout_ms, args.drain_timeout_ms, args.warm_batch,
            args.chaos, args.chaos_rate, args.chaos_seed, args.admission,
            args.max_delay_ms, args.max_inflight_rows) == (
        "127.0.0.1", 0, 4096, 30000.0, 10000.0, 30000.0, 8, False, 0.2, 0,
        "block", 5.0, 4096)
