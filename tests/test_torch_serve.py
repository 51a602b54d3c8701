"""The port's serve launcher (``python -m repro_torch.launch.serve --mode
delivery``) on the CPU, beside the reference launcher on the same flags:
the same report lines, the same microbatches and padding, and engine
features within 1e-5 of per-request delivery."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

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
def test_unported_modes_raise(argv):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tserve.main(["--device", "cpu", *argv])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--tenants", "1", "--requests", "1", "--channels", "1",
                     "--out-channels", "2", "--image-size", "4"])
