"""The repo's static analysis (``repro.analysis``: secret-flow taint, lock
discipline, jit stability) over the port's package, ``src/repro_torch``:
no live finding and no broken annotation.  The sharding modules and the
engine's mesh path are in its reach: a replication of tenant secrets onto
the ranks of a mesh that reached a sink would be a finding."""
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro.analysis import PASSES, run_paths  # noqa: E402


def test_analysis_finds_nothing_in_the_port():
    root = Path(repro_torch.__file__).parent
    active, declassified, errors = run_paths([root])
    print(f"{len(PASSES)} pass(es): {len(active)} finding(s), "
          f"{len(declassified)} declassified, {len(errors)} error(s)")
    assert not errors, [f.render() for f in errors]
    assert not active, [f.render() for f in active]
    # each declassification is an audited, written-down flow
    assert all(f.declassified.strip() for f in declassified)
    assert {Path(f.path).name for f in declassified} <= {
        "lm.py", "protocol.py", "decode.py", "engine.py"}
