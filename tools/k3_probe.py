"""Times K3 (``src/repro_torch/kernels/csrc/row_gemm.cu``) on one card,
beside ``chip_smoke.py``'s gates; prints one JSON line a case, none gated.

    PYTHONPATH=<checkout>/src python3 tools/k3_probe.py

K3 through the wrapper (``kernels.grouped_row_gemm``) of the
``repro_torch`` on the path, at the decode lane's two shapes, deepseek_7b's
h (4, 4096) x tables (4, 4096, 102400) and phi3_mini_3p8b's h (4, 3072) x
tables (4, 3072, 32064), bf16 h on 4 distinct slots (gidx = arange(4)), on
fp32 tables and on the same tables cast to bf16 (where the wrapper on the
path takes them: a wrapper that takes only fp32 tables raises TypeError,
printed as ``refused``).  Timers are ``chip_smoke.py``'s: ``graph_ms``
(device time, CUDA graphs of 10 calls, p50 of 5 replays) and ``cuda_ms``
(10 calls back to back), each taken twice in turns; ``torch.bmm`` on the
same tables beside them.  Run it on two checkouts in one call (parent,
change, change, parent) to compare them on one card; each run prints its
checkout's path and a checksum of K3's output, which agrees across trees
to rounding (the sums may run in another order, so it is printed, not
compared).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

SHAPES = {"deepseek_7b": (4, 4096, 102400), "phi3_mini_3p8b": (4, 3072, 32064)}


def probe_time(dev, gen) -> None:
    import repro_torch
    from repro_torch import kernels

    for arch, (R, K, N) in SHAPES.items():
        ident = torch.arange(R, dtype=torch.int32, device=dev)
        t32 = torch.randn((R, K, N), generator=gen, device=dev) * K ** -0.5
        h = torch.randn((R, K), generator=gen, device=dev).to(torch.bfloat16)
        for t_dtype in (torch.float32, torch.bfloat16):
            tables = t32.to(t_dtype)
            tname = str(t_dtype).split(".")[-1]
            row = {"probe": "k3", "checkout": str(Path(repro_torch.__file__)
                                                  .resolve().parents[2]),
                   "arch": arch, "shape": [R, K, N], "tables": tname}
            try:
                out = kernels.grouped_row_gemm(h, ident, tables)
            except TypeError as exc:
                print(json.dumps(dict(row, refused=str(exc))), flush=True)
                continue

            def run():
                return kernels.grouped_row_gemm(h, ident, tables)

            hb = h if t_dtype == torch.bfloat16 else h.float()

            def bmm():
                return torch.bmm(hb[:, None, :], tables)

            b, by = cs.k3_bound(R, K, N, h.dtype, t_dtype)
            g = [cs.graph_ms(run, 5, 10), cs.graph_ms(run, 5, 10)]
            e = [cs.cuda_ms(run, 10), cs.cuda_ms(run, 10)]
            print(json.dumps(dict(
                row, graph_ms=g, cuda_ms=e, bound_ms=b, bound_by=by,
                over_bound=min(g) / b, library_graph_ms=cs.graph_ms(bmm, 5, 10),
                library_cuda_ms=cs.cuda_ms(bmm, 10),
                checksum=float(out.double().sum()))), flush=True)
            del tables, out
        del t32
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("k3_probe: needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    probe_time(dev, gen)


if __name__ == "__main__":
    main()
