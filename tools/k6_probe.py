"""Probes of K6 (``src/repro_torch/kernels/csrc/wkv6.cu``) on one card,
beside ``chip_smoke.py``'s gates.  Each prints JSON lines; none is gated.
K6's inputs are ``chip_smoke.py``'s (D 64, chunk 128, its seed), and its
timers are ``chip_smoke.py``'s: ``graph_ms`` (device time, CUDA graphs of 10
calls) and ``cuda_p50`` (10 calls back to back, the host's time included).

    PYTHONPATH=<checkout>/src python3 tools/k6_probe.py time
        K6 through the wrapper of the ``repro_torch`` on the path, at
        (BH, T) = (40, 384), (40, 1024), (160, 128) and (80, 4096), both
        ways; on a checkout with the time-chunked form also each form
        through the binding (the columns form at the width rule's C, the
        chunked form at every L of ``gemm.SCAN_CHUNKS``), held to the token
        recurrence, graph-timed in turns: the measurements behind
        ``gemm.scan_form``.  Run it on two checkouts in one call (parent,
        change, change, parent) to compare them.
    PYTHONPATH=src python3 tools/k6_probe.py variants
        Copies of this checkout's wkv6.cu, each built with nvcc and called
        through its C entry on the same inputs, held to the repo's kernel
        within 1e-4 * max|out|, device times in turns with it: the other
        splits (G, CPT) = (8, 2) and (16, 2) at D = 64 at every block width
        they take; and the consumer loop with software-pipelined operand
        loads (token t + 1's shared-memory loads issued before token t's
        arithmetic).
    PYTHONPATH=src python3 tools/k6_probe.py profile
        The form ``gemm.scan_form`` takes at (40, 384) and at (80, 4096),
        from a copy of wkv6.cu whose blocks stamp ``%globaltimer``.  The
        columns form: per tile (thread 0 for the consumers, producer thread
        0 for the producers), at the rule's width and at 16 and 32 columns,
        the consumers' wait for a prepared slot, the producers' preparation
        and the consumers' recurrence, in ns.  The time-chunked form: per
        block, its local pass, its wait for the previous chunk's state and
        its state step, and its correction, in ns.
    PYTHONPATH=src python3 tools/k6_probe.py chunk_variants
        Copies of wkv6.cu with the time-chunked form's compile-time knobs
        changed (``CHUNK_VARIANTS``: the split G, CPT of a block's 64
        columns, ring slots, producer warps, resident blocks), held to the
        token recurrence at (80, 4096) and graph-timed at L 64, 128 and 256
        beside the repo's kernel at the rule's L.
    PYTHONPATH=src python3 tools/k6_probe.py rows time [OLD_WKV6_ROWS_CU]
        The key-row scan of K6's gradient (``csrc/wkv6_rows.cu``) at
        rwkv_train's (80, 4096, 64) and at head size 16's (80, 4096, 16)
        and (7, 70, 16): through its wrapper and, given the source of the
        token recurrence it replaced (a ``wkv6_rows.cu`` from before the
        chunked form, e.g. unpacked from that commit by ``git archive``),
        that kernel through its C entry; each held to ``ref.wkv6_rows_ref`` within
        1e-4 * max, then graph-timed in turns (in order, then in reverse).
    PYTHONPATH=src python3 tools/k6_probe.py rows variants
        Copies of wkv6_rows.cu with its compile-time knobs changed
        (``ROWS_VARIANTS``: the split G, RPT of ``RowSplit<64>``, the chunk
        length L, tokens a tile, ring slots, producer warps, resident
        blocks), each in a process of its own, held to the plain version at
        (80, 4096, 64) and graph-timed in turns with the repo's kernel.
    PYTHONPATH=src python3 tools/k6_probe.py rows profile
        The key-row scan at (80, 4096, 64) in chunks of the repo's L and of
        128, from copies of wkv6_rows.cu whose blocks stamp
        ``%globaltimer`` (consumer thread 0) after taking their ticket,
        after the local pass, after the chain (the wait for the previous
        chunk's state and the state step) and at the end: per block each
        phase in ns, and the kernel's span.

Every ``rows`` reading prints the card's name and power limit.  Builds go
to ``build/probe/`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "probe"
D = 64
# The prefill's shape, a longer prompt, the short-sequence sweep's widest
# case and rwkv_train's microbatch (BH, T).
TIME_SHAPES = ((40, 384), (40, 1024), (160, 128), (80, 4096))
SPLIT_64 = "template <> struct Split<64> { static constexpr int G = 16, CPT = 4; };"

# The consumer loop's per-token body, and the same with token t + 1's
# operands fetched into registers before token t's arithmetic.
_BODY_START = "            unroll<G>([&](auto tt_) {"
_BODY_END = "            // Butterfly over the column group's G lanes"
_PIPELINED = '''            float4 cr[Q], ck[Q], cw[Q];
            float cv[CPT];
            auto fetch = [&](int t, float4 (&fr)[Q], float4 (&fk)[Q],
                             float4 (&fw)[Q], float (&fv)[CPT]) {
                const float* const row = rs + t * D;
                load_n<CPT>(row + 3 * TF + j, fv);
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                    const int o = 4 * (q * G + g);
                    fr[q] = ld4(row + o); fk[q] = ld4(row + TF + o);
                    fw[q] = ld4(row + 2 * TF + o);
                }
            };
            fetch(t0, cr, ck, cw, cv);
            unroll<G>([&](auto tt_) {
                constexpr int tt = decltype(tt_)::value;
                float4 nr[Q], nk[Q], nw[Q];
                float nv[CPT];
                if constexpr (tt + 1 < G) fetch(t0 + tt + 1, nr, nk, nw, nv);
#pragma unroll
                for (int x = 0; x < CPT; ++x) p[tt][x] = 0.0f;
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                    const float re[4] = {cr[q].x, cr[q].y, cr[q].z, cr[q].w};
                    const float ke[4] = {ck[q].x, ck[q].y, ck[q].z, ck[q].w};
                    const float we[4] = {cw[q].x, cw[q].y, cw[q].z, cw[q].w};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
#pragma unroll
                        for (int x = 0; x < CPT; ++x) {
                            float& st = S[4 * q + e][x];
                            p[tt][x] = fmaf(re[e], st, p[tt][x]);
                            st = fmaf(we[e], st, ke[e] * cv[x]);
                        }
                }
                if constexpr (tt + 1 < G) {
#pragma unroll
                    for (int q = 0; q < Q; ++q) { cr[q] = nr[q]; ck[q] = nk[q]; cw[q] = nw[q]; }
#pragma unroll
                    for (int x = 0; x < CPT; ++x) cv[x] = nv[x];
                }
            });
'''


def scan_ops(dev, BH, T):
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 6)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = randn(BH, T, D), randn(BH, T, D), randn(BH, T, D)
    return r, k, v, -torch.exp(randn(BH, T, D)), randn(BH, D), randn(BH, D, D) * 0.1


def patched(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"anchor not found once in wkv6.cu: {old[:60]!r}")
    return src.replace(old, new)


def build_copies(sources: dict[str, str]) -> dict[str, tuple]:
    """Each source into build/probe/, one nvcc each, all started together;
    returns {tag: (library, ptxas register/spill lines)}."""
    from repro_torch.kernels import build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, src in sources.items():
        cu = OUT / f"wkv6_{tag}.cu"
        cu.write_text(src)
        procs[tag] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        libs[tag] = (ctypes.CDLL(str(OUT / f"wkv6_{tag}.so")),
                     [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln])
    return libs


def entry(lib):
    from repro_torch.kernels import gemm

    fn = lib.wkv6_chunked
    fn.argtypes = gemm._ENTRIES["wkv6_chunked"][1]
    return fn


def caller(fn, ops, width):
    """A call of the C entry ``fn`` on ``ops`` into fixed outputs; the
    stream is read at each call, so that a graph captures it."""
    BH, T, _ = ops[0].shape
    out, s_out = torch.empty_like(ops[0]), torch.empty_like(ops[5])
    ptrs = [a.data_ptr() for a in ops] + [out.data_ptr(), s_out.data_ptr()]

    def run():
        err = fn(*ptrs, BH, T, D, width, ops[0].device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wkv6_chunked refused width {width}: {err}")
        return out, s_out
    return run


def widths(G, CPT):
    return [c for c in range(CPT, D + 1, CPT) if c // CPT * G % 32 == 0
            and c // CPT * G <= 256]


def held_to_recurrence(got, ops, tag):
    """out and s_final within chip_smoke.REL_TOL of max|token recurrence|."""
    from repro_torch.kernels import ref

    r, k, v, logw, u, s0 = ops
    want = ref.wkv6_ref(r[None], k[None], v[None], logw[None], u, s0[None])
    for g, w in zip(got, (want[0][0], want[1][0])):
        err = float((g - w).abs().max())
        if not err <= cs.REL_TOL * float(w.abs().max()):
            raise RuntimeError(f"{tag}: |kernel - recurrence| {err}")


def probe_time(dev):
    """K6 through the wrapper at each TIME_SHAPES shape; on a checkout with
    the time-chunked form, also each form through the binding (the columns
    form at the width rule's C, the chunked form at every L), held to the
    token recurrence and graph-timed in turns with the wrapper."""
    import repro_torch
    from repro_torch.kernels import build, gemm, wkv6_chunked

    build.build_all()
    forms = hasattr(gemm, "scan_form")
    for BH, T in TIME_SHAPES:
        ops = scan_ops(dev, BH, T)
        run = lambda: wkv6_chunked(*ops, chunk=cs.K6_CHUNK)  # noqa: E731
        row = {"probe": "time", "package": repro_torch.__file__, "BH": BH,
               "T": T, "graph_ms": cs.graph_ms(run, 5, 10),
               "eager_ms": cs.cuda_p50(run, 5, 10),
               "bound_ms": cs.k6_bound(BH, T, D)[0]}
        if forms:
            sms = gemm.sm_count(dev)
            row["rule"] = gemm.scan_form(BH, T, D, sms)
            calls = {f"columns_C{gemm.scan_width(BH, D, sms)}": lambda: gemm.scan(
                "wkv6_chunked", *ops, width=gemm.scan_width(BH, D, sms))}
            for L in gemm.SCAN_CHUNKS:
                calls[f"chunks_L{L}"] = (lambda L=L: gemm.scan(
                    "wkv6_chunked", *ops, tokens=L))
            for tag, call in calls.items():
                held_to_recurrence(call(), ops, f"({BH}, {T}) {tag}")
            first = {tag: cs.graph_ms(call, 3, 10) for tag, call in calls.items()}
            second = {tag: cs.graph_ms(call, 3, 10)
                      for tag, call in reversed(calls.items())}
            row["forms_graph_ms"] = {t: (first[t] + second[t]) / 2 for t in calls}
            row["forms_runs_ms"] = {t: [first[t], second[t]] for t in calls}
        cs.emit(row)
        del ops
        torch.cuda.empty_cache()


def probe_variants(dev):
    from repro_torch.kernels import build, gemm

    src = build.SOURCES["wkv6"].read_text()
    body = src[src.index(_BODY_START):src.index(_BODY_END)]
    splits = {(8, 2), (16, 2)}
    libs = build_copies(
        {**{f"G{g}_CPT{c}": patched(src, SPLIT_64, SPLIT_64.replace(
            "G = 16, CPT = 4", f"G = {g}, CPT = {c}")) for g, c in splits},
         "pipelined": patched(src, body, _PIPELINED)})
    repo = entry(build.load("wkv6"))
    rule = gemm.scan_width(40, D, gemm.sm_count(dev))
    for tag, (_, ptxas) in libs.items():
        cs.emit({"probe": "variants", "build": tag, "ptxas": ptxas})

    def held(run, want):
        got = run()
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = float((g - w).abs().max())
            if err > 1e-4 * float(w.abs().max()):
                raise RuntimeError(f"a variant differs from the repo's kernel by {err}")

    # The splits: every width each takes, at the prefill's shape, with the
    # repo's kernel at its rule's width before and after.
    ops = scan_ops(dev, 40, 384)
    base = caller(repo, ops, rule)
    want = tuple(t.clone() for t in base())
    times = {"repo_before": cs.graph_ms(base, 5, 10)}
    for G, CPT in [*sorted(splits), tuple(gemm.SCAN_SPLIT[D])]:
        fn = repo if (G, CPT) == gemm.SCAN_SPLIT[D] else entry(libs[f"G{G}_CPT{CPT}"][0])
        for c in widths(G, CPT):
            run = caller(fn, ops, c)
            held(run, want)
            times[f"G{G}_CPT{CPT}_C{c}"] = cs.graph_ms(run, 3, 10)
    times["repo_after"] = cs.graph_ms(base, 5, 10)
    cs.emit({"probe": "variants", "shape": [40, 384, D], "rule_width": rule,
             "graph_ms": times})
    # The pipelined loop against the repo's, in turns.
    piped = entry(libs["pipelined"][0])
    for T in (384, 1024):
        ops = scan_ops(dev, 40, T)
        for c in sorted({rule, 32}):
            base, run = caller(repo, ops, c), caller(piped, ops, c)
            held(run, base())
            cs.emit({"probe": "variants", "shape": [40, T, D], "width": c,
                     "repo_pipelined_repo_pipelined_ms":
                         [cs.graph_ms(f, 5, 10) for f in (base, run, base, run)]})


_CLOCK = ("namespace {\n", "namespace {\n__device__ unsigned long long* g_prof;\n"
          "__device__ __forceinline__ unsigned long long clk() { unsigned long long c;"
          " asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(c)); return c; }\n")
_SET_PROF = ('\nextern "C" int wkv6_set_prof(void* p) {\n'
             '    return (int)cudaMemcpyToSymbol(g_prof, &p, sizeof(p));\n}\n')


def profile_chunks(dev, BH, T, L):
    """The time-chunked form at (BH, T) in chunks of L: a copy of wkv6.cu
    whose blocks stamp ``%globaltimer`` (consumer thread 0) after taking
    their ticket, after the local pass, after the look-back and at the end;
    per block the local pass, the wait for the previous chunk's state and
    the state step, and the correction, in ns, and the blocks' spread."""
    from repro_torch.kernels import build

    src = build.SOURCES["wkv6"].read_text()
    stamps = [
        _CLOCK,
        ("    const int ticket = *ticket_s;\n",
         "    const int ticket = *ticket_s;\n"
         "    unsigned long long* const pr = g_prof + (size_t)ticket * 4;\n"
         "    if (tid == 0) pr[0] = clk();\n"),
        ("    const float* start = s0 + (size_t)bh * D * D;\n",
         "    if (tid == 0) pr[1] = clk();\n"
         "    const float* start = s0 + (size_t)bh * D * D;\n"),
        ("    // The correction: out_t = the local read-out + (r_t A_{t-1}) .\n",
         "    if (tid == 0) pr[2] = clk();\n"
         "    // The correction: out_t = the local read-out + (r_t A_{t-1}) .\n"),
        ("                store_n<CPT>(dst, o);\n            }\n        }\n    }\n}\n",
         "                store_n<CPT>(dst, o);\n            }\n        }\n    }\n"
         "    if (tid == 0) pr[3] = clk();\n}\n"),
    ]
    for old, new in stamps:
        src = patched(src, old, new)
    lib, _ = build_copies({"profile_chunks": src + _SET_PROF})["profile_chunks"]
    lib.wkv6_set_prof.argtypes = [ctypes.c_void_p]
    fn = lib.wkv6_time_chunks
    from repro_torch.kernels import gemm
    fn.argtypes = gemm._ENTRIES["wkv6_time_chunks"][1]
    ops = scan_ops(dev, BH, T)
    nc = -(-T // L)
    blocks = BH * nc
    prof = torch.zeros(blocks * 4, dtype=torch.int64, device=dev)
    if lib.wkv6_set_prof(prof.data_ptr()):
        raise RuntimeError("cudaMemcpyToSymbol failed")
    run = chunk_caller(fn, ops, L)
    for _ in range(3):
        out, s_out = run()
    torch.cuda.synchronize()
    held_to_recurrence((out, s_out), ops, f"profiled chunks ({BH}, {T}) L {L}")
    a = prof.cpu().numpy().reshape(blocks, 4).astype(np.int64)
    chunk = np.arange(blocks) // BH
    later = chunk > 0
    cs.emit({"probe": "profile", "form": "chunks", "shape": [BH, T, D], "L": L,
             "blocks": blocks,
             "kernel_span_ns": int(a[:, 3].max() - a[:, 0].min()),
             "block_ns_mean": float((a[:, 3] - a[:, 0]).mean()),
             "per_block_ns": {
                 "local_pass": float((a[:, 1] - a[:, 0]).mean()),
                 "wait_and_state": float((a[:, 2] - a[:, 1]).mean()),
                 "wait_and_state_past_chunk_0": float((a[later, 2] - a[later, 1]).mean()),
                 "correction": float((a[:, 3] - a[:, 2]).mean())},
             "wait_and_state_p90_ns": float(np.percentile(a[:, 2] - a[:, 1], 90)),
             "start_spread_ns": int(a[:, 0].max() - a[:, 0].min())})


def probe_profile(dev):
    """The form the rule takes at the prefill's (40, 384) and at
    rwkv_train's (80, 4096): the columns kernel's per-tile stamps, or the
    chunked kernel's per-phase stamps (:func:`profile_chunks`)."""
    from repro_torch.kernels import gemm

    for BH, T in ((40, 384), (80, 4096)):
        form, size = gemm.scan_form(BH, T, D, gemm.sm_count(dev))
        if form == "chunks":
            profile_chunks(dev, BH, T, size)
        else:
            profile_columns(dev, BH, T, size)


_CHUNKS_PART = "// The time-chunked form: a block per"


def profile_columns(dev, BH, T, rule_width):
    """The columns form at (BH, T): a copy of wkv6.cu whose blocks stamp
    ``%globaltimer`` per tile (thread 0 for the consumers, producer thread
    0 for the producers), at the rule's width and at 16 and 32 columns."""
    from repro_torch.kernels import build

    full_src = build.SOURCES["wkv6"].read_text()
    cut = full_src.index(_CHUNKS_PART)
    src, rest = full_src[:cut], full_src[cut:]
    stamps = [
        _CLOCK,
        ("    const size_t seq = (size_t)bh * T * D;\n"
         "    // The last block of a sequence",
         "    const size_t seq = (size_t)bh * T * D;\n"
         "    unsigned long long* const pr = g_prof + (size_t)(blockIdx.y * gridDim.x"
         " + blockIdx.x) * (2 + 4 * n_tiles);\n    if (tid == 0) pr[0] = clk();\n"
         "    // The last block of a sequence"),
        ("            mbar_wait(smem_addr(full + s), (i / STAGES) & 1);\n",
         "            mbar_wait(smem_addr(full + s), (i / STAGES) & 1);\n"
         "            if (pt == 0) pr[2 + 4 * i + 1] = clk();\n"),
        ("            asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n",
         "            if (pt == 0) pr[2 + 4 * i + 2] = clk();\n"
         "            asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n"),
        ("        mbar_wait(smem_addr(ready + s), (i / STAGES) & 1);\n",
         "        if (tid == 0) pr[2 + 4 * i] = clk();\n"
         "        mbar_wait(smem_addr(ready + s), (i / STAGES) & 1);\n"
         "        if (tid == 0) pr[2 + 4 * i + 3] = clk();\n"),
        ("#pragma unroll\n    for (int q = 0; q < Q; ++q)\n#pragma unroll\n"
         "        for (int e = 0; e < 4; ++e)\n            store_n",
         "    if (tid == 0) pr[1] = clk();\n#pragma unroll\n    for (int q = 0; q < Q; ++q)\n"
         "#pragma unroll\n        for (int e = 0; e < 4; ++e)\n            store_n"),
    ]
    for old, new in stamps:
        src = patched(src, old, new)
    lib, _ = build_copies({"profile": src + rest + _SET_PROF})["profile"]
    lib.wkv6_set_prof.argtypes = [ctypes.c_void_p]
    fn = entry(lib)
    ops = scan_ops(dev, BH, T)
    n_tiles = -(-T // 32)
    for c in sorted({rule_width, 16, 32}):
        blocks = BH * -(-D // c)
        prof = torch.zeros(blocks * (2 + 4 * n_tiles), dtype=torch.int64, device=dev)
        if lib.wkv6_set_prof(prof.data_ptr()):
            raise RuntimeError("cudaMemcpyToSymbol failed")
        run = caller(fn, ops, c)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        a = prof.cpu().numpy().reshape(blocks, 2 + 4 * n_tiles).astype(np.int64)
        tiles = a[:, 2:].reshape(blocks, n_tiles, 4)
        top, full_seen, prepped, ready_seen = (tiles[:, :, i] for i in range(4))
        end_of = np.concatenate([top[:, 1:], a[:, 1:2]], 1)
        cs.emit({"probe": "profile", "form": "columns", "shape": [BH, T, D], "width": c,
                 "blocks": blocks,
                 "kernel_span_ns": int(a[:, 1].max() - a[:, 0].min()),
                 "block_ns_mean": float((a[:, 1] - a[:, 0]).mean()),
                 "first_tile_wait_ns": float((ready_seen - top)[:, 0].mean()),
                 "per_tile_ns": {
                     "consumer_wait": float((ready_seen - top)[:, 1:].mean()),
                     "producer_prep": float((prepped - full_seen).mean()),
                     "consumer_recurrence": float((end_of - ready_seen).mean())},
                 "tiles_ready_before_consumers": float((prepped <= top)[:, 1:].mean())})


# The chunked form's compile-time knobs in wkv6.cu, and the variants timed:
# (G, CPT) of ChunkSplit<64>, tokens a tile, ring slots, producer warps,
# resident blocks.
_CHUNK_KNOBS = ("template <> struct ChunkSplit<64> { static constexpr int G = 8, CPT = 4; };",
                "constexpr int CHUNK_TILE = 16;", "constexpr int CHUNK_STAGES = 2;",
                "constexpr int CHUNK_PRODUCER_WARPS = 2;", "constexpr int CHUNK_MIN_BLOCKS = 3;")
CHUNK_VARIANTS = [(16, 4, 32, 2, 2, 2), (8, 4, 32, 2, 2, 2), (8, 4, 16, 3, 2, 3),
                  (8, 4, 16, 2, 1, 3), (8, 4, 16, 2, 2, 4)]


def chunk_caller(fn, ops, L):
    """A call of a ``wkv6_time_chunks`` C entry on ``ops`` in chunks of L,
    its outputs and workspaces allocated by each call as ``gemm.scan``
    allocates them (one zeroed sync buffer reused by the calls of one CUDA
    graph, zeroed by ``zero_`` between them, faulted on replay at L 64)."""
    from repro_torch.kernels import gemm

    BH, T, _ = ops[0].shape
    nc = -(-T // L)

    def run():
        out, s_out = torch.empty_like(ops[0]), torch.empty_like(ops[5])
        states = ops[0].new_empty(max(nc - 1, 1) * BH * D * D)
        sync = ops[0].new_zeros(gemm.scan_sync_words(BH, T, L), dtype=torch.int32)
        err = fn(*[a.data_ptr() for a in (*ops, out, s_out, states, sync)],
                 BH, T, D, L, ops[0].device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wkv6_time_chunks refused L {L}: {err}")
        return out, s_out
    return run


def probe_chunk_variants(dev):
    """Copies of wkv6.cu with the chunked form's knobs changed (the
    columns' G and CPT of ChunkSplit<64>, ring slots, producer warps,
    resident blocks in the launch bounds), each held to the token
    recurrence at rwkv_train's (80, 4096) and graph-timed at L 64, 128 and
    256 in turns with the repo's kernel at the rule's L."""
    from repro_torch.kernels import build, gemm

    src = build.SOURCES["wkv6"].read_text()
    sources = {}
    for g, cpt, tile, stages, pw, mb in CHUNK_VARIANTS:
        v = src
        for old, new in zip(_CHUNK_KNOBS, (
                f"template <> struct ChunkSplit<64> {{ static constexpr int G = {g}, CPT = {cpt}; }};",
                f"constexpr int CHUNK_TILE = {tile};",
                f"constexpr int CHUNK_STAGES = {stages};",
                f"constexpr int CHUNK_PRODUCER_WARPS = {pw};",
                f"constexpr int CHUNK_MIN_BLOCKS = {mb};")):
            v = patched(v, old, new)
        sources[f"G{g}_CPT{cpt}_T{tile}_S{stages}_P{pw}_B{mb}"] = v
    libs = build_copies(sources)
    for tag, (_, ptxas) in libs.items():
        cs.emit({"probe": "chunk_variants", "build": tag, "ptxas": ptxas})
    # One process a variant, so that a fault names its variant and leaves
    # the others' timings.
    for tag in libs:
        proc = subprocess.run([sys.executable, __file__, "chunk_variant", tag],
                              capture_output=True, text=True, timeout=600)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            cs.emit({"probe": "chunk_variants", "variant": tag, "failed": proc.returncode,
                     "stderr": proc.stderr[-1500:]})


def probe_chunk_variant(dev, tag):
    """One built variant of ``chunk_variants`` (``build/probe/wkv6_<tag>.so``)
    at rwkv_train's (80, 4096), L 64, 128 and 256, in turns with the repo's
    kernel at the rule's L."""
    from repro_torch.kernels import build, gemm

    BH, T = 80, 4096
    ops = scan_ops(dev, BH, T)
    rule = gemm.scan_form(BH, T, D, gemm.sm_count(dev))
    repo_fn = build.load("wkv6").wkv6_time_chunks
    repo_fn.argtypes = gemm._ENTRIES["wkv6_time_chunks"][1]
    base = chunk_caller(repo_fn, ops, rule[1])
    held_to_recurrence(base(), ops, "repo chunks")
    times = {"repo_before": cs.graph_ms(base, 3, 10)}
    fn = ctypes.CDLL(str(OUT / f"wkv6_{tag}.so")).wkv6_time_chunks
    fn.argtypes = repo_fn.argtypes
    for L in (64, 128, 256):
        run = chunk_caller(fn, ops, L)
        held_to_recurrence(run(), ops, f"{tag} L {L}")
        times[f"L{L}_once"] = "held"
        times[f"L{L}"] = cs.graph_ms(run, 3, 10)
    times["repo_after"] = cs.graph_ms(base, 3, 10)
    cs.emit({"probe": "chunk_variants", "variant": tag, "shape": [BH, T, D],
             "rule": rule, "graph_ms": times})


# -- the key-row scan (csrc/wkv6_rows.cu) ------------------------------------

# rwkv_train's shape and head size 16's twins, (BH, T, D).
ROWS_SHAPES = ((80, 4096, 64), (80, 4096, 16), (7, 70, 16))
# The knobs of wkv6_rows.cu and the variants timed: (G, RPT) of
# RowSplit<64>, tokens a chunk, tokens a tile, ring slots, producer warps,
# resident blocks.  The repo's geometry at other chunk lengths, then other
# geometries at its chunk length.
_ROWS_KNOBS = ("template <> struct RowSplit<64> { static constexpr int G = 8, RPT = 4; };",
               "constexpr int CHUNK = 64; ", "constexpr int TILE = 16; ",
               "constexpr int STAGES = 2; ", "constexpr int PRODUCER_WARPS = 2;",
               "constexpr int MIN_BLOCKS = 3; ")
ROWS_VARIANTS = [(8, 4, 16, 16, 2, 2, 3), (8, 4, 32, 16, 2, 2, 3),
                 (8, 4, 128, 16, 2, 2, 3), (8, 4, 256, 16, 2, 2, 3),
                 (4, 4, 64, 16, 2, 2, 3), (16, 4, 64, 16, 2, 2, 2),
                 (8, 2, 64, 16, 2, 2, 2), (8, 8, 64, 16, 2, 2, 3),
                 (8, 4, 64, 32, 2, 2, 2), (8, 4, 64, 16, 2, 1, 3),
                 (8, 4, 64, 16, 3, 2, 3), (8, 4, 64, 16, 2, 2, 4)]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def rows_ops(dev, BH, T, D):
    """x, y, z ~ N(0, 1), logw = -exp(N(0, 1)), s0 ~ 0.1 N(0, 1), from
    chip_smoke.py's seed."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 39)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, y, z = randn(BH, T, D), randn(BH, T, D), randn(BH, T, D)
    return x, y, z, -torch.exp(randn(BH, T, D)), 0.1 * randn(BH, D, D)


def held_to_plain(got, ops, tag):
    from repro_torch.kernels import ref

    want = ref.wkv6_rows_ref(*ops)
    err = float((got - want).abs().max())
    if not err <= cs.REL_TOL * float(want.abs().max()):
        raise RuntimeError(f"{tag}: |kernel - plain| {err}")


def rows_caller(lib, ops):
    """A call of a built copy of wkv6_rows.cu (``lib``) on ``ops``, its
    output and workspaces allocated by each call as ``gemm.key_rows``
    allocates them, by the copy's own chunk length and sync-word count."""
    from repro_torch.kernels import gemm

    fn = lib.wkv6_rows
    fn.argtypes = gemm._ENTRIES["wkv6_rows"][1]
    words = lib.wkv6_rows_sync_words
    words.argtypes, words.restype = [ctypes.c_int] * 2, ctypes.c_size_t
    BH, T, D = ops[0].shape
    nc = -(-T // lib.wkv6_rows_chunk())

    def run():
        out = torch.empty_like(ops[0])
        states = ops[0].new_empty(max(nc - 1, 1) * BH * D * D)
        sync = ops[0].new_zeros(words(BH, T), dtype=torch.int32)
        err = fn(*[a.data_ptr() for a in (*ops, out, states, sync)], BH, T, D,
                 ops[0].device.index, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wkv6_rows refused: {err}")
        return out
    return run


def old_rows_caller(fn, ops):
    """A call of the token-recurrence kernel's ``wkv6_rows`` C entry (x,
    y, z, logw, s0, out, BH, T, D, device, stream)."""
    BH, T, D = ops[0].shape

    def run():
        out = torch.empty_like(ops[0])
        err = fn(*[a.data_ptr() for a in (*ops, out)], BH, T, D, ops[0].device.index,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the old wkv6_rows refused: {err}")
        return out
    return run


def probe_rows_time(dev, old_source=None):
    from repro_torch.kernels import build, gemm, wkv6_rows

    build.build_all()
    old = None
    if old_source is not None:
        lib, ptxas = build_copies({"rows_old": Path(old_source).read_text()})["rows_old"]
        old = lib.wkv6_rows
        old.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        cs.emit({"probe": "rows_time", "build": "old", "source": old_source,
                 "ptxas": ptxas})
    for BH, T, D in ROWS_SHAPES:
        ops = rows_ops(dev, BH, T, D)
        calls = {"wrapper": lambda: wkv6_rows(*ops)}
        if old is not None:
            calls["old"] = old_rows_caller(old, ops)
        for tag, call in calls.items():
            held_to_plain(call(), ops, f"({BH}, {T}, {D}) {tag}")
        first = {tag: cs.graph_ms(call, 3, 10) for tag, call in calls.items()}
        second = {tag: cs.graph_ms(call, 3, 10) for tag, call in reversed(calls.items())}
        cs.emit({"probe": "rows_time", "card": card(), "shape": [BH, T, D],
                 "rows_chunk": gemm.rows_chunk(),
                 "graph_ms": {t: (first[t] + second[t]) / 2 for t in calls},
                 "runs_ms": {t: [first[t], second[t]] for t in calls},
                 "wrapper_eager_ms": cs.cuda_p50(calls["wrapper"], 5, 10),
                 "bound_ms": cs.rows_bound(BH, T, D)[0],
                 "form_floor_ms": cs.rows_form_floor_ms(BH, T, D)})
        del ops
        torch.cuda.empty_cache()


def probe_rows_variants(dev):
    from repro_torch.kernels import build

    src = build.SOURCES["wkv6_rows"].read_text()
    sources = {}
    for g, rpt, L, tile, stages, pw, mb in ROWS_VARIANTS:
        v = src
        for old, new in zip(_ROWS_KNOBS, (
                f"template <> struct RowSplit<64> {{ static constexpr int G = {g}, RPT = {rpt}; }};",
                f"constexpr int CHUNK = {L}; ", f"constexpr int TILE = {tile}; ",
                f"constexpr int STAGES = {stages}; ", f"constexpr int PRODUCER_WARPS = {pw};",
                f"constexpr int MIN_BLOCKS = {mb}; ")):
            v = patched(v, old, new)
        sources[f"rows_G{g}_R{rpt}_L{L}_T{tile}_S{stages}_P{pw}_B{mb}"] = v
    libs = build_copies(sources)
    for tag, (_, ptxas) in libs.items():
        cs.emit({"probe": "rows_variants", "build": tag, "ptxas": ptxas})
    for tag in libs:
        proc = subprocess.run([sys.executable, __file__, "rows_variant", tag],
                              capture_output=True, text=True, timeout=600)
        print(proc.stdout, end="", flush=True)
        if proc.returncode:
            cs.emit({"probe": "rows_variants", "variant": tag, "failed": proc.returncode,
                     "stderr": proc.stderr[-1500:]})


def probe_rows_variant(dev, tag):
    """One built variant of ``rows variants`` (``build/probe/wkv6_<tag>.so``)
    at (80, 4096, 64), in turns with the repo's kernel."""
    from repro_torch.kernels import build

    ops = rows_ops(dev, 80, 4096, 64)
    base = rows_caller(build.load("wkv6_rows"), ops)
    held_to_plain(base(), ops, "repo")
    times = {"repo_before": cs.graph_ms(base, 3, 10)}
    run = rows_caller(ctypes.CDLL(str(OUT / f"wkv6_{tag}.so")), ops)
    held_to_plain(run(), ops, tag)
    times["variant"] = cs.graph_ms(run, 3, 10)
    times["repo_after"] = cs.graph_ms(base, 3, 10)
    cs.emit({"probe": "rows_variants", "variant": tag, "card": card(),
             "shape": [80, 4096, 64], "graph_ms": times})


def probe_rows_profile(dev):
    from repro_torch.kernels import build, gemm

    src = build.SOURCES["wkv6_rows"].read_text()
    stamps = [
        _CLOCK,
        ("    const int ticket = *ticket_s;\n",
         "    const int ticket = *ticket_s;\n"
         "    unsigned long long* const pr = g_prof + (size_t)ticket * 4;\n"
         "    if (tid == 0) pr[0] = clk();\n"),
        ("    const float* start = s0 + (size_t)bh * D * D;\n",
         "    if (tid == 0) pr[1] = clk();\n"
         "    const float* start = s0 + (size_t)bh * D * D;\n"),
        ("    // The correction: out_t = the local read-out + a_{t-1} (S_start(c) .\n",
         "    if (tid == 0) pr[2] = clk();\n"
         "    // The correction: out_t = the local read-out + a_{t-1} (S_start(c) .\n"),
        ("            store_n<RPT>(o_seq + (size_t)t * D + row0, o);\n        }\n    }\n}\n",
         "            store_n<RPT>(o_seq + (size_t)t * D + row0, o);\n        }\n    }\n"
         "    if (tid == 0) pr[3] = clk();\n}\n"),
    ]
    for old, new in stamps:
        src = patched(src, old, new)
    chunks = sorted({gemm.rows_chunk(), 128})
    libs = build_copies({f"rows_profile_L{L}": patched(
        src, _ROWS_KNOBS[1], f"constexpr int CHUNK = {L}; ") + _SET_PROF for L in chunks})
    BH, T, D = 80, 4096, 64
    ops = rows_ops(dev, BH, T, D)
    for L in chunks:
        lib, _ = libs[f"rows_profile_L{L}"]
        lib.wkv6_set_prof.argtypes = [ctypes.c_void_p]
        blocks = BH * -(-T // L)
        prof = torch.zeros(blocks * 4, dtype=torch.int64, device=dev)
        if lib.wkv6_set_prof(prof.data_ptr()):
            raise RuntimeError("cudaMemcpyToSymbol failed")
        run = rows_caller(lib, ops)
        for _ in range(3):
            out = run()
        torch.cuda.synchronize()
        held_to_plain(out, ops, f"profiled rows L {L}")
        a = prof.cpu().numpy().reshape(blocks, 4).astype(np.int64)
        later = np.arange(blocks) >= BH
        span = int(a[:, 3].max() - a[:, 0].min())
        cs.emit({"probe": "rows_profile", "card": card(), "shape": [BH, T, D], "L": L,
                 "blocks": blocks, "kernel_span_ns": span,
                 "block_ns_mean": float((a[:, 3] - a[:, 0]).mean()),
                 "per_block_ns": {
                     "local_pass": float((a[:, 1] - a[:, 0]).mean()),
                     "chain": float((a[:, 2] - a[:, 1]).mean()),
                     "chain_past_chunk_0": float((a[later, 2] - a[later, 1]).mean()),
                     "correction": float((a[:, 3] - a[:, 2]).mean())},
                 "chain_p90_ns": float(np.percentile(a[:, 2] - a[:, 1], 90)),
                 "chain_share_of_block_time": float((a[:, 2] - a[:, 1]).sum()
                                                    / (a[:, 3] - a[:, 0]).sum()),
                 "start_spread_ns": int(a[:, 0].max() - a[:, 0].min())})


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    probes = {"time": probe_time, "variants": probe_variants, "profile": probe_profile,
              "chunk_variants": probe_chunk_variants}
    rows = {"time": probe_rows_time, "variants": probe_rows_variants,
            "profile": probe_rows_profile}
    if not torch.cuda.is_available():
        sys.exit("k6_probe.py: no CUDA device")
    dev = torch.device("cuda", 0)
    if mode == "chunk_variant" and len(sys.argv) == 3:
        probe_chunk_variant(dev, sys.argv[2])
        return
    if mode == "rows_variant" and len(sys.argv) == 3:
        probe_rows_variant(dev, sys.argv[2])
        return
    if mode == "rows":
        sub = sys.argv[2] if len(sys.argv) > 2 else ""
        if sub not in rows or (len(sys.argv) > 3 and sub != "time") or len(sys.argv) > 4:
            sys.exit(f"usage: k6_probe.py rows {{{'|'.join(rows)}}} (time [OLD_WKV6_ROWS_CU])")
        rows[sub](dev, *sys.argv[3:])
        return
    if mode not in probes:
        sys.exit(f"usage: k6_probe.py {{{'|'.join(probes)}|rows}}")
    probes[mode](dev)


if __name__ == "__main__":
    main()
