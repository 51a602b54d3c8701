// RWKV-6 linear-attention scan as a state-column recurrence (sm_90a), fp32,
// in two forms: blocks of columns walking the whole sequence (the columns
// form, wkv6_chunked), or chunks of time run in parallel and chained (the
// time-chunked form, wkv6_time_chunks).  kernels/gemm.py scan_form picks one
// per shape.
//
//   r, k, v, logw (BH, T, D) with logw <= 0; u (BH, D); s0 (BH, D, D)
//   [key x value]; out (BH, T, D); s_out (BH, D, D).  Row-major, contiguous.
//   Column j of the state is a D-vector recurrence over the tokens, and the
//   columns share nothing:
//
//     out_t[j]   = r_t . S_{t-1}[:, j] + (sum_d r_td u_d k_td) v_t[j]
//     S_t[:, j]  = w_t * S_{t-1}[:, j] + k_t v_t[j],     w_t = e^{logw_t}
//
// Replaces the Pallas kernel wkv6_chunked (src/repro/kernels/wkv6.py:71).
// That kernel takes the chunked form (intra-chunk scores under pairwise
// decays, then a state update per chunk) because the TPU's matrix unit
// wants products; the function is the token recurrence above (the oracle
// ref.wkv6_ref), and this kernel computes that recurrence.  The result
// does not depend on the chunk, which the wrapper still validates.
//
// What bounds it on an H100.  The function is bound by bytes: at the
// prefill's shape (BH = 40 heads, T = 384, D = 64) it must read r, k, v,
// logw, u and s0 and write out and the final state, 21.0 MB, 0.0063 ms at
// 3.35 TB/s.  This form's own floor is its fp32 issue: 3 instructions per
// (token, column, row) (a read-out FMA, the product k v[j], the
// decay-and-add FMA), 0.19 G at that shape, 0.0056 ms at 128 lanes per SM
// and clock; and one exponential per (token, row), where the pairwise
// chunked form took L (L - 1) / 2 * D a chunk (62 M at that shape).  What
// holds this kernel above that floor is delivering r, w and k to the
// threads: every thread reads its rows of all three for every token from
// shared memory, which serves 128 bytes a clock per SM whether or not the
// lanes of a warp share an address.  What the design does:
//
//   * Columns per thread.  Each thread holds CPT neighbouring columns of
//     its R = D / G state rows (rows 4 (q G + g) + e for row group g), in
//     registers for the whole sequence: the r, w, k it reads serve CPT
//     columns, so shared-memory traffic per column falls by CPT.  One
//     (G, CPT) per head size (Split below): at D = 64, G = 16, CPT = 4,
//     R = 4, 16 state floats a thread, the fastest of the pairs timed on
//     an H100 at the prefill's shape (PERF.md); at D = 16, G = 4, CPT = 1.
//   * Parallelism.  A block owns one (b, h) and C columns (the last block
//     of a sequence the rest), with C / CPT * G consumer threads and
//     PRODUCER_WARPS producer warps.  The columns share nothing: no state
//     chain crosses blocks.  A warp holds 32 / G * CPT = 8 columns, so no
//     scheduler can hold fewer than 8 of the 2,560 columns at BH = 40; the
//     wrapper's rule (gemm.scan_width) takes C = 24: 120 blocks of 3
//     consumer warps, one block an SM, 8 columns a scheduler.
//   * Warp-specialised tiles.  r, k, logw and v stream through a ring of
//     STAGES tiles of TILE tokens, each a contiguous run of the sequence
//     loaded by cp.async.bulk on an mbarrier (full).  The producer warps
//     prepare a tile while the consumers run the one before: w = e^{logw}
//     (one exp2 per token and row) and the bonus sum_d r_d u_d k_d (one
//     per token) go into the slot once per block, for all its columns;
//     mbarriers ready and empty hand slots back and forth, and no block
//     barrier stops the consumers.
//   * The read-out.  A thread's partial sums over its rows for G tokens are
//     reduced across the column group's G lanes by a butterfly that also
//     scatters them ((G - 1) CPT shuffles per G tokens), leaving lane g
//     with token g's sums for its CPT columns: a 16-byte piece of one
//     output row, which it stores (a warp's pieces of a row are whole
//     32-byte sectors).
//   * Layout.  Neighbouring lanes take neighbouring columns (s0 and s_out
//     rows coalesce); the G row groups of a warp read G neighbouring
//     16-byte pieces of a token's row, so shared loads do not conflict.
//   * Ragged ends.  The last tile copies only its T % TILE rows; the rest
//     are set to w = 1, k = v = 0, which leaves the state as it is, and
//     their outputs are not stored.  T = 1 is one such tile.
//
// The time-chunked form.  The columns form runs every block through all T
// tokens in series, so where few sequences leave the card short of warps it
// is latency-bound: at rwkv_train's (BH, T) = (80, 4096) its blocks of 8
// columns put one consumer warp on an SM and each block streams its
// sequence's whole r, k, logw and v (2.7 GB against 0.34 GB of operands).
// The time-chunked form cuts each sequence into chunks of L tokens, with
// S_start(c) the state before chunk c, A_{t-1} the product of w over the
// chunk's tokens before t and A(c) over the whole chunk:
//   * Local pass, a block per (sequence, chunk) owning all D columns: the
//     column recurrence above from a zero state, keeping each token's
//     read-out of the chunk's own tokens (with its bonus) and r_t A_{t-1}
//     in shared memory, and ending with S_loc(c).  The producer
//     warps prepare each tile once for all columns (and A, r A).
//   * State chain, in chunk order: S_start(c + 1) = diag(A(c)) S_start(c) +
//     S_loc(c) from s0; the last is s_final.  Each consumer thread reads the
//     entries of S_start(c) that the same thread of chunk c - 1 wrote, so a
//     warp waits on its counterpart's flag alone (ld.acquire) and publishes
//     its own (st.release after a warp barrier).  Blocks take their chunk
//     from an atomic ticket, chunk c of every sequence before chunk c + 1
//     of any: a block waits only on a block that took its ticket earlier
//     and is running or done, and the chains of the BH sequences advance
//     side by side.
//   * Correction: out_t += (r_t A_{t-1}) . S_start(c), an (L, D) @ (D, D)
//     product per chunk with the read-out's partial sums and butterfly.
// Nothing is divided and no factor exceeds 1: strong decay underflows A to
// 0, as the recurrence decays the state.  No atomics touch the numbers: the
// same bits on every call.  The wrapper zeroes the sync words (the ticket,
// a flag a consumer warp of each (chunk, sequence)) before each launch.
// Bytes: r, k, logw, v read once, out written once, S_start through L2:
// about 0.42 GB at (80, 4096), its 0.126 ms bound.  Operations: the local pass issues the columns form's 3
// FMA-pipe instructions per (token, column, row), the correction 1 more.
// Geometry, the fastest of the variants timed at (80, 4096) on an H100
// (tools/k6_probe.py chunk_variants, PERF.md): (G, CPT) = (8, 4) at D = 64
// (4 consumer warps a block, 8 rows x 4 columns a thread), 2 producer
// warps, tiles of 16 tokens in a ring of 2, three blocks an SM; L = 64, the
// chunk's local read-outs kept in shared memory (70 KB a block) until the
// correction adds to them and writes out once.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int TILE = 32;             // tokens per ring slot
constexpr int STAGES = 3;            // ring slots
constexpr int MAX_CONSUMERS = 256;   // C / CPT * G at most
constexpr int PRODUCER_WARPS = 4;
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

// The split of each head size: G threads per state column, CPT columns per
// thread (gemm.py's SCAN_SPLIT says the same).
template <int D> struct Split;
template <> struct Split<16> { static constexpr int G = 4, CPT = 1; };
template <> struct Split<64> { static constexpr int G = 16, CPT = 4; };

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Waits for the phase of parity `parity` of the mbarrier at `bar`.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, unrolled in the
// source: an array indexed by i stays in registers whatever the compiler's
// unrolling thresholds.
template <class F, int... I>
__device__ __forceinline__ void unroll_seq(F&& f, std::integer_sequence<int, I...>) {
    (f(std::integral_constant<int, I>{}), ...);
}

template <int N, class F>
__device__ __forceinline__ void unroll(F&& f) {
    unroll_seq(f, std::make_integer_sequence<int, N>{});
}

// 2^x on the SFU (ex2.approx: within a few units in the last place).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// a where m is 0, b where m is all ones: a select on the values' bits, so
// that the compiler cannot turn it into a select of addresses (which would
// put the array it indexes in local memory).
__device__ __forceinline__ float pick(float a, float b, unsigned m) {
    return __uint_as_float((__float_as_uint(a) & ~m) | (__float_as_uint(b) & m));
}

// Bytes of shared memory: the ring and u, then the mbarriers full, ready
// and empty, STAGES each.
template <int D>
constexpr size_t smem_bytes() {
    return (size_t)(STAGES * (4 * TILE * D + TILE) + D) * sizeof(float)
           + 3 * STAGES * sizeof(uint64_t);
}

// N consecutive floats (N = 1, 2 or 4, p aligned to N floats) in one access.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&o)[N]) {
    if constexpr (N == 4) {
        const float4 x = ld4(p);
        o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
    } else if constexpr (N == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        o[0] = x.x; o[1] = x.y;
    } else {
        o[0] = *p;
    }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&o)[N]) {
    if constexpr (N == 4) {
        st4(p, make_float4(o[0], o[1], o[2], o[3]));
    } else if constexpr (N == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
    } else {
        *p = o[0];
    }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Token t0 + tt's row of a ring slot (r, k, w, v at TF floats apart), for
// tt = 0 .. G - 1: each thread's partial read-out p[tt] over its rows of
// S_{t-1}, then S_t = w S_{t-1} + k v[j], for its R rows 4 (q G + g) + e
// and CPT columns j .. j + CPT - 1.
template <int D, int G, int CPT, int TF>
__device__ __forceinline__ void recur_group(const float* rs, int t0, int g, int j,
                                            float (&S)[D / G][CPT], float (&p)[G][CPT]) {
    constexpr int Q = D / G / 4;
    unroll<G>([&](auto tt_) {
        constexpr int tt = decltype(tt_)::value;
        const float* const row = rs + (t0 + tt) * D;
        float vj[CPT];
        load_n<CPT>(row + 3 * TF + j, vj);
#pragma unroll
        for (int x = 0; x < CPT; ++x) p[tt][x] = 0.0f;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int o = 4 * (q * G + g);
            const float4 rr = ld4(row + o), kk = ld4(row + TF + o),
                         ww = ld4(row + 2 * TF + o);
            const float re[4] = {rr.x, rr.y, rr.z, rr.w};
            const float ke[4] = {kk.x, kk.y, kk.z, kk.w};
            const float we[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int x = 0; x < CPT; ++x) {
                    float& st = S[4 * q + e][x];
                    p[tt][x] = fmaf(re[e], st, p[tt][x]);
                    st = fmaf(we[e], st, ke[e] * vj[x]);
                }
        }
    });
}

// Butterfly over the column group's G lanes (lane bits of GW * h): at each
// step a lane keeps the half of its tokens that its bit h of g selects and
// adds its partner's sums for them; lane g ends with token g's sums in
// p[0].
template <int G, int CPT>
__device__ __forceinline__ void butterfly(float (&p)[G][CPT], int g) {
    constexpr int GW = 32 / G;
    constexpr int LOG2_G = G == 2 ? 1 : G == 4 ? 2 : G == 8 ? 3 : 4;
    unroll<LOG2_G>([&](auto level_) {
        constexpr int h = G >> (decltype(level_)::value + 1);
        const unsigned upper = (g & h) ? 0xffffffffu : 0u;
        unroll<h>([&](auto y_) {
            constexpr int y = decltype(y_)::value;
#pragma unroll
            for (int x = 0; x < CPT; ++x) {
                const float lo = p[y][x], hi = p[y + h][x];
                p[y][x] = pick(lo, hi, upper)
                          + __shfl_xor_sync(0xffffffffu, pick(hi, lo, upper), h * GW);
            }
        });
    });
}

template <int D>
__global__ void __launch_bounds__(MAX_CONSUMERS + 32 * PRODUCER_WARPS, 1)
wkv6_columns_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    float* __restrict__ out, float* __restrict__ s_out,
                    int T, int C) {
    constexpr int G = Split<D>::G, CPT = Split<D>::CPT;
    constexpr int R = D / G;             // state rows per thread
    constexpr int Q = R / 4;             // their 16-byte groups
    constexpr int GW = 32 / G;           // column groups per warp
    constexpr int LOG2_G = G == 2 ? 1 : G == 4 ? 2 : G == 8 ? 3 : 4;
    constexpr int TF = TILE * D;         // floats of one operand tile
    constexpr int SF = 4 * TF + TILE;    // a slot: r, k, w, v, bonus
    constexpr int NP = 32 * PRODUCER_WARPS;
    static_assert(R % 4 == 0 && GW * G == 32 && (1 << LOG2_G) == G
                  && (CPT == 1 || CPT == 2 || CPT == 4),
                  "unsupported split");

    // [STAGES][r | k | w (logw on arrival) | v | bonus], u, then the
    // mbarriers: full (the slot's copies landed), ready (prepared), empty
    // (the consumers are done with it).
    extern __shared__ __align__(128) float smem[];
    float* const u_s = smem + STAGES * SF;
    uint64_t* const full = reinterpret_cast<uint64_t*>(u_s + D);
    uint64_t* const ready = full + STAGES;
    uint64_t* const empty = ready + STAGES;

    const int consumers = C / CPT * G;   // threads [0, consumers)
    const int tid = threadIdx.x;
    const int bh = blockIdx.y;
    const int col0 = blockIdx.x * C;
    const int n_tiles = (T + TILE - 1) / TILE;
    const size_t seq = (size_t)bh * T * D;
    // The last block of a sequence may own fewer than C columns: its warps
    // past column D (all their lanes are) take no part.
    const int owners = 32 * min(consumers / 32, (D - col0 + GW * CPT - 1) / (GW * CPT));

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(ready + s, NP);
            mbar_init(empty + s, owners);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int d = tid; d < D; d += blockDim.x) u_s[d] = u[(size_t)bh * D + d];
    __syncthreads();

    if (tid >= consumers) {
        // ---- producer warps: copy each tile in, then prepare it ------------
        const int pt = tid - consumers;
        // Tile i's four operands into slot i % STAGES, counted on full.
        auto load = [&](int i) {
            const int s = i % STAGES;
            const unsigned bytes = (unsigned)min(TILE, T - i * TILE) * D * sizeof(float);
            const unsigned bar = smem_addr(full + s);
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         :: "r"(bar), "r"(4 * bytes) : "memory");
            const size_t off = seq + (size_t)i * TF;
            const float* src[4] = {r + off, k + off, logw + off, v + off};
#pragma unroll
            for (int a = 0; a < 4; ++a)
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                    "[%0], [%1], %2, [%3];\n"
                    :: "r"(smem_addr(smem + s * SF + a * TF)), "l"(src[a]), "r"(bytes),
                       "r"(bar)
                    : "memory");
        };
        if (pt == 0)
            for (int i = 0; i < STAGES - 1 && i < n_tiles; ++i) load(i);
        // The bonus: TP threads per token of the tile, each summing
        // UQ = D / (4 TP) groups of four (rotated by token, so that a
        // quarter-warp's loads hit distinct banks; its groups of u are held
        // in registers), then a shuffle sum.
        constexpr int TP = NP / TILE;
        constexpr int UQ = D / (4 * TP);
        static_assert(UQ >= 1 && D % (4 * TP) == 0, "bonus split");
        const int bt = pt / TP, bp = pt % TP;
        float4 uu[UQ];
#pragma unroll
        for (int m = 0; m < UQ; ++m) uu[m] = ld4(u_s + 4 * ((bp + TP * m + TP * bt) % (D / 4)));
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % STAGES;
            const int rows = min(TILE, T - i * TILE);
            float* const rs = smem + s * SF;
            float* const ks = rs + TF;
            float* const ws = ks + TF;
            float* const vs = ws + TF;
            mbar_wait(smem_addr(full + s), (i / STAGES) & 1);
            // w = e^{logw}; rows past the end neutral (w = 1, k = v = 0).
#pragma unroll 4
            for (int e = pt; e < TF / 4; e += NP) {
                float4 w;
                if (e / (D / 4) < rows) {
                    w = ld4(ws + 4 * e);
                    w.x = ex2(w.x * LOG2E); w.y = ex2(w.y * LOG2E);
                    w.z = ex2(w.z * LOG2E); w.w = ex2(w.w * LOG2E);
                } else {
                    w = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
                    st4(ks + 4 * e, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
                    st4(vs + 4 * e, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
                }
                st4(ws + 4 * e, w);
            }
            float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (bt < rows) {
#pragma unroll
                for (int m = 0; m < UQ; ++m) {
                    const int f = 4 * ((bp + TP * m + TP * bt) % (D / 4));
                    const float4 rr = ld4(rs + bt * D + f), kk = ld4(ks + bt * D + f);
                    a[0] = fmaf(rr.x * uu[m].x, kk.x, a[0]);
                    a[1] = fmaf(rr.y * uu[m].y, kk.y, a[1]);
                    a[2] = fmaf(rr.z * uu[m].z, kk.z, a[2]);
                    a[3] = fmaf(rr.w * uu[m].w, kk.w, a[3]);
                }
            }
            float b = (a[0] + a[1]) + (a[2] + a[3]);
#pragma unroll
            for (int o = TP / 2; o > 0; o /= 2) b += __shfl_xor_sync(0xffffffffu, b, o);
            if (bp == 0) vs[TF + bt] = b;
            // This thread's writes precede the bulk copy that will refill
            // the slot; then the slot is ready.
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(ready + s);
            // Tile i + STAGES - 1 into the slot of tile i - 1, once the
            // consumers are done with it.
            const int n = i + STAGES - 1;
            if (pt == 0 && n < n_tiles) {
                if (n >= STAGES) mbar_wait(smem_addr(empty + n % STAGES), (n / STAGES - 1) & 1);
                load(n);
            }
        }
        return;
    }
    if (tid >= owners) return;

    // ---- consumer warps: the recurrence ------------------------------------
    // This thread's CPT columns j .. j + CPT - 1 and its rows 4 (q G + g) + e.
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane / GW;
    const int j = col0 + (warp * GW + lane % GW) * CPT;
    float S[R][CPT];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            load_n<CPT>(s0 + ((size_t)bh * D + 4 * (q * G + g) + e) * D + j, S[4 * q + e]);

    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int rows = min(TILE, T - i * TILE);
        const float* const rs = smem + s * SF;
        const float* const bs = rs + 4 * TF;
        mbar_wait(smem_addr(ready + s), (i / STAGES) & 1);
        for (int t0 = 0; t0 < rows; t0 += G) {
            float p[G][CPT];
            recur_group<D, G, CPT, TF>(rs, t0, g, j, S, p);
            butterfly<G, CPT>(p, g);     // lane g: token t0 + g
            const int t = t0 + g;
            if (t < rows) {
                float o[CPT];
                load_n<CPT>(rs + t * D + 3 * TF + j, o);
#pragma unroll
                for (int x = 0; x < CPT; ++x) o[x] = fmaf(bs[t], o[x], p[0][x]);
                store_n<CPT>(out + seq + (size_t)(i * TILE + t) * D + j, o);
            }
        }
        mbar_arrive(empty + s);
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            store_n<CPT>(s_out + ((size_t)bh * D + 4 * (q * G + g) + e) * D + j, S[4 * q + e]);
}

// ---------------------------------------------------------------------------
// The time-chunked form: a block per (sequence, chunk of L tokens).

constexpr int MAX_CHUNK = 256;       // tokens a chunk at most (a multiple of CHUNK_TILE)
constexpr int CHUNK_TILE = 16;       // tokens per ring slot
constexpr int CHUNK_STAGES = 2;      // ring slots
constexpr int CHUNK_PRODUCER_WARPS = 2;
constexpr int CHUNK_MIN_BLOCKS = 3;  // resident per SM (launch bounds)
constexpr int CHUNK_FLAGS = 8;       // flag words a (chunk, sequence): one a consumer warp

// The split of each head size in the chunked form: G threads per state
// column, CPT columns per thread; a block holds all D columns.
template <int D> struct ChunkSplit;
template <> struct ChunkSplit<16> { static constexpr int G = 4, CPT = 1; };
template <> struct ChunkSplit<64> { static constexpr int G = 8, CPT = 4; };

template <int D>
__host__ __device__ constexpr int chunk_consumers() {
    return D / ChunkSplit<D>::CPT * ChunkSplit<D>::G;
}

template <int D>
__host__ __device__ constexpr int chunk_threads() {
    return chunk_consumers<D>() + 32 * CHUNK_PRODUCER_WARPS;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned x;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(x) : "l"(p) : "memory");
    return x;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned x) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(x) : "memory");
}

// Row stride (floats) of the local read-outs in shared memory: padded so
// that the two tokens a quarter-warp stores fall in different banks.
template <int D> __host__ __device__ constexpr int ol_ld() { return D + 16; }

// Bytes of shared memory a chunk block takes at head size D for chunks of L
// tokens: the ring and u, r_t A_{t-1} and the local read-outs for the
// chunk's L tokens, the chunk's product of w, the ticket (padded to 16
// bytes), then the mbarriers full, ready and empty.
template <int D>
constexpr size_t chunks_smem_bytes(int L) {
    return (size_t)(CHUNK_STAGES * (4 * CHUNK_TILE * D + CHUNK_TILE) + D + L * D
                    + L * ol_ld<D>() + D + 4) * sizeof(float)
           + 3 * CHUNK_STAGES * sizeof(uint64_t);
}

template <int D>
__global__ void __launch_bounds__(chunk_threads<D>(), CHUNK_MIN_BLOCKS)
wkv6_chunks_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ out, float* __restrict__ s_out,
                   float* __restrict__ states, unsigned* __restrict__ sync, int BH,
                   int T, int L) {
    constexpr int G = ChunkSplit<D>::G, CPT = ChunkSplit<D>::CPT;
    constexpr int R = D / G, Q = R / 4, GW = 32 / G;
    constexpr int TILE = CHUNK_TILE, STAGES = CHUNK_STAGES;
    constexpr int TF = TILE * D, SF = 4 * TF + TILE;
    constexpr int NP = 32 * CHUNK_PRODUCER_WARPS;
    constexpr int CONSUMERS = chunk_consumers<D>();  // every column of the state
    constexpr int TP = NP / TILE;                    // bonus threads a token
    constexpr int UQ = D / (4 * TP);
    static_assert(R % 4 == 0 && GW * G == 32 && CONSUMERS % 32 == 0
                  && CONSUMERS / 32 <= CHUNK_FLAGS && TILE % G == 0 && UQ >= 1
                  && D % (4 * TP) == 0, "unsupported split");

    // [STAGES][r | k | w (logw on arrival) | v | bonus], u, r_t A_{t-1} (L,
    // D), the local read-outs (L rows of OL_LD), A (D), the ticket, then the
    // mbarriers full, ready, empty.
    constexpr int OL_LD = ol_ld<D>();
    extern __shared__ __align__(128) float smem[];
    float* const u_s = smem + STAGES * SF;
    float* const rp = u_s + D;
    float* const ol = rp + L * D;
    float* const a_s = ol + L * OL_LD;
    int* const ticket_s = reinterpret_cast<int*>(a_s + D);
    uint64_t* const full = reinterpret_cast<uint64_t*>(a_s + D + 4);
    uint64_t* const ready = full + STAGES;
    uint64_t* const empty = ready + STAGES;

    const int tid = threadIdx.x;
    if (tid == 0) {
        // Chunk order by ticket: chunk c of every sequence before chunk c + 1
        // of any, so the block this one waits for took its ticket first and
        // is running or done.
        *ticket_s = static_cast<int>(atomicAdd(sync, 1u));
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(ready + s, NP);
            mbar_init(empty + s, CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int ticket = *ticket_s;
    const int c = ticket / BH, bh = ticket % BH;
    const int nc = (T + L - 1) / L;
    const int t_begin = c * L;
    const int len = min(L, T - t_begin);
    const int n_tiles = (len + TILE - 1) / TILE;
    const size_t seq = (size_t)bh * T * D;
    // flags[(c * BH + bh) * CHUNK_FLAGS + w]: consumer warp w of chunk c has
    // published its part of S_start(c + 1).
    unsigned* const flags = sync + 1;
    for (int d = tid; d < D; d += blockDim.x) u_s[d] = u[(size_t)bh * D + d];
    __syncthreads();

    if (tid >= CONSUMERS) {
        // ---- producer warps: copy each tile in, then prepare it ------------
        const int pt = tid - CONSUMERS;
        auto load = [&](int i) {
            const int s = i % STAGES;
            const unsigned bytes = (unsigned)min(TILE, len - i * TILE) * D * sizeof(float);
            const unsigned bar = smem_addr(full + s);
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         :: "r"(bar), "r"(4 * bytes) : "memory");
            const size_t off = seq + (size_t)(t_begin + i * TILE) * D;
            const float* src[4] = {r + off, k + off, logw + off, v + off};
#pragma unroll
            for (int a = 0; a < 4; ++a)
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                    "[%0], [%1], %2, [%3];\n"
                    :: "r"(smem_addr(smem + s * SF + a * TF)), "l"(src[a]), "r"(bytes),
                       "r"(bar)
                    : "memory");
        };
        if (pt == 0)
            for (int i = 0; i < STAGES - 1 && i < n_tiles; ++i) load(i);
        // Each producer thread owns rows pt, pt + NP, ... of the tile: w =
        // e^{logw}, r_t A_{t-1} with A the product of w from the chunk's
        // start (rows past the end neutral: w = 1, k = v = 0, r A = 0);
        // then the bonus, TP threads a token, as in the columns kernel.
        constexpr int RPT = (D + NP - 1) / NP;      // rows a thread
        const int bt = pt / TP, bp = pt % TP;
        float4 uu[UQ];
#pragma unroll
        for (int m = 0; m < UQ; ++m)
            uu[m] = ld4(u_s + 4 * ((bp + TP * m + TP * bt) % (D / 4)));
        float A[RPT];
#pragma unroll
        for (int x = 0; x < RPT; ++x) A[x] = 1.0f;
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % STAGES;
            const int rows = min(TILE, len - i * TILE);
            float* const rs = smem + s * SF;
            float* const ks = rs + TF;
            float* const ws = ks + TF;
            float* const vs = ws + TF;
            mbar_wait(smem_addr(full + s), (i / STAGES) & 1);
#pragma unroll
            for (int x = 0; x < RPT; ++x) {
                const int d = pt + x * NP;
                if (d >= D) break;
                float* const rpi = rp + i * TF + d;
#pragma unroll 4
                for (int t = 0; t < TILE; ++t) {
                    const int e = t * D + d;
                    float w = 1.0f, ra = 0.0f;
                    if (t < rows) {
                        w = ex2(ws[e] * LOG2E);
                        ra = rs[e] * A[x];
                    } else {
                        ks[e] = 0.0f;
                        vs[e] = 0.0f;
                    }
                    ws[e] = w;
                    rpi[t * D] = ra;
                    A[x] *= w;
                }
                if (i == n_tiles - 1) a_s[d] = A[x];
            }
            {
                float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                if (bt < rows) {
#pragma unroll
                    for (int m = 0; m < UQ; ++m) {
                        const int f = 4 * ((bp + TP * m + TP * bt) % (D / 4));
                        const float4 rr = ld4(rs + bt * D + f), kk = ld4(ks + bt * D + f);
                        a[0] = fmaf(rr.x * uu[m].x, kk.x, a[0]);
                        a[1] = fmaf(rr.y * uu[m].y, kk.y, a[1]);
                        a[2] = fmaf(rr.z * uu[m].z, kk.z, a[2]);
                        a[3] = fmaf(rr.w * uu[m].w, kk.w, a[3]);
                    }
                }
                float b = (a[0] + a[1]) + (a[2] + a[3]);
#pragma unroll
                for (int o = TP / 2; o > 0; o /= 2) b += __shfl_xor_sync(0xffffffffu, b, o);
                if (bp == 0) vs[TF + bt] = b;
            }
            // This thread's writes precede the bulk copy that will refill
            // the slot; then the slot is ready.
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(ready + s);
            const int n = i + STAGES - 1;
            if (pt == 0 && n < n_tiles) {
                if (n >= STAGES) mbar_wait(smem_addr(empty + n % STAGES), (n / STAGES - 1) & 1);
                load(n);
            }
        }
        return;
    }

    // ---- consumer warps ----------------------------------------------------
    // This thread's CPT columns j .. j + CPT - 1 and its rows 4 (q G + g) + e.
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane / GW;
    const int j = (warp * GW + lane % GW) * CPT;
    float* const o_seq = out + seq + (size_t)t_begin * D;

    // The local pass: the recurrence from a zero state; each token's
    // read-out of the chunk's own tokens (and its bonus) goes to shared
    // memory, where the thread that stored it takes it back.
    float S[R][CPT];
#pragma unroll
    for (int e = 0; e < R; ++e)
#pragma unroll
        for (int x = 0; x < CPT; ++x) S[e][x] = 0.0f;
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int rows = min(TILE, len - i * TILE);
        const float* const rs = smem + s * SF;
        const float* const bs = rs + 4 * TF;
        mbar_wait(smem_addr(ready + s), (i / STAGES) & 1);
        for (int t0 = 0; t0 < rows; t0 += G) {
            float p[G][CPT];
            recur_group<D, G, CPT, TF>(rs, t0, g, j, S, p);
            butterfly<G, CPT>(p, g);     // lane g: token t0 + g
            const int t = t0 + g;
            if (t < rows) {
                float o[CPT];
                load_n<CPT>(rs + t * D + 3 * TF + j, o);
#pragma unroll
                for (int x = 0; x < CPT; ++x) o[x] = fmaf(bs[t], o[x], p[0][x]);
                store_n<CPT>(ol + (i * TILE + t) * OL_LD + j, o);
            }
        }
        mbar_arrive(empty + s);
    }

    // The state chain, warp by warp: each thread reads in S_start(c) the
    // entries that the same thread of chunk c - 1 wrote (s0 for the first
    // chunk), and writes its entries of S_start(c + 1) = diag(A) S_start(c)
    // + S (the local pass's end state), or of s_final for the last chunk.
    // A warp waits only on its counterpart's flag and publishes its own.
    const float* start = s0 + (size_t)bh * D * D;
    if (c > 0) {
        if (lane == 0)
            while (ld_acquire(flags + ((size_t)(c - 1) * BH + bh) * CHUNK_FLAGS + warp) == 0) {
            }
        __syncwarp();
        start = states + ((size_t)(c - 1) * BH + bh) * D * D;
    }
    float* const next = c == nc - 1 ? s_out + (size_t)bh * D * D
                                    : states + ((size_t)c * BH + bh) * D * D;
    float S0[R][CPT];
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = 4 * (q * G + g) + e;
            const float* const src = start + (size_t)row * D + j;
            if constexpr (CPT == 4) {
                const float4 x = __ldcg(reinterpret_cast<const float4*>(src));
                S0[4 * q + e][0] = x.x; S0[4 * q + e][1] = x.y;
                S0[4 * q + e][2] = x.z; S0[4 * q + e][3] = x.w;
            } else {
#pragma unroll
                for (int x = 0; x < CPT; ++x) S0[4 * q + e][x] = __ldcg(src + x);
            }
            const float a = a_s[row];
#pragma unroll
            for (int x = 0; x < CPT; ++x) S[4 * q + e][x] = fmaf(a, S0[4 * q + e][x], S[4 * q + e][x]);
            store_n<CPT>(next + (size_t)row * D + j, S[4 * q + e]);
        }
    if (c < nc - 1) {
        // The warp's stores, ordered by the warp barrier before lane 0's
        // release of the flag (the acquire above pairs with it).
        __syncwarp();
        if (lane == 0) st_release(flags + ((size_t)c * BH + bh) * CHUNK_FLAGS + warp, 1u);
    }

    // The correction: out_t = the local read-out + (r_t A_{t-1}) .
    // S_start(c), a (len, D) @ (D, D) product with the read-out's partial
    // sums and butterfly; each thread holds its entries of S_start(c), so
    // the warps go on at their own pace.
    for (int i = 0; i < n_tiles; ++i) {
        const int rows = min(TILE, len - i * TILE);
        for (int t0 = 0; t0 < rows; t0 += G) {
            const int t = t0 + g;
            float* const dst = o_seq + (size_t)(i * TILE + t) * D + j;
            float o[CPT];
            if (t < rows) load_n<CPT>(ol + (i * TILE + t) * OL_LD + j, o);
            float p[G][CPT];
            unroll<G>([&](auto tt_) {
                constexpr int tt = decltype(tt_)::value;
                const float* const row = rp + (i * TILE + t0 + tt) * D;
#pragma unroll
                for (int x = 0; x < CPT; ++x) p[tt][x] = 0.0f;
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                    const float4 rr = ld4(row + 4 * (q * G + g));
                    const float re[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
#pragma unroll
                        for (int x = 0; x < CPT; ++x)
                            p[tt][x] = fmaf(re[e], S0[4 * q + e][x], p[tt][x]);
                }
            });
            butterfly<G, CPT>(p, g);
            if (t < rows) {
#pragma unroll
                for (int x = 0; x < CPT; ++x) o[x] += p[0][x];
                store_n<CPT>(dst, o);
            }
        }
    }
}

template <int D>
cudaError_t launch_chunks(const void* r, const void* k, const void* v, const void* logw,
                          const void* u, const void* s0, void* out, void* s_out,
                          void* states, void* sync, int BH, int T, int L, int device,
                          cudaStream_t stream) {
    const long long blocks = (long long)BH * ((T + L - 1) / L);
    if (BH < 1 || T < 1 || L < CHUNK_TILE || L > MAX_CHUNK || L % CHUNK_TILE
            || blocks > 0x7fffffff || device < 0 || device >= MAX_DEVICES)
        return cudaErrorInvalidValue;
    static bool raised[MAX_DEVICES] = {};
    if (!raised[device]) {
        const cudaError_t err = cudaFuncSetAttribute(
            wkv6_chunks_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(chunks_smem_bytes<D>(MAX_CHUNK)));
        if (err != cudaSuccess) return err;
        raised[device] = true;
    }
    wkv6_chunks_kernel<D><<<static_cast<unsigned>(blocks), chunk_threads<D>(),
                            chunks_smem_bytes<D>(L), stream>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(logw),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(out), static_cast<float*>(s_out), static_cast<float*>(states),
        static_cast<unsigned*>(sync), BH, T, L);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* out,
                   void* s_out, int BH, int T, int C, int device,
                   cudaStream_t stream) {
    constexpr int G = Split<D>::G, CPT = Split<D>::CPT;
    if (BH < 1 || BH > 65535 || T < 1 || C < 1 || C > D || C % CPT
            || (C / CPT * G) % 32 || C / CPT * G > MAX_CONSUMERS
            || device < 0 || device >= MAX_DEVICES)
        return cudaErrorInvalidValue;
    constexpr int bytes = static_cast<int>(smem_bytes<D>());
    // Raised once per device (not again while a graph is captured).
    static bool raised[MAX_DEVICES] = {};
    if (!raised[device]) {
        const cudaError_t err = cudaFuncSetAttribute(
            wkv6_columns_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (err != cudaSuccess) return err;
        raised[device] = true;
    }
    wkv6_columns_kernel<D><<<dim3((D + C - 1) / C, BH),
                             C / CPT * G + 32 * PRODUCER_WARPS, bytes, stream>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(logw),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(out), static_cast<float*>(s_out), T, C);
    return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and does not synchronise.
// D is 16 or 64, split as Split<D> says.  C <= D columns a block (the last
// block of a sequence takes the rest), CPT divides C, and C / CPT * G is a
// multiple of 32 and at most 256; 1 <= BH <= 65535, T >= 1.  Every pointer
// is 16-byte aligned.  Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for an unsupported D or C):
// a refused launch never runs, and the caller must check the code.  The
// caller validates shapes, dtypes and contiguity.
extern "C" int wkv6_chunked(const void* r, const void* k, const void* v,
                            const void* logw, const void* u, const void* s0,
                            void* out, void* s_out, int BH, int T, int D,
                            int C, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return static_cast<int>(
            launch<16>(r, k, v, logw, u, s0, out, s_out, BH, T, C, device, s));
        case 64: return static_cast<int>(
            launch<64>(r, k, v, logw, u, s0, out, s_out, BH, T, C, device, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The words of the sync buffer that wkv6_time_chunks takes for BH sequences
// of T tokens in chunks of L: the ticket, then CHUNK_FLAGS flags (one a
// consumer warp) for each (chunk, sequence).  The caller allocates it.
extern "C" size_t wkv6_chunk_sync_words(int BH, int T, int L) {
    return 1 + (size_t)CHUNK_FLAGS * ((T + L - 1) / L) * BH;
}

// The time-chunked form: a block per (sequence, chunk of L tokens), L a
// multiple of 16 up to 256; states holds (ceil(T / L) - 1) * BH * D * D
// floats (the published chunk start states; unused where T <= L), sync the
// words wkv6_chunk_sync_words gives, zero at the launch.  Otherwise as
// wkv6_chunked.
extern "C" int wkv6_time_chunks(const void* r, const void* k, const void* v,
                                const void* logw, const void* u, const void* s0,
                                void* out, void* s_out, void* states, void* sync,
                                int BH, int T, int D, int L, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return static_cast<int>(launch_chunks<16>(
            r, k, v, logw, u, s0, out, s_out, states, sync, BH, T, L, device, s));
        case 64: return static_cast<int>(launch_chunks<64>(
            r, k, v, logw, u, s0, out, s_out, states, sync, BH, T, L, device, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Bytes of dynamic shared memory a block takes at head size D (0 for an
// unsupported D).
extern "C" int wkv6_smem_bytes(int D) {
    switch (D) {
        case 16: return static_cast<int>(smem_bytes<16>());
        case 64: return static_cast<int>(smem_bytes<64>());
        default: return 0;
    }
}

extern "C" const char* wkv6_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
