// The key-row scan of the RWKV-6 gradient (sm_90a), fp32, in chunks of time
// run in parallel and chained.
//
//   x, logw (BH, T, D) with logw <= 0; y, z (BH, T, D); s0 (BH, D, D);
//   out (BH, T, D).  Row-major, contiguous.  A (D, D) state M per
//   sequence, from M = s0; at each token t, for every key row i:
//
//     out_t[i] = M[i, :] . z_t                       (read out, then)
//     M[i, :]  = w_t[i] M[i, :] + x_t[i] y_t,        w_t = e^{logw_t}
//
// Each key row carries its own scalar decay, so the rows share nothing.
// Replaces no Pallas kernel: the JAX package takes the scan's gradient by
// differentiating its XLA chunked form (src/repro/models/blocks.py:732,
// _wkv_chunked).  The port's backward of K6 (kernels/wkv6.py) runs this
// scan twice: forward with (x, y, z) = (k, v, dO) from s0, which gives
// S_{t-1} dO_t (the state part of dr), and over the flipped sequence with
// (r, dO, v) from dS_T, which gives G_t v_t (the state part of dk).
//
// What bounds it on an H100.  Bytes: x, logw, y and z are read once and out
// written once, 5 x 84 MB at the training shape (BH = 80, T = 4096,
// D = 64), 0.125 ms at 3.35 TB/s; its 2 BH T D^2 FFMA (2.7 G there) take
// 0.080 ms at 67 TFLOP/s.  A token recurrence per sequence cannot reach
// either there: 80 sequences of 64 rows leave the card's schedulers one or
// two warps each, every warp walking 4,096 tokens in series, latency-bound.
// So this kernel cuts each sequence into chunks of L tokens, with S_start(c)
// the state before chunk c, a_{t-1}[i] the product of w[i] over the chunk's
// tokens before t (1 at its first) and A(c)[i] over the whole chunk:
//
//   * Local pass, a block per (sequence, chunk) owning all D rows: the
//     recurrence above from a zero state, each token's read-out kept in
//     shared memory, ending with the chunk's state S_loc(c).  Producer warps
//     copy tiles of x, y and logw (a ring) and of z (kept for the whole
//     chunk) by cp.async.bulk and prepare each once for all rows: w =
//     e^{logw}, and a_{t-1}, kept for the correction.
//   * Chain, in chunk order: S_start(0) = s0, S_start(c + 1)[i, :] =
//     A(c)[i] S_start(c)[i, :] + S_loc(c)[i, :]; the last chunk publishes
//     nothing (the scan returns no final state).  Each consumer thread
//     reads the entries of S_start(c) that the same thread of chunk c - 1
//     wrote, so a warp waits on its counterpart's flag alone (ld.acquire)
//     and publishes its own (st.release after a warp barrier).  Blocks take
//     their chunk from an atomic ticket, chunk c of every sequence before
//     chunk c + 1 of any: a block waits only on a block that took its
//     ticket earlier and is running or done, whatever the grid's size.
//   * Correction: out_t[i] = the local read-out + a_{t-1}[i] (S_start(c)[i,
//     :] . z_t), an (L, D) @ (D, D)^T product per chunk, written to out once.
//
// Nothing is divided and no factor exceeds 1: strong decay underflows a to
// 0, as the recurrence decays the state.  No atomics touch the numbers: the
// same bits on every call.  The wrapper zeroes the sync words (the ticket, a
// flag a consumer warp of each (chunk, sequence)) before each launch.  The
// form issues 4 FMA-pipe instructions per (token, row, column): the
// read-out FMA, the product x_t[i] y_t[j], the decay-and-add FMA and the
// correction's FMA, 0.160 ms at the training shape: its own floor.
//
// The layout.  A consumer thread holds RPT neighbouring rows of one row
// group and D / G of their columns in registers, at columns 4 (q G + g) + e
// for lane g of the group's G, so that a group's lanes read G neighbouring
// 16-byte pieces of y_t and z_t (the groups of a warp read the same
// pieces).  Its partial read-outs for G tokens are summed across the G
// lanes by a butterfly that also scatters them ((G - 1) RPT shuffles per G
// tokens), leaving lane g with token g's sums for its RPT rows, one piece
// of a row of out.  In shared memory the local read-outs and a_{t-1} keep
// each token's row with its pieces permuted by the token (swz), so that the
// G tokens a warp stores at once fall in different banks without padding.
// Geometry (RowSplit, CHUNK, TILE, STAGES, PRODUCER_WARPS, MIN_BLOCKS: what
// tools/k6_probe.py rows variants patches): (G, RPT) = (8, 4) at D = 64,
// four consumer warps of 4 rows x 8 columns a thread, 2 producer warps,
// tiles of 16 tokens in a ring of 2; chunks of L = 64 tokens take 72 KB a
// block, three blocks an SM.  Ragged ends: the last
// tile copies only its rows; the rest are set to w = 1, x = y = z = 0,
// which leaves the state as it is, and their outputs are not stored.  T = 1
// is one such tile.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int CHUNK = 64;            // L, tokens a chunk (whole tiles)
constexpr int TILE = 16;             // tokens per ring slot
constexpr int STAGES = 2;            // ring slots
constexpr int PRODUCER_WARPS = 2;
constexpr int MIN_BLOCKS = 3;        // resident per SM (launch bounds)
constexpr int FLAGS = 8;             // flag words a (chunk, sequence): one a consumer warp
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

// The split of each head size: G lanes a row group, each holding D / G of
// its columns; RPT rows a group.
template <int D> struct RowSplit;
template <> struct RowSplit<16> { static constexpr int G = 4, RPT = 1; };
template <> struct RowSplit<64> { static constexpr int G = 8, RPT = 4; };

template <int D>
__host__ __device__ constexpr int consumers() {
    return D / RowSplit<D>::RPT * RowSplit<D>::G;
}

template <int D>
__host__ __device__ constexpr int threads() {
    return consumers<D>() + 32 * PRODUCER_WARPS;
}

// Bytes of shared memory a block takes at head size D: the ring (x, y, w),
// then z, a_{t-1} and the local read-outs for the chunk's L tokens, A (D),
// the ticket (padded to 16 bytes), then the mbarriers full, ready and empty.
template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
    return (size_t)(STAGES * 3 * TILE * D + 3 * CHUNK * D + D + 4) * sizeof(float)
           + 3 * STAGES * sizeof(uint64_t);
}
static_assert(CHUNK % TILE == 0, "a chunk is whole tiles");
static_assert(smem_bytes<64>() <= 232448, "a chunk exceeds a block's shared memory");

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

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned x;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(x) : "l"(p) : "memory");
    return x;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned x) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(p), "r"(x) : "memory");
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

// N consecutive floats (N = 1, 2 or a multiple of 4; p aligned to
// min(N, 4) floats) in 16-byte accesses where N allows.
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&o)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int k = 0; k < N / 4; ++k) {
            const float4 x = ld4(p + 4 * k);
            o[4 * k] = x.x; o[4 * k + 1] = x.y; o[4 * k + 2] = x.z; o[4 * k + 3] = x.w;
        }
    } else if constexpr (N == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        o[0] = x.x; o[1] = x.y;
    } else {
        static_assert(N == 1, "load_n: N is 1, 2 or a multiple of 4");
        o[0] = *p;
    }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&o)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int k = 0; k < N / 4; ++k)
            st4(p + 4 * k, make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]));
    } else if constexpr (N == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
    } else {
        static_assert(N == 1, "store_n: N is 1, 2 or a multiple of 4");
        *p = o[0];
    }
}

// Butterfly over a row group's G lanes (lane bits of GW * h): at each step
// a lane keeps the half of its tokens that its bit h of g selects and adds
// its partner's sums for them; lane g ends with token g's sums in p[0].
template <int G, int N>
__device__ __forceinline__ void butterfly(float (&p)[G][N], int g) {
    constexpr int GW = 32 / G;
    constexpr int LOG2_G = G == 2 ? 1 : G == 4 ? 2 : G == 8 ? 3 : 4;
    unroll<LOG2_G>([&](auto level_) {
        constexpr int h = G >> (decltype(level_)::value + 1);
        const unsigned upper = (g & h) ? 0xffffffffu : 0u;
        unroll<h>([&](auto y_) {
            constexpr int y = decltype(y_)::value;
#pragma unroll
            for (int x = 0; x < N; ++x) {
                const float lo = p[y][x], hi = p[y + h][x];
                p[y][x] = pick(lo, hi, upper)
                          + __shfl_xor_sync(0xffffffffu, pick(hi, lo, upper), h * GW);
            }
        });
    });
}

// Where token t's row i lies in the chunk-wide arrays of a_{t-1} and the
// local read-outs: row t, with its rows permuted by (t mod G) GW RPT (mod
// D).  After the butterfly the lanes of a warp hold G tokens' pieces, GW RPT
// neighbouring rows of each; the permutation puts the tokens' pieces in
// different banks.  It moves whole aligned groups of RPT rows.
template <int D>
__device__ __forceinline__ int swz(int t, int i) {
    constexpr int G = RowSplit<D>::G, GW = 32 / G;
    return t * D + (i ^ ((t % G) * GW * RowSplit<D>::RPT % D));
}

template <int D>
__global__ void __launch_bounds__(threads<D>(), MIN_BLOCKS)
wkv6_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ z, const float* __restrict__ logw,
                 const float* __restrict__ s0, float* __restrict__ out,
                 float* __restrict__ states, unsigned* __restrict__ sync, int BH,
                 int T) {
    constexpr int L = CHUNK;
    constexpr int G = RowSplit<D>::G, RPT = RowSplit<D>::RPT;
    constexpr int GW = 32 / G;           // row groups a warp
    constexpr int NC = D / G;            // columns a thread
    constexpr int Q = NC / 4;            // their 16-byte groups
    constexpr int TF = TILE * D;         // floats of one operand tile
    constexpr int SF = 3 * TF;           // a ring slot: x, y, w (logw on arrival)
    constexpr int NP = 32 * PRODUCER_WARPS;
    constexpr int CONSUMERS = consumers<D>();
    static_assert(NC % 4 == 0 && GW * G == 32 && (D & (D - 1)) == 0
                  && CONSUMERS % 32 == 0 && CONSUMERS / 32 <= FLAGS && TILE % G == 0
                  && (RPT == 1 || RPT == 2 || RPT % 4 == 0), "unsupported split");

    // [STAGES][x | y | w], z (L, D), a_{t-1} (L, D), the local read-outs
    // (L, D), A (D), the ticket, then the mbarriers full (the slot's copies
    // landed), ready (prepared) and empty (the consumers are done with it).
    extern __shared__ __align__(128) float smem[];
    float* const zc = smem + STAGES * SF;
    float* const ac = zc + L * D;
    float* const ol = ac + L * D;
    float* const a_s = ol + L * D;
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
    // flags[(c * BH + bh) * FLAGS + w]: consumer warp w of chunk c has
    // published its rows of S_start(c + 1).
    unsigned* const flags = sync + 1;

    if (tid >= CONSUMERS) {
        // ---- producer warps: copy each tile in, then prepare it ------------
        const int pt = tid - CONSUMERS;
        // Tile i's x, y and logw into slot i % STAGES and its z into the
        // chunk's z, counted on full.
        auto load = [&](int i) {
            const int s = i % STAGES;
            const unsigned bytes = (unsigned)min(TILE, len - i * TILE) * D * sizeof(float);
            const unsigned bar = smem_addr(full + s);
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         :: "r"(bar), "r"(4 * bytes) : "memory");
            const size_t off = seq + (size_t)(t_begin + i * TILE) * D;
            float* const slot = smem + s * SF;
            float* const dst[4] = {slot, slot + TF, slot + 2 * TF, zc + i * TF};
            const float* const src[4] = {x + off, y + off, logw + off, z + off};
#pragma unroll
            for (int a = 0; a < 4; ++a)
                asm volatile(
                    "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                    "[%0], [%1], %2, [%3];\n"
                    :: "r"(smem_addr(dst[a])), "l"(src[a]), "r"(bytes), "r"(bar)
                    : "memory");
        };
        if (pt == 0)
            for (int i = 0; i < STAGES - 1 && i < n_tiles; ++i) load(i);
        // Each producer thread owns rows pt, pt + NP, ... of the tile: w =
        // e^{logw} and a_{t-1}, the product of w from the chunk's start;
        // tokens past the end neutral (w = 1, x = y = z = 0).
        constexpr int RPP = (D + NP - 1) / NP;      // rows a producer thread
        float A[RPP];
#pragma unroll
        for (int r = 0; r < RPP; ++r) A[r] = 1.0f;
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % STAGES;
            const int rows = min(TILE, len - i * TILE);
            float* const xs = smem + s * SF;
            float* const ys = xs + TF;
            float* const ws = ys + TF;
            float* const zs = zc + i * TF;
            mbar_wait(smem_addr(full + s), (i / STAGES) & 1);
#pragma unroll
            for (int r = 0; r < RPP; ++r) {
                const int d = pt + r * NP;
                if (d >= D) break;
#pragma unroll 4
                for (int t = 0; t < TILE; ++t) {
                    const int e = t * D + d;
                    float w = 1.0f;
                    if (t < rows) {
                        w = ex2(ws[e] * LOG2E);
                    } else {
                        xs[e] = 0.0f;
                        ys[e] = 0.0f;
                        zs[e] = 0.0f;
                    }
                    ws[e] = w;
                    ac[swz<D>(i * TILE + t, d)] = A[r];
                    A[r] *= w;
                }
                if (i == n_tiles - 1) a_s[d] = A[r];
            }
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

    // ---- consumer warps ----------------------------------------------------
    // This thread's rows row0 .. row0 + RPT - 1 and columns 4 (q G + g) + e.
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane / GW;
    const int row0 = (warp * GW + lane % GW) * RPT;

    // The local pass: the recurrence from a zero state; each token's
    // read-out goes to shared memory, where the thread that stored it takes
    // it back.
    float M[RPT][NC];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int j = 0; j < NC; ++j) M[r][j] = 0.0f;
    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int rows = min(TILE, len - i * TILE);
        const float* const xs = smem + s * SF;
        const float* const ys = xs + TF;
        const float* const ws = ys + TF;
        const float* const zs = zc + i * TF;
        mbar_wait(smem_addr(ready + s), (i / STAGES) & 1);
        for (int t0 = 0; t0 < rows; t0 += G) {
            float p[G][RPT];
            unroll<G>([&](auto tt_) {
                constexpr int tt = decltype(tt_)::value;
                const int e = (t0 + tt) * D;
                float xr[RPT], wr[RPT];
                load_n<RPT>(xs + e + row0, xr);
                load_n<RPT>(ws + e + row0, wr);
#pragma unroll
                for (int r = 0; r < RPT; ++r) p[tt][r] = 0.0f;
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                    const int o = e + 4 * (q * G + g);
                    const float4 yy = ld4(ys + o), zz = ld4(zs + o);
                    const float ye[4] = {yy.x, yy.y, yy.z, yy.w};
                    const float ze[4] = {zz.x, zz.y, zz.z, zz.w};
#pragma unroll
                    for (int k = 0; k < 4; ++k)
#pragma unroll
                        for (int r = 0; r < RPT; ++r) {
                            float& m = M[r][4 * q + k];
                            p[tt][r] = fmaf(m, ze[k], p[tt][r]);
                            m = fmaf(wr[r], m, xr[r] * ye[k]);
                        }
                }
            });
            butterfly<G, RPT>(p, g);     // lane g: token t0 + g
            const int t = t0 + g;
            if (t < rows) store_n<RPT>(ol + swz<D>(i * TILE + t, row0), p[0]);
        }
        mbar_arrive(empty + s);
    }

    // The state chain, warp by warp: each thread reads in S_start(c) the
    // entries that the same thread of chunk c - 1 wrote (s0 for the first
    // chunk) and, but in the last chunk, writes its entries of S_start(c +
    // 1) = diag(A) S_start(c) + M (the local pass's end state).  A warp waits
    // only on its counterpart's flag and publishes its own.
    const float* start = s0 + (size_t)bh * D * D;
    if (c > 0) {
        if (lane == 0)
            while (ld_acquire(flags + ((size_t)(c - 1) * BH + bh) * FLAGS + warp) == 0) {
            }
        __syncwarp();
        start = states + ((size_t)(c - 1) * BH + bh) * D * D;
    }
    float S0[RPT][NC];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const float4 v = __ldcg(reinterpret_cast<const float4*>(
                start + (size_t)(row0 + r) * D + 4 * (q * G + g)));
            S0[r][4 * q] = v.x; S0[r][4 * q + 1] = v.y;
            S0[r][4 * q + 2] = v.z; S0[r][4 * q + 3] = v.w;
        }
    if (c < nc - 1) {
        float* const next = states + ((size_t)c * BH + bh) * D * D;
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const float a = a_s[row0 + r];
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                float n[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) n[k] = fmaf(a, S0[r][4 * q + k], M[r][4 * q + k]);
                st4(next + (size_t)(row0 + r) * D + 4 * (q * G + g),
                    make_float4(n[0], n[1], n[2], n[3]));
            }
        }
        // The warp's stores, ordered by the warp barrier before lane 0's
        // release of the flag (the acquire above pairs with it).
        __syncwarp();
        if (lane == 0) st_release(flags + ((size_t)c * BH + bh) * FLAGS + warp, 1u);
    }

    // The correction: out_t = the local read-out + a_{t-1} (S_start(c) .
    // z_t), with the read-out's partial sums and butterfly; each thread
    // holds its entries of S_start(c), so the warps go on at their own pace.
    float* const o_seq = out + seq + (size_t)t_begin * D;
    for (int t0 = 0; t0 < len; t0 += G) {
        const int t = t0 + g;
        float o[RPT] = {}, a[RPT] = {};
        if (t < len) {
            load_n<RPT>(ol + swz<D>(t, row0), o);
            load_n<RPT>(ac + swz<D>(t, row0), a);
        }
        float p[G][RPT];
        unroll<G>([&](auto tt_) {
            constexpr int tt = decltype(tt_)::value;
            const float* const zt = zc + (t0 + tt) * D;
#pragma unroll
            for (int r = 0; r < RPT; ++r) p[tt][r] = 0.0f;
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const float4 zz = ld4(zt + 4 * (q * G + g));
                const float ze[4] = {zz.x, zz.y, zz.z, zz.w};
#pragma unroll
                for (int k = 0; k < 4; ++k)
#pragma unroll
                    for (int r = 0; r < RPT; ++r)
                        p[tt][r] = fmaf(S0[r][4 * q + k], ze[k], p[tt][r]);
            }
        });
        butterfly<G, RPT>(p, g);
        if (t < len) {
#pragma unroll
            for (int r = 0; r < RPT; ++r) o[r] = fmaf(a[r], p[0][r], o[r]);
            store_n<RPT>(o_seq + (size_t)t * D + row0, o);
        }
    }
}

template <int D>
cudaError_t launch(const void* x, const void* y, const void* z, const void* logw,
                   const void* s0, void* out, void* states, void* sync, int BH, int T,
                   int device, cudaStream_t stream) {
    const long long blocks = (long long)BH * ((T + (long long)CHUNK - 1) / CHUNK);
    if (BH < 1 || T < 1 || blocks > 0x7fffffff || device < 0 || device >= MAX_DEVICES)
        return cudaErrorInvalidValue;
    // Raised once per device (not again while a graph is captured).
    static bool raised[MAX_DEVICES] = {};
    if (!raised[device]) {
        const cudaError_t err = cudaFuncSetAttribute(
            wkv6_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem_bytes<D>()));
        if (err != cudaSuccess) return err;
        raised[device] = true;
    }
    wkv6_rows_kernel<D><<<static_cast<unsigned>(blocks), threads<D>(), smem_bytes<D>(),
                          stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const float*>(logw),
        static_cast<const float*>(s0), static_cast<float*>(out),
        static_cast<float*>(states), static_cast<unsigned*>(sync), BH, T);
    return cudaGetLastError();
}

}  // namespace

// The chunk length L that wkv6_rows was built with: the caller's start-state
// workspace holds (ceil(T / L) - 1) BH D D floats.
extern "C" int wkv6_rows_chunk() { return CHUNK; }

// The words of the sync buffer that wkv6_rows takes for BH sequences of T
// tokens: the ticket, then FLAGS flags (one a consumer warp) for each
// (chunk, sequence); 0 for a shape it refuses.  The caller allocates it.
extern "C" size_t wkv6_rows_sync_words(int BH, int T) {
    if (BH < 1 || T < 1) return 0;
    return 1 + (size_t)FLAGS * ((T + (size_t)CHUNK - 1) / CHUNK) * BH;
}

// Launches on `stream` (PyTorch's current stream) and does not synchronise.
// D is 16 or 64; BH >= 1, T >= 1, and at most 2^31 - 1 blocks (BH ceil(T /
// L), L = wkv6_rows_chunk()).  states holds (ceil(T / L) - 1) BH D D floats
// (the published chunk start states; unused where T <= L), sync the words
// wkv6_rows_sync_words gives, zero at the launch.  Every pointer 16-byte
// aligned.  Returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for an unsupported D, BH or T): a refused launch
// never runs, and the caller must check the code.  The caller validates
// shapes, dtypes and contiguity.
extern "C" int wkv6_rows(const void* x, const void* y, const void* z,
                         const void* logw, const void* s0, void* out, void* states,
                         void* sync, int BH, int T, int D, int device,
                         void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return static_cast<int>(launch<16>(
            x, y, z, logw, s0, out, states, sync, BH, T, device, s));
        case 64: return static_cast<int>(launch<64>(
            x, y, z, logw, s0, out, states, sync, BH, T, device, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* wkv6_rows_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
