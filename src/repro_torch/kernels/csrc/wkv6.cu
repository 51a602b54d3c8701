// RWKV-6 linear-attention scan as a state-column recurrence (sm_90a), fp32.
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
            // Butterfly over the column group's G lanes (lane bits of
            // GW * h): at each step a lane keeps the half of its tokens
            // that its bit h of g selects and adds its partner's sums for
            // them; lane g ends with token t0 + g.
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
