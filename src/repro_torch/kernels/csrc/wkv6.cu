// RWKV-6 chunked linear-attention scan (sm_90a), fp32.
//
//   r, k, v, logw (BH, T, D) with logw <= 0; u (BH, D); s0 (BH, D, D)
//   [key x value]; out (BH, T, D); s_out (BH, D, D).  Row-major, contiguous.
//   For every chunk of L tokens (T % L == 0), with c = cumsum(logw) over the
//   chunk and c_{-1} = 0:
//
//     out_t = (r_t * e^{c_{t-1}}) S
//           + sum_{s<t} (sum_d r_td k_sd e^{c_{t-1,d} - c_{s,d}}) v_s
//           + (sum_d r_td u_d k_td) v_t
//     S    <- e^{c_{L-1}} * S + sum_s (k_s * e^{c_{L-1} - c_s})^T v_s
//
// Replaces the Pallas kernel wkv6_chunked (src/repro/kernels/wkv6.py:71):
// the same function, the same exponents, all <= 0 (c is non-increasing, and
// e^{a - b} is never split into e^{a} e^{-b}, which overflows).  The TPU
// kernel walks the chunks as a sequential grid axis and keeps the (D, D)
// state in VMEM between grid steps; blocks of a GPU share nothing, so here
// one block carries the state of its (b, h) through all chunks in a loop,
// in shared memory.  The (L, L, D) decay tensor is never stored: each
// exponential is computed where it is used.
//
// What bounds it on an H100.  The function itself is bound by bytes: at the
// prefill's shape (BH = 40 heads, T = 384) it must move 21 MB (0.006 ms),
// against 0.25 GFLOP of state read-out and update (0.004 ms) and 1 M decays
// that every exact form needs.  What bounds this design is its pairwise
// decays: a chunk takes L (L - 1) / 2 * D exponentials (520 K at L = 128,
// D = 64), 64 M at that shape (0.015 ms at 16 per SM per clock), several
// times what the boundary-referenced subchunk form of the reference
// (_wkv_intra_subchunked) needs; that form is left for a redesign.  What
// the design does:
//
//   * Parallelism.  At B = 1 there are only 40 (b, h) pairs for 132 SMs.
//     The grid is (BH, P): block p of a (b, h) owns the query rows
//     t = p, p + P, ... of every chunk.  The scores, the expensive part,
//     are split P ways with no overlap (interleaved rows balance the
//     triangle); every block of the (b, h) recomputes the cheap state update
//     (FMAs, L * D exponentials) to have the state its rows read.  Splitting
//     the value columns instead is also exact, but each block would then
//     recompute all the scores.  The wrapper picks P = min(8, SMs / BH).
//   * Exponentials.  Decays are kept in log2 units and raised with exp2f
//     (the SFU's ex2).  A thread owns one key row s: its k_s and c_s sit in
//     registers for the whole chunk, and the query side (r_t, c_{t-1}) is
//     read as 16-byte shared-memory broadcasts, so each exponential costs
//     half a shared load.
//   * Shared memory (at L = 128, D = 64, P = 1: 216 KB of the 227 KB):
//     r (own rows), k and c as [rows][D + 4] (16-byte rows, no bank
//     conflicts for row-wise or column-wise access), v [L][D], the state
//     [D][D], and the (rows, L) score tile of the block's own rows.
//   * Products are register-tiled 4 x 4 (read-out: 4 query rows x 4 value
//     columns; state update: 4 keys x 4 values) from float4 loads.
//   * The cumulative sum runs as a two-level scan: THREADS / D segments per
//     column, then the segment totals; rounding keeps it non-increasing.
//
// Left for later: a chunk-parallel form (scores of all chunks at once, then
// a short sequential pass over the states) would fill the card at any BH.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float at(const float4& x, int i) {
    return i == 0 ? x.x : (i == 1 ? x.y : (i == 2 ? x.z : x.w));
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ s_out,
            int T, int L, int P) {
    constexpr int DP = D + 4;            // padded row: 16-byte aligned
    constexpr int G4 = D / 4;            // float4 groups per row
    constexpr int SEG = THREADS / D;     // scan segments per column
    const int tid = threadIdx.x;
    const int bh = blockIdx.x;
    const int p = blockIdx.y;            // own query rows t = p + i * P
    const int rows_max = (L + P - 1) / P;
    const int nrows = (L - p + P - 1) / P;

    extern __shared__ float4 smem4[];
    float* rs = reinterpret_cast<float*>(smem4);  // [rows_max][DP]
    float* ks = rs + rows_max * DP;               // [L][DP]
    float* cs = ks + L * DP;                      // [L][DP]
    float* vs = cs + L * DP;                      // [L][D]
    float* Ss = vs + L * D;                       // [D][D]
    float* As = Ss + D * D;                       // [rows_max][L]
    float* tot = As + rows_max * L;               // [THREADS]
    float* us = tot + THREADS;                    // [D]
    float* wl = us + D;                           // [D]

    for (int e = tid; e < D * D; e += THREADS)
        Ss[e] = s0[(size_t)bh * D * D + e];
    if (tid < D) us[tid] = u[(size_t)bh * D + tid];

    const int n_chunks = T / L;
    for (int n = 0; n < n_chunks; ++n) {
        const size_t base = ((size_t)bh * T + (size_t)n * L) * D;
        // ---- load the chunk (c <- logw in log2 units) -------------------
        for (int e = tid; e < L * G4; e += THREADS) {
            const int s = e / G4, g = 4 * (e % G4);
            const size_t o = base + (size_t)s * D + g;
            st4(ks + s * DP + g, ld4(k + o));
            float4 w = ld4(logw + o);
            w.x *= LOG2E; w.y *= LOG2E; w.z *= LOG2E; w.w *= LOG2E;
            st4(cs + s * DP + g, w);
            st4(vs + s * D + g, ld4(v + o));
        }
        for (int e = tid; e < nrows * G4; e += THREADS) {
            const int i = e / G4, g = 4 * (e % G4);
            st4(rs + i * DP + g, ld4(r + base + (size_t)(p + i * P) * D + g));
        }
        __syncthreads();

        // ---- inclusive cumulative sum of c over the chunk ---------------
        {
            const int d = tid % D, g = tid / D;
            const int len = (L + SEG - 1) / SEG;
            const int s_lo = g * len, s_hi = min(L, s_lo + len);
            float acc = 0.0f;
            for (int s = s_lo; s < s_hi; ++s) {
                acc += cs[s * DP + d];
                cs[s * DP + d] = acc;
            }
            tot[g * D + d] = acc;
            __syncthreads();
            if (g > 0) {
                float pre = 0.0f;
                for (int h = 0; h < g; ++h) pre += tot[h * D + d];
                for (int s = s_lo; s < s_hi; ++s) cs[s * DP + d] = pre + cs[s * DP + d];
            }
            __syncthreads();
        }

        // ---- scores of the own rows: A[i][s], zero above the diagonal ----
        {
            const int q = THREADS / L;           // threads per key row
            if (tid < q * L) {
                const int s = tid % L, g = tid / L;
                float kr[D], cr[D];
#pragma unroll
                for (int j = 0; j < G4; ++j) {
                    const float4 kk = ld4(ks + s * DP + 4 * j);
                    const float4 cc = ld4(cs + s * DP + 4 * j);
                    kr[4 * j] = kk.x; kr[4 * j + 1] = kk.y;
                    kr[4 * j + 2] = kk.z; kr[4 * j + 3] = kk.w;
                    cr[4 * j] = cc.x; cr[4 * j + 1] = cc.y;
                    cr[4 * j + 2] = cc.z; cr[4 * j + 3] = cc.w;
                }
                for (int i = g; i < nrows; i += q) {
                    const int t = p + i * P;
                    const float* rt = rs + i * DP;
                    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // 4 independent chains
                    if (t > s) {
                        const float* ct = cs + (t - 1) * DP;
#pragma unroll
                        for (int j = 0; j < G4; ++j) {
                            const float4 rr = ld4(rt + 4 * j);
                            const float4 cc = ld4(ct + 4 * j);
#pragma unroll
                            for (int c = 0; c < 4; ++c)
                                a[c] = fmaf(at(rr, c) * kr[4 * j + c],
                                            exp2f(at(cc, c) - cr[4 * j + c]), a[c]);
                        }
                    } else if (t == s) {
#pragma unroll
                        for (int d = 0; d < D; ++d)
                            a[d % 4] = fmaf(rt[d] * us[d], kr[d], a[d % 4]);
                    }
                    As[i * L + s] = (a[0] + a[1]) + (a[2] + a[3]);
                }
            }
            if (tid < D) wl[tid] = exp2f(cs[(L - 1) * DP + tid]);
        }
        __syncthreads();

        // ---- decays: r_t *= e^{c_{t-1}}, k_s *= e^{c_{L-1} - c_s} ----------
        for (int e = tid; e < nrows * D; e += THREADS) {
            const int i = e / D, d = e % D, t = p + i * P;
            if (t > 0) rs[i * DP + d] *= exp2f(cs[(t - 1) * DP + d]);
        }
        for (int e = tid; e < L * D; e += THREADS) {
            const int s = e / D, d = e % D;
            ks[s * DP + d] *= exp2f(cs[(L - 1) * DP + d] - cs[s * DP + d]);
        }
        __syncthreads();

        // ---- out of the own rows: A v + r_dec S (4 rows x 4 columns) -----
        const int n_rt = (nrows + 3) / 4;
        for (int e = tid; e < n_rt * G4; e += THREADS) {
            const int i0 = 4 * (e / G4), j = 4 * (e % G4);
            int ir[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) ir[a] = min(i0 + a, nrows - 1);
            float acc[4][4] = {};
            const int t_max = p + ir[3] * P;
            for (int s = 0; s <= t_max; ++s) {
                const float4 vv = ld4(vs + s * D + j);
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const float x = As[ir[a] * L + s];
                    acc[a][0] = fmaf(x, vv.x, acc[a][0]);
                    acc[a][1] = fmaf(x, vv.y, acc[a][1]);
                    acc[a][2] = fmaf(x, vv.z, acc[a][2]);
                    acc[a][3] = fmaf(x, vv.w, acc[a][3]);
                }
            }
            for (int d = 0; d < D; ++d) {
                const float4 sv = ld4(Ss + d * D + j);
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const float x = rs[ir[a] * DP + d];
                    acc[a][0] = fmaf(x, sv.x, acc[a][0]);
                    acc[a][1] = fmaf(x, sv.y, acc[a][1]);
                    acc[a][2] = fmaf(x, sv.z, acc[a][2]);
                    acc[a][3] = fmaf(x, sv.w, acc[a][3]);
                }
            }
#pragma unroll
            for (int a = 0; a < 4; ++a)
                if (i0 + a < nrows)
                    st4(out + base + (size_t)(p + (i0 + a) * P) * D + j,
                        make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
        }

        // ---- state update (4 keys x 4 values per thread) -----------------
        const bool upd = tid < G4 * G4;
        float sn[4][4];
        const int d0 = 4 * (tid / G4), j0 = 4 * (tid % G4);
        if (upd) {
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const float4 sv = ld4(Ss + (d0 + a) * D + j0);
                const float w = wl[d0 + a];
                sn[a][0] = w * sv.x; sn[a][1] = w * sv.y;
                sn[a][2] = w * sv.z; sn[a][3] = w * sv.w;
            }
            for (int s = 0; s < L; ++s) {
                const float4 kk = ld4(ks + s * DP + d0);
                const float4 vv = ld4(vs + s * D + j0);
#pragma unroll
                for (int a = 0; a < 4; ++a) {
                    const float x = at(kk, a);
                    sn[a][0] = fmaf(x, vv.x, sn[a][0]);
                    sn[a][1] = fmaf(x, vv.y, sn[a][1]);
                    sn[a][2] = fmaf(x, vv.z, sn[a][2]);
                    sn[a][3] = fmaf(x, vv.w, sn[a][3]);
                }
            }
        }
        __syncthreads();                 // every read of the old state is done
        if (upd) {
#pragma unroll
            for (int a = 0; a < 4; ++a)
                st4(Ss + (d0 + a) * D + j0,
                    make_float4(sn[a][0], sn[a][1], sn[a][2], sn[a][3]));
        }
    }
    __syncthreads();
    if (p == 0)
        for (int e = tid; e < D * D; e += THREADS)
            s_out[(size_t)bh * D * D + e] = Ss[e];
}

template <int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* out,
                   void* s_out, int BH, int T, int L, int P,
                   cudaStream_t stream) {
    const int rows_max = (L + P - 1) / P;
    const size_t floats = (size_t)rows_max * (D + 4) + 2 * (size_t)L * (D + 4)
                          + (size_t)L * D + D * D + (size_t)rows_max * L
                          + THREADS + 2 * D;
    const int bytes = static_cast<int>(floats * sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    wkv6_kernel<D><<<dim3(BH, P), THREADS, bytes, stream>>>(
        static_cast<const float*>(r), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(logw),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(out), static_cast<float*>(s_out), T, L, P);
    return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and does not synchronise.
// D is 16 or 64; 1 <= L <= 128 with T % L == 0; 1 <= P <= L; BH >= 1.
// Every pointer is 16-byte aligned.  Returns cudaGetLastError() after the
// launch (or the error of an unsupported D): a refused launch never runs,
// and the caller must check the code.  The caller validates shapes, dtypes
// and contiguity before passing pointers.
extern "C" int wkv6_chunked(const void* r, const void* k, const void* v,
                            const void* logw, const void* u, const void* s0,
                            void* out, void* s_out, int BH, int T, int D,
                            int L, int P, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: err = launch<16>(r, k, v, logw, u, s0, out, s_out, BH, T, L, P, s); break;
        case 64: err = launch<64>(r, k, v, logw, u, s0, out, s_out, BH, T, L, P, s); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

extern "C" const char* wkv6_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
