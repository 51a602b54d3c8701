// Slot-indexed per-row GEMM for batched cross-tenant decode (sm_90a).
//
//   out[r, n] = sum_k h[r, k] * round_to(T, tables[clamp(gidx[r]), k, n])
//   h (R, K) of type T (fp32 or bf16), tables (S, K, N) fp32, gidx (R,)
//   int32, out (R, N) of type T; row-major and contiguous.  The sum is
//   accumulated in fp32 and rounded to T once.
//
// Replaces the Pallas kernel grouped_row_gemm (src/repro/kernels/grouped.py
// :206, which runs grouped_aug_gemm at B = bm = 1): the logits step of the
// continuous-batched decode lane, where row r is one tenant's sequence and
// tables[gidx[r]] that tenant's fused (d_model, V) Aug-head.  The table
// entries are rounded to the activation type before the product, as the
// reference's jnp path does (kernels/ref.py lm_head_rows_grouped_ref:
// w.astype(h.dtype)) and as the per-tenant models.stack.lm_head does, which
// batched decode must agree with.  (The Pallas path promotes a bf16 h
// against fp32 tables and skips that rounding; this kernel does not copy
// that.)  A row's slot index is clamped to [0, S-1], as the ops layer's
// _safe_gidx does: for the kernel the clamp is memory safety.
//
// What bounds it on an H100: decode-shaped, R rows each against its own
// K x N table, 2 flops per 4 table bytes.  At the decode lane's main path
// (R = 4, K = 4096, N = 102400) one call reads 6.71 GB of fp32 tables:
// 2.00 ms at 3.35 TB/s, against 3.4 GFLOP.  It is bound by memory, so the
// design is about keeping enough loads in flight:
//
//   * a block takes one row and a strip of BN = 1024 columns: 256 threads,
//     each owning 4 adjacent columns, read as one 16-byte load per table
//     row (a warp reads 512 contiguous bytes); 8 table rows' loads are
//     issued before their FMAs, so every thread keeps 128 bytes in flight;
//   * h[r] is staged in shared memory in chunks of KC values (8 KB), read
//     back as a broadcast;
//   * fp32 FFMA accumulators in registers, one rounding to T at the end;
//   * every ragged edge is masked: K needs no alignment; when N is not a
//     multiple of 4 (or the table is not 16-byte aligned) a scalar variant
//     with coalesced 4-byte loads runs instead.  Every shape launches.
//
// Rows that share a slot each read the table again, and there is no split-K
// (grid = N / 1024 x R blocks); TMA and slot-shared reads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 4;                  // columns per thread
constexpr int BN = THREADS * COLS;       // columns per block
constexpr int KC = 2048;                 // h values staged per chunk
constexpr int UNROLL = 8;                // table rows in flight per thread

template <typename T>
struct Act;

template <>
struct Act<float> {
    static __device__ __forceinline__ float load(const float* p) { return *p; }
    static __device__ __forceinline__ float round(float w) { return w; }
    static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Act<__nv_bfloat16> {
    static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
        return __bfloat162float(*p);
    }
    static __device__ __forceinline__ float round(float w) {
        return __bfloat162float(__float2bfloat16_rn(w));
    }
    static __device__ __forceinline__ __nv_bfloat16 store(float v) {
        return __float2bfloat16_rn(v);
    }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
row_gemm_kernel(const T* __restrict__ h, const int* __restrict__ gidx,
                const float* __restrict__ tables, T* __restrict__ out,
                int N, int K, int S) {
    const int r = blockIdx.y;
    int slot = gidx[r];
    slot = slot < 0 ? 0 : (slot > S - 1 ? S - 1 : slot);
    const float* W = tables + (size_t)slot * K * N;
    const T* hr = h + (size_t)r * K;

    // VEC: columns col0 .. col0 + 3 (N % 4 == 0, so all four or none are in
    // range).  Scalar: columns col0 + j * THREADS, each masked.
    const int col0 = VEC ? blockIdx.x * BN + threadIdx.x * COLS
                         : blockIdx.x * BN + threadIdx.x;
    bool live[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j)
        live[j] = VEC ? col0 < N : col0 + j * THREADS < N;

    __shared__ float hs[KC];
    float acc[COLS] = {0.0f, 0.0f, 0.0f, 0.0f};

    for (int k0 = 0; k0 < K; k0 += KC) {
        const int kn = min(KC, K - k0);
        __syncthreads();                 // the previous chunk is consumed
        for (int i = threadIdx.x; i < kn; i += THREADS)
            hs[i] = Act<T>::load(hr + k0 + i);
        __syncthreads();
        const float* p = W + (size_t)k0 * N + col0;
        if (VEC) {
            if (!live[0]) continue;
            int k = 0;
            for (; k + UNROLL <= kn; k += UNROLL) {
                float4 w[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u)
                    w[u] = __ldg(reinterpret_cast<const float4*>(p + (size_t)(k + u) * N));
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const float x = hs[k + u];
                    acc[0] = fmaf(x, Act<T>::round(w[u].x), acc[0]);
                    acc[1] = fmaf(x, Act<T>::round(w[u].y), acc[1]);
                    acc[2] = fmaf(x, Act<T>::round(w[u].z), acc[2]);
                    acc[3] = fmaf(x, Act<T>::round(w[u].w), acc[3]);
                }
            }
            for (; k < kn; ++k) {
                const float4 w = __ldg(reinterpret_cast<const float4*>(p + (size_t)k * N));
                const float x = hs[k];
                acc[0] = fmaf(x, Act<T>::round(w.x), acc[0]);
                acc[1] = fmaf(x, Act<T>::round(w.y), acc[1]);
                acc[2] = fmaf(x, Act<T>::round(w.z), acc[2]);
                acc[3] = fmaf(x, Act<T>::round(w.w), acc[3]);
            }
        } else {
            for (int k = 0; k < kn; ++k) {
                const float x = hs[k];
                const float* pk = p + (size_t)k * N;
#pragma unroll
                for (int j = 0; j < COLS; ++j)
                    if (live[j])
                        acc[j] = fmaf(x, Act<T>::round(__ldg(pk + j * THREADS)), acc[j]);
            }
        }
    }

    T* o = out + (size_t)r * N + col0;
#pragma unroll
    for (int j = 0; j < COLS; ++j)
        if (live[j]) o[VEC ? j : j * THREADS] = Act<T>::store(acc[j]);
}

template <typename T>
cudaError_t launch(const void* h, const void* gidx, const void* tables,
                   void* out, int R, int N, int K, int S, cudaStream_t stream) {
    const dim3 grid((N + BN - 1) / BN, R);
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(tables) % 16 == 0;
    if (vec)
        row_gemm_kernel<T, true><<<grid, THREADS, 0, stream>>>(
            static_cast<const T*>(h), static_cast<const int*>(gidx),
            static_cast<const float*>(tables), static_cast<T*>(out), N, K, S);
    else
        row_gemm_kernel<T, false><<<grid, THREADS, 0, stream>>>(
            static_cast<const T*>(h), static_cast<const int*>(gidx),
            static_cast<const float*>(tables), static_cast<T*>(out), N, K, S);
    return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and does not synchronise.
// `bf16` selects the type of h and out (0: fp32, 1: bf16).  Returns
// cudaGetLastError() after the launch: a refused launch never runs, and the
// caller must check the code.  The caller validates shapes (R, N, K >= 1,
// R within the grid limit), dtypes and contiguity before passing pointers.
extern "C" int row_gemm(const void* h, const void* gidx, const void* tables,
                        void* out, int R, int N, int K, int S, int bf16,
                        int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = bf16 ? launch<__nv_bfloat16>(h, gidx, tables, out, R, N, K, S, s)
               : launch<float>(h, gidx, tables, out, R, N, K, S, s);
    return static_cast<int>(err);
}

extern "C" const char* row_gemm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
