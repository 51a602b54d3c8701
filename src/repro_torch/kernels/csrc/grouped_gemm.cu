// Grouped GEMM for MoLe's Aug-Conv products (sm_90a).
//
//   out[g] = a[g] @ b[slot(g)],  slot(g) = clamp(gidx[g], 0, S - 1), or g
//                                when gidx is null
//   a (G, M, K), b (S, K, N), out (G, M, N), gidx (G,) int32 or null;
//   row-major and contiguous; a, b and out of one element type T.
//
// One kernel serves two TPU kernels of the reference, the Aug-Conv products
// with a wide output, through two entry points: grouped_sgemm (K2,
// slot-indexed, fp32) and gemm_typed (K5, gidx null, fp32 or bf16):
//   * grouped_aug_gemm (src/repro/kernels/grouped.py:157), K2: a = t
//     (G, B, K), b = the stacked Aug-Conv matrices c_acs (S, K, N), fp32;
//   * aug_gemm (src/repro/kernels/aug_gemm.py:41), K5: t (G, B, K) @
//     c_acs (G, K, N) or, at G = 1, the developer's T @ C^{ac}; gidx null.
// The morph products K1 and K4, narrow and deep, have their own split-K
// kernel in morph_gemm.cu.  K2 runs in fp32 only.  K5 takes fp32 or bf16,
// as the Pallas kernel does: bf16 is converted to fp32 on load, the
// products are fp32 FFMA into an fp32 accumulator, and each output is
// rounded once (__float2bfloat16_rn), so the result is the reference's
// einsum(..., preferred_element_type=f32).astype(bf16).
//
// The Pallas grouped kernels scalar-prefetch gidx and DMA the slot's tile
// out of the stack through an index_map.  Here each block reads its own
// gidx[g] from device memory and forms the slot's base pointer: no
// (G, K, N) gather copy exists.  The clamp is memory safety, not only
// parity: a pointer past slot S-1 reads out of bounds.  A null gidx means
// slot = group index, which serves K5's per-group operands with no index
// vector copied to the card per call.
//
// What bounds it on an H100 at the main-path shapes (VGG-16/CIFAR first
// layer, kappa = 1): K2 at G=4, B=64 and K5 at B=256 each do 103 GFLOP in
// fp32 (1.54 ms at 67 TFLOP/s) against 3.2 GB and 0.8 GB of weights (0.96
// and 0.24 ms at 3.35 TB/s): both are bound by fp32 FFMA issue, not by
// memory.  They launch 2,048 blocks, several resident on every SM (the
// morph products' 96 tiles would leave SMs idle; see morph_gemm.cu).  TF32
// tensor cores would be faster but keep only ~3 decimal digits; the
// reference accumulates in full fp32, so this kernel stays on FFMA, for
// bf16 operands too (they halve the bytes, not the FFMA work).
//
// Design: a classic register-blocked SGEMM.  A 64 x 128 output tile per
// block of 128 threads, each thread an 8 x 8 micro-tile (two 4-wide runs in
// each direction so shared-memory reads are float4 and conflict-light),
// BK = 8 slices of a and b staged (as fp32) in double-buffered shared
// memory, fp32 FFMA with an fp32 accumulator.  Every ragged edge of M, N and
// K is masked (loads fill zero, stores are skipped), so any shape runs.
// wgmma/TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 128;   // (BM / 8) * (BN / 8)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
grouped_gemm_kernel(const T* __restrict__ a, const int* __restrict__ gidx,
                    const T* __restrict__ b, T* __restrict__ out,
                    int M, int N, int K, int S) {
    const int g = blockIdx.z;
    int slot = g;
    if (gidx != nullptr) {
        slot = gidx[g];
        slot = slot < 0 ? 0 : (slot > S - 1 ? S - 1 : slot);
    }
    const T* A = a + (size_t)g * M * K;
    const T* B = b + (size_t)slot * K * N;
    T* C = out + (size_t)g * M * N;

    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    const int tid = threadIdx.x;

    __shared__ __align__(16) float As[2][BK][BM];   // a tile, transposed
    __shared__ __align__(16) float Bs[2][BK][BN];

    // Global -> register staging (converted to fp32 here).  a: thread loads
    // 4 consecutive k of row tid / 2.  b: thread loads column tid of each of
    // the BK rows (a warp reads one contiguous run of 32 elements per row).
    const int a_row = tid >> 1;
    const int a_k = (tid & 1) * 4;
    float ra[4];
    float rb[BK];

    auto load_global = [&](int k0) {
        const int r = row0 + a_row;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = k0 + a_k + i;
            ra[i] = (r < M && k < K) ? to_float(A[(size_t)r * K + k]) : 0.0f;
        }
        const int c = col0 + tid;
#pragma unroll
        for (int i = 0; i < BK; ++i) {
            const int k = k0 + i;
            rb[i] = (k < K && c < N) ? to_float(B[(size_t)k * N + c]) : 0.0f;
        }
    };
    auto store_shared = [&](int buf) {
#pragma unroll
        for (int i = 0; i < 4; ++i) As[buf][a_k + i][a_row] = ra[i];
#pragma unroll
        for (int i = 0; i < BK; ++i) Bs[buf][i][tid] = rb[i];
    };

    // Compute mapping: rows ty*4 + {0..3} and 32 + ty*4 + {0..3}; columns
    // tx*4 + {0..3} and 64 + tx*4 + {0..3}.
    const int ty = tid / 16;
    const int tx = tid % 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    const int ktiles = (K + BK - 1) / BK;
    if (ktiles > 0) {
        load_global(0);
        store_shared(0);
    }
    __syncthreads();

    for (int t = 0; t < ktiles; ++t) {
        const int cur = t & 1;
        if (t + 1 < ktiles) load_global((t + 1) * BK);
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][32 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
            const float af[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bf[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(af[i], bf[j], acc[i][j]);
        }
        // The other buffer was last read in iteration t - 1, which ended
        // with a barrier, so it is free to overwrite now.
        if (t + 1 < ktiles) store_shared(cur ^ 1);
        __syncthreads();
    }

    // Epilogue: the only rounding to T, once per output.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = row0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4));
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
            if (c < N) C[(size_t)r * N + c] = from_float<T>(acc[i][j]);
        }
    }
}

template <typename T>
int launch(const void* a, const void* gidx, const void* b, void* out, int G,
           int M, int N, int K, int S, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
    grouped_gemm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const int*>(gidx),
        static_cast<const T*>(b), static_cast<T*>(out), M, N, K, S);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` (PyTorch's current stream) and does
// not synchronise.  It returns cudaGetLastError() after the launch: a refused
// launch never runs, and the caller must check the code.  The caller
// validates shapes (G, M, N >= 1, grid limits), dtypes and contiguity before
// passing pointers.

// K2: slot-indexed, fp32.  gidx (G,) int32 into a stack of S slots.
extern "C" int grouped_sgemm(const void* a, const void* gidx, const void* b,
                             void* out, int G, int M, int N, int K, int S,
                             int device, void* stream) {
    return launch<float>(a, gidx, b, out, G, M, N, K, S, device, stream);
}

// K5: one matrix per group (b has G slots, slot = group index); fp32 or
// bf16 operands (bf16 != 0).
extern "C" int gemm_typed(const void* a, const void* b, void* out, int G,
                          int M, int N, int K, int bf16, int device,
                          void* stream) {
    return bf16 ? launch<__nv_bfloat16>(a, nullptr, b, out, G, M, N, K, G,
                                        device, stream)
                : launch<float>(a, nullptr, b, out, G, M, N, K, G, device,
                                stream);
}

extern "C" const char* grouped_gemm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
