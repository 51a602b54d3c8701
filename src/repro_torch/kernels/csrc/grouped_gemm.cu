// Slot-indexed grouped SGEMM for the MoLe delivery engine (sm_90a).
//
//   out[g] = a[g] @ b[clamp(gidx[g], 0, S - 1)]
//   a (G, M, K), b (S, K, N), out (G, M, N), gidx (G,) int32; all fp32,
//   row-major and contiguous.
//
// One kernel serves both delivery kernels of the TPU reference:
//   * grouped_aug_gemm (src/repro/kernels/grouped.py:157): a = t (G, B, K),
//     b = the stacked Aug-Conv matrices c_acs (S, K, N);
//   * grouped_block_diag_matmul (src/repro/kernels/grouped.py:80): a = x
//     (G, B, kappa*q) viewed as (G, B*kappa, q), b = the stacked cores
//     (S, q, q) -- reshape(x[g], (B, kappa, q)) @ core is that product.
// The Pallas kernels scalar-prefetch gidx and DMA the slot's tile out of the
// stack through an index_map.  Here each block reads its own gidx[g] from
// device memory and forms the slot's base pointer: no (G, K, N) gather copy
// exists.  The clamp is memory safety, not only parity: a pointer past slot
// S-1 reads out of bounds.
//
// What bounds it on an H100 at the slice's main-path shape (VGG-16/CIFAR
// first layer, kappa = 1): grouped_aug_gemm at G=4, B=64, K=3072, N=65536
// reads 3.2 GB of weights (0.96 ms at 3.35 TB/s) and does 103 GFLOP in fp32
// (1.54 ms at 67 TFLOP/s): it is bound by fp32 FFMA issue, not by memory.
// TF32 tensor cores would be faster but keep only ~3 decimal digits; the
// reference accumulates in full fp32, so this kernel stays on FFMA.
//
// Design: a classic register-blocked SGEMM.  A 64 x 128 output tile per
// block of 128 threads, each thread an 8 x 8 micro-tile (two 4-wide runs in
// each direction so shared-memory reads are float4 and conflict-light),
// BK = 8 slices of a and b staged in double-buffered shared memory, fp32
// FFMA with an fp32 accumulator.  Every ragged edge of M, N and K is masked
// (loads fill zero, stores are skipped), so any shape runs.  wgmma/TMA and a
// split-K path for the narrow morph GEMM (q x q at small G*M) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int THREADS = 128;   // (BM / 8) * (BN / 8)

__global__ void __launch_bounds__(THREADS)
grouped_sgemm_kernel(const float* __restrict__ a, const int* __restrict__ gidx,
                     const float* __restrict__ b, float* __restrict__ out,
                     int M, int N, int K, int S) {
    const int g = blockIdx.z;
    int slot = gidx[g];
    slot = slot < 0 ? 0 : (slot > S - 1 ? S - 1 : slot);
    const float* A = a + (size_t)g * M * K;
    const float* B = b + (size_t)slot * K * N;
    float* C = out + (size_t)g * M * N;

    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    const int tid = threadIdx.x;

    __shared__ __align__(16) float As[2][BK][BM];   // a tile, transposed
    __shared__ __align__(16) float Bs[2][BK][BN];

    // Global -> register staging.  a: thread loads 4 consecutive k of row
    // tid / 2.  b: thread loads column tid of each of the BK rows (a warp
    // reads 128 contiguous bytes per row).
    const int a_row = tid >> 1;
    const int a_k = (tid & 1) * 4;
    float ra[4];
    float rb[BK];

    auto load_global = [&](int k0) {
        const int r = row0 + a_row;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int k = k0 + a_k + i;
            ra[i] = (r < M && k < K) ? A[(size_t)r * K + k] : 0.0f;
        }
        const int c = col0 + tid;
#pragma unroll
        for (int i = 0; i < BK; ++i) {
            const int k = k0 + i;
            rb[i] = (k < K && c < N) ? B[(size_t)k * N + c] : 0.0f;
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

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = row0 + (i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4));
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
            if (c < N) C[(size_t)r * N + c] = acc[i][j];
        }
    }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and does not synchronise.
// Returns cudaGetLastError() after the launch: a refused launch never runs,
// and the caller must check the code.  The caller validates shapes (G, M, N
// >= 1, grid limits), dtypes and contiguity before passing pointers.
extern "C" int grouped_sgemm(const void* a, const void* gidx, const void* b,
                             void* out, int G, int M, int N, int K, int S,
                             int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
    grouped_sgemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const int*>(gidx),
        static_cast<const float*>(b), static_cast<float*>(out), M, N, K, S);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* grouped_sgemm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
