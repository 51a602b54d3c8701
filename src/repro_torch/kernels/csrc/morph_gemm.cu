// Morph GEMM: MoLe's narrow, deep morph products K1 and K4 in bf16 or small
// fp32 (sm_90a), on the fp32 FFMA pipe.
//
//   out[g] = a[g] @ b[slot(g)],  slot(g) = clamp(gidx[g], 0, S - 1), or g
//                                when gidx is null
//   a (G, M, K), b (S, K, N), out (G, M, N), gidx (G,) int32 or null;
//   row-major and contiguous; a, b and out of one element type T.
//
// Replaces two TPU kernels of the reference, through two entry points:
//   * grouped_block_diag_matmul (src/repro/kernels/grouped.py:80), K1:
//     morph_sgemm, fp32, slot-indexed.  a = x (G, B, kappa*q) viewed as
//     (G, B*kappa, q), b = the stacked cores (S, q, q): reshape(x[g], (B,
//     kappa, q)) @ core is that product.  Each block reads its own gidx[g]
//     and clamps it (memory safety: a slot past S-1 reads out of bounds).
//     K1 keeps this route for now; aug_gemm.cu's split-TF32 GEMM is the
//     candidate, as it is for K4.
//   * block_diag_matmul (src/repro/kernels/block_diag.py:45), K4:
//     morph_gemm_typed, gidx null (slot = group index), bf16, and fp32
//     products under 3 GFLOP (kernels/gemm.py morph_route): larger fp32
//     morphs, every main path's, run on aug_gemm.cu's split-TF32 GEMM
//     (aug_sgemm_split), whose tensor cores outrun this loop's 67 TFLOP/s
//     ceiling; below that size its split pass and extra launch cost more
//     than they save.  bf16 is converted to fp32 when read from shared
//     memory, the products are fp32 FFMA into fp32 sums, and each output is
//     rounded to T once (__float2bfloat16_rn), as einsum(...,
//     preferred_element_type=f32).astype(bf16) in the reference.
//
// What bounds it on an H100.  At K1's main-path shape (x (4, 64, 3072) @ 4
// cores (3072, 3072)), q = K = N = 3072 and 256 rows in all: 4.83 GFLOP of
// fp32 FFMA (0.072 ms at 67 TFLOP/s, TF32 off as the reference accumulates
// in fp32), against 151 MB of reads (four cores, more than the 50 MB L2;
// 0.045 ms): bound by FFMA issue, provided the card is full and the core
// reads stay in flight while the FMAs run.  The output is narrow (96
// tiles of 64 x 128) and the reduction long, so tiles alone leave most SMs
// idle: a plain tiled FFMA GEMM (64 x 128 tiles, 96 blocks of 4 warps) ran
// at 27% of the FFMA peak here.
//
// Design:
//   * Split-K.  The wrapper splits K into `splits` slices of `kslice` (a
//     multiple of BK; the last slice takes the rest) by a rule from the
//     shape and the SM count (kernels/gemm.py, morph_splits); grid (N tiles
//     * splits, M tiles, G).  At the main shapes 4 slices give 384 blocks,
//     three (12 warps) on most SMs.  With one slice a block rounds its tile
//     to T and writes it: one launch.  With more, each block writes its fp32
//     partial tile to a workspace ws (splits, G, M, N) that the wrapper
//     allocates, and a second kernel adds the partials in the fixed order
//     0..splits-1 and rounds each output to T once: two launches, no
//     atomics, the same bits on every call.  The second is a programmatic
//     dependent launch, so its launch overlaps the first one's tail.  (Summing in the last block to
//     reach a tile, behind an int counter, saves the second launch, but on
//     an H100 its extra registers changed the main loop's allocation and
//     cost more time than the launch.)
//   * Pipeline.  BK = 16, STAGES = 3: the a and b tiles of two k-steps are
//     in flight (cp.async, 16-byte copies, L1 bypassed) while the third is
//     multiplied; one barrier per 16 k.  A copy whose source lies past an
//     edge is zero-filled.  An operand whose rows are not 16-byte aligned
//     (K or N not a multiple of 16 / sizeof(T), or a base pointer off 16)
//     is loaded by masked scalar copies inside the same kernel.  Each core
//     element is read from device memory by one block per row tile: once
//     for K1, whose groups have 64 rows.
//   * Inner product.  128 threads, each an 8 x 8 register micro-tile: rows
//     ty + 8i, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}.  The a tile
//     keeps its k-major rows, padded by 16 bytes so that a warp's two rows
//     fall in different banks; a thread reads 4 k of each of its rows and
//     one b row's 8 columns per k as 16-byte (8-byte for bf16) shared
//     loads: 4 such loads per 64 FFMA.  What holds the FFMA rate below its
//     peak on an H100 is register bank conflicts, not shared memory (wider
//     micro-tiles, with fewer shared loads per FFMA, ran no faster): FFMAs
//     whose two operands not held in the reuse cache share a bank.  Two
//     choices cut them: the columns of each row are walked in zig-zag order
//     (forward on even rows, backward on odd), so a change of row can reuse
//     the b register; and the accumulators are stored as scalars, so the
//     register allocator may give them the other bank than their b operands
//     (a 16-byte store pins four accumulators to an aligned quad, the bank
//     pattern of the b fragment that a 16-byte shared load fills).
//   * __launch_bounds__(128, 3): at most 170 registers, 39,936 bytes of
//     static shared memory (fp32) per block, so three blocks fit an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 8;                   // rows per thread: ty + RS * i
constexpr int TN = 8;                   // columns per thread, in runs of 4
constexpr int CR = TN / 4;              // column runs, BN / CR apart
constexpr int TX = BN / TN;             // threads along a tile row
constexpr int RS = BM / TM;             // threads along a tile column
constexpr int THREADS = RS * TX;        // 128
constexpr int STAGES = 3;
constexpr int MIN_BLOCKS = 3;           // resident per SM
constexpr int REDUCE_THREADS = 256;

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Four consecutive elements of shared memory as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);   // little-endian pairs
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Four consecutive outputs, each rounded to T once.
__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) = make_uint2(
        *reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// 16-byte asynchronous copy global -> shared; `in` false zero-fills the
// destination and reads nothing (src is then any valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
morph_gemm_kernel(const T* __restrict__ a, const int* __restrict__ gidx,
                  const T* __restrict__ b, T* __restrict__ out,
                  float* __restrict__ ws, int M, int N, int K, int S,
                  int kslice, int ntiles_n) {
    constexpr int CH = 16 / sizeof(T);     // elements per 16-byte copy
    constexpr int A_LD = BK + CH;          // a tile row, padded by 16 bytes
    constexpr int A_CHUNKS = BM * BK / CH / THREADS;
    constexpr int B_CHUNKS = BK * BN / CH / THREADS;
    static_assert(BM * BK % (CH * THREADS) == 0 && BK * BN % (CH * THREADS) == 0,
                  "tiles must split evenly into 16-byte copies");
    __shared__ __align__(16) T As[STAGES][BM * A_LD];
    __shared__ __align__(16) T Bs[STAGES][BK * BN];

    const int g = blockIdx.z;
    int slot = g;
    if (gidx != nullptr) {
        slot = gidx[g];
        slot = slot < 0 ? 0 : (slot > S - 1 ? S - 1 : slot);
    }
    const int split = blockIdx.x / ntiles_n;
    const int col0 = (blockIdx.x - split * ntiles_n) * BN;
    const int row0 = blockIdx.y * BM;
    const int k_begin = split * kslice;
    const int k_end = min(K, k_begin + kslice);
    const T* A = a + (size_t)g * M * K;
    const T* B = b + (size_t)slot * K * N;
    const int tid = threadIdx.x;

    // Row starts are 16-byte aligned iff the base is and the row length is
    // a multiple of CH; then every in-range copy is a whole 16 bytes, since
    // k_end is K or a multiple of BK.
    const bool a_vec = aligned16(a) && K % CH == 0;
    const bool b_vec = aligned16(b) && N % CH == 0;
    const T zero = from_float<T>(0.0f);

    auto load_tile = [&](int stage, int k0) {
        T* as = As[stage];
        T* bs = Bs[stage];
        if (a_vec) {
#pragma unroll
            for (int i = 0; i < A_CHUNKS; ++i) {
                const int c = tid + i * THREADS;
                const int r = c / (BK / CH), kc = (c % (BK / CH)) * CH;
                const int gr = row0 + r, gk = k0 + kc;
                const bool in = gr < M && gk < k_end;
                cp_async16(as + r * A_LD + kc, in ? A + (size_t)gr * K + gk : A, in);
            }
        } else {
            for (int e = tid; e < BM * BK; e += THREADS) {
                const int r = e / BK, kk = e % BK;
                const int gr = row0 + r, gk = k0 + kk;
                as[r * A_LD + kk] = (gr < M && gk < k_end) ? A[(size_t)gr * K + gk] : zero;
            }
        }
        if (b_vec) {
#pragma unroll
            for (int i = 0; i < B_CHUNKS; ++i) {
                const int c = tid + i * THREADS;
                const int kr = c / (BN / CH), nc = (c % (BN / CH)) * CH;
                const int gk = k0 + kr, gn = col0 + nc;
                const bool in = gk < k_end && gn < N;
                cp_async16(bs + kr * BN + nc, in ? B + (size_t)gk * N + gn : B, in);
            }
        } else {
            for (int e = tid; e < BK * BN; e += THREADS) {
                const int kr = e / BN, n = e % BN;
                const int gk = k0 + kr, gn = col0 + n;
                bs[kr * BN + n] = (gk < k_end && gn < N) ? B[(size_t)gk * N + gn] : zero;
            }
        }
    };

    const int ty = tid / TX;
    const int tx = tid % TX;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    // Slices are non-empty (the wrapper checks), so ktiles >= 1.
    const int ktiles = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ktiles) load_tile(s, k_begin + s * BK);
        cp_async_commit();
    }

    for (int t = 0; t < ktiles; ++t) {
        // Tile t has landed (this thread's copies); the barrier makes every
        // thread's copies and scalar stores visible, and frees the stage
        // that iteration t - 1 read.
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int next = t + STAGES - 1;
        if (next < ktiles) load_tile(next % STAGES, k_begin + next * BK);
        cp_async_commit();

        const T* as = As[t % STAGES];
        const T* bs = Bs[t % STAGES];
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
            float af[TM][4];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                const float4 v = load4(as + (ty + RS * i) * A_LD + kk);
                af[i][0] = v.x;
                af[i][1] = v.y;
                af[i][2] = v.z;
                af[i][3] = v.w;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float bf[TN];
#pragma unroll
                for (int r = 0; r < CR; ++r) {
                    const float4 v = load4(bs + (kk + j) * BN + r * (BN / CR) + tx * 4);
                    bf[4 * r] = v.x;
                    bf[4 * r + 1] = v.y;
                    bf[4 * r + 2] = v.z;
                    bf[4 * r + 3] = v.w;
                }
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int cc = 0; cc < TN; ++cc) {
                        const int c = i % 2 ? TN - 1 - cc : cc;   // zig-zag
                        acc[i][c] = fmaf(af[i][j], bf[c], acc[i][c]);
                    }
            }
        }
    }

    // Epilogue: scalar stores (coalesced across the warp), for the register
    // allocation reason above.  With one slice they are the only rounding
    // to T; else they write this slice's fp32 partial.
    const size_t tile_off = (size_t)g * M * N;
    auto write = [&](auto* dst) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int r = row0 + ty + RS * i;
            if (r >= M) continue;
#pragma unroll
            for (int h = 0; h < CR; ++h) {
                const int c = col0 + h * (BN / CR) + tx * 4;
                auto* p = dst + (size_t)r * N + c;
                for (int j = 0; j < 4 && c + j < N; ++j)
                    p[j] = from_float<std::remove_reference_t<decltype(*p)>>(acc[i][h * 4 + j]);
            }
        }
    };
    if (ws == nullptr) {
        write(out + tile_off);
    } else {
        write(ws + (size_t)split * gridDim.z * M * N + tile_off);
    }
}

// out[i] = T(ws[0][i] + ws[1][i] + ... + ws[splits-1][i]), in that order;
// four consecutive outputs per thread (16-byte loads of each slice) when n
// is a multiple of 4, else one.  Launched as a programmatic dependent of the
// tile kernel: it may start while that kernel drains, and waits here until
// the tile kernel has finished and its stores are visible.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
morph_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                    size_t n, int splits) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const size_t stride = (size_t)gridDim.x * REDUCE_THREADS;
    const size_t first = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (n % 4 == 0) {
        const float4* w = reinterpret_cast<const float4*>(ws);
        for (size_t i = first; i < n / 4; i += stride) {
            float4 s = w[i];
#pragma unroll 4
            for (int j = 1; j < splits; ++j) {
                const float4 v = w[j * (n / 4) + i];
                s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
            }
            store4(out + 4 * i, s);
        }
    } else {
        for (size_t i = first; i < n; i += stride) {
            float s = ws[i];
#pragma unroll 4
            for (int j = 1; j < splits; ++j) s += ws[j * n + i];
            out[i] = from_float<T>(s);
        }
    }
}

template <typename T>
int launch(const void* a, const void* gidx, const void* b, void* out, void* ws,
           int G, int M, int N, int K, int S, int splits, int kslice,
           int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    // Three blocks of 39 KB (fp32) need the shared-memory carveout, not L1.
    err = cudaFuncSetAttribute(morph_gemm_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int ntiles_n = (N + BN - 1) / BN;
    const dim3 grid(ntiles_n * splits, (M + BM - 1) / BM, G);
    morph_gemm_kernel<T><<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(a), static_cast<const int*>(gidx),
        static_cast<const T*>(b), static_cast<T*>(out),
        splits > 1 ? static_cast<float*>(ws) : nullptr, M, N, K, S, kslice,
        ntiles_n);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const size_t n = (size_t)G * M * N;
    const size_t items = n % 4 == 0 ? n / 4 : n;
    const unsigned blocks = static_cast<unsigned>(
        std::min<size_t>((items + REDUCE_THREADS - 1) / REDUCE_THREADS, 8192));
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(REDUCE_THREADS);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, morph_reduce_kernel<T>,
                             static_cast<const float*>(ws), static_cast<T*>(out),
                             n, splits);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry point launches on `stream` (PyTorch's current stream) and does
// not synchronise.  It returns cudaGetLastError() after each launch: a
// refused launch never runs, and the caller must check the code.  The caller
// validates shapes (G, M, N, K >= 1, grid limits), dtypes and contiguity,
// and passes splits >= 1 slices of kslice (a multiple of 16) that are all
// non-empty, with ws of splits * G * M * N floats when splits > 1 (ignored,
// may be null, when splits == 1).  With splits > 1 a call is two launches.

// K1: slot-indexed, fp32.  gidx (G,) int32 into a stack of S slots.
extern "C" int morph_sgemm(const void* a, const void* gidx, const void* b,
                           void* out, void* ws, int G, int M, int N, int K,
                           int S, int splits, int kslice, int device,
                           void* stream) {
    return launch<float>(a, gidx, b, out, ws, G, M, N, K, S, splits, kslice,
                         device, stream);
}

// K4: one matrix per group (b has G slots, slot = group index); fp32 or
// bf16 operands (bf16 != 0).  K4 passes x viewed as (G, rows*kappa, q).
extern "C" int morph_gemm_typed(const void* a, const void* b, void* out,
                                void* ws, int G, int M, int N, int K, int bf16,
                                int splits, int kslice, int device,
                                void* stream) {
    return bf16 ? launch<__nv_bfloat16>(a, nullptr, b, out, ws, G, M, N, K, G,
                                        splits, kslice, device, stream)
                : launch<float>(a, nullptr, b, out, ws, G, M, N, K, G, splits,
                                kslice, device, stream);
}

extern "C" const char* morph_gemm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
