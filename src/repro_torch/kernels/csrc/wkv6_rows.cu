// The key-row scan of the RWKV-6 gradient (sm_90a), fp32.
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
// 0.080 ms at 67 TFLOP/s.  This form runs about 3 fp32 instructions per
// (token, row, column): the read-out FMA, the product x_t[i] y_t[j] and
// the decay-and-add FMA.  The design is the simple one:
//
//   * A block owns one sequence and ROWS key rows (grid (D / ROWS, BH)).
//     Each row is split over G = 4 neighbouring lanes that hold D / G of
//     its columns in registers for the whole sequence, at columns
//     4 (q G + g) + e, so that a row's lanes read four neighbouring
//     16-byte pieces of y_t and z_t from shared memory (the rows of a warp
//     read the same pieces: broadcasts, no conflict).
//   * Tiles of TILE tokens of y, z and the block's columns of x and logw
//     are copied into shared memory by cp.async, two slots, the next tile
//     in flight while the block runs the current one.
//   * A row's partial read-outs are summed across its G lanes by two xor
//     shuffles; its first lane stores the sum.  Each lane takes w_t[i] as
//     one ex2 of its row's logw (the G lanes of a row repeat it).
//   * Ragged ends: the last tile copies only its T % TILE tokens and the
//     loop stops there.  T = 1 is one such tile.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 32;         // tokens per shared-memory slot
constexpr int G = 4;             // lanes per key row
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

// Key rows per block, per head size (64 threads at D = 16, 128 at D = 64).
template <int D> struct Rows;
template <> struct Rows<16> { static constexpr int value = 16; };
template <> struct Rows<64> { static constexpr int value = 32; };

// Floats of one slot: y and z tiles (TILE x D), x and logw tiles
// (TILE x ROWS).
template <int D>
__host__ __device__ constexpr int slot_floats() {
    return TILE * (2 * D + 2 * Rows<D>::value);
}

template <int D>
constexpr size_t smem_bytes() { return 2 * (size_t)slot_floats<D>() * sizeof(float); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// 2^x on the SFU (ex2.approx: within a few units in the last place).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

template <int D>
__global__ void __launch_bounds__(Rows<D>::value * G)
wkv6_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ z, const float* __restrict__ logw,
                 const float* __restrict__ s0, float* __restrict__ out, int T) {
    constexpr int ROWS = Rows<D>::value;
    constexpr int NT = ROWS * G;         // threads
    constexpr int Q = D / G / 4;         // a lane's 16-byte column groups
    constexpr int SLOT = slot_floats<D>();
    static_assert(D % (4 * G) == 0 && ROWS % 4 == 0 && NT % 32 == 0,
                  "unsupported head size");

    // Two slots of [y | z | x | logw].
    extern __shared__ __align__(16) float smem[];

    const int tid = threadIdx.x;
    const int bh = blockIdx.y;
    const int i0 = blockIdx.x * ROWS;
    const int row = tid / G, g = tid % G;
    const int i = i0 + row;
    const size_t seq = (size_t)bh * T * D;
    const int n_tiles = (T + TILE - 1) / TILE;

    // Tile n of y and z (whole token rows, contiguous) and of the block's
    // columns of x and logw into slot n % 2, as one copy group.
    auto load = [&](int n) {
        float* const ys = smem + (n & 1) * SLOT;
        float* const zs = ys + TILE * D;
        float* const xs = zs + TILE * D;
        float* const ls = xs + TILE * ROWS;
        const int rows = min(TILE, T - n * TILE);
        const size_t off = seq + (size_t)n * TILE * D;
        for (int e = tid; e < rows * D / 4; e += NT) {
            cp_async16(ys + 4 * e, y + off + 4 * e);
            cp_async16(zs + 4 * e, z + off + 4 * e);
        }
        for (int e = tid; e < rows * ROWS / 4; e += NT) {
            const int t = e / (ROWS / 4), c = 4 * (e % (ROWS / 4));
            cp_async16(xs + t * ROWS + c, x + off + (size_t)t * D + i0 + c);
            cp_async16(ls + t * ROWS + c, logw + off + (size_t)t * D + i0 + c);
        }
        cp_async_commit();
    };

    load(0);
    // This lane's columns 4 (q G + g) + e of row i.
    float M[Q][4];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const float4 m = ld4(s0 + ((size_t)bh * D + i) * D + 4 * (q * G + g));
        M[q][0] = m.x; M[q][1] = m.y; M[q][2] = m.z; M[q][3] = m.w;
    }

    for (int n = 0; n < n_tiles; ++n) {
        if (n + 1 < n_tiles) {
            load(n + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* const ys = smem + (n & 1) * SLOT;
        const float* const zs = ys + TILE * D;
        const float* const xs = zs + TILE * D;
        const float* const ls = xs + TILE * ROWS;
        const int rows = min(TILE, T - n * TILE);
        for (int t = 0; t < rows; ++t) {
            const float xi = xs[t * ROWS + row];
            const float wi = ex2(ls[t * ROWS + row] * LOG2E);
            float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int c = 4 * (q * G + g);
                const float4 zz = ld4(zs + t * D + c), yy = ld4(ys + t * D + c);
                p[0] = fmaf(M[q][0], zz.x, p[0]);
                p[1] = fmaf(M[q][1], zz.y, p[1]);
                p[2] = fmaf(M[q][2], zz.z, p[2]);
                p[3] = fmaf(M[q][3], zz.w, p[3]);
                M[q][0] = fmaf(wi, M[q][0], xi * yy.x);
                M[q][1] = fmaf(wi, M[q][1], xi * yy.y);
                M[q][2] = fmaf(wi, M[q][2], xi * yy.z);
                M[q][3] = fmaf(wi, M[q][3], xi * yy.w);
            }
            float s = (p[0] + p[1]) + (p[2] + p[3]);
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (g == 0) out[seq + (size_t)(n * TILE + t) * D + i] = s;
        }
        // Every thread is done with this slot before tile n + 2 refills it.
        __syncthreads();
    }
}

template <int D>
cudaError_t launch(const void* x, const void* y, const void* z,
                   const void* logw, const void* s0, void* out, int BH, int T,
                   int device, cudaStream_t stream) {
    if (BH < 1 || BH > 65535 || T < 1 || device < 0 || device >= MAX_DEVICES)
        return cudaErrorInvalidValue;
    constexpr int bytes = static_cast<int>(smem_bytes<D>());
    // Raised once per device (not again while a graph is captured).
    static bool raised[MAX_DEVICES] = {};
    if (!raised[device]) {
        const cudaError_t err = cudaFuncSetAttribute(
            wkv6_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (err != cudaSuccess) return err;
        raised[device] = true;
    }
    wkv6_rows_kernel<D><<<dim3(D / Rows<D>::value, BH), Rows<D>::value * G,
                          bytes, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(z), static_cast<const float*>(logw),
        static_cast<const float*>(s0), static_cast<float*>(out), T);
    return cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and does not synchronise.
// D is 16 or 64; 1 <= BH <= 65535, T >= 1; every pointer 16-byte aligned.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue for
// an unsupported D, BH or T): a refused launch never runs, and the caller
// must check the code.  The caller validates shapes, dtypes and contiguity.
extern "C" int wkv6_rows(const void* x, const void* y, const void* z,
                         const void* logw, const void* s0, void* out, int BH,
                         int T, int D, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return static_cast<int>(
            launch<16>(x, y, z, logw, s0, out, BH, T, device, s));
        case 64: return static_cast<int>(
            launch<64>(x, y, z, logw, s0, out, BH, T, device, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

extern "C" const char* wkv6_rows_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
