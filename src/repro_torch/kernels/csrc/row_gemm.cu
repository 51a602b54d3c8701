// Slot-indexed per-row GEMM for batched cross-tenant decode, K3 (sm_90a).
//
//   out[r, n] = sum_k h[r, k] * round_to(T, tables[clamp(gidx[r]), k, n])
//   h (R, K) of type T (fp32 or bf16), tables (S, K, N) of type W (fp32 or
//   bf16), gidx (R,) int32, out (R, N) of type T; row-major and contiguous.
//   The sum is accumulated in fp32 and rounded to T once.  A bf16 entry is
//   exact in fp32, so a bf16 table gives the bits that an fp32 table of the
//   same entries rounded to bf16 gives: with T = bf16 the rounding is
//   already done, with T = fp32 there is none to do.
//
// Replaces the Pallas kernel grouped_row_gemm (src/repro/kernels/grouped.py
// :206, which reaches pallas_call at :197 through grouped_aug_gemm at B =
// bm = 1): the logits step of the continuous-batched decode lane, where row
// r is one tenant's sequence and tables[gidx[r]] that tenant's fused
// (d_model, V) Aug-head.  The table entries are rounded to the activation
// type before the product, as the reference's jnp path does
// (kernels/ref.py lm_head_rows_grouped_ref: w.astype(h.dtype)) and as the
// per-tenant models.stack.lm_head does, which batched decode must agree
// with.  (The Pallas path promotes a bf16 h against fp32 tables and skips
// that rounding; this kernel does not copy that.)  A row's slot index is
// clamped to [0, S-1], as the ops layer's _safe_gidx does: for the kernel
// the clamp is memory safety.
//
// What bounds it on an H100: the table bytes.  Each of the R rows streams
// its own K x N table once and does 2 flops per entry: 0.5 flop per byte
// in fp32, 1 in bf16, against the ~295 flops per byte at which the bf16
// tensor cores, not the memory, would be the limit.  So wgmma would gain
// nothing here (nor would any reuse: no entry serves two rows), and the
// products are fp32 FFMA.  At the decode lane's main paths, R = 4 rows on
// 4 slots: deepseek_7b (K = 4096, N = 102400) reads 6.71 GB of fp32 tables
// (2.004 ms at 3.35 TB/s) or 3.36 GB of bf16 ones (1.002 ms); phi3_mini
// (K = 3072, N = 32064) 1.58 GB or 0.79 GB (0.471 / 0.235 ms).  The lane
// stages its head stacks in the model's activation type, bf16 on those
// paths, so K3 there reads half the bytes of an fp32 stack for the same
// logits.  The design is about keeping enough table bytes in flight on
// every SM:
//
//   * The unit of work is one row r and one strip of STRIP_BYTES = 512
//     bytes of each table row (128 fp32 or 256 bf16 columns: 32 lanes, one
//     16-byte load each).  Grid (strips, R), one launch, no workspace.  A
//     narrow vocabulary still gives many blocks: phi3's N = 32064 is 504
//     blocks on bf16 tables and 1,004 on fp32 ones, deepseek's 1,600 and
//     3,200, against 132 SMs of MIN_BLOCKS = 4 resident blocks each.
//   * The split of K is inside the block: its 8 warps take contiguous
//     slices of `kslice` table rows (a multiple of U; the last takes the
//     rest, warps past K idle), which the wrapper's rule gives
//     (kernels/gemm.py row_splits), and add their partial sums in shared
//     memory in warp order: no atomics, the same bits on every call.  (A
//     split of K across blocks, summed by a second, ordered pass, moved
//     neither main shape by 1%, so there is none.)
//   * Loads in flight.  Each lane streams its 16-byte piece of consecutive
//     table rows in batches of U = 4 rows, software pipelined: the next
//     batch's loads are issued before the current batch's FMAs, so about 8
//     loads (128 bytes) a thread are in flight, 128 KB an SM at 4 resident
//     blocks.  The table loads bypass L1 (ld.global.nc.L1::no_allocate:
//     each byte is read once); h, which every lane reads as a broadcast,
//     stays there.
//   * Rounding.  fp32 entries against bf16 h are rounded two at a time
//     (cvt.rn.bf16x2.f32, round to nearest even like torch's cast); bf16
//     entries are widened by a shift.
//   * Ragged edges are masked: rows past a warp's slice load nothing and
//     add zero; columns past N in the last strip (phi3's last strip holds
//     64 columns, of 256 on bf16 tables or of 128 on fp32 ones) are neither
//     loaded nor written.  When N is not a multiple of the entries per 16
//     bytes (or the table is not 16-byte aligned), a variant with coalesced
//     scalar loads runs (lane l takes columns l + 32 j of the strip; one
//     batch in flight at a time, of 2 rows for bf16 tables).  Every shape
//     launches.
//
// Rows that share a slot each read the table again: the lane's rows are
// distinct tenants' sequences, so duplicates are rare there.  Fewer than
// 132 blocks (one row of phi3's vocabulary on bf16 tables is 126) leave
// SMs idle; no path of the port has such a shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 4;            // resident blocks an SM (launch bounds)
constexpr int STRIP_BYTES = 512;         // a unit's bytes of each table row
constexpr int U = 4;                     // table rows a batch

template <typename T>
struct Act;

template <>
struct Act<float> {
    static __device__ __forceinline__ float load(const float* p) { return *p; }
    static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Act<__nv_bfloat16> {
    static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
        return __bfloat162float(*p);
    }
    static __device__ __forceinline__ __nv_bfloat16 store(float v) {
        return __float2bfloat16_rn(v);
    }
};

// A table's entries as fp32 values rounded to the activation type T: the
// V entries of one 16-byte piece (get), or one entry (one).
template <typename T, typename W>
struct Entries;

template <>
struct Entries<float, float> {
    static constexpr int V = 4;
    static __device__ __forceinline__ void get(const uint4& q, float (&w)[V]) {
        w[0] = __uint_as_float(q.x);
        w[1] = __uint_as_float(q.y);
        w[2] = __uint_as_float(q.z);
        w[3] = __uint_as_float(q.w);
    }
    static __device__ __forceinline__ float one(float x) { return x; }
};

template <>
struct Entries<__nv_bfloat16, float> {
    static constexpr int V = 4;
    static __device__ __forceinline__ void pair(unsigned a, unsigned b,
                                                float& lo, float& hi) {
        const __nv_bfloat162 r =
            __floats2bfloat162_rn(__uint_as_float(a), __uint_as_float(b));
        lo = __low2float(r);
        hi = __high2float(r);
    }
    static __device__ __forceinline__ void get(const uint4& q, float (&w)[V]) {
        pair(q.x, q.y, w[0], w[1]);
        pair(q.z, q.w, w[2], w[3]);
    }
    static __device__ __forceinline__ float one(float x) {
        return __bfloat162float(__float2bfloat16_rn(x));
    }
};

// bf16 entries: exact in fp32, whatever T is.
struct Bf16Entries {
    static constexpr int V = 8;
    static __device__ __forceinline__ void get(const uint4& q, float (&w)[V]) {
        const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            w[2 * i] = __uint_as_float(u[i] << 16);
            w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
        }
    }
    static __device__ __forceinline__ float one(__nv_bfloat16 x) {
        return __bfloat162float(x);
    }
};

template <>
struct Entries<float, __nv_bfloat16> : Bf16Entries {};
template <>
struct Entries<__nv_bfloat16, __nv_bfloat16> : Bf16Entries {};

__device__ __forceinline__ uint4 ld_stream(const void* p) {
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}

// One batch of ROWS table rows for this lane: its 16-byte piece of each
// row (VEC) or its V scalar entries (columns lane + 32 j), and h at those
// rows.  Rows at or past `end`, and dead lanes' columns, load nothing and
// hold 0.  The scalar form takes 2 rows a batch for bf16 tables (8 entries
// a row), which keeps it within the launch bounds' 64 registers.
template <typename T, typename W, bool VEC>
struct Batch {
    static constexpr int V = Entries<T, W>::V;
    static constexpr int ROWS = VEC || V == 4 ? U : U / 2;
    uint4 q[VEC ? ROWS : 1];
    float e[VEC ? 1 : ROWS][VEC ? 1 : V];   // scalar: entries rounded to T
    float x[ROWS];

    __device__ __forceinline__ void load(const W* col, size_t stride,
                                         const T* hr, int k, int end,
                                         const bool (&live)[V]) {
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
            const bool in = k + u < end;
            const W* p = col + (size_t)(k + u) * stride;
            if constexpr (VEC) {
                q[u] = in && live[0] ? ld_stream(p) : make_uint4(0, 0, 0, 0);
            } else {
#pragma unroll
                for (int j = 0; j < V; ++j)
                    e[u][j] = in && live[j]
                                  ? Entries<T, W>::one(__ldg(p + 32 * j))
                                  : 0.0f;
            }
            x[u] = in ? Act<T>::load(hr + k + u) : 0.0f;
        }
    }

    __device__ __forceinline__ void fma(float (&acc)[V]) const {
#pragma unroll
        for (int u = 0; u < ROWS; ++u) {
            float w[V];
            if constexpr (VEC) {
                Entries<T, W>::get(q[u], w);
            } else {
#pragma unroll
                for (int j = 0; j < V; ++j) w[j] = e[u][j];
            }
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(x[u], w[j], acc[j]);
        }
    }
};

template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
row_gemm_kernel(const T* __restrict__ h, const int* __restrict__ gidx,
                const W* __restrict__ tables, T* __restrict__ out,
                int N, int K, int S, int kslice) {
    constexpr int V = Entries<T, W>::V;
    constexpr int STRIP = STRIP_BYTES / sizeof(W);     // 32 * V columns
    constexpr int PAD = STRIP + STRIP / 32;
    __shared__ float red[WARPS][PAD];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r = blockIdx.y;
    int slot = gidx[r];
    slot = slot < 0 ? 0 : (slot > S - 1 ? S - 1 : slot);
    const T* hr = h + (size_t)r * K;
    const int strip0 = blockIdx.x * STRIP;

    // This warp's rows: its slice of K, a multiple of U long but the last.
    const int k0 = min(K, warp * kslice), k1 = min(K, k0 + kslice);

    // VEC: columns strip0 + lane * V + j, all in range or none (N % V ==
    // 0).  Scalar: columns strip0 + lane + 32 j, each masked.
    const int col0 = VEC ? strip0 + lane * V : strip0 + lane;
    bool live[V];
#pragma unroll
    for (int j = 0; j < V; ++j) live[j] = VEC ? col0 < N : col0 + 32 * j < N;
    const W* col = tables + (size_t)slot * K * N + min(col0, N - 1);

    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    Batch<T, W, VEC> a;
    if constexpr (VEC) {
        Batch<T, W, VEC> b;
        a.load(col, N, hr, k0, k1, live);
        for (int k = k0; k < k1; k += 2 * U) {
            b.load(col, N, hr, k + U, k1, live);
            a.fma(acc);
            a.load(col, N, hr, k + 2 * U, k1, live);
            b.fma(acc);
        }
    } else {                            // the rare ragged form: not pipelined
        for (int k = k0; k < k1; k += Batch<T, W, VEC>::ROWS) {
            a.load(col, N, hr, k, k1, live);
            a.fma(acc);
        }
    }

    // The 8 warps' partial sums, added in warp order.  Column c of the
    // strip sits at red[w][c + c / 32]: conflict-free both ways.
#pragma unroll
    for (int j = 0; j < V; ++j) {
        const int c = VEC ? lane * V + j : j * 32 + lane;
        red[warp][c + c / 32] = acc[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < STRIP; c += THREADS) {
        const int n = strip0 + c;
        if (n >= N) break;
        float s = red[0][c + c / 32];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) s += red[w][c + c / 32];
        out[(size_t)r * N + n] = Act<T>::store(s);
    }
}

template <typename T, typename W>
bool vectorised(const void* tables, int N) {
    return N % Entries<T, W>::V == 0
           && reinterpret_cast<uintptr_t>(tables) % 16 == 0;
}

template <typename T, typename W>
int launch(const void* h, const void* gidx, const void* tables, void* out,
           int R, int N, int K, int S, int kslice, cudaStream_t st) {
    constexpr int STRIP = STRIP_BYTES / sizeof(W);
    const dim3 grid((N + STRIP - 1) / STRIP, R);
    auto kernel = vectorised<T, W>(tables, N) ? row_gemm_kernel<T, W, true>
                                              : row_gemm_kernel<T, W, false>;
    kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const T*>(h), static_cast<const int*>(gidx),
        static_cast<const W*>(tables), static_cast<T*>(out), N, K, S, kslice);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and does not synchronise.
// `h_bf16` selects the type of h and out, `tables_bf16` that of the tables
// (0: fp32, 1: bf16).  The caller validates shapes (R, N, K >= 1, R within
// the grid limit), dtypes and contiguity, and passes the rows of K each of
// a block's warps takes, kslice: a multiple of U with WARPS * kslice >= K.
// Returns cudaGetLastError() after the launch: a refused launch never runs,
// and the caller must check the code.
extern "C" int row_gemm(const void* h, const void* gidx, const void* tables,
                        void* out, int R, int N, int K, int S, int h_bf16,
                        int tables_bf16, int kslice, int device, void* stream) {
    using bf16 = __nv_bfloat16;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (h_bf16)
        return tables_bf16 ? launch<bf16, bf16>(h, gidx, tables, out, R, N, K,
                                                S, kslice, s)
                           : launch<bf16, float>(h, gidx, tables, out, R, N, K,
                                                 S, kslice, s);
    return tables_bf16 ? launch<float, bf16>(h, gidx, tables, out, R, N, K, S,
                                             kslice, s)
                       : launch<float, float>(h, gidx, tables, out, R, N, K, S,
                                              kslice, s);
}

extern "C" const char* row_gemm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
