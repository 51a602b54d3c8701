// Aug-Conv GEMM: MoLe's wide Aug-Conv products K2 and K5, and the morph K4
// in fp32, on Hopper's tensor cores (sm_90a).
//
//   out[g] = a[g] @ b[slot(g)],  slot(g) = clamp(gidx[g], 0, S - 1), or g
//                                when gidx is null
//   a (G, M, K), b (S, K, N), out (G, M, N), gidx (G,) int32 or null;
//   row-major and contiguous; a, b and out of one element type T.
//
// Replaces three TPU kernels of the reference, through three entry points:
//   * grouped_aug_gemm (src/repro/kernels/grouped.py:157), K2:
//     aug_sgemm_grouped, fp32, slot-indexed.  a = t (G, B, K), b = the
//     stacked Aug-Conv matrices c_acs (S, K, N).  Each block reads its own
//     gidx[g] and clamps it (memory safety: a slot past S-1 reads out of
//     bounds); no (G, K, N) gather copy exists.
//   * aug_gemm (src/repro/kernels/aug_gemm.py:41), K5: aug_gemm_typed, gidx
//     null (slot = group index), fp32 or bf16: the developer's T @ C^{ac},
//     or t (G, B, K) @ c_acs (G, K, N).
//   * block_diag_matmul (src/repro/kernels/block_diag.py:45), K4 in fp32:
//     aug_sgemm_split, gidx null, fp32 only: x (R, kappa q) viewed as
//     (R kappa, q) @ the core (q, q), the provider's morph.  Its sum over K
//     may be split into slices (below).  K4 takes this route where its
//     product is large enough (kernels/gemm.py morph_route): the split form
//     reaches the tensor cores' 495 TFLOP/s of TF32 where the FFMA loop of
//     morph_gemm.cu tops out at 67 TFLOP/s of fp32, and cuBLAS's fp32 SGEMM
//     already ran at 73% of that.  K4 in bf16, and fp32 morphs too small to
//     pay for this route's split pass and extra launch, stay on
//     morph_gemm.cu.
//
// The arithmetic.  The reference sums fp32 products in fp32.  One TF32
// tensor-core pass keeps about three decimal digits (3e-4 of max|out| at
// K = 3072), so it is not used.  fp32 operands are split instead, x = hi +
// lo with hi = tf32_rna(x) and lo = tf32_rna(x - hi) (the rounding of
// cvt.rna.tf32.f32: to nearest, ties away from zero), and each k-step runs
// three TF32 products, small terms first: lo(a) hi(b), hi(a) lo(b), hi(a)
// hi(b).  lo lo is below fp32's last place and is dropped; the products of
// TF32 values are exact in fp32.  The tensor cores align a sum to its
// largest term and truncate it, so products added into one growing
// accumulator each drop up to one unit of its last place, always toward
// zero: over K = 3072 (1,152 products of a k-step of 8) that bias came to
// 2.4e-5 of max|out| on an H100 (tests/test_torch_cuda.py's fp64 test).
// So each stage of 32 k is summed into a fresh accumulator, whose
// truncations have either sign, and added to the running sum by fp32 FADDs
// (round to nearest): 5e-7 of max|fp64| there, no worse than cuBLAS's fp32
// SGEMM.  tests/test_torch_split_tf32.py models the split on the CPU;
// chip_smoke.py holds the card at 1e-5 of max|fp64|.  bf16 operands take
// one bf16 pass: their products are exact in fp32, so this is the
// reference's einsum(..., preferred_element_type=f32) up to the order of
// the sum.  Every output is rounded to T once (__float2bfloat16_rn for
// bf16).  No atomics, a fixed order: the same bits on every call.
//
// What bounds it on an H100 at the main-path shapes (VGG-16/CIFAR first
// layer, kappa = 1; 495 TFLOP/s TF32 dense, 3.35 TB/s):
//   K5 (256, 3072) @ (3072, 65536) fp32: 3 x 103.1 GFLOP of TF32, 0.625 ms,
//      against 875.6 MB, 0.261 ms: bound by operations.
//   K2 (4, 64, 3072) @ 4 x (3072, 65536) fp32: the same 3 x 103.1 GFLOP,
//      against 3.291 GB (each group's own 805 MB C^{ac}, read once),
//      0.982 ms: bound by bytes.
//
// K4 at its main-path shapes (fp32; 3 x its flops of TF32 at 495 TFLOP/s):
//   vlm provider (2048, 7680) @ (7680, 7680): 3 x 241.6 GFLOP, 1.464 ms,
//      against 0.36 GB, 0.11 ms: bound by operations.
//   VGG-16 (256, 3072) @ (3072, 3072): 3 x 4.83 GFLOP, 0.029 ms.
//   whisper (24000, 384) @ (384, 384): 3 x 7.08 GFLOP, 0.043 ms, against
//      74 MB, 0.022 ms.
//
// Design, fp32: two launches, split_t_kernel then sgemm_kernel (K4: a third
// where K is split).
//   * The MMA: wgmma in the swapped form out^T = C^{ac}^T T^T.  wgmma takes
//     tf32 operands from shared memory only K-major, and C^{ac} (K, N) is
//     N-major, so C^{ac}^T is wgmma's A operand, from registers: each
//     thread reads its fragment out of the N-major shared tile (rows padded
//     by 8 floats, conflict-free) and splits it there.  T (M, K) row-major
//     is a K-major B.  mma.sync reaches about half of wgmma's rate on this
//     card: a first version on it ran K5 at parity with torch.matmul.
//   * T is split once, by split_t_kernel, into a workspace laid out as
//     wgmma's interleaved core matrices (8 rows x 16 bytes), a block's tile
//     of a stage contiguous; the GEMM takes each hi and lo tile with one
//     bulk copy (cp.async.bulk, counted on an mbarrier), which wgmma reads
//     with no thread work or proxy fence.  Splitting in the GEMM instead
//     repeats the split for every column tile, and was slower.
//   * Tiles: a block of two warpgroups covers 128 columns of C^{ac} (64
//     each) and NR rows of T (the wgmma N): NR = 64 where M <= 64 (K2: all
//     of a group's rows, 2,048 blocks), else 128 (K5: two row blocks per
//     column tile, adjacent in the grid, so that the second reads the
//     C^{ac} tile from L2).  Every ragged edge of M, N and K is masked.
//   * Operand rings: stages of 32 k.  Each warpgroup copies its own half of
//     the C^{ac} tile (cp.async 16-byte copies, L1 bypassed; masked scalar
//     copies where rows are not 16-byte aligned) STAGES - 1 stages ahead:
//     6 stages at NR = 64, where K2 streams 3.3 GB, 4 at NR = 128.  The T
//     tiles run STAGES - 2 ahead; a slot is refilled once both warpgroups
//     have released it (an mbarrier per slot).  Apart from that the
//     warpgroups run their stages on their own, so one's wgmmas can keep
//     the tensor cores busy while the other adds its stage sum.
//   * Grid order: rows fastest, so that the row tiles of a column tile run
//     side by side and share its C^{ac} tile through L2; columns fastest
//     where one group's C^{ac} fits in COLS_FASTEST_BYTES (whisper's K4: a
//     0.6 MB core against 74 MB of split frames, read once instead of
//     three times).
//   * Split K (K4's narrow outputs: VGG-16's 48 tiles on 132 SMs): slice j
//     of `splits` runs stages [j kt_slice, (j + 1) kt_slice) into an fp32
//     partial (splits, G, M, N) that the caller allocates, and
//     split_reduce_kernel adds the slices in the fixed order 0 .. splits -
//     1: no atomics, the same bits on every call.  It is a programmatic
//     dependent launch, so its launch overlaps the GEMM's tail.  The rule
//     (kernels/gemm.py tf32_splits) takes one slice where the tiles give
//     every SM one: the vlm provider's 960 and whisper's 564.
// Design, bf16 (hgemm_kernel): mma.sync m16n8k16 from ldmatrix fragments
// (ldmatrix.trans for the N-major b), warps of 64 x 32, cp.async stages of
// 64 k; it is K5's bf16 form only, off every main path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int REDUCE_THREADS = 256;

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

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Copies the ROWS x COLS tile at (r0, c0) of a row-major (R, C) matrix into
// shared memory with row stride `ld`, zero past the edges: 16-byte
// cp.async chunks where `vec` (the rows 16-byte aligned, so a chunk is all
// in or all out), else synchronous scalar copies, visible after the next
// barrier.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int R,
                                          int C, int r0, int c0, bool vec,
                                          int tid) {
    constexpr int CH = 16 / sizeof(T);
    constexpr int CHUNKS = ROWS * COLS / CH;
    static_assert(CHUNKS % THREADS == 0, "tiles must split evenly into 16-byte copies");
    if (vec) {
#pragma unroll
        for (int i = 0; i < CHUNKS / THREADS; ++i) {
            const int c = tid + i * THREADS;
            const int r = c / (COLS / CH), cc = (c % (COLS / CH)) * CH;
            const int gr = r0 + r, gc = c0 + cc;
            const bool in = gr < R && gc < C;
            cp_async16(dst + r * ld + cc, in ? src + (size_t)gr * C + gc : src, in);
        }
    } else {
        for (int e = tid; e < ROWS * COLS; e += THREADS) {
            const int r = e / COLS, cc = e % COLS;
            const int gr = r0 + r, gc = c0 + cc;
            dst[r * ld + cc] = (gr < R && gc < C) ? src[(size_t)gr * C + gc]
                                                  : from_float<T>(0.0f);
        }
    }
}

// Group g's slot: clamp(gidx[g], 0, S - 1) (a slot past S - 1 would read
// out of bounds), or g without gidx.
__device__ __forceinline__ int clamp_slot(const int* gidx, int g, int S) {
    if (gidx == nullptr) return g;
    const int s = gidx[g];
    return s < 0 ? 0 : (s > S - 1 ? S - 1 : s);
}

// ---------------------------------------------------------------------------
// fp32: split TF32 on wgmma.

// x -> the nearest TF32 value, ties away from zero (cvt.rna.tf32.f32's
// rounding), in an fp32 container: integer operations at full rate, where
// cvt.rna's NaN handling compiles to a longer sequence.  Operands are finite.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 22 bits, each a TF32 value in an fp32 container.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}

// Orders the compiler's accesses to wgmma accumulators around the
// asynchronous wgmmas (emits nothing).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A K-major operand in wgmma's interleaved layout: 8-row core matrices of
// 16 bytes a row, the two 16-byte k halves of a k-step CORE_K apart, row
// groups CORE_ROWS apart.
constexpr int CORE_K = 128;             // bytes: a stage's 32 k = 8 core columns
constexpr int CORE_ROWS = 8 * CORE_K;   // bytes
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
    const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(p));
    return ((a >> 4) & 0x3fff) | (uint64_t(CORE_K >> 4) << 16)
           | (uint64_t(CORE_ROWS >> 4) << 32);
}

// d (64 x 128) += a (64 x 8, registers) b (8 x 128, shared, K-major), tf32 in,
// fp32 out; d is cleared first where `accumulate` is 0.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x 64) += a (64 x 8, registers) b (8 x 64, shared, K-major), tf32 in,
// fp32 out; d is cleared first where `accumulate` is 0.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// T split once, before the GEMM, into ws (G, ktiles, 2, m_pad * 32) floats:
// for each group, stage of 32 k and hi / lo, the rows (m_pad, M rounded up
// to the GEMM's row tile) in wgmma's interleaved K-major layout, [row group
// r / 8][16-byte k chunk][r % 8][4], zero past M and K.  So a GEMM block's
// hi or lo tile of a stage is one contiguous NR * 128 bytes.  One thread a
// 16-byte chunk; a warp writes 512 contiguous bytes.
__global__ void __launch_bounds__(256)
split_t_kernel(const float* __restrict__ a, float* __restrict__ ws, int M, int K,
               int m_pad, int ktiles, size_t chunks) {
    const size_t c = (size_t)blockIdx.x * 256 + threadIdx.x;
    if (c >= chunks) return;
    const int r8 = c % 8, kc = (c / 8) % 8;
    const size_t rest = c / 64;
    const int rg = rest % (m_pad / 8);
    const int t = (rest / (m_pad / 8)) % ktiles;
    const size_t g = rest / ((size_t)(m_pad / 8) * ktiles);
    const int r = rg * 8 + r8, k = t * 32 + kc * 4;
    const float* src = a + (g * M + r) * K + k;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < M && k + 3 < K && aligned(src, 16)) {
        v = __ldg(reinterpret_cast<const float4*>(src));
    } else if (r < M) {
        float e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = k + j < K ? src[j] : 0.0f;
        v = make_float4(e[0], e[1], e[2], e[3]);
    }
    uint4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    const size_t tile = (g * ktiles + t) * 2 * (size_t)m_pad * 32;
    float* hi = ws + tile + (size_t)(rg * 8 + kc) * 32 + r8 * 4;
    *reinterpret_cast<uint4*>(hi) = h;
    *reinterpret_cast<uint4*>(hi + (size_t)m_pad * 32) = l;
}

constexpr int SPLIT_BK = 32;            // k per stage of the fp32 GEMM: 4 wgmma k-steps

// The fp32 GEMM's row tile (the wgmma N): all of a group's rows where M <=
// 64, else 128.
__host__ __forceinline__ int row_tile(int M) { return M > 64 ? 128 : 64; }

// Floats of the split-T workspace, (G, ktiles, 2, m_pad * 32): M rounded up
// to the row tile, K to the stage.  The one copy of this rule.
__host__ __forceinline__ size_t split_floats(int G, int M, int K) {
    const int nr = row_tile(M);
    const size_t m_pad = (size_t)(M + nr - 1) / nr * nr;
    const size_t ktiles = (size_t)(K + SPLIT_BK - 1) / SPLIT_BK;
    return (size_t)G * ktiles * 2 * m_pad * SPLIT_BK;
}

template <int NR>
struct SgemmTile {
    static constexpr int THREADS = 256;             // two warpgroups
    static constexpr int BN = 128;                  // C^{ac} columns, 64 per warpgroup
    static constexpr int BK = SPLIT_BK;
    static constexpr int STAGES = NR == 64 ? 6 : 4;
    static constexpr int C_LD = 64 + 8;             // floats: a warpgroup's half tile
    static constexpr int C_FLOATS = BK * C_LD;
    static constexpr int T_FLOATS = NR * BK;        // one hi or lo tile
    static constexpr int T_BYTES = T_FLOATS * 4;
    static constexpr int STAGE_FLOATS = 2 * T_FLOATS + 2 * C_FLOATS;
    static constexpr int SMEM = STAGES * STAGE_FLOATS * 4 + 2 * STAGES * 8;
};

template <int NR>
__device__ __forceinline__ void wgmma_tf32(float (&d)[NR / 2], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
    if constexpr (NR == 128) {
        wgmma_n128(d, a, desc, accumulate);
    } else {
        wgmma_n64(d, a, desc, accumulate);
    }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Waits for the phase of parity `parity` of the mbarrier at `bar` to
// complete.  The loop stays inside the asm: a loop in C++ around the
// try_wait makes ptxas serialise the wgmmas after it.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    asm volatile(
        "{\n.reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// Block (x, y, z): a row tile and a column tile (rows fastest, or columns
// fastest where `cols_fastest`), group g = z % G and slice z / G of the
// stages: slice j sums stages [j * kt_slice, min(ktiles, (j + 1) * kt_slice))
// and, with partial non-null, writes its fp32 sums to partial (slices, G, M,
// N) for split_reduce_kernel; with partial null (one slice) to out.
template <int NR>
__global__ void __launch_bounds__(256, 1)
sgemm_kernel(const float* __restrict__ ws, const int* __restrict__ gidx,
             const float* __restrict__ b, float* __restrict__ out,
             float* __restrict__ partial, int G, int M, int N, int K, int S,
             int m_pad, int kt_slice, int cols_fastest) {
    using W = SgemmTile<NR>;
    constexpr int BK = W::BK, STAGES = W::STAGES, C_LD = W::C_LD;
    // [STAGES][T hi, T lo, C^{ac} half tiles of warpgroups 0 and 1], then
    // the mbarriers full[STAGES] (the stage's T tiles landed) and
    // empty[STAGES] (both warpgroups done with the slot).
    extern __shared__ __align__(1024) float smem_f[];
    auto t_tile = [&](int s) { return smem_f + s * W::STAGE_FLOATS; };
    uint64_t* const full = reinterpret_cast<uint64_t*>(smem_f + STAGES * W::STAGE_FLOATS);
    uint64_t* const empty = full + STAGES;

    const int g = blockIdx.z % G, slice = blockIdx.z / G;
    const int row0 = (cols_fastest ? blockIdx.y : blockIdx.x) * NR;
    const int tid = threadIdx.x;
    // Warpgroup wg owns C^{ac} columns col0 + [0, 64); within it, warp v
    // the wgmma rows 16 v + [0, 16); lane (q, tq) = (lane / 4, lane % 4).
    const int wg = tid >> 7, wtid = tid & 127;
    const int v = wtid >> 5, q = (tid & 31) >> 2, tq = tid & 3;
    const int col0 = (cols_fastest ? blockIdx.x : blockIdx.y) * W::BN + 64 * wg;
    const float* B = b + (size_t)clamp_slot(gidx, g, S) * K * N;
    const bool b_vec = aligned(b, 16) && N % 4 == 0;
    // This slice's stages t0 + [0, ktiles) of the group's kt_all; the
    // wrapper leaves no slice empty.
    const int kt_all = (K + BK - 1) / BK;
    const int t0 = slice * kt_slice;
    const int ktiles = min(kt_all, t0 + kt_slice) - t0;
    auto c_tile = [&](int s) { return t_tile(s) + 2 * W::T_FLOATS + wg * W::C_FLOATS; };

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(full + s)));
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 2;\n" :: "r"(smem_addr(empty + s)));
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // The warpgroup's half of the slice's stage t's C^{ac} tile, by its
    // own cp.async.
    auto load_c = [&](int t) {
        load_tile<float, BK, 64, 128>(c_tile(t % STAGES), C_LD, B, K, N, (t0 + t) * BK,
                                      col0, b_vec, wtid);
    };
    // The slice's stage t's split T tiles, one bulk copy each (the async
    // proxy, which wgmma reads), counted on full[t % STAGES]; by thread 0.
    auto load_t = [&](int t) {
        const int s = t % STAGES;
        const unsigned bar = smem_addr(full + s);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                     :: "r"(bar), "r"(2 * W::T_BYTES) : "memory");
        const float* src = ws + ((size_t)g * kt_all + t0 + t) * 2 * m_pad * 32
                           + (size_t)row0 * 32;
#pragma unroll
        for (int h = 0; h < 2; ++h)
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1], %2, [%3];\n"
                :: "r"(smem_addr(t_tile(s) + h * W::T_FLOATS)),
                   "l"(src + (size_t)h * m_pad * 32), "r"(W::T_BYTES), "r"(bar)
                : "memory");
    };

    float acc[NR / 2], part[NR / 2];
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) acc[i] = part[i] = 0.0f;

    // T runs STAGES - 2 stages ahead, C^{ac} STAGES - 1.
    if (tid == 0)
        for (int s = 0; s < STAGES - 2 && s < ktiles; ++s) load_t(s);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ktiles) load_c(s);
        cp_async_commit();
    }

    // The warpgroups synchronise only through the T ring: each runs its own
    // stages, so one's wgmmas keep the tensor cores busy while the other
    // adds its stage sum and loads its next fragments.
    for (int t = 0; t < ktiles; ++t) {
        // This warpgroup's half of stage t has landed (this thread's
        // copies); its barrier makes them visible, and the warpgroup has
        // finished stage t - 1: its wgmmas, whose T slot it releases, and
        // its fragment loads, whose C^{ac} slot takes stage t + STAGES - 1.
        cp_async_wait<STAGES - 2>();
        if (wg == 0) {
            asm volatile("bar.sync 1, 128;\n" ::: "memory");
        } else {
            asm volatile("bar.sync 2, 128;\n" ::: "memory");
        }
        if (t > 0 && wtid == 0)
            asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                         :: "r"(smem_addr(empty + (t - 1) % STAGES)) : "memory");
        if (t + STAGES - 1 < ktiles) load_c(t + STAGES - 1);
        cp_async_commit();
        // Stage t + STAGES - 2 goes to the slot of stage t - 2, once both
        // warpgroups have released it: warp 0 waits (converged, so that
        // ptxas need not serialise the wgmmas), thread 0 copies.
        const int u = t + STAGES - 2;
        if (tid < 32 && u < ktiles) {
            if (u >= STAGES) mbar_wait(smem_addr(empty + u % STAGES), (u / STAGES - 1) & 1);
            if (tid == 0) load_t(u);
            __syncwarp();
        }

        // a fragments of the stage's four k-steps, split: (row q, k tq),
        // (q + 8, tq), (q, tq + 4), (q + 8, tq + 4) of the warp's 16 rows,
        // i.e. C^{ac}[k][col] for col = 16 v + q (+ 8) of the half tile.
        const float* cs = c_tile(t % STAGES) + tq * C_LD + 16 * v + q;
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            const float* p = cs + ks * 8 * C_LD;
            split(p[0], ah[ks][0], al[ks][0]);
            split(p[8], ah[ks][1], al[ks][1]);
            split(p[4 * C_LD], ah[ks][2], al[ks][2]);
            split(p[4 * C_LD + 8], ah[ks][3], al[ks][3]);
        }
        const float* hi = t_tile(t % STAGES);
        const float* lo = hi + W::T_FLOATS;
        mbar_wait(smem_addr(full + t % STAGES), (t / STAGES) & 1);
        fence_operands(part);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            const int kb = ks * 2 * (CORE_K / 4);   // two 16-byte core columns
            wgmma_tf32<NR>(part, al[ks], kmajor_desc(hi + kb), ks > 0);
            wgmma_tf32<NR>(part, ah[ks], kmajor_desc(lo + kb), 1);
            wgmma_tf32<NR>(part, ah[ks], kmajor_desc(hi + kb), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(part);
#pragma unroll
        for (int i = 0; i < NR / 2; ++i) acc[i] += part[i];
    }

    // acc[4j + e] is out^T (col, row): col = 16 v + q (+ 8 for e >= 2) of
    // the half tile, row = 8 j + 2 tq (+ 1 for odd e).  A warp's store
    // covers four rows of eight consecutive floats: whole 32-byte sectors.
    float* C = (partial != nullptr ? partial + (size_t)slice * G * M * N : out)
               + (size_t)g * M * N;
    const int c_lo = col0 + 16 * v + q, c_hi = c_lo + 8;
#pragma unroll
    for (int j = 0; j < NR / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = row0 + 8 * j + 2 * tq + (e & 1);
            const int c = e < 2 ? c_lo : c_hi;
            if (r < M && c < N) C[(size_t)r * N + c] = acc[4 * j + e];
        }
    }
}

// ---------------------------------------------------------------------------
// bf16: one mma.sync pass.

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a (16 x 16, row) b (16 x 8, col), bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int H_STAGES = 4;
constexpr int H_BK = 64;                // k per stage: 128 bytes of a row
constexpr int H_A_LD = H_BK + 8;        // 144-byte rows
constexpr int MT = 4;                   // 16-row MMA tiles per warp: 64 rows
constexpr int NT = 4;                   // 8-column MMA tiles per warp: 32

// A block of WARPS_M x WARPS_N warps, each a 64 x 32 output tile.
template <int WARPS_M, int WARPS_N>
struct HgemmTile {
    static constexpr int WM = WARPS_M;
    static constexpr int BM = 64 * WARPS_M;
    static constexpr int BN = 8 * NT * WARPS_N;
    static constexpr int B_LD = BN + 8;
    static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
    static constexpr int MIN_BLOCKS = THREADS == 128 ? 2 : 1;
    static constexpr int SMEM = H_STAGES * (BM * H_A_LD + H_BK * B_LD) * 2;
};
using Narrow = HgemmTile<1, 4>;         // 64 x 128, M <= 64
using Wide = HgemmTile<4, 2>;           // 256 x 64, M > 64

template <typename W>
__global__ void __launch_bounds__(W::THREADS, W::MIN_BLOCKS)
hgemm_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
             __nv_bfloat16* __restrict__ out, int M, int N, int K) {
    using bf16 = __nv_bfloat16;
    constexpr int BM = W::BM, BN = W::BN, B_LD = W::B_LD;
    extern __shared__ __align__(16) unsigned char smem_h[];
    bf16* const As = reinterpret_cast<bf16*>(smem_h);
    bf16* const Bs = As + H_STAGES * BM * H_A_LD;

    const int g = blockIdx.z;
    const int col0 = blockIdx.x * BN;
    const int row0 = blockIdx.y * BM;
    const bf16* A = a + (size_t)g * M * K;
    const bf16* B = b + (size_t)g * K * N;
    const int tid = threadIdx.x;
    const bool a_vec = aligned(a, 16) && K % 8 == 0;
    const bool b_vec = aligned(b, 16) && N % 8 == 0;

    auto load_stage = [&](int stage, int k0) {
        load_tile<bf16, BM, H_BK, W::THREADS>(As + stage * BM * H_A_LD, H_A_LD, A, M, K,
                                              row0, k0, a_vec, tid);
        load_tile<bf16, H_BK, BN, W::THREADS>(Bs + stage * H_BK * B_LD, B_LD, B, K, N,
                                              k0, col0, b_vec, tid);
    };

    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int wm = warp % W::WM;
    const int wn = warp / W::WM;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    const int ktiles = (K + H_BK - 1) / H_BK;
#pragma unroll
    for (int s = 0; s < H_STAGES - 1; ++s) {
        if (s < ktiles) load_stage(s, s * H_BK);
        cp_async_commit();
    }

    for (int t = 0; t < ktiles; ++t) {
        // Tile t has landed (this thread's copies); the barrier makes every
        // thread's copies and scalar stores visible, and frees the stage
        // that iteration t - 1 read.
        cp_async_wait<H_STAGES - 2>();
        __syncthreads();
        const int next = t + H_STAGES - 1;
        if (next < ktiles) load_stage(next % H_STAGES, next * H_BK);
        cp_async_commit();

        const bf16* as = As + (t % H_STAGES) * BM * H_A_LD + wm * 64 * H_A_LD;
        const bf16* bs = Bs + (t % H_STAGES) * H_BK * B_LD + wn * 8 * NT;
#pragma unroll
        for (int kk = 0; kk < H_BK; kk += 16) {
            // a fragments: ldmatrix's four matrices are rows 0-7 and 8-15 at
            // k 0-7, then at k 8-15.
            uint32_t af[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i)
                ldmatrix_x4(af[i], as + (i * 16 + (lane & 15)) * H_A_LD + kk + (lane >> 4) * 8);
            // .trans of k rows 0-7 and 8-15 at columns 0-7, then at 8-15: the
            // b fragments (k = 2t, 2t + 1 | 2t + 8, 2t + 9; n = g) of two
            // 8-column tiles.
            const bf16* bp = bs + (kk + (lane & 15)) * B_LD + (lane >> 4) * 8;
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, bp + j * 8);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
                    mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
                }
            }
        }
    }

    // Each thread holds outputs (g, 2t), (g, 2t + 1) and the same two 8 rows
    // down of every 16 x 8 tile.  With N even a pair is one 4-byte store.
    bf16* C = out + (size_t)g * M * N;
    const bool pairs = N % 2 == 0 && aligned(out, 4);
    const int g8 = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = row0 + wm * 64 + i * 16 + g8 + 8 * h;
            if (r >= M) continue;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int c = col0 + wn * 8 * NT + j * 8 + t2;
                if (c >= N) continue;
                bf16* p = C + (size_t)r * N + c;
                const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
                if (pairs) {
                    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
                } else {
                    p[0] = __float2bfloat16_rn(x);
                    if (c + 1 < N) p[1] = __float2bfloat16_rn(y);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes) {
    // Above 48 KB only as dynamic shared memory, after this opt-in.
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// out[i] = part[0][i] + part[1][i] + ... + part[splits-1][i], in that order;
// four consecutive outputs per thread (16-byte loads of each slice) when n
// is a multiple of 4, else one.  Launched as a programmatic dependent of the
// GEMM: it may start while the GEMM drains, and waits here until the GEMM
// has finished and its stores are visible.
__global__ void __launch_bounds__(REDUCE_THREADS)
split_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, size_t n,
                    int splits) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const size_t stride = (size_t)gridDim.x * REDUCE_THREADS;
    const size_t first = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (n % 4 == 0) {
        const float4* w = reinterpret_cast<const float4*>(part);
        float4* o = reinterpret_cast<float4*>(out);
        for (size_t i = first; i < n / 4; i += stride) {
            float4 s = w[i];
            for (int j = 1; j < splits; ++j) {
                const float4 x = w[j * (n / 4) + i];
                s = make_float4(s.x + x.x, s.y + x.y, s.z + x.z, s.w + x.w);
            }
            o[i] = s;
        }
    } else {
        for (size_t i = first; i < n; i += stride) {
            float s = part[i];
            for (int j = 1; j < splits; ++j) s += part[j * n + i];
            out[i] = s;
        }
    }
}

// Columns fastest where one group's C^{ac} is at most this many bytes, so
// that it stays in L2 while the column tiles of a row tile, adjacent in the
// grid, share that row tile's split T (whisper's K4: a 0.6 MB core against
// 74 MB of split frames).  Else rows fastest: the row tiles of a column
// tile run side by side and share its C^{ac} tile (K5: an 805 MB C^{ac}).
constexpr size_t COLS_FASTEST_BYTES = size_t(8) << 20;

// The fp32 GEMM in `splits` slices of K (part: splits * G * M * N floats
// where splits > 1): split_t_kernel, sgemm_kernel, and split_reduce_kernel
// where splits > 1.
template <int NR>
cudaError_t launch_sgemm(const float* a, const int* gidx, const float* b, float* out,
                         float* ws, float* part, int G, int M, int N, int K, int S,
                         int splits, cudaStream_t st) {
    using W = SgemmTile<NR>;
    const int m_pad = (M + NR - 1) / NR * NR;   // split_floats' rows
    const int ktiles = (K + W::BK - 1) / W::BK;
    const int kt_slice = (ktiles + splits - 1) / splits;
    if (splits < 1 || (splits - 1) * kt_slice >= ktiles || (size_t)G * splits > 65535
            || (splits > 1 && part == nullptr))
        return cudaErrorInvalidValue;
    const size_t chunks = (size_t)G * ktiles * m_pad * 8;
    split_t_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, st>>>(
        a, ws, M, K, m_pad, ktiles, chunks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = opt_in(sgemm_kernel<NR>, W::SMEM);
    if (err != cudaSuccess) return err;
    const int rows = m_pad / NR, cols = (N + W::BN - 1) / W::BN;
    const int cols_fastest = (size_t)K * N * sizeof(float) <= COLS_FASTEST_BYTES;
    const dim3 grid(cols_fastest ? cols : rows, cols_fastest ? rows : cols, G * splits);
    sgemm_kernel<NR><<<grid, W::THREADS, W::SMEM, st>>>(
        ws, gidx, b, out, splits > 1 ? part : nullptr, G, M, N, K, S, m_pad, kt_slice,
        cols_fastest);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return err;
    const size_t n = (size_t)G * M * N;
    const size_t items = n % 4 == 0 ? n / 4 : n;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(
        std::min<size_t>((items + REDUCE_THREADS - 1) / REDUCE_THREADS, 8192)));
    cfg.blockDim = dim3(REDUCE_THREADS);
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, split_reduce_kernel, static_cast<const float*>(part), out,
                             n, splits);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename W>
cudaError_t launch_hgemm(const __nv_bfloat16* a, const __nv_bfloat16* b,
                         __nv_bfloat16* out, int G, int M, int N, int K,
                         cudaStream_t st) {
    cudaError_t err = opt_in(hgemm_kernel<W>, W::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + W::BN - 1) / W::BN, (M + W::BM - 1) / W::BM, G);
    hgemm_kernel<W><<<grid, W::THREADS, W::SMEM, st>>>(a, b, out, M, N, K);
    return cudaGetLastError();
}

int launch_f32(const void* a, const void* gidx, const void* b, void* out, void* ws,
               void* part, int G, int M, int N, int K, int S, int splits, int device,
               void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto* fa = static_cast<const float*>(a);
    const auto* ig = static_cast<const int*>(gidx);
    const auto* fb = static_cast<const float*>(b);
    auto* fo = static_cast<float*>(out);
    auto* fw = static_cast<float*>(ws);
    auto* fp = static_cast<float*>(part);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = row_tile(M) == 128
              ? launch_sgemm<128>(fa, ig, fb, fo, fw, fp, G, M, N, K, S, splits, st)
              : launch_sgemm<64>(fa, ig, fb, fo, fw, fp, G, M, N, K, S, splits, st);
    return static_cast<int>(err);
}

}  // namespace

// Every entry point launches on `stream` (PyTorch's current stream) and does
// not synchronise.  It returns cudaGetLastError() after the launch: a
// refused launch never runs, and the caller must check the code.  The caller
// validates shapes (G, M, N, K >= 1, grid limits), dtypes and contiguity.

// The floats of the fp32 workspace `ws` that aug_sgemm_grouped and
// aug_gemm_typed (fp32) take for G groups of (M, K) operands a; the caller
// allocates it.  bf16 takes none.
extern "C" size_t aug_workspace_floats(int G, int M, int K) {
    return split_floats(G, M, K);
}

// K2: slot-indexed, fp32.  gidx (G,) int32 into a stack of S slots.
extern "C" int aug_sgemm_grouped(const void* a, const void* gidx, const void* b,
                                 void* out, void* ws, int G, int M, int N, int K,
                                 int S, int device, void* stream) {
    return launch_f32(a, gidx, b, out, ws, nullptr, G, M, N, K, S, 1, device, stream);
}

// K5: one matrix per group (b has G slots, slot = group index); fp32 or
// bf16 operands (bf16 != 0).
extern "C" int aug_gemm_typed(const void* a, const void* b, void* out, void* ws,
                              int G, int M, int N, int K, int bf16, int device,
                              void* stream) {
    if (!bf16)
        return launch_f32(a, nullptr, b, out, ws, nullptr, G, M, N, K, G, 1, device, stream);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto* ha = static_cast<const __nv_bfloat16*>(a);
    const auto* hb = static_cast<const __nv_bfloat16*>(b);
    auto* ho = static_cast<__nv_bfloat16*>(out);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = M > 64 ? launch_hgemm<Wide>(ha, hb, ho, G, M, N, K, st)
                 : launch_hgemm<Narrow>(ha, hb, ho, G, M, N, K, st);
    return static_cast<int>(err);
}

// K4 in fp32: one matrix per group (b has G slots), its sum over K in
// `splits` slices of ceil(ceil(K / 32) / splits) stages, none empty (the
// caller's rule, kernels/gemm.py tf32_splits), added in slice order by a
// third launch into out; part holds splits * G * M * N floats where splits
// > 1 (ignored, may be null, for one slice).
extern "C" int aug_sgemm_split(const void* a, const void* b, void* out, void* ws,
                               void* part, int G, int M, int N, int K, int splits,
                               int device, void* stream) {
    return launch_f32(a, nullptr, b, out, ws, part, G, M, N, K, G, splits, device, stream);
}

extern "C" const char* aug_gemm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
