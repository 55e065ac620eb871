// Tensor-core GEMM for Hopper (sm_90a): C[m, n] = A[m, k] @ B[k, n].
//
// Replaces the TPU kernel repro/kernels/gemm.py:gemm (_gemm_kernel, launched
// by the pl.pallas_call at gemm.py:71): a k-innermost, output-stationary
// grid whose (bm, bn) output tile stays in an fp32 VMEM accumulator across
// the contraction.  Here one block of 8 warps owns one 128 x 128 output
// tile and walks k in an in-block loop (blocks run in parallel and in no
// order on Hopper, so nothing is carried across blocks); each warp owns a
// 64 x 32 warp tile, kept in fp32 registers in the mma C-fragment layout.
//
// What bounds it on this card.  At the shapes the calibration path runs
// (m = 4096, n and k of 1024..5632) the function is far above the H100's
// ridge point (several hundred flops per byte), so the bound is
// operations: for bf16 inputs the tensor cores' 989 TFLOP/s; for f32
// inputs three TF32 products at 495 TFLOP/s each (below), where the FFMA
// units outside the tensor cores would give 67 TFLOP/s.
//
// What the design does about it.  Both input types run mma.sync on the
// tensor cores, fed by a three-stage cp.async ring in dynamic shared
// memory (16-byte copies; the next two k-slabs are in flight while this
// one is multiplied).  A slab is 128 bytes of k: 32 f32 or 64 bf16.
//  * bf16: mma.sync.m16n8k16 (bf16 in, fp32 accumulate); A's fragments
//    from ldmatrix.x4, B's (k x n, row-major) from ldmatrix.x4.trans.
//    Products are exact in fp32: the result is gemm_plain's up to the
//    order of the sums.
//  * f32: 3xTF32 on mma.sync.m16n8k8.tf32.  The reference holds f32 to
//    rtol 1e-4, and one TF32 product keeps about three digits.  Each
//    operand is split in registers into hi = tf32(x) and lo = tf32(x -
//    hi), rounded to nearest (ties away, as cvt.rna); the kernel sums
//    lo.hi + hi.lo + hi.hi (lo.lo is below fp32's last bit).  Inf and
//    NaN get their own split (split_tf32), so that they give what the
//    FFMA product gives.  The tensor cores' fp32 accumulation need not
//    round to nearest (earlier generations truncate), and over k = 2816
//    such a bias would grow past the FFMA product's error; so each slab
//    is summed from zero on the tensor cores and added to the running sum
//    with a rounded FADD.  TF32 fragments are 32-bit and are read with
//    plain shared loads.
// Shared rows are padded (A by 16 bytes, B by 8 elements) so that the
// fragment reads and ldmatrix rows of a warp fall in distinct banks.
// Ragged edges: rows or columns past m, n or k are zero-filled on load
// (cp.async's src-size 0), so no value past an edge reaches a product, and
// masked on store.  Where a row pitch or a base pointer is not 16-byte
// aligned (f32 with k or n % 4 != 0, bf16 with k or n % 8 != 0) the
// C entry picks the variant that loads element by element into the same
// ring.
//
// Tiles: 128 x 128 blocks of 8 warps; bf16 (128 registers) fits two
// blocks on an SM, 3xTF32 (two accumulator sets, about 240 registers) one.
// No instantiation spills.  Wider tiles (128 x 256, or 64 x 64 warp tiles)
// and deeper rings were slower or no faster on the H100.  Beside its three
// MMAs, the f32 path spends time splitting the operands, which each warp
// repeats for the fragments it shares with the others.
//
// What is left: wgmma fed by TMA (the only way to the card's full
// tensor-core rate), and honouring CrossFlow's L1 block shape by
// compiling a set of tiles.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                      // block tile rows
constexpr int BN = 128;                      // block tile cols
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;   // 256
constexpr int WM = BM / WARPS_M;             // 64: warp tile rows
constexpr int WN = BN / WARPS_N;             // 32: warp tile cols
constexpr int MT = WM / 16;                  // m16 tiles per warp
constexpr int NT = WN / 8;                   // n8 tiles per warp
constexpr int STAGES = 3;

template <typename T>
struct Tile {
    static constexpr int BK = 128 / sizeof(T);      // slab depth
    static constexpr int EPC = 16 / sizeof(T);      // elements per copy
    static constexpr int LDA = BK + EPC;            // A row, padded
    static constexpr int LDB = BN + 8;              // B row, padded
    static constexpr int A_ELEMS = BM * LDA;
    static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
    static constexpr int SMEM = STAGES * STAGE_ELEMS * (int)sizeof(T);
    static constexpr int A_CPR = BK / EPC;          // copies per A row
    static constexpr int B_CPR = BN / EPC;          // copies per B row
    static constexpr int A_COPIES = BM * BK / EPC / THREADS;   // per thread
    static constexpr int B_COPIES = BK * BN / EPC / THREADS;
    static_assert(A_COPIES * THREADS * EPC == BM * BK, "whole copies");
    static_assert(B_COPIES * THREADS * EPC == BK * BN, "whole copies");
};

// One copy unit (16 bytes) of a slab row: `avail` elements of the row are
// left from `src` on.  VEC: one cp.async (the caller guarantees 16-byte
// alignment and whole units).  Otherwise element by element, zero past
// the edge.
template <typename T, bool VEC>
__device__ __forceinline__ void copy_unit(T* dst, const T* src,
                                          const T* base, bool row_ok,
                                          int avail) {
    constexpr int EPC = Tile<T>::EPC;
    if constexpr (VEC) {
        const bool ok = row_ok && avail > 0;
        cp_async16(smem_u32(dst), ok ? src : base, ok);
    } else {
        using Raw = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;
        const Raw* s = reinterpret_cast<const Raw*>(src);
        Raw* d = reinterpret_cast<Raw*>(dst);
#pragma unroll
        for (int e = 0; e < EPC; ++e)
            d[e] = (row_ok && e < avail) ? s[e] : Raw(0);
    }
}

// slab k0 of A (BM x BK) and B (BK x BN) into one ring stage
template <typename T, bool VEC>
__device__ __forceinline__ void load_slab(T* stage, const T* __restrict__ A,
                                          const T* __restrict__ B, int M,
                                          int N, int K, int row0, int col0,
                                          int k0, int tid) {
    using TL = Tile<T>;
    T* As = stage;
    T* Bs = stage + TL::A_ELEMS;
#pragma unroll
    for (int p = 0; p < TL::A_COPIES; ++p) {
        const int i = tid + p * THREADS;
        const int r = i / TL::A_CPR, c = (i % TL::A_CPR) * TL::EPC;
        const int gr = row0 + r, gc = k0 + c;
        copy_unit<T, VEC>(As + r * TL::LDA + c, A + (size_t)gr * K + gc, A,
                          gr < M, K - gc);
    }
#pragma unroll
    for (int p = 0; p < TL::B_COPIES; ++p) {
        const int i = tid + p * THREADS;
        const int r = i / TL::B_CPR, c = (i % TL::B_CPR) * TL::EPC;
        const int gr = k0 + r, gc = col0 + c;
        copy_unit<T, VEC>(Bs + r * TL::LDB + c, B + (size_t)gr * N + gc, B,
                          gr < K, N - gc);
    }
}

// ---- f32: 3xTF32 on m16n8k8 ------------------------------------------------

// Bits of a finite float32 rounded to TF32 (10 mantissa bits), to nearest
// with ties away from zero, as cvt.rna.tf32.f32 rounds: add half a unit of
// the 13 dropped bits to the magnitude, clear them.  On the H100 this
// measured faster than cvt.rna; split_tf32 keeps Inf, NaN and the values
// that would round past FLT_MAX away from it.
__device__ __forceinline__ unsigned tf32_rna(unsigned bits) {
    return (bits + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi).  Where x is Inf or NaN,
// or rounds past FLT_MAX (where the bit rounding would carry into the
// sign), hi is +-1 and lo is x - hi, unrounded, so that lo.hi + hi.lo +
// hi.hi meets Inf or NaN where x.y does and nowhere else: with hi = Inf,
// hi.lo would be Inf * 0 (a NaN) wherever y is a TF32 value (lo(y) = 0).
// Inf . y comes from lo(x).hi(y) (hi(y) is 0 only where y is), Inf . Inf
// from both cross terms, of one sign; a NaN in lo reaches every product
// of its row or column.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
    const unsigned u = __float_as_uint(x);
    const bool big = !(fabsf(x) < __uint_as_float(0x7f7ff000u));
    hi = big ? (u & 0x80000000u) | 0x3f800000u : tf32_rna(u);
    const unsigned rest = __float_as_uint(x - __uint_as_float(hi));
    lo = big ? rest : tf32_rna(rest);
}

// c (16 x 8, fp32) += a (16 x 8, tf32, row) . b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
                   "r"(b[0]), "r"(b[1]));
}

// acc += this stage's slab, for the warp tile at (wr, wc) of the block
// tile; g = lane / 4, t = lane % 4 (the fragments' row group and column)
__device__ __forceinline__ void slab_f32(float (&acc)[MT][NT][4],
                                         const float* stage, int wr,
                                         int wc, int lane) {
    using TL = Tile<float>;
    const int g = lane >> 2, t = lane & 3;
    const float* As = stage + (wr + g) * TL::LDA + t;
    const float* Bs = stage + TL::A_ELEMS + t * TL::LDB + wc + g;
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < TL::BK; kk += 8) {
        unsigned ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            const float* a = As + i * 16 * TL::LDA + kk;
            split_tf32(a[0], ahi[i][0], alo[i][0]);              // (g, t)
            split_tf32(a[8 * TL::LDA], ahi[i][1], alo[i][1]);    // (g+8, t)
            split_tf32(a[4], ahi[i][2], alo[i][2]);              // (g, t+4)
            split_tf32(a[8 * TL::LDA + 4], ahi[i][3], alo[i][3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const float* b = Bs + kk * TL::LDB + j * 8;
            split_tf32(b[0], bhi[j][0], blo[j][0]);              // (k t, n g)
            split_tf32(b[4 * TL::LDB], bhi[j][1], blo[j][1]);    // (t+4, g)
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j) {   // small terms first
                mma_tf32(part[i][j], alo[i], bhi[j]);
                mma_tf32(part[i][j], ahi[i], blo[j]);
                mma_tf32(part[i][j], ahi[i], bhi[j]);
            }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// ---- bf16: m16n8k16 ---------------------------------------------------------

__device__ __forceinline__ void slab_bf16(float (&acc)[MT][NT][4],
                                          const bf16* stage, int wr, int wc,
                                          int lane) {
    using TL = Tile<bf16>;
    // ldmatrix row addresses: A's four 8x8 matrices are (rows 0-7 | 8-15)
    // x (k 0-7 | 8-15) of a 16 x 16 tile; B's are (k 0-7 | 8-15) x
    // (n 0-7 | 8-15), transposed into the col operand of two n8 tiles
    const unsigned a0 = smem_u32(stage + (wr + (lane & 15)) * TL::LDA
                                 + (lane >> 4) * 8);
    const unsigned b0 = smem_u32(
        stage + TL::A_ELEMS
        + ((lane & 7) + ((lane >> 3) & 1) * 8) * TL::LDB + wc
        + (lane >> 4) * 8);
#pragma unroll
    for (int kk = 0; kk < TL::BK; kk += 16) {
        unsigned a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
            ldsm_x4(a0 + (i * 16 * TL::LDA + kk) * 2, a[i]);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
            unsigned r[4];
            ldsm_x4_trans(b0 + (kk * TL::LDB + j * 8) * 2, r);
            b[j][0] = r[0];
            b[j][1] = r[1];
            b[j + 1][0] = r[2];
            b[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
                mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
}

// ---- the kernel ---------------------------------------------------------------

__device__ __forceinline__ void store_pair(float* p, float x, float y,
                                           bool both_ok, bool paired) {
    if (paired) {
        *reinterpret_cast<float2*>(p) = make_float2(x, y);
        return;
    }
    p[0] = x;
    if (both_ok) p[1] = y;
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y,
                                           bool both_ok, bool paired) {
    if (paired) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
        return;
    }
    p[0] = __float2bfloat16_rn(x);
    if (both_ok) p[1] = __float2bfloat16_rn(y);
}

// bf16 fits two blocks on an SM (128 registers); 3xTF32 holds two sets of
// accumulators and takes one
template <typename T, typename TOut, bool VEC>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            TOut* __restrict__ C, int M, int N, int K) {
    using TL = Tile<T>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* smem = reinterpret_cast<T*>(smem_raw);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wr = (warp % WARPS_M) * WM;          // warp tile in the block
    const int wc = (warp / WARPS_M) * WN;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    const int slabs = (K + TL::BK - 1) / TL::BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {         // fill the ring
        if (s < slabs)
            load_slab<T, VEC>(smem + s * TL::STAGE_ELEMS, A, B, M, N, K,
                              row0, col0, s * TL::BK, tid);
        cp_async_commit();
    }
    for (int s = 0; s < slabs; ++s) {
        cp_async_wait<STAGES - 2>();               // slab s has landed
        __syncthreads();                           // ... for every thread,
        const int next = s + STAGES - 1;           // and slab s-1 is read
        if (next < slabs)
            load_slab<T, VEC>(smem + (next % STAGES) * TL::STAGE_ELEMS, A,
                              B, M, N, K, row0, col0, next * TL::BK, tid);
        cp_async_commit();
        const T* stage = smem + (s % STAGES) * TL::STAGE_ELEMS;
        if constexpr (std::is_same_v<T, float>)
            slab_f32(acc, stage, wr, wc, lane);
        else
            slab_bf16(acc, stage, wr, wc, lane);
    }
    cp_async_wait<0>();                            // nothing left in flight

    // C fragment: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int c = col0 + wc + j * 8 + 2 * t;
            if (c >= N) continue;
            const bool both = c + 1 < N;           // VEC: n is even
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = row0 + wr + i * 16 + g + 8 * h;
                if (r < M)
                    store_pair(C + (size_t)r * N + c, acc[i][j][2 * h],
                               acc[i][j][2 * h + 1], both, VEC);
            }
        }
    }
}

template <typename T, typename TOut, bool VEC>
int launch(const void* a, const void* b, void* c, int m, int n, int k,
           cudaStream_t stream) {
    using TL = Tile<T>;
    static bool configured = false;
    const int rc = set_smem(gemm_kernel<T, TOut, VEC>, TL::SMEM, configured);
    if (rc) return rc;
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    gemm_kernel<T, TOut, VEC><<<grid, THREADS, TL::SMEM, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<TOut*>(c), m, n, k);
    return (int)cudaGetLastError();
}

template <typename T, typename TOut>
int launch_variant(const void* a, const void* b, void* c, int m, int n,
                   int k, cudaStream_t s) {
    // 16-byte copies where no copy can start off alignment or cross the
    // end of a row of A (k) or B (n); else element by element
    constexpr int per = 16 / sizeof(T);
    const uintptr_t addr = reinterpret_cast<uintptr_t>(a)
        | reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c);
    const bool vec = !(addr & 15) && k % per == 0 && n % per == 0;
    return vec ? launch<T, TOut, true>(a, b, c, m, n, k, s)
               : launch<T, TOut, false>(a, b, c, m, n, k, s);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Any m, n, k >= 1, row-major
// operands.  Returns cudaGetLastError() right after the launch (0 =
// cudaSuccess); the launch is asynchronous.
extern "C" int repro_gemm(const void* a, const void* b, void* c, int m,
                          int n, int k, int in_dtype, int out_dtype,
                          void* stream) {
    if (m < 1 || n < 1 || k < 1 || (m + BM - 1) / BM > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_dtype == 0 && out_dtype == 0)
        return launch_variant<float, float>(a, b, c, m, n, k, s);
    if (in_dtype == 0 && out_dtype == 1)
        return launch_variant<float, bf16>(a, b, c, m, n, k, s);
    if (in_dtype == 1 && out_dtype == 1)
        return launch_variant<bf16, bf16>(a, b, c, m, n, k, s);
    if (in_dtype == 1 && out_dtype == 0)
        return launch_variant<bf16, float>(a, b, c, m, n, k, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
