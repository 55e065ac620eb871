// Block-tiled GEMM for Hopper (sm_90a): C[m, n] = A[m, k] @ B[k, n].
//
// Replaces the TPU kernel repro/kernels/gemm.py:gemm (_gemm_kernel, launched
// by the pl.pallas_call at gemm.py:71): a k-innermost, output-stationary
// grid whose (bm, bn) output tile stays in an fp32 VMEM accumulator across
// the contraction.  Here one thread block owns one 128 x 128 output tile
// and walks k in an in-block loop (blocks run in parallel and in no order
// on Hopper, so nothing is carried across blocks); each of its 256 threads
// keeps an 8 x 8 fp32 micro-tile of the accumulator in registers.
//
// What bounds it on this card.  At the shapes the calibration path runs
// (m = 4096, n and k of 1024..5632) the function is far above the H100's
// ridge point: 2mnk flops against (mk + kn + mn) elements of traffic gives
// several hundred flops per byte, so the bound is operations, not bytes.
// The kernel computes with FFMA in IEEE fp32 (never TF32: the reference's
// fp32 tolerance is rtol 1e-4), so its ceiling is the card's 67 TFLOP/s of
// fp32 outside the tensor cores; bf16 inputs are widened to fp32 on the way
// into shared memory and run the same FFMA path, so bf16 is also held to
// the fp32 FFMA rate, far below the 989 TFLOP/s tensor-core bound.
//
// What the design does about it.  The 8 x 8 register micro-tile gives 64
// FMAs per 16 shared-memory operands; operands are read as float4 (A is
// stored transposed, padded by 4 floats to keep the transposing stores free
// of bank conflicts); the next k-slab is fetched into registers while the
// current one is multiplied, hiding global-memory latency; and
// __launch_bounds__(256, 2) keeps two blocks resident per SM.  Ragged edges
// are masked on load (zero fill) and on store, so any (m, n, k) works and
// no divisor block shape is needed.  wgmma, TMA and a tensor-core bf16 path
// are later work.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                              // block tile rows
constexpr int BN = 128;                              // block tile cols
constexpr int BK = 8;                                // k-slab depth
constexpr int TM = 8;                                // micro-tile rows
constexpr int TN = 8;                                // micro-tile cols
constexpr int THREADS = (BM / TM) * (BN / TN);       // 256
constexpr int APAD = 4;                              // keeps float4 alignment
constexpr int A_PER_THREAD = BM * BK / THREADS;      // 4
constexpr int B_PER_THREAD = BK * BN / THREADS;      // 4

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

template <typename TIn>
__device__ __forceinline__ void load_slab(const TIn* __restrict__ A,
                                          const TIn* __restrict__ B,
                                          int M, int N, int K, int row0,
                                          int col0, int k0, int tid,
                                          float (&ra)[A_PER_THREAD],
                                          float (&rb)[B_PER_THREAD]) {
#pragma unroll
    for (int p = 0; p < A_PER_THREAD; ++p) {
        const int i = tid + p * THREADS;
        const int r = i / BK, c = i % BK;
        const int gr = row0 + r, gc = k0 + c;
        ra[p] = (gr < M && gc < K) ? to_f32(A[(size_t)gr * K + gc]) : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < B_PER_THREAD; ++p) {
        const int i = tid + p * THREADS;
        const int r = i / BN, c = i % BN;
        const int gr = k0 + r, gc = col0 + c;
        rb[p] = (gr < K && gc < N) ? to_f32(B[(size_t)gr * N + gc]) : 0.0f;
    }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
            TOut* __restrict__ C, int M, int N, int K) {
    __shared__ __align__(16) float As[BK][BM + APAD];  // transposed: As[k][m]
    __shared__ __align__(16) float Bs[BK][BN];

    const int tid = threadIdx.x;
    const int tr = tid / (BN / TN);                    // 0..15
    const int tc = tid % (BN / TN);                    // 0..15
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    float ra[A_PER_THREAD], rb[B_PER_THREAD];
    load_slab(A, B, M, N, K, row0, col0, 0, tid, ra, rb);

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
        for (int p = 0; p < A_PER_THREAD; ++p) {
            const int i = tid + p * THREADS;
            As[i % BK][i / BK] = ra[p];
        }
#pragma unroll
        for (int p = 0; p < B_PER_THREAD; ++p) {
            const int i = tid + p * THREADS;
            Bs[i / BN][i % BN] = rb[p];
        }
        __syncthreads();
        // fetch the next slab while this one is multiplied
        if (k0 + BK < K)
            load_slab(A, B, M, N, K, row0, col0, k0 + BK, tid, ra, rb);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * 4]);
            const float4 a1 =
                *reinterpret_cast<const float4*>(&As[kk][BM / 2 + tr * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tc * 4]);
            const float4 b1 =
                *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tc * 4]);
            const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gr = row0 + (i < 4 ? tr * 4 + i : BM / 2 + tr * 4 + i - 4);
        if (gr >= M) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gc = col0 + (j < 4 ? tc * 4 + j : BN / 2 + tc * 4 + j - 4);
            if (gc < N) store_as(&C[(size_t)gr * N + gc], acc[i][j]);
        }
    }
}

template <typename TIn, typename TOut>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            cudaStream_t stream) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    gemm_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
        static_cast<const TIn*>(a), static_cast<const TIn*>(b),
        static_cast<TOut*>(c), m, n, k);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError()
// right after the launch (0 = cudaSuccess); the launch is asynchronous.
extern "C" int repro_gemm(const void* a, const void* b, void* c, int m,
                          int n, int k, int in_dtype, int out_dtype,
                          void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_dtype == 0 && out_dtype == 0)
        launch<float, float>(a, b, c, m, n, k, s);
    else if (in_dtype == 0 && out_dtype == 1)
        launch<float, __nv_bfloat16>(a, b, c, m, n, k, s);
    else if (in_dtype == 1 && out_dtype == 1)
        launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, s);
    else if (in_dtype == 1 && out_dtype == 0)
        launch<__nv_bfloat16, float>(a, b, c, m, n, k, s);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
