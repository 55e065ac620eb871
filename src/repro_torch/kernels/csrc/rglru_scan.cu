// RG-LRU linear-recurrence scan for Hopper (sm_90a): h_t = a_t h_{t-1} + b_t.
//
// Replaces the TPU kernel repro/kernels/rglru.py:rglru_scan (_rglru_kernel,
// launched by the pl.pallas_call at rglru.py:50): a (batch, seq blocks) grid
// whose sequence blocks run in order, carrying h in fp32 VMEM scratch from
// one block to the next while a fori_loop walks the rows of each block.
// Hopper runs blocks in parallel and in no order, so nothing can be carried
// between them: here one thread owns one (batch, channel) and walks the
// whole sequence itself, with h in a register from h0 to the last step.
//
// What it computes.  a, b: (batch, seq, width), both float32 or both
// bfloat16 (widened to fp32 on load, as the TPU kernel casts to fp32
// first); h0: (batch, width) fp32; out: (batch, seq, width) fp32.  Each step
// is a rounded product then a rounded sum (no fused multiply-add), so the
// output is bit for bit the sequential plain version's
// (repro_torch/kernels/ref.py:rglru_scan_ref), whatever the block size.
//
// What bounds it on this card.  Two flops per element against 2 reads and
// one fp32 write: it is bound by bytes.  At recurrentgemma-2b's prefill
// (batch 2, seq 2048, width 2560, fp32 a and b) that is 126 MB, 37.6 us at
// 3.35 TB/s.
//
// What the design does about it.  Neighbouring threads take neighbouring
// channels, so every load and store of a warp is one coalesced 128-byte
// (fp32) or 64-byte (bf16) transaction; each thread loads the next PREFETCH
// steps of a and b into registers before it computes them, keeping 2 x
// PREFETCH loads in flight per thread to cover the memory latency.  The
// parallelism is batch x width threads only: 5,120 at recurrentgemma's
// prefill, 80 blocks of 64 -- fewer than the 132 SMs, so the card's
// bandwidth is out of reach.  A chunked two-pass scan (per-chunk carries,
// then a fix-up pass) that fills the card is later work.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;                // channels per block
constexpr int PREFETCH = 16;               // steps loaded ahead per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_kernel(const T* __restrict__ a, const T* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ out,
             int seq, int width) {
    const int c = blockIdx.x * THREADS + threadIdx.x;
    const int n = blockIdx.y;
    if (c >= width) return;
    const long long base = (long long)n * seq * width + c;
    float h = h0[(long long)n * width + c];
    for (int t0 = 0; t0 < seq; t0 += PREFETCH) {
        float av[PREFETCH], bv[PREFETCH];
#pragma unroll
        for (int i = 0; i < PREFETCH; ++i) {
            if (t0 + i < seq) {
                const long long off = base + (long long)(t0 + i) * width;
                av[i] = to_f32(a[off]);
                bv[i] = to_f32(b[off]);
            }
        }
#pragma unroll
        for (int i = 0; i < PREFETCH; ++i) {
            if (t0 + i < seq) {
                // product then sum, each rounded: the plain version's order
                h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
                out[base + (long long)(t0 + i) * width] = h;
            }
        }
    }
}

}  // namespace

// a, b (batch, seq, width) contiguous, dtype 0 = float32, 1 = bfloat16 (both
// the same); h0 (batch, width) float32 contiguous; out (batch, seq, width)
// float32 contiguous.  Returns cudaGetLastError() right after the launch
// (0 = cudaSuccess); the launch is asynchronous.
extern "C" int repro_rglru_scan(const void* a, const void* b, const float* h0,
                                float* out, int batch, int seq, int width,
                                int dtype, void* stream) {
    if (batch < 1 || batch > 65535 || seq < 1 || width < 1)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((width + THREADS - 1) / THREADS, batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        rglru_kernel<float><<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(a), static_cast<const float*>(b), h0,
            out, seq, width);
    } else if (dtype == 1) {
        rglru_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(a),
            static_cast<const __nv_bfloat16*>(b), h0, out, seq, width);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
