// RG-LRU linear-recurrence scan for Hopper (sm_90a): h_t = a_t h_{t-1} + b_t.
//
// Replaces the TPU kernel repro/kernels/rglru.py:rglru_scan (_rglru_kernel,
// launched by the pl.pallas_call at rglru.py:50): a (batch, seq blocks) grid
// whose sequence blocks run in order, carrying h in fp32 VMEM scratch from
// one block to the next while a fori_loop walks the rows of each block.
// Hopper runs blocks in parallel and in no order, so nothing can be carried
// between them: here each channel's whole sequence is walked by one thread,
// with h in a register from h0 to the last step.
//
// What it computes.  a, b: (batch, seq, width), both float32 or both
// bfloat16 (widened to fp32 on load, as the TPU kernel casts to fp32
// first); h0: (batch, width) fp32; out: (batch, seq, width) fp32.  Each step
// is a rounded product then a rounded sum (__fmul_rn, __fadd_rn: never
// contracted to an FFMA), so the output is bit for bit the sequential plain
// version's (repro_torch/kernels/ref.py:rglru_scan_ref), whatever the block
// size.
//
// What bounds it on this card.  Two flops per element against 2 reads and
// one fp32 write: it is bound by bytes.  At recurrentgemma-2b's prefill
// (batch 2, seq 2048, width 2560, fp32 a and b) that is 126 MB, 37.6 us at
// 3.35 TB/s.  The walk itself is short: 2,048 dependent steps of an FMUL
// then an FADD, about 8 cycles each, are ~10 us at the card's clock.
//
// What the design does about it: bytes in flight.  At the bound, by
// Little's law, the card needs 2-3.5 MB of reads in flight (0.6-1 us of
// loaded DRAM latency at 3.35 TB/s).  rglru_ring_kernel gives each warp its
// own block and 32 neighbouring channels of one batch row (lane = channel,
// so a row of a tile is one 128-byte segment in fp32), grid (width / 32,
// batch): 160 blocks at the prefill shape.  A ring of RING_STAGES tiles of
// RING_ROWS steps x 32 channels of a and b lives in dynamic shared memory
// (64 KB in fp32, three blocks an SM), filled by 16-byte cp.async copies.
// The warp starts the copies of tile i + RING_STAGES - 1, waits for tile i
// (cp.async.wait_group RING_STAGES - 1, then __syncwarp so that every
// lane's copies are seen by all), and walks tile i from shared memory
// while the next three are in flight: ~48 KB a block, ~7.7 MB across the
// card.  Each step's output is one coalesced 128-byte store of the warp.
// Ragged edges: copies of lanes past `width` are zero-filled (src-size 0)
// and those lanes store nothing; rows past `seq` are zero-filled and never
// walked.
//
// Why the walk stays sequential.  A chunked scan (per-chunk carries, then
// a fix-up pass) would fill the card with more threads, but it reassociates
// the recurrence, and the output would no longer be the plain version's bit
// for bit, as the TPU kernel's in-order walk is.  Parallelism over time is
// not what is missing: the ~10 us chain fits under the 37.6 us bound.
//
// The ring copies 16 bytes at a time, so it takes width % 4 == 0 (fp32) or
// width % 8 == 0 (bf16) and a, b 16-byte aligned.  For any other shape the
// caller asks for rglru_kernel, the element-wise variant: one thread per
// (batch, channel), blocks of 64 channels, the next PREFETCH steps of a and
// b loaded into registers before they are walked.  The variant is chosen in
// Python (repro_torch/kernels/rglru.py:kernel_variant) and passed in; both
// variants compute the same bits.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_sync.cuh"

namespace {

constexpr int THREADS = 64;                // element-wise: channels per block
constexpr int PREFETCH = 16;               // element-wise: steps loaded ahead
constexpr int LANES = 32;                  // ring: channels per block (a warp)
constexpr int RING_ROWS = 64;              // ring: steps per tile
constexpr int RING_STAGES = 4;             // ring: tiles in shared memory

// the ring's dynamic shared memory: RING_STAGES x {a, b} x a tile
template <typename T>
constexpr int ring_smem() {
    return RING_STAGES * 2 * RING_ROWS * LANES * (int)sizeof(T);
}

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

template <typename T>
__global__ void __launch_bounds__(LANES)
rglru_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int seq, int width) {
    constexpr int PER_COPY = 16 / (int)sizeof(T);       // channels a copy
    constexpr int COPIES_PER_ROW = LANES / PER_COPY;    // 8 fp32, 4 bf16
    constexpr int ROWS_PER_PASS = LANES / COPIES_PER_ROW;
    constexpr int TILE = RING_ROWS * LANES;             // elements a tile
    extern __shared__ __align__(16) unsigned char smem[];
    const T* ring = reinterpret_cast<const T*>(smem);   // [slot][a|b][row][lane]
    const int lane = threadIdx.x;
    const int c0 = blockIdx.x * LANES;
    const long long row0 = (long long)blockIdx.y * seq; // row of (n, t = 0)
    const int n_tiles = (seq + RING_ROWS - 1) / RING_ROWS;

    // this lane's copies: 16 bytes at column `ccol` of rows crow + k *
    // ROWS_PER_PASS; each is wholly inside `width` or wholly past it
    const int crow = lane / COPIES_PER_ROW;
    const int ccol = (lane % COPIES_PER_ROW) * PER_COPY;
    const bool col_ok = c0 + ccol < width;
    const unsigned ring_u32 = smem_u32(smem);
    auto load_tile = [&](int tile) {
        const int t0 = tile * RING_ROWS;
        const unsigned slot = ring_u32
            + (unsigned)((tile % RING_STAGES) * 2 * TILE * sizeof(T));
#pragma unroll
        for (int k = 0; k < RING_ROWS / ROWS_PER_PASS; ++k) {
            const int r = crow + k * ROWS_PER_PASS;
            const bool ok = col_ok && t0 + r < seq;
            const long long off = ok ? (row0 + t0 + r) * width + c0 + ccol
                                     : 0;
            const unsigned dst = slot + (unsigned)((r * LANES + ccol)
                                                   * sizeof(T));
            cp_async16(dst, a + off, ok);
            cp_async16(dst + TILE * sizeof(T), b + off, ok);
        }
    };

    const int c = c0 + lane;
    const bool live = c < width;
    float h = live ? h0[blockIdx.y * (long long)width + c] : 0.f;
    float* o = out + row0 * width + c;
#pragma unroll
    for (int s = 0; s < RING_STAGES - 1; ++s) {
        if (s < n_tiles) load_tile(s);
        cp_async_commit();                 // empty groups keep the count
    }
    for (int i = 0; i < n_tiles; ++i) {
        // slot (i - 1) % RING_STAGES was walked, and the warp synced, last
        if (i + RING_STAGES - 1 < n_tiles) load_tile(i + RING_STAGES - 1);
        cp_async_commit();
        cp_async_wait<RING_STAGES - 1>();  // this lane's copies of tile i
        __syncwarp();                      // ... and every other lane's
        const T* sa = ring + (i % RING_STAGES) * 2 * TILE + lane;
        const T* sb = sa + TILE;
        const int rows = min(RING_ROWS, seq - i * RING_ROWS);
        if (rows == RING_ROWS) {
#pragma unroll 16
            for (int r = 0; r < RING_ROWS; ++r) {
                // product then sum, each rounded: the plain version's order
                h = __fadd_rn(__fmul_rn(to_f32(sa[r * LANES]), h),
                              to_f32(sb[r * LANES]));
                if (live) o[(long long)r * width] = h;
            }
        } else {
            for (int r = 0; r < rows; ++r) {
                h = __fadd_rn(__fmul_rn(to_f32(sa[r * LANES]), h),
                              to_f32(sb[r * LANES]));
                if (live) o[(long long)r * width] = h;
            }
        }
        o += (long long)RING_ROWS * width;
        __syncwarp();                      // the slot is free to refill
    }
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, float* out,
           int batch, int seq, int width, int variant, cudaStream_t s) {
    const T* at = static_cast<const T*>(a);
    const T* bt = static_cast<const T*>(b);
    if (variant == 0) {
        const dim3 grid((width + THREADS - 1) / THREADS, batch);
        rglru_kernel<T><<<grid, THREADS, 0, s>>>(at, bt, h0, out, seq, width);
        return (int)cudaGetLastError();
    }
    if (variant != 1 || width % (16 / (int)sizeof(T))
        || (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b))
               % 16)
        return (int)cudaErrorInvalidValue;
    static bool configured = false;
    const int rc = set_smem(rglru_ring_kernel<T>, ring_smem<T>(), configured);
    if (rc) return rc;
    const dim3 grid((width + LANES - 1) / LANES, batch);
    rglru_ring_kernel<T><<<grid, LANES, ring_smem<T>(), s>>>(
        at, bt, h0, out, seq, width);
    return (int)cudaGetLastError();
}

}  // namespace

// a, b (batch, seq, width) contiguous, dtype 0 = float32, 1 = bfloat16 (both
// the same); h0 (batch, width) float32 contiguous; out (batch, seq, width)
// float32 contiguous.  variant 0 = the element-wise kernel (any shape), 1 =
// the cp.async ring (width a multiple of 16 bytes' elements, a and b
// 16-byte aligned; anything else is refused).  Returns cudaGetLastError()
// right after the launch (0 = cudaSuccess); the launch is asynchronous.
extern "C" int repro_rglru_scan(const void* a, const void* b, const float* h0,
                                float* out, int batch, int seq, int width,
                                int dtype, int variant, void* stream) {
    if (batch < 1 || batch > 65535 || seq < 1 || width < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch<float>(a, b, h0, out, batch, seq, width, variant, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(a, b, h0, out, batch, seq, width,
                                     variant, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
