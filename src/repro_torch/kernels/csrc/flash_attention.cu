// Flash attention for Hopper (sm_90a): out = softmax(scale * q k^T + mask) v.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_attn_kernel, launched by the pl.pallas_call at flash_attention.py:100):
// a (batch*heads, q blocks, kv blocks) grid, kv innermost, whose running
// max m, sum l and output accumulator stay in fp32 VMEM scratch across the
// kv steps.  Blocks on Hopper run in parallel and in no order, so here one
// thread block owns one (batch*head, 64-row q tile) and walks the kv tiles
// itself; m, l and the accumulator live in registers for the whole walk.
//
// What it computes, beyond the TPU kernel.  On the serving path it stands
// in for models/common.py:chunked_attention, so it takes two host ints by
// value: q_offset (the absolute position of q[0] for the causal and window
// masks) and kv_len (keys at positions >= kv_len are masked; decode passes
// min(pos + 1, W) with causal off).  With q_offset = 0 and kv_len = skv it
// is the TPU kernel's function.  GQA reads kv head h / (h / h_kv) without
// materialising a repeat.  Masked scores are -1e30, as in the reference, so
// a row with no visible key averages every key as the reference does;
// positions past skv (the ragged edge) count for nothing.  P is rounded to
// v's dtype before P.V (flash_attention.py:63); l sums the unrounded P.
//
// Tiles that are fully masked for every row of the q tile (above the causal
// diagonal, behind the window, at or past kv_len) are skipped.  That is
// exact: once a row has seen a visible key, a masked entry contributes
// exp(-1e30 - m) = 0, and the correction factor zeroes whatever the row
// gathered before (the masked-block hazard, flash_attention.py:56-65).  The
// one case where skipping would change the output is a row with no visible
// key at all; a q tile that holds such a row walks every kv tile instead.
//
// What bounds it on this card.  Prefill at full width (qwen1.5-0.5b: b 2,
// 16 heads of 64, 2048 causal) does 4 * d flops per visible (q, k) pair
// against one read of q, k, v: hundreds of flops per byte, so it is bound
// by operations.  Decode (sq = 1 over a 160-entry cache) does 4 * d flops
// per key against 4 * d bytes of bf16 K and V: it is bound by the bytes of
// the KV read, and at 16 heads x batch 8 it is 128 blocks of one live row.
//
// What the design does about it.  Scores and P.V are FFMA on fp32 operands
// staged in shared memory (bf16 is widened on the way in), 256 threads each
// owning a 4 x 4 block of scores and a 4 x (d / 16) block of the output, so
// every shared operand feeds four FMAs; rows are padded by one float, which
// keeps the strided reads free of bank conflicts; the row max and sum are
// reduced with half-warp shuffles; fully masked tiles are skipped (half the
// causal prefill work); the q tiles run heaviest first.  Head dims 32, 64,
// 128 and 256 (recurrentgemma-2b); at d = 256 a thread keeps a 4 x 16
// output block and the block takes 214,016 B of dynamic shared memory (one
// block per SM, under the 227 KB cap), set with cudaFuncSetAttribute.  The bound stays
// out of reach for prefill (FFMA, not the tensor cores) and for decode (63
// of a tile's 64 rows are idle, no split over the cache): mma/wgmma, TMA
// and split-KV decode are later work.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;                    // q rows per block
constexpr int BKV = 64;                    // keys per kv tile
constexpr int THREADS = 256;               // 16 row groups x 16 lanes
constexpr int RPT = BQ / 16;               // rows per thread (4)
constexpr int CPT = BKV / 16;              // score columns per thread (4)
constexpr int LDP = BKV + 1;               // padded P row (floats)
constexpr float MASKED = -1e30f;

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long qs[3], ks[3], vs[3], os[3];  // (batch, head, seq) strides
    int h, group, sq, skv;
    int causal, window;                    // window <= 0: none
    int q_offset, kv_len;                  // kv_len <= skv
    float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}
// P as the TPU kernel feeds it to P.V: cast to v's dtype
__device__ __forceinline__ float p_as(float x, float) { return x; }
__device__ __forceinline__ float p_as(float x, __nv_bfloat16) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)((BQ + 2 * BKV) * (D + 1) + BQ * LDP);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const Params p) {
    constexpr int LD = D + 1;              // padded q/k/v row (floats)
    constexpr int DPT = D / 16;            // output columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;
    float* Ks = Qs + BQ * LD;
    float* Vs = Ks + BKV * LD;
    float* Ps = Vs + BKV * LD;

    const int tid = threadIdx.x;
    const int tr = tid / 16;               // row group: rows tr*4 .. tr*4+3
    const int tc = tid % 16;               // lane in the half warp
    const int rbase = tr * RPT;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
    const int b = blockIdx.y / p.h, hq = blockIdx.y % p.h;
    const int hk = hq / p.group;
    const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + hq * p.qs[1];
    const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
    const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
    T* og = static_cast<T*>(p.o) + b * p.os[0] + hq * p.os[1];

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, c = i % D;
        Qs[r * LD + c] = (q0 + r < p.sq)
            ? to_f32(qg[(long long)(q0 + r) * p.qs[2] + c]) : 0.0f;
    }

    // the kv tiles any row of this q tile can see; the empty rows form a
    // suffix or the whole tile, so the first and last rows decide
    const int first = p.q_offset + q0;
    const int last = p.q_offset + min(q0 + BQ, p.sq) - 1;
    auto lo_of = [&](int qpos) {
        return p.window > 0 ? max(0, qpos - p.window + 1) : 0;
    };
    auto hi_of = [&](int qpos) {
        return p.causal ? min(p.kv_len, qpos + 1) : p.kv_len;
    };
    int t_lo = 0, t_hi = (p.skv + BKV - 1) / BKV;
    if (hi_of(first) > lo_of(first) && hi_of(last) > lo_of(last)) {
        t_lo = lo_of(first) / BKV;
        t_hi = (hi_of(last) + BKV - 1) / BKV;
    }

    float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = MASKED;
        l[i] = 0.0f;
#pragma unroll
        for (int u = 0; u < DPT; ++u) acc[i][u] = 0.0f;
    }

    for (int t = t_lo; t < t_hi; ++t) {
        const int k0 = t * BKV;
        __syncthreads();                   // the last tile's reads are done
        for (int i = tid; i < BKV * D; i += THREADS) {
            const int r = i / D, c = i % D;
            float kx = 0.0f, vx = 0.0f;
            if (k0 + r < p.skv) {
                kx = to_f32(kg[(long long)(k0 + r) * p.ks[2] + c]);
                vx = to_f32(vg[(long long)(k0 + r) * p.vs[2] + c]);
            }
            Ks[r * LD + c] = kx;
            Vs[r * LD + c] = vx;
        }
        __syncthreads();

        float s[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) s[i][j] = 0.0f;
#pragma unroll 8
        for (int kk = 0; kk < D; ++kk) {
            float a[RPT], bk[CPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) a[i] = Qs[(rbase + i) * LD + kk];
#pragma unroll
            for (int j = 0; j < CPT; ++j) bk[j] = Ks[(tc + 16 * j) * LD + kk];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < CPT; ++j)
                    s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int qpos = p.q_offset + q0 + rbase + i;
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int kpos = k0 + tc + 16 * j;
                float x = -INFINITY;       // past skv: no key at all
                if (kpos < p.skv) {
                    bool vis = kpos < p.kv_len;
                    if (p.causal) vis = vis && kpos <= qpos;
                    if (p.window > 0) vis = vis && kpos > qpos - p.window;
                    x = vis ? s[i][j] * p.scale : MASKED;
                }
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mx));
            const float corr = expf(m[i] - m_new);
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const float pv = expf(s[i][j] - m_new);
                sum += pv;
                Ps[(rbase + i) * LDP + tc + 16 * j] = p_as(pv, T());
            }
            l[i] = l[i] * corr + half_warp_sum(sum);
#pragma unroll
            for (int u = 0; u < DPT; ++u) acc[i][u] *= corr;
            m[i] = m_new;
        }
        __syncwarp();                      // P rows are the half warp's own

#pragma unroll 4
        for (int j = 0; j < BKV; ++j) {
            float vv[DPT];
#pragma unroll
            for (int u = 0; u < DPT; ++u) vv[u] = Vs[j * LD + tc + 16 * u];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const float pij = Ps[(rbase + i) * LDP + j];
#pragma unroll
                for (int u = 0; u < DPT; ++u)
                    acc[i][u] = fmaf(pij, vv[u], acc[i][u]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = q0 + rbase + i;
        if (r >= p.sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int u = 0; u < DPT; ++u)
            store_as(&og[(long long)r * p.os[2] + tc + 16 * u],
                     acc[i][u] / den);
    }
}

template <typename T, int D>
int launch(const Params& p, int batch_heads, cudaStream_t stream) {
    static bool configured = false;        // one attribute call per variant
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes<D>());
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const dim3 grid((p.sq + BQ - 1) / BQ, batch_heads);
    attn_kernel<T, D><<<grid, THREADS, smem_bytes<D>(), stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int d, int batch_heads, cudaStream_t s) {
    switch (d) {
        case 32: return launch<T, 32>(p, batch_heads, s);
        case 64: return launch<T, 64>(p, batch_heads, s);
        case 128: return launch<T, 128>(p, batch_heads, s);
        case 256: return launch<T, 256>(p, batch_heads, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q (b, h, sq, d), k/v (b, h_kv, skv, d), o like q, each with unit stride
// over d and the (batch, head, seq) strides given in `strides` (12 values:
// q, k, v, o), in elements.  dtype: 0 = float32, 1 = bfloat16 (all four
// tensors).  window <= 0 means none; kv_len must be in [0, skv].  Returns
// cudaGetLastError() right after the launch (0 = cudaSuccess); the launch
// is asynchronous.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* strides, int b, int h,
                                     int h_kv, int sq, int skv, int d,
                                     int dtype, int causal, int window,
                                     int q_offset, int kv_len, float scale,
                                     void* stream) {
    if (b < 1 || h < 1 || h_kv < 1 || h % h_kv || sq < 1 || skv < 1 ||
        kv_len < 0 || kv_len > skv || q_offset < 0 || b * h > 65535)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    for (int i = 0; i < 3; ++i) {
        p.qs[i] = strides[i];
        p.ks[i] = strides[3 + i];
        p.vs[i] = strides[6 + i];
        p.os[i] = strides[9 + i];
    }
    p.h = h;
    p.group = h / h_kv;
    p.sq = sq;
    p.skv = skv;
    p.causal = causal;
    p.window = window;
    p.q_offset = q_offset;
    p.kv_len = kv_len;
    p.scale = scale;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(p, d, b * h, s);
    if (dtype == 1) return dispatch<__nv_bfloat16>(p, d, b * h, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
