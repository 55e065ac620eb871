// mLSTM parallel form for Hopper (sm_90a): xLSTM's stabilised decay-weighted
// causal linear attention.
//
//   a_tj = F_t - F_j + i_j  (j <= t; F = cumsum log f),  m_t = max_j a_tj
//   w_tj = exp(a_tj - m_t) (q_t d^-1/2 . k_j)
//   h_t  = sum_j w_tj v_j / max(|sum_j w_tj|, exp(-m_t))
//
// Replaces the TPU kernel repro/kernels/mlstm.py:mlstm_parallel
// (_mlstm_kernel, launched by the pl.pallas_call at mlstm.py:93): a
// (batch*heads, q blocks, kv blocks) grid, kv innermost, whose running
// stabiliser m, numerator and signed denominator stay in fp32 VMEM scratch
// across the kv steps.  Hopper runs blocks in parallel and in no order, so
// here one thread block owns one (batch*head, 64-row q tile) and walks the
// kv tiles up to the diagonal itself, with m, the denominator and the
// numerator in registers for the whole walk (the layout of the port's
// flash-attention kernel, csrc/flash_attention.cu).
//
// What it computes, as the TPU kernel does.  q is scaled in its own dtype
// (q * d^-1/2, the scale rounded to q's dtype: mlstm.py:35); q.k sums in
// fp32; the decay is (F_t - F_j) + i_j in fp32; w is rounded to v's dtype
// before w.V (mlstm.py:64-65) while the denominator sums the unrounded w;
// the output is rounded to q's dtype.  In float32 none of those roundings
// does anything.
//
// Tiles above the diagonal are skipped, and that is exact: kv tile 0 is
// visible to every row (j = 0 <= t), so m is finite once it has been seen,
// and a masked entry of a later tile would add exp(-1e30 - m) = 0 to both
// sums.  Positions past s (the ragged edge: any s works, not only multiples
// of the tile) count for nothing.
//
// What bounds it on this card.  4 d flops per visible (t, j) pair (q.k and
// w.V) against one read of q, k, v and one write of the output: at
// xlstm-125m's prefill (batch 2, 4 heads of 192, s 2048, causal) that is
// hundreds of flops per byte, so it is bound by operations.
//
// What the design does about it.  Both products are FFMA on fp32 operands
// staged in shared memory (bf16 widened on the way in), 256 threads each
// owning a 4 x 4 block of the (t, j) tile and a 4 x (d / 16) block of the
// numerator, so every shared operand feeds four FMAs; rows are padded by one
// float (no bank conflicts on the strided reads); row maxima and sums are
// half-warp shuffles; tiles above the diagonal are skipped (half the causal
// work); q tiles run heaviest first.  It stays far from the bound: FFMA, not
// the tensor cores (wgmma for both products is later work).
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;                    // q rows per block
constexpr int BKV = 64;                   // keys per kv tile
constexpr int THREADS = 256;              // 16 row groups x 16 lanes
constexpr int RPT = BQ / 16;              // rows per thread (4)
constexpr int CPT = BKV / 16;             // tile columns per thread (4)
constexpr int LDP = BKV + 1;              // padded w row (floats)
constexpr float MASKED = -1e30f;          // the TPU kernel's NEG_INF

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    const float* fc;                      // F = cumsum log f, (b, h, s)
    const float* li;                      // log i, (b, h, s)
    long long qs[3], ks[3], vs[3], os[3], fs[3], is[3];  // (b, h, s) strides
    int h, s;
    float scale;                          // d^-1/2 rounded to q's dtype
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}
// a value rounded to T, as the TPU kernel holds it in T
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
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
    return sizeof(float) *
           (size_t)((BQ + 2 * BKV) * (D + 1) + BQ * LDP + BQ + 2 * BKV);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
mlstm_kernel(const Params p) {
    constexpr int LD = D + 1;             // padded q/k/v row (floats)
    constexpr int DPT = D / 16;           // numerator columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;                     // q * scale, rounded to T
    float* Ks = Qs + BQ * LD;
    float* Vs = Ks + BKV * LD;
    float* Ws = Vs + BKV * LD;            // w rounded to T, for w.V
    float* Fq = Ws + BQ * LDP;            // F_t of the tile's rows
    float* Fk = Fq + BQ;                  // F_j of the kv tile
    float* Ik = Fk + BKV;                 // log i_j of the kv tile

    const int tid = threadIdx.x;
    const int tr = tid / 16;              // row group: rows tr*4 .. tr*4+3
    const int tc = tid % 16;              // lane in the half warp
    const int rbase = tr * RPT;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
    const int b = blockIdx.y / p.h, hh = blockIdx.y % p.h;
    const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + hh * p.qs[1];
    const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + hh * p.ks[1];
    const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + hh * p.vs[1];
    T* og = static_cast<T*>(p.o) + b * p.os[0] + hh * p.os[1];
    const float* fg = p.fc + b * p.fs[0] + hh * p.fs[1];
    const float* ig = p.li + b * p.is[0] + hh * p.is[1];

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, c = i % D;
        Qs[r * LD + c] = (q0 + r < p.s)
            ? round_as(to_f32(qg[(long long)(q0 + r) * p.qs[2] + c]) * p.scale,
                       T())
            : 0.0f;
    }
    for (int i = tid; i < BQ; i += THREADS)
        Fq[i] = (q0 + i < p.s) ? fg[(long long)(q0 + i) * p.fs[2]] : 0.0f;

    float m[RPT], den[RPT], acc[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = MASKED;
        den[i] = 0.0f;
#pragma unroll
        for (int u = 0; u < DPT; ++u) acc[i][u] = 0.0f;
    }

    // kv tiles up to the one holding the tile's last live row
    const int n_tiles = (min(q0 + BQ, p.s) - 1) / BKV + 1;
    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * BKV;
        __syncthreads();                  // the last tile's reads are done
        for (int i = tid; i < BKV * D; i += THREADS) {
            const int r = i / D, c = i % D;
            float kx = 0.0f, vx = 0.0f;
            if (k0 + r < p.s) {
                kx = to_f32(kg[(long long)(k0 + r) * p.ks[2] + c]);
                vx = to_f32(vg[(long long)(k0 + r) * p.vs[2] + c]);
            }
            Ks[r * LD + c] = kx;
            Vs[r * LD + c] = vx;
        }
        for (int i = tid; i < BKV; i += THREADS) {
            const bool in = k0 + i < p.s;
            Fk[i] = in ? fg[(long long)(k0 + i) * p.fs[2]] : 0.0f;
            Ik[i] = in ? ig[(long long)(k0 + i) * p.is[2]] : 0.0f;
        }
        __syncthreads();

        float qk[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int j = 0; j < CPT; ++j) qk[i][j] = 0.0f;
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
                    qk[i][j] = fmaf(a[i], bk[j], qk[i][j]);
        }

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int qpos = q0 + rbase + i;
            const float fq = Fq[rbase + i];
            float la[CPT];
            float mx = -INFINITY;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const int col = tc + 16 * j;
                const int kpos = k0 + col;
                float x = -INFINITY;      // past s: no key at all
                if (kpos < p.s)
                    x = (kpos <= qpos) ? (fq - Fk[col]) + Ik[col] : MASKED;
                la[j] = x;
                mx = fmaxf(mx, x);
            }
            const float m_new = fmaxf(m[i], half_warp_max(mx));
            const float corr = expf(m[i] - m_new);
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
                const float w = qk[i][j] * expf(la[j] - m_new);
                sum += w;
                Ws[(rbase + i) * LDP + tc + 16 * j] = round_as(w, T());
            }
            den[i] = den[i] * corr + half_warp_sum(sum);
#pragma unroll
            for (int u = 0; u < DPT; ++u) acc[i][u] *= corr;
            m[i] = m_new;
        }
        __syncwarp();                     // w rows are the half warp's own

#pragma unroll 4
        for (int j = 0; j < BKV; ++j) {
            float vv[DPT];
#pragma unroll
            for (int u = 0; u < DPT; ++u) vv[u] = Vs[j * LD + tc + 16 * u];
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                const float wij = Ws[(rbase + i) * LDP + j];
#pragma unroll
                for (int u = 0; u < DPT; ++u)
                    acc[i][u] = fmaf(wij, vv[u], acc[i][u]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = q0 + rbase + i;
        if (r >= p.s) continue;
        const float denom = fmaxf(fabsf(den[i]), expf(-m[i]));
#pragma unroll
        for (int u = 0; u < DPT; ++u)
            store_as(&og[(long long)r * p.os[2] + tc + 16 * u],
                     acc[i][u] / denom);
    }
}

template <typename T, int D>
int launch(const Params& p, int batch_heads, cudaStream_t stream) {
    static bool configured = false;       // one attribute call per variant
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            mlstm_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes<D>());
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const dim3 grid((p.s + BQ - 1) / BQ, batch_heads);
    mlstm_kernel<T, D><<<grid, THREADS, smem_bytes<D>(), stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int d, int batch_heads, cudaStream_t s) {
    switch (d) {
        case 32: return launch<T, 32>(p, batch_heads, s);
        case 64: return launch<T, 64>(p, batch_heads, s);
        case 128: return launch<T, 128>(p, batch_heads, s);
        case 192: return launch<T, 192>(p, batch_heads, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// q, k, v, o (b, h, s, d), each with unit stride over d; f_cum and log_i
// (b, h, s) float32.  `strides` holds the (batch, head, seq) strides in
// elements of q, k, v, o, f_cum, log_i (18 values).  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and o).  scale is d^-1/2 rounded to that dtype.
// Returns cudaGetLastError() right after the launch (0 = cudaSuccess); the
// launch is asynchronous.
extern "C" int repro_mlstm(const void* q, const void* k, const void* v,
                           void* o, const float* f_cum, const float* log_i,
                           const long long* strides, int b, int h, int s,
                           int d, int dtype, float scale, void* stream) {
    if (b < 1 || h < 1 || s < 1 || b * h > 65535)
        return (int)cudaErrorInvalidValue;
    Params p;
    p.q = q;
    p.k = k;
    p.v = v;
    p.o = o;
    p.fc = f_cum;
    p.li = log_i;
    for (int i = 0; i < 3; ++i) {
        p.qs[i] = strides[i];
        p.ks[i] = strides[3 + i];
        p.vs[i] = strides[6 + i];
        p.os[i] = strides[9 + i];
        p.fs[i] = strides[12 + i];
        p.is[i] = strides[15 + i];
    }
    p.h = h;
    p.s = s;
    p.scale = scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch<float>(p, d, b * h, st);
    if (dtype == 1) return dispatch<__nv_bfloat16>(p, d, b * h, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
