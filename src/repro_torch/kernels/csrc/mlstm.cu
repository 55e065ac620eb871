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
// across the kv steps, with both products on the MXU.  Hopper runs blocks
// in parallel and in no order, so here one thread block owns one
// (batch*head, 64-row q tile) and walks the kv tiles up to the diagonal
// itself, with m, the denominator and the numerator in registers for the
// whole walk (the layout of the port's flash-attention kernel,
// csrc/flash_attention.cu).
//
// What it computes, as the TPU kernel does.  q is scaled in its own dtype
// (q * d^-1/2, the scale rounded to q's dtype: mlstm.py:35); q.k sums in
// fp32; the decay is (F_t - F_j) + i_j in fp32; w is rounded to v's dtype
// before w.V (mlstm.py:64-65) while the denominator sums the unrounded w;
// the output is rounded to q's dtype.  In float32 none of those roundings
// does anything.
//
// Tiles above the diagonal are skipped, and for finite inputs that is
// exact: kv tile 0 is visible to every row (j = 0 <= t), so m is finite
// once it has been seen, and a masked entry of a later tile would add
// exp(-1e30 - m) = 0 to both sums.  Masked entries of the tiles that are
// walked are w = S * 0, as in both references, so a NaN or Inf in q_t or
// k_j poisons what it poisons there (0 * NaN = NaN).  A non-finite key j
// past the first kv tile is where the two part: the references compute
// every (t, j) and poison every row of the head, the kernel only the rows
// whose walk reaches j's tile.  Positions past s (the ragged edge: any s
// works, not only multiples of the tile) count for nothing: their rows are
// zero-filled, a = -inf keeps them out of m, and w = 0 is forced there
// (S may be NaN, from an Inf in q times a zero-filled key).
//
// What bounds it on this card.  4 d flops per visible (t, j) pair (q.k and
// w.V) against one read of q, k, v and one write of the output: at
// xlstm-125m's prefill (batch 2, 4 heads of 192, s 2048, causal) that is
// hundreds of flops per byte, so it is bound by operations, and only the
// tensor cores come near that bound.
//
// What the design does about it.  Two kernels, one per dtype.
//
// bf16 (the model path): mlstm_mma_kernel, FlashAttention-2's design on the
// tensor cores, as attn_mma_kernel.  A block of 4 warps owns 64 q rows,
// each warp 16 rows for the whole walk.  Q, K and V go to shared memory by
// cp.async 16-byte copies (rows past s are zero-filled through the
// src-size operand, not read), F_j and log i_j (fp32) by 4-byte ones, K, V,
// F and i through a two-stage ring so that tile t + 1 loads while tile t
// computes.  Q is scaled once, in shared memory, as soon as it lands:
// bf16(q * scale), rounded to nearest by cvt.  Rows are padded by 8 bf16
// (16 bytes), which keeps ldmatrix free of bank conflicts.  S = Q K^T and
// num += w V are mma.sync.m16n8k16 (bf16 in, fp32 accumulate); Q's A
// fragments stay in registers at d <= 128 and are reloaded per kv tile at
// d = 192 (their 48 registers would join a 96-register numerator), K's B
// fragments come from ldmatrix.x4 and V's from ldmatrix.x4.trans.  The
// decay, the mask (only on the tile that crosses the diagonal or s) and
// the online stabiliser run in registers in the m16n8 accumulator layout,
// where a row lies in one quad of lanes (two shuffles per max); exp is
// exp2 of a product by log2(e).  w, rounded to bf16, is the A fragment of
// w V straight from the S accumulators (two adjacent n8 tiles), so it never
// goes through shared memory.  kv tiles are 64 keys at every head dim: at
// d = 192 that takes ~126 KB of shared memory and 242 registers, one
// block per SM, and still beat 32-key tiles at two blocks per SM on an
// H100, as 64-row q tiles beat 32-row ones (2 warps) at every head dim but
// 32 (PERF.md).  Grid: (batch*head, q tile), heaviest q tiles first.
//
// fp32 (tests and checks only; one TF32 product would leave the 3e-3
// tolerance no headroom): mlstm_kernel, FFMA on fp32 operands staged in
// shared memory, 256 threads each owning a 4 x 4 block of the (t, j) tile
// and a 4 x (d / 16) block of the numerator; rows padded by one float;
// half-warp shuffles; ~166 KB of shared memory at d = 192.
//
// What it leaves.  mma.sync reaches a part of the card's bf16 rate; only
// wgmma fed by TMA reaches all of it (later work).
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sync.cuh"

namespace {

constexpr float MASKED = -1e30f;          // the TPU kernel's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

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

// max(|den|, e^-m) with NaN passed on, as torch.maximum does
__device__ __forceinline__ float denominator(float den, float m) {
    return isnan(den) ? den : fmaxf(fabsf(den), expf(-m));
}

// ---------------------------------------------------------------------------
// fp32: FFMA on operands staged in shared memory
// ---------------------------------------------------------------------------

constexpr int BQ = 64;                    // q rows per block
constexpr int BKV = 64;                   // keys per kv tile
constexpr int THREADS = 256;              // 16 row groups x 16 lanes
constexpr int RPT = BQ / 16;              // rows per thread (4)
constexpr int CPT = BKV / 16;             // tile columns per thread (4)
constexpr int LDP = BKV + 1;              // padded w row (floats)

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) *
           (size_t)((BQ + 2 * BKV) * (D + 1) + BQ * LDP + BQ + 2 * BKV);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
mlstm_kernel(const Params p) {
    constexpr int LD = D + 1;             // padded q/k/v row (floats)
    constexpr int DPT = D / 16;           // numerator columns per thread
    extern __shared__ float smem[];
    float* Qs = smem;                     // q * scale
    float* Ks = Qs + BQ * LD;
    float* Vs = Ks + BKV * LD;
    float* Ws = Vs + BKV * LD;            // w, for w.V
    float* Fq = Ws + BQ * LDP;            // F_t of the tile's rows
    float* Fk = Fq + BQ;                  // F_j of the kv tile
    float* Ik = Fk + BKV;                 // log i_j of the kv tile

    const int tid = threadIdx.x;
    const int tr = tid / 16;              // row group: rows tr*4 .. tr*4+3
    const int tc = tid % 16;              // lane in the half warp
    const int rbase = tr * RPT;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
    const int b = blockIdx.y / p.h, hh = blockIdx.y % p.h;
    const float* qg = static_cast<const float*>(p.q) + b * p.qs[0]
        + hh * p.qs[1];
    const float* kg = static_cast<const float*>(p.k) + b * p.ks[0]
        + hh * p.ks[1];
    const float* vg = static_cast<const float*>(p.v) + b * p.vs[0]
        + hh * p.vs[1];
    float* og = static_cast<float*>(p.o) + b * p.os[0] + hh * p.os[1];
    const float* fg = p.fc + b * p.fs[0] + hh * p.fs[1];
    const float* ig = p.li + b * p.is[0] + hh * p.is[1];

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, c = i % D;
        Qs[r * LD + c] = (q0 + r < p.s)
            ? qg[(long long)(q0 + r) * p.qs[2] + c] * p.scale : 0.0f;
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
                kx = kg[(long long)(k0 + r) * p.ks[2] + c];
                vx = vg[(long long)(k0 + r) * p.vs[2] + c];
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
                Ws[(rbase + i) * LDP + tc + 16 * j] = w;
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
        const float denom = denominator(den[i], m[i]);
#pragma unroll
        for (int u = 0; u < DPT; ++u)
            og[(long long)r * p.os[2] + tc + 16 * u] = acc[i][u] / denom;
    }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, cp.async into a two-stage ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct MmaTile {
    static constexpr int BQ = 64;                   // 4 warps x 16 rows
    static constexpr int BKV = 64;                  // keys per kv tile
    static constexpr int LDS = D + 8;               // padded row (bf16)
    static constexpr int THREADS = 128;
    static constexpr size_t SMEM =                  // Q + 2 x (K, V, F, i)
        sizeof(bf16) * (size_t)(BQ + 4 * BKV) * LDS
        + sizeof(float) * (size_t)(4 * BKV);
};

template <int D>
__global__ void __launch_bounds__(MmaTile<D>::THREADS)
mlstm_mma_kernel(const Params p) {
    using T = MmaTile<D>;
    constexpr int BQ = T::BQ, BKV = T::BKV, LDS = T::LDS;
    constexpr int NT = T::THREADS;
    constexpr int CH = D / 8;              // 16-byte chunks per row
    constexpr int KS = D / 16;             // k steps of Q K^T
    constexpr int NS = BKV / 8;            // n8 tiles of S
    constexpr int NO = D / 8;              // n8 tiles of the numerator
    constexpr bool Q_IN_REGS = D <= 128;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BQ * LDS;              // 2 stages of BKV rows
    bf16* Vs = Ks + 2 * BKV * LDS;
    float* Fk = reinterpret_cast<float*>(Vs + 2 * BKV * LDS);  // 2 stages
    float* Ik = Fk + 2 * BKV;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;   // mma row group, lane in quad
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
    const int b = blockIdx.x / p.h, hh = blockIdx.x % p.h;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs[0]
        + hh * p.qs[1];
    const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0]
        + hh * p.ks[1];
    const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0]
        + hh * p.vs[1];
    bf16* og = static_cast<bf16*>(p.o) + b * p.os[0] + hh * p.os[1];
    const float* fg = p.fc + b * p.fs[0] + hh * p.fs[1];
    const float* ig = p.li + b * p.is[0] + hh * p.is[1];

    for (int i = tid; i < BQ * CH; i += NT) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool ok = q0 + r < p.s;
        cp_async16(smem_u32(Qs + r * LDS + c),
                   qg + (ok ? (long long)(q0 + r) * p.qs[2] : 0) + c, ok);
    }
    cp_async_commit();                     // group: Q
    auto load_kv = [&](int t, int stage) {
        const int k0 = t * BKV;
        bf16* kd = Ks + stage * BKV * LDS;
        bf16* vd = Vs + stage * BKV * LDS;
        for (int i = tid; i < BKV * CH; i += NT) {
            const int r = i / CH, c = (i % CH) * 8;
            const bool ok = k0 + r < p.s;
            const long long row = ok ? k0 + r : 0;
            cp_async16(smem_u32(kd + r * LDS + c), kg + row * p.ks[2] + c,
                       ok);
            cp_async16(smem_u32(vd + r * LDS + c), vg + row * p.vs[2] + c,
                       ok);
        }
        for (int i = tid; i < BKV; i += NT) {
            const bool ok = k0 + i < p.s;
            const long long row = ok ? k0 + i : 0;
            cp_async4(smem_u32(Fk + stage * BKV + i), fg + row * p.fs[2], ok);
            cp_async4(smem_u32(Ik + stage * BKV + i), ig + row * p.is[2], ok);
        }
    };
    const int n_tiles = (min(q0 + BQ, p.s) - 1) / BKV + 1;
    load_kv(0, 0);
    cp_async_commit();                     // group: the first kv tile

    // q * scale, rounded to bf16, once Q has landed (the first kv tile
    // loads meanwhile); the loop's first barrier orders it before ldmatrix
    cp_async_wait<1>();
    __syncthreads();
    for (int i = tid; i < BQ * D / 2; i += NT) {
        const int r = i / (D / 2), c = (i % (D / 2)) * 2;
        unsigned* pair = reinterpret_cast<unsigned*>(Qs + r * LDS + c);
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(pair));
        *pair = pack_bf16(x.x * p.scale, x.y * p.scale);
    }

    const bool live = q0 + warp * 16 < p.s;   // the warp has a row
    const int qp0 = q0 + warp * 16 + g;       // rows g and g + 8
    const int qp1 = qp0 + 8;
    const float fq0 = qp0 < p.s ? fg[(long long)qp0 * p.fs[2]] : 0.0f;
    const float fq1 = qp1 < p.s ? fg[(long long)qp1 * p.fs[2]] : 0.0f;
    const unsigned q_frag = smem_u32(Qs + (warp * 16 + (lane & 15)) * LDS
                                     + (lane >> 4) * 8);

    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    float m0 = MASKED, m1 = MASKED, l0 = 0.0f, l1 = 0.0f;
    unsigned qf[Q_IN_REGS ? KS : 1][4];

    for (int t = 0; t < n_tiles; ++t) {
        const int st = t & 1;
        if (t + 1 < n_tiles) {             // tile t + 1 loads meanwhile
            load_kv(t + 1, st ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (live) {
            const bf16* Kt = Ks + st * BKV * LDS;
            const bf16* Vt = Vs + st * BKV * LDS;
            const float* fk = Fk + st * BKV;
            const float* ik = Ik + st * BKV;
            if constexpr (Q_IN_REGS) {
                if (t == 0) {
#pragma unroll
                    for (int kk = 0; kk < KS; ++kk)
                        ldsm_x4(q_frag + kk * 32, qf[kk]);
                }
            }

            // S = Q K^T: per k step, K's B fragments for 16 keys at a time
            float s[NS][4];
#pragma unroll
            for (int j = 0; j < NS; ++j)
                s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
            const unsigned k_frag = smem_u32(
                Kt + ((lane & 7) + (lane >> 4) * 8) * LDS
                + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
                unsigned a[4];
                if constexpr (Q_IN_REGS) {
                    a[0] = qf[kk][0]; a[1] = qf[kk][1];
                    a[2] = qf[kk][2]; a[3] = qf[kk][3];
                } else {
                    ldsm_x4(q_frag + kk * 32, a);
                }
#pragma unroll
                for (int jj = 0; jj < NS / 2; ++jj) {
                    unsigned bk[4];
                    ldsm_x4(k_frag + (jj * 16 * LDS + kk * 16) * 2, bk);
                    mma_bf16(s[2 * jj], a, bk[0], bk[1]);
                    mma_bf16(s[2 * jj + 1], a, bk[2], bk[3]);
                }
            }

            // the decay a = (F_t - F_j) + i_j; the mask only where the
            // tile crosses the diagonal or s (then keys past s get -inf:
            // they never set m)
            const int k0 = t * BKV;
            const bool inside = k0 + BKV - 1 <= q0;
            float la[NS][4];
            float mx0 = m0, mx1 = m1;
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                const int col = j * 8 + 2 * tq;
                const float2 fk2 = *reinterpret_cast<const float2*>(fk + col);
                const float2 ik2 = *reinterpret_cast<const float2*>(ik + col);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = ((e < 2 ? fq0 : fq1) - (e & 1 ? fk2.y : fk2.x))
                        + (e & 1 ? ik2.y : ik2.x);
                    if (!inside) {
                        const int kpos = k0 + col + (e & 1);
                        if (kpos >= p.s)
                            x = -INFINITY;
                        else if (kpos > (e < 2 ? qp0 : qp1))
                            x = MASKED;
                    }
                    la[j][e] = x;
                }
                mx0 = fmaxf(mx0, fmaxf(la[j][0], la[j][1]));
                mx1 = fmaxf(mx1, fmaxf(la[j][2], la[j][3]));
            }

            // online stabiliser: rows g (s[.][0..1]) and g + 8 (s[.][2..3])
            mx0 = quad_max(mx0);
            mx1 = quad_max(mx1);
            const float c0 = exp2f((m0 - mx0) * LOG2E);
            const float c1 = exp2f((m1 - mx1) * LOG2E);
            m0 = mx0;
            m1 = mx1;
            l0 *= c0;
            l1 *= c1;
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[n][0] *= c0; o[n][1] *= c0;
                o[n][2] *= c1; o[n][3] *= c1;
            }
            // w = S exp(a - m); a masked entry is S * 0 (NaN stays NaN, as
            // in the references), a key past s is 0 whatever S is
#pragma unroll
            for (int j = 0; j < NS; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float w = s[j][e]
                        * exp2f((la[j][e] - (e < 2 ? mx0 : mx1)) * LOG2E);
                    if (!inside && k0 + j * 8 + 2 * tq + (e & 1) >= p.s)
                        w = 0.0f;
                    s[j][e] = w;
                }
                l0 += s[j][0] + s[j][1];   // the unrounded w
                l1 += s[j][2] + s[j][3];
            }

            // num += w V: two n8 tiles of S are one A fragment; V's B
            // fragments for 16 numerator columns at a time, transposed
            const unsigned v_frag = smem_u32(
                Vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                + (lane >> 4) * 8);
#pragma unroll
            for (int ks = 0; ks < BKV / 16; ++ks) {
                const unsigned a[4] = {
                    pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                    pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                    pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                    pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
                for (int nn = 0; nn < NO / 2; ++nn) {
                    unsigned bv[4];
                    ldsm_x4_trans(v_frag + (ks * 16 * LDS + nn * 16) * 2,
                                  bv);
                    mma_bf16(o[2 * nn], a, bv[0], bv[1]);
                    mma_bf16(o[2 * nn + 1], a, bv[2], bv[3]);
                }
            }
        }
        __syncthreads();                   // this stage is read; reuse it
    }

    const float d0 = denominator(quad_sum(l0), m0);
    const float d1 = denominator(quad_sum(l1), m1);
    bf16* o0 = og + (long long)qp0 * p.os[2] + 2 * tq;
    bf16* o1 = o0 + 8 * p.os[2];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        if (qp0 < p.s)
            *reinterpret_cast<unsigned*>(o0 + n * 8) =
                pack_bf16(o[n][0] / d0, o[n][1] / d0);
        if (qp1 < p.s)
            *reinterpret_cast<unsigned*>(o1 + n * 8) =
                pack_bf16(o[n][2] / d1, o[n][3] / d1);
    }
}

template <int D>
int launch_f32(const Params& p, int batch_heads, cudaStream_t stream) {
    static bool configured = false;
    const int rc = set_smem(mlstm_kernel<D>, smem_bytes<D>(), configured);
    if (rc) return rc;
    const dim3 grid((p.s + BQ - 1) / BQ, batch_heads);
    mlstm_kernel<D><<<grid, THREADS, smem_bytes<D>(), stream>>>(p);
    return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Params& p, int batch_heads, cudaStream_t stream) {
    using T = MmaTile<D>;
    static bool configured = false;
    const int rc = set_smem(mlstm_mma_kernel<D>, T::SMEM, configured);
    if (rc) return rc;
    const int q_tiles = (p.s + T::BQ - 1) / T::BQ;
    if (q_tiles > 65535) return (int)cudaErrorInvalidValue;   // grid.y
    const dim3 grid(batch_heads, q_tiles);
    mlstm_mma_kernel<D><<<grid, T::THREADS, T::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
}

int dispatch(const Params& p, int d, int dtype, int batch_heads,
             cudaStream_t s) {
    if (dtype == 0) {
        switch (d) {
            case 32: return launch_f32<32>(p, batch_heads, s);
            case 64: return launch_f32<64>(p, batch_heads, s);
            case 128: return launch_f32<128>(p, batch_heads, s);
            case 192: return launch_f32<192>(p, batch_heads, s);
        }
    } else if (dtype == 1) {
        switch (d) {
            case 32: return launch_bf16<32>(p, batch_heads, s);
            case 64: return launch_bf16<64>(p, batch_heads, s);
            case 128: return launch_bf16<128>(p, batch_heads, s);
            case 192: return launch_bf16<192>(p, batch_heads, s);
        }
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o (b, h, s, d), each with unit stride over d; f_cum and log_i
// (b, h, s) float32.  `strides` holds the (batch, head, seq) strides in
// elements of q, k, v, o, f_cum, log_i (18 values).  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and o; every q, k, v, o pointer 16-byte aligned
// and every stride of theirs a multiple of 8: the kernel's 16-byte copies;
// the wrapper checks).  scale is d^-1/2 rounded to that dtype.  Returns
// cudaGetLastError() right after the launch (0 = cudaSuccess); the launch
// is asynchronous.
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
    return dispatch(p, d, dtype, b * h, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
