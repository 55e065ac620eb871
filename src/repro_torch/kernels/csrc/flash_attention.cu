// Flash attention for Hopper (sm_90a): out = softmax(scale * q k^T + mask) v.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (_attn_kernel, launched by the pl.pallas_call at flash_attention.py:100):
// a (batch*heads, q blocks, kv blocks) grid, kv innermost, whose running
// max m, sum l and output accumulator stay in fp32 VMEM scratch across the
// kv steps, with both products on the MXU (bf16 operands, fp32 results).
// Blocks on Hopper run in parallel and in no order, so here one thread
// block owns one (batch*head, q tile) and walks the kv tiles itself; m, l
// and the accumulator live in registers for the whole walk.
//
// What it computes, beyond the TPU kernel.  On the serving path it stands
// in for models/common.py:chunked_attention, so it takes two host ints by
// value: q_offset (the absolute position of q[0] for the causal and window
// masks) and kv_len (keys at positions >= kv_len are masked; decode passes
// min(pos + 1, W) with causal off).  With q_offset = 0 and kv_len = skv it
// is the TPU kernel's function.  GQA reads kv head h / (h / h_kv) without
// materialising a repeat.  Masked scores are -1e30, as in the reference, so
// a row with no visible key averages every key as the reference does;
// positions past skv (the ragged edge) count for nothing.  The scale is
// applied to the fp32 scores; P is rounded to v's dtype before P.V
// (flash_attention.py:63); l sums the unrounded P; the denominator is
// max(l, 1e-30).
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
// 16 heads of 64, 2048 causal; recurrentgemma-2b: 10 heads of 256 over one
// kv head) does 4 * d flops per visible (q, k) pair against one read of q,
// k, v: hundreds of flops per byte, so it is bound by operations, and only
// the tensor cores come near that bound.  Decode (sq = 1 over a 160- to
// 2048-entry cache) does 4 * d flops per key against 4 * d bytes of bf16 K
// and V: it is bound by the bytes of the KV read.
//
// What the design does about it.  Two kernels, one per dtype.
//
// bf16 (serving and prefill): attn_mma_kernel, FlashAttention-2's design on
// the tensor cores.  A block of 4 warps owns 64 q rows (1 warp and 16 rows
// when sq <= 16, so decode idles 15 of 16 rows rather than 63 of 64); each
// warp owns 16 rows for the whole walk.  Q, K and V go to shared memory by
// cp.async 16-byte copies (rows past sq / skv are zero-filled through the
// src-size operand, not read), K and V through a two-stage ring so that
// tile t + 1 loads while tile t computes.  Rows are padded by 8 bf16
// (16 bytes), which keeps ldmatrix free of bank conflicts.  S = Q K^T and
// O += P V are mma.sync.m16n8k16 (bf16 in, fp32 accumulate); Q's A
// fragments stay in registers at d <= 128 and are reloaded per kv tile at
// d = 256 (their 64 registers would join a 128-register accumulator), K's
// B fragments come from ldmatrix.x4 and V's from ldmatrix.x4.trans.  The
// online softmax runs in registers in the m16n8 accumulator layout, where a
// row's scores sit in one quad of lanes (two shuffles per max), in base 2
// with scale * log2(e) folded into one multiply; the mask is evaluated
// only on tiles that cross a mask edge.  The fp32 S accumulators of two
// adjacent n8 tiles are the A fragment of P V once rounded to bf16, so P
// never goes through shared memory.  kv tiles are 64 keys at d <= 128 and
// 32 at d = 256, where 64 would leave one block per SM (~169 KB of shared
// memory); at 32 two fit.  Grid: (batch*head, q tile), heaviest q tiles
// first, so the causal diagonal's long rows start in the first wave.
//
// fp32 (tests and checks only; TF32 would miss the 2e-3 tolerance):
// attn_kernel, FFMA on fp32 operands staged in shared memory, 256 threads
// each owning a 4 x 4 block of scores and a 4 x (d / 16) block of the
// output; rows padded by one float; half-warp shuffles; at d = 256 it takes
// 214,016 B of dynamic shared memory (one block per SM).
//
// What it leaves.  mma.sync reaches a part of the card's bf16 rate; only
// wgmma (asynchronous warpgroup products from shared memory, fed by TMA and
// mbarrier pipelines) reaches all of it.  Decode runs one block per
// (batch, head) and walks the cache alone; splitting the cache over blocks
// (split-KV, then a combine) would put more SMs on the byte-bound read.
// Both are later work.
//
// Plain C interface, built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_sync.cuh"

namespace {

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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

// The kv tiles [t_lo, t_hi) that any row q0 .. min(q0 + bq, sq) - 1 can
// see.  The empty rows form a suffix or the whole tile, so the first and
// last rows decide; a tile holding an empty row walks every kv tile.
__device__ __forceinline__ void kv_tiles(const Params& p, int q0, int bq,
                                         int bkv, int& t_lo, int& t_hi) {
    const int first = p.q_offset + q0;
    const int last = p.q_offset + min(q0 + bq, p.sq) - 1;
    auto lo_of = [&](int qpos) {
        return p.window > 0 ? max(0, qpos - p.window + 1) : 0;
    };
    auto hi_of = [&](int qpos) {
        return p.causal ? min(p.kv_len, qpos + 1) : p.kv_len;
    };
    t_lo = 0;
    t_hi = (p.skv + bkv - 1) / bkv;
    if (hi_of(first) > lo_of(first) && hi_of(last) > lo_of(last)) {
        t_lo = lo_of(first) / bkv;
        t_hi = (hi_of(last) + bkv - 1) / bkv;
    }
}

// ---------------------------------------------------------------------------
// fp32: FFMA on operands staged in shared memory
// ---------------------------------------------------------------------------

constexpr int BQ = 64;                    // q rows per block
constexpr int BKV = 64;                    // keys per kv tile
constexpr int THREADS = 256;               // 16 row groups x 16 lanes
constexpr int RPT = BQ / 16;               // rows per thread (4)
constexpr int CPT = BKV / 16;              // score columns per thread (4)
constexpr int LDP = BKV + 1;               // padded P row (floats)

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)((BQ + 2 * BKV) * (D + 1) + BQ * LDP);
}

template <int D>
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
    const float* qg = static_cast<const float*>(p.q) + b * p.qs[0]
        + hq * p.qs[1];
    const float* kg = static_cast<const float*>(p.k) + b * p.ks[0]
        + hk * p.ks[1];
    const float* vg = static_cast<const float*>(p.v) + b * p.vs[0]
        + hk * p.vs[1];
    float* og = static_cast<float*>(p.o) + b * p.os[0] + hq * p.os[1];

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, c = i % D;
        Qs[r * LD + c] = (q0 + r < p.sq)
            ? qg[(long long)(q0 + r) * p.qs[2] + c] : 0.0f;
    }

    int t_lo, t_hi;
    kv_tiles(p, q0, BQ, BKV, t_lo, t_hi);

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
                kx = kg[(long long)(k0 + r) * p.ks[2] + c];
                vx = vg[(long long)(k0 + r) * p.vs[2] + c];
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
                Ps[(rbase + i) * LDP + tc + 16 * j] = pv;
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
            og[(long long)r * p.os[2] + tc + 16 * u] = acc[i][u] / den;
    }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores, cp.async into a two-stage ring
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D, int WARPS>
struct MmaTile {
    static constexpr int BQ = 16 * WARPS;          // q rows per block
    static constexpr int BKV = D == 256 ? 32 : 64;  // keys per kv tile
    static constexpr int LDS = D + 8;              // padded row (bf16)
    static constexpr int THREADS = 32 * WARPS;
    static constexpr size_t SMEM =
        sizeof(bf16) * (size_t)(BQ + 4 * BKV) * LDS;   // Q + 2 x (K, V)
};

template <int D, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
attn_mma_kernel(const Params p) {
    using T = MmaTile<D, WARPS>;
    constexpr int BQ = T::BQ, BKV = T::BKV, LDS = T::LDS;
    constexpr int NT = T::THREADS;
    constexpr int CH = D / 8;              // 16-byte chunks per row
    constexpr int KS = D / 16;             // k steps of Q K^T
    constexpr int NS = BKV / 8;            // n8 tiles of S
    constexpr int NO = D / 8;              // n8 tiles of O
    constexpr bool Q_IN_REGS = D <= 128;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BQ * LDS;              // 2 stages of BKV rows
    bf16* Vs = Ks + 2 * BKV * LDS;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, tq = lane & 3;   // mma row group, lane in quad
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
    const int b = blockIdx.x / p.h, hq = blockIdx.x % p.h;
    const int hk = hq / p.group;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs[0]
        + hq * p.qs[1];
    const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0]
        + hk * p.ks[1];
    const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0]
        + hk * p.vs[1];
    bf16* og = static_cast<bf16*>(p.o) + b * p.os[0] + hq * p.os[1];

    for (int i = tid; i < BQ * CH; i += NT) {
        const int r = i / CH, c = (i % CH) * 8;
        const bool ok = q0 + r < p.sq;
        cp_async16(smem_u32(Qs + r * LDS + c),
                   qg + (ok ? (long long)(q0 + r) * p.qs[2] : 0) + c, ok);
    }
    auto load_kv = [&](int t, int stage) {
        const int k0 = t * BKV;
        bf16* kd = Ks + stage * BKV * LDS;
        bf16* vd = Vs + stage * BKV * LDS;
        for (int i = tid; i < BKV * CH; i += NT) {
            const int r = i / CH, c = (i % CH) * 8;
            const bool ok = k0 + r < p.skv;
            const long long row = ok ? k0 + r : 0;
            cp_async16(smem_u32(kd + r * LDS + c), kg + row * p.ks[2] + c,
                       ok);
            cp_async16(smem_u32(vd + r * LDS + c), vg + row * p.vs[2] + c,
                       ok);
        }
    };

    int t_lo, t_hi;
    kv_tiles(p, q0, BQ, BKV, t_lo, t_hi);
    load_kv(t_lo, 0);
    cp_async_commit();                     // group: Q and the first tile

    // the block's live q positions, for the tiles that need no mask
    const int qmin = p.q_offset + q0;
    const int qmax = p.q_offset + min(q0 + BQ, p.sq) - 1;
    const bool live = q0 + warp * 16 < p.sq;   // the warp has a row
    const int qp0 = p.q_offset + q0 + warp * 16 + g;   // rows g and g + 8
    const int qp1 = qp0 + 8;
    const float sl2 = p.scale * LOG2E;     // scores in base 2
    const unsigned q_frag = smem_u32(Qs + (warp * 16 + (lane & 15)) * LDS
                                     + (lane >> 4) * 8);

    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    float m0 = MASKED, m1 = MASKED, l0 = 0.0f, l1 = 0.0f;
    unsigned qf[Q_IN_REGS ? KS : 1][4];

    for (int t = t_lo; t < t_hi; ++t) {
        const int st = (t - t_lo) & 1;
        if (t + 1 < t_hi) {                // tile t + 1 loads meanwhile
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
            if constexpr (Q_IN_REGS) {
                if (t == t_lo) {
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

            // scale, then mask where the tile crosses a mask edge
            const int k0 = t * BKV;
            const bool inside = k0 + BKV <= p.kv_len
                && (!p.causal || k0 + BKV - 1 <= qmin)
                && (p.window <= 0 || k0 > qmax - p.window);
#pragma unroll
            for (int j = 0; j < NS; ++j) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[j][e] * sl2;
                    if (!inside) {
                        const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
                        const int qpos = e < 2 ? qp0 : qp1;
                        if (kpos >= p.skv) {
                            x = -INFINITY;     // no key at all
                        } else {
                            bool vis = kpos < p.kv_len;
                            if (p.causal) vis = vis && kpos <= qpos;
                            if (p.window > 0)
                                vis = vis && kpos > qpos - p.window;
                            if (!vis) x = MASKED;
                        }
                    }
                    s[j][e] = x;
                }
            }

            // online softmax: rows g (s[.][0..1]) and g + 8 (s[.][2..3])
            float mx0 = m0, mx1 = m1;
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
                mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
            }
            mx0 = quad_max(mx0);
            mx1 = quad_max(mx1);
            const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
            m0 = mx0;
            m1 = mx1;
            l0 *= c0;
            l1 *= c1;
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[n][0] *= c0; o[n][1] *= c0;
                o[n][2] *= c1; o[n][3] *= c1;
            }
#pragma unroll
            for (int j = 0; j < NS; ++j) {
                s[j][0] = exp2f(s[j][0] - mx0);
                s[j][1] = exp2f(s[j][1] - mx0);
                s[j][2] = exp2f(s[j][2] - mx1);
                s[j][3] = exp2f(s[j][3] - mx1);
                l0 += s[j][0] + s[j][1];   // the unrounded P
                l1 += s[j][2] + s[j][3];
            }

            // O += P V: two n8 tiles of S are one A fragment; V's B
            // fragments for 16 output columns at a time, transposed
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

    const float d0 = fmaxf(quad_sum(l0), 1e-30f);
    const float d1 = fmaxf(quad_sum(l1), 1e-30f);
    const int r0 = q0 + warp * 16 + g;
    bf16* o0 = og + (long long)r0 * p.os[2] + 2 * tq;
    bf16* o1 = o0 + 8 * p.os[2];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        if (r0 < p.sq)
            *reinterpret_cast<unsigned*>(o0 + n * 8) =
                pack_bf16(o[n][0] / d0, o[n][1] / d0);
        if (r0 + 8 < p.sq)
            *reinterpret_cast<unsigned*>(o1 + n * 8) =
                pack_bf16(o[n][2] / d1, o[n][3] / d1);
    }
}

template <int D>
int launch_f32(const Params& p, int batch_heads, cudaStream_t stream) {
    static bool configured = false;
    const int rc = set_smem(attn_kernel<D>, smem_bytes<D>(), configured);
    if (rc) return rc;
    const dim3 grid((p.sq + BQ - 1) / BQ, batch_heads);
    attn_kernel<D><<<grid, THREADS, smem_bytes<D>(), stream>>>(p);
    return (int)cudaGetLastError();
}

template <int D, int WARPS>
int launch_mma(const Params& p, int batch_heads, cudaStream_t stream) {
    using T = MmaTile<D, WARPS>;
    static bool configured = false;
    const int rc = set_smem(attn_mma_kernel<D, WARPS>, T::SMEM, configured);
    if (rc) return rc;
    const int q_tiles = (p.sq + T::BQ - 1) / T::BQ;
    if (q_tiles > 65535) return (int)cudaErrorInvalidValue;   // grid.y
    const dim3 grid(batch_heads, q_tiles);
    attn_mma_kernel<D, WARPS><<<grid, T::THREADS, T::SMEM, stream>>>(p);
    return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Params& p, int batch_heads, cudaStream_t s) {
    // one warp of 16 rows for decode-sized q, four of 64 rows otherwise
    return p.sq <= 16 ? launch_mma<D, 1>(p, batch_heads, s)
                      : launch_mma<D, 4>(p, batch_heads, s);
}

int dispatch(const Params& p, int d, int dtype, int batch_heads,
             cudaStream_t s) {
    if (dtype == 0) {
        switch (d) {
            case 32: return launch_f32<32>(p, batch_heads, s);
            case 64: return launch_f32<64>(p, batch_heads, s);
            case 128: return launch_f32<128>(p, batch_heads, s);
            case 256: return launch_f32<256>(p, batch_heads, s);
        }
    } else if (dtype == 1) {
        switch (d) {
            case 32: return launch_bf16<32>(p, batch_heads, s);
            case 64: return launch_bf16<64>(p, batch_heads, s);
            case 128: return launch_bf16<128>(p, batch_heads, s);
            case 256: return launch_bf16<256>(p, batch_heads, s);
        }
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (b, h, sq, d), k/v (b, h_kv, skv, d), o like q, each with unit stride
// over d and the (batch, head, seq) strides given in `strides` (12 values:
// q, k, v, o), in elements.  dtype: 0 = float32, 1 = bfloat16 (all four
// tensors); for bfloat16 every pointer is 16-byte aligned and every stride
// a multiple of 8 (the kernel's 16-byte copies; the wrapper checks).
// window <= 0 means none; kv_len must be in [0, skv].  Returns
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
    return dispatch(p, d, dtype, b * h, static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
