// Fused multi-head self-attention: K1 on the raw fused-qkv projection and K5
// on separate q, k, v.
//
// Replaces, for Hopper (sm_90a), autoprog_tpu/ops/attention_pallas.py:
//   mhsa_fused_qkv (_fwd_kernel_qkv forward, _bwd_kernel_qkv backward)  -> K1,
//   mhsa_fused     (_fwd_kernel forward, _bwd_kernel backward)         -> K5.
// Both run the same device code; they differ in where the operands live
// (the slabs of mhsa_common.cuh) and in the score type.
//
// K1: qkv is [B, n, 3C] straight out of the qkv Dense, channel order
// (3, heads, d): q/k/v of head h sit at lanes j*C + h*d .. j*C + (h+1)*d.
// The kernels address those slices by the row stride 3C, so there is no
// relayout before or after the call. The output is [B, n, C] with head h
// in lanes h*d .. (h+1)*d; the gradient is one [B, n, 3C] tensor. Scores
// are rounded to the working type unless scores_f32.
//
// K5: q, k, v are three tensors [B, n, heads, d], each with strides of its
// own (a contiguous tensor, or a view into a [B, n, 3, heads, d] buffer); the
// output and the three gradients are contiguous [B, n, heads, d]. The
// Pallas wrapper moved the head axis in front of the token axis around its
// call because its blocks had to end in (n, d); here a block reads its head
// slice in place by the strides, so nothing is transposed. Scores are always
// f32.
//
// Numerics follow the Pallas kernels exactly (rounding points in
// mhsa_common.cuh).
//
// What bounds it at the VOLO shape (n = 196, d = 32): per head the forward
// does about 2 * n^2 * d FLOP (2.5 MFLOP) against 3 * n * d * 2 bytes read
// (38 KB), ~65 FLOP per byte, and the n x n score matrix plus its row
// softmax is the only large intermediate. So the score matrix and softmax,
// not HBM, set the pace. The design keeps every score out of device memory
// and streams K and V tiles of the head through shared memory; blocks are
// (query or key tile, head, image). The backward is two kernels so that no
// block carries a sum across blocks: pass A (per query tile) recomputes the
// scores, writes dQ and the per-row statistics (max, sum, rowsum(dP * p));
// pass B (per key tile) recomputes p and dS from those statistics and
// accumulates dK and dV over all query rows in registers. Blocks run in any
// order.
//
// bf16, the training path, runs its products on the tensor cores
// (mma.sync, mhsa_common.cuh), with the scores in registers. f32 runs them as
// scalar FMAs with the score rows in shared memory (the next section).
// wgmma/TMA is later work.

#include "mhsa_common.cuh"

namespace {

constexpr int NT = 128;     // threads per block
constexpr int TQ = 16;      // query rows per block: forward and backward pass A
constexpr int TK = 64;      // key rows per shared-memory tile: forward, pass A
constexpr int TKB = 16;     // key rows per block: backward pass B
constexpr int TQB = 32;     // query rows per shared-memory tile: pass B

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Copy `rows` rows of one head slice (d lanes each, row stride `stride`
// elements) starting at row r0 into shared memory as f32 with leading
// dimension ld. Rows past n are zero. With `as_qs` the values become
// qs = T(f32(q) * scale).
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* __restrict__ base, long long stride,
                          int r0, int rows, int n, int d, float scale, bool as_qs) {
    for (int idx = threadIdx.x; idx < rows * d; idx += NT) {
        const int r = idx / d, c = idx - (idx / d) * d;
        float v = 0.f;
        if (r0 + r < n) {
            v = to_f<T>(base[(long long)(r0 + r) * stride + c]);
            if (as_qs) v = round_to<T>(v * scale);
        }
        dst[r * ld + c] = v;
    }
}

// dot product of two shared-memory rows, summed in lane order; every pass
// that recomputes a score or dP entry uses this, so the recomputed values
// are bit-identical to the first ones
__device__ __forceinline__ float dot_row(const float* a, const float* b, int d) {
    float acc = 0.f;
    for (int c = 0; c < d; ++c) acc = fmaf(a[c], b[c], acc);
    return acc;
}

template <typename T>
__device__ __forceinline__ float score_round(float s, int scores_f32) {
    return scores_f32 ? s : round_to<T>(s);
}

// Scores of the block's TQ query rows against every key, into sS [TQ, n].
template <typename T>
__device__ void scores_rows(float* sS, const float* sQ, float* sKV, int ld,
                            const T* __restrict__ kbase, long long stride, int n, int d,
                            int scores_f32) {
    for (int k0 = 0; k0 < n; k0 += TK) {
        const int kr = min(TK, n - k0);
        __syncthreads();  // previous users of sKV are done
        load_rows<T>(sKV, ld, kbase, stride, k0, kr, n, d, 1.f, false);
        __syncthreads();
        for (int idx = threadIdx.x; idx < TQ * kr; idx += NT) {
            const int i = idx / kr, j = idx - (idx / kr) * kr;
            sS[i * n + k0 + j] = score_round<T>(dot_row(sQ + i * ld, sKV + j * ld, d),
                                                scores_f32);
        }
    }
    __syncthreads();
}

// ------------------------------------------- f32: scalar kernels, forward

template <typename T>
__global__ void __launch_bounds__(NT)
mhsa_fwd_kernel(Slab<const T> q, Slab<const T> k, Slab<const T> v, Slab<T> out, int n, int d,
                float scale, int scores_f32) {
    extern __shared__ float smem[];
    const int ld = d + 1;  // odd row pitch: column reads across rows hit distinct banks
    const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
    float* sQ = smem;            // [TQ, ld]  qs rows
    float* sKV = sQ + TQ * ld;   // [TK, ld]  K tile, then V tile
    float* sS = sKV + TK * ld;   // [TQ, n]   scores, then T(e)
    float* sZ = sS + TQ * n;     // [TQ]      rowsum(e)

    const T* vb = v.at(b, h);
    load_rows<T>(sQ, ld, q.at(b, h), q.row, q0, TQ, n, d, scale, true);
    scores_rows<T>(sS, sQ, sKV, ld, k.at(b, h), k.row, n, d, scores_f32);

    // softmax numerators, one warp per row
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = warp; i < TQ; i += NT / 32) {
        float* row = sS + i * n;
        float m = -INFINITY;
        for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
        m = warp_max(m);
        float z = 0.f;
        for (int j = lane; j < n; j += 32) {
            const float e = expf(row[j] - m);
            z += e;
            row[j] = round_to<T>(e);
        }
        z = warp_sum(z);
        if (lane == 0) sZ[i] = z;
    }

    // O = T(e) . V, each thread owns TQ * d / NT outputs
    constexpr int MAXO = TQ * MAX_D / NT;
    float acc[MAXO];
#pragma unroll
    for (int r = 0; r < MAXO; ++r) acc[r] = 0.f;
    const int nout = TQ * d;
    for (int k0 = 0; k0 < n; k0 += TK) {
        const int kr = min(TK, n - k0);
        __syncthreads();
        load_rows<T>(sKV, ld, vb, v.row, k0, kr, n, d, 1.f, false);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < MAXO; ++r) {
            const int o = threadIdx.x + r * NT;
            if (o < nout) {
                const int i = o / d, c = o - (o / d) * d;
                const float* ei = sS + i * n + k0;
                float a = acc[r];
                for (int j = 0; j < kr; ++j) a = fmaf(ei[j], sKV[j * ld + c], a);
                acc[r] = a;
            }
        }
    }
    T* ob = out.at(b, h);
#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
        const int o = threadIdx.x + r * NT;
        if (o < nout) {
            const int i = o / d, c = o - (o / d) * d;
            if (q0 + i < n) ob[(long long)(q0 + i) * out.row + c] = from_f<T>(acc[r] / sZ[i]);
        }
    }
}

// ------------------------------------------------- backward pass A: dQ, stats

// stats[(b * H + h) * n + i] = (rowmax, rowsum(e), rowsum(dP * p))
template <typename T>
__global__ void __launch_bounds__(NT)
mhsa_bwd_dq_kernel(Slab<const T> q, Slab<const T> k, Slab<const T> v, Slab<const T> dout,
                   Slab<T> dq, float3* __restrict__ stats, int n, int d, int H, float scale,
                   int scores_f32) {
    extern __shared__ float smem[];
    const int ld = d + 1;
    const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
    float* sQ = smem;             // [TQ, ld] qs rows
    float* sDO = sQ + TQ * ld;    // [TQ, ld] dO rows
    float* sKV = sDO + TQ * ld;   // [TK, ld] K or V tile
    float* sP = sKV + TK * ld;    // [TQ, n]  scores, then p
    float* sDS = sP + TQ * n;     // [TQ, n]  dP, then T(dS)

    const T* kb = k.at(b, h);
    const T* vb = v.at(b, h);
    load_rows<T>(sQ, ld, q.at(b, h), q.row, q0, TQ, n, d, scale, true);
    load_rows<T>(sDO, ld, dout.at(b, h), dout.row, q0, TQ, n, d, 1.f, false);
    scores_rows<T>(sP, sQ, sKV, ld, kb, k.row, n, d, scores_f32);

    // p = softmax(S) per row; keep max and sum for pass B
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float row_m[TQ / (NT / 32)], row_z[TQ / (NT / 32)];
#pragma unroll
    for (int t = 0; t < TQ / (NT / 32); ++t) {
        const int i = warp + t * (NT / 32);
        float* row = sP + i * n;
        float m = -INFINITY;
        for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
        m = warp_max(m);
        float z = 0.f;
        for (int j = lane; j < n; j += 32) z += expf(row[j] - m);
        z = warp_sum(z);
        for (int j = lane; j < n; j += 32) row[j] = expf(row[j] - m) / z;
        row_m[t] = m;
        row_z[t] = z;
    }

    // dP = dO . V^T
    for (int k0 = 0; k0 < n; k0 += TK) {
        const int kr = min(TK, n - k0);
        __syncthreads();
        load_rows<T>(sKV, ld, vb, v.row, k0, kr, n, d, 1.f, false);
        __syncthreads();
        for (int idx = threadIdx.x; idx < TQ * kr; idx += NT) {
            const int i = idx / kr, j = idx - (idx / kr) * kr;
            sDS[i * n + k0 + j] = dot_row(sDO + i * ld, sKV + j * ld, d);
        }
    }
    __syncthreads();

    // dS = T(p * (dP - rowsum(dP * p)))
#pragma unroll
    for (int t = 0; t < TQ / (NT / 32); ++t) {
        const int i = warp + t * (NT / 32);
        const float* prow = sP + i * n;
        float* drow = sDS + i * n;
        float s = 0.f;
        for (int j = lane; j < n; j += 32) s += drow[j] * prow[j];
        s = warp_sum(s);
        for (int j = lane; j < n; j += 32) drow[j] = round_to<T>(prow[j] * (drow[j] - s));
        if (lane == 0 && q0 + i < n)
            stats[((size_t)b * H + h) * n + q0 + i] = make_float3(row_m[t], row_z[t], s);
    }

    // dQ = (dS . K) * scale
    constexpr int MAXO = TQ * MAX_D / NT;
    float acc[MAXO];
#pragma unroll
    for (int r = 0; r < MAXO; ++r) acc[r] = 0.f;
    const int nout = TQ * d;
    for (int k0 = 0; k0 < n; k0 += TK) {
        const int kr = min(TK, n - k0);
        __syncthreads();
        load_rows<T>(sKV, ld, kb, k.row, k0, kr, n, d, 1.f, false);
        __syncthreads();
#pragma unroll
        for (int r = 0; r < MAXO; ++r) {
            const int o = threadIdx.x + r * NT;
            if (o < nout) {
                const int i = o / d, c = o - (o / d) * d;
                const float* dsi = sDS + i * n + k0;
                float a = acc[r];
                for (int j = 0; j < kr; ++j) a = fmaf(dsi[j], sKV[j * ld + c], a);
                acc[r] = a;
            }
        }
    }
    T* dqb = dq.at(b, h);
#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
        const int o = threadIdx.x + r * NT;
        if (o < nout) {
            const int i = o / d, c = o - (o / d) * d;
            if (q0 + i < n) dqb[(long long)(q0 + i) * dq.row + c] = from_f<T>(acc[r] * scale);
        }
    }
}

// ---------------------------------------------- backward pass B: dK and dV

template <typename T>
__global__ void __launch_bounds__(NT)
mhsa_bwd_dkv_kernel(Slab<const T> q, Slab<const T> k, Slab<const T> v, Slab<const T> dout,
                    Slab<T> dk, Slab<T> dv, const float3* __restrict__ stats, int n, int d,
                    int H, float scale, int scores_f32) {
    extern __shared__ float smem[];
    const int ld = d + 1;
    const int j0 = blockIdx.x * TKB, h = blockIdx.y, b = blockIdx.z;
    float* sK = smem;              // [TKB, ld] K rows of this block
    float* sV = sK + TKB * ld;     // [TKB, ld] V rows of this block
    float* sQ = sV + TKB * ld;     // [TQB, ld] qs tile
    float* sDO = sQ + TQB * ld;    // [TQB, ld] dO tile
    float* sPc = sDO + TQB * ld;   // [TQB, TKB] T(p)
    float* sDS = sPc + TQB * TKB;  // [TQB, TKB] T(dS)
    float3* sSt = reinterpret_cast<float3*>(sDS + TQB * TKB);  // [TQB] row stats

    const T* qb = q.at(b, h);
    const T* gb = dout.at(b, h);
    const float3* st = stats + ((size_t)b * H + h) * n;
    load_rows<T>(sK, ld, k.at(b, h), k.row, j0, TKB, n, d, 1.f, false);
    load_rows<T>(sV, ld, v.at(b, h), v.row, j0, TKB, n, d, 1.f, false);

    constexpr int MAXO = TKB * MAX_D / NT;
    float acc_k[MAXO], acc_v[MAXO];
#pragma unroll
    for (int r = 0; r < MAXO; ++r) acc_k[r] = acc_v[r] = 0.f;
    const int nout = TKB * d;

    for (int q0 = 0; q0 < n; q0 += TQB) {
        __syncthreads();  // previous tile fully consumed
        load_rows<T>(sQ, ld, qb, q.row, q0, TQB, n, d, scale, true);
        load_rows<T>(sDO, ld, gb, dout.row, q0, TQB, n, d, 1.f, false);
        for (int i = threadIdx.x; i < TQB; i += NT)
            sSt[i] = q0 + i < n ? st[q0 + i] : make_float3(0.f, 1.f, 0.f);
        __syncthreads();
        for (int idx = threadIdx.x; idx < TQB * TKB; idx += NT) {
            const int i = idx / TKB, j = idx - (idx / TKB) * TKB;
            float pc = 0.f, ds = 0.f;
            if (q0 + i < n && j0 + j < n) {
                const float3 s3 = sSt[i];
                const float s = score_round<T>(dot_row(sQ + i * ld, sK + j * ld, d), scores_f32);
                const float p = expf(s - s3.x) / s3.y;
                const float dp = dot_row(sDO + i * ld, sV + j * ld, d);
                pc = round_to<T>(p);
                ds = round_to<T>(p * (dp - s3.z));
            }
            sPc[idx] = pc;
            sDS[idx] = ds;
        }
        __syncthreads();
        const int qr = min(TQB, n - q0);
#pragma unroll
        for (int r = 0; r < MAXO; ++r) {
            const int o = threadIdx.x + r * NT;
            if (o < nout) {
                const int j = o / d, c = o - (o / d) * d;
                float ak = acc_k[r], av = acc_v[r];
                for (int i = 0; i < qr; ++i) {
                    av = fmaf(sPc[i * TKB + j], sDO[i * ld + c], av);
                    ak = fmaf(sDS[i * TKB + j], sQ[i * ld + c], ak);
                }
                acc_k[r] = ak;
                acc_v[r] = av;
            }
        }
    }
    T* dkb = dk.at(b, h);
    T* dvb = dv.at(b, h);
#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
        const int o = threadIdx.x + r * NT;
        if (o < nout) {
            const int j = o / d, c = o - (o / d) * d;
            if (j0 + j < n) {
                dkb[(long long)(j0 + j) * dk.row + c] = from_f<T>(acc_k[r]);
                dvb[(long long)(j0 + j) * dv.row + c] = from_f<T>(acc_v[r]);
            }
        }
    }
}

// ------------------------------------------- bf16: tensor-core (mma.sync)
//
// One cell of mhsa_common.cuh per block; blocks are (tile, head, image).

template <int DP>
__global__ void __launch_bounds__(MT)
mhsa_fwd_mma(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out, int n,
             int d, float scale, int scores_f32, int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] qs
    bf16* sK = sQ + MQ * LD;                         // [MK, LD]
    bf16* sV = sK + MK * LD;                         // [MK, LD]
    const int h = blockIdx.y, b = blockIdx.z;
    fwd_cell<DP>(sQ, sK, sV, q.at(b, h), q.row, k.at(b, h), k.row, v.at(b, h), v.row,
                 out.at(b, h), out.row, blockIdx.x * MQ, n, d, scale, scores_f32, vec);
}

template <int DP>
__global__ void __launch_bounds__(MT)
mhsa_bwd_dq_mma(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v,
                Slab<const bf16> dout, Slab<bf16> dq, float3* __restrict__ stats, int n, int d,
                int H, float scale, int scores_f32, int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] qs
    bf16* sDO = sQ + MQ * LD;                        // [MQ, LD] dO
    bf16* sK = sDO + MQ * LD;                        // [MK, LD]
    bf16* sV = sK + MK * LD;                         // [MK, LD]
    const int h = blockIdx.y, b = blockIdx.z;
    bwd_dq_cell<DP>(sQ, sDO, sK, sV, q.at(b, h), q.row, k.at(b, h), k.row, v.at(b, h), v.row,
                    dout.at(b, h), dout.row, dq.at(b, h), dq.row,
                    stats + ((size_t)b * H + h) * n, blockIdx.x * MQ, n, d, scale, scores_f32,
                    vec);
}

template <int DP>
__global__ void __launch_bounds__(MT)
mhsa_bwd_dkv_mma(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v,
                 Slab<const bf16> dout, Slab<bf16> dk, Slab<bf16> dv,
                 const float3* __restrict__ stats, int n, int d, int H, float scale,
                 int scores_f32, int vec) {
    constexpr int LD = DP + PAD;
    constexpr int NQ = NQ_ROWS<DP>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] this block's keys
    bf16* sV = sK + MQ * LD;                         // [MQ, LD]
    bf16* sQ = sV + MQ * LD;                         // [NQ, LD] qs tile
    bf16* sDO = sQ + NQ * LD;                        // [NQ, LD] dO tile
    float3* sSt = reinterpret_cast<float3*>(sDO + NQ * LD);  // [NQ] row stats
    const int h = blockIdx.y, b = blockIdx.z;
    bwd_dkv_cell<DP>(sK, sV, sQ, sDO, sSt, q.at(b, h), q.row, k.at(b, h), k.row, v.at(b, h),
                     v.row, dout.at(b, h), dout.row, dk.at(b, h), dk.row, dv.at(b, h), dv.row,
                     stats + ((size_t)b * H + h) * n, blockIdx.x * MQ, n, d, scale, scores_f32,
                     vec);
}

size_t fwd_smem(int n, int d) { return sizeof(float) * ((size_t)(TQ + TK) * (d + 1) + (size_t)TQ * n + TQ); }
size_t bwd_dq_smem(int n, int d) { return sizeof(float) * ((size_t)(2 * TQ + TK) * (d + 1) + 2 * (size_t)TQ * n); }
size_t bwd_dkv_smem(int d) {
    return sizeof(float) * ((size_t)(2 * TKB + 2 * TQB) * (d + 1) + 2 * TQB * TKB) + sizeof(float3) * TQB;
}

// the operands of one call, in the working type T
template <typename T>
struct Operands {
    Slab<const T> q, k, v, dout;  // dout only in the backward
    Slab<T> out;                  // forward
    Slab<T> dq, dk, dv;           // backward
    int B, n, H, d;
};

template <int DP>
int fwd_mma(const Operands<bf16>& a, float scale, int scores_f32, int vec, cudaStream_t stream) {
    const dim3 grid(ceil_div(a.n, MQ), a.H, a.B);
    const size_t smem = fwd_cell_smem<DP>(MW);
    cudaError_t err = allow_smem(mhsa_fwd_mma<DP>, smem);
    if (err != cudaSuccess) return (int)err;
    mhsa_fwd_mma<DP><<<grid, MT, smem, stream>>>(a.q, a.k, a.v, a.out, a.n, a.d, scale,
                                                 scores_f32, vec);
    return (int)cudaGetLastError();
}

template <int DP>
int bwd_mma(const Operands<bf16>& a, void* stats, float scale, int scores_f32, int vec,
            cudaStream_t stream) {
    float3* st = static_cast<float3*>(stats);
    const dim3 grid(ceil_div(a.n, MQ), a.H, a.B);

    const size_t smem_a = dq_cell_smem<DP>(MW);
    cudaError_t err = allow_smem(mhsa_bwd_dq_mma<DP>, smem_a);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dq_mma<DP><<<grid, MT, smem_a, stream>>>(a.q, a.k, a.v, a.dout, a.dq, st, a.n, a.d,
                                                      a.H, scale, scores_f32, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const size_t smem_b = dkv_cell_smem<DP>(MW);
    err = allow_smem(mhsa_bwd_dkv_mma<DP>, smem_b);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dkv_mma<DP><<<grid, MT, smem_b, stream>>>(a.q, a.k, a.v, a.dout, a.dk, a.dv, st,
                                                       a.n, a.d, a.H, scale, scores_f32, vec);
    return (int)cudaGetLastError();
}

template <typename T>
int fwd_scalar(const Operands<T>& a, float scale, int scores_f32, cudaStream_t stream) {
    const dim3 grid(ceil_div(a.n, TQ), a.H, a.B);
    const size_t smem = fwd_smem(a.n, a.d);
    cudaError_t err = allow_smem(mhsa_fwd_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    mhsa_fwd_kernel<T><<<grid, NT, smem, stream>>>(a.q, a.k, a.v, a.out, a.n, a.d, scale,
                                                   scores_f32);
    return (int)cudaGetLastError();
}

template <typename T>
int bwd_scalar(const Operands<T>& a, void* stats, float scale, int scores_f32,
               cudaStream_t stream) {
    float3* st = static_cast<float3*>(stats);
    const dim3 grid_a(ceil_div(a.n, TQ), a.H, a.B);
    const size_t smem_a = bwd_dq_smem(a.n, a.d);
    cudaError_t err = allow_smem(mhsa_bwd_dq_kernel<T>, smem_a);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dq_kernel<T><<<grid_a, NT, smem_a, stream>>>(a.q, a.k, a.v, a.dout, a.dq, st, a.n,
                                                          a.d, a.H, scale, scores_f32);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const dim3 grid_b(ceil_div(a.n, TKB), a.H, a.B);
    const size_t smem_b = bwd_dkv_smem(a.d);
    err = allow_smem(mhsa_bwd_dkv_kernel<T>, smem_b);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dkv_kernel<T><<<grid_b, NT, smem_b, stream>>>(a.q, a.k, a.v, a.dout, a.dk, a.dv, st,
                                                           a.n, a.d, a.H, scale, scores_f32);
    return (int)cudaGetLastError();
}

// 16-byte loads need d % 8 == 0 and, for each slab that is read, a 16-byte
// aligned base and strides; one slab that is not switches the call to
// element loads
int can_vec(const Operands<bf16>& a, bool backward) {
    bool ok = a.d % 8 == 0 && slab_vec_ok(a.q) && slab_vec_ok(a.k) && slab_vec_ok(a.v);
    if (backward) ok = ok && slab_vec_ok(a.dout);
    return ok ? 1 : 0;
}

template <typename T>
int run_fwd(const Operands<T>& a, float scale, int scores_f32, cudaStream_t s);

template <>
int run_fwd<float>(const Operands<float>& a, float scale, int scores_f32, cudaStream_t s) {
    return fwd_scalar<float>(a, scale, scores_f32, s);
}

template <>
int run_fwd<bf16>(const Operands<bf16>& a, float scale, int scores_f32, cudaStream_t s) {
    const int vec = can_vec(a, false);
    if (a.d <= 32) return fwd_mma<32>(a, scale, scores_f32, vec, s);
    if (a.d <= 64) return fwd_mma<64>(a, scale, scores_f32, vec, s);
    return fwd_mma<128>(a, scale, scores_f32, vec, s);
}

template <typename T>
int run_bwd(const Operands<T>& a, void* stats, float scale, int scores_f32, cudaStream_t s);

template <>
int run_bwd<float>(const Operands<float>& a, void* stats, float scale, int scores_f32,
                   cudaStream_t s) {
    return bwd_scalar<float>(a, stats, scale, scores_f32, s);
}

template <>
int run_bwd<bf16>(const Operands<bf16>& a, void* stats, float scale, int scores_f32,
                  cudaStream_t s) {
    const int vec = can_vec(a, true);
    if (a.d <= 32) return bwd_mma<32>(a, stats, scale, scores_f32, vec, s);
    if (a.d <= 64) return bwd_mma<64>(a, stats, scale, scores_f32, vec, s);
    return bwd_mma<128>(a, stats, scale, scores_f32, vec, s);
}

// K1: the operands of a raw qkv projection, its output and its gradient
template <typename T>
Operands<T> qkv_operands(const void* qkv, const void* dout, void* out, void* dqkv, int B, int n,
                         int C, int H) {
    Operands<T> a{};
    const int d = C / H;
    qkv_slabs<const T>(qkv, n, C, d, a.q, a.k, a.v);
    a.dout = slab<const T>(dout, (long long)n * C, C, d);
    a.out = slab<T>(out, (long long)n * C, C, d);
    qkv_slabs<T>(dqkv, n, C, d, a.dq, a.dk, a.dv);
    a.B = B, a.n = n, a.H = H, a.d = d;
    return a;
}

// K5: strided q, k, v (and dout); contiguous [B, n, H, d] results
template <typename T>
Operands<T> split_operands(const void* q, const void* k, const void* v, const void* dout,
                           void* out, void* dq, void* dk, void* dv, const long long* sq,
                           const long long* sk, const long long* sv, const long long* sg, int B,
                           int n, int H, int d) {
    Operands<T> a{};
    const long long row = (long long)H * d, img = n * row;
    a.q = slab<const T>(q, sq[0], sq[1], sq[2]);
    a.k = slab<const T>(k, sk[0], sk[1], sk[2]);
    a.v = slab<const T>(v, sv[0], sv[1], sv[2]);
    if (sg) a.dout = slab<const T>(dout, sg[0], sg[1], sg[2]);
    a.out = slab<T>(out, img, row, d);
    a.dq = slab<T>(dq, img, row, d);
    a.dk = slab<T>(dk, img, row, d);
    a.dv = slab<T>(dv, img, row, d);
    a.B = B, a.n = n, a.H = H, a.d = d;
    return a;
}

}  // namespace

extern "C" {

// Every entry point returns 0 on success, a cudaError_t value, or -1 for a
// shape the kernels do not take. `stream` is a cudaStream_t. dtype: 0 =
// float32, 1 = bfloat16.

// K1 forward: qkv [B, n, 3C] -> out [B, n, C].
int mhsa_qkv_fwd(const void* qkv, void* out, int B, int n, int C, int H, float scale,
                 int scores_f32, int dtype, void* stream) {
    if (H < 1 || C % H != 0 || bad_shape(B, n, H, C / H) || (dtype != 0 && dtype != 1))
        return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return run_fwd(qkv_operands<float>(qkv, nullptr, out, nullptr, B, n, C, H), scale,
                       scores_f32, s);
    return run_fwd(qkv_operands<bf16>(qkv, nullptr, out, nullptr, B, n, C, H), scale, scores_f32,
                   s);
}

// K1 backward: `stats` is f32 scratch of B * H * n * 3 elements.
int mhsa_qkv_bwd(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int n, int C,
                 int H, float scale, int scores_f32, int dtype, void* stream) {
    if (H < 1 || C % H != 0 || bad_shape(B, n, H, C / H) || (dtype != 0 && dtype != 1))
        return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return run_bwd(qkv_operands<float>(qkv, dout, nullptr, dqkv, B, n, C, H), stats, scale,
                       scores_f32, s);
    return run_bwd(qkv_operands<bf16>(qkv, dout, nullptr, dqkv, B, n, C, H), stats, scale,
                   scores_f32, s);
}

// K5 forward: q, k, v of shape [B, n, H, d] with the element strides
// (image, row, head) given for each, lanes contiguous; out is contiguous
// [B, n, H, d]. Scores stay f32.
int mhsa_fwd(const void* q, const void* k, const void* v, void* out, long long q_img,
             long long q_row, long long q_head, long long k_img, long long k_row,
             long long k_head, long long v_img, long long v_row, long long v_head, int B, int n,
             int H, int d, float scale, int dtype, void* stream) {
    if (bad_shape(B, n, H, d) || (dtype != 0 && dtype != 1)) return kBadShape;
    const long long sq[3] = {q_img, q_row, q_head}, sk[3] = {k_img, k_row, k_head},
                    sv[3] = {v_img, v_row, v_head};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return run_fwd(split_operands<float>(q, k, v, nullptr, out, nullptr, nullptr, nullptr, sq,
                                             sk, sv, nullptr, B, n, H, d), scale, 1, s);
    return run_fwd(split_operands<bf16>(q, k, v, nullptr, out, nullptr, nullptr, nullptr, sq, sk,
                                        sv, nullptr, B, n, H, d), scale, 1, s);
}

// K5 backward: strided q, k, v and dout; contiguous dq, dk, dv [B, n, H, d];
// `stats` is f32 scratch of B * H * n * 3 elements.
int mhsa_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, void* stats, long long q_img, long long q_row, long long q_head,
             long long k_img, long long k_row, long long k_head, long long v_img,
             long long v_row, long long v_head, long long g_img, long long g_row,
             long long g_head, int B, int n, int H, int d, float scale, int dtype,
             void* stream) {
    if (bad_shape(B, n, H, d) || (dtype != 0 && dtype != 1)) return kBadShape;
    const long long sq[3] = {q_img, q_row, q_head}, sk[3] = {k_img, k_row, k_head},
                    sv[3] = {v_img, v_row, v_head}, sg[3] = {g_img, g_row, g_head};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return run_bwd(split_operands<float>(q, k, v, dout, nullptr, dq, dk, dv, sq, sk, sv, sg,
                                             B, n, H, d), stats, scale, 1, s);
    return run_bwd(split_operands<bf16>(q, k, v, dout, nullptr, dq, dk, dv, sq, sk, sv, sg, B, n,
                                        H, d), stats, scale, 1, s);
}

}  // extern "C"
