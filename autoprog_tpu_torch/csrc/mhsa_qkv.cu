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
// The rounding points are the Pallas kernels' (mhsa_common.cuh).
//
// What bounds it on this card. At the VOLO shape (B = 128, n = 196, d = 32,
// 12 heads) a call moves 77 MB forward and 135 MB backward (q, k, v, out; q,
// k, v, dout and the gradient; once each), 0.023 and 0.040 ms at 3.35 TB/s,
// against 7.6 and 19 GFLOP of products (0.008 and 0.019 ms at the bf16 peak)
// and 59 M exponentials a pass: by the roofline bytes bound it. The first
// design (one block per 64 query rows, K and V streamed through shared memory
// in tiles of 64 keys with a barrier around every load, the scores recomputed
// in each pass) ran at a tenth of that bound: it was bound by latency, not
// by bytes or arithmetic, since nothing was in flight while the tensor cores
// worked, a block lived for four tile loads, a head's K and V were fetched
// twelve times, and the scores were computed three times forward and four
// times backward.
//
// The design, for bf16 with n <= 256 and head_dim <= 64 (the resident path;
// the switch is by shape alone, RES_MAX_N and RES_MAX_D of mhsa_common.cuh):
//   * A block takes whole (image, head) cells. K and V of the cell (and the
//     block's q rows; in the backward all of q, k, v and dO) are fetched once
//     by cp.async into shared memory, K first, so that q k^T starts while V
//     is still in flight. A slab that takes no 16-byte copies goes through
//     the element loads instead, in the same kernels.
//   * A block walks over several cells (a grid sized from what is resident
//     on the card), and where a second buffer costs no residency it fetches
//     the next cell while it computes this one; else the other blocks of the
//     SM cover the load.
//   * A warp owns 16 query rows and walks the resident K and V 16 keys a
//     step. Fragments come from shared memory by ldmatrix (V and K
//     transposed by ldmatrix.trans), each sent a step ahead of its mma.
//   * With everything resident and loads off the critical path, what bounds
//     the kernels is the operations they spend per score and the registers
//     that set how many warps hide each other's latencies. So no score row
//     is held: the forward computes q k^T twice (row maxima, then exp and
//     T(e) . V) and phase A of the backward computes the scores and dP twice,
//     out of shared memory, and twice as many warps are resident as when a
//     warp held its 16 x n row in n / 2 registers. Per score the kernels
//     spend one cvt per two roundings, one fma and one ex2.approx for exp
//     (the row maximum stays exact), a multiplication by 1 / z taken once
//     per row, and a mask test per 16-key step.
//   * The forward writes (rowmax, z) per row, [B, heads, n, 2] f32, when the
//     caller wants a backward; the backward reads them instead of computing
//     them again.
//   * The backward is one kernel per cell in two phases over the same
//     resident tiles, the row sums passed in shared memory. No block carries
//     a sum to another and there are no atomics, so a result does not change
//     from run to run.
// Against the streaming cells the results differ by the f32 operations
// above (ex2.approx for expf, 1 / z), within 2 ulp of bf16.
// Above the resident path (n up to 1024, head_dim up to 128) the streaming
// cells of mhsa_common.cuh run as before, one (tile, head, image) per block,
// two kernels backward; they too write and read the saved statistics.
//
// f32, the reference path of the tests, runs scalar FMAs with the score rows
// in shared memory (the next section). wgmma and TMA are not used (PERF.md).

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
mhsa_fwd_kernel(Slab<const T> q, Slab<const T> k, Slab<const T> v, Slab<T> out,
                float2* __restrict__ fst, int n, int d, int H, float scale, int scores_f32) {
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
        if (lane == 0) {
            sZ[i] = z;
            if (fst != nullptr && q0 + i < n)
                fst[((size_t)b * H + h) * n + q0 + i] = make_float2(m, z);
        }
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

// stats[(b * H + h) * n + i] = (rowmax, rowsum(e), rowsum(dP * p)) for pass B;
// rowmax and rowsum(e) come from the forward's `fst` when it is given
template <typename T>
__global__ void __launch_bounds__(NT)
mhsa_bwd_dq_kernel(Slab<const T> q, Slab<const T> k, Slab<const T> v, Slab<const T> dout,
                   Slab<T> dq, const float2* __restrict__ fst, float3* __restrict__ stats, int n,
                   int d, int H, float scale, int scores_f32) {
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
        float m = -INFINITY, z = 0.f;
        if (fst != nullptr && q0 + i < n) {  // saved by the forward
            const float2 mz = fst[((size_t)b * H + h) * n + q0 + i];
            m = mz.x, z = mz.y;
        } else {
            for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
            m = warp_max(m);
            for (int j = lane; j < n; j += 32) z += expf(row[j] - m);
            z = warp_sum(z);
        }
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

// --------------------------------- bf16, streaming: one cell per block
//
// The cells of mhsa_common.cuh; blocks are (tile, head, image). They take
// what the resident path does not: n > RES_MAX_N or head_dim > RES_MAX_D.

template <int DP>
__global__ void __launch_bounds__(MT)
mhsa_fwd_mma(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out,
             float2* __restrict__ fst, int n, int d, int H, float scale, int scores_f32,
             int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] qs
    bf16* sK = sQ + MQ * LD;                         // [MK, LD]
    bf16* sV = sK + MK * LD;                         // [MK, LD]
    const int h = blockIdx.y, b = blockIdx.z;
    fwd_cell<DP>(sQ, sK, sV, q.at(b, h), q.row, k.at(b, h), k.row, v.at(b, h), v.row,
                 out.at(b, h), out.row, blockIdx.x * MQ, n, d, scale, scores_f32, vec,
                 fst ? fst + ((size_t)b * H + h) * n : nullptr);
}

template <int DP>
__global__ void __launch_bounds__(MT)
mhsa_bwd_dq_mma(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v,
                Slab<const bf16> dout, Slab<bf16> dq, const float2* __restrict__ fst,
                float3* __restrict__ stats, int n, int d, int H, float scale, int scores_f32,
                int vec) {
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
                    vec, fst ? fst + ((size_t)b * H + h) * n : nullptr);
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

// ------------------------------ bf16, resident path: whole cells per block
//
// The resident bodies of mhsa_common.cuh, one cell (or a chunk of its query
// rows) per work item.

// Forward in two sweeps over the resident K: the first keeps only the row
// maxima, the second computes the same scores again, bit for bit, and goes on
// to exp, the row sums and T(e) . V, 16 keys at a time. It holds no score
// row. (Holding the 16 x n row of a warp in n / 2 registers, for one q k^T,
// left 14 warps on an SM, spilled at n = 196 and was a quarter slower:
// PERF.md. The second q k^T reads shared memory only.) A work item is (cell,
// chunk of 16 W query rows); the block walks items blockIdx.x, + gridDim.x,
// ... One buffer holds the chunk's q rows and the cell's K and V. q and K are
// one cp.async group and V the next, so the first sweep runs while V lands;
// with nbuf == 2 the next item is fetched into the other buffer meanwhile.
template <int DP, int W>
__global__ void __launch_bounds__(32 * W, RES_MIN_BLOCKS<DP, W>)
mhsa_fwd_res(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out,
             float2* __restrict__ fst, int n, int d, int H, float scale, int scores_f32, int vec,
             int pk, int items, int chunks, int nbuf, int steps) {
    constexpr int LD = DP + PAD, QR = 16 * W;
    const int NN = 16 * steps, BUF = (QR + 2 * NN) * LD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* base = reinterpret_cast<bf16*>(smem_raw);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;

    auto fetch = [&](int item, bf16* s) {
        const int cell = item / chunks, q0 = (item - cell * chunks) * QR;
        const int b = cell / H, h = cell - b * H;
        fetch_tile<DP>(s, q.at(b, h), q.row, q0, QR, n, d, scale, true, vec);
        fetch_tile<DP>(s + QR * LD, k.at(b, h), k.row, 0, NN, n, d, 1.f, false, vec);
        cp_async_commit();
        fetch_tile<DP>(s + (QR + NN) * LD, v.at(b, h), v.row, 0, NN, n, d, 1.f, false, vec);
        cp_async_commit();
    };

    int item = blockIdx.x, cur = 0;
    if (item < items) fetch(item, base);
    for (; item < items; item += gridDim.x) {
        bf16* sQ = base + cur * BUF;
        bf16* sK = sQ + QR * LD;
        bf16* sV = sK + NN * LD;
        const int next = item + gridDim.x;
        const bool ahead = nbuf == 2 && next < items;
        if (ahead) fetch(next, base + (cur ^ 1) * BUF);
        const int cell = item / chunks, q0 = (item - cell * chunks) * QR;
        const int b = cell / H, h = cell - b * H;

        if (ahead) cp_async_wait<3>(); else cp_async_wait<1>();  // q and K are here
        if (vec) scale_own_chunks<DP>(sQ, q0, QR, n, d, scale);
        __syncthreads();
        const bool active = q0 + wr < n;
        uint32_t aq[DP / 16][4];
        float m0, m1;
        if (active) {
            load_a<DP>(aq, sQ, wr, lane);
            res_row_max<DP>(m0, m1, aq, sK, steps, n, t, lane, scores_f32, NoPark());
        }
        if (ahead) cp_async_wait<2>(); else cp_async_wait<0>();  // V is here
        __syncthreads();
        if (active) {
            auto again = [&](int kk, float (&s)[2][4]) {
                mma_abt_frag<DP, 16>(s, aq, sK + kk * 16 * LD, lane);
                if (!scores_f32) round_scores<16>(s);
                mask_scores<16>(s, kk * 16, n, t);
            };
            float z0, z1, o[DP / 8][4];
            res_exp_pv<DP>(o, z0, z1, again, sV, steps, m0 * LOG2E, m1 * LOG2E, lane);
            res_store_out<DP>(out.at(b, h) + (long long)q0 * out.row, out.row, o, z0, z1, wr,
                              n - q0, d, g, t, pk);
            if (fst != nullptr && t == 0) {
                float2* st = fst + (size_t)cell * n + q0 + wr + g;
                if (q0 + wr + g < n) st[0] = make_float2(m0, z0);
                if (q0 + wr + g + 8 < n) st[8] = make_float2(m1, z1);
            }
        }
        __syncthreads();  // every warp is done with this buffer
        if (nbuf == 1 && next < items) fetch(next, base);
        if (nbuf == 2) cur ^= 1;
    }
}

// Backward, both phases of a cell in one block. One buffer holds qs, K, V
// and dO of the cell, [4][16 steps][LD]; sSt holds (rowmax log2(e), 1 / z,
// rowsum(dP p)) per query row between the phases, so no statistics go
// through device memory. Phase A, per 16 query rows, walks K and V twice, 16
// keys a step: first for rowsum(dP e), then, with the scores, exp and dP of
// the step computed again, for dS and dQ (5 products); phase B, per 16 keys,
// walks the queries once (S^T, dP^T, T(p)^T dO, T(dS)^T qs). Nothing of a
// row is held between the walks. (Holding exp(S - max) of a row in n / 2
// registers saves a product and costs half the resident warps: equal at n =
// 196, slower at 100 and 144, spills at head_dim 64. Holding S packed at bf16
// and dP as well, for 7 products, was slower still: PERF.md.)
template <int DP, int W, int MINB>
__global__ void __launch_bounds__(32 * W, MINB)
mhsa_bwd_res(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<const bf16> dout,
             Slab<bf16> dq, Slab<bf16> dk, Slab<bf16> dv, const float2* __restrict__ fst, int n,
             int d, int H, float scale, int scores_f32, int vec, int pk, int items, int nbuf,
             int steps) {
    constexpr int LD = DP + PAD;
    const int NN = 16 * steps, TILE = NN * LD, BUF = 4 * TILE;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float3* sSt = reinterpret_cast<float3*>(smem_raw);  // [NN], 192 bytes a step
    bf16* base = reinterpret_cast<bf16*>(smem_raw + sizeof(float3) * NN);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int warp = threadIdx.x >> 5;

    auto fetch = [&](int cell, bf16* s) {
        const int b = cell / H, h = cell - b * H;
        fetch_tile<DP>(s, q.at(b, h), q.row, 0, NN, n, d, scale, true, vec);
        fetch_tile<DP>(s + TILE, k.at(b, h), k.row, 0, NN, n, d, 1.f, false, vec);
        fetch_tile<DP>(s + 2 * TILE, v.at(b, h), v.row, 0, NN, n, d, 1.f, false, vec);
        fetch_tile<DP>(s + 3 * TILE, dout.at(b, h), dout.row, 0, NN, n, d, 1.f, false, vec);
        cp_async_commit();
    };

    int cell = blockIdx.x, cur = 0;
    if (cell < items) fetch(cell, base);
    for (; cell < items; cell += gridDim.x) {
        bf16* sQ = base + cur * BUF;
        bf16* sK = sQ + TILE;
        bf16* sV = sK + TILE;
        bf16* sDO = sV + TILE;
        const int next = cell + gridDim.x;
        const bool ahead = nbuf == 2 && next < items;
        if (ahead) fetch(next, base + (cur ^ 1) * BUF);
        const int b = cell / H, h = cell - b * H;
        const float2* st_in = fst ? fst + (size_t)cell * n : nullptr;

        if (ahead) cp_async_wait<1>(); else cp_async_wait<0>();
        if (vec) scale_own_chunks<DP>(sQ, 0, NN, n, d, scale);
        __syncthreads();

        // phase A: dQ and the row statistics of 16 query rows per warp
        for (int rg = warp; rg < steps; rg += W) {
            const int r0 = rg * 16;
            uint32_t aq[DP / 16][4], ado[DP / 16][4];  // the rows' qs and dO
            load_a<DP>(aq, sQ, r0, lane);
            load_a<DP>(ado, sDO, r0, lane);
            const RowStats r =
                bwd_row_stats<DP>(aq, ado, sK, sV, st_in, r0, steps, n, g, t, lane, scores_f32);
            float acc[DP / 8][4];
            bwd_row_dq<DP>(acc, r, aq, ado, sK, sV, steps, n, t, lane, scores_f32, scale);
            store_rows_pk<DP>(dq.at(b, h), dq.row, acc, r0, n, d, g, t, pk);
            put_row_stats(sSt, r, r0, n, g, t);
        }
        __syncthreads();

        // phase B: dK and dV of 16 keys per warp, over the queries 16 at a time
        for (int kg = warp; kg < steps; kg += W) {
            const int j0 = kg * 16;
            float gk[DP / 8][4], gv[DP / 8][4];
            bwd_key_grads<DP>(gk, gv, sQ, sK, sV, sDO, sSt, j0, NN, t, lane, scores_f32);
            store_rows_pk<DP>(dk.at(b, h), dk.row, gk, j0, n, d, g, t, pk);
            store_rows_pk<DP>(dv.at(b, h), dv.row, gv, j0, n, d, g, t, pk);
        }
        __syncthreads();  // every warp is done with this buffer and with sSt
        if (nbuf == 1 && next < items) fetch(next, base);
        if (nbuf == 2) cur ^= 1;
    }
}

// ------------------------------------------------------------------ host

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
    // forward: where (rowmax, z) go, [B, H, n] or null; backward: where they
    // come from, or null
    float2* fst;
    float3* scratch;  // backward, streaming and f32 kernels: [B, H, n] between the passes
    int B, n, H, d;
};

template <int DP, int W>
int fwd_res(const Operands<bf16>& a, float scale, int scores_f32, int vec, cudaStream_t stream) {
    const int steps = ceil_div(a.n, 16);
    const size_t buf = tile_bytes(16 * W + 32 * steps, DP);
    static Plan plans[1][17] = {};
    Plan plan{};
    const int err = cached_plan(plans, 0, steps, plan, [&](Plan& p) {
        return (int)make_plan(mhsa_fwd_res<DP, W>, 32 * W, buf, 0, p);
    });
    if (err != 0) return err;
    const int chunks = ceil_div(steps, W), items = a.B * a.H * chunks;
    const int pk = a.d % 2 == 0 && even_slab(a.out);
    mhsa_fwd_res<DP, W><<<min(items, plan.resident), 32 * W, plan.nbuf * buf, stream>>>(
        a.q, a.k, a.v, a.out, a.fst, a.n, a.d, a.H, scale, scores_f32, vec, pk, items, chunks,
        plan.nbuf, steps);
    return (int)cudaGetLastError();
}

template <int DP>
int fwd_res_steps(const Operands<bf16>& a, float scale, int scores_f32, int vec, cudaStream_t s) {
    return with_fwd_w(ceil_div(a.n, 16), [&](auto w) {
        return fwd_res<DP, decltype(w)::value>(a, scale, scores_f32, vec, s);
    });
}

template <int DP, int W, int MINB>
int bwd_res(const Operands<bf16>& a, float scale, int scores_f32, int vec, cudaStream_t stream) {
    const int steps = ceil_div(a.n, 16);
    const size_t buf = tile_bytes(64 * steps, DP), fixed = sizeof(float3) * 16 * steps;
    static Plan plans[1][17] = {};
    Plan plan{};
    const int err = cached_plan(plans, 0, steps, plan, [&](Plan& p) {
        return (int)make_plan(mhsa_bwd_res<DP, W, MINB>, 32 * W, buf, fixed, p);
    });
    if (err != 0) return err;
    const int items = a.B * a.H;
    const int pk = a.d % 2 == 0 && even_slab(a.dq) && even_slab(a.dk) && even_slab(a.dv);
    mhsa_bwd_res<DP, W, MINB>
        <<<min(items, plan.resident), 32 * W, plan.nbuf * buf + fixed, stream>>>(
            a.q, a.k, a.v, a.dout, a.dq, a.dk, a.dv, a.fst, a.n, a.d, a.H, scale, scores_f32,
            vec, pk, items, plan.nbuf, steps);
    return (int)cudaGetLastError();
}

int bwd_res_steps(const Operands<bf16>& a, float scale, int scores_f32, int vec, cudaStream_t s) {
    return with_bwd_w(a.d, ceil_div(a.n, 16), [&](auto dp, auto w, auto minb) {
        return bwd_res<decltype(dp)::value, decltype(w)::value, decltype(minb)::value>(
            a, scale, scores_f32, vec, s);
    });
}

template <int DP>
int fwd_mma(const Operands<bf16>& a, float scale, int scores_f32, int vec, cudaStream_t stream) {
    const dim3 grid(ceil_div(a.n, MQ), a.H, a.B);
    const size_t smem = fwd_cell_smem<DP>(MW);
    cudaError_t err = allow_smem(mhsa_fwd_mma<DP>, smem);
    if (err != cudaSuccess) return (int)err;
    mhsa_fwd_mma<DP><<<grid, MT, smem, stream>>>(a.q, a.k, a.v, a.out, a.fst, a.n, a.d, a.H,
                                                 scale, scores_f32, vec);
    return (int)cudaGetLastError();
}

template <int DP>
int bwd_mma(const Operands<bf16>& a, float scale, int scores_f32, int vec, cudaStream_t stream) {
    if (a.scratch == nullptr) return kBadShape;
    const dim3 grid(ceil_div(a.n, MQ), a.H, a.B);

    const size_t smem_a = dq_cell_smem<DP>(MW);
    cudaError_t err = allow_smem(mhsa_bwd_dq_mma<DP>, smem_a);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dq_mma<DP><<<grid, MT, smem_a, stream>>>(a.q, a.k, a.v, a.dout, a.dq, a.fst,
                                                      a.scratch, a.n, a.d, a.H, scale,
                                                      scores_f32, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const size_t smem_b = dkv_cell_smem<DP>(MW);
    err = allow_smem(mhsa_bwd_dkv_mma<DP>, smem_b);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dkv_mma<DP><<<grid, MT, smem_b, stream>>>(a.q, a.k, a.v, a.dout, a.dk, a.dv,
                                                       a.scratch, a.n, a.d, a.H, scale,
                                                       scores_f32, vec);
    return (int)cudaGetLastError();
}

template <typename T>
int fwd_scalar(const Operands<T>& a, float scale, int scores_f32, cudaStream_t stream) {
    const dim3 grid(ceil_div(a.n, TQ), a.H, a.B);
    const size_t smem = fwd_smem(a.n, a.d);
    cudaError_t err = allow_smem(mhsa_fwd_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    mhsa_fwd_kernel<T><<<grid, NT, smem, stream>>>(a.q, a.k, a.v, a.out, a.fst, a.n, a.d, a.H,
                                                   scale, scores_f32);
    return (int)cudaGetLastError();
}

template <typename T>
int bwd_scalar(const Operands<T>& a, float scale, int scores_f32, cudaStream_t stream) {
    if (a.scratch == nullptr) return kBadShape;
    const dim3 grid_a(ceil_div(a.n, TQ), a.H, a.B);
    const size_t smem_a = bwd_dq_smem(a.n, a.d);
    cudaError_t err = allow_smem(mhsa_bwd_dq_kernel<T>, smem_a);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dq_kernel<T><<<grid_a, NT, smem_a, stream>>>(a.q, a.k, a.v, a.dout, a.dq, a.fst,
                                                          a.scratch, a.n, a.d, a.H, scale,
                                                          scores_f32);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const dim3 grid_b(ceil_div(a.n, TKB), a.H, a.B);
    const size_t smem_b = bwd_dkv_smem(a.d);
    err = allow_smem(mhsa_bwd_dkv_kernel<T>, smem_b);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dkv_kernel<T><<<grid_b, NT, smem_b, stream>>>(a.q, a.k, a.v, a.dout, a.dk, a.dv,
                                                           a.scratch, a.n, a.d, a.H, scale,
                                                           scores_f32);
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
    if (resident_path(a.n, a.d)) {
        if (a.d <= 32) return fwd_res_steps<32>(a, scale, scores_f32, vec, s);
        return fwd_res_steps<64>(a, scale, scores_f32, vec, s);
    }
    if (a.d <= 32) return fwd_mma<32>(a, scale, scores_f32, vec, s);
    if (a.d <= 64) return fwd_mma<64>(a, scale, scores_f32, vec, s);
    return fwd_mma<128>(a, scale, scores_f32, vec, s);
}

template <typename T>
int run_bwd(const Operands<T>& a, float scale, int scores_f32, cudaStream_t s);

template <>
int run_bwd<float>(const Operands<float>& a, float scale, int scores_f32, cudaStream_t s) {
    return bwd_scalar<float>(a, scale, scores_f32, s);
}

template <>
int run_bwd<bf16>(const Operands<bf16>& a, float scale, int scores_f32, cudaStream_t s) {
    const int vec = can_vec(a, true);
    if (resident_path(a.n, a.d)) {
        return bwd_res_steps(a, scale, scores_f32, vec, s);
    }
    if (a.d <= 32) return bwd_mma<32>(a, scale, scores_f32, vec, s);
    if (a.d <= 64) return bwd_mma<64>(a, scale, scores_f32, vec, s);
    return bwd_mma<128>(a, scale, scores_f32, vec, s);
}

// K1: the operands of a raw qkv projection, its output and its gradient
template <typename T>
Operands<T> qkv_operands(const void* qkv, const void* dout, void* out, void* dqkv, void* fst,
                         void* scratch, int B, int n, int C, int H) {
    Operands<T> a{};
    const int d = C / H;
    qkv_slabs<const T>(qkv, n, C, d, a.q, a.k, a.v);
    a.dout = slab<const T>(dout, (long long)n * C, C, d);
    a.out = slab<T>(out, (long long)n * C, C, d);
    qkv_slabs<T>(dqkv, n, C, d, a.dq, a.dk, a.dv);
    a.fst = static_cast<float2*>(fst);
    a.scratch = static_cast<float3*>(scratch);
    a.B = B, a.n = n, a.H = H, a.d = d;
    return a;
}

// K5: strided q, k, v (and dout); contiguous [B, n, H, d] results
template <typename T>
Operands<T> split_operands(const void* q, const void* k, const void* v, const void* dout,
                           void* out, void* dq, void* dk, void* dv, void* fst, void* scratch,
                           const long long* sq, const long long* sk, const long long* sv,
                           const long long* sg, int B, int n, int H, int d) {
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
    a.fst = static_cast<float2*>(fst);
    a.scratch = static_cast<float3*>(scratch);
    a.B = B, a.n = n, a.H = H, a.d = d;
    return a;
}

}  // namespace

extern "C" {

// Every entry point returns 0 on success, a cudaError_t value, or -1 for a
// shape the kernels do not take. `stream` is a cudaStream_t. dtype: 0 =
// float32, 1 = bfloat16.
//
// `stats` is [B, H, n, 2] f32, (rowmax, z) per query row. A forward writes
// it unless it is null (no backward will follow). A backward reads it, and
// computes the two itself when it is null. `scratch` is f32 of B * H * n * 3
// elements that the two-kernel backwards (f32, and bf16 outside the resident
// path: mhsa_uses_scratch) pass the row statistics through; else it may be
// null.

// 1 when a backward of this type and shape needs `scratch`
int mhsa_uses_scratch(int n, int d, int dtype) { return dtype == 0 || !resident_path(n, d); }

// K1 forward: qkv [B, n, 3C] -> out [B, n, C].
int mhsa_qkv_fwd(const void* qkv, void* out, void* stats, int B, int n, int C, int H, float scale,
                 int scores_f32, int dtype, void* stream) {
    if (H < 1 || C % H != 0 || bad_shape(B, n, H, C / H) || (dtype != 0 && dtype != 1))
        return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return run_fwd(qkv_operands<float>(qkv, nullptr, out, nullptr, stats, nullptr, B, n, C, H),
                       scale, scores_f32, s);
    return run_fwd(qkv_operands<bf16>(qkv, nullptr, out, nullptr, stats, nullptr, B, n, C, H),
                   scale, scores_f32, s);
}

// K1 backward: qkv, dout [B, n, C] -> dqkv [B, n, 3C].
int mhsa_qkv_bwd(const void* qkv, const void* dout, void* dqkv, const void* stats, void* scratch,
                 int B, int n, int C, int H, float scale, int scores_f32, int dtype,
                 void* stream) {
    if (H < 1 || C % H != 0 || bad_shape(B, n, H, C / H) || (dtype != 0 && dtype != 1))
        return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    void* st = const_cast<void*>(stats);
    if (dtype == 0)
        return run_bwd(qkv_operands<float>(qkv, dout, nullptr, dqkv, st, scratch, B, n, C, H),
                       scale, scores_f32, s);
    return run_bwd(qkv_operands<bf16>(qkv, dout, nullptr, dqkv, st, scratch, B, n, C, H), scale,
                   scores_f32, s);
}

// K5 forward: q, k, v of shape [B, n, H, d] with the element strides
// (image, row, head) given for each, lanes contiguous; out is contiguous
// [B, n, H, d]. Scores stay f32.
int mhsa_fwd(const void* q, const void* k, const void* v, void* out, void* stats, long long q_img,
             long long q_row, long long q_head, long long k_img, long long k_row,
             long long k_head, long long v_img, long long v_row, long long v_head, int B, int n,
             int H, int d, float scale, int dtype, void* stream) {
    if (bad_shape(B, n, H, d) || (dtype != 0 && dtype != 1)) return kBadShape;
    const long long sq[3] = {q_img, q_row, q_head}, sk[3] = {k_img, k_row, k_head},
                    sv[3] = {v_img, v_row, v_head};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return run_fwd(split_operands<float>(q, k, v, nullptr, out, nullptr, nullptr, nullptr,
                                             stats, nullptr, sq, sk, sv, nullptr, B, n, H, d),
                       scale, 1, s);
    return run_fwd(split_operands<bf16>(q, k, v, nullptr, out, nullptr, nullptr, nullptr, stats,
                                        nullptr, sq, sk, sv, nullptr, B, n, H, d),
                   scale, 1, s);
}

// K5 backward: strided q, k, v and dout; contiguous dq, dk, dv [B, n, H, d].
int mhsa_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, const void* stats, void* scratch, long long q_img, long long q_row,
             long long q_head, long long k_img, long long k_row, long long k_head,
             long long v_img, long long v_row, long long v_head, long long g_img,
             long long g_row, long long g_head, int B, int n, int H, int d, float scale,
             int dtype, void* stream) {
    if (bad_shape(B, n, H, d) || (dtype != 0 && dtype != 1)) return kBadShape;
    const long long sq[3] = {q_img, q_row, q_head}, sk[3] = {k_img, k_row, k_head},
                    sv[3] = {v_img, v_row, v_head}, sg[3] = {g_img, g_row, g_head};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    void* st = const_cast<void*>(stats);
    if (dtype == 0)
        return run_bwd(split_operands<float>(q, k, v, dout, nullptr, dq, dk, dv, st, scratch, sq,
                                             sk, sv, sg, B, n, H, d),
                       scale, 1, s);
    return run_bwd(split_operands<bf16>(q, k, v, dout, nullptr, dq, dk, dv, st, scratch, sq, sk,
                                        sv, sg, B, n, H, d),
                   scale, 1, s);
}

}  // extern "C"
