// Fused multi-head self-attention on the raw fused-qkv projection (K1).
//
// Replaces autoprog_tpu/ops/attention_pallas.py:mhsa_fused_qkv
// (_fwd_kernel_qkv forward, _bwd_kernel_qkv backward) for Hopper (sm_90a).
//
// Input qkv is [B, n, 3C] straight out of the qkv Dense, channel order
// (3, heads, d): q/k/v of head h sit at lanes j*C + h*d .. j*C + (h+1)*d.
// The kernels address those slices by the row stride 3C, so there is no
// relayout before or after the call. The output is [B, n, C] with head h
// in lanes h*d .. (h+1)*d; the gradient is one [B, n, 3C] tensor.
//
// Numerics follow the Pallas kernel exactly (rounding points included):
//   qs = T(f32(q) * scale)
//   S  = qs . k^T accumulated in f32, rounded to the score type
//        (T, or f32 when scores_f32)
//   e  = exp(S - rowmax) in f32, z = rowsum(e)
//   O  = (T(e) . v) / z, the unnormalised e rounded to T before the product
// backward, with p = softmax(f32(S)) recomputed:
//   dV = T(p)^T . dO, dP = dO . v^T, dS = T(p * (dP - rowsum(dP * p)))
//   dQ = (dS . k) * scale, dK = dS^T . qs
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
// (mma.sync, below), with the scores in registers. f32 runs them as scalar
// FMAs with the score rows in shared memory (the next section). wgmma/TMA
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;     // threads per block
constexpr int TQ = 16;      // query rows per block: forward and backward pass A
constexpr int TK = 64;      // key rows per shared-memory tile: forward, pass A
constexpr int TKB = 16;     // key rows per block: backward pass B
constexpr int TQB = 32;     // query rows per shared-memory tile: pass B
constexpr int MAX_D = 128;  // largest head_dim the router sends
constexpr int MAX_N = 1024; // longest sequence the router sends

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype does
}

// round an f32 value to T and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f<T>(from_f<T>(x));
}

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
__device__ void load_rows(float* dst, int ld, const T* __restrict__ base, size_t stride,
                          int r0, int rows, int n, int d, float scale, bool as_qs) {
    for (int idx = threadIdx.x; idx < rows * d; idx += NT) {
        const int r = idx / d, c = idx - (idx / d) * d;
        float v = 0.f;
        if (r0 + r < n) {
            v = to_f<T>(base[(size_t)(r0 + r) * stride + c]);
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
                            const T* __restrict__ kbase, size_t stride, int n, int d,
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
mhsa_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int C, int d,
                float scale, int scores_f32) {
    extern __shared__ float smem[];
    const int ld = d + 1;  // odd row pitch: column reads across rows hit distinct banks
    const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
    float* sQ = smem;            // [TQ, ld]  qs rows
    float* sKV = sQ + TQ * ld;   // [TK, ld]  K tile, then V tile
    float* sS = sKV + TK * ld;   // [TQ, n]   scores, then T(e)
    float* sZ = sS + TQ * n;     // [TQ]      rowsum(e)

    const size_t stride = 3 * (size_t)C;
    const T* base = qkv + (size_t)b * n * stride + (size_t)h * d;
    load_rows<T>(sQ, ld, base, stride, q0, TQ, n, d, scale, true);
    scores_rows<T>(sS, sQ, sKV, ld, base + C, stride, n, d, scores_f32);

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
        load_rows<T>(sKV, ld, base + 2 * C, stride, k0, kr, n, d, 1.f, false);
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
#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
        const int o = threadIdx.x + r * NT;
        if (o < nout) {
            const int i = o / d, c = o - (o / d) * d;
            if (q0 + i < n)
                out[((size_t)b * n + q0 + i) * C + (size_t)h * d + c] = from_f<T>(acc[r] / sZ[i]);
        }
    }
}

// ------------------------------------------------- backward pass A: dQ, stats

// stats[(b * H + h) * n + i] = (rowmax, rowsum(e), rowsum(dP * p))
template <typename T>
__global__ void __launch_bounds__(NT)
mhsa_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                   T* __restrict__ dqkv, float3* __restrict__ stats, int n, int C, int d,
                   int H, float scale, int scores_f32) {
    extern __shared__ float smem[];
    const int ld = d + 1;
    const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
    float* sQ = smem;             // [TQ, ld] qs rows
    float* sDO = sQ + TQ * ld;    // [TQ, ld] dO rows
    float* sKV = sDO + TQ * ld;   // [TK, ld] K or V tile
    float* sP = sKV + TK * ld;    // [TQ, n]  scores, then p
    float* sDS = sP + TQ * n;     // [TQ, n]  dP, then T(dS)

    const size_t stride = 3 * (size_t)C;
    const T* base = qkv + (size_t)b * n * stride + (size_t)h * d;
    const T* obase = dout + (size_t)b * n * C + (size_t)h * d;
    load_rows<T>(sQ, ld, base, stride, q0, TQ, n, d, scale, true);
    load_rows<T>(sDO, ld, obase, C, q0, TQ, n, d, 1.f, false);
    scores_rows<T>(sP, sQ, sKV, ld, base + C, stride, n, d, scores_f32);

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
        load_rows<T>(sKV, ld, base + 2 * C, stride, k0, kr, n, d, 1.f, false);
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
        load_rows<T>(sKV, ld, base + C, stride, k0, kr, n, d, 1.f, false);
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
#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
        const int o = threadIdx.x + r * NT;
        if (o < nout) {
            const int i = o / d, c = o - (o / d) * d;
            if (q0 + i < n)
                dqkv[((size_t)b * n + q0 + i) * stride + (size_t)h * d + c] =
                    from_f<T>(acc[r] * scale);
        }
    }
}

// ---------------------------------------------- backward pass B: dK and dV

template <typename T>
__global__ void __launch_bounds__(NT)
mhsa_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                    T* __restrict__ dqkv, const float3* __restrict__ stats, int n, int C,
                    int d, int H, float scale, int scores_f32) {
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

    const size_t stride = 3 * (size_t)C;
    const T* base = qkv + (size_t)b * n * stride + (size_t)h * d;
    const T* obase = dout + (size_t)b * n * C + (size_t)h * d;
    const float3* st = stats + ((size_t)b * H + h) * n;
    load_rows<T>(sK, ld, base + C, stride, j0, TKB, n, d, 1.f, false);
    load_rows<T>(sV, ld, base + 2 * C, stride, j0, TKB, n, d, 1.f, false);

    constexpr int MAXO = TKB * MAX_D / NT;
    float acc_k[MAXO], acc_v[MAXO];
#pragma unroll
    for (int r = 0; r < MAXO; ++r) acc_k[r] = acc_v[r] = 0.f;
    const int nout = TKB * d;

    for (int q0 = 0; q0 < n; q0 += TQB) {
        __syncthreads();  // previous tile fully consumed
        load_rows<T>(sQ, ld, base, stride, q0, TQB, n, d, scale, true);
        load_rows<T>(sDO, ld, obase, C, q0, TQB, n, d, 1.f, false);
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
#pragma unroll
    for (int r = 0; r < MAXO; ++r) {
        const int o = threadIdx.x + r * NT;
        if (o < nout) {
            const int j = o / d, c = o - (o / d) * d;
            if (j0 + j < n) {
                T* row = dqkv + ((size_t)b * n + j0 + j) * stride + (size_t)h * d + c;
                row[C] = from_f<T>(acc_k[r]);
                row[2 * C] = from_f<T>(acc_v[r]);
            }
        }
    }
}

// ------------------------------------------- bf16: tensor-core (mma.sync)
//
// The bf16 kernels run every product on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), the same rounding points as
// above. Each warp owns 16 rows of the product; a block is 4 warps, 64
// rows. The n x n score matrix never leaves registers: a score tile is an
// mma accumulator, and its f32 fragment is rounded to bf16 and re-used as
// the A operand of the next product (the accumulator and A layouts of
// m16n8k16 line up). No pass keeps a score row, so instead the scores are
// recomputed, bit for bit, in each pass that needs them:
//   forward  1: rowmax(S)          2: e, z and T(e) . V
//   dQ pass  1: rowmax(S)          2: z and rowsum(dP * e) / z
//            3: dS and dS . K, then (max, z, rowsum) to `stats`
//   dK/dV    per key tile, loop over query tiles: p and dS from `stats`,
//            T(p)^T . dO and dS^T . qs accumulated in registers.
// Head dims are zero-padded to DP = 32, 64 or 128 in shared memory; rows and
// keys past n are masked.

using bf16 = __nv_bfloat16;

constexpr int MW = 4;        // warps per block
constexpr int MT = 32 * MW;  // threads per block
constexpr int MQ = 16 * MW;  // product rows per block, 16 per warp
constexpr int MK = 64;       // key rows per shared-memory tile (forward, dQ)
constexpr int PAD = 8;       // bf16 elements of padding per shared row (16 bytes)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two f32 values rounded to bf16 (nearest even), the lower column first
__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
    return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// Fragments of m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: {r g, c 2t..2t+1}, {r g+8, c 2t..}, {r g, c 2t+8..}, {r g+8, c 2t+8..}
//   B 16x8:  {k 2t..2t+1, n g}, {k 2t+8..2t+9, n g}
//   C 16x8:  c0,c1 at (r g, c 2t..2t+1), c2,c3 at (r g+8, c 2t..2t+1)
// A from a row-major tile s[row][col] at rows r0.., cols c0..
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld, int r0, int c0,
                                       int g, int t) {
    const bf16* p = s + (r0 + g) * ld + c0 + 2 * t;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * ld);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * ld + 8);
}

// B[k][n] = s[n0 + n][k0 + k]: k runs along a shared row (K for S = qs . K^T)
__device__ __forceinline__ void frag_b_rows(uint32_t& b0, uint32_t& b1, const bf16* s, int ld,
                                            int n0, int k0, int g, int t) {
    const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
    b0 = ld32(p);
    b1 = ld32(p + 8);
}

// B[k][n] = s[k0 + k][n0 + n]: k runs down a shared column (V for T(e) . V)
__device__ __forceinline__ void frag_b_cols(uint32_t& b0, uint32_t& b1, const bf16* s, int ld,
                                            int k0, int n0, int g, int t) {
    const bf16* p = s + (k0 + 2 * t) * ld + n0 + g;
    b0 = pack2(p[0], p[ld]);
    b1 = pack2(p[8 * ld], p[9 * ld]);
}

// A of k-step kk from the f32 accumulators of n-tiles 2kk and 2kk + 1,
// rounded to bf16: a product's output feeds the next product directly
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
    a[0] = pack2f(c0[0], c0[1]);
    a[1] = pack2f(c0[2], c0[3]);
    a[2] = pack2f(c1[0], c1[1]);
    a[3] = pack2f(c1[2], c1[3]);
}

// acc[16 x NN] = sA[r0 .. r0 + 16) . sB[0 .. NN)^T over the DP lanes
template <int DP, int NN>
__device__ __forceinline__ void mma_abt(float (&acc)[NN / 8][4], const bf16* sA, int r0,
                                        const bf16* sB, int g, int t) {
    constexpr int LD = DP + PAD;
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
        uint32_t a[4];
        frag_a(a, sA, LD, r0, ks * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < NN / 8; ++nt) {
            uint32_t b0, b1;
            frag_b_rows(b0, b1, sB, LD, nt * 8, ks * 16, g, t);
            mma_bf16(acc[nt], a, b0, b1);
        }
    }
}

// acc[16 x DP] += A(k-step kk of p) . s[16 kk ..][0 .. DP) for NN / 16 k-steps
template <int DP, int NN>
__device__ __forceinline__ void mma_pv(float (&acc)[DP / 8][4], const float (&p)[NN / 8][4],
                                       const bf16* s, int g, int t) {
    constexpr int LD = DP + PAD;
#pragma unroll
    for (int kk = 0; kk < NN / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt) {
            uint32_t b0, b1;
            frag_b_cols(b0, b1, s, LD, kk * 16, dt * 8, g, t);
            mma_bf16(acc[dt], a, b0, b1);
        }
    }
}

// Round scores to the score type and mask the columns past n with -inf.
template <int NN>
__device__ __forceinline__ void finish_scores(float (&s)[NN / 8][4], int c0, int n, int t,
                                              int scores_f32) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int col = c0 + nt * 8 + 2 * t + (e & 1);
            const float v = scores_f32 ? s[nt][e] : round_to<bf16>(s[nt][e]);
            s[nt][e] = col < n ? v : -INFINITY;
        }
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copy `rows` rows of one head slice (d lanes, row stride `stride`) from row
// r0 into a shared tile [rows][DP + PAD]; rows past n and lanes past d are
// zero. `as_qs` stores qs = T(f32(q) * scale). `vec`: 16-byte loads (d % 8
// == 0 and a 16-byte aligned base).
template <int DP>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, size_t stride, int r0,
                          int rows, int n, int d, float scale, bool as_qs, bool vec) {
    constexpr int LD = DP + PAD;
    if (vec) {
        constexpr int CH = DP / 8;
        for (int idx = threadIdx.x; idx < rows * CH; idx += MT) {
            const int r = idx / CH, c = (idx - r * CH) * 8;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (r0 + r < n && c < d) {
                v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + c);
                if (as_qs) {
                    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
                    for (int k = 0; k < 8; ++k)
                        e[k] = __float2bfloat16(__bfloat162float(e[k]) * scale);
                }
            }
            *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
        }
    } else {
        for (int idx = threadIdx.x; idx < rows * DP; idx += MT) {
            const int r = idx / DP, c = idx - r * DP;
            bf16 v = __float2bfloat16(0.f);
            if (r0 + r < n && c < d) {
                v = src[(size_t)(r0 + r) * stride + c];
                if (as_qs) v = __float2bfloat16(__bfloat162float(v) * scale);
            }
            dst[r * LD + c] = v;
        }
    }
}

// Store a warp's 16 x DP accumulator to rows r0.. of a [*, row_stride]
// bf16 matrix; rows past n and lanes past d are skipped.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, size_t row_stride,
                                           const float (&acc)[DP / 8][4], int r0, int n, int d,
                                           int g, int t) {
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = r0 + g + (e >> 1) * 8, c = dt * 8 + 2 * t + (e & 1);
            if (r < n && c < d) dst[(size_t)r * row_stride + c] = __float2bfloat16(acc[dt][e]);
        }
}

template <int DP>
__global__ void __launch_bounds__(MT)
mhsa_fwd_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n, int C, int d,
             float scale, int scores_f32, int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] qs
    bf16* sK = sQ + MQ * LD;                         // [MK, LD]
    bf16* sV = sK + MK * LD;                         // [MK, LD]
    const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile
    const size_t stride = 3 * (size_t)C;
    const bf16* base = qkv + (size_t)b * n * stride + (size_t)h * d;
    load_tile<DP>(sQ, base, stride, q0, MQ, n, d, scale, true, vec);

    float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, base + C, stride, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
#pragma unroll
        for (int nt = 0; nt < MK / 8; ++nt) {
            m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
            m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
        }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    float o[DP / 8][4];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    float z0 = 0.f, z1 = 0.f;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, base + C, stride, k0, MK, n, d, 1.f, false, vec);
        load_tile<DP>(sV, base + 2 * C, stride, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
#pragma unroll
        for (int nt = 0; nt < MK / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float ex = expf(s[nt][e] - (e < 2 ? m0 : m1));
                if (e < 2) z0 += ex; else z1 += ex;
                s[nt][e] = ex;
            }
        mma_pv<DP, MK>(o, s, sV, g, t);  // T(e) . V
    }
    z0 = quad_sum(z0);
    z1 = quad_sum(z1);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] /= e < 2 ? z0 : z1;
    store_rows<DP>(out + ((size_t)b * n + q0) * C + (size_t)h * d, C, o, wr, n - q0, d, g, t);
}

template <int DP>
__global__ void __launch_bounds__(MT)
mhsa_bwd_dq_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                bf16* __restrict__ dqkv, float3* __restrict__ stats, int n, int C, int d, int H,
                float scale, int scores_f32, int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] qs
    bf16* sDO = sQ + MQ * LD;                        // [MQ, LD] dO
    bf16* sK = sDO + MQ * LD;                        // [MK, LD]
    bf16* sV = sK + MK * LD;                         // [MK, LD]
    const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    const size_t stride = 3 * (size_t)C;
    const bf16* base = qkv + (size_t)b * n * stride + (size_t)h * d;
    load_tile<DP>(sQ, base, stride, q0, MQ, n, d, scale, true, vec);
    load_tile<DP>(sDO, dout + (size_t)b * n * C + (size_t)h * d, C, q0, MQ, n, d, 1.f, false, vec);

    float m0 = -INFINITY, m1 = -INFINITY;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, base + C, stride, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
#pragma unroll
        for (int nt = 0; nt < MK / 8; ++nt) {
            m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
            m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
        }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    // z = rowsum(e) and rowsum(dP * p) = rowsum(dP * e) / z
    float z0 = 0.f, z1 = 0.f, r0 = 0.f, r1 = 0.f;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, base + C, stride, k0, MK, n, d, 1.f, false, vec);
        load_tile<DP>(sV, base + 2 * C, stride, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4], dp[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
        mma_abt<DP, MK>(dp, sDO, wr, sV, g, t);
#pragma unroll
        for (int nt = 0; nt < MK / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float ex = expf(s[nt][e] - (e < 2 ? m0 : m1));
                if (e < 2) { z0 += ex; r0 += ex * dp[nt][e]; }
                else { z1 += ex; r1 += ex * dp[nt][e]; }
            }
    }
    z0 = quad_sum(z0);
    z1 = quad_sum(z1);
    r0 = quad_sum(r0) / z0;
    r1 = quad_sum(r1) / z1;

    // dS = T(p * (dP - rowsum)), dQ = (dS . K) * scale
    float dq[DP / 8][4];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, base + C, stride, k0, MK, n, d, 1.f, false, vec);
        load_tile<DP>(sV, base + 2 * C, stride, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4], dp[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
        mma_abt<DP, MK>(dp, sDO, wr, sV, g, t);
#pragma unroll
        for (int nt = 0; nt < MK / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(s[nt][e] - (e < 2 ? m0 : m1)) / (e < 2 ? z0 : z1);
                s[nt][e] = p * (dp[nt][e] - (e < 2 ? r0 : r1));
            }
        mma_pv<DP, MK>(dq, s, sK, g, t);  // T(dS) . K
    }
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[dt][e] *= scale;
    store_rows<DP>(dqkv + ((size_t)b * n + q0) * stride + (size_t)h * d, stride, dq, wr,
                   n - q0, d, g, t);
    if (t == 0) {
        float3* st = stats + ((size_t)b * H + h) * n + q0 + wr + g;
        if (q0 + wr + g < n) st[0] = make_float3(m0, z0, r0);
        if (q0 + wr + g + 8 < n) st[8] = make_float3(m1, z1, r1);
    }
}

template <int DP>
__global__ void __launch_bounds__(MT)
mhsa_bwd_dkv_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                 bf16* __restrict__ dqkv, const float3* __restrict__ stats, int n, int C, int d,
                 int H, float scale, int scores_f32, int vec) {
    constexpr int LD = DP + PAD;
    constexpr int NQ = DP <= 64 ? 64 : 32;  // query rows per tile (bounds the registers)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] this block's keys
    bf16* sV = sK + MQ * LD;                         // [MQ, LD]
    bf16* sQ = sV + MQ * LD;                         // [NQ, LD] qs tile
    bf16* sDO = sQ + NQ * LD;                        // [NQ, LD] dO tile
    float3* sSt = reinterpret_cast<float3*>(sDO + NQ * LD);  // [NQ] row stats
    const int j0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    const size_t stride = 3 * (size_t)C;
    const bf16* base = qkv + (size_t)b * n * stride + (size_t)h * d;
    const bf16* obase = dout + (size_t)b * n * C + (size_t)h * d;
    const float3* st = stats + ((size_t)b * H + h) * n;
    load_tile<DP>(sK, base + C, stride, j0, MQ, n, d, 1.f, false, vec);
    load_tile<DP>(sV, base + 2 * C, stride, j0, MQ, n, d, 1.f, false, vec);

    float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
    for (int q0 = 0; q0 < n; q0 += NQ) {
        __syncthreads();
        load_tile<DP>(sQ, base, stride, q0, NQ, n, d, scale, true, vec);
        load_tile<DP>(sDO, obase, C, q0, NQ, n, d, 1.f, false, vec);
        for (int i = threadIdx.x; i < NQ; i += MT)
            sSt[i] = q0 + i < n ? st[q0 + i] : make_float3(0.f, 1.f, 0.f);
        __syncthreads();
        // S^T and dP^T: rows are this warp's keys, columns the tile's queries
        float s[NQ / 8][4], dp[NQ / 8][4];
        mma_abt<DP, NQ>(s, sK, wr, sQ, g, t);
        finish_scores<NQ>(s, q0, n, t, scores_f32);
        mma_abt<DP, NQ>(dp, sV, wr, sDO, g, t);
#pragma unroll
        for (int nt = 0; nt < NQ / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float3 r = sSt[nt * 8 + 2 * t + (e & 1)];
                const float p = expf(s[nt][e] - r.x) / r.y;
                s[nt][e] = p;
                dp[nt][e] = p * (dp[nt][e] - r.z);
            }
        mma_pv<DP, NQ>(dv, s, sDO, g, t);  // T(p)^T . dO
        mma_pv<DP, NQ>(dk, dp, sQ, g, t);  // T(dS)^T . qs
    }
    bf16* drow = dqkv + ((size_t)b * n + j0) * stride + (size_t)h * d;
    store_rows<DP>(drow + C, stride, dk, wr, n - j0, d, g, t);
    store_rows<DP>(drow + 2 * C, stride, dv, wr, n - j0, d, g, t);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

size_t fwd_smem(int n, int d) { return sizeof(float) * ((size_t)(TQ + TK) * (d + 1) + (size_t)TQ * n + TQ); }
size_t bwd_dq_smem(int n, int d) { return sizeof(float) * ((size_t)(2 * TQ + TK) * (d + 1) + 2 * (size_t)TQ * n); }
size_t bwd_dkv_smem(int d) {
    return sizeof(float) * ((size_t)(2 * TKB + 2 * TQB) * (d + 1) + 2 * TQB * TKB) + sizeof(float3) * TQB;
}

// dynamic shared memory above 48 KB has to be allowed per kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int B, int n, int C, int H) {
    return B < 1 || B > 65535 || n < 1 || n > MAX_N || H < 1 || H > 65535 || C % H != 0 ||
           C / H > MAX_D;
}

constexpr size_t tile_bytes(int rows, int DP) { return sizeof(bf16) * (size_t)rows * (DP + PAD); }

template <int DP>
int fwd_mma(const void* qkv, void* out, int B, int n, int C, int H, float scale, int scores_f32,
            int vec, cudaStream_t stream) {
    const dim3 grid(ceil_div(n, MQ), H, B);
    const size_t smem = tile_bytes(MQ + 2 * MK, DP);
    cudaError_t err = allow_smem(mhsa_fwd_mma<DP>, smem);
    if (err != cudaSuccess) return (int)err;
    mhsa_fwd_mma<DP><<<grid, MT, smem, stream>>>(static_cast<const bf16*>(qkv),
                                                 static_cast<bf16*>(out), n, C, C / H, scale,
                                                 scores_f32, vec);
    return (int)cudaGetLastError();
}

template <int DP>
int bwd_mma(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int n, int C,
            int H, float scale, int scores_f32, int vec, cudaStream_t stream) {
    const bf16* x = static_cast<const bf16*>(qkv);
    const bf16* g = static_cast<const bf16*>(dout);
    bf16* dx = static_cast<bf16*>(dqkv);
    float3* st = static_cast<float3*>(stats);
    const dim3 grid(ceil_div(n, MQ), H, B);

    const size_t smem_a = tile_bytes(2 * MQ + 2 * MK, DP);
    cudaError_t err = allow_smem(mhsa_bwd_dq_mma<DP>, smem_a);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dq_mma<DP><<<grid, MT, smem_a, stream>>>(x, g, dx, st, n, C, C / H, H, scale,
                                                      scores_f32, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    constexpr int NQ = DP <= 64 ? 64 : 32;
    const size_t smem_b = tile_bytes(2 * MQ + 2 * NQ, DP) + sizeof(float3) * NQ;
    err = allow_smem(mhsa_bwd_dkv_mma<DP>, smem_b);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dkv_mma<DP><<<grid, MT, smem_b, stream>>>(x, g, dx, st, n, C, C / H, H, scale,
                                                       scores_f32, vec);
    return (int)cudaGetLastError();
}

// 16-byte loads need d % 8 == 0 and 16-byte aligned bases
inline int can_vec(int d, const void* a, const void* b) {
    return d % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
int fwd(const void* qkv, void* out, int B, int n, int C, int H, float scale, int scores_f32,
        cudaStream_t stream) {
    const int d = C / H;
    const dim3 grid(ceil_div(n, TQ), H, B);
    const size_t smem = fwd_smem(n, d);
    cudaError_t err = allow_smem(mhsa_fwd_kernel<T>, smem);
    if (err != cudaSuccess) return (int)err;
    mhsa_fwd_kernel<T><<<grid, NT, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                                   n, C, d, scale, scores_f32);
    return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int n, int C, int H,
        float scale, int scores_f32, cudaStream_t stream) {
    const int d = C / H;
    const T* x = static_cast<const T*>(qkv);
    const T* g = static_cast<const T*>(dout);
    T* dx = static_cast<T*>(dqkv);
    float3* st = static_cast<float3*>(stats);

    const dim3 grid_a(ceil_div(n, TQ), H, B);
    const size_t smem_a = bwd_dq_smem(n, d);
    cudaError_t err = allow_smem(mhsa_bwd_dq_kernel<T>, smem_a);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dq_kernel<T><<<grid_a, NT, smem_a, stream>>>(x, g, dx, st, n, C, d, H, scale, scores_f32);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const dim3 grid_b(ceil_div(n, TKB), H, B);
    const size_t smem_b = bwd_dkv_smem(d);
    err = allow_smem(mhsa_bwd_dkv_kernel<T>, smem_b);
    if (err != cudaSuccess) return (int)err;
    mhsa_bwd_dkv_kernel<T><<<grid_b, NT, smem_b, stream>>>(x, g, dx, st, n, C, d, H, scale, scores_f32);
    return (int)cudaGetLastError();
}

constexpr int kBadShape = -1;

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t value, or -1 for a shape the kernels
// do not take. `stream` is a cudaStream_t. dtype: 0 = float32, 1 = bfloat16.
int mhsa_qkv_fwd(const void* qkv, void* out, int B, int n, int C, int H, float scale,
                 int scores_f32, int dtype, void* stream) {
    if (bad_shape(B, n, C, H) || (dtype != 0 && dtype != 1)) return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return fwd<float>(qkv, out, B, n, C, H, scale, scores_f32, s);
    const int d = C / H, vec = can_vec(d, qkv, out);
    if (d <= 32) return fwd_mma<32>(qkv, out, B, n, C, H, scale, scores_f32, vec, s);
    if (d <= 64) return fwd_mma<64>(qkv, out, B, n, C, H, scale, scores_f32, vec, s);
    return fwd_mma<128>(qkv, out, B, n, C, H, scale, scores_f32, vec, s);
}

// `stats` is f32 scratch of B * H * n * 3 elements.
int mhsa_qkv_bwd(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int n, int C,
                 int H, float scale, int scores_f32, int dtype, void* stream) {
    if (bad_shape(B, n, C, H) || (dtype != 0 && dtype != 1)) return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return bwd<float>(qkv, dout, dqkv, stats, B, n, C, H, scale, scores_f32, s);
    const int d = C / H, vec = can_vec(d, qkv, dout);
    if (d <= 32) return bwd_mma<32>(qkv, dout, dqkv, stats, B, n, C, H, scale, scores_f32, vec, s);
    if (d <= 64) return bwd_mma<64>(qkv, dout, dqkv, stats, B, n, C, H, scale, scores_f32, vec, s);
    return bwd_mma<128>(qkv, dout, dqkv, stats, B, n, C, H, scale, scores_f32, vec, s);
}

}  // extern "C"
