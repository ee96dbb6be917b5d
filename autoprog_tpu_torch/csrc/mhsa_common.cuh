// Device code shared by the MHSA kernels: mhsa_qkv.cu (K1 on the raw qkv
// projection, K5 on separate q, k, v) and mhsa_variants.cu (the schedule
// variants of K1's forward and the G-images-per-block variants).
//
// Every kernel computes, per (image, head), with T the working type:
//   qs = T(f32(q) * scale)
//   S  = qs . k^T accumulated in f32, rounded to the score type
//        (T, or f32 when scores_f32)
//   e  = exp(S - rowmax) in f32, z = rowsum(e)
//   O  = (T(e) . v) / z, the unnormalised e rounded to T before the product
// backward, with p = softmax(f32(S)) recomputed:
//   dV = T(p)^T . dO, dP = dO . v^T, dS = T(p * (dP - rowsum(dP * p)))
//   dQ = (dS . k) * scale, dK = dS^T . qs
//
// Where the operands live is a `Slab` per tensor: a base pointer and the
// strides, in elements, between images, rows (tokens) and heads; the lanes of
// a head are contiguous. The raw qkv projection [B, n, 3C] is three slabs on
// one base (offsets 0, C, 2C; row stride 3C); separate q, k, v of shape
// [B, n, heads, d], or views into any other buffer, are three bases with
// their own strides. No kernel copies or relayouts an operand.
//
// The bf16 bodies run every product on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate). Each warp owns 16 rows of a
// product; a block of W warps covers 16 W rows. A score tile is an mma
// accumulator, and its f32 fragment is rounded to bf16 and re-used as the A
// operand of the next product (the accumulator and A layouts of m16n8k16 line
// up). Head dims are zero-padded to DP = 32, 64 or 128 in shared memory; rows
// and keys past n are masked.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;  // largest head_dim the router sends
constexpr int MAX_N = 1024; // longest sequence the router sends

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as astype does
}

// round an f32 value to T and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f<T>(from_f<T>(x));
}

// One operand: element (b, row, h, lane) is p[b * img + row * row_stride + h * head + lane].
template <typename T>
struct Slab {
    T* p;
    long long img, row, head;
    __host__ __device__ T* at(int b, int h) const { return p + b * img + h * head; }
};

template <typename T>
Slab<T> slab(const void* p, long long img, long long row, long long head) {
    return Slab<T>{static_cast<T*>(const_cast<void*>(p)), img, row, head};
}

// the three slabs of a raw qkv projection [B, n, 3C] (also of its gradient)
template <typename T>
void qkv_slabs(const void* qkv, int n, int C, int d, Slab<T>& q, Slab<T>& k, Slab<T>& v) {
    T* x = static_cast<T*>(const_cast<void*>(qkv));
    const long long row = 3LL * C;
    q = Slab<T>{x, n * row, row, d};
    k = Slab<T>{x + C, n * row, row, d};
    v = Slab<T>{x + 2 * C, n * row, row, d};
}

// 16-byte loads of a bf16 slab need a 16-byte aligned base and strides
template <typename T> bool slab_vec_ok(const Slab<T>& s) {
    return reinterpret_cast<uintptr_t>(s.p) % 16 == 0 && s.img % 8 == 0 && s.row % 8 == 0 &&
           s.head % 8 == 0;
}

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// dynamic shared memory above 48 KB has to be allowed per kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

constexpr size_t SMEM_LIMIT = 232448;  // what one block may ask for on sm_90
constexpr int kBadShape = -1;

inline bool bad_shape(int B, int n, int H, int d) {
    return B < 1 || B > 65535 || n < 1 || n > MAX_N || H < 1 || H > 65535 || d < 1 || d > MAX_D;
}

// ---------------------------------------------------------- mma.sync helpers

constexpr int MW = 4;        // warps per block of the K1 / K5 kernels
constexpr int MT = 32 * MW;  // their threads per block
constexpr int MQ = 16 * MW;  // their product rows per block, 16 per warp
constexpr int MK = 64;       // key rows per shared-memory tile (forward, dQ)
constexpr int PAD = 8;       // bf16 elements of padding per shared row (16 bytes)

constexpr size_t tile_bytes(int rows, int DP) { return sizeof(bf16) * (size_t)rows * (DP + PAD); }

// query rows per tile of the dK/dV pass (bounds the registers)
template <int DP> constexpr int NQ_ROWS = DP <= 64 ? 64 : 32;

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

template <int N> __device__ __forceinline__ void zero_acc(float (&acc)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// acc[16 x NN] = sA[r0 .. r0 + 16) . sB[0 .. NN)^T over the DP lanes
template <int DP, int NN>
__device__ __forceinline__ void mma_abt(float (&acc)[NN / 8][4], const bf16* sA, int r0,
                                        const bf16* sB, int g, int t) {
    constexpr int LD = DP + PAD;
    zero_acc(acc);
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

// fold a score tile into the running row maxima (rows g and g + 8)
template <int NN>
__device__ __forceinline__ void tile_max(const float (&s)[NN / 8][4], float& m0, float& m1) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt) {
        m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
        m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
}

// s <- exp(s - rowmax), the row sums folded into z0 / z1
template <int NN>
__device__ __forceinline__ void tile_exp(float (&s)[NN / 8][4], float m0, float m1, float& z0,
                                         float& z1) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float ex = expf(s[nt][e] - (e < 2 ? m0 : m1));
            if (e < 2) z0 += ex; else z1 += ex;
            s[nt][e] = ex;
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
// == 0 and a 16-byte aligned slab).
template <int DP>
__device__ void load_tile(bf16* dst, const bf16* __restrict__ src, long long stride, int r0,
                          int rows, int n, int d, float scale, bool as_qs, bool vec) {
    constexpr int LD = DP + PAD;
    const int nt = blockDim.x;
    if (vec) {
        constexpr int CH = DP / 8;
        for (int idx = threadIdx.x; idx < rows * CH; idx += nt) {
            const int r = idx / CH, c = (idx - r * CH) * 8;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (r0 + r < n && c < d) {
                v = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c);
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
        for (int idx = threadIdx.x; idx < rows * DP; idx += nt) {
            const int r = idx / DP, c = idx - r * DP;
            bf16 v = __float2bfloat16(0.f);
            if (r0 + r < n && c < d) {
                v = src[(long long)(r0 + r) * stride + c];
                if (as_qs) v = __float2bfloat16(__bfloat162float(v) * scale);
            }
            dst[r * LD + c] = v;
        }
    }
}

// Store a warp's 16 x DP accumulator to rows r0.. of a bf16 matrix with row
// stride `row_stride`; rows past n and lanes past d are skipped.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long long row_stride,
                                           const float (&acc)[DP / 8][4], int r0, int n, int d,
                                           int g, int t) {
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int r = r0 + g + (e >> 1) * 8, c = dt * 8 + 2 * t + (e & 1);
            if (r < n && c < d) dst[(long long)r * row_stride + c] = __float2bfloat16(acc[dt][e]);
        }
}

template <int N> __device__ __forceinline__ void scale_acc(float (&acc)[N][4], float a) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= a;
}

// ------------------------------------------------- one (tile, head, image)
//
// No pass keeps a score row, so the scores are recomputed, bit for bit, in
// each pass that needs them:
//   forward  1: rowmax(S)          2: e, z and T(e) . V
//   dQ pass  1: rowmax(S)          2: z and rowsum(dP * e) / z
//            3: dS and dS . K, then (max, z, rowsum) to `stats`
//   dK/dV    per key tile, loop over query tiles: p and dS from `stats`,
//            T(p)^T . dO and dS^T . qs accumulated in registers.
// The three bodies below are one cell each: the kernels of mhsa_qkv.cu call
// them once per block, the G-images-per-block kernels of mhsa_variants.cu once
// per image of the block. Shared tiles: sQ [16 W, LD], sK and sV [MK, LD].

template <int DP>
__device__ void fwd_cell(bf16* sQ, bf16* sK, bf16* sV, const bf16* qb, long long q_row,
                         const bf16* kb, long long k_row, const bf16* vb, long long v_row,
                         bf16* ob, long long o_row, int q0, int n, int d, float scale,
                         int scores_f32, int vec) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile
    const int mq = (blockDim.x >> 5) * 16;
    __syncthreads();  // a previous cell is done with the tiles
    load_tile<DP>(sQ, qb, q_row, q0, mq, n, d, scale, true, vec);

    float m0 = -INFINITY, m1 = -INFINITY;  // rows g and g + 8
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, kb, k_row, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
        tile_max<MK>(s, m0, m1);
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    float o[DP / 8][4];
    zero_acc(o);
    float z0 = 0.f, z1 = 0.f;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, kb, k_row, k0, MK, n, d, 1.f, false, vec);
        load_tile<DP>(sV, vb, v_row, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
        tile_exp<MK>(s, m0, m1, z0, z1);
        mma_pv<DP, MK>(o, s, sV, g, t);  // T(e) . V
    }
    z0 = quad_sum(z0);
    z1 = quad_sum(z1);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] /= e < 2 ? z0 : z1;
    store_rows<DP>(ob + (long long)q0 * o_row, o_row, o, wr, n - q0, d, g, t);
}

// dQ and the row statistics. Shared tiles: sQ and sDO [16 W, LD], sK and sV
// [MK, LD]. `st` points at the statistics of this (image, head).
template <int DP>
__device__ void bwd_dq_cell(bf16* sQ, bf16* sDO, bf16* sK, bf16* sV, const bf16* qb,
                            long long q_row, const bf16* kb, long long k_row, const bf16* vb,
                            long long v_row, const bf16* gb, long long g_row, bf16* dqb,
                            long long dq_row, float3* st, int q0, int n, int d, float scale,
                            int scores_f32, int vec) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    const int mq = (blockDim.x >> 5) * 16;
    __syncthreads();
    load_tile<DP>(sQ, qb, q_row, q0, mq, n, d, scale, true, vec);
    load_tile<DP>(sDO, gb, g_row, q0, mq, n, d, 1.f, false, vec);

    float m0 = -INFINITY, m1 = -INFINITY;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, kb, k_row, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
        tile_max<MK>(s, m0, m1);
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    // z = rowsum(e) and rowsum(dP * p) = rowsum(dP * e) / z
    float z0 = 0.f, z1 = 0.f, r0 = 0.f, r1 = 0.f;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, kb, k_row, k0, MK, n, d, 1.f, false, vec);
        load_tile<DP>(sV, vb, v_row, k0, MK, n, d, 1.f, false, vec);
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
    zero_acc(dq);
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sK, kb, k_row, k0, MK, n, d, 1.f, false, vec);
        load_tile<DP>(sV, vb, v_row, k0, MK, n, d, 1.f, false, vec);
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
    scale_acc(dq, scale);
    store_rows<DP>(dqb + (long long)q0 * dq_row, dq_row, dq, wr, n - q0, d, g, t);
    if (t == 0) {
        float3* row = st + q0 + wr + g;
        if (q0 + wr + g < n) row[0] = make_float3(m0, z0, r0);
        if (q0 + wr + g + 8 < n) row[8] = make_float3(m1, z1, r1);
    }
}

// dK and dV of the block's 16 W keys. Shared tiles: sK and sV [16 W, LD], sQ
// and sDO [NQ, LD], sSt [NQ].
template <int DP>
__device__ void bwd_dkv_cell(bf16* sK, bf16* sV, bf16* sQ, bf16* sDO, float3* sSt,
                             const bf16* qb, long long q_row, const bf16* kb, long long k_row,
                             const bf16* vb, long long v_row, const bf16* gb, long long g_row,
                             bf16* dkb, long long dk_row, bf16* dvb, long long dv_row,
                             const float3* st, int j0, int n, int d, float scale,
                             int scores_f32, int vec) {
    constexpr int NQ = NQ_ROWS<DP>;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    const int mq = (blockDim.x >> 5) * 16;
    __syncthreads();
    load_tile<DP>(sK, kb, k_row, j0, mq, n, d, 1.f, false, vec);
    load_tile<DP>(sV, vb, v_row, j0, mq, n, d, 1.f, false, vec);

    float dk[DP / 8][4], dv[DP / 8][4];
    zero_acc(dk);
    zero_acc(dv);
    for (int q0 = 0; q0 < n; q0 += NQ) {
        __syncthreads();
        load_tile<DP>(sQ, qb, q_row, q0, NQ, n, d, scale, true, vec);
        load_tile<DP>(sDO, gb, g_row, q0, NQ, n, d, 1.f, false, vec);
        for (int i = threadIdx.x; i < NQ; i += blockDim.x)
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
    store_rows<DP>(dkb + (long long)j0 * dk_row, dk_row, dk, wr, n - j0, d, g, t);
    store_rows<DP>(dvb + (long long)j0 * dv_row, dv_row, dv, wr, n - j0, d, g, t);
}

// shared memory of the three bodies for W warps
template <int DP> constexpr size_t fwd_cell_smem(int W) { return tile_bytes(16 * W + 2 * MK, DP); }
template <int DP> constexpr size_t dq_cell_smem(int W) { return tile_bytes(32 * W + 2 * MK, DP); }
template <int DP> constexpr size_t dkv_cell_smem(int W) {
    return tile_bytes(32 * W + 2 * NQ_ROWS<DP>, DP) + sizeof(float3) * NQ_ROWS<DP>;
}

}  // namespace
