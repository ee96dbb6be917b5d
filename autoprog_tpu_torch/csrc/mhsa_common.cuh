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
//
// Two families of bodies share these rules. The streaming cells (fwd_cell,
// bwd_dq_cell, bwd_dkv_cell) walk K and V in tiles of 64 keys through shared
// memory with a barrier around every load; the schedule variants of
// mhsa_variants.cu are built from them, and K1 / K5 run them above n = 256 or
// head_dim 64. The resident helpers further down (cp.async tiles, ldmatrix
// fragments, the cheap element-wise steps) are what the K1 / K5 kernels of
// mhsa_qkv.cu run below that.

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
    const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);  // one cvt.rn.bf16x2.f32
    return *reinterpret_cast<const uint32_t*>(&two);
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

// ------------------------------------------------ asynchronous tile loads

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// load_tile by asynchronous 16-byte copies; rows past n and lanes past d are
// zeroed by plain stores. Needs d % 8 == 0 and an aligned slab.
template <int DP>
__device__ void async_tile(bf16* dst, const bf16* __restrict__ src, long long stride, int r0,
                           int rows, int n, int d) {
    constexpr int LD = DP + PAD, CH = DP / 8;
    for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
        const int r = idx / CH, c = (idx - r * CH) * 8;
        bf16* to = dst + r * LD + c;
        if (r0 + r < n && c < d) cp_async16(to, src + (long long)(r0 + r) * stride + c);
        else *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
}

// q -> qs = T(f32(q) * scale) in place, each thread on the 16-byte chunks it
// copied itself in async_tile (same index walk), so it needs no barrier
// between its own cp.async.wait_group and this
template <int DP>
__device__ void scale_own_chunks(bf16* dst, int r0, int rows, int n, int d, float scale) {
    constexpr int LD = DP + PAD, CH = DP / 8;
    for (int idx = threadIdx.x; idx < rows * CH; idx += blockDim.x) {
        const int r = idx / CH, c = (idx - r * CH) * 8;
        if (r0 + r < n && c < d) {
            uint4 v = *reinterpret_cast<uint4*>(dst + r * LD + c);
            bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
            for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16(__bfloat162float(e[k]) * scale);
            *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
        }
    }
}

// One tile on its way to shared memory: asynchronously when the slab takes
// 16-byte copies (q is then scaled later by scale_own_chunks), else by the
// element loads of load_tile, which are complete when this returns.
template <int DP>
__device__ __forceinline__ void fetch_tile(bf16* dst, const bf16* __restrict__ src,
                                           long long stride, int r0, int rows, int n, int d,
                                           float scale, bool as_qs, int vec) {
    if (vec) async_tile<DP>(dst, src, stride, r0, rows, n, d);
    else load_tile<DP>(dst, src, stride, r0, rows, n, d, scale, as_qs, false);
}

// ------------------------------------------------------ ldmatrix fragments
//
// ldmatrix.x4 reads four 8 x 8 bf16 matrices; lane l gives the address of row
// l % 8 of matrix l / 8, and gets of each matrix the pair at (row l / 4,
// columns 2 (l % 4)..), or with .trans at (rows 2 (l % 4).., column l / 4):
// exactly the A and B fragments of m16n8k16, in one load where the
// element loads above take four to eight. Rows of a tile are LD * 2 bytes
// apart (80 or 144: a multiple of 16, and eight of them fall in distinct
// banks).

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

// The A fragments of rows r0 .. r0 + 16 of a tile, one per k-step
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[DP / 16][4], const bf16* sA, int r0,
                                       int lane) {
    constexpr int LD = DP + PAD;
    const bf16* pa = sA + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) ldsm_x4(a[ks], pa + ks * 16);
}

// mma_abt with ldmatrix: acc[16 x NN] = A . sB[0 .. NN)^T, A as load_a gave
// it. One x4 gives the B fragments of two n-tiles; it is sent one step
// before the two mma that use it (the asm statements keep their order, so
// the load is ahead of its use only if the source puts it there). The
// k-steps of an accumulator come in mma_abt's order.
template <int DP, int NN>
__device__ __forceinline__ void mma_abt_frag(float (&acc)[NN / 8][4],
                                             const uint32_t (&a)[DP / 16][4], const bf16* sB,
                                             int lane) {
    constexpr int LD = DP + PAD, STEPS = (DP / 16) * (NN / 16);
    zero_acc(acc);
    const bf16* pb = sB + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
    uint32_t b[2][4];
    ldsm_x4(b[0], pb);
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {  // i = ks * (NN / 16) + np
        const int ks = i / (NN / 16), np = i % (NN / 16);
        if (i + 1 < STEPS) {
            const int ks1 = (i + 1) / (NN / 16), np1 = (i + 1) % (NN / 16);
            ldsm_x4(b[(i + 1) & 1], pb + np1 * 16 * LD + ks1 * 16);
        }
        mma_bf16(acc[2 * np], a[ks], b[i & 1][0], b[i & 1][1]);
        mma_bf16(acc[2 * np + 1], a[ks], b[i & 1][2], b[i & 1][3]);
    }
}

// mma_pv with ldmatrix.trans and A already packed: acc[16 x DP] += p .
// s[0 .. NN)[0 .. DP), p[kk] the A fragment of k-step kk; B one step ahead
template <int DP, int NN>
__device__ __forceinline__ void mma_pv_ld(float (&acc)[DP / 8][4],
                                          const uint32_t (&p)[NN / 16][4], const bf16* s,
                                          int lane) {
    constexpr int LD = DP + PAD, STEPS = (NN / 16) * (DP / 16);
    const bf16* pb = s + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
    uint32_t b[2][4];
    ldsm_x4_t(b[0], pb);
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {  // i = kk * (DP / 16) + dd
        const int kk = i / (DP / 16), dd = i % (DP / 16);
        if (i + 1 < STEPS) {
            const int kk1 = (i + 1) / (DP / 16), dd1 = (i + 1) % (DP / 16);
            ldsm_x4_t(b[(i + 1) & 1], pb + kk1 * 16 * LD + dd1 * 16);
        }
        mma_bf16(acc[2 * dd], p[kk], b[i & 1][0], b[i & 1][1]);
        mma_bf16(acc[2 * dd + 1], p[kk], b[i & 1][2], b[i & 1][3]);
    }
}

// the A fragments of a whole 16 x NN accumulator, rounded to bf16
template <int NN>
__device__ __forceinline__ void pack_acc(uint32_t (&p)[NN / 16][4], const float (&c)[NN / 8][4]) {
#pragma unroll
    for (int kk = 0; kk < NN / 16; ++kk) acc_to_a(p[kk], c[2 * kk], c[2 * kk + 1]);
}

// the two bf16 halves of a packed pair, as f32 (exact)
__device__ __forceinline__ float unpack_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float unpack_hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// store_rows with the two neighbouring lanes of a thread as one 32-bit store
// (`pk`: the destination is 4-byte aligned, its strides and d are even)
template <int DP>
__device__ __forceinline__ void store_rows_pk(bf16* __restrict__ dst, long long row_stride,
                                              const float (&acc)[DP / 8][4], int r0, int n, int d,
                                              int g, int t, int pk) {
    if (!pk) {
        store_rows<DP>(dst, row_stride, acc, r0, n, d, g, t);
        return;
    }
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + g + hh * 8, c = dt * 8 + 2 * t;
            if (r < n && c < d)
                *reinterpret_cast<uint32_t*>(dst + (long long)r * row_stride + c) =
                    pack2f(acc[dt][2 * hh], acc[dt][2 * hh + 1]);
        }
}

// ------------------------------------- element-wise work on a score fragment
//
// The resident path is bound by the operations it spends per score, so
// these spend few: two scores are rounded by one cvt, the mask is tested once
// per fragment, exp is one fma and one
// ex2.approx (exp(s - m) = 2^(s log2(e) - m log2(e)); the row maximum itself
// stays exact), and a division by z is a multiplication by 1 / z taken once
// per row. Against expf and a division per score that moves a result by a few
// f32 ulp before the roundings to T that the function prescribes.

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// -inf in the columns past n of a fragment whose first column is c0; one
// test for the whole fragment where it ends before n
template <int NN>
__device__ __forceinline__ void mask_scores(float (&s)[NN / 8][4], int c0, int n, int t) {
    if (c0 + NN <= n) return;
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (c0 + nt * 8 + 2 * t + (e & 1) >= n) s[nt][e] = -INFINITY;
}

// round a fragment to bf16 in place, two scores a cvt
template <int NN> __device__ __forceinline__ void round_scores(float (&s)[NN / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt) {
        const uint32_t lo = pack2f(s[nt][0], s[nt][1]), hi = pack2f(s[nt][2], s[nt][3]);
        s[nt][0] = unpack_lo(lo), s[nt][1] = unpack_hi(lo);
        s[nt][2] = unpack_lo(hi), s[nt][3] = unpack_hi(hi);
    }
}

// s <- exp(s - rowmax) with ml = rowmax * log2(e); the row sums into z0 / z1
template <int NN>
__device__ __forceinline__ void tile_exp2(float (&s)[NN / 8][4], float ml0, float ml1, float& z0,
                                          float& z1) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float ex = fast_exp2(fmaf(s[nt][e], LOG2E, e < 2 ? -ml0 : -ml1));
            if (e < 2) z0 += ex; else z1 += ex;
            s[nt][e] = ex;
        }
}

// the same, and T(e) packed as the A fragments of T(e) . V in the same walk
template <int NN>
__device__ __forceinline__ void tile_exp2_pack(uint32_t (&p)[NN / 16][4], float (&s)[NN / 8][4],
                                               float ml0, float ml1, float& z0, float& z1) {
#pragma unroll
    for (int kk = 0; kk < NN / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float ex =
                    fast_exp2(fmaf(s[2 * kk + j][e], LOG2E, e < 2 ? -ml0 : -ml1));
                if (e < 2) z0 += ex; else z1 += ex;
                s[2 * kk + j][e] = ex;
            }
        acc_to_a(p[kk], s[2 * kk], s[2 * kk + 1]);
    }
}

// ------------------------------------------------- one (tile, head, image)
//
// No pass keeps a score row, so the scores are recomputed, bit for bit, in
// each pass that needs them:
//   forward  1: rowmax(S)          2: e, z and T(e) . V; (max, z) to `fst`
//                                     when the caller wants them
//   dQ pass  1: rowmax(S), or read from the forward's `fst`
//            2: z and rowsum(dP * e) / z
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
                         int scores_f32, int vec, float2* fst = nullptr) {
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
    if (fst != nullptr && t == 0) {  // (max, z) of this (image, head), for the backward
        if (q0 + wr + g < n) fst[q0 + wr + g] = make_float2(m0, z0);
        if (q0 + wr + g + 8 < n) fst[q0 + wr + g + 8] = make_float2(m1, z1);
    }
}

// dQ and the row statistics. Shared tiles: sQ and sDO [16 W, LD], sK and sV
// [MK, LD]. `st` points at the statistics of this (image, head).
template <int DP>
__device__ void bwd_dq_cell(bf16* sQ, bf16* sDO, bf16* sK, bf16* sV, const bf16* qb,
                            long long q_row, const bf16* kb, long long k_row, const bf16* vb,
                            long long v_row, const bf16* gb, long long g_row, bf16* dqb,
                            long long dq_row, float3* st, int q0, int n, int d, float scale,
                            int scores_f32, int vec, const float2* fst = nullptr) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    const int mq = (blockDim.x >> 5) * 16;
    __syncthreads();
    load_tile<DP>(sQ, qb, q_row, q0, mq, n, d, scale, true, vec);
    load_tile<DP>(sDO, gb, g_row, q0, mq, n, d, 1.f, false, vec);

    float m0 = -INFINITY, m1 = -INFINITY;
    if (fst != nullptr) {  // the forward saved the maxima: no pass for them
        m0 = q0 + wr + g < n ? fst[q0 + wr + g].x : 0.f;
        m1 = q0 + wr + g + 8 < n ? fst[q0 + wr + g + 8].x : 0.f;
    } else {
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
    }

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
