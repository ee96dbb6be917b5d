// Schedule variants of the fused MHSA on the raw qkv projection (bf16).
//
// Replaces, for Hopper (sm_90a), the experimental Pallas kernels that the
// measurement scripts of the JAX package time against mhsa_fused_qkv:
//   scripts/attn_variants.py  _fwd_kernel_twophase, _fwd_kernel_pipelined
//                             (mhsa_fwd_variant)            -> mhsa_variant_fwd
//   scripts/bench_attn_x.py   _fwd_phase_kernel, _fwd_loop_kernel,
//                             _bwd_phase_kernel (make_variant)
//                                          -> mhsa_group_fwd, mhsa_group_bwd
// None of them changes the arithmetic of K1 (mhsa_qkv.cu, rounding points in
// mhsa_common.cuh); each is another answer to a question of schedule, and
// each result equals K1's bit for bit at the same score type.
//
// What bounds K1 at the VOLO shape is the n x n score matrix and its row
// softmax, not HBM (see mhsa_qkv.cu), and K1 pays for keeping no score row by
// recomputing the scores in every pass. The variants put the card's own
// answer beside that:
//
//   twophase, twophase_bf16s   park or recompute? The block computes its
//       whole score rows [64, n] once, parks them in shared memory (f32, or
//       the working type), and the softmax and T(e) . V read them back. Each
//       thread reads exactly the fragment elements it wrote, so parking needs
//       no barrier of its own. Rows that do not fit the block's shared memory
//       are refused (-1): n = 1024 at f32.
//   pipelined                  K1's two loops, with the next K (and V) tile
//       fetched by cp.async into a second buffer while the tensor cores work
//       on the current one. 16-byte copies: head_dim % 8 != 0 is refused.
//   G images per block, order `loop`    grid z is B / G and the block walks
//       its G images for its (tile, head), K1's body once per image: fewer,
//       longer blocks.
//   G images per block, order `phase`   the QK^T of all G cells into shared
//       memory, then all softmaxes, then all T(e) . V; the backward in the
//       same manner (scores, e, dP and its row sums, dS and dQ; and per key
//       tile scores, p, dV with dP and dS, dK). The parked rows of G cells
//       have to fit one block, so these kernels take 32 rows (2 warps) per
//       block where K1 takes 64, and refuse (-1) a G that still does not fit.
//
// The backward stays two passes in every order. The TPU program held a whole
// image, all queries and all keys, so dQ (a sum over keys) and dK, dV (sums
// over queries) were complete inside one program. Here a block holds one tile
// of rows and the blocks run in any order on 132 SMs: dK and dV of a key tile
// sum over every query tile, which other blocks own. So pass A (per query
// tile) writes dQ and the row statistics, and pass B (per key tile) rebuilds
// p and dS from them and sums over the query tiles itself. The G loop sits
// inside each pass.

#include "mhsa_common.cuh"

namespace {

// ------------------------------------------------------------ parked tiles
//
// A warp parks its 16 x NN fragment at columns c0.. of its 16 rows (`rows`
// points at the first, leading dimension ld, even; c0 a multiple of 8).

template <int NN>
__device__ __forceinline__ void park_store(float* rows, int ld, int c0,
                                           const float (&s)[NN / 8][4], int g, int t) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt) {
        float* p = rows + g * ld + c0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(s[nt][0], s[nt][1]);
        *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(s[nt][2], s[nt][3]);
    }
}

template <int NN>
__device__ __forceinline__ void park_load(const float* rows, int ld, int c0,
                                          float (&s)[NN / 8][4], int g, int t) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt) {
        const float* p = rows + g * ld + c0 + nt * 8 + 2 * t;
        const float2 lo = *reinterpret_cast<const float2*>(p);
        const float2 hi = *reinterpret_cast<const float2*>(p + 8 * ld);
        s[nt][0] = lo.x, s[nt][1] = lo.y, s[nt][2] = hi.x, s[nt][3] = hi.y;
    }
}

// parked at bf16: the values were rounded to bf16 already, so this is exact
template <int NN>
__device__ __forceinline__ void park_store(bf16* rows, int ld, int c0,
                                           const float (&s)[NN / 8][4], int g, int t) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt) {
        bf16* p = rows + g * ld + c0 + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(p) = pack2f(s[nt][0], s[nt][1]);
        *reinterpret_cast<uint32_t*>(p + 8 * ld) = pack2f(s[nt][2], s[nt][3]);
    }
}

template <int NN>
__device__ __forceinline__ void park_load(const bf16* rows, int ld, int c0,
                                          float (&s)[NN / 8][4], int g, int t) {
#pragma unroll
    for (int nt = 0; nt < NN / 8; ++nt) {
        const bf16* p = rows + g * ld + c0 + nt * 8 + 2 * t;
        s[nt][0] = __bfloat162float(p[0]), s[nt][1] = __bfloat162float(p[1]);
        s[nt][2] = __bfloat162float(p[8 * ld]), s[nt][3] = __bfloat162float(p[8 * ld + 1]);
    }
}

// leading dimension of parked rows over n columns cut in tiles of `tile`
inline int park_ld(int n, int tile) { return ceil_div(n, tile) * tile + 8; }

// --------------------------------------------- twophase, twophase_bf16s

template <int DP, typename S>
__global__ void __launch_bounds__(MT)
fwd_twophase(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out, int n,
             int d, float scale, int ldS, int vec) {
    constexpr int LD = DP + PAD;
    constexpr int scores_f32 = sizeof(S) == sizeof(float);
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] qs
    bf16* sKV = sQ + MQ * LD;                        // [MK, LD] K tile, then V tile
    S* sS = reinterpret_cast<S*>(sKV + MK * LD);     // [MQ, ldS] parked scores
    const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    const bf16* kb = k.at(b, h);
    const bf16* vb = v.at(b, h);
    S* mine = sS + wr * ldS;
    load_tile<DP>(sQ, q.at(b, h), q.row, q0, MQ, n, d, scale, true, vec);

    // phase 1: every score of the block's rows, once
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sKV, kb, k.row, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sKV, g, t);
        finish_scores<MK>(s, k0, n, t, scores_f32);
        park_store<MK>(mine, ldS, k0, s, g, t);
        tile_max<MK>(s, m0, m1);
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    // phase 2: softmax numerators and T(e) . V from the parked rows
    float o[DP / 8][4];
    zero_acc(o);
    float z0 = 0.f, z1 = 0.f;
    for (int k0 = 0; k0 < n; k0 += MK) {
        __syncthreads();
        load_tile<DP>(sKV, vb, v.row, k0, MK, n, d, 1.f, false, vec);
        __syncthreads();
        float s[MK / 8][4];
        park_load<MK>(mine, ldS, k0, s, g, t);
        tile_exp<MK>(s, m0, m1, z0, z1);
        mma_pv<DP, MK>(o, s, sKV, g, t);
    }
    z0 = quad_sum(z0);
    z1 = quad_sum(z1);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] /= e < 2 ? z0 : z1;
    bf16* ob = out.at(b, h);
    store_rows<DP>(ob + (long long)q0 * out.row, out.row, o, wr, n - q0, d, g, t);
}

// ------------------------------------------------------------- pipelined

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

template <int DP>
__global__ void __launch_bounds__(MT)
fwd_pipelined(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out, int n,
              int d, float scale) {
    constexpr int LD = DP + PAD, TILE = MK * LD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [MQ, LD] qs
    bf16* sK = sQ + MQ * LD;                         // [2][MK, LD]
    bf16* sV = sK + 2 * TILE;                        // [2][MK, LD]
    const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    const bf16* kb = k.at(b, h);
    const bf16* vb = v.at(b, h);
    // step i < nk: K tile i for the row maxima; step nk + i: K and V tile i
    const int nk = ceil_div(n, MK), steps = 2 * nk;

    load_tile<DP>(sQ, q.at(b, h), q.row, q0, MQ, n, d, scale, true, true);
    async_tile<DP>(sK, kb, k.row, 0, MK, n, d);
    cp_async_commit();

    float m0 = -INFINITY, m1 = -INFINITY, z0 = 0.f, z1 = 0.f;
    float o[DP / 8][4];
    zero_acc(o);
    for (int step = 0; step < steps; ++step) {
        const int buf = step & 1, k0 = (step < nk ? step : step - nk) * MK;
        if (step + 1 < steps) {
            // the buffer of step - 1 is free since the barrier that ended it
            const int nxt = step + 1, nbuf = nxt & 1, nk0 = (nxt < nk ? nxt : nxt - nk) * MK;
            async_tile<DP>(sK + nbuf * TILE, kb, k.row, nk0, MK, n, d);
            if (nxt >= nk) async_tile<DP>(sV + nbuf * TILE, vb, v.row, nk0, MK, n, d);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        float s[MK / 8][4];
        mma_abt<DP, MK>(s, sQ, wr, sK + buf * TILE, g, t);
        finish_scores<MK>(s, k0, n, t, 1);
        if (step < nk) {
            tile_max<MK>(s, m0, m1);
            if (step == nk - 1) {
                m0 = quad_max(m0);
                m1 = quad_max(m1);
            }
        } else {
            tile_exp<MK>(s, m0, m1, z0, z1);
            mma_pv<DP, MK>(o, s, sV + buf * TILE, g, t);
        }
        __syncthreads();
    }
    z0 = quad_sum(z0);
    z1 = quad_sum(z1);
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] /= e < 2 ? z0 : z1;
    bf16* ob = out.at(b, h);
    store_rows<DP>(ob + (long long)q0 * out.row, out.row, o, wr, n - q0, d, g, t);
}

// ---------------------------------------- G images per block, order `loop`

template <int DP>
__global__ void __launch_bounds__(MT)
group_fwd_loop(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out, int n,
               int d, float scale, int G, int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sK = sQ + MQ * LD;
    bf16* sV = sK + MK * LD;
    const int h = blockIdx.y;
    for (int gi = 0; gi < G; ++gi) {
        const int b = blockIdx.z * G + gi;
        fwd_cell<DP>(sQ, sK, sV, q.at(b, h), q.row, k.at(b, h), k.row, v.at(b, h), v.row,
                     out.at(b, h), out.row, blockIdx.x * MQ, n, d, scale, 1, vec);
    }
}

template <int DP>
__global__ void __launch_bounds__(MT)
group_bwd_dq_loop(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v,
                  Slab<const bf16> dout, Slab<bf16> dq, float3* __restrict__ stats, int n, int d,
                  int H, float scale, int G, int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sDO = sQ + MQ * LD;
    bf16* sK = sDO + MQ * LD;
    bf16* sV = sK + MK * LD;
    const int h = blockIdx.y;
    for (int gi = 0; gi < G; ++gi) {
        const int b = blockIdx.z * G + gi;
        bwd_dq_cell<DP>(sQ, sDO, sK, sV, q.at(b, h), q.row, k.at(b, h), k.row, v.at(b, h), v.row,
                        dout.at(b, h), dout.row, dq.at(b, h), dq.row,
                        stats + ((size_t)b * H + h) * n, blockIdx.x * MQ, n, d, scale, 1, vec);
    }
}

template <int DP>
__global__ void __launch_bounds__(MT)
group_bwd_dkv_loop(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v,
                   Slab<const bf16> dout, Slab<bf16> dk, Slab<bf16> dv,
                   const float3* __restrict__ stats, int n, int d, int H, float scale, int G,
                   int vec) {
    constexpr int LD = DP + PAD;
    constexpr int NQ = NQ_ROWS<DP>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sK = reinterpret_cast<bf16*>(smem_raw);
    bf16* sV = sK + MQ * LD;
    bf16* sQ = sV + MQ * LD;
    bf16* sDO = sQ + NQ * LD;
    float3* sSt = reinterpret_cast<float3*>(sDO + NQ * LD);
    const int h = blockIdx.y;
    for (int gi = 0; gi < G; ++gi) {
        const int b = blockIdx.z * G + gi;
        bwd_dkv_cell<DP>(sK, sV, sQ, sDO, sSt, q.at(b, h), q.row, k.at(b, h), k.row, v.at(b, h),
                         v.row, dout.at(b, h), dout.row, dk.at(b, h), dk.row, dv.at(b, h),
                         dv.row, stats + ((size_t)b * H + h) * n, blockIdx.x * MQ, n, d, scale,
                         1, vec);
    }
}

// --------------------------------------- G images per block, order `phase`

constexpr int PW = 2;        // warps per block
constexpr int PT = 32 * PW;  // threads per block
constexpr int PQ = 16 * PW;  // product rows per block

// Phases 1 and 2 of the forward and of backward pass A: the scores of every
// cell parked at f32 with their row maxima, then e = exp(S - max) parked in
// their place with the row sums. `stat` is [G][PQ][NS] floats: max, z, ...
template <int DP, int NS>
__device__ void park_scores_and_exp(bf16* sQ, bf16* sK, float* sS, float* stat,
                                    const Slab<const bf16>& q, const Slab<const bf16>& k, int q0,
                                    int h, int b0, int n, int d, float scale, int G, int ldS,
                                    int vec) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    for (int gi = 0; gi < G; ++gi) {
        const int b = b0 + gi;
        const bf16* kb = k.at(b, h);
        float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        __syncthreads();  // the previous cell is done with sQ
        load_tile<DP>(sQ, q.at(b, h), q.row, q0, PQ, n, d, scale, true, vec);
        float m0 = -INFINITY, m1 = -INFINITY;
        for (int k0 = 0; k0 < n; k0 += MK) {
            __syncthreads();
            load_tile<DP>(sK, kb, k.row, k0, MK, n, d, 1.f, false, vec);
            __syncthreads();
            float s[MK / 8][4];
            mma_abt<DP, MK>(s, sQ, wr, sK, g, t);
            finish_scores<MK>(s, k0, n, t, 1);
            park_store<MK>(mine, ldS, k0, s, g, t);
            tile_max<MK>(s, m0, m1);
        }
        m0 = quad_max(m0);
        m1 = quad_max(m1);
        if (t == 0) {
            stat[(gi * PQ + wr + g) * NS] = m0;
            stat[(gi * PQ + wr + g + 8) * NS] = m1;
        }
    }
    __syncwarp();
    for (int gi = 0; gi < G; ++gi) {
        float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        float* st0 = stat + (gi * PQ + wr + g) * NS;
        float* st1 = st0 + 8 * NS;
        const float m0 = st0[0], m1 = st1[0];
        float z0 = 0.f, z1 = 0.f;
        for (int k0 = 0; k0 < n; k0 += MK) {
            float s[MK / 8][4];
            park_load<MK>(mine, ldS, k0, s, g, t);
            tile_exp<MK>(s, m0, m1, z0, z1);
            park_store<MK>(mine, ldS, k0, s, g, t);
        }
        z0 = quad_sum(z0);
        z1 = quad_sum(z1);
        if (t == 0) {
            st0[1] = z0;
            st1[1] = z1;
        }
    }
    __syncwarp();
}

template <int DP>
__global__ void __launch_bounds__(PT)
group_fwd_phase(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out, int n,
                int d, float scale, int G, int ldS, int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);            // [PQ, LD] qs
    bf16* sKV = sQ + PQ * LD;                                  // [MK, LD] K or V tile
    float* sS = reinterpret_cast<float*>(sKV + MK * LD);       // [G][PQ, ldS] parked
    float* stat = sS + (size_t)G * PQ * ldS;                   // [G][PQ][2] max, z
    const int q0 = blockIdx.x * PQ, h = blockIdx.y, b0 = blockIdx.z * G;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;

    park_scores_and_exp<DP, 2>(sQ, sKV, sS, stat, q, k, q0, h, b0, n, d, scale, G, ldS, vec);

    // phase 3: every T(e) . V
    for (int gi = 0; gi < G; ++gi) {
        const int b = b0 + gi;
        const bf16* vb = v.at(b, h);
        const float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        float o[DP / 8][4];
        zero_acc(o);
        for (int k0 = 0; k0 < n; k0 += MK) {
            __syncthreads();
            load_tile<DP>(sKV, vb, v.row, k0, MK, n, d, 1.f, false, vec);
            __syncthreads();
            float s[MK / 8][4];
            park_load<MK>(mine, ldS, k0, s, g, t);
            mma_pv<DP, MK>(o, s, sKV, g, t);
        }
        const float z0 = stat[(gi * PQ + wr + g) * 2 + 1];
        const float z1 = stat[(gi * PQ + wr + g + 8) * 2 + 1];
#pragma unroll
        for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[dt][e] /= e < 2 ? z0 : z1;
        bf16* ob = out.at(b, h);
        store_rows<DP>(ob + (long long)q0 * out.row, out.row, o, wr, n - q0, d, g, t);
    }
}

template <int DP>
__global__ void __launch_bounds__(PT)
group_bwd_dq_phase(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v,
                   Slab<const bf16> dout, Slab<bf16> dq, float3* __restrict__ stats, int n, int d,
                   int H, float scale, int G, int ldS, int vec) {
    constexpr int LD = DP + PAD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);            // [PQ, LD] qs, then dO
    bf16* sK = sQ + PQ * LD;                                   // [MK, LD]
    bf16* sV = sK + MK * LD;                                   // [MK, LD]
    float* sS = reinterpret_cast<float*>(sV + MK * LD);        // [G][PQ, ldS] parked
    float* stat = sS + (size_t)G * PQ * ldS;                   // [G][PQ][3] max, z, rowsum
    const int q0 = blockIdx.x * PQ, h = blockIdx.y, b0 = blockIdx.z * G;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;

    park_scores_and_exp<DP, 3>(sQ, sK, sS, stat, q, k, q0, h, b0, n, d, scale, G, ldS, vec);

    // phase 3: dP = dO . V^T of every cell, folded into rowsum(dP * e) / z
    for (int gi = 0; gi < G; ++gi) {
        const int b = b0 + gi;
        const bf16* vb = v.at(b, h);
        const float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        float* st0 = stat + (gi * PQ + wr + g) * 3;
        float* st1 = st0 + 8 * 3;
        __syncthreads();
        load_tile<DP>(sQ, dout.at(b, h), dout.row, q0, PQ, n, d, 1.f, false, vec);
        float r0 = 0.f, r1 = 0.f;
        for (int k0 = 0; k0 < n; k0 += MK) {
            __syncthreads();
            load_tile<DP>(sV, vb, v.row, k0, MK, n, d, 1.f, false, vec);
            __syncthreads();
            float e[MK / 8][4], dp[MK / 8][4];
            mma_abt<DP, MK>(dp, sQ, wr, sV, g, t);
            park_load<MK>(mine, ldS, k0, e, g, t);
#pragma unroll
            for (int nt = 0; nt < MK / 8; ++nt)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    if (c < 2) r0 += e[nt][c] * dp[nt][c];
                    else r1 += e[nt][c] * dp[nt][c];
                }
        }
        r0 = quad_sum(r0) / st0[1];
        r1 = quad_sum(r1) / st1[1];
        if (t == 0) {
            st0[2] = r0;
            st1[2] = r1;
        }
    }
    __syncwarp();

    // phase 4: dS = T(p * (dP - rowsum)) and dQ = (dS . K) * scale
    for (int gi = 0; gi < G; ++gi) {
        const int b = b0 + gi;
        const bf16* kb = k.at(b, h);
        const bf16* vb = v.at(b, h);
        const float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        const float* st0 = stat + (gi * PQ + wr + g) * 3;
        const float* st1 = st0 + 8 * 3;
        const float z0 = st0[1], z1 = st1[1], r0 = st0[2], r1 = st1[2];
        __syncthreads();
        load_tile<DP>(sQ, dout.at(b, h), dout.row, q0, PQ, n, d, 1.f, false, vec);
        float acc[DP / 8][4];
        zero_acc(acc);
        for (int k0 = 0; k0 < n; k0 += MK) {
            __syncthreads();
            load_tile<DP>(sK, kb, k.row, k0, MK, n, d, 1.f, false, vec);
            load_tile<DP>(sV, vb, v.row, k0, MK, n, d, 1.f, false, vec);
            __syncthreads();
            float s[MK / 8][4], dp[MK / 8][4];
            mma_abt<DP, MK>(dp, sQ, wr, sV, g, t);
            park_load<MK>(mine, ldS, k0, s, g, t);
#pragma unroll
            for (int nt = 0; nt < MK / 8; ++nt)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const float p = s[nt][c] / (c < 2 ? z0 : z1);
                    s[nt][c] = p * (dp[nt][c] - (c < 2 ? r0 : r1));
                }
            mma_pv<DP, MK>(acc, s, sK, g, t);
        }
        scale_acc(acc, scale);
        bf16* dqb = dq.at(b, h);
        store_rows<DP>(dqb + (long long)q0 * dq.row, dq.row, acc, wr, n - q0, d, g, t);
        if (t == 0) {
            float3* row = stats + ((size_t)b * H + h) * n + q0 + wr + g;
            if (q0 + wr + g < n) row[0] = make_float3(st0[0], z0, r0);
            if (q0 + wr + g + 8 < n) row[8] = make_float3(st1[0], z1, r1);
        }
    }
}

template <int DP>
__global__ void __launch_bounds__(PT)
group_bwd_dkv_phase(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v,
                    Slab<const bf16> dout, Slab<bf16> dk, Slab<bf16> dv,
                    const float3* __restrict__ stats, int n, int d, int H, float scale, int G,
                    int ldS, int vec) {
    constexpr int LD = DP + PAD;
    constexpr int NQ = NQ_ROWS<DP>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* sKV = reinterpret_cast<bf16*>(smem_raw);           // [PQ, LD] the block's K or V rows
    bf16* sT = sKV + PQ * LD;                                  // [NQ, LD] qs or dO tile
    float* sS = reinterpret_cast<float*>(sT + NQ * LD);        // [G][PQ keys, ldS queries]
    const int j0 = blockIdx.x * PQ, h = blockIdx.y, b0 = blockIdx.z * G;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    const float3 none = make_float3(0.f, 1.f, 0.f);

    // phase 1: S^T of every cell: rows are this warp's keys, columns the queries
    for (int gi = 0; gi < G; ++gi) {
        const int b = b0 + gi;
        const bf16* qb = q.at(b, h);
        float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        __syncthreads();
        load_tile<DP>(sKV, k.at(b, h), k.row, j0, PQ, n, d, 1.f, false, vec);
        for (int q0 = 0; q0 < n; q0 += NQ) {
            __syncthreads();
            load_tile<DP>(sT, qb, q.row, q0, NQ, n, d, scale, true, vec);
            __syncthreads();
            float s[NQ / 8][4];
            mma_abt<DP, NQ>(s, sKV, wr, sT, g, t);
            finish_scores<NQ>(s, q0, n, t, 1);
            park_store<NQ>(mine, ldS, q0, s, g, t);
        }
    }
    // phase 2: p of every cell from the statistics of pass A
    for (int gi = 0; gi < G; ++gi) {
        const float3* st = stats + ((size_t)(b0 + gi) * H + h) * n;
        float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        for (int q0 = 0; q0 < n; q0 += NQ) {
            float s[NQ / 8][4];
            park_load<NQ>(mine, ldS, q0, s, g, t);
#pragma unroll
            for (int nt = 0; nt < NQ / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = q0 + nt * 8 + 2 * t + (e & 1);
                    const float3 r = col < n ? st[col] : none;
                    s[nt][e] = expf(s[nt][e] - r.x) / r.y;
                }
            park_store<NQ>(mine, ldS, q0, s, g, t);
        }
    }
    // phase 3: dV = T(p)^T . dO, and dS^T = p * (dP^T - rowsum) parked over p
    for (int gi = 0; gi < G; ++gi) {
        const int b = b0 + gi;
        const bf16* gb = dout.at(b, h);
        const float3* st = stats + ((size_t)b * H + h) * n;
        float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        __syncthreads();
        load_tile<DP>(sKV, v.at(b, h), v.row, j0, PQ, n, d, 1.f, false, vec);
        float acc[DP / 8][4];
        zero_acc(acc);
        for (int q0 = 0; q0 < n; q0 += NQ) {
            __syncthreads();
            load_tile<DP>(sT, gb, dout.row, q0, NQ, n, d, 1.f, false, vec);
            __syncthreads();
            float s[NQ / 8][4], dp[NQ / 8][4];
            park_load<NQ>(mine, ldS, q0, s, g, t);
            mma_pv<DP, NQ>(acc, s, sT, g, t);
            mma_abt<DP, NQ>(dp, sKV, wr, sT, g, t);
#pragma unroll
            for (int nt = 0; nt < NQ / 8; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int col = q0 + nt * 8 + 2 * t + (e & 1);
                    const float rs = col < n ? st[col].z : 0.f;
                    s[nt][e] = s[nt][e] * (dp[nt][e] - rs);
                }
            park_store<NQ>(mine, ldS, q0, s, g, t);
        }
        bf16* dvb = dv.at(b, h);
        store_rows<DP>(dvb + (long long)j0 * dv.row, dv.row, acc, wr, n - j0, d, g, t);
    }
    // phase 4: dK = T(dS)^T . qs
    for (int gi = 0; gi < G; ++gi) {
        const int b = b0 + gi;
        const bf16* qb = q.at(b, h);
        const float* mine = sS + ((size_t)gi * PQ + wr) * ldS;
        float acc[DP / 8][4];
        zero_acc(acc);
        for (int q0 = 0; q0 < n; q0 += NQ) {
            __syncthreads();
            load_tile<DP>(sT, qb, q.row, q0, NQ, n, d, scale, true, vec);
            __syncthreads();
            float s[NQ / 8][4];
            park_load<NQ>(mine, ldS, q0, s, g, t);
            mma_pv<DP, NQ>(acc, s, sT, g, t);
        }
        bf16* dkb = dk.at(b, h);
        store_rows<DP>(dkb + (long long)j0 * dk.row, dk.row, acc, wr, n - j0, d, g, t);
    }
}

// ------------------------------------------------------------------ host

struct Call {
    Slab<const bf16> q, k, v, dout;
    Slab<bf16> out, dq, dk, dv;
    int B, n, H, d, vec;
};

Call make_call(const void* qkv, const void* dout, void* out, void* dqkv, int B, int n, int C,
               int H) {
    Call c{};
    const int d = C / H;
    qkv_slabs<const bf16>(qkv, n, C, d, c.q, c.k, c.v);
    c.dout = slab<const bf16>(dout, (long long)n * C, C, d);
    c.out = slab<bf16>(out, (long long)n * C, C, d);
    qkv_slabs<bf16>(dqkv, n, C, d, c.dq, c.dk, c.dv);
    c.B = B, c.n = n, c.H = H, c.d = d;
    c.vec = d % 8 == 0 && slab_vec_ok(c.q) && slab_vec_ok(c.k) && slab_vec_ok(c.v) &&
            (dout == nullptr || slab_vec_ok(c.dout));
    return c;
}

template <int DP, typename S>
int launch_twophase(const Call& c, float scale, cudaStream_t stream) {
    const int ldS = park_ld(c.n, MK);
    const size_t smem = tile_bytes(MQ + MK, DP) + sizeof(S) * (size_t)MQ * ldS;
    if (smem > SMEM_LIMIT) return kBadShape;
    cudaError_t err = allow_smem(fwd_twophase<DP, S>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(c.n, MQ), c.H, c.B);
    fwd_twophase<DP, S><<<grid, MT, smem, stream>>>(c.q, c.k, c.v, c.out, c.n, c.d, scale, ldS,
                                                    c.vec);
    return (int)cudaGetLastError();
}

template <int DP>
int launch_pipelined(const Call& c, float scale, cudaStream_t stream) {
    if (!c.vec) return kBadShape;
    const size_t smem = tile_bytes(MQ + 4 * MK, DP);
    cudaError_t err = allow_smem(fwd_pipelined<DP>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(c.n, MQ), c.H, c.B);
    fwd_pipelined<DP><<<grid, MT, smem, stream>>>(c.q, c.k, c.v, c.out, c.n, c.d, scale);
    return (int)cudaGetLastError();
}

template <int DP>
int launch_variant(const Call& c, float scale, int variant, cudaStream_t stream) {
    if (variant == 0) return launch_twophase<DP, float>(c, scale, stream);
    if (variant == 1) return launch_twophase<DP, bf16>(c, scale, stream);
    return launch_pipelined<DP>(c, scale, stream);
}

template <int DP>
int launch_group_fwd(const Call& c, float scale, int G, int phase, cudaStream_t stream) {
    if (!phase) {
        const size_t smem = fwd_cell_smem<DP>(MW);
        cudaError_t err = allow_smem(group_fwd_loop<DP>, smem);
        if (err != cudaSuccess) return (int)err;
        const dim3 grid(ceil_div(c.n, MQ), c.H, c.B / G);
        group_fwd_loop<DP><<<grid, MT, smem, stream>>>(c.q, c.k, c.v, c.out, c.n, c.d, scale, G,
                                                       c.vec);
        return (int)cudaGetLastError();
    }
    const int ldS = park_ld(c.n, MK);
    const size_t smem = tile_bytes(PQ + MK, DP) + sizeof(float) * (size_t)G * PQ * (ldS + 2);
    if (smem > SMEM_LIMIT) return kBadShape;
    cudaError_t err = allow_smem(group_fwd_phase<DP>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(c.n, PQ), c.H, c.B / G);
    group_fwd_phase<DP><<<grid, PT, smem, stream>>>(c.q, c.k, c.v, c.out, c.n, c.d, scale, G, ldS,
                                                    c.vec);
    return (int)cudaGetLastError();
}

template <int DP>
int launch_group_bwd(const Call& c, void* stats, float scale, int G, int phase,
                     cudaStream_t stream) {
    float3* st = static_cast<float3*>(stats);
    if (!phase) {
        const dim3 grid(ceil_div(c.n, MQ), c.H, c.B / G);
        const size_t smem_a = dq_cell_smem<DP>(MW), smem_b = dkv_cell_smem<DP>(MW);
        cudaError_t err = allow_smem(group_bwd_dq_loop<DP>, smem_a);
        if (err != cudaSuccess) return (int)err;
        group_bwd_dq_loop<DP><<<grid, MT, smem_a, stream>>>(c.q, c.k, c.v, c.dout, c.dq, st, c.n,
                                                            c.d, c.H, scale, G, c.vec);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        err = allow_smem(group_bwd_dkv_loop<DP>, smem_b);
        if (err != cudaSuccess) return (int)err;
        group_bwd_dkv_loop<DP><<<grid, MT, smem_b, stream>>>(c.q, c.k, c.v, c.dout, c.dk, c.dv,
                                                             st, c.n, c.d, c.H, scale, G, c.vec);
        return (int)cudaGetLastError();
    }
    const dim3 grid(ceil_div(c.n, PQ), c.H, c.B / G);
    const int ld_a = park_ld(c.n, MK), ld_b = park_ld(c.n, NQ_ROWS<DP>);
    const size_t smem_a = tile_bytes(PQ + 2 * MK, DP) +
                          sizeof(float) * (size_t)G * PQ * (ld_a + 3);
    const size_t smem_b = tile_bytes(PQ + NQ_ROWS<DP>, DP) +
                          sizeof(float) * (size_t)G * PQ * ld_b;
    if (smem_a > SMEM_LIMIT || smem_b > SMEM_LIMIT) return kBadShape;
    cudaError_t err = allow_smem(group_bwd_dq_phase<DP>, smem_a);
    if (err != cudaSuccess) return (int)err;
    group_bwd_dq_phase<DP><<<grid, PT, smem_a, stream>>>(c.q, c.k, c.v, c.dout, c.dq, st, c.n,
                                                         c.d, c.H, scale, G, ld_a, c.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(group_bwd_dkv_phase<DP>, smem_b);
    if (err != cudaSuccess) return (int)err;
    group_bwd_dkv_phase<DP><<<grid, PT, smem_b, stream>>>(c.q, c.k, c.v, c.dout, c.dk, c.dv, st,
                                                          c.n, c.d, c.H, scale, G, ld_b, c.vec);
    return (int)cudaGetLastError();
}

bool bad_qkv(int B, int n, int C, int H) {
    return H < 1 || C % H != 0 || bad_shape(B, n, H, C / H);
}

bool bad_group(int B, int G) { return G < 1 || B % G != 0; }

}  // namespace

extern "C" {

// Every entry point takes bf16 tensors, returns 0 on success, a cudaError_t
// value, or -1 for a shape it refuses (also: what does not fit the shared
// memory the schedule asks for). `stream` is a cudaStream_t.

// qkv [B, n, 3C] -> out [B, n, C]. variant: 0 twophase (scores parked at f32),
// 1 twophase_bf16s (parked at bf16), 2 pipelined (f32 scores).
int mhsa_variant_fwd(const void* qkv, void* out, int B, int n, int C, int H, float scale,
                     int variant, void* stream) {
    if (bad_qkv(B, n, C, H) || variant < 0 || variant > 2) return kBadShape;
    const Call c = make_call(qkv, nullptr, out, nullptr, B, n, C, H);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (c.d <= 32) return launch_variant<32>(c, scale, variant, s);
    if (c.d <= 64) return launch_variant<64>(c, scale, variant, s);
    return launch_variant<128>(c, scale, variant, s);
}

// G images per block, f32 scores; phase: 0 = order `loop`, 1 = order `phase`.
int mhsa_group_fwd(const void* qkv, void* out, int B, int n, int C, int H, float scale, int G,
                   int phase, void* stream) {
    if (bad_qkv(B, n, C, H) || bad_group(B, G)) return kBadShape;
    const Call c = make_call(qkv, nullptr, out, nullptr, B, n, C, H);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (c.d <= 32) return launch_group_fwd<32>(c, scale, G, phase, s);
    if (c.d <= 64) return launch_group_fwd<64>(c, scale, G, phase, s);
    return launch_group_fwd<128>(c, scale, G, phase, s);
}

// `stats` is f32 scratch of B * H * n * 3 elements.
int mhsa_group_bwd(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int n,
                   int C, int H, float scale, int G, int phase, void* stream) {
    if (bad_qkv(B, n, C, H) || bad_group(B, G)) return kBadShape;
    const Call c = make_call(qkv, dout, nullptr, dqkv, B, n, C, H);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (c.d <= 32) return launch_group_bwd<32>(c, stats, scale, G, phase, s);
    if (c.d <= 64) return launch_group_bwd<64>(c, stats, scale, G, phase, s);
    return launch_group_bwd<128>(c, stats, scale, G, phase, s);
}

}  // extern "C"
