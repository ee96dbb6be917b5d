// Schedule variants of the fused MHSA on the raw qkv projection (bf16).
//
// Replaces, for Hopper (sm_90a), the experimental Pallas kernels that the
// measurement scripts of the JAX package time against mhsa_fused_qkv:
//   scripts/attn_variants.py  _fwd_kernel_twophase, _fwd_kernel_pipelined
//                             (mhsa_fwd_variant)            -> mhsa_variant_fwd
//   scripts/bench_attn_x.py   _fwd_phase_kernel, _fwd_loop_kernel,
//                             _bwd_phase_kernel (make_variant)
//                                          -> mhsa_group_fwd, mhsa_group_bwd
// None of them changes K1's arithmetic (mhsa_qkv.cu, rounding points in
// mhsa_common.cuh); each asks one question of schedule against K1 as it is.
// What bounds them is what bounds K1: the operations spent per score and the
// warps resident to hide each other's latencies; a variant that parks rows in
// shared memory trades the second for the first.
//
// Resident shapes (bf16, n <= 256, head_dim <= 64; the router's switch by
// shape, as for K1). Every variant is built from K1's resident walks
// (mhsa_common.cuh): whole cells in shared memory by cp.async, K before V, a
// persistent grid sized by make_plan, ldmatrix fragments, mma.sync, the
// cheap per-score steps. Only the question a variant asks differs from K1,
// so each gives K1's bits at its score type:
//
//   pipelined         K1's forward with the next work item always in flight
//                     in a second buffer, where K1 takes one only if it costs
//                     no residency; f32 scores. The items are whole cells (a
//                     13-warp block at n = 196, where K1 takes half cells),
//                     so that two buffers still leave two blocks an SM.
//                     16-byte copies: head_dim % 8 != 0 is refused.
//   twophase, twophase_bf16s   park or recompute? K1's items, one q k^T sweep
//                     per warp; the masked scores of its 16 rows are parked
//                     in shared memory (f32, or rounded to bf16), and exp, z
//                     and T(e) . V read them back where K1 computes them
//                     again. The rows park over the chunk's q once every warp
//                     holds its fragments, and V lands in K's place after the
//                     sweep, so a block holds the rows and one tile. Each lane
//                     reads back only the fragment it wrote.
//   G images per block, order `loop`   a work item is G whole cells of one
//                     head; K1's forward body once per image, the next
//                     image's q, K and V in flight in a second buffer. G = 1
//                     is `pipelined`.
//   G images per block, order `phase`  q k^T of the G cells, parked at f32;
//                     then the G softmaxes, e kept in place at bf16 (exact:
//                     T(e) . V takes e rounded to bf16) beside z; then the G
//                     T(e) . V. q and K of a cell, then its V, pass through a
//                     ring of two slots, the next cell's in flight. Warps per
//                     block at run time: the most query rows of real work
//                     that the parked rows let stay resident.
//   backward, both orders    one kernel per work item (G cells of one head),
//                     a block holding all queries and keys of a cell, so dQ,
//                     dK and dV are complete in it and no statistics go
//                     through device memory. `loop`: K1's backward body once
//                     per image; `phase`: the statistics (scores, softmax,
//                     rowsum(dP p)) of all G cells first, kept in shared
//                     memory, then dS, dQ, dK and dV of each; a cell's tiles
//                     are fetched again for the second phase where G > 1.
//                     The next cell is in flight in a second buffer wherever
//                     two fit (not at head_dim 64, n > 192).
//
// Above the resident shapes (n up to 1024, head_dim up to 128) the variants
// run the streaming cells of mhsa_common.cuh, K1's path there, in 64-row
// tiles: `loop` with G = 1 is that path exactly and every variant with f32
// scores equals it bit for bit. twophase parks the block's [64, n] rows
// (refused, -1, where they do not fit: n = 1024 at f32); pipelined fetches
// the next K (and V) tile by cp.async; `phase` takes 2-warp blocks whose G
// cells of parked rows must fit (else -1); the backward is two passes
// (dQ and the row statistics through device memory, then dK and dV), the G
// loop inside each.

#include "mhsa_common.cuh"

namespace {

// Launches of each kernel of this file, counted beside its <<<>>> and read
// by mhsa_variant_launches in this order (KERNEL_NAMES of
// scripts/attn_variants.py names them).
enum Kernel {
    // streaming shapes
    K_FWD_TWOPHASE, K_FWD_PIPELINED, K_GROUP_FWD_LOOP, K_GROUP_FWD_PHASE, K_GROUP_BWD_DQ_LOOP,
    K_GROUP_BWD_DKV_LOOP, K_GROUP_BWD_DQ_PHASE, K_GROUP_BWD_DKV_PHASE,
    // resident shapes
    K_FWD_WALK, K_FWD_PARK, K_FWD_PHASE, K_BWD_WALK,
    KERNELS
};
long long launches[KERNELS] = {};

// ======================================================= streaming shapes

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

// cp.async helpers and async_tile: mhsa_common.cuh

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

// =============================================== resident shapes
//
// Parked scores of a warp, per 16-key step: a lane's eight values of s[2][4]
// as two float4 (f32: the first of every lane, then the second, so that a
// quarter warp stores 128 contiguous bytes) or one uint4 of bf16 pairs.
// A lane reads back only what it wrote: no barrier.

constexpr int PARK_F32 = 1, PARK_BF16 = 2;
// 32-bit words a warp parks per 16-key step
template <int PARK> constexpr int PARK_WORDS = PARK == PARK_BF16 ? 128 : 256;

template <int PARK>
__device__ __forceinline__ void park(uint32_t* p, int kk, int lane, const float (&s)[2][4]) {
    if constexpr (PARK == PARK_BF16) {
        reinterpret_cast<uint4*>(p)[kk * 32 + lane] =
            make_uint4(pack2f(s[0][0], s[0][1]), pack2f(s[0][2], s[0][3]),
                       pack2f(s[1][0], s[1][1]), pack2f(s[1][2], s[1][3]));
    } else {
        float4* f = reinterpret_cast<float4*>(p) + kk * 64 + lane;
        f[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
        f[32] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
    }
}

template <int PARK>
__device__ __forceinline__ void unpark(const uint32_t* p, int kk, int lane, float (&s)[2][4]) {
    if constexpr (PARK == PARK_BF16) {
        const uint4 x = reinterpret_cast<const uint4*>(p)[kk * 32 + lane];
        s[0][0] = unpack_lo(x.x), s[0][1] = unpack_hi(x.x), s[0][2] = unpack_lo(x.y),
        s[0][3] = unpack_hi(x.y), s[1][0] = unpack_lo(x.z), s[1][1] = unpack_hi(x.z),
        s[1][2] = unpack_lo(x.w), s[1][3] = unpack_hi(x.w);
    } else {
        const float4* f = reinterpret_cast<const float4*>(p) + kk * 64 + lane;
        const float4 a = f[0], b = f[32];
        s[0][0] = a.x, s[0][1] = a.y, s[0][2] = a.z, s[0][3] = a.w;
        s[1][0] = b.x, s[1][1] = b.y, s[1][2] = b.z, s[1][3] = b.w;
    }
}

// Warps per block of the walks below: all of a cell's 16-row groups, so that
// a work item is whole cells and a second buffer costs fewer blocks of wider
// cells than K1's half cells (at n = 196: two 13-warp blocks an SM where two
// buffers of K1's 7-warp blocks leave two).
template <int NS> constexpr int CELL_W = NS <= 4 ? 4 : NS <= 7 ? 7 : NS <= 9 ? 9 : NS <= 13 ? 13 : 16;
template <int DP, int W> constexpr int WALK_MIN_BLOCKS =
    RES_MIN_BLOCKS<DP, W> > 1 ? RES_MIN_BLOCKS<DP, W> : 1;

template <typename F> int with_cell_w(int steps, F&& f) {
    if (steps <= 4) return f(IntC<CELL_W<4>>());
    if (steps <= 7) return f(IntC<CELL_W<7>>());
    if (steps <= 9) return f(IntC<CELL_W<9>>());
    if (steps <= 13) return f(IntC<CELL_W<13>>());
    return f(IntC<CELL_W<16>>());
}

// The forward walk of pipelined and `loop`: a work item is (image group,
// head), and the block walks units (item, image) for items blockIdx.x, +
// gridDim.x, ..., each unit K1's two sweeps on a cell. One buffer holds the
// cell's q, K and V, q and K one cp.async group and V the next; the next
// unit's tiles are in flight in the other buffer (nbuf == 2 wherever two fit,
// which is every resident shape).
template <int DP, int W>
__global__ void __launch_bounds__(32 * W, WALK_MIN_BLOCKS<DP, W>)
fwd_walk(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out, int n, int d,
         int H, float scale, int vec, int pk, int items, int G, int nbuf, int steps) {
    constexpr int LD = DP + PAD;
    const int NN = 16 * steps, BUF = 3 * NN * LD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* base = reinterpret_cast<bf16*>(smem_raw);
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;

    // the cell of the u-th unit of this block (image u % G of item blockIdx.x
    // + (u / G) gridDim.x), or -1 past the last
    auto unit = [&](int u) {
        const int item = blockIdx.x + (u / G) * gridDim.x;
        if (item >= items) return -1;
        const int grp = item / H;
        return (grp * G + u % G) * H + (item - grp * H);
    };
    auto fetch = [&](int cell, bf16* s) {
        const int b = cell / H, h = cell - b * H;
        fetch_tile<DP>(s, q.at(b, h), q.row, 0, NN, n, d, scale, true, vec);
        fetch_tile<DP>(s + NN * LD, k.at(b, h), k.row, 0, NN, n, d, 1.f, false, vec);
        cp_async_commit();
        fetch_tile<DP>(s + 2 * NN * LD, v.at(b, h), v.row, 0, NN, n, d, 1.f, false, vec);
        cp_async_commit();
    };

    int u = 0, cur = 0, cell = unit(0);
    if (cell >= 0) fetch(cell, base);
    while (cell >= 0) {
        bf16* sQ = base + cur * BUF;
        bf16* sK = sQ + NN * LD;
        bf16* sV = sK + NN * LD;
        const int next = unit(u + 1);
        const bool ahead = nbuf == 2 && next >= 0;
        if (ahead) fetch(next, base + (cur ^ 1) * BUF);
        const int b = cell / H, h = cell - b * H;

        if (ahead) cp_async_wait<3>(); else cp_async_wait<1>();  // q and K are here
        if (vec) scale_own_chunks<DP>(sQ, 0, NN, n, d, scale);
        __syncthreads();
        const bool active = wr < n;
        uint32_t aq[DP / 16][4];
        float m0, m1;
        if (active) {
            load_a<DP>(aq, sQ, wr, lane);
            res_row_max<DP>(m0, m1, aq, sK, steps, n, t, lane, 1, NoPark());
        }
        if (ahead) cp_async_wait<2>(); else cp_async_wait<0>();  // V is here
        __syncthreads();
        if (active) {
            auto again = [&](int kk, float (&s)[2][4]) {
                mma_abt_frag<DP, 16>(s, aq, sK + kk * 16 * LD, lane);
                mask_scores<16>(s, kk * 16, n, t);
            };
            float z0, z1, o[DP / 8][4];
            res_exp_pv<DP>(o, z0, z1, again, sV, steps, m0 * LOG2E, m1 * LOG2E, lane);
            res_store_out<DP>(out.at(b, h), out.row, o, z0, z1, wr, n, d, g, t, pk);
        }
        __syncthreads();  // every warp is done with this buffer
        if (nbuf == 1 && next >= 0) fetch(next, base);
        if (nbuf == 2) cur ^= 1;
        cell = next, ++u;
    }
}

// twophase (PARK_F32, f32 scores) and twophase_bf16s (PARK_BF16, bf16
// scores): K1's work items (cell, chunk of 16 W query rows) and one q k^T
// sweep whose masked scores each warp parks; exp, z and T(e) . V read them
// back. Shared memory: the parked rows [W][steps][PARK_WORDS], with the
// chunk's q rows at their start until every warp holds its fragments, then
// one tile [NN][LD] that holds K for the sweep and V after it. One buffer:
// the other blocks of the SM cover the two loads of an item.
template <int DP, int W, int PARK>
__global__ void __launch_bounds__(32 * W, RES_MIN_BLOCKS<DP, W>)
fwd_park(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out, int n,
         int d, int H, float scale, int scores_f32, int vec, int pk, int items, int chunks,
         int steps, int rows_bytes) {
    constexpr int LD = DP + PAD, QR = 16 * W, PW = PARK_WORDS<PARK>;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int warp = threadIdx.x >> 5, wr = warp * 16;
    uint32_t* mine = reinterpret_cast<uint32_t*>(smem_raw) + warp * steps * PW;
    bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
    bf16* sKV = reinterpret_cast<bf16*>(smem_raw + rows_bytes);

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int cell = item / chunks, q0 = (item - cell * chunks) * QR;
        const int b = cell / H, h = cell - b * H;
        fetch_tile<DP>(sQ, q.at(b, h), q.row, q0, QR, n, d, scale, true, vec);
        fetch_tile<DP>(sKV, k.at(b, h), k.row, 0, 16 * steps, n, d, 1.f, false, vec);
        cp_async_commit();
        cp_async_wait<0>();
        if (vec) scale_own_chunks<DP>(sQ, q0, QR, n, d, scale);
        __syncthreads();
        const bool active = q0 + wr < n;
        uint32_t aq[DP / 16][4];
        if (active) load_a<DP>(aq, sQ, wr, lane);
        __syncthreads();  // every warp holds its q fragments: the rows park over q
        float m0, m1;
        if (active)
            res_row_max<DP>(m0, m1, aq, sKV, steps, n, t, lane, scores_f32,
                            [&](int kk, float (&s)[2][4]) { park<PARK>(mine, kk, lane, s); });
        __syncthreads();  // every warp is done with K: V lands in its place
        fetch_tile<DP>(sKV, v.at(b, h), v.row, 0, 16 * steps, n, d, 1.f, false, vec);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (active) {
            auto parked = [&](int kk, float (&s)[2][4]) { unpark<PARK>(mine, kk, lane, s); };
            float z0, z1, o[DP / 8][4];
            res_exp_pv<DP>(o, z0, z1, parked, sKV, steps, m0 * LOG2E, m1 * LOG2E, lane);
            res_store_out<DP>(out.at(b, h) + (long long)q0 * out.row, out.row, o, z0, z1, wr,
                              n - q0, d, g, t, pk);
        }
        __syncthreads();  // every warp is done with V and with its parked rows
    }
}

// `phase` forward: a work item is (image group, head, chunk of 16 W query
// rows), W = blockDim.x / 32 chosen by the host. Shared memory: the parked
// rows [W][G][steps][256 words] (scores at f32, then e at bf16 in the first
// half of each step), (max log2(e), z) per lane [W][G][2][32], and a ring of
// two slots (one if G = 1), each a q chunk [QR][LD] and a tile [NN][LD]:
// cell gi's q and K in slot gi % 2 for phase 1, the next cell's in flight in
// the other; V the same way for phase 3, the first two landing while phase
// 2 runs.
template <int DP>
__global__ void __launch_bounds__(256)
fwd_phase(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<bf16> out, int n,
          int d, int H, float scale, int vec, int pk, int items, int chunks, int G, int steps) {
    constexpr int LD = DP + PAD, PW = PARK_WORDS<PARK_F32>;
    const int W = blockDim.x >> 5, QR = 16 * W, NN = 16 * steps, SLOT = (QR + NN) * LD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int warp = threadIdx.x >> 5, wr = warp * 16;
    uint32_t* mine = reinterpret_cast<uint32_t*>(smem_raw) + (size_t)warp * G * steps * PW;
    float2* stat = reinterpret_cast<float2*>(reinterpret_cast<uint32_t*>(smem_raw) +
                                             (size_t)W * G * steps * PW);
    float2* my_stat = stat + warp * G * 64 + lane;  // [gi * 64]: max log2(e), [+ 32]: z
    bf16* ring = reinterpret_cast<bf16*>(stat + W * G * 64);

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int grp = item / (H * chunks), rest = item - grp * (H * chunks);
        const int h = rest / chunks, q0 = (rest - h * chunks) * QR;
        const bool active = q0 + wr < n;
        auto fetch_qk = [&](int gi) {
            bf16* s = ring + (gi & 1) * SLOT;
            fetch_tile<DP>(s, q.at(grp * G + gi, h), q.row, q0, QR, n, d, scale, true, vec);
            fetch_tile<DP>(s + QR * LD, k.at(grp * G + gi, h), k.row, 0, NN, n, d, 1.f, false,
                           vec);
            cp_async_commit();
        };
        auto fetch_v = [&](int gi) {
            fetch_tile<DP>(ring + (gi & 1) * SLOT + QR * LD, v.at(grp * G + gi, h), v.row, 0, NN,
                           n, d, 1.f, false, vec);
            cp_async_commit();
        };
        // phase 1: q k^T of every cell, parked, and the row maxima
        fetch_qk(0);
        if (G > 1) fetch_qk(1);
        for (int gi = 0; gi < G; ++gi) {
            bf16* s = ring + (gi & 1) * SLOT;
            if (gi + 1 < G) cp_async_wait<1>(); else cp_async_wait<0>();
            if (vec) scale_own_chunks<DP>(s, q0, QR, n, d, scale);
            __syncthreads();
            if (active) {
                uint32_t aq[DP / 16][4];
                load_a<DP>(aq, s, wr, lane);
                uint32_t* p = mine + gi * steps * PW;
                float m0, m1;
                res_row_max<DP>(m0, m1, aq, s + QR * LD, steps, n, t, lane, 1,
                                [&](int kk, float (&sc)[2][4]) { park<PARK_F32>(p, kk, lane, sc); });
                my_stat[gi * 64] = make_float2(m0 * LOG2E, m1 * LOG2E);
            }
            __syncthreads();  // every warp is done with the slot
            if (gi + 2 < G) fetch_qk(gi + 2);
        }
        fetch_v(0);
        if (G > 1) fetch_v(1);
        // phase 2: every softmax numerator, e packed to bf16 in place of the scores
        if (active)
            for (int gi = 0; gi < G; ++gi) {
                uint32_t* p = mine + gi * steps * PW;
                const float2 ml = my_stat[gi * 64];
                float z0 = 0.f, z1 = 0.f;
#pragma unroll 2
                for (int kk = 0; kk < steps; ++kk) {
                    float sc[2][4];
                    unpark<PARK_F32>(p, kk, lane, sc);
                    uint32_t e[1][4];
                    tile_exp2_pack<16>(e, sc, ml.x, ml.y, z0, z1);
                    reinterpret_cast<uint4*>(p)[kk * 64 + lane] =
                        make_uint4(e[0][0], e[0][1], e[0][2], e[0][3]);
                }
                my_stat[gi * 64 + 32] = make_float2(quad_sum(z0), quad_sum(z1));
            }
        // phase 3: every T(e) . V
        for (int gi = 0; gi < G; ++gi) {
            if (gi + 1 < G) cp_async_wait<1>(); else cp_async_wait<0>();
            __syncthreads();
            if (active) {
                const uint32_t* p = mine + gi * steps * PW;
                const bf16* sV = ring + (gi & 1) * SLOT + QR * LD;
                float o[DP / 8][4];
                zero_acc(o);
#pragma unroll 2
                for (int kk = 0; kk < steps; ++kk) {
                    const uint4 x = reinterpret_cast<const uint4*>(p)[kk * 64 + lane];
                    const uint32_t e[1][4] = {{x.x, x.y, x.z, x.w}};
                    mma_pv_ld<DP, 16>(o, e, sV + kk * 16 * LD, lane);
                }
                const float2 z = my_stat[gi * 64 + 32];
                const int b = grp * G + gi;
                res_store_out<DP>(out.at(b, h) + (long long)q0 * out.row, out.row, o, z.x, z.y,
                                  wr, n - q0, d, g, t, pk);
            }
            __syncthreads();  // every warp is done with the slot
            if (gi + 2 < G) fetch_v(gi + 2);
        }
    }
}

// The backward of both orders: a work item is (image group, head), and the
// block walks units: `loop`, (item, image), K1's backward body on the cell;
// `phase`, (item, phase, image): phase 0 the statistics of each query row
// into sSt[image], phase 1 dQ from them, then dK and dV. One buffer holds
// qs, K, V and dO of the unit's cell; with nbuf == 2 the next unit's cell is
// fetched into the other buffer meanwhile, unless it is the same cell.
template <int DP, int W, int MINB, bool PHASE>
__global__ void __launch_bounds__(32 * W, MINB)
bwd_walk(Slab<const bf16> q, Slab<const bf16> k, Slab<const bf16> v, Slab<const bf16> dout,
         Slab<bf16> dq, Slab<bf16> dk, Slab<bf16> dv, int n, int d, int H, float scale, int vec,
         int pk, int items, int G, int nbuf, int steps) {
    constexpr int LD = DP + PAD;
    constexpr bool phase = PHASE;
    const int NN = 16 * steps, TILE = NN * LD, BUF = 4 * TILE, upi = phase ? 2 * G : G;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float3* sSt = reinterpret_cast<float3*>(smem_raw);  // [phase ? G : 1][NN]
    bf16* base = reinterpret_cast<bf16*>(smem_raw + sizeof(float3) * NN * (phase ? G : 1));
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int warp = threadIdx.x >> 5;

    // the cell of the u-th unit of this block, or -1 past the last; its phase
    // and image in the item are (u % upi) / G and (u % upi) % G
    auto unit = [&](int u) {
        const int item = blockIdx.x + (u / upi) * gridDim.x;
        if (item >= items) return -1;
        const int grp = item / H;
        return (grp * G + u % upi % G) * H + (item - grp * H);
    };
    auto fetch = [&](int cell, bf16* s) {
        const int b = cell / H, h = cell - b * H;
        fetch_tile<DP>(s, q.at(b, h), q.row, 0, NN, n, d, scale, true, vec);
        fetch_tile<DP>(s + TILE, k.at(b, h), k.row, 0, NN, n, d, 1.f, false, vec);
        fetch_tile<DP>(s + 2 * TILE, v.at(b, h), v.row, 0, NN, n, d, 1.f, false, vec);
        fetch_tile<DP>(s + 3 * TILE, dout.at(b, h), dout.row, 0, NN, n, d, 1.f, false, vec);
        cp_async_commit();
    };

    int u = 0, cur = 0, cell = unit(0);
    bool fresh = true;  // the buffer's q is not scaled yet
    if (cell >= 0) fetch(cell, base);
    while (cell >= 0) {
        bf16* sQ = base + cur * BUF;
        bf16* sK = sQ + TILE;
        bf16* sV = sK + TILE;
        bf16* sDO = sV + TILE;
        {
            const int next = unit(u + 1);
            const bool ahead = nbuf == 2 && next >= 0 && next != cell;
            if (ahead) fetch(next, base + (cur ^ 1) * BUF);
            if (ahead) cp_async_wait<1>(); else cp_async_wait<0>();
        }
        if (fresh && vec) scale_own_chunks<DP>(sQ, 0, NN, n, d, scale);
        __syncthreads();
        const int b = cell / H, h = cell - b * H, ph = phase ? u % upi / G : 0;
        float3* st = sSt + (phase ? u % upi % G * NN : 0);
        if (!phase || ph == 0)  // the row statistics (and, in order loop, dQ)
            for (int rg = warp; rg < steps; rg += W) {
                const int r0 = rg * 16;
                uint32_t aq[DP / 16][4], ado[DP / 16][4];
                load_a<DP>(aq, sQ, r0, lane);
                load_a<DP>(ado, sDO, r0, lane);
                const RowStats r =
                    bwd_row_stats<DP>(aq, ado, sK, sV, nullptr, r0, steps, n, g, t, lane, 1);
                if (!phase) {
                    float acc[DP / 8][4];
                    bwd_row_dq<DP>(acc, r, aq, ado, sK, sV, steps, n, t, lane, 1, scale);
                    store_rows_pk<DP>(dq.at(b, h), dq.row, acc, r0, n, d, g, t, pk);
                }
                put_row_stats(st, r, r0, n, g, t);
            }
        if (!phase) __syncthreads();
        if (!phase || ph == 1) {
            if (phase)
                for (int rg = warp; rg < steps; rg += W) {
                    const int r0 = rg * 16;
                    uint32_t aq[DP / 16][4], ado[DP / 16][4];
                    load_a<DP>(aq, sQ, r0, lane);
                    load_a<DP>(ado, sDO, r0, lane);
                    float acc[DP / 8][4];
                    bwd_row_dq<DP>(acc, get_row_stats(st, r0, g), aq, ado, sK, sV, steps, n, t,
                                   lane, 1, scale);
                    store_rows_pk<DP>(dq.at(b, h), dq.row, acc, r0, n, d, g, t, pk);
                }
            for (int kg = warp; kg < steps; kg += W) {
                const int j0 = kg * 16;
                float gk[DP / 8][4], gv[DP / 8][4];
                bwd_key_grads<DP>(gk, gv, sQ, sK, sV, sDO, st, j0, NN, t, lane, 1);
                store_rows_pk<DP>(dk.at(b, h), dk.row, gk, j0, n, d, g, t, pk);
                store_rows_pk<DP>(dv.at(b, h), dv.row, gv, j0, n, d, g, t, pk);
            }
        }
        __syncthreads();  // every warp is done with this buffer
        const int next = unit(u + 1);
        if (next != cell) {
            if (nbuf == 1 && next >= 0) fetch(next, base);
            if (nbuf == 2) cur ^= 1;
        }
        fresh = next != cell;
        cell = next, ++u;
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
    ++launches[K_FWD_TWOPHASE];
    return (int)cudaGetLastError();
}

template <int DP>
int launch_pipelined(const Call& c, float scale, cudaStream_t stream) {
    const size_t smem = tile_bytes(MQ + 4 * MK, DP);
    cudaError_t err = allow_smem(fwd_pipelined<DP>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(ceil_div(c.n, MQ), c.H, c.B);
    fwd_pipelined<DP><<<grid, MT, smem, stream>>>(c.q, c.k, c.v, c.out, c.n, c.d, scale);
    ++launches[K_FWD_PIPELINED];
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
        ++launches[K_GROUP_FWD_LOOP];
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
    ++launches[K_GROUP_FWD_PHASE];
    return (int)cudaGetLastError();
}

template <int DP>
int launch_group_bwd(const Call& c, void* stats, float scale, int G, int phase,
                     cudaStream_t stream) {
    float3* st = static_cast<float3*>(stats);
    if (st == nullptr) return kBadShape;
    if (!phase) {
        const dim3 grid(ceil_div(c.n, MQ), c.H, c.B / G);
        const size_t smem_a = dq_cell_smem<DP>(MW), smem_b = dkv_cell_smem<DP>(MW);
        cudaError_t err = allow_smem(group_bwd_dq_loop<DP>, smem_a);
        if (err != cudaSuccess) return (int)err;
        group_bwd_dq_loop<DP><<<grid, MT, smem_a, stream>>>(c.q, c.k, c.v, c.dout, c.dq, st, c.n,
                                                            c.d, c.H, scale, G, c.vec);
        ++launches[K_GROUP_BWD_DQ_LOOP];
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        err = allow_smem(group_bwd_dkv_loop<DP>, smem_b);
        if (err != cudaSuccess) return (int)err;
        group_bwd_dkv_loop<DP><<<grid, MT, smem_b, stream>>>(c.q, c.k, c.v, c.dout, c.dk, c.dv,
                                                             st, c.n, c.d, c.H, scale, G, c.vec);
        ++launches[K_GROUP_BWD_DKV_LOOP];
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
    ++launches[K_GROUP_BWD_DQ_PHASE];
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = allow_smem(group_bwd_dkv_phase<DP>, smem_b);
    if (err != cudaSuccess) return (int)err;
    group_bwd_dkv_phase<DP><<<grid, PT, smem_b, stream>>>(c.q, c.k, c.v, c.dout, c.dk, c.dv, st,
                                                          c.n, c.d, c.H, scale, G, ld_b, c.vec);
    ++launches[K_GROUP_BWD_DKV_PHASE];
    return (int)cudaGetLastError();
}

// ------------------------------------------------ host, resident shapes

// pipelined (G = 1) and `loop`: a second buffer wherever two fit
template <int DP, int W>
int launch_fwd_walk(const Call& c, float scale, int G, cudaStream_t stream) {
    const int steps = ceil_div(c.n, 16);
    const size_t buf = tile_bytes(48 * steps, DP);
    static Plan plans[1][17] = {};
    Plan plan{};
    const int err = cached_plan(plans, 0, steps, plan, [&](Plan& p) {
        return (int)make_plan(fwd_walk<DP, W>, 32 * W, buf, 0, p, true);
    });
    if (err != 0) return err;
    const int items = c.B / G * c.H;
    const int pk = c.d % 2 == 0 && even_slab(c.out);
    fwd_walk<DP, W><<<min(items, plan.resident), 32 * W, plan.nbuf * buf, stream>>>(
        c.q, c.k, c.v, c.out, c.n, c.d, c.H, scale, c.vec, pk, items, G, plan.nbuf, steps);
    ++launches[K_FWD_WALK];
    return (int)cudaGetLastError();
}

template <int DP>
int fwd_walk_steps(const Call& c, float scale, int G, cudaStream_t stream) {
    return with_cell_w(ceil_div(c.n, 16), [&](auto w) {
        return launch_fwd_walk<DP, decltype(w)::value>(c, scale, G, stream);
    });
}

// twophase at K1's warps per block; one buffer
template <int DP, int W, int PARK>
int launch_fwd_park(const Call& c, float scale, int scores_f32, cudaStream_t stream) {
    const int steps = ceil_div(c.n, 16);
    const size_t parked = sizeof(uint32_t) * W * steps * PARK_WORDS<PARK>;
    const size_t rows = parked > tile_bytes(16 * W, DP) ? parked : tile_bytes(16 * W, DP);
    const size_t smem = rows + tile_bytes(16 * steps, DP);
    if (smem > SMEM_LIMIT) return kBadShape;
    static Plan plans[1][17] = {};
    Plan plan{};
    const int err = cached_plan(plans, 0, steps, plan, [&](Plan& p) {
        return (int)make_plan(fwd_park<DP, W, PARK>, 32 * W, smem, 0, p);
    });
    if (err != 0) return err;
    const int chunks = ceil_div(steps, W), items = c.B * c.H * chunks;
    const int pk = c.d % 2 == 0 && even_slab(c.out);
    fwd_park<DP, W, PARK><<<min(items, plan.resident), 32 * W, smem, stream>>>(
        c.q, c.k, c.v, c.out, c.n, c.d, c.H, scale, scores_f32, c.vec, pk, items, chunks, steps,
        (int)rows);
    ++launches[K_FWD_PARK];
    return (int)cudaGetLastError();
}

template <int DP, int PARK>
int fwd_park_steps(const Call& c, float scale, int scores_f32, cudaStream_t stream) {
    return with_fwd_w(ceil_div(c.n, 16), [&](auto w) {
        return launch_fwd_park<DP, decltype(w)::value, PARK>(c, scale, scores_f32, stream);
    });
}

template <int DP> size_t fwd_phase_smem(int W, int G, int steps) {
    return sizeof(uint32_t) * W * G * steps * PARK_WORDS<PARK_F32> + sizeof(float2) * W * G * 64 +
           tile_bytes((G > 1 ? 2 : 1) * (16 * W + 16 * steps), DP);
}

// `phase` forward: the warps per block that keep the most query rows of
// real work resident (the parked rows of G cells grow with the warps; a
// chunk's warps past the last row idle)
// warps per block and blocks resident on the card
struct PhasePlan {
    int w, resident;
};

template <int DP>
int launch_fwd_phase(const Call& c, float scale, int G, cudaStream_t stream) {
    const int steps = ceil_div(c.n, 16);
    static PhasePlan plans[9][17] = {};  // by G
    PhasePlan plan{};
    const int status = cached_plan(plans, G, steps, plan, [&](PhasePlan& p) {
        int dev = 0, sms = 0, best = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess) err = allow_smem(fwd_phase<DP>, SMEM_LIMIT);
        for (int w = 1; err == cudaSuccess && w <= 8 && w <= steps; ++w) {
            const size_t smem = fwd_phase_smem<DP>(w, G, steps);
            if (smem > SMEM_LIMIT) break;
            int blocks = 0;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fwd_phase<DP>, 32 * w,
                                                                smem);
            const int rows = blocks * steps / ceil_div(steps, w);  // warps of real work, an SM
            if (err == cudaSuccess && blocks > 0 && rows > best)
                best = rows, p.w = w, p.resident = sms * blocks;
        }
        if (err != cudaSuccess) return (int)err;
        return p.w == 0 ? kBadShape : 0;  // 0 warps: the parked rows of G cells do not fit
    });
    if (status != 0) return status;
    const int W = plan.w, chunks = ceil_div(steps, W), items = c.B / G * c.H * chunks;
    const int pk = c.d % 2 == 0 && even_slab(c.out);
    const size_t smem = fwd_phase_smem<DP>(W, G, steps);
    fwd_phase<DP><<<min(items, plan.resident), 32 * W, smem, stream>>>(
        c.q, c.k, c.v, c.out, c.n, c.d, c.H, scale, c.vec, pk, items, chunks, G, steps);
    ++launches[K_FWD_PHASE];
    return (int)cudaGetLastError();
}

template <int DP, int W, int MINB, bool PHASE>
int launch_bwd_walk(const Call& c, float scale, int G, cudaStream_t stream) {
    const int steps = ceil_div(c.n, 16), cells = PHASE ? G : 1;
    const size_t buf = tile_bytes(64 * steps, DP), fixed = sizeof(float3) * 16 * steps * cells;
    if (buf + fixed > SMEM_LIMIT) return kBadShape;
    static Plan plans[9][17] = {};  // by cells of statistics
    Plan plan{};
    const int err = cached_plan(plans, cells, steps, plan, [&](Plan& p) {
        return (int)make_plan(bwd_walk<DP, W, MINB, PHASE>, 32 * W, buf, fixed, p, true);
    });
    if (err != 0) return err;
    const int items = c.B / G * c.H;
    const int pk = c.d % 2 == 0 && even_slab(c.dq) && even_slab(c.dk) && even_slab(c.dv);
    bwd_walk<DP, W, MINB, PHASE>
        <<<min(items, plan.resident), 32 * W, plan.nbuf * buf + fixed, stream>>>(
            c.q, c.k, c.v, c.dout, c.dq, c.dk, c.dv, c.n, c.d, c.H, scale, c.vec, pk, items, G,
            plan.nbuf, steps);
    ++launches[K_BWD_WALK];
    return (int)cudaGetLastError();
}

int resident_variant_fwd(const Call& c, float scale, int variant, cudaStream_t s) {
    if (variant == 2 && !c.vec) return kBadShape;  // pipelined copies 16 bytes at a time
    if (c.d <= 32) {
        if (variant == 0) return fwd_park_steps<32, PARK_F32>(c, scale, 1, s);
        if (variant == 1) return fwd_park_steps<32, PARK_BF16>(c, scale, 0, s);
        return fwd_walk_steps<32>(c, scale, 1, s);
    }
    if (variant == 0) return fwd_park_steps<64, PARK_F32>(c, scale, 1, s);
    if (variant == 1) return fwd_park_steps<64, PARK_BF16>(c, scale, 0, s);
    return fwd_walk_steps<64>(c, scale, 1, s);
}

int resident_group_fwd(const Call& c, float scale, int G, int phase, cudaStream_t s) {
    if (c.d <= 32)
        return phase ? launch_fwd_phase<32>(c, scale, G, s) : fwd_walk_steps<32>(c, scale, G, s);
    return phase ? launch_fwd_phase<64>(c, scale, G, s) : fwd_walk_steps<64>(c, scale, G, s);
}

int resident_group_bwd(const Call& c, float scale, int G, int phase, cudaStream_t s) {
    return with_bwd_w(c.d, ceil_div(c.n, 16), [&](auto dp, auto w, auto minb) {
        constexpr int DP = decltype(dp)::value, W = decltype(w)::value;
        constexpr int MINB = decltype(minb)::value;
        return phase ? launch_bwd_walk<DP, W, MINB, true>(c, scale, G, s)
                     : launch_bwd_walk<DP, W, MINB, false>(c, scale, G, s);
    });
}

bool bad_qkv(int B, int n, int C, int H) {
    return H < 1 || C % H != 0 || bad_shape(B, n, H, C / H);
}

bool bad_group(int B, int G) { return G < 1 || B % G != 0; }

}  // namespace

extern "C" {

// Copies the launches of each kernel of this library so far, in the order of
// `Kernel`, into counts[0 .. min(len, KERNELS)); returns KERNELS.
int mhsa_variant_launches(long long* counts, int len) {
    for (int i = 0; i < len && i < KERNELS; ++i) counts[i] = launches[i];
    return KERNELS;
}

// Every other entry point takes bf16 tensors, returns 0 on success, a cudaError_t
// value, or -1 for a shape it refuses (also: what does not fit the shared
// memory the schedule asks for). `stream` is a cudaStream_t. Routed by shape
// as K1 is: the resident kernels at n <= 256 and head_dim <= 64, the
// streaming ones above.

// qkv [B, n, 3C] -> out [B, n, C]. variant: 0 twophase (scores parked at f32),
// 1 twophase_bf16s (parked at bf16), 2 pipelined (f32 scores).
int mhsa_variant_fwd(const void* qkv, void* out, int B, int n, int C, int H, float scale,
                     int variant, void* stream) {
    if (bad_qkv(B, n, C, H) || variant < 0 || variant > 2) return kBadShape;
    const Call c = make_call(qkv, nullptr, out, nullptr, B, n, C, H);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (resident_path(c.n, c.d)) return resident_variant_fwd(c, scale, variant, s);
    if (variant == 2 && !c.vec) return kBadShape;
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
    if (resident_path(c.n, c.d)) return resident_group_fwd(c, scale, G, phase, s);
    if (c.d <= 32) return launch_group_fwd<32>(c, scale, G, phase, s);
    if (c.d <= 64) return launch_group_fwd<64>(c, scale, G, phase, s);
    return launch_group_fwd<128>(c, scale, G, phase, s);
}

// `stats`: f32 scratch of B * H * n * 3 elements where the shape streams
// (mhsa_uses_scratch(n, d, 1) of mhsa_qkv.cu); unused, and may be null, at
// the resident shapes.
int mhsa_group_bwd(const void* qkv, const void* dout, void* dqkv, void* stats, int B, int n,
                   int C, int H, float scale, int G, int phase, void* stream) {
    if (bad_qkv(B, n, C, H) || bad_group(B, G)) return kBadShape;
    const Call c = make_call(qkv, dout, nullptr, dqkv, B, n, C, H);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (resident_path(c.n, c.d)) return resident_group_bwd(c, scale, G, phase, s);
    if (c.d <= 32) return launch_group_bwd<32>(c, stats, scale, G, phase, s);
    if (c.d <= 64) return launch_group_bwd<64>(c, stats, scale, G, phase, s);
    return launch_group_bwd<128>(c, stats, scale, G, phase, s);
}

}  // extern "C"
