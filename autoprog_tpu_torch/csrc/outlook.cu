// Fused outlook attention for Hopper (sm_90a): K2 forward, K2 backward and
// the K3 / K4 attend.
//
// Replaces autoprog_tpu/ops/outlook_pallas.py:
//   outlook_fused_fwd  <- _forward / _kernel           (outlook_attention_fused)
//   outlook_fused_bwd  <- _bwd (XLA in the JAX package, a kernel here)
//   outlook_attend     <- _forward_hybrid / _attend_kernel      (head_minor = 1)
//                         _forward_hybrid2 / _attend_kernel_v2  (head_minor = 0)
//
// The op (kernel 3, stride 2, padding 1, H = 2h, W = 2w):
//   v      [B, H, W, C]           C = heads * d, head-major channels
//   logits [B, h, w, heads * 81]  per window and head a 9 x 9 matrix [p, q]
//   att    = softmax_q(f32(logits) * scale)
//   av[win, p, c]  = sum_q att[win, head(c), p, q] * patch[win, q, c]
//   out[y, x, c]   = sum of av[win, p, c] over the (win, p) whose window
//                    position p lies on pixel (y, x)           (the fold)
// with patch[win = (i, j), q = (qy, qx)] = v[2i - 1 + qy, 2j - 1 + qx], zero
// outside the map. Everything is f32 inside; the output is rounded once.
// Backward, with dav = unfold(g) and the softmax recomputed from the saved
// logits (only v and logits are saved):
//   datt[p, q]  = sum_d dav[p, (head, d)] * patch[q, (head, d)]      (f32)
//   ds          = att * (datt - sum_q datt * att)
//   dlogits     = T(ds * scale)
//   dpatch[q,c] = T(sum_p att[p, q] * dav[p, c])      rounded before the fold
//   dv          = fold(dpatch), summed in T in (ky, kx) order as the plain
//                 fold sums it
//
// The Pallas kernel's parity planes, slabs and channel permutation exist
// because Mosaic cannot lower strided slices; none of that is carried over.
// The fold is a gather: quad row i (pixels 2i, 2i+1) receives from window
// rows i and i+1 only, every output element is owned by one thread, there
// are no atomics and the result is the same from run to run.
//
// What bounds it: at [128, 28, 28, 192] bf16 the forward must move 38.5 MB
// of v, 24.4 MB of logits and 38.5 MB of output (0.030 ms at 3.35 TB/s)
// against 0.39 G f32 FMA (0.012 ms), the backward 164 MB (0.049 ms) against
// twice that: bytes by the bound, but the instructions are close behind:
// every FMA of the attend reads a bf16 patch value that must be widened to
// f32 and a probability from shared memory, and the fold's gather and the
// backward's per-term roundings add to that. The first kernels (the
// general path below) issued 36 shared loads of patches and 81 of
// probabilities for 81 FMA a channel, divided by run-time integers in the
// inner loop, loaded whole tiles with nothing in flight during the
// arithmetic, and ran the backward as two kernels that read g and the
// logits twice.
//
// The row kernels (outlook_fwd_rows, outlook_bwd_rows) stream rows. An
// item is (image, run of window rows, head group); persistent blocks take
// items, and a block walks down its run one quad row a step, with a ring of
// map rows in shared memory: quad row i needs map rows 2i-1 .. 2i+3 and the
// next one shares three of them, so a ring of 5 + 2 AHEAD slots holds the
// rows in use while the rows of the next AHEAD steps, and their logits,
// arrive by cp.async (one commit group a step) during the arithmetic; every
// byte crosses from device memory once per run. Tiles stay in the working
// type; a slot has one zero pixel left of the row and row -1 is a slot of
// zeros, so the inner loop tests no bound. The softmax of a window row runs
// once a step into f32 matrices stored as rows of two float4 and one float
// (bf16: fma + ex2.approx, one reciprocal a row). A thread owns VB bytes of
// channels of a quad: one load per patch pixel, each probability read once
// for all its channels, outputs stored as VB-byte vectors, indices split by
// multiplications (`Div`). The head group is the largest whose block lets
// two share an SM, so one block's loads and barriers overlap another's
// arithmetic; runs split an image only when the images alone would leave
// SMs idle.
//
// The backward is one kernel on the same stream: the softmax of window row
// i+1 stored transposed, then the dv gather of quad row i on g (the
// forward's code with att^T and a rounding after every term) and datt, ds
// and dlogits of window row i. In bf16 datt is a [9 x d] . [d x 9] product
// per (window, head) on the tensor cores (mma.sync m16n8k16: products of
// bf16 values are exact in f32, only the f32 sum's order changes), fed by
// ldmatrix straight from the ring slots, DT tasks in flight a warp; in f32
// a thread takes a matrix row on the f32 pipe. dlogits are staged in the
// logits slot that window row i+1 has left and stored by consecutive threads
// the next step. Every warp gathers first, then takes its datt tasks. v, g
// and the logits are read once, dv and dlogits written once: the bound's own
// 164 MB.
// The constants (AHEAD, VB, DT, the budget of two blocks an SM) are those
// that measured fastest on an H100 at the volo_d1 map (PERF.md, section 6).
//
// The general path (outlook_gather_kernel, outlook_dlogits_kernel: the
// first kernels, a thread per channel of a quad, whole f32 tiles per (row
// tile, head, image)) takes what the row kernels do not: a head's channels
// that are no whole number of 16-byte groups, tensors not 16-byte aligned. The
// entry points' `general` flag forces it at any shape; it serves only the
// before / after column of scripts/bench_k2.py and goes once the general
// kernels are no longer the yardstick at the VOLO maps.
//
// The attend (K3 / K4) takes patches that PyTorch already unfolded,
// [B, n, 9, C], and logits [B, n, 9, 9, heads], and writes [B, 9, n, C]: f32
// softmax over q, f32 sum, one rounding. K3 has head-minor channels
// (c' = d_idx * heads + head), K4 head-major; the one-hot matmul of the TPU
// kernel is a TPU device and is not carried over.

#include <algorithm>
#include <initializer_list>

#include "mhsa_common.cuh"

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int KK = 9;                    // window positions (3 x 3)
constexpr int AA = 81;                   // one head's matrix of one window
constexpr int kSmemTwoPerSM = 100 * 1024;   // budget that lets two blocks share an SM

struct Geo {
    int B, H, W, C, heads, d, h, w;
    int TI;      // window rows per block
    int DP;      // shared-memory stride of one pixel's d channels (odd)
    float scale;
};

// softmax over q of every (window, p) row of `att` ([rows][9], already scaled)
__device__ __forceinline__ void softmax_rows(float* att, int rows) {
    for (int r = threadIdx.x; r < rows; r += NT) {
        float* a = att + r * KK;
        float m = a[0];
#pragma unroll
        for (int q = 1; q < KK; ++q) m = fmaxf(m, a[q]);
        float e[KK], s = 0.f;
#pragma unroll
        for (int q = 0; q < KK; ++q) { e[q] = expf(a[q] - m); s += e[q]; }
#pragma unroll
        for (int q = 0; q < KK; ++q) a[q] = e[q] / s;
    }
}

// scaled logits of head `head`, window rows [i0, i1) of image b -> att[win][81]
template <typename T>
__device__ __forceinline__ void load_logits(const T* __restrict__ logits, float* att,
                                            const Geo& g, int b, int head, int i0, int i1) {
    const int n = (i1 - i0) * g.w * AA;
    const size_t base = ((size_t)b * g.h + i0) * g.w;
    for (int e = threadIdx.x; e < n; e += NT) {
        const int win = e / AA, k = e - win * AA;
        att[e] = to_f(logits[((base + win) * g.heads + head) * AA + k]) * g.scale;
    }
}

template <typename T> struct Vec;   // 16 bytes of T
template <> struct Vec<float> {
    static constexpr int N = 4;
    static __device__ __forceinline__ void unpack(const uint4& u, float* out) {
        out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
        out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
    }
};
template <> struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    static __device__ __forceinline__ void unpack(const uint4& u, float* out) {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {          // a bf16 is the high half of an f32
            out[2 * k] = __uint_as_float(w[k] << 16);
            out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
        }
    }
};

// the head's d channels of rows [r0, r1) of map `src` -> tile[pixel][DP];
// 16-byte loads where d, C and the base allow (`vec`), scalar otherwise
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* tile,
                                          const Geo& g, int b, int head, int r0, int r1,
                                          bool vec) {
    const size_t base = ((size_t)b * g.H + r0) * g.W;
    if (vec) {
        constexpr int N = Vec<T>::N;
        const int per = g.d / N, n = (r1 - r0) * g.W * per;
        for (int e = threadIdx.x; e < n; e += NT) {
            const int pix = e / per, c = (e - pix * per) * N;
            const uint4 u = *reinterpret_cast<const uint4*>(
                src + (base + pix) * g.C + head * g.d + c);
            float f[N];
            Vec<T>::unpack(u, f);
#pragma unroll
            for (int k = 0; k < N; ++k) tile[pix * g.DP + c + k] = f[k];
        }
        return;
    }
    const int n = (r1 - r0) * g.W * g.d;
    for (int e = threadIdx.x; e < n; e += NT) {
        const int pix = e / g.d, c = e - pix * g.d;
        tile[pix * g.DP + c] = to_f(src[(base + pix) * g.C + head * g.d + c]);
    }
}

// Channel c of one window's 3 x 3 patch, zero outside the map. `tile` holds
// map rows from r0 on.
__device__ __forceinline__ void load_patch(const float* __restrict__ tile, const Geo& g,
                                           int r0, int i, int j, int c, float* pv) {
#pragma unroll
    for (int ry = 0; ry < 3; ++ry) {
        const int yy = 2 * i - 1 + ry;
        const bool oky = yy >= 0 && yy < g.H;
#pragma unroll
        for (int rx = 0; rx < 3; ++rx) {
            const int xx = 2 * j - 1 + rx;
            pv[ry * 3 + rx] = (oky && xx >= 0 && xx < g.W)
                                  ? tile[((yy - r0) * g.W + xx) * g.DP + c] : 0.f;
        }
    }
}

// One term of the fold: window position k of the window whose matrix is `a`
// and whose patch is `pv`. Forward: sum_q a[p = k][q] * v[q]. Backward:
// sum_p a[p][q = k] * g[p].
template <bool BWD>
__device__ __forceinline__ float window_term(const float* __restrict__ a, int k,
                                             const float* pv) {
    float val = 0.f;
#pragma unroll
    for (int r = 0; r < KK; ++r) val = fmaf(BWD ? a[r * KK + k] : a[k * KK + r], pv[r], val);
    return val;
}

// the plain fold adds the rounded patches in T, one by one; the forward
// sums in f32 and rounds at the end
template <typename T, bool BWD>
__device__ __forceinline__ void fold_add(float& acc, float val) {
    acc = BWD ? round_to<T>(acc + round_to<T>(val)) : acc + val;
}

// K2 forward (BWD = false: src = v, dst = out) and the dv half of the
// backward (BWD = true: src = g, dst = dv). grid (row tiles, heads, B).
// A thread owns channel c of the 2 x 2 pixels (2i..2i+1, 2j..2j+1). They
// receive from four windows: A = (i, j) at its positions 4, 5, 7, 8;
// B = (i, j+1) at 3, 6; C = (i+1, j) at 1, 2; D = (i+1, j+1) at 0. Each
// window's patch is read once for all its terms, and the order D, C, B, A
// is the fold's (ky, kx) order for every pixel.
template <typename T, bool BWD>
__global__ void __launch_bounds__(NT)
outlook_gather_kernel(const T* __restrict__ src, const T* __restrict__ logits,
                      T* __restrict__ dst, const Geo g, const bool vec) {
    extern __shared__ float smem[];
    const int head = blockIdx.y, b = blockIdx.z;
    const int i0 = blockIdx.x * g.TI;
    const int i1 = min(i0 + g.TI, g.h);       // output rows [2 i0, 2 i1)
    const int wi1 = min(i1 + 1, g.h);         // windows rows [i0, wi1) reach them
    const int r0 = max(2 * i0 - 1, 0);        // map rows [r0, r1) those windows cover
    const int r1 = min(2 * wi1, g.H);
    float* att = smem;
    float* tile = smem + (g.TI + 1) * g.w * AA;

    load_logits<T>(logits, att, g, b, head, i0, wi1);
    load_tile<T>(src, tile, g, b, head, r0, r1, vec);
    __syncthreads();
    softmax_rows(att, (wi1 - i0) * g.w * KK);
    __syncthreads();

    const int n = (i1 - i0) * g.w * g.d;
    for (int e = threadIdx.x; e < n; e += NT) {
        const int quad = e / g.d, c = e - quad * g.d;
        const int i = i0 + quad / g.w, j = quad % g.w;
        const bool down = i + 1 < g.h, right = j + 1 < g.w;
        const float* mat = att + ((i - i0) * g.w + j) * AA;      // window A's matrix
        float p00 = 0.f, p01 = 0.f, p10 = 0.f, p11 = 0.f;        // pixel (row, col) of the quad
        float pv[KK];
        if (down && right) {
            load_patch(tile, g, r0, i + 1, j + 1, c, pv);
            fold_add<T, BWD>(p11, window_term<BWD>(mat + (g.w + 1) * AA, 0, pv));
        }
        if (down) {
            load_patch(tile, g, r0, i + 1, j, c, pv);
            fold_add<T, BWD>(p10, window_term<BWD>(mat + g.w * AA, 1, pv));
            fold_add<T, BWD>(p11, window_term<BWD>(mat + g.w * AA, 2, pv));
        }
        if (right) {
            load_patch(tile, g, r0, i, j + 1, c, pv);
            fold_add<T, BWD>(p01, window_term<BWD>(mat + AA, 3, pv));
            fold_add<T, BWD>(p11, window_term<BWD>(mat + AA, 6, pv));
        }
        load_patch(tile, g, r0, i, j, c, pv);
        fold_add<T, BWD>(p00, window_term<BWD>(mat, 4, pv));
        fold_add<T, BWD>(p01, window_term<BWD>(mat, 5, pv));
        fold_add<T, BWD>(p10, window_term<BWD>(mat, 7, pv));
        fold_add<T, BWD>(p11, window_term<BWD>(mat, 8, pv));
        T* o = dst + (((size_t)b * g.H + 2 * i) * g.W + 2 * j) * g.C + head * g.d + c;
        o[0] = from_f<T>(p00);
        o[g.C] = from_f<T>(p01);
        o[(size_t)g.W * g.C] = from_f<T>(p10);
        o[(size_t)g.W * g.C + g.C] = from_f<T>(p11);
    }
}

// dlogits half of the backward. grid (row tiles, heads, B); a block takes the
// windows of rows [i0, i1) and a thread one (window, p) row of the matrix.
template <typename T>
__global__ void __launch_bounds__(NT)
outlook_dlogits_kernel(const T* __restrict__ v, const T* __restrict__ logits,
                       const T* __restrict__ gout, T* __restrict__ dlogits, const Geo g,
                       const bool vec) {
    extern __shared__ float smem[];
    const int head = blockIdx.y, b = blockIdx.z;
    const int i0 = blockIdx.x * g.TI;
    const int i1 = min(i0 + g.TI, g.h);
    const int r0 = max(2 * i0 - 1, 0);
    const int r1 = min(2 * i1, g.H);
    const int tile_elems = (2 * g.TI + 1) * g.W * g.DP;
    float* att = smem;
    float* vt = smem + g.TI * g.w * AA;
    float* gt = vt + tile_elems;

    load_logits<T>(logits, att, g, b, head, i0, i1);
    load_tile<T>(v, vt, g, b, head, r0, r1, vec);
    load_tile<T>(gout, gt, g, b, head, r0, r1, vec);
    __syncthreads();
    const int nwin = (i1 - i0) * g.w;
    softmax_rows(att, nwin * KK);
    __syncthreads();

    for (int t = threadIdx.x; t < nwin * KK; t += NT) {
        const int win = t / KK, p = t - win * KK;
        const int i = i0 + win / g.w, j = win % g.w;
        float* a = att + t * KK;                 // row p of this window's matrix
        const int gy = 2 * i - 1 + p / 3, gx = 2 * j - 1 + p % 3;
        float datt[KK];
#pragma unroll
        for (int q = 0; q < KK; ++q) datt[q] = 0.f;
        if (gy >= 0 && gy < g.H && gx >= 0 && gx < g.W) {
            const float* grow = gt + ((gy - r0) * g.W + gx) * g.DP;
            int off[KK];                         // patch rows, -1 outside the map
#pragma unroll
            for (int q = 0; q < KK; ++q) {
                const int yy = 2 * i - 1 + q / 3, xx = 2 * j - 1 + q % 3;
                off[q] = (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
                             ? ((yy - r0) * g.W + xx) * g.DP : -1;
            }
            for (int c = 0; c < g.d; ++c) {
                const float gv = grow[c];
#pragma unroll
                for (int q = 0; q < KK; ++q)
                    if (off[q] >= 0) datt[q] = fmaf(gv, vt[off[q] + c], datt[q]);
            }
        }
        float dot = 0.f;
#pragma unroll
        for (int q = 0; q < KK; ++q) dot = fmaf(datt[q], a[q], dot);
#pragma unroll
        for (int q = 0; q < KK; ++q) a[q] = a[q] * (datt[q] - dot) * g.scale;
    }
    __syncthreads();

    const size_t base = ((size_t)b * g.h + i0) * g.w;
    for (int e = threadIdx.x; e < nwin * AA; e += NT) {
        const int win = e / AA, k = e - win * AA;
        dlogits[((base + win) * g.heads + head) * AA + k] = from_f<T>(att[e]);
    }
}

// K3 / K4: softmax + attend on unfolded patches. grid (window tiles, B).
// patches [B, n, 9, C], logits [B, n, 9, 9, heads] -> out [B, 9, n, C].
template <typename T, bool HEAD_MINOR>
__global__ void __launch_bounds__(NT)
outlook_attend_kernel(const T* __restrict__ patches, const T* __restrict__ logits,
                      T* __restrict__ out, int n, int C, int heads, int TW, float scale) {
    extern __shared__ float att[];               // [TW][9 p][9 q][heads]
    const int b = blockIdx.y;
    const int n0 = blockIdx.x * TW;
    const int nw = min(TW, n - n0);
    const int per = AA * heads;
    const int d = C / heads;

    const T* lg = logits + ((size_t)b * n + n0) * per;
    for (int e = threadIdx.x; e < nw * per; e += NT) att[e] = to_f(lg[e]) * scale;
    __syncthreads();
    for (int t = threadIdx.x; t < nw * KK * heads; t += NT) {   // (win, p, head)
        const int hd = t % heads, wp = t / heads;
        float* a = att + wp * KK * heads + hd;                  // stride heads over q
        float m = a[0];
#pragma unroll
        for (int q = 1; q < KK; ++q) m = fmaxf(m, a[q * heads]);
        float e[KK], s = 0.f;
#pragma unroll
        for (int q = 0; q < KK; ++q) { e[q] = expf(a[q * heads] - m); s += e[q]; }
#pragma unroll
        for (int q = 0; q < KK; ++q) a[q * heads] = e[q] / s;
    }
    __syncthreads();

    for (int t = threadIdx.x; t < nw * C; t += NT) {            // (win, c)
        const int win = t / C, c = t - win * C;
        const int hd = HEAD_MINOR ? c % heads : c / d;
        const T* pr = patches + (((size_t)b * n + n0 + win) * KK) * C + c;
        float pv[KK];
#pragma unroll
        for (int q = 0; q < KK; ++q) pv[q] = to_f(pr[(size_t)q * C]);
        const float* a = att + win * per + hd;
#pragma unroll
        for (int p = 0; p < KK; ++p) {
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < KK; ++q) acc = fmaf(a[(p * KK + q) * heads], pv[q], acc);
            out[(((size_t)b * KK + p) * n + n0 + win) * C + c] = from_f<T>(acc);
        }
    }
}

// ------------------------------------------------------ K2 on streamed rows

constexpr int AHEAD = 1;               // steps whose copies are in flight
constexpr int RING = 5 + 2 * AHEAD;    // map-row slots of the gathered map (v / g)
constexpr int VRING = 3 + 2 * AHEAD;   // v-row slots of the backward's datt
constexpr int RAWS = 1 + AHEAD;        // logits staging slots
constexpr int MSTRIDE = 84;  // floats per stored 9 x 9 matrix (16-byte aligned)
constexpr int NT_MAX = 512;  // threads per block at most
constexpr int MIN_BLOCKS = 1;   // blocks an SM must hold (bounds the registers)

// n / m for 0 <= n < 2^24 and 0 < m < 2^16 by a multiplication: magic =
// ceil(2^40 / m) is exact there, and no division runs in the kernels
struct Div {
    unsigned long long magic;
    int m;
    __device__ __forceinline__ int div(int n) const {
        return (int)(((unsigned long long)(unsigned)n * magic) >> 40);
    }
};

Div make_div(int m) { return {((1ull << 40) + (unsigned long long)m - 1) / (unsigned long long)m, m}; }

// One launch of the streamed kernels. An item is (image, run of window rows,
// head group); a block walks down its run one quad row a step.
struct Stream {
    int B, H, W, C, heads, d, h, w;
    int G;        // heads per block
    int R;        // window rows per run
    int items;
    int PB;       // bytes of one pixel's channels of the head group
    int SLOT;     // bytes of a map-row slot: W + 1 pixels, the first one zero
    int WS;       // bytes of one window's logits span in the staging slot
    int CG;       // groups of VB bytes (the channels a thread owns) in a head group
    int JS;       // quads of a row one pass of the block covers
    int probs, raw;   // byte offsets of the shared-memory areas
    float scale;
    Div per_img, per_run, cpc, chw, g9, g81, g;   // items per image, head groups,
    // chunks per pixel, chunks per window, rows, values and heads per window
};

// A thread's channels of a quad: VB bytes of T, CPT values
constexpr int VB = 16;
template <typename T> constexpr int CPT = VB / (int)sizeof(T);

template <typename T> __device__ __forceinline__ void load_vec(const unsigned char* p, float* f) {
    uint32_t w[VB / 4];
    if constexpr (VB == 8) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        w[0] = u.x; w[1] = u.y;
    } else {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    }
#pragma unroll
    for (int k = 0; k < VB / 4; ++k) {
        if constexpr (sizeof(T) == 4) {
            f[k] = __uint_as_float(w[k]);
        } else {
            f[2 * k] = unpack_lo(w[k]);
            f[2 * k + 1] = unpack_hi(w[k]);
        }
    }
}

template <typename T> __device__ __forceinline__ void store_vec(T* p, const float* f) {
    uint32_t w[VB / 4];
#pragma unroll
    for (int k = 0; k < VB / 4; ++k)
        w[k] = sizeof(T) == 4 ? __float_as_uint(f[k]) : pack2f(f[2 * k], f[2 * k + 1]);
    if constexpr (VB == 8)
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Map row r of image b, head group from channel head g0 on, into a ring
// slot by 16-byte cp.async; row -1 (above the map) is a slot of zeros.
template <typename T>
__device__ __forceinline__ void fetch_row(unsigned char* slot, const T* __restrict__ map,
                                          const Stream& s, int b, int g0, int r) {
    const int tid = threadIdx.x, nt = blockDim.x;
    if (r < 0) {
        for (int e = tid; e < s.SLOT / 16; e += nt)
            reinterpret_cast<uint4*>(slot)[e] = make_uint4(0u, 0u, 0u, 0u);
        return;
    }
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        map + ((size_t)b * s.H + r) * s.W * s.C + (size_t)g0 * s.d);
    const int n = s.W * s.cpc.m;
    for (int e = tid; e < n; e += nt) {
        const int x = s.cpc.div(e), c = e - x * s.cpc.m;
        cp_async16(slot + (x + 1) * s.PB + 16 * c, src + (size_t)x * s.C * sizeof(T) + 16 * c);
    }
}

// byte address of window (b, i, j)'s logits of the head group
template <typename T>
__device__ __forceinline__ uintptr_t logits_span(const T* logits, const Stream& s, int b, int i,
                                                 int j, int g0) {
    return reinterpret_cast<uintptr_t>(
        logits + ((((size_t)b * s.h + i) * s.w + j) * s.heads + g0) * AA);
}

// Window row i's logits of the head group into the staging slot: window j's
// span (G * 81 values, only T-aligned) as the 16-byte chunks that hold it,
// at j * WS, so the span starts (address & 15) bytes in.
template <typename T>
__device__ __forceinline__ void fetch_logits(unsigned char* raw, const T* __restrict__ logits,
                                             const Stream& s, int b, int i, int g0) {
    const int tid = threadIdx.x, nt = blockDim.x, CH = s.chw.m;
    const int L = s.G * AA * (int)sizeof(T);
    const int n = s.w * CH;
    for (int e = tid; e < n; e += nt) {
        const int j = s.chw.div(e), c = e - j * CH;
        const uintptr_t span = logits_span(logits, s, b, i, j, g0);
        const uintptr_t a = (span & ~(uintptr_t)15) + 16 * c;
        if (a < span + L)
            cp_async16(raw + j * s.WS + 16 * c, reinterpret_cast<const void*>(a));
    }
}

// A stored matrix keeps row r's first 8 entries at 8 r and the ninth at
// 72 + r: a row is two float4 and one float. The forward stores att (rows
// p), the backward att^T (rows q), so both gathers read rows.
__device__ __forceinline__ int mat_at(int r, int c) { return c < 8 ? 8 * r + c : 72 + r; }

// softmax over q of f32(logits) * scale for every (window, head, p) row of
// window row i, from the staging slot into `probs` (transposed when TRANS).
// bf16: exp as one fma and ex2.approx with log2(e) in the scale, one
// reciprocal a row; f32 keeps expf and a division (its tolerance is 2^-20).
template <typename T, bool TRANS>
__device__ __forceinline__ void softmax_row(float* probs, const unsigned char* raw,
                                            const T* logits, const Stream& s, int b, int i,
                                            int g0) {
    const int tid = threadIdx.x, nt = blockDim.x, n = s.w * s.g9.m;
    for (int e = tid; e < n; e += nt) {
        const int j = s.g9.div(e), rest = e - j * s.g9.m;
        const int gg = rest / KK, p = rest - KK * gg;
        const T* x = reinterpret_cast<const T*>(
                         raw + j * s.WS + (logits_span(logits, s, b, i, j, g0) & 15)) +
                     (gg * KK + p) * KK;
        float a[KK];
#pragma unroll
        for (int q = 0; q < KK; ++q) a[q] = to_f(x[q]);
        if constexpr (sizeof(T) == 2) {
            const float s2 = s.scale * LOG2E;
            float hi = a[0], lo = a[0];
#pragma unroll
            for (int q = 1; q < KK; ++q) { hi = fmaxf(hi, a[q]); lo = fminf(lo, a[q]); }
            const float mb = (s2 >= 0.f ? hi : lo) * s2;
            float z = 0.f;
#pragma unroll
            for (int q = 0; q < KK; ++q) { a[q] = fast_exp2(fmaf(a[q], s2, -mb)); z += a[q]; }
            const float rz = 1.f / z;
#pragma unroll
            for (int q = 0; q < KK; ++q) a[q] *= rz;
        } else {
#pragma unroll
            for (int q = 0; q < KK; ++q) a[q] *= s.scale;
            float m = a[0];
#pragma unroll
            for (int q = 1; q < KK; ++q) m = fmaxf(m, a[q]);
            float z = 0.f;
#pragma unroll
            for (int q = 0; q < KK; ++q) { a[q] = expf(a[q] - m); z += a[q]; }
#pragma unroll
            for (int q = 0; q < KK; ++q) a[q] /= z;
        }
        float* M = probs + (j * s.G + gg) * MSTRIDE;
#pragma unroll
        for (int q = 0; q < KK; ++q) M[TRANS ? mat_at(q, p) : mat_at(p, q)] = a[q];
    }
}

// two values rounded to T in place by one conversion (bf16: one cvt.rn.bf16x2)
template <typename T> __device__ __forceinline__ void round2(float& x0, float& x1) {
    if constexpr (sizeof(T) == 2) {
        const uint32_t w = pack2f(x0, x1);
        x0 = unpack_lo(w);
        x1 = unpack_hi(w);
    }
}

// One window's share of a quad: for each of its NR positions k (pixel P of
// the quad), sum_q M[k][q] * patch[q] over the thread's CPT channels. The
// forward adds the products straight into the pixel's f32 sum; the backward
// sums the term, rounds it to T and adds it in T, as the plain fold does.
template <typename T, bool BWD, int NR, int K0, int P0, int K1 = 0, int P1 = 0, int K2 = 0,
          int P2 = 0, int K3 = 0, int P3 = 0>
__device__ __forceinline__ void window_pass(float (&acc)[4][CPT<T>],
                                            const unsigned char* const* rows, int xoff, int PB,
                                            const float* M) {
    constexpr int N = CPT<T>;
    constexpr int ks[4] = {K0, K1, K2, K3}, ps[4] = {P0, P1, P2, P3};
    float a[NR][KK];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
        const float4 u0 = *reinterpret_cast<const float4*>(M + 8 * ks[r]);
        const float4 u1 = *reinterpret_cast<const float4*>(M + 8 * ks[r] + 4);
        a[r][0] = u0.x; a[r][1] = u0.y; a[r][2] = u0.z; a[r][3] = u0.w;
        a[r][4] = u1.x; a[r][5] = u1.y; a[r][6] = u1.z; a[r][7] = u1.w;
        a[r][8] = M[72 + ks[r]];
    }
    float t[BWD ? NR : 1][N];
    if (BWD) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
            for (int c = 0; c < N; ++c) t[r][c] = 0.f;
    }
#pragma unroll
    for (int qy = 0; qy < 3; ++qy) {
        const unsigned char* rp = rows[qy] + xoff;
#pragma unroll
        for (int qx = 0; qx < 3; ++qx) {
            float v[N];
            load_vec<T>(rp + qx * PB, v);
#pragma unroll
            for (int r = 0; r < NR; ++r)
#pragma unroll
                for (int c = 0; c < N; ++c) {
                    if (BWD)
                        t[BWD ? r : 0][c] = fmaf(a[r][3 * qy + qx], v[c], t[BWD ? r : 0][c]);
                    else
                        acc[ps[r]][c] = fmaf(a[r][3 * qy + qx], v[c], acc[ps[r]][c]);
                }
        }
    }
    if (BWD) {
#pragma unroll
        for (int r = 0; r < NR; ++r)
#pragma unroll
            for (int c = 0; c < N; c += 2) {
                float t0 = t[BWD ? r : 0][c], t1 = t[BWD ? r : 0][c + 1];
                round2<T>(t0, t1);
                float& a0 = acc[ps[r]][c];
                float& a1 = acc[ps[r]][c + 1];
                a0 += t0;
                a1 += t1;
                round2<T>(a0, a1);
            }
    }
}

// The quads of quad row i (pixels 2i, 2i+1): a thread owns CPT channels of
// one quad and gathers from the four windows that cover it, A = (i, j) at
// its positions 4, 5, 7, 8, B = (i, j+1) at 3, 6, C = (i+1, j) at 1, 2 and
// D = (i+1, j+1) at 0, in the order D, C, B, A: for every pixel the fold's
// (ky, kx) order. `rows` are the ring slots of map rows 2i-1 .. 2i+3 and Mi,
// Mi1 the stored matrices of window rows i and i+1.
template <typename T, bool BWD>
__device__ __forceinline__ void gather_row(T* __restrict__ dst, const unsigned char* const* rows,
                                           const float* Mi, const float* Mi1, const Stream& s,
                                           int b, int i, int g0, int cg, int jq) {
    constexpr int N = CPT<T>;
    const int gg = (cg * N) / s.d;    // the head of the channels, in the group
    const bool down = i + 1 < s.h;
    for (int j = jq; j < s.w; j += s.JS) {
        const bool right = j + 1 < s.w;
        const int xoff = 2 * j * s.PB + VB * cg;
        const float* MA = Mi + (j * s.G + gg) * MSTRIDE;
        const float* MC = Mi1 + (j * s.G + gg) * MSTRIDE;
        float acc[4][N];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int c = 0; c < N; ++c) acc[p][c] = 0.f;
        if (down && right)
            window_pass<T, BWD, 1, 0, 3>(acc, rows + 2, xoff + 2 * s.PB, s.PB,
                                         MC + s.G * MSTRIDE);
        if (down) window_pass<T, BWD, 2, 1, 2, 2, 3>(acc, rows + 2, xoff, s.PB, MC);
        if (right)
            window_pass<T, BWD, 2, 3, 1, 6, 3>(acc, rows, xoff + 2 * s.PB, s.PB,
                                               MA + s.G * MSTRIDE);
        if (BWD) {
            window_pass<T, BWD, 2, 4, 0, 5, 1>(acc, rows, xoff, s.PB, MA);
            window_pass<T, BWD, 2, 7, 2, 8, 3>(acc, rows, xoff, s.PB, MA);
        } else {
            window_pass<T, BWD, 4, 4, 0, 5, 1, 7, 2, 8, 3>(acc, rows, xoff, s.PB, MA);
        }
        T* o = dst + (((size_t)b * s.H + 2 * i) * s.W + 2 * j) * s.C + (size_t)g0 * s.d + cg * N;
        store_vec<T>(o, acc[0]);
        store_vec<T>(o + s.C, acc[1]);
        store_vec<T>(o + (size_t)s.W * s.C, acc[2]);
        store_vec<T>(o + (size_t)s.W * s.C + s.C, acc[3]);
    }
}

// ds and dlogits of one (window, head) matrix row p from its datt row:
// ds = att * (datt - sum_q datt * att), written as T(ds * scale).
// datt[p][q] = sum_c g[pixel p][c] * v[pixel q][c] over the head's channels.
//
// bf16: one warp a (window, head), on the tensor cores: A = g rows
// (p = 0..8, zero rows to 16), B = v rows (q = 0..8, zero to 16), K = d in
// steps of 16, both by ldmatrix straight from the ring slots (a lane gives
// the address of a pixel's 16 bytes; past the 9 pixels or past d it points
// at a zero pixel). Products of bf16 values are exact in f32; only the order
// of the f32 sum differs from the plain einsum.
//
// A warp keeps DT (window, head) tasks in flight: their ldmatrix are issued
// together and their mma after them, since one task's chain of loads, two
// dependent products, shuffles and stores would leave the warp waiting.
constexpr int DT = 2;

__device__ __forceinline__ void datt_mma(bf16* stage, const unsigned char* const* grows,
                                         const unsigned char* const* vrows,
                                         const unsigned char* zero, const float* Mi,
                                         const Stream& s, float scale) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int pa = (lane & 7) + 8 * ((lane >> 3) & 1), ka = 8 * (lane >> 4);
    const int nb = (lane & 7) + 8 * (lane >> 4), kb = 8 * ((lane >> 3) & 1);
    const int g = lane >> 2, t = lane & 3;
    // the lane's pixel: A row p = pa of the g patch, B row q = nb of the v patch
    const unsigned char* abase =
        pa < KK ? (pa < 3 ? grows[0] : pa < 6 ? grows[1] : grows[2]) + (pa % 3) * s.PB
                : nullptr;
    const unsigned char* bbase =
        nb < KK ? (nb < 3 ? vrows[0] : nb < 6 ? vrows[1] : vrows[2]) + (nb % 3) * s.PB
                : nullptr;
    const int ntask = s.w * s.G;
    const int qs[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
    for (int t0 = warp; t0 < ntask; t0 += nw * DT) {
        int off[DT], task[DT];
        float c[DT][2][4];
#pragma unroll
        for (int u = 0; u < DT; ++u) {
            task[u] = t0 + u * nw;
            const int j = s.g.div(task[u]), gg = task[u] - j * s.G;
            off[u] = 2 * j * s.PB + gg * s.d * 2;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) c[u][n][e] = 0.f;
        }
        for (int k0 = 0; k0 < s.d; k0 += 16) {
            uint32_t a[DT][4], b[DT][4];
#pragma unroll
            for (int u = 0; u < DT; ++u) {
                const bool ok = task[u] < ntask;
                const unsigned char* ap =
                    ok && abase && k0 + ka < s.d ? abase + off[u] + 2 * (k0 + ka) : zero;
                const unsigned char* bp =
                    ok && bbase && k0 + kb < s.d ? bbase + off[u] + 2 * (k0 + kb) : zero;
                ldsm_x4(a[u], reinterpret_cast<const bf16*>(ap));
                ldsm_x4(b[u], reinterpret_cast<const bf16*>(bp));
            }
#pragma unroll
            for (int u = 0; u < DT; ++u) {
                mma_bf16(c[u][0], a[u], b[u][0], b[u][1]);
                mma_bf16(c[u][1], a[u], b[u][2], b[u][3]);
            }
        }
        // this lane: rows g and g + 8, columns 2t, 2t+1, 8+2t, 9+2t
#pragma unroll
        for (int u = 0; u < DT; ++u) {
            const float* M = Mi + task[u] * MSTRIDE;   // att^T: att[p][q] at mat_at(q, p)
            const float dv[2][4] = {{c[u][0][0], c[u][0][1], c[u][1][0], c[u][1][1]},
                                    {c[u][0][2], c[u][0][3], c[u][1][2], c[u][1][3]}};
            const bool ok = task[u] < ntask;
            float at[2][4], dot[2];
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
                const int p = g + 8 * h2;
                dot[h2] = 0.f;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    at[h2][k] = ok && p < KK && qs[k] < KK ? M[mat_at(qs[k], p)] : 0.f;
                    dot[h2] = fmaf(dv[h2][k], at[h2][k], dot[h2]);
                }
                dot[h2] += __shfl_xor_sync(0xffffffffu, dot[h2], 1);
                dot[h2] += __shfl_xor_sync(0xffffffffu, dot[h2], 2);
            }
            if (!ok) continue;
            bf16* out = stage + task[u] * AA;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
                const int p = g + 8 * h2;
                if (p >= KK) continue;
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (qs[k] < KK)
                        out[p * KK + qs[k]] =
                            from_f<bf16>(at[h2][k] * (dv[h2][k] - dot[h2]) * scale);
            }
        }
    }
}

// f32: a thread a (window, head, p) row, on the f32 pipe, 4 channels a load
__device__ __forceinline__ void datt_rows(float* stage, const unsigned char* const* grows,
                                          const unsigned char* const* vrows, const float* Mi,
                                          const Stream& s, float scale) {
    const int n = s.w * s.g9.m;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int j = s.g9.div(e), rest = e - j * s.g9.m;
        const int gg = rest / KK, p = rest - KK * gg;
        const int hoff = gg * s.d * 4;
        const float* gp = reinterpret_cast<const float*>(grows[p / 3] + (2 * j + p % 3) * s.PB +
                                                         hoff);
        const float* vq[KK];
#pragma unroll
        for (int q = 0; q < KK; ++q)
            vq[q] = reinterpret_cast<const float*>(vrows[q / 3] + (2 * j + q % 3) * s.PB + hoff);
        float da[KK];
#pragma unroll
        for (int q = 0; q < KK; ++q) da[q] = 0.f;
        for (int c = 0; c < s.d; c += 4) {
            const float4 gv = *reinterpret_cast<const float4*>(gp + c);
#pragma unroll
            for (int q = 0; q < KK; ++q) {
                const float4 vv = *reinterpret_cast<const float4*>(vq[q] + c);
                da[q] = fmaf(gv.x, vv.x, da[q]);
                da[q] = fmaf(gv.y, vv.y, da[q]);
                da[q] = fmaf(gv.z, vv.z, da[q]);
                da[q] = fmaf(gv.w, vv.w, da[q]);
            }
        }
        const float* M = Mi + (j * s.G + gg) * MSTRIDE;
        float at[KK], dot = 0.f;
#pragma unroll
        for (int q = 0; q < KK; ++q) {
            at[q] = M[mat_at(q, p)];
            dot = fmaf(da[q], at[q], dot);
        }
        float* out = stage + (j * s.G + gg) * AA + p * KK;
#pragma unroll
        for (int q = 0; q < KK; ++q) out[q] = at[q] * (da[q] - dot) * scale;
    }
}

// staged dlogits of window row i ([window][G * 81], as in device memory)
// out, each window's span at its head group's place: consecutive threads
// store consecutive values
template <typename T>
__device__ __forceinline__ void store_dlogits(T* __restrict__ dlogits, const T* stage,
                                              const Stream& s, int b, int i, int g0) {
    const int n = s.w * s.g81.m;
    T* row = dlogits + (((size_t)b * s.h + i) * s.w * s.heads + g0) * AA;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int j = s.g81.div(e);
        row[(size_t)j * (s.heads - s.G) * AA + e] = stage[e];
    }
}

struct Item {
    int b, i0, i1, g0;
};

__device__ __forceinline__ Item item_of(const Stream& s, int item) {
    const int b = s.per_img.div(item), rest = item - b * s.per_img.m;
    const int run = s.per_run.div(rest), hg = rest - run * s.per_run.m;
    const int i0 = run * s.R;
    return {b, i0, min(s.h, i0 + s.R), hg * s.G};
}

// ring slots of map rows 2i-1 .. 2i+3 (of a ring of N slots from row r0)
template <int N>
__device__ __forceinline__ void ring_rows(const unsigned char* (&rows)[5],
                                          const unsigned char* ring, const Stream& s, int i,
                                          int r0, int count) {
#pragma unroll
    for (int u = 0; u < 5; ++u)
        rows[u] = u < count ? ring + ((2 * i - 1 + u - r0) % N) * s.SLOT : ring;
}

// K2 forward. Persistent blocks take items (image, run, head group); a block
// walks down its run a quad row a step. Step i: the softmax of window row
// i+1 (its logits already staged), a barrier, cp.async of what step
// i+AHEAD needs (map rows 2(i+AHEAD)+2, +3 and the logits of window row
// i+AHEAD+1), the gather of quad row i out of map rows 2i-1 .. 2i+3, then
// a wait for the copies of step i+1 and a barrier.
template <typename T>
__global__ void __launch_bounds__(NT_MAX, MIN_BLOCKS)
outlook_fwd_rows(const T* __restrict__ v, const T* __restrict__ logits, T* __restrict__ out,
                 const Stream s) {
    extern __shared__ __align__(16) unsigned char row_smem[];
    unsigned char* smem = row_smem;
    unsigned char* ring = smem;
    float* probs = reinterpret_cast<float*>(smem + s.probs);
    unsigned char* raw = smem + s.raw;
    const int pslot = s.w * s.G * MSTRIDE, rslot = s.w * s.WS;
    const int cg = threadIdx.x % s.CG, jq = threadIdx.x / s.CG;
    for (int k = 0; k < RING; ++k)     // the zero pixel left of every row
        for (int e = threadIdx.x; e < s.PB / 16; e += blockDim.x)
            reinterpret_cast<uint4*>(ring + k * s.SLOT)[e] = make_uint4(0u, 0u, 0u, 0u);
    for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
        const Item it = item_of(s, item);
        const int r0 = 2 * it.i0 - 1;
        const int rmax = it.i1 < s.h ? 2 * it.i1 + 1 : s.H - 1;
        // one commit group a step: the rows step k adds to step k-1's and
        // the logits of window row k+1 (the first step: all of its own)
        auto fetch_step = [&](int k) {
            for (int r = k == it.i0 ? r0 : 2 * k + 2; r <= min(2 * k + 3, rmax); ++r)
                fetch_row<T>(ring + ((r - r0) % RING) * s.SLOT, v, s, it.b, it.g0, r);
            for (int l = k == it.i0 ? k : k + 1; l <= min(k + 1, it.i1); ++l)
                if (l < s.h) fetch_logits<T>(raw + (l % RAWS) * rslot, logits, s, it.b, l, it.g0);
            cp_async_commit();
        };
        for (int k = it.i0; k < it.i0 + AHEAD; ++k) fetch_step(k);
        cp_async_wait<AHEAD - 1>();
        __syncthreads();
        softmax_row<T, false>(probs + (it.i0 & 1) * pslot, raw + (it.i0 % RAWS) * rslot, logits,
                              s, it.b, it.i0, it.g0);
        for (int i = it.i0; i < it.i1; ++i) {
            const bool down = i + 1 < s.h;
            if (down)
                softmax_row<T, false>(probs + ((i + 1) & 1) * pslot,
                                      raw + ((i + 1) % RAWS) * rslot, logits, s, it.b, i + 1,
                                      it.g0);
            __syncthreads();
            fetch_step(i + AHEAD);
            if (jq < s.JS) {
                const unsigned char* rows[5];
                ring_rows<RING>(rows, ring, s, i, r0, down ? 5 : 3);
                gather_row<T, false>(out, rows, probs + (i & 1) * pslot,
                                     probs + ((i + 1) & 1) * pslot, s, it.b, i, it.g0, cg, jq);
            }
            cp_async_wait<AHEAD - 1>();
            __syncthreads();
        }
        cp_async_wait<0>();
    }
}

// K2 backward, one kernel, on the same stream of rows with v rows beside
// the g rows. Step i: the softmax of window row i+1 stored transposed; then,
// while the copies of step i+AHEAD are in flight, the dv gather of quad row
// i on g (att^T, a rounding after every term) and datt, ds and dlogits of
// window row i (v and g rows 2i-1 .. 2i+1). v, g and the logits are read
// once per run, dv and dlogits written once.
template <typename T>
__global__ void __launch_bounds__(NT_MAX, MIN_BLOCKS)
outlook_bwd_rows(const T* __restrict__ v, const T* __restrict__ logits,
                 const T* __restrict__ gout, T* __restrict__ dv, T* __restrict__ dlogits,
                 const Stream s) {
    extern __shared__ __align__(16) unsigned char row_smem[];
    unsigned char* smem = row_smem;
    unsigned char* gring = smem;
    unsigned char* vring = smem + RING * s.SLOT;
    float* probs = reinterpret_cast<float*>(smem + s.probs);
    unsigned char* raw = smem + s.raw;
    const int pslot = s.w * s.G * MSTRIDE, rslot = s.w * s.WS;
    const int cg = threadIdx.x % s.CG, jq = threadIdx.x / s.CG;
    for (int k = 0; k < RING + VRING; ++k)     // vring follows gring
        for (int e = threadIdx.x; e < s.PB / 16; e += blockDim.x)
            reinterpret_cast<uint4*>(gring + k * s.SLOT)[e] = make_uint4(0u, 0u, 0u, 0u);
    for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
        const Item it = item_of(s, item);
        const int r0 = 2 * it.i0 - 1;
        const int rmax = it.i1 < s.h ? 2 * it.i1 + 1 : s.H - 1;
        const int vmax = 2 * it.i1 - 1;
        auto fetch_step = [&](int k) {
            for (int r = k == it.i0 ? r0 : 2 * k + 2; r <= min(2 * k + 3, rmax); ++r)
                fetch_row<T>(gring + ((r - r0) % RING) * s.SLOT, gout, s, it.b, it.g0, r);
            for (int r = k == it.i0 ? r0 : 2 * k; r <= min(2 * k + 1, vmax); ++r)
                fetch_row<T>(vring + ((r - r0) % VRING) * s.SLOT, v, s, it.b, it.g0, r);
            for (int l = k == it.i0 ? k : k + 1; l <= min(k + 1, it.i1); ++l)
                if (l < s.h) fetch_logits<T>(raw + (l % RAWS) * rslot, logits, s, it.b, l, it.g0);
            cp_async_commit();
        };
        for (int k = it.i0; k < it.i0 + AHEAD; ++k) fetch_step(k);
        cp_async_wait<AHEAD - 1>();
        __syncthreads();
        softmax_row<T, true>(probs + (it.i0 & 1) * pslot, raw + (it.i0 % RAWS) * rslot, logits,
                             s, it.b, it.i0, it.g0);
        for (int i = it.i0; i < it.i1; ++i) {
            const bool down = i + 1 < s.h;
            if (i > it.i0)
                store_dlogits<T>(dlogits, reinterpret_cast<const T*>(raw + (i % RAWS) * rslot), s,
                                 it.b, i - 1, it.g0);
            if (down)
                softmax_row<T, true>(probs + ((i + 1) & 1) * pslot,
                                     raw + ((i + 1) % RAWS) * rslot, logits, s, it.b, i + 1,
                                     it.g0);
            __syncthreads();
            fetch_step(i + AHEAD);
            const unsigned char* grows[5];
            const unsigned char* vrows[5];
            ring_rows<RING>(grows, gring, s, i, r0, down ? 5 : 3);
            ring_rows<VRING>(vrows, vring, s, i, r0, 3);
            const float* Mi = probs + (i & 1) * pslot;
            // window row i's dlogits into the staging slot that row i+1's
            // logits have left; the next step stores them
            T* stage = reinterpret_cast<T*>(raw + ((i + 1) % RAWS) * rslot);
            if (jq < s.JS)
                gather_row<T, true>(dv, grows, Mi, probs + ((i + 1) & 1) * pslot, s, it.b, i,
                                    it.g0, cg, jq);
            if constexpr (sizeof(T) == 2) {
                datt_mma(stage, grows, vrows, gring, Mi, s, s.scale);
            } else {
                datt_rows(stage, grows, vrows, Mi, s, s.scale);
            }
            cp_async_wait<AHEAD - 1>();
            __syncthreads();
        }
        store_dlogits<T>(dlogits, reinterpret_cast<const T*>(raw + (it.i1 % RAWS) * rslot), s,
                         it.b, it.i1 - 1, it.g0);
        cp_async_wait<0>();
        __syncthreads();
    }
}

// ------------------------------------------------ launchers of the general path

bool bad_map(int B, int H, int W, int C, int heads) {
    return B < 1 || B > 65535 || H < 2 || W < 2 || (H & 1) || (W & 1) || heads < 1 ||
           heads > 65535 || C < heads || C % heads != 0;
}

size_t gather_smem(const Geo& g, int TI) {
    return ((size_t)(TI + 1) * g.w * AA + (size_t)(2 * TI + 3) * g.W * g.DP) * sizeof(float);
}

size_t dlogits_smem(const Geo& g, int TI) {
    return ((size_t)TI * g.w * AA + 2 * (size_t)(2 * TI + 1) * g.W * g.DP) * sizeof(float);
}

// Largest row tile within the two-blocks-per-SM budget; failing that the
// largest that fits a block at all; 0 when not even one window row fits.
template <typename F> int pick_tile(const Geo& g, F smem_of) {
    int best = 0;
    for (int t = 1; t <= g.h; ++t)
        if (smem_of(g, t) <= (size_t)kSmemTwoPerSM) best = t;
    if (best) return best;
    for (int t = 1; t <= g.h; ++t)
        if (smem_of(g, t) <= SMEM_LIMIT) best = t;
    return best;
}

// 16-byte loads of a head's channels need d and C in whole vectors and
// 16-byte aligned bases
template <typename T> bool can_vec(const Geo& g, const void* a, const void* b = nullptr) {
    constexpr int N = 16 / (int)sizeof(T);
    return g.d % N == 0 && g.C % N == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

Geo make_geo(int B, int H, int W, int C, int heads, float scale) {
    Geo g;
    g.B = B; g.H = H; g.W = W; g.C = C; g.heads = heads; g.d = C / heads;
    g.h = H / 2; g.w = W / 2; g.TI = 0; g.DP = g.d | 1; g.scale = scale;
    return g;
}

template <typename T, bool BWD>
int launch_gather(const void* src, const void* logits, void* dst, Geo g, cudaStream_t s) {
    g.TI = pick_tile(g, gather_smem);
    if (g.TI == 0) return kBadShape;
    const size_t smem = gather_smem(g, g.TI);
    cudaError_t err = cudaFuncSetAttribute(outlook_gather_kernel<T, BWD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((g.h + g.TI - 1) / g.TI, g.heads, g.B);
    outlook_gather_kernel<T, BWD><<<grid, NT, smem, s>>>(
        static_cast<const T*>(src), static_cast<const T*>(logits), static_cast<T*>(dst), g,
        can_vec<T>(g, src));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dlogits(const void* v, const void* logits, const void* gout, void* dlogits, Geo g,
                   cudaStream_t s) {
    g.TI = pick_tile(g, dlogits_smem);
    if (g.TI == 0) return kBadShape;
    const size_t smem = dlogits_smem(g, g.TI);
    cudaError_t err = cudaFuncSetAttribute(outlook_dlogits_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((g.h + g.TI - 1) / g.TI, g.heads, g.B);
    outlook_dlogits_kernel<T><<<grid, NT, smem, s>>>(
        static_cast<const T*>(v), static_cast<const T*>(logits), static_cast<const T*>(gout),
        static_cast<T*>(dlogits), g, can_vec<T>(g, v, gout));
    return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* v, const void* logits, const void* gout, void* dv, void* dlogits,
               const Geo& g, cudaStream_t s) {
    int rc = launch_dlogits<T>(v, logits, gout, dlogits, g, s);
    if (rc != 0) return rc;
    return launch_gather<T, true>(gout, logits, dv, g, s);
}

template <typename T, bool HEAD_MINOR>
int launch_attend(const void* patches, const void* logits, void* out, int B, int n, int C,
                  int heads, float scale, cudaStream_t s) {
    const int per_win = AA * heads * (int)sizeof(float);
    int TW = (48 * 1024) / per_win;              // stay inside the static limit
    if (TW < 1) return kBadShape;
    if (TW > 8) TW = 8;
    dim3 grid((n + TW - 1) / TW, B);
    outlook_attend_kernel<T, HEAD_MINOR><<<grid, NT, (size_t)TW * per_win, s>>>(
        static_cast<const T*>(patches), static_cast<const T*>(logits), static_cast<T*>(out), n,
        C, heads, TW, scale);
    return (int)cudaGetLastError();
}


// ------------------------------------------------ launchers of the row stream

constexpr size_t kSmemTwoBlocks = 113 * 1024;   // two blocks (and 1 KB each) share an SM

int sm_count() {
    static int sms[16] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 0;
    if (!sms[dev] && cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) !=
                         cudaSuccess)
        sms[dev] = 0;
    return sms[dev];
}

// The streamed geometry for head groups of G heads; returns the shared
// memory a block needs.
template <typename T>
size_t stream_geo(Stream& s, int B, int H, int W, int C, int heads, int G, float scale,
                  bool bwd) {
    s = Stream{};
    s.B = B; s.H = H; s.W = W; s.C = C; s.heads = heads; s.d = C / heads;
    s.h = H / 2; s.w = W / 2; s.G = G; s.scale = scale;
    s.PB = G * s.d * (int)sizeof(T);
    s.SLOT = (W + 1) * s.PB;
    const int L = G * AA * (int)sizeof(T);
    const int CH = (L + 30) / 16;               // chunks of a span that starts at any T
    s.WS = 16 * CH;
    s.CG = s.PB / VB;
    size_t off = (size_t)(bwd ? RING + VRING : RING) * s.SLOT;
    s.probs = (int)off;
    off += 2 * (size_t)s.w * G * MSTRIDE * sizeof(float);
    s.raw = (int)off;
    off += (size_t)RAWS * s.w * s.WS;
    s.cpc = make_div(s.PB / 16);
    s.chw = make_div(CH);
    s.g9 = make_div(G * KK);
    s.g81 = make_div(G * AA);
    s.g = make_div(G);
    return off;
}

// The row kernels' plan: the largest head group whose block lets two share
// an SM (else the largest that fits one), the threads that cover a quad row
// in the fewest passes, runs of window rows when the images and head groups
// alone would leave SMs idle. False where the streamed kernels do not take the
// shape (a head's channels not a whole number of 16-byte groups, unaligned
// tensors), which the general kernels then take.
template <typename T>
bool plan_stream(Stream& s, size_t& smem, int& threads, int B, int H, int W, int C, int heads,
                 float scale, bool bwd, std::initializer_list<const void*> ptrs) {
    const int d = C / heads;
    if ((d * (int)sizeof(T)) % 16 != 0) return false;
    for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
    int G = 0;
    for (size_t budget : {kSmemTwoBlocks, SMEM_LIMIT}) {
        for (int g = heads; g >= 1 && !G; --g)
            if (heads % g == 0 && stream_geo<T>(s, B, H, W, C, heads, g, scale, bwd) <= budget)
                G = g;
        if (G) break;
    }
    if (!G) return false;
    smem = stream_geo<T>(s, B, H, W, C, heads, G, scale, bwd);
    if (s.CG > NT_MAX || s.SLOT / 16 > (1 << 24)) return false;
    const int passes = (s.w * s.CG + NT_MAX - 1) / NT_MAX;
    s.JS = (s.w + passes - 1) / passes;
    threads = (s.CG * s.JS + 31) / 32 * 32;
    const int HG = heads / G, sms = sm_count();
    int runs = 1;
    if ((long long)B * HG < sms) runs = std::min((sms + B * HG - 1) / (B * HG), std::max(1, s.h / 4));
    s.R = (s.h + runs - 1) / runs;
    runs = (s.h + s.R - 1) / s.R;
    const long long items = (long long)B * runs * HG;
    if (items >= (1 << 24)) return false;
    s.items = (int)items;
    s.per_img = make_div(runs * HG);
    s.per_run = make_div(HG);
    return true;
}

// plan[6] (may be null): route (1 the streamed kernel, 0 the general one),
// heads per block, runs per image, threads, blocks, shared memory. The grid
// is the items, at most the blocks resident on the card.
template <typename K>
int rows_grid(K kernel, bool& allowed, const Stream& s, size_t smem, int threads, int* plan,
              int& blocks) {
    if (!allowed) {     // the limit itself, once per kernel
        const cudaError_t err = allow_smem(kernel, SMEM_LIMIT);
        if (err != cudaSuccess) return (int)err;
        allowed = true;
    }
    int occ = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (occ < 1) return (int)cudaErrorLaunchOutOfResources;
    blocks = std::min(s.items, std::max(1, sm_count()) * occ);
    if (plan) {
        const int vals[6] = {1, s.G, s.items / s.B / (s.heads / s.G), threads, blocks,
                             (int)smem};
        for (int k = 0; k < 6; ++k) plan[k] = vals[k];
    }
    return 0;
}

void general_plan(int* plan) {
    if (plan)
        for (int k = 0; k < 6; ++k) plan[k] = 0;
}

template <typename T>
int launch_fwd(const void* v, const void* logits, void* out, int B, int H, int W, int C,
               int heads, float scale, int general, int* plan, cudaStream_t st) {
    Stream s;
    size_t smem = 0;
    int threads = 0;
    if (!general &&
        plan_stream<T>(s, smem, threads, B, H, W, C, heads, scale, false, {v, out})) {
        static bool allowed = false;
        int blocks = 0;
        const int rc = rows_grid(outlook_fwd_rows<T>, allowed, s, smem, threads, plan, blocks);
        if (rc != 0) return rc;
        outlook_fwd_rows<T><<<blocks, threads, smem, st>>>(
            static_cast<const T*>(v), static_cast<const T*>(logits), static_cast<T*>(out), s);
        return (int)cudaGetLastError();
    }
    general_plan(plan);
    return launch_gather<T, false>(v, logits, out, make_geo(B, H, W, C, heads, scale), st);
}

template <typename T>
int launch_bwd_rows(const void* v, const void* logits, const void* gout, void* dv, void* dlogits,
                    int B, int H, int W, int C, int heads, float scale, int general,
                    int* plan, cudaStream_t st) {
    Stream s;
    size_t smem = 0;
    int threads = 0;
    if (!general &&
        plan_stream<T>(s, smem, threads, B, H, W, C, heads, scale, true, {v, gout, dv})) {
        static bool allowed = false;
        int blocks = 0;
        const int rc = rows_grid(outlook_bwd_rows<T>, allowed, s, smem, threads, plan, blocks);
        if (rc != 0) return rc;
        outlook_bwd_rows<T><<<blocks, threads, smem, st>>>(
            static_cast<const T*>(v), static_cast<const T*>(logits), static_cast<const T*>(gout),
            static_cast<T*>(dv), static_cast<T*>(dlogits), s);
        return (int)cudaGetLastError();
    }
    general_plan(plan);
    return launch_bwd<T>(v, logits, gout, dv, dlogits, make_geo(B, H, W, C, heads, scale), st);
}

}  // namespace

extern "C" {

// Each returns 0 on success, a cudaError_t value, or -1 for a shape the
// kernels do not take. `stream` is a cudaStream_t. dtype: 0 = float32,
// 1 = bfloat16 (v, logits and the outputs share it). K2: `general` = 1
// takes the general kernels at any shape (only the benches' before / after
// column asks for that), and `plan` (int[6] or null) receives the route and
// the launch (see rows_grid).

int outlook_fused_fwd(const void* v, const void* logits, void* out, int B, int H, int W, int C,
                      int heads, float scale, int dtype, int general, int* plan, void* stream) {
    if (bad_map(B, H, W, C, heads) || (dtype != 0 && dtype != 1)) return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_fwd<float>(v, logits, out, B, H, W, C, heads, scale, general, plan, s);
    return launch_fwd<bf16>(v, logits, out, B, H, W, C, heads, scale, general, plan, s);
}

// gout is the gradient of the output, [B, H, W, C]; dv and dlogits are written.
int outlook_fused_bwd(const void* v, const void* logits, const void* gout, void* dv,
                      void* dlogits, int B, int H, int W, int C, int heads, float scale,
                      int dtype, int general, int* plan, void* stream) {
    if (bad_map(B, H, W, C, heads) || (dtype != 0 && dtype != 1)) return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_bwd_rows<float>(v, logits, gout, dv, dlogits, B, H, W, C, heads, scale,
                                      general, plan, s);
    return launch_bwd_rows<bf16>(v, logits, gout, dv, dlogits, B, H, W, C, heads, scale, general,
                                 plan, s);
}

int outlook_attend(const void* patches, const void* logits, void* out, int B, int n, int C,
                   int heads, float scale, int head_minor, int dtype, void* stream) {
    if (B < 1 || B > 65535 || n < 1 || heads < 1 || C < heads || C % heads != 0 ||
        (dtype != 0 && dtype != 1))
        return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return head_minor
                   ? launch_attend<float, true>(patches, logits, out, B, n, C, heads, scale, s)
                   : launch_attend<float, false>(patches, logits, out, B, n, C, heads, scale, s);
    return head_minor ? launch_attend<__nv_bfloat16, true>(patches, logits, out, B, n, C, heads,
                                                           scale, s)
                      : launch_attend<__nv_bfloat16, false>(patches, logits, out, B, n, C, heads,
                                                            scale, s);
}

}  // extern "C"
