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
//
// The Pallas kernel's parity planes, slabs, interleaves and head-minor
// channel permutation exist because Mosaic cannot lower strided slices; none
// of that is carried over. The fold is written as a gather: pixel (y, x)
// receives from the windows i with y + 1 - 2i in {0, 1, 2} (one window for an
// even y, two for an odd y) and the same in x, so every output element is
// owned by one thread, there are no atomics and the result is deterministic.
//
// What bounds it: at [128, 28, 28, 192] bf16 the forward must move 38.5 MB of
// v, 24.4 MB of logits and 38.5 MB of output against 0.4 GFMA, about 4 FMA
// per byte, far below the card's ratio: bytes. The design therefore reads
// every input element once per block and keeps patches, probabilities and
// attended patches out of device memory. A block takes (row tile, head,
// image): the head's d channels of the tile's v rows (with the one-row halo)
// and the softmaxed 9 x 9 matrices of the tile's windows sit in shared
// memory; a thread owns one channel of a 2 x 2 pixel quad and a warp one
// quad, so the probabilities are shared-memory broadcasts, the v reads are
// conflict-free and each window's patch is read once for all its terms. The
// row tile is the largest whose shared memory lets two blocks share an SM, so
// one block's loads overlap the other's arithmetic.
//
// Backward, with dav = unfold(g) and the softmax recomputed from the saved
// logits (only v and logits are saved):
//   datt[p, q]  = sum_d dav[p, (head, d)] * patch[q, (head, d)]      (f32)
//   ds          = att * (datt - sum_q datt * att)
//   dlogits     = T(ds * scale)
//   dpatch[q,c] = T(sum_p att[p, q] * dav[p, c])      rounded before the fold
//   dv          = fold(dpatch), summed in T in (ky, kx) order as the plain
//                 fold sums it
// dlogits is per window and dv per pixel, so the backward is two kernels:
// outlook_dlogits_kernel (a thread owns one (window, p) row of the 9 x 9
// matrix) and the forward's gather kernel run on g with the matrix
// transposed and a rounding after every term. Nothing is accumulated across
// blocks.
//
// The attend (K3 / K4) takes patches that PyTorch already unfolded,
// [B, n, 9, C], and logits [B, n, 9, 9, heads], and writes [B, 9, n, C]: f32
// softmax over q, f32 sum, one rounding. K3 has head-minor channels
// (c' = d_idx * heads + head), K4 head-major; the one-hot matmul of the TPU
// kernel is a TPU device and is not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int KK = 9;                    // window positions (3 x 3)
constexpr int AA = 81;                   // one head's matrix of one window
constexpr int kBadShape = -1;
constexpr int kSmemTwoPerSM = 100 * 1024;   // budget that lets two blocks share an SM
constexpr int kSmemMax = 227 * 1024;        // most a block can ask for

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);  // round to nearest even, as .to(dtype) does
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f<T>(from_f<T>(x));
}

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

// ---------------------------------------------------------------- launchers

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
        if (smem_of(g, t) <= (size_t)kSmemMax) best = t;
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

}  // namespace

extern "C" {

// Each returns 0 on success, a cudaError_t value, or -1 for a shape the
// kernels do not take. `stream` is a cudaStream_t. dtype: 0 = float32,
// 1 = bfloat16 (v, logits and the outputs share it).

int outlook_fused_fwd(const void* v, const void* logits, void* out, int B, int H, int W, int C,
                      int heads, float scale, int dtype, void* stream) {
    if (bad_map(B, H, W, C, heads) || (dtype != 0 && dtype != 1)) return kBadShape;
    const Geo g = make_geo(B, H, W, C, heads, scale);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_gather<float, false>(v, logits, out, g, s);
    return launch_gather<__nv_bfloat16, false>(v, logits, out, g, s);
}

// gout is the gradient of the output, [B, H, W, C]; dv and dlogits are written.
int outlook_fused_bwd(const void* v, const void* logits, const void* gout, void* dv,
                      void* dlogits, int B, int H, int W, int C, int heads, float scale,
                      int dtype, void* stream) {
    if (bad_map(B, H, W, C, heads) || (dtype != 0 && dtype != 1)) return kBadShape;
    const Geo g = make_geo(B, H, W, C, heads, scale);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_bwd<float>(v, logits, gout, dv, dlogits, g, s);
    return launch_bwd<__nv_bfloat16>(v, logits, gout, dv, dlogits, g, s);
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
