// LayerNorm over the last axis for Hopper (sm_90a): one forward kernel and a
// backward of two kernels, in bf16 or f32 storage with f32 arithmetic.
//
// Replaces no TPU kernel: the JAX package leaves nn.LayerNorm to XLA. The
// port's plain path (models/layers.py, now the twin in ops/layernorm.py)
// widens the input to f32, runs F.layer_norm in f32 and casts the result
// back, and autograd mirrors that in the backward: about 1.0 GB a call at
// deit_small's [50432, 384] where one pass needs 194 MB, 10-12 % of the
// bytes' bound. These kernels read and write the working dtype once and
// keep everything else in registers.
//
// The op, for a row x of C values (the statistics and the affine in f32):
//   mean = sum(x) / C;  var = sum((x - mean)^2) / C  (biased, from the
//   deviations held in registers, not E[x^2] - mean^2);
//   rstd = 1 / sqrt(var + eps);  xhat = (x - mean) * rstd
//   y    = T(xhat * gamma + beta)                    rounded once
// Backward, from the saved x, mean and rstd (f32 per row):
//   g = dy * gamma;  a = sum(g) / C;  b = sum(g * xhat) / C
//   dx = T(rstd * (g - a - xhat * b))                rounded once
//   dgamma = sum over rows of dy * xhat;  dbeta = sum over rows of dy  (f32)
//
// Layout, chosen from C alone: a row is C / V vectors of 16 bytes (V = 8
// bf16 or 4 f32 values); `lanes` = the smallest power of two >= C / V / 4,
// at most 32, threads share a row, each holding VPT = ceil(C / V / lanes)
// vectors in registers (lane l takes vectors l, l + lanes, ...), and a warp
// holds 32 / lanes rows. Row sums reduce over the row's lanes by xor
// shuffles. So a row is read once with 16-byte loads whatever C is (every
// multiple of 8 up to 1024), and deit's C = 384 in bf16 runs 16 lanes of 3
// vectors, 2 rows a warp.
//
// The backward's first kernel gives each block a strip of rows; each row
// group of lanes walks its rows of the strip and keeps running f32 sums of
// dy * xhat and dy for the channels it holds. At the end of the strip the
// groups of a warp combine by xor shuffles, the warps through shared memory
// in warp order, and the block writes one [2, C] row of partial sums. The
// second kernel sums those rows in a fixed order into dgamma and dbeta.
// There are no atomics: every sum has one order, and a result is the same
// bits from run to run (a recompute under --remat gives the forward's
// bits). The number of strips depends on the row count only (at most
// `partial_rows`, which the caller sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBadShape = -1;
constexpr int kMaxC = 1024;
constexpr int kFwdWarps = 4;
constexpr int kBwdWarps = 8;
constexpr int kReduceRows = 8;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
    static constexpr int N = 4;
};
template <>
struct Vec<bf16> {
    static constexpr int N = 8;
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const bf16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void store_vec(float* p, const float* in) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store_vec(bf16* p, const float* in) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
}

// V f32 values of gamma (or beta) as float4 loads
template <int V>
__device__ __forceinline__ void load_param(const float* p, float* out) {
#pragma unroll
    for (int i = 0; i < V; i += 4) load_vec(p + i, out + i);
}

// sum over the `lanes` threads of a row (a power of two, aligned in the warp)
__device__ __forceinline__ float row_sum(float v, int lanes) {
    for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kFwdWarps * 32)
ln_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
       const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ mean,
       float* __restrict__ rstd, int rows, int C, int lanes, float eps) {
    constexpr int V = Vec<T>::N;
    const int lane = threadIdx.x & 31;
    const int li = lane & (lanes - 1);
    const long long row =
        (static_cast<long long>(blockIdx.x) * kFwdWarps + (threadIdx.x >> 5)) * (32 / lanes) +
        lane / lanes;
    const bool valid = row < rows;
    const int vecs = C / V;
    const T* xr = x + row * C;
    float v[VPT][V];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
        const int c = j * lanes + li;
        if (valid && c < vecs) {
            load_vec(xr + c * V, v[j]);
#pragma unroll
            for (int k = 0; k < V; ++k) s += v[j][k];
        }
    }
    const float mu = row_sum(s, lanes) / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
        if (valid && j * lanes + li < vecs) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                v[j][k] -= mu;
                q += v[j][k] * v[j][k];
            }
        }
    }
    const float rs = 1.f / sqrtf(row_sum(q, lanes) / C + eps);
    if (!valid) return;
    if (li == 0) {
        mean[row] = mu;
        rstd[row] = rs;
    }
    T* yr = y + row * C;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
        const int c = j * lanes + li;
        if (c < vecs) {
            float g[V], b[V];
            load_param<V>(gamma + c * V, g);
            load_param<V>(beta + c * V, b);
#pragma unroll
            for (int k = 0; k < V; ++k) v[j][k] = v[j][k] * rs * g[k] + b[k];
            store_vec(yr + c * V, v[j]);
        }
    }
}

// dx for a strip of rows a block, and the strip's partial sums of dy * xhat
// and dy per channel: partial[blockIdx.x] = [2, C]. Dynamic shared memory:
// kBwdWarps * C floats.
template <typename T, int VPT>
__global__ void __launch_bounds__(kBwdWarps * 32)
ln_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ gamma,
          const float* __restrict__ mean, const float* __restrict__ rstd, T* __restrict__ dx,
          float* __restrict__ partial, int rows, int C, int lanes, int strip) {
    constexpr int V = Vec<T>::N;
    extern __shared__ float red[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int li = lane & (lanes - 1);
    const int per_warp = 32 / lanes;
    const int groups = kBwdWarps * per_warp;
    const int group = warp * per_warp + lane / lanes;
    const int vecs = C / V;
    const long long r0 = static_cast<long long>(blockIdx.x) * strip;
    const long long r1 = min(r0 + strip, static_cast<long long>(rows));
    const float inv_c = 1.f / C;
    float dg[VPT][V], db[VPT][V];
#pragma unroll
    for (int j = 0; j < VPT; ++j)
#pragma unroll
        for (int k = 0; k < V; ++k) dg[j][k] = db[j][k] = 0.f;

    for (long long base = r0; base < r1; base += groups) {
        const long long row = base + group;
        const bool valid = row < r1;
        const float mu = valid ? mean[row] : 0.f;
        const float rs = valid ? rstd[row] : 0.f;
        float xh[VPT][V], gy[VPT][V];
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
            const int c = j * lanes + li;
            if (valid && c < vecs) {
                float d[V], g[V];
                load_vec(x + row * C + c * V, xh[j]);
                load_vec(dy + row * C + c * V, d);
                load_param<V>(gamma + c * V, g);
#pragma unroll
                for (int k = 0; k < V; ++k) {
                    xh[j][k] = (xh[j][k] - mu) * rs;
                    dg[j][k] += d[k] * xh[j][k];
                    db[j][k] += d[k];
                    gy[j][k] = d[k] * g[k];
                    a += gy[j][k];
                    b += gy[j][k] * xh[j][k];
                }
            }
        }
        a = row_sum(a, lanes) * inv_c;
        b = row_sum(b, lanes) * inv_c;
        if (valid) {
#pragma unroll
            for (int j = 0; j < VPT; ++j) {
                const int c = j * lanes + li;
                if (c < vecs) {
#pragma unroll
                    for (int k = 0; k < V; ++k) xh[j][k] = rs * (gy[j][k] - a - xh[j][k] * b);
                    store_vec(dx + row * C + c * V, xh[j]);
                }
            }
        }
    }

    // the row groups of a warp hold the same channels: combine them in-warp
    for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
        for (int j = 0; j < VPT; ++j)
#pragma unroll
            for (int k = 0; k < V; ++k) {
                dg[j][k] += __shfl_xor_sync(0xffffffffu, dg[j][k], off);
                db[j][k] += __shfl_xor_sync(0xffffffffu, db[j][k], off);
            }
    }
    // then the warps, in warp order, through shared memory: dgamma, then dbeta
    float* out = partial + static_cast<long long>(blockIdx.x) * 2 * C;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
        if (lane < lanes) {
#pragma unroll
            for (int j = 0; j < VPT; ++j) {
                const int c = j * lanes + li;
                if (c < vecs) {
#pragma unroll
                    for (int k = 0; k < V; ++k)
                        red[warp * C + c * V + k] = which == 0 ? dg[j][k] : db[j][k];
                }
            }
        }
        __syncthreads();
        for (int c = threadIdx.x; c < C; c += blockDim.x) {
            float t = 0.f;
#pragma unroll
            for (int w = 0; w < kBwdWarps; ++w) t += red[w * C + c];
            out[which * C + c] = t;
        }
        __syncthreads();
    }
}

// dgamma, dbeta = the sums of the strips' partial rows, in strip order within
// each of kReduceRows interleaved slices, then the slices in order. Block
// (32 columns, kReduceRows slices), grid over the 2C columns.
__global__ void __launch_bounds__(32 * kReduceRows)
ln_bwd_params(const float* __restrict__ partial, float* __restrict__ dgamma,
              float* __restrict__ dbeta, int strips, int C) {
    __shared__ float part[kReduceRows][33];
    const int col = blockIdx.x * 32 + threadIdx.x;
    const int width = 2 * C;
    float t = 0.f;
    if (col < width)
        for (int s = threadIdx.y; s < strips; s += kReduceRows)
            t += partial[static_cast<long long>(s) * width + col];
    part[threadIdx.y][threadIdx.x] = t;
    __syncthreads();
    if (threadIdx.y == 0 && col < width) {
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < kReduceRows; ++r) sum += part[r][threadIdx.x];
        if (col < C)
            dgamma[col] = sum;
        else
            dbeta[col - C] = sum;
    }
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the row layout of the module comment; false where C is not taken
template <typename T>
bool layout(int C, int* lanes, int* vpt) {
    constexpr int V = Vec<T>::N;
    if (C < 8 || C > kMaxC || C % 8) return false;
    const int vecs = C / V;
    int l = 1;
    while (l < 32 && l * 4 < vecs) l <<= 1;
    *lanes = l;
    *vpt = (vecs + l - 1) / l;
    return true;
}

template <typename T, int VPT>
void fwd_launch(const void* x, const void* gamma, const void* beta, void* y, float* mean,
                float* rstd, int rows, int C, int lanes, float eps, cudaStream_t s) {
    const int rows_per_block = kFwdWarps * (32 / lanes);
    const int blocks = (rows + rows_per_block - 1) / rows_per_block;
    ln_fwd<T, VPT><<<blocks, kFwdWarps * 32, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<T*>(y), mean, rstd, rows, C, lanes, eps);
}

template <typename T, int VPT>
void dx_launch(const void* x, const void* dy, const void* gamma, const float* mean,
               const float* rstd, void* dx, float* partial, int rows, int C, int lanes,
               int strips, int strip, cudaStream_t s) {
    ln_bwd_dx<T, VPT><<<strips, kBwdWarps * 32, kBwdWarps * C * sizeof(float), s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(gamma),
        mean, rstd, static_cast<T*>(dx), partial, rows, C, lanes, strip);
}

template <typename T>
int launch_fwd(const void* x, const void* gamma, const void* beta, void* y, float* mean,
               float* rstd, int rows, int C, float eps, cudaStream_t s) {
    int lanes, vpt;
    if (!layout<T>(C, &lanes, &vpt)) return kBadShape;
    if (rows == 0) return 0;
    switch (vpt) {
#define LN_FWD_CASE(N) \
    case N: fwd_launch<T, N>(x, gamma, beta, y, mean, rstd, rows, C, lanes, eps, s); break;
        LN_FWD_CASE(1) LN_FWD_CASE(2) LN_FWD_CASE(3) LN_FWD_CASE(4)
        LN_FWD_CASE(5) LN_FWD_CASE(6) LN_FWD_CASE(7) LN_FWD_CASE(8)
#undef LN_FWD_CASE
        default: return kBadShape;
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* gamma, const float* mean,
               const float* rstd, void* dx, float* partial, float* dgamma, float* dbeta,
               int rows, int C, int partial_rows, cudaStream_t s) {
    int lanes, vpt;
    if (!layout<T>(C, &lanes, &vpt)) return kBadShape;
    // strips: as many as `partial_rows` allows, each at least one pass of
    // the block's row groups, so that every strip holds rows
    const int groups = kBwdWarps * (32 / lanes);
    int strips = (rows + groups - 1) / groups;
    if (strips > partial_rows) strips = partial_rows;
    const int strip = strips ? (rows + strips - 1) / strips : 0;
    if (strips) strips = (rows + strip - 1) / strip;
    if (strips) {
        switch (vpt) {
#define LN_DX_CASE(N)                                                                  \
    case N:                                                                            \
        dx_launch<T, N>(x, dy, gamma, mean, rstd, dx, partial, rows, C, lanes, strips, \
                        strip, s);                                                     \
        break;
            LN_DX_CASE(1) LN_DX_CASE(2) LN_DX_CASE(3) LN_DX_CASE(4)
            LN_DX_CASE(5) LN_DX_CASE(6) LN_DX_CASE(7) LN_DX_CASE(8)
#undef LN_DX_CASE
            default: return kBadShape;
        }
    }
    const dim3 block(32, kReduceRows);
    ln_bwd_params<<<(2 * C + 31) / 32, block, 0, s>>>(partial, dgamma, dbeta, strips, C);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns 0 on success, a cudaError_t value, or -1 for a shape the
// kernels do not take (C not a multiple of 8 in [8, 1024], a 16-byte
// misaligned tensor, an unknown dtype). `stream` is a cudaStream_t. dtype:
// 0 = float32, 1 = bfloat16 (x, y, dy and dx share it); gamma, beta, the
// statistics and the parameter gradients are f32. x is [rows, C] contiguous.

// y = LayerNorm(x) * gamma + beta; stats = [mean; rstd], two f32 rows of `rows`
int layernorm_fwd(const void* x, const void* gamma, const void* beta, void* y, void* stats,
                  int rows, int C, float eps, int dtype, void* stream) {
    if (rows < 0 || !aligned(x) || !aligned(gamma) || !aligned(beta) || !aligned(y))
        return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* mean = static_cast<float*>(stats);
    if (dtype == 0) return launch_fwd<float>(x, gamma, beta, y, mean, mean + rows, rows, C, eps, s);
    if (dtype == 1) return launch_fwd<bf16>(x, gamma, beta, y, mean, mean + rows, rows, C, eps, s);
    return kBadShape;
}

// dx from x, dy, gamma and the forward's stats; dgamma, dbeta through
// `partial`, f32 scratch of [partial_rows, 2, C] (partial_rows >= 1): two
// kernel launches
int layernorm_bwd(const void* x, const void* dy, const void* gamma, const void* stats, void* dx,
                  void* partial, void* dgamma, void* dbeta, int rows, int C, int partial_rows,
                  int dtype, void* stream) {
    if (rows < 0 || partial_rows < 1 || !aligned(x) || !aligned(dy) || !aligned(gamma) ||
        !aligned(dx))
        return kBadShape;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* mean = static_cast<const float*>(stats);
    float* part = static_cast<float*>(partial);
    float* dg = static_cast<float*>(dgamma);
    float* dbt = static_cast<float*>(dbeta);
    if (dtype == 0)
        return launch_bwd<float>(x, dy, gamma, mean, mean + rows, dx, part, dg, dbt, rows, C,
                                 partial_rows, s);
    if (dtype == 1)
        return launch_bwd<bf16>(x, dy, gamma, mean, mean + rows, dx, part, dg, dbt, rows, C,
                                partial_rows, s);
    return kBadShape;
}

}  // extern "C"
