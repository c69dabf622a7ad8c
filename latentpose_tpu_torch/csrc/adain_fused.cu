// Fused AdaIN (+ReLU) for Hopper (sm_90a): IN(x) * weight[b, c] + bias[b, c].
//
// Replaces the TPU kernel latentpose_tpu/ops/pallas/adain_fused.py
// (adain_fused, body _adain_kernel).  The generator applies this op 17 times
// per frame; each application reads x twice and writes it once, with almost
// no arithmetic per byte, so the kernel is bound by device-memory bandwidth.
//
// The TPU kernel walks a sequential grid and carries the per-channel sums from
// one grid step to the next.  Blocks on this card run in parallel and in no
// order, so the work is split into three launches instead:
//
//   1. adain_stats: blocks over (pixel chunk, sample).  Each thread owns one
//      16-byte vector of channels and walks the chunk's pixels with f32 sum and
//      sum of squares; the block folds its rows together and writes one f32
//      partial per (sample, chunk, {sum, sumsq}, channel).  Many chunks keep
//      all SMs busy even at the (65536, 64) shapes.
//   2. adain_finalize: one thread per (sample, channel) reduces the chunks,
//      clamps the one-pass variance at 0 (as ops/norms.py does, unlike the
//      Pallas kernel) and folds IN and the affine into scale and shift.
//   3. adain_apply: the same (chunk, sample) grid streams x again and writes
//      x * scale + shift, with the ReLU fused, in x's dtype.
//
// x and out are (B, HW, C) contiguous (NHWC).  weight and bias are (B, C) in
// x's dtype with a row stride (0 broadcasts one row over the batch).  All
// statistics are f32 for f32 and bf16 inputs alike.  The kernel allocates
// nothing: the caller passes the f32 scratch `partial` (B, chunks, 2, C) and
// `coef` (B, 2, C).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float scalar(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
  __device__ static float scalar(__nv_bfloat16 x) { return __bfloat162float(x); }
};

// Thread layout shared by the stats and apply passes: thread t owns channel
// vector g = t % groups and pixel row r = t / groups of each step of `rows`
// pixels.  Threads with r >= rows (when groups does not divide kThreads) idle.
struct Layout {
  int groups, rows, g, r;
  __device__ Layout(int c, int vec) {
    groups = c / vec;
    rows = kThreads / groups;
    g = threadIdx.x % groups;
    r = threadIdx.x / groups;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
adain_stats(const T* __restrict__ x, float* __restrict__ partial, int hw, int c,
            int chunk_pixels) {
  using V = Vec<T>;
  __shared__ float red_s[kThreads * V::N];
  __shared__ float red_q[kThreads * V::N];
  const int b = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const Layout L(c, V::N);

  float s[V::N], q[V::N];
#pragma unroll
  for (int i = 0; i < V::N; ++i) s[i] = q[i] = 0.f;
  if (L.r < L.rows) {
    const int p0 = chunk * chunk_pixels;
    const int p1 = min(p0 + chunk_pixels, hw);
    const T* xb = x + (size_t)b * hw * c + (size_t)L.g * V::N;
    for (int p = p0 + L.r; p < p1; p += L.rows) {
      float v[V::N];
      V::load(xb + (size_t)p * c, v);
#pragma unroll
      for (int i = 0; i < V::N; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
  }
  // Row r's value for channel ch = g * N + i lands at r * c + ch.
#pragma unroll
  for (int i = 0; i < V::N; ++i) {
    red_s[threadIdx.x * V::N + i] = s[i];
    red_q[threadIdx.x * V::N + i] = q[i];
  }
  __syncthreads();
  float* out = partial + ((size_t)b * chunks + chunk) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < L.rows; ++r) {
      ts += red_s[r * c + ch];
      tq += red_q[r * c + ch];
    }
    out[ch] = ts;
    out[c + ch] = tq;
  }
}

template <typename T>
__global__ void adain_finalize(const float* __restrict__ partial, const T* __restrict__ weight,
                               long long w_stride, const T* __restrict__ bias, long long b_stride,
                               float* __restrict__ coef, int hw, int c, int chunks, float eps) {
  const int b = blockIdx.y;
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float s = 0.f, q = 0.f;
  const float* p = partial + (size_t)b * chunks * 2 * c + ch;
  for (int k = 0; k < chunks; ++k) {
    s += p[(size_t)k * 2 * c];
    q += p[(size_t)k * 2 * c + c];
  }
  const float n = (float)hw;
  const float mean = s / n;
  const float var = fmaxf(q / n - mean * mean, 0.f);
  const float scale = Vec<T>::scalar(weight[b * w_stride + ch]) * rsqrtf(var + eps);
  coef[(size_t)b * 2 * c + ch] = scale;
  coef[(size_t)b * 2 * c + c + ch] = Vec<T>::scalar(bias[b * b_stride + ch]) - mean * scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adain_apply(const T* __restrict__ x, const float* __restrict__ coef, T* __restrict__ out,
            int hw, int c, int chunk_pixels, int relu) {
  using V = Vec<T>;
  const int b = blockIdx.y, chunk = blockIdx.x;
  const Layout L(c, V::N);
  if (L.r >= L.rows) return;
  float scale[V::N], shift[V::N];
  const float* cb = coef + (size_t)b * 2 * c + L.g * V::N;
#pragma unroll
  for (int i = 0; i < V::N; ++i) {
    scale[i] = cb[i];
    shift[i] = cb[c + i];
  }
  const int p0 = chunk * chunk_pixels;
  const int p1 = min(p0 + chunk_pixels, hw);
  const size_t base = (size_t)b * hw * c + (size_t)L.g * V::N;
  for (int p = p0 + L.r; p < p1; p += L.rows) {
    float v[V::N];
    V::load(x + base + (size_t)p * c, v);
#pragma unroll
    for (int i = 0; i < V::N; ++i) {
      v[i] = v[i] * scale[i] + shift[i];
      if (relu) v[i] = fmaxf(v[i], 0.f);
    }
    V::store(out + base + (size_t)p * c, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* weight, long long w_stride, const void* bias,
                   long long b_stride, void* out, float* partial, float* coef, int batch, int hw,
                   int c, int chunk_pixels, int chunks, int relu, float eps, cudaStream_t stream) {
  const dim3 grid(chunks, batch);
  adain_stats<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), partial, hw, c,
                                                 chunk_pixels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adain_finalize<T><<<dim3((c + kThreads - 1) / kThreads, batch), kThreads, 0, stream>>>(
      partial, static_cast<const T*>(weight), w_stride, static_cast<const T*>(bias), b_stride,
      coef, hw, c, chunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  adain_apply<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), coef,
                                                 static_cast<T*>(out), hw, c, chunk_pixels, relu);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 on success).
// The caller has checked shapes, alignment and that c / (16 / itemsize)
// divides into at most kThreads channel vectors.
extern "C" int adain_fused_forward(const void* x, const void* weight, long long w_stride,
                                   const void* bias, long long b_stride, void* out,
                                   float* partial, float* coef, int batch, int hw, int c,
                                   int chunk_pixels, int chunks, int dtype, int relu, float eps,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, weight, w_stride, bias, b_stride, out, partial, coef, batch, hw, c,
                         chunk_pixels, chunks, relu, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, weight, w_stride, bias, b_stride, out, partial, coef, batch,
                                 hw, c, chunk_pixels, chunks, relu, eps, s);
  return cudaErrorInvalidValue;
}
