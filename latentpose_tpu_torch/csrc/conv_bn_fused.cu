// Fused BN-apply -> ReLU -> 1x1 conv -> BN statistics for Hopper (sm_90a):
//
//   y     = relu(x * scale + offset) @ W            (M, Cout) in x's dtype
//   stats = (sum_m y, sum_m y^2) per output channel (2, Cout) in f32
//
// Replaces the TPU kernel latentpose_tpu/ops/pallas/conv_bn_fused.py:58
// (bn_relu_conv1x1_stats, body _kernel).  In the ResNeXt-50 identity tower it
// is the bottleneck's bn2 -> ReLU -> conv3 link: x is conv2's output (NHWC,
// flattened to M rows of Cin channels), scale/offset fold bn2, W is conv3's
// weight, and stats are what a train-mode bn3 would need.
//
// What bounds it on this card.  A 1x1 conv is an (M, Cin) x (Cin, Cout)
// product.  The largest link, layer1's (M, 128 -> 256), does 2*128*256 FLOP
// per row for (128 + 256) * 2 bytes of bf16 traffic: ~85 FLOP/byte, below the
// H100's ~295 FLOP/byte ridge, so it is bound by device memory; layer3's
// (512 -> 1024) and layer4's (1024 -> 2048) links are far above the ridge and
// bound by arithmetic.  This kernel does its arithmetic on the CUDA cores
// (f32 FMA, no tensor cores), so in practice it is bound by the FMA rate
// everywhere but the smallest links.
//
// What the design does about that:
//   * each block owns a 128 x 128 tile of y and walks Cin in 16-wide slices;
//     every thread keeps an 8 x 8 block of f32 accumulators in registers, so
//     each shared-memory load feeds eight FMAs and the loop is FMA-bound, not
//     load-bound;
//   * the BN apply and ReLU run in the prologue, while the x slice is staged
//     into shared memory (rounded to W's dtype, as the Pallas kernel rounds
//     before its dot), so the normalised activation never goes to device
//     memory: x is read once per 128-column tile, y written once;
//   * the statistics come from the f32 accumulators in the epilogue, so y is
//     never read back.  The TPU kernel carried them in scratch along a
//     sequential grid; blocks here run in no order, so each row tile writes
//     its per-column partial sums to an f32 scratch (row_tiles, 2, Cout) and
//     a second small launch reduces them in a fixed order (deterministic, no
//     atomics), as adain_fused.cu does.
//   * ragged M and ragged Cout are masked (zero rows contribute nothing to y
//     or the sums); Cin and Cout must be multiples of the 16-byte vector
//     (4 f32 or 8 bf16), which the wrapper checks.
// Tensor cores (wgmma with a TMA ring), a persistent grid and fusing bn3's
// apply are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // rows of y per block
constexpr int kBN = 128;        // columns of y per block
constexpr int kBK = 16;         // Cin slice staged per step
constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLd = kBM + 4;    // shared row stride (floats), 16-byte aligned

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ static float round(float x) { return x; }
  // four consecutive values
  __device__ __forceinline__ static void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static void store4(__nv_bfloat16* p, float a, float b, float c,
                                                float d) {
    uint2 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(a, b);
    h[1] = __floats2bfloat162_rn(c, d);
    *reinterpret_cast<uint2*>(p) = q;
  }
};

// Thread t owns rows {ty*4 + i, 64 + ty*4 + i} and columns {tx*4 + j,
// 64 + tx*4 + j} (i, j < 4) of the block's tile, ty = t / 16, tx = t % 16, so
// the float4 reads of a k-row of the staged tiles are conflict-free.
__device__ __forceinline__ int owned(int half, int base, int i) { return half * 64 + base * 4 + i; }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
bn_relu_conv1x1(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ offset, const T* __restrict__ w, T* __restrict__ y,
                float* __restrict__ partial, long long m, int cin, int cout, int relu) {
  using E = Elem<T>;
  constexpr int kVecsPerRow = kBK / E::kVec;
  __shared__ __align__(16) float a_s[kBK][kLd];   // relu(x*scale+offset), k-major
  __shared__ __align__(16) float b_s[kBK][kLd];   // W slice, k-major
  __shared__ float red_s[16][kBN];
  __shared__ float red_q[16][kBN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += kBK) {
    __syncthreads();   // the previous slice has been consumed
    for (int idx = tid; idx < kBM * kVecsPerRow; idx += kThreads) {
      const int r = idx / kVecsPerRow;
      const int kk = (idx % kVecsPerRow) * E::kVec;
      const long long gm = m0 + r;
      const int gk = k0 + kk;
      float v[E::kVec];
      if (gm < m && gk < cin) {   // cin % kVec == 0: a vector is all in or all out
        E::load(x + gm * cin + gk, v);
#pragma unroll
        for (int i = 0; i < E::kVec; ++i) {
          float h = v[i] * scale[gk + i] + offset[gk + i];
          if (relu) h = fmaxf(h, 0.f);
          v[i] = E::round(h);
        }
      } else {
#pragma unroll
        for (int i = 0; i < E::kVec; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < E::kVec; ++i) a_s[kk + i][r] = v[i];
    }
    for (int idx = tid; idx < kBN * kVecsPerRow; idx += kThreads) {
      const int c = idx / kVecsPerRow;
      const int kk = (idx % kVecsPerRow) * E::kVec;
      const int gn = n0 + c;
      const int gk = k0 + kk;
      float v[E::kVec];
      if (gn < cout && gk < cin) {
        E::load(w + (size_t)gn * cin + gk, v);
      } else {
#pragma unroll
        for (int i = 0; i < E::kVec; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < E::kVec; ++i) b_s[kk + i][c] = v[i];
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // Epilogue: y in x's dtype; column sums of the f32 accumulators.  Rows past
  // M were staged as zeros, so their accumulators are exactly 0 and add
  // nothing to the sums.
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gm = m0 + owned(i / 4, ty, i % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] += acc[i][j];
      q[j] += acc[i][j] * acc[i][j];
    }
    if (gm >= m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gn = n0 + owned(half, tx, 0);
      if (gn < cout)   // cout % 4 == 0: the four columns are all in or all out
        E::store4(y + gm * cout + gn, acc[i][half * 4], acc[i][half * 4 + 1],
                  acc[i][half * 4 + 2], acc[i][half * 4 + 3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red_s[ty][owned(j / 4, tx, j % 4)] = s[j];
    red_q[ty][owned(j / 4, tx, j % 4)] = q[j];
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < cout) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      ts += red_s[r][tid];
      tq += red_q[r][tid];
    }
    float* out = partial + (size_t)blockIdx.x * 2 * cout;
    out[n0 + tid] = ts;
    out[cout + n0 + tid] = tq;
  }
}

// stats[0][c] = sum_t partial[t][0][c], stats[1][c] = sum_t partial[t][1][c],
// summed over the row tiles t in order.
__global__ void stats_finalize(const float* __restrict__ partial, float* __restrict__ stats,
                               int row_tiles, int cout) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cout) return;
  float s = 0.f, q = 0.f;
  for (int t = 0; t < row_tiles; ++t) {
    s += partial[(size_t)t * 2 * cout + c];
    q += partial[(size_t)t * 2 * cout + cout + c];
  }
  stats[c] = s;
  stats[cout + c] = q;
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* offset, const void* w, void* y,
                   float* partial, float* stats, long long m, int cin, int cout, int relu,
                   cudaStream_t stream) {
  const long long row_tiles = (m + kBM - 1) / kBM;
  const dim3 grid((unsigned)row_tiles, (cout + kBN - 1) / kBN);
  bn_relu_conv1x1<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, offset, static_cast<const T*>(w), static_cast<T*>(y),
      partial, m, cin, cout, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_finalize<<<(cout + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, stats, (int)row_tiles, cout);
  return cudaGetLastError();
}

}  // namespace

// x (m, cin) and y (m, cout) contiguous in one dtype (0 = float32,
// 1 = bfloat16); w is conv3's (cout, cin) weight, contiguous, in x's dtype;
// scale, offset (cin,) f32; partial (ceil(m / 128), 2, cout) and stats
// (2, cout) f32 scratch and output.  Returns a cudaError_t (0 on success).
// The caller has checked shapes, alignment and cin % vec == cout % vec == 0.
extern "C" int bn_relu_conv1x1_stats_forward(const void* x, const float* scale,
                                             const float* offset, const void* w, void* y,
                                             float* partial, float* stats, long long m, int cin,
                                             int cout, int dtype, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, offset, w, y, partial, stats, m, cin, cout, relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, offset, w, y, partial, stats, m, cin, cout, relu, s);
  return cudaErrorInvalidValue;
}
