// Fused AdaIN (+ReLU) for Hopper (sm_90a): IN(x) * weight[b, c] + bias[b, c].
//
// Replaces the TPU kernel latentpose_tpu/ops/pallas/adain_fused.py
// (adain_fused, body _adain_kernel).  The generator applies this op 17 times
// per frame.  It needs one read and one write of x with almost no arithmetic
// per byte, so the card's bound is device-memory bandwidth: bytes(x) * 2 /
// 3.35 TB/s.  At the small shapes (4x4 .. 16x16 at 512 channels) a call is
// pure latency, so the design also keeps to one launch.
//
// One launch, one thread-block cluster per sample (grid = (cluster, batch)):
//
//   1. Each block owns a contiguous slice of the sample's pixels.  It keeps
//      the last `resident` pixels of its slice in shared memory: one thread
//      issues TMA bulk copies (cp.async.bulk, one mbarrier per chunk), and
//      the block streams the rest of the slice (the "overflow", only where
//      the sample does not fit the cluster's shared memory) from device
//      memory meanwhile.  Each thread owns one 16-byte vector of channels and
//      accumulates f32 sum and sum of squares over its pixel rows.
//   2. The block folds its rows into per-channel partials in shared memory;
//      after cluster.sync() every block reads all blocks' partials through
//      distributed shared memory in rank order (fixed order, no atomics: two
//      runs are bitwise equal, and every block gets the same totals).  The
//      one-pass variance is clamped at 0 as ops/norms.py does; IN and the
//      affine fold into per-channel scale and shift.
//   3. Each block writes x * scale + shift (ReLU fused) for its slice: the
//      overflow first, re-read in reverse order so that the most recently
//      read lines (still in L2) come first, then the resident pixels from
//      shared memory.  So x is read from device memory once wherever the
//      sample fits the cluster.
//
// The launch plan (cluster size, pixels per block, resident pixels, chunk
// size, shared-memory bytes) comes from ops/adain.py plan_launch, which also
// asks adain_max_active_clusters that the cluster fits the card.
//
// x and out are (B, HW, C) contiguous (NHWC).  weight and bias are (B, C) in
// x's dtype with a row stride (0 broadcasts one row over the batch).  All
// statistics are f32 for f32 and bf16 inputs alike.  The kernel allocates
// nothing and needs no scratch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 16;           // mbarriers, one per bulk-copy chunk
constexpr int kBarBytes = kMaxChunks * 8;
constexpr int kSmemLimit = 232448;       // opt-in shared memory per block on sm_90
constexpr int kBatch = 8;                // overflow vectors in flight per thread

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

// Thread t owns channel vector g = t % groups and pixel row r = t / groups of
// each step of `rows` pixels.  Threads with r >= rows (when groups does not
// divide kThreads) idle.
struct Layout {
  int groups, rows, g, r;
  __device__ Layout(int c, int vec) {
    groups = c / vec;
    rows = kThreads / groups;
    g = threadIdx.x % groups;
    r = threadIdx.x / groups;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA bulk copy of `bytes` (a multiple of 16) from device memory into this
// block's shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adain_cluster(const T* __restrict__ x, const T* __restrict__ weight, long long w_stride,
              const T* __restrict__ bias, long long b_stride, T* __restrict__ out, int hw, int c,
              int block_pixels, int resident_cap, int chunk_pixels, int relu, float eps) {
  using V = Vec<T>;
  constexpr int N = V::N;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + kBarBytes);       // (2, c): Σx, Σx²
  float* red = part + 2 * c;                                      // (2, kThreads * N)
  T* data = reinterpret_cast<T*>(red + 2 * kThreads * N);         // resident pixels

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int p0 = rank * block_pixels;
  const int count = max(0, min(block_pixels, hw - p0));
  const int resident = min(count, resident_cap);
  const int overflow = count - resident;   // the slice's first pixels, streamed
  const int chunks = (resident + chunk_pixels - 1) / chunk_pixels;
  const T* xs = x + ((size_t)b * hw + p0) * c;
  T* os = out + ((size_t)b * hw + p0) * c;

  if (threadIdx.x == 0) {
    for (int i = 0; i < chunks; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < chunks; ++i) {
      const int pa = i * chunk_pixels, pb = min(pa + chunk_pixels, resident);
      bulk_load(data + (size_t)pa * c, xs + (size_t)(overflow + pa) * c,
                (uint32_t)((size_t)(pb - pa) * c * sizeof(T)), &bars[i]);
    }
  }
  __syncthreads();   // the barriers are initialised before anyone waits

  const Layout L(c, N);
  float s[N], q[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = q[i] = 0.f;
  if (L.r < L.rows) {
    const int col = L.g * N;
    // The overflow streams from device memory kBatch vectors at a time, so
    // that each thread keeps kBatch loads in flight.
    int p = L.r;
    for (; p + (kBatch - 1) * L.rows < overflow; p += kBatch * L.rows) {
      float v[kBatch][N];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) V::load(xs + (size_t)(p + u * L.rows) * c + col, v[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s[i] += v[u][i];
          q[i] += v[u][i] * v[u][i];
        }
    }
    for (; p < overflow; p += L.rows) {
      float v[N];
      V::load(xs + (size_t)p * c + col, v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
    for (int k = 0; k < chunks; ++k) {
      mbar_wait(&bars[k], 0);
      const int pb = min((k + 1) * chunk_pixels, resident);
      for (int p = k * chunk_pixels + L.r; p < pb; p += L.rows) {
        float v[N];
        V::load(data + (size_t)p * c + col, v);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          s[i] += v[i];
          q[i] += v[i] * v[i];
        }
      }
    }
  }
  // Row r's value for channel ch = g * N + i lands at r * c + ch.
#pragma unroll
  for (int i = 0; i < N; ++i) {
    red[threadIdx.x * N + i] = s[i];
    red[kThreads * N + threadIdx.x * N + i] = q[i];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int r = 0; r < L.rows; ++r) {
      ts += red[r * c + ch];
      tq += red[kThreads * N + r * c + ch];
    }
    part[ch] = ts;
    part[c + ch] = tq;
  }
  cluster.sync();   // every block's partials are written and visible

  // Totals over the cluster in rank order; scale and shift go where the
  // row partials were.
  float* coef = red;
  const float n = (float)hw;
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < blocks; ++k) {
      const float* remote = cluster.map_shared_rank(part, k);
      ts += remote[ch];
      tq += remote[c + ch];
    }
    const float mean = ts / n;
    const float var = fmaxf(tq / n - mean * mean, 0.f);
    const float scale = V::scalar(weight[b * w_stride + ch]) * rsqrtf(var + eps);
    coef[ch] = scale;
    coef[c + ch] = V::scalar(bias[b * b_stride + ch]) - mean * scale;
  }
  cluster.sync();   // no block leaves while another still reads its partials

  if (L.r >= L.rows) return;
  const int col = L.g * N;
  float scale[N], shift[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    scale[i] = coef[col + i];
    shift[i] = coef[c + col + i];
  }
  int p = overflow - 1 - L.r;
  for (; p - (kBatch - 1) * L.rows >= 0; p -= kBatch * L.rows) {
    float v[kBatch][N];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) V::load(xs + (size_t)(p - u * L.rows) * c + col, v[u]);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        v[u][i] = v[u][i] * scale[i] + shift[i];
        if (relu) v[u][i] = fmaxf(v[u][i], 0.f);
      }
      V::store(os + (size_t)(p - u * L.rows) * c + col, v[u]);
    }
  }
  for (; p >= 0; p -= L.rows) {
    float v[N];
    V::load(xs + (size_t)p * c + col, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = v[i] * scale[i] + shift[i];
      if (relu) v[i] = fmaxf(v[i], 0.f);
    }
    V::store(os + (size_t)p * c + col, v);
  }
#pragma unroll 4
  for (int p = L.r; p < resident; p += L.rows) {
    float v[N];
    V::load(data + (size_t)p * c + col, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[i] = v[i] * scale[i] + shift[i];
      if (relu) v[i] = fmaxf(v[i], 0.f);
    }
    V::store(os + (size_t)(overflow + p) * c + col, v);
  }
}

template <typename T>
cudaError_t allow_large_clusters() {
  static cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(adain_cluster<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(adain_cluster<T>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

template <typename T>
cudaLaunchConfig_t config(int cluster, int batch, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
cudaError_t launch(const void* x, const void* weight, long long w_stride, const void* bias,
                   long long b_stride, void* out, int batch, int hw, int c, int cluster,
                   int block_pixels, int resident_cap, int chunk_pixels, int smem, int relu,
                   float eps, cudaStream_t stream) {
  cudaError_t err = allow_large_clusters<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(cluster, batch, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, adain_cluster<T>, static_cast<const T*>(x),
                           static_cast<const T*>(weight), w_stride,
                           static_cast<const T*>(bias), b_stride, static_cast<T*>(out), hw, c,
                           block_pixels, resident_cap, chunk_pixels, relu, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t active_clusters(int cluster, int smem, int* count) {
  cudaError_t err = allow_large_clusters<T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config<T>(cluster, 1, smem, 0, attr);
  return cudaOccupancyMaxActiveClusters(count, adain_cluster<T>, &cfg);
}

}  // namespace

// plan: {hw, c, cluster, block_pixels, resident_cap, chunk_pixels, smem,
// dtype} from ops/adain.py plan_launch (dtype: 0 = float32, 1 = bfloat16):
// cluster blocks per sample, block_pixels per block, at most resident_cap of
// them (in chunks of chunk_pixels, at most kMaxChunks) held in smem bytes of
// shared memory.  Returns a cudaError_t (0 on success).  The caller has
// checked shapes and alignment and that C / (16 / itemsize) is at most
// kThreads channel vectors.
extern "C" int adain_fused_forward(const void* x, const void* weight, long long w_stride,
                                   const void* bias, long long b_stride, void* out, int batch,
                                   const int* plan, int relu, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = plan[0], c = plan[1], cluster = plan[2], block_pixels = plan[3],
            resident_cap = plan[4], chunk_pixels = plan[5], smem = plan[6], dtype = plan[7];
  if (dtype == 0)
    return launch<float>(x, weight, w_stride, bias, b_stride, out, batch, hw, c, cluster,
                         block_pixels, resident_cap, chunk_pixels, smem, relu, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, weight, w_stride, bias, b_stride, out, batch, hw, c,
                                 cluster, block_pixels, resident_cap, chunk_pixels, smem, relu,
                                 eps, s);
  return cudaErrorInvalidValue;
}

// How many clusters of `cluster` blocks with `smem` bytes each the card can
// hold at once (0: the plan cannot launch).
extern "C" int adain_max_active_clusters(int cluster, int smem, int dtype, int* count) {
  if (dtype == 0) return active_clusters<float>(cluster, smem, count);
  if (dtype == 1) return active_clusters<__nv_bfloat16>(cluster, smem, count);
  return cudaErrorInvalidValue;
}
