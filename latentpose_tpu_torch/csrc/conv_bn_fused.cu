// Fused BN-apply -> ReLU -> 1x1 conv -> BN statistics for Hopper (sm_90a):
//
//   y     = relu(x * scale + offset) @ W            (M, Cout) in x's dtype
//   stats = (sum_m y, sum_m y^2) per output channel (2, Cout) in f32
//
// Replaces the TPU kernel latentpose_tpu/ops/pallas/conv_bn_fused.py:58
// (bn_relu_conv1x1_stats, body _kernel).  In the ResNeXt-50 identity tower it
// is the bottleneck's bn2 -> ReLU -> conv3 link: x is conv2's output (NHWC,
// flattened to M rows of Cin channels), scale/offset fold bn2, W is conv3's
// (Cout, Cin) weight, and stats are what a train-mode bn3 would need.
//
// What bounds it on this card.  A 1x1 conv is an (M, Cin) x (Cin, Cout)
// product.  layer1's (M, 128 -> 256) link does ~85 FLOP per byte of bf16
// traffic, below the H100's ~295 FLOP/byte ridge, so it is bound by device
// memory; layer3's (512 -> 1024) and layer4's (1024 -> 2048) links are bound
// by the tensor cores.
//
// The design is a Hopper GEMM with the BN prologue in registers:
//   * a tile of y is 128 rows (two consumer warpgroups of 64) by 256 columns
//     in bf16 (wgmma m64n256) or 128 in f32 (m64n128: three products need
//     the registers), and the block walks Cin in 128-byte slices (64 bf16 or
//     32 f32 channels);
//   * one thread of a producer warpgroup issues TMA loads of the x slice and
//     the W slice (both K-major, 128-byte swizzle) and bulk copies of the
//     slices of scale and offset into a ring of `stages` shared-memory
//     stages; mbarriers signal arrival (full) and release (empty).  The
//     producer warpgroup hands its registers to the consumers (setmaxnreg),
//     which the 128 accumulators of a bf16 thread need;
//   * each consumer thread loads its raw x fragment from shared memory into
//     registers, applies x * scale[k] + offset[k] and the ReLU in f32, rounds
//     to W's dtype (as the plain version and the Pallas kernel do), and feeds
//     the fragment to wgmma in its register-A form, so the normalised
//     activation never reaches device or shared memory.  Two fragments
//     alternate: step k's products run while step k+1's fragment is built;
//   * bf16: wgmma .f32.bf16.bf16, f32 accumulators.  f32: 3xTF32, so the
//     result keeps f32 accuracy: A splits in registers into a_big = tf32(a)
//     and a_small = tf32(a - a_big), W arrives pre-split by the wrapper into
//     w_big and w_small, and a_small*w_big + a_big*w_small + a_big*w_big of
//     each k tile go into fresh registers that f32 adds fold into the
//     accumulators, so the tensor cores' accumulation rounding spans one
//     tile, not all of Cin ("tf32" here is truncation to 10 mantissa bits,
//     done explicitly, so the tensor cores' input rounding never matters);
//   * the grid is persistent (one block per SM, each walking the tiles b,
//     b + gridDim, ...) and the ring's stage counter runs across tiles, so
//     the producer loads the next tile while the consumers finish this one;
//   * the epilogue takes Σy and Σy² from the f32 accumulators (y is never
//     read back), reduces them over the tile's rows in a fixed order, and
//     writes per-row-tile partials; a second small launch reduces those in
//     a fixed order (deterministic, no atomics).  y goes through a staging
//     buffer in shared memory to coalesced 16-byte stores;
//   * ragged M, Cin and Cout: TMA fills out-of-range elements with zeros, and
//     the prologue zeroes rows past M and channels past Cin, so they add
//     nothing to y or the sums; stores and sums are masked past M and Cout.
//     Cin and Cout must be multiples of the 16-byte vector (4 f32 or 8 bf16),
//     which the wrapper checks.
// Overlapping one tile's epilogue with the next tile's products (two
// consumer sets in turn), bn3's apply in the epilogue and the backward are
// later work.

#include <cuda.h>   // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                    // rows of y per tile
constexpr int kSliceBytes = 128;            // K bytes per stage: the swizzle span
constexpr int kConsumers = 2;               // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
// Registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65536, the
// 384 x 168 the block starts with.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTileBytes = kBM * kSliceBytes;     // the x slice of a stage
constexpr int kStageCols = 128;             // columns of y staged at a time in the epilogue
constexpr int kSmemLimit = 232448;

template <typename T>
struct Traits;

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kBN = 256;         // columns of y per tile
  static constexpr int kBK = 64;          // channels per stage
  static constexpr int kStep = 16;        // K of one wgmma
  static constexpr int kWTiles = 1;       // W
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

template <>
struct Traits<float> {
  static constexpr int kBN = 128;
  static constexpr int kBK = 32;
  static constexpr int kStep = 8;
  static constexpr int kWTiles = 2;       // w_big, w_small
  static constexpr CUtensorMapDataType kTmaType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the box at (k, row) of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major tile with 128-byte rows and 128-byte swizzle
// (as TMA writes it): 8-row atoms 1024 bytes apart.  Adding 2 advances K by
// 32 bytes (one wgmma step).
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of a register across the
// asynchronous wgmma that uses it.
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// acc (64 rows x 256 columns of f32, this thread's 128) += A (64 x 16, this
// thread's fragment a[4]) * B (256 x 16, K-major in shared memory, `desc`).
__device__ __forceinline__ void wgmma_bf16(float* acc, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
        "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]),
        "+f"(acc[36]), "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]),
        "+f"(acc[40]), "+f"(acc[41]), "+f"(acc[42]), "+f"(acc[43]),
        "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]), "+f"(acc[47]),
        "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
        "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]),
        "+f"(acc[56]), "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]),
        "+f"(acc[60]), "+f"(acc[61]), "+f"(acc[62]), "+f"(acc[63]),
        "+f"(acc[64]), "+f"(acc[65]), "+f"(acc[66]), "+f"(acc[67]),
        "+f"(acc[68]), "+f"(acc[69]), "+f"(acc[70]), "+f"(acc[71]),
        "+f"(acc[72]), "+f"(acc[73]), "+f"(acc[74]), "+f"(acc[75]),
        "+f"(acc[76]), "+f"(acc[77]), "+f"(acc[78]), "+f"(acc[79]),
        "+f"(acc[80]), "+f"(acc[81]), "+f"(acc[82]), "+f"(acc[83]),
        "+f"(acc[84]), "+f"(acc[85]), "+f"(acc[86]), "+f"(acc[87]),
        "+f"(acc[88]), "+f"(acc[89]), "+f"(acc[90]), "+f"(acc[91]),
        "+f"(acc[92]), "+f"(acc[93]), "+f"(acc[94]), "+f"(acc[95]),
        "+f"(acc[96]), "+f"(acc[97]), "+f"(acc[98]), "+f"(acc[99]),
        "+f"(acc[100]), "+f"(acc[101]), "+f"(acc[102]), "+f"(acc[103]),
        "+f"(acc[104]), "+f"(acc[105]), "+f"(acc[106]), "+f"(acc[107]),
        "+f"(acc[108]), "+f"(acc[109]), "+f"(acc[110]), "+f"(acc[111]),
        "+f"(acc[112]), "+f"(acc[113]), "+f"(acc[114]), "+f"(acc[115]),
        "+f"(acc[116]), "+f"(acc[117]), "+f"(acc[118]), "+f"(acc[119]),
        "+f"(acc[120]), "+f"(acc[121]), "+f"(acc[122]), "+f"(acc[123]),
        "+f"(acc[124]), "+f"(acc[125]), "+f"(acc[126]), "+f"(acc[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// acc (64 rows x 128 columns of f32, this thread's 64) = A (64 x 8, this
// thread's fragment a[4]) * B (128 x 8, K-major in shared memory, `desc`),
// plus acc where `accumulate` is not 0.
__device__ __forceinline__ void wgmma_tf32(float* acc, const uint32_t* a, uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
        "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]),
        "+f"(acc[36]), "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]),
        "+f"(acc[40]), "+f"(acc[41]), "+f"(acc[42]), "+f"(acc[43]),
        "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]), "+f"(acc[47]),
        "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
        "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]),
        "+f"(acc[56]), "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]),
        "+f"(acc[60]), "+f"(acc[61]), "+f"(acc[62]), "+f"(acc[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ uint32_t tf32(float v) { return __float_as_uint(v) & 0xFFFFE000u; }

// The prologue on one 32-bit word of x: relu(x * scale + offset) rounded to
// W's dtype, or 0 for a row past M or a channel past Cin (`ok` false).
// `sc` and `of` point at the word's first channel in the stage's slices.
template <typename T>
struct Prologue;

template <>
struct Prologue<__nv_bfloat16> {
  // a word holds two channels
  __device__ __forceinline__ static uint32_t apply(uint32_t word, const float* sc,
                                                   const float* of, bool ok, bool relu) {
    if (!ok) return 0u;
    const float2 s = *reinterpret_cast<const float2*>(sc);
    const float2 o = *reinterpret_cast<const float2*>(of);
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&word);
    float2 v = __bfloat1622float2(h);
    v.x = v.x * s.x + o.x;
    v.y = v.y * s.y + o.y;
    if (relu) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
    }
    h = __floats2bfloat162_rn(v.x, v.y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

template <>
struct Prologue<float> {
  // a word holds one channel
  __device__ __forceinline__ static float apply(uint32_t word, const float* sc, const float* of,
                                                bool ok, bool relu) {
    if (!ok) return 0.f;
    const float v = __uint_as_float(word) * *sc + *of;
    return relu ? fmaxf(v, 0.f) : v;
  }
};

// One bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16) into
// shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A consumer thread's A operand for one ring step: kSteps wgmma fragments of
// four 32-bit registers (f32: the tf32 parts big and small).
template <typename T>
struct Frag {
  static constexpr int kSteps = Traits<T>::kBK / Traits<T>::kStep;   // 4 in both dtypes
  uint32_t big[kSteps][4];
  uint32_t small[Traits<T>::kWTiles == 2 ? kSteps : 1][4];
};

// The consumer side of the ring, for one thread of a consumer warpgroup.
template <typename T>
struct Ring {
  using Tr = Traits<T>;
  static constexpr int kWBytes = Tr::kBN * kSliceBytes;   // a W slice of a stage
  static constexpr int kStageBytes = kTileBytes + Tr::kWTiles * kWBytes;
  static constexpr int kAcc = Tr::kBN / 2;                // accumulators a thread
  static constexpr int kSteps = Frag<T>::kSteps;
  unsigned char* smem;
  const float* coef;
  uint64_t* full;
  uint64_t* empty;
  int stages, ktiles, cin, tile_row, g, t, lane;
  bool row_ok0, row_ok1, relu;

  // The fragment of ring step `at` (k tile kt): wait for the stage, then
  // wgmma step ks reads the 16-byte chunks 2ks and 2ks+1 of rows g and g + 8
  // at byte 4t (in the swizzled tile chunk c of row r sits at chunk
  // c ^ (r % 8), and r % 8 == g for both rows) and applies the prologue.
  __device__ __forceinline__ void load(int at, int kt, Frag<T>& frag) const {
    const int s = at % stages;
    mbar_wait(&full[s], (at / stages) & 1);
    const unsigned char* stage = smem + s * kStageBytes;
    const float* sc = coef + s * 2 * Tr::kBK;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = tile_row + (i & 1) * 8;
        const int chunk = 2 * ks + (i >> 1);
        const uint32_t word = *reinterpret_cast<const uint32_t*>(
            stage + row * kSliceBytes + ((chunk ^ g) << 4) + 4 * t);
        // the word's first channel in the tile: 8 bf16 or 4 f32 a chunk
        const int kk = chunk * (16 / (int)sizeof(T)) + t * (4 / (int)sizeof(T));
        const bool ok = ((i & 1) ? row_ok1 : row_ok0) && kt * Tr::kBK + kk < cin;
        if constexpr (Tr::kWTiles == 1) {
          frag.big[ks][i] = Prologue<T>::apply(word, sc + kk, sc + Tr::kBK + kk, ok, relu);
        } else {
          const float a = Prologue<T>::apply(word, sc + kk, sc + Tr::kBK + kk, ok, relu);
          frag.big[ks][i] = tf32(a);
          frag.small[ks][i] = tf32(a - __uint_as_float(frag.big[ks][i]));
        }
      }
    }
  }

  // Ring step `at` (k tile kt) on fragment `cur`: issue its products,
  // build the next step's fragment in `next` while they run, wait for them,
  // release the stage.
  __device__ __forceinline__ void step(int at, int kt, float (&acc)[kAcc], Frag<T>& cur,
                                       Frag<T>& next) const {
    const int s = at % stages;
    const unsigned char* stage = smem + s * kStageBytes;
    // f32: the step's 3xTF32 products go to fresh registers, then into acc
    // by f32 adds, so the tensor cores' own accumulation rounding spans one
    // k tile, not all of Cin.
    float part[Tr::kWTiles == 2 ? kAcc : 1];
    wgmma_fence();
    const uint64_t w_desc = tile_desc(stage + kTileBytes);
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      if constexpr (Tr::kWTiles == 1) {
        wgmma_bf16(acc, cur.big[ks], w_desc + 2 * ks);
      } else {
        const uint64_t w_small_desc = tile_desc(stage + kTileBytes + kWBytes);
        wgmma_tf32(part, cur.small[ks], w_desc + 2 * ks, ks > 0);
        wgmma_tf32(part, cur.big[ks], w_small_desc + 2 * ks, 1);
        wgmma_tf32(part, cur.big[ks], w_desc + 2 * ks, 1);
      }
    }
    wgmma_commit();
    if (kt + 1 < ktiles) load(at + 1, kt + 1, next);
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) pin(acc[i]);
    if constexpr (Tr::kWTiles == 2) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        pin(part[i]);
        acc[i] += part[i];
      }
    }
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pin(cur.big[ks][i]);
        if constexpr (Tr::kWTiles == 2) pin(cur.small[ks][i]);
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bn_relu_conv1x1(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap w_map,
                const __grid_constant__ CUtensorMap w_small_map, const float* __restrict__ scale,
                const float* __restrict__ offset, T* __restrict__ y, float* __restrict__ partial,
                long long m, int cin, int cout, int col_tiles, int stages, int relu) {
  using Tr = Traits<T>;
  constexpr int kBN = Tr::kBN;
  constexpr int kWBytes = Ring<T>::kWBytes;
  constexpr int kStageBytes = Ring<T>::kStageBytes;
  constexpr int kAcc = Ring<T>::kAcc;
  constexpr int kPitch = kStageCols * (int)sizeof(T) + 16;   // a staged row of y, padded
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* coef = reinterpret_cast<float*>(smem + stages * kStageBytes);  // (stages, 2, kBK)
  unsigned char* staged = reinterpret_cast<unsigned char*>(coef + stages * 2 * Tr::kBK);
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + kBM * kPitch);  // (kBM, kPitch) of y
  uint64_t* empty = full + stages;
  float* red = reinterpret_cast<float*>(empty + stages);   // (8 warps, 2, kBN)

  const long long tiles = (long long)((m + kBM - 1) / kBM) * col_tiles;
  const int ktiles = (cin + Tr::kBK - 1) / Tr::kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // The grid is persistent: block b takes tiles b, b + gridDim.x, ...
  // (column tiles fastest, so the blocks that share an x slice run
  // together).  The ring's stage counter runs on across tiles, so the
  // producer loads the next tile while the consumers finish this one.
  if (warp >= 4 * kConsumers) {
    // The producer warpgroup gives its registers to the consumers; one
    // thread issues the loads.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == 4 * kConsumers && lane == 0) {
      int it = 0;
      for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (int)(tile / col_tiles) * kBM;
        const int n0 = (int)(tile % col_tiles) * kBN;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
          const int s = it % stages;
          mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
          unsigned char* stage = smem + s * kStageBytes;
          const int k0 = kt * Tr::kBK;
          // the stage's slices of scale and offset (Cin % 4 == 0: whole 16 bytes)
          const uint32_t coef_bytes = (uint32_t)min(Tr::kBK, cin - k0) * 4;
          mbar_expect(&full[s], kStageBytes + 2 * coef_bytes);
          tma_load(stage, &x_map, k0, m0, &full[s]);
          tma_load(stage + kTileBytes, &w_map, k0, n0, &full[s]);
          if (Tr::kWTiles == 2)
            tma_load(stage + kTileBytes + kWBytes, &w_small_map, k0, n0, &full[s]);
          bulk_load(coef + s * 2 * Tr::kBK, scale + k0, coef_bytes, &full[s]);
          bulk_load(coef + (s * 2 + 1) * Tr::kBK, offset + k0, coef_bytes, &full[s]);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows [wg * 64, wg * 64 + 64) of a tile;
  // this thread's fragment rows are g and g + 8 of its warp's 16.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4, wwarp = warp % 4, g = lane / 4, t = lane % 4;
  const int tile_row = wg * 64 + wwarp * 16 + g;
  unsigned char* stage_y = staged + wg * 64 * kPitch;
  int it = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row_tile = tile / col_tiles;
    const long long m0 = row_tile * kBM;
    const int n0 = (int)(tile % col_tiles) * kBN;
    const bool row_ok[2] = {m0 + tile_row < m, m0 + tile_row + 8 < m};

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

    // Two fragments in turn: step kt's products run while step kt + 1's
    // fragment is built.
    const Ring<T> ring{smem, coef, full, empty, stages, ktiles, cin, tile_row, g, t, lane,
                       row_ok[0], row_ok[1], relu != 0};
    Frag<T> frag_a, frag_b;
    ring.load(it, 0, frag_a);
    for (int kt = 0; kt < ktiles; kt += 2, it += 2) {
      ring.step(it, kt, acc, frag_a, frag_b);
      if (kt + 1 < ktiles) ring.step(it + 1, kt + 1, acc, frag_b, frag_a);
    }
    it -= (ktiles & 1);   // an odd count ran one step fewer than counted

    // Column sums of the tile from the f32 accumulators.  acc[4j + e] is
    // row g + 8 * (e >> 1), column 8j + 2t + (e & 1) of this warp's
    // 16 x kBN.  Rows past M hold exact zeros.
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float a = acc[4 * j + e], b = acc[4 * j + 2 + e];
        float sum = a + b, sq = a * a + b * b;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
          sq += __shfl_xor_sync(0xFFFFFFFFu, sq, off);
        }
        if (g == 0) {
          red[(warp * 2) * kBN + 8 * j + 2 * t + e] = sum;
          red[(warp * 2 + 1) * kBN + 8 * j + 2 * t + e] = sq;
        }
      }
    }
    // y, kStageCols columns at a time: the warpgroup's 64 rows in x's dtype
    // into its staging rows (padded by 16 bytes against bank conflicts), then
    // 16-byte stores.  The first barrier also publishes the column sums.
#pragma unroll
    for (int part = 0; part < kBN / kStageCols; ++part) {
#pragma unroll
      for (int jj = 0; jj < kStageCols / 8; ++jj) {
        const int j = part * (kStageCols / 8) + jj;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned char* p = stage_y + (wwarp * 16 + g + 8 * half) * kPitch +
                             (8 * jj + 2 * t) * (int)sizeof(T);
          const float a = acc[4 * j + 2 * half], b = acc[4 * j + 2 * half + 1];
          if constexpr (sizeof(T) == 2) {
            *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
          } else {
            *reinterpret_cast<float2*>(p) = make_float2(a, b);
          }
        }
      }
      named_sync(1, 128 * kConsumers);   // staged y (and the sums) are written

      if (part == 0) {
        for (int col = threadIdx.x; col < kBN; col += 128 * kConsumers) {
          if (n0 + col >= cout) break;
          float sum = 0.f, sq = 0.f;
#pragma unroll
          for (int w = 0; w < 4 * kConsumers; ++w) {
            sum += red[(w * 2) * kBN + col];
            sq += red[(w * 2 + 1) * kBN + col];
          }
          float* out = partial + (size_t)row_tile * 2 * cout;
          out[n0 + col] = sum;
          out[cout + n0 + col] = sq;
        }
      }
      constexpr int kChunksPerRow = kStageCols * (int)sizeof(T) / 16;
      constexpr int kPerChunk = 16 / (int)sizeof(T);
      const int tid = threadIdx.x % 128;
      for (int idx = tid; idx < 64 * kChunksPerRow; idx += 128) {
        const int row = idx / kChunksPerRow, chunk = idx % kChunksPerRow;
        const long long gm = m0 + wg * 64 + row;
        const int gn = n0 + part * kStageCols + chunk * kPerChunk;
        if (gm < m && gn < cout)   // cout % kPerChunk == 0: a chunk is all in or all out
          *reinterpret_cast<uint4*>(y + gm * cout + gn) =
              *reinterpret_cast<const uint4*>(stage_y + row * kPitch + chunk * 16);
      }
      named_sync(1, 128 * kConsumers);   // staged y (and the sums) are read: reusable
    }
  }
}

// stats[0][c] = sum_t partial[t][0][c], stats[1][c] = sum_t partial[t][1][c]
// over the row tiles t, in a fixed order: a block of 32 x 32 threads takes
// 32 columns; row lane r sums the tiles t = r (mod 32) into four running
// sums (t / 32 mod 4) in increasing t, then the lanes fold in order.
constexpr int kFinalCols = 32, kFinalLanes = 32;

__global__ void __launch_bounds__(kFinalCols * kFinalLanes)
stats_finalize(const float* __restrict__ partial, float* __restrict__ stats,
               long long row_tiles, int cout) {
  __shared__ float fold[2][kFinalLanes][kFinalCols + 1];
  const int col = threadIdx.x % kFinalCols, r = threadIdx.x / kFinalCols;
  const int c = blockIdx.x * kFinalCols + col;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
  if (c < cout) {
    long long t = r;
    for (; t + 3 * kFinalLanes < row_tiles; t += 4 * kFinalLanes) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* p = partial + (size_t)(t + u * kFinalLanes) * 2 * cout + c;
        s[u] += p[0];
        q[u] += p[cout];
      }
    }
    for (int u = 0; t < row_tiles; t += kFinalLanes, ++u) {
      const float* p = partial + (size_t)t * 2 * cout + c;
      s[u] += p[0];
      q[u] += p[cout];
    }
  }
  fold[0][r][col] = (s[0] + s[1]) + (s[2] + s[3]);
  fold[1][r][col] = (q[0] + q[1]) + (q[2] + q[3]);
  __syncthreads();
  if (r == 0 && c < cout) {
    float ts = 0.f, tq = 0.f;
    for (int k = 0; k < kFinalLanes; ++k) {
      ts += fold[0][k][col];
      tq += fold[1][k][col];
    }
    stats[c] = ts;
    stats[cout + c] = tq;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (rows, cols) row-major tensor read in boxes of (box_rows, 128 bytes),
// 128-byte swizzle, zeros outside.
template <typename T>
bool encode(CUtensorMap* map, const void* base, long long rows, int cols, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Traits<T>::kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, Traits<T>::kTmaType, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* offset, const void* w,
                   const void* w_small, void* y, float* partial, float* stats, long long m,
                   int cin, int cout, int stages, int smem, int relu, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bn_relu_conv1x1<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return attr;
  CUtensorMap x_map, w_map, w_small_map;
  constexpr int kBN = Traits<T>::kBN;
  if (!encode<T>(&x_map, x, m, cin, kBM) || !encode<T>(&w_map, w, cout, cin, kBN) ||
      !encode<T>(&w_small_map, Traits<T>::kWTiles == 2 ? w_small : w, cout, cin, kBN))
    return cudaErrorInvalidValue;
  static const int sms = [] {
    int device = 0, count = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    return count;
  }();
  const long long row_tiles = (m + kBM - 1) / kBM;
  const int col_tiles = (cout + kBN - 1) / kBN;
  const long long tiles = row_tiles * col_tiles;
  bn_relu_conv1x1<T><<<(unsigned)(tiles < sms ? tiles : sms), kThreads, smem, stream>>>(
      x_map, w_map, w_small_map, scale, offset, static_cast<T*>(y), partial, m, cin, cout,
      col_tiles, stages, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_finalize<<<(cout + kFinalCols - 1) / kFinalCols, kFinalCols * kFinalLanes, 0, stream>>>(
      partial, stats, row_tiles, cout);
  return cudaGetLastError();
}

}  // namespace

// x (m, cin) and y (m, cout) contiguous in one dtype (0 = float32,
// 1 = bfloat16); w is conv3's (cout, cin) weight, contiguous, in x's dtype
// (for f32: its tf32 part, with w_small the tf32 part of the remainder; for
// bf16 w_small is unused); scale, offset (cin,) f32; partial
// (ceil(m / 128), 2, cout) and stats (2, cout) f32 scratch and output;
// stages and smem from ops/conv_bn.py plan_tiles.  Returns a cudaError_t
// (0 on success).  The caller has checked shapes, 16-byte alignment and
// cin % vec == cout % vec == 0.
extern "C" int bn_relu_conv1x1_stats_forward(const void* x, const float* scale,
                                             const float* offset, const void* w,
                                             const void* w_small, void* y, float* partial,
                                             float* stats, long long m, int cin, int cout,
                                             int stages, int smem, int dtype, int relu,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, scale, offset, w, w_small, y, partial, stats, m, cin, cout, stages,
                         smem, relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, scale, offset, w, w_small, y, partial, stats, m, cin, cout,
                                 stages, smem, relu, s);
  return cudaErrorInvalidValue;
}
