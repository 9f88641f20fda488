// int8 shared-MLP chain over point windows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ampnet_tpu/ops/pallas/quantized_mlp.py
// (quantized_mlp_chain, pl.pallas_call at :121). Per layer it computes
//   s_x = max(absmax(h over the block), 1e-12) / 127
//   hq  = clip(rint(h / s_x), -127, 127)                      (int8)
//   h   = relu(float(hq @ wq) * (s_x * s_w) + b)              (int32 sums)
// where a block is g consecutive windows (windows past m, up to a multiple
// of g, are zero windows that count toward their block's scale) and wq, s_w
// are the per-output-channel int8 weights and scales (ReLU on the last layer
// optional). It returns the last layer's activations [M, N, Cout], the
// per-window max [M, Cout], or both.
//
// What bounds it on this card: bytes. Its chains do 4.9k (mlp_a) to 61k
// (mlp_b) int8 MACs per point on 48-256 input bytes per point: 32 and 480
// operations per byte, below the ~590 where int8 tensor cores (1,979 TOP/s)
// overtake HBM (3.35 TB/s). What keeps it from that bound is the scale: layer
// l+1 cannot quantize until max|h_l| over a whole block (4096 rows at the
// served shapes; 2 MB of 128-wide fp32) is known, and a block does not fit
// one SM's shared memory.
//
// The design: recompute instead of store. The int32 dot is exact and the
// dequantization is elementwise, rounded step by step, so a layer's output
// recomputed from the same int8 inputs is bit-identical in every pass. For
// L layers the chain runs as L + 1 passes over 64-row tiles of one window:
//   * pass 0 (absmax_kernel): the per-block absmax of x;
//   * pass 1 quantizes x with s_0, writes it once as x_q (int8, in the
//     tiles' shared-memory image) and runs layer 0;
//   * pass p < L reads x_q and runs layers 0 .. p-1 on chip;
//   * each pass p < L folds max|h_p| into the block's word p (atomicMax on
//     the float's bits, which order like the floats because |h| >= 0);
//   * pass L runs all L layers and writes the activations and/or the pooled
//     maxima. Only x_q, the absmax words and the outputs touch device memory.
// Within a pass each warpgroup walks a contiguous run of tiles (persistent:
// as many as fit the SMs, up to 5 per block and per SM by registers). A
// block stages the pass's int8 weights, laid out once by
// ops/quantized_mlp.py::prepare_quantized_chain (K-major, zero-padded,
// core-matrix order), into shared memory once, by cp.async.bulk on an
// mbarrier, for all its warpgroups (a chain too wide for that streams one
// layer per tile, one warpgroup a block). x_q tiles arrive by cp.async.bulk
// into two buffers per warpgroup, the next tile's copy in flight while the
// current one multiplies. Products are wgmma m64nNk32 s8 x s8 -> s32 (N =
// 64, 128 or 256: each Cout padded up to one) with both operands K-major in
// shared memory, no swizzle; a 256-wide layer that does not overwrite its
// own A tile runs as two 128-wide halves, so that the kernel holds half the
// accumulators and more warpgroups fit an SM.
// Each hidden epilogue dequantizes (s_x * s_w once per column per tile),
// adds the bias, applies ReLU and quantizes with the next layer's scale
// straight into the next layer's int8 A tile in shared memory. Pooled
// maxima are reduced per tile in registers and shared memory, kept per run
// of a window's tiles in shared memory, and folded into device memory with
// atomicMax on an order-preserving integer image of the float (any sign:
// relu_last=0 gives negatives); the block that completes a window's count
// of tiles decodes its maxima. max does not depend on order, so the result
// is deterministic.
//
// The plan does 1.7x (mlp_b) the chain's products and some 640 quantizing
// divisions per mlp_b row; on the card its epilogues and the passes'
// latency, not bytes or the tensor cores, keep it above the bound
// (kernel_timing.py --variants and --passes, PERF.md section 6).
//
// Rounding matches the plain PyTorch version bit for bit: correctly rounded
// division (div_rn: the reciprocal alone would not do), round half to even,
// and dequantization as a rounded product then a rounded sum (no FMA).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kRows = 64;      // rows per tile: the wgmma M
constexpr int kThreads = 128;  // threads of one warpgroup
constexpr int kK = 32;         // wgmma depth in int8 values
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 256;
constexpr int kHeader = 128;    // mbarriers: two x_q buffers per warpgroup, weights
constexpr int kWeightBar = 96;  // byte offset of the weights' mbarrier
constexpr int kMaxWgs = 5;      // consumer warpgroups per block, at most
static_assert(16 * kMaxWgs <= kWeightBar && kWeightBar + 8 <= kHeader, "mbarriers overlap");
constexpr int kSmemLimit = 232448 - 1024;   // dynamic shared memory a block may ask for
constexpr int kAbsmaxThreads = 256;
constexpr int kAbsmaxChunk = kAbsmaxThreads * 16;  // elements per absmax block
constexpr int kMaxDevices = 64;

struct Params {
  const float* x;    // [m, n, cin] fp32
  int8_t* xq;        // [m_pad * tiles][kRows * kpad[0]] tile images, or null
  const int8_t* w[kMaxLayers];  // [npad/8][kpad/16][8][16]: K-major core matrices
  const float* s[kMaxLayers];   // [npad] weight scales, zero past cout
  const float* b[kMaxLayers];   // [npad] biases, zero past cout
  int kpad[kMaxLayers], npad[kMaxLayers], w_off[kMaxLayers];
  unsigned* amax;     // [n_layers][groups] bits of each block's input absmax
  unsigned* keys;     // [m][cout] pooled maxima as order keys, or null
  int* win_done;      // [m] tiles of each window pooled so far, or null
  float* acts;        // [m, n, cout] or null
  float* pooled;      // [m, cout] or null
  int m, n, cin, cout, g, groups, tiles, n_layers, relu_last;
  long long tiles_total;  // tiles this pass walks
  // the pass: layers run, whether it writes the outputs (else it folds
  // max|h_depth| into amax word depth), whether it quantizes x (else it
  // reads x_q), whether the weights stay resident, and the shared layout
  int depth, final_pass, from_x, resident, w_bytes, kwork, in_bufs;
  int wg_bytes;  // shared memory of one warpgroup: x_q tiles, work tile, pool
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// one contiguous global -> shared copy, completing on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy shared stores made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, then the byte
// offsets between core matrices adjacent in K (leading) and in M/N (stride)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32);
}

#define ACC8(i)                                                                                \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])
#define ACC32(i) ACC8(i), ACC8(i + 8), ACC8(i + 16), ACC8(i + 24)

// d[64 x N] += A[64 x 32] . B[N x 32]^T, both int8 K-major in shared memory
template <int N>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : ACC32(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : ACC32(0), ACC32(32)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(int* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : ACC32(0), ACC32(32), ACC32(64), ACC32(96)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC32
#undef ACC8

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float block_scale(const unsigned* amax, int group) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax[group]), 1e-12f), 127.0f);
}

// v / s_x rounded to nearest even, as __fdiv_rn gives it, without its range
// check and slow path: r_x = RN(1 / s_x) (__frcp_rn, once per tile), one
// Newton step makes y a faithful quotient, and a second, with the remainder
// v - s_x * y exact in an FMA, rounds it correctly (Markstein's theorem; no
// underflow or overflow). Every quotient a quantization meets here lies in
// [-127.00002, 127.00002] with s_x a normal float; where one underflows it
// rounds to 0 either way. tests/test_torch_quantized.py holds this against
// exact rational division, half-integer ties and the clamp included.
__device__ __forceinline__ float div_rn(float v, float s_x, float r_x) {
  float y = __fmul_rn(v, r_x);
  y = __fmaf_rn(r_x, __fmaf_rn(-s_x, y, v), y);
  return __fmaf_rn(r_x, __fmaf_rn(-s_x, y, v), y);
}

// 1.5 * 2^23. Added to a float of magnitude below 2^22 it leaves that float
// rounded to an integer (ties to even) in the low mantissa bits; a float of
// bits kMagicBits + k, for |k| < 2^22, is kMagic + k. So int <-> float
// conversions run on the FP32 and integer pipes, not at the quarter rate of
// the conversion instructions (tests/test_torch_quantized.py checks both).
constexpr float kMagic = 12582912.0f;
constexpr int kMagicBits = 0x4B400000;

// an int32 sum (|acc| <= 127 * 127 * 256 < 2^22) as a float, exactly
__device__ __forceinline__ float to_float(int acc) {
  return __fsub_rn(__int_as_float(acc + kMagicBits), kMagic);
}

// clip(rint(v / s_x), -127, 127) as an int8 in the low byte (half to even;
// clipping before rounding gives the same, the bounds being integers)
__device__ __forceinline__ unsigned quantize(float v, float s_x, float r_x) {
  const float q = fminf(fmaxf(div_rn(v, s_x, r_x), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(q, kMagic)) & 0xffu;
}

// the same for v >= 0 (after a ReLU), whose quotient is >= 0
__device__ __forceinline__ unsigned quantize_relu(float v, float s_x, float r_x) {
  return __float_as_uint(__fadd_rn(fminf(div_rn(v, s_x, r_x), 127.f), kMagic)) & 0xffu;
}

// four int8 values, the first in the lowest byte
__device__ __forceinline__ unsigned pack4(float a, float b, float c, float d, float s_x,
                                          float r_x) {
  return quantize(a, s_x, r_x) | quantize(b, s_x, r_x) << 8 | quantize(c, s_x, r_x) << 16 |
         quantize(d, s_x, r_x) << 24;
}

// an unsigned image of a float that orders like the float, for any sign; 0
// lies below every float's image
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// byte offset of element (r, k) of a [kRows, kst] int8 tile in core-matrix
// order: core matrix (r / 8, k / 16) at 128 bytes each, row r % 8 at 16 bytes
__device__ __forceinline__ int tile_offset(int r, int k, int kst) {
  return ((r >> 3) * (kst >> 4) + (k >> 4)) * 128 + (r & 7) * 16 + (k & 15);
}

// grid (groups, chunks): the absmax of each block of g windows of x; the
// zero windows past the real ones add nothing. 16-byte loads where the
// group's own start is 16-byte aligned, then the rest (the last end % 4
// elements, or all of an unaligned group) one float at a time.
__global__ void __launch_bounds__(kAbsmaxThreads)
absmax_kernel(const float* __restrict__ x, long long group_elems, long long total,
              unsigned* __restrict__ amax) {
  const long long base = (long long)blockIdx.x * group_elems;
  const long long end = min(group_elems, total - base);
  const float* p = x + base;
  const long long stride = (long long)gridDim.y * kAbsmaxThreads;
  const long long first = (long long)blockIdx.y * kAbsmaxThreads + threadIdx.x;
  float m = 0.f;
  long long vec_end = 0;  // elements read by the 16-byte loads
  if (((uintptr_t)p & 15) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const long long end4 = end / 4;
#pragma unroll 4
    for (long long i = first; i < end4; i += stride) {
      const float4 v = __ldg(p4 + i);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    vec_end = 4 * end4;
  }
  for (long long i = vec_end + first; i < end; i += stride) m = fmaxf(m, fabsf(__ldg(p + i)));
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) atomicMax(&amax[blockIdx.x], __float_as_uint(m));
}

// whether layer l of a pass of `depth` layers runs as two products of half
// its width, one after the other: a 256-wide layer that does not write the
// work tile it reads (the pass's last layer, or layer 0, which reads x's
// tile). Half the accumulators, so more blocks fit an SM.
__host__ __device__ __forceinline__ bool split_layer(int l, int depth, int npad) {
  return npad == 256 && (l == 0 || l == depth - 1);
}

// One warpgroup's walk over its tiles in one pass.
struct Walker {
  const Params& p;
  unsigned char* w_smem;  // staged weights
  unsigned char* work;    // [kRows, kwork] hidden activations, int8
  float* red;             // [npad of the last layer] this window run's pooled maxima
  float* red4;            // [4 warps][npad of the last layer] this tile's, per warp
  uint32_t bar_w;
  uint32_t w_loads;       // weight copies waited for so far
  int wg;                 // this warpgroup in its block
  int warp, lane, tid;    // within the warpgroup
  // the current tile
  int window, row0, rows, group;
  float habs;             // this thread's max|h_depth| over the group's tiles

  // a barrier of this warpgroup's 128 threads alone
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(wg + 1), "r"(kThreads) : "memory");
  }

  // columns [n0, n0 + N) of layer l: the product of A (shared, at a_addr,
  // rows of a_kst bytes) and the weights at b_addr, then its epilogue.
  // Hidden layers quantize into the work tile.
  template <int N>
  __device__ void layer(int l, uint32_t a_addr, int a_kst, uint32_t b_addr, int n0) {
    const int kpad = p.kpad[l];
    b_addr += n0 * kpad;  // n0 / 8 core-matrix rows of kpad / 16 core matrices
    int acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0;
    fence_regs<N / 2>(acc);
    wgmma_fence();
#pragma unroll 1
    for (int k = 0; k < kpad; k += kK) {
      const uint32_t off = k * 8;  // two core matrices of K a step
      Mma<N>::run(acc, make_desc(a_addr + off, 128, a_kst * 8), make_desc(b_addr + off, 128, kpad * 8));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<N / 2>(acc);
    sync();  // every warp's products have read A and the weights

    const float s_in = block_scale(p.amax + (size_t)l * p.groups, group);
    const float* __restrict__ sw = p.s[l] + n0;
    const float* __restrict__ bias = p.b[l] + n0;
    const bool last = l == p.depth - 1;
    const bool relu = l < p.n_layers - 1 || p.relu_last;
    // accumulator layout: acc[4i + 2h + e] is row warp*16 + lane/4 + 8h,
    // column n0 + 8i + 2(lane % 4) + e
    const int r0 = warp * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    const bool ok0 = r0 < rows, ok1 = r0 + 8 < rows;

    if (!last) {  // hidden: the next layer's int8 A tile, in place
      const float s_next = block_scale(p.amax + (size_t)(l + 1) * p.groups, group);
      const float r_next = __frcp_rn(s_next);
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        unsigned q[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * i + c0 + e;
          const float sc = __fmul_rn(s_in, __ldg(sw + c));
          const float bc = __ldg(bias + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = __fadd_rn(__fmul_rn(to_float(acc[4 * i + 2 * h + e]), sc), bc);
            v = fmaxf(v, 0.f);
            q[h] |= quantize_relu(v, s_next, r_next) << (8 * e);
          }
        }
        const int c = n0 + 8 * i + c0;
        *reinterpret_cast<unsigned short*>(work + tile_offset(r0, c, p.kwork)) = (unsigned short)q[0];
        *reinterpret_cast<unsigned short*>(work + tile_offset(r0 + 8, c, p.kwork)) = (unsigned short)q[1];
      }
      fence_async_smem();
      sync();
      return;
    }

    if (!p.final_pass) {  // a scale pass: only max|h| of the tile's real rows
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * i + c0 + e;
          const float sc = __fmul_rn(s_in, __ldg(sw + c));
          const float bc = __ldg(bias + c);
          float v0 = __fadd_rn(__fmul_rn(to_float(acc[4 * i + e]), sc), bc);
          float v1 = __fadd_rn(__fmul_rn(to_float(acc[4 * i + 2 + e]), sc), bc);
          if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          if (ok0) habs = fmaxf(habs, fabsf(v0));
          if (ok1) habs = fmaxf(habs, fabsf(v1));
        }
      }
      return;
    }

    const int cout = p.cout;
    float* dst = p.acts != nullptr ? p.acts + ((size_t)window * p.n + row0) * cout : nullptr;
    const bool pairs = (cout & 1) == 0 && ((uintptr_t)p.acts & 7) == 0;
    float mx[N / 8][2];  // each column's max over the thread's two rows
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      float v[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * i + c0 + e;
        const float sc = __fmul_rn(s_in, __ldg(sw + c));
        const float bc = __ldg(bias + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float t = __fadd_rn(__fmul_rn(to_float(acc[4 * i + 2 * h + e]), sc), bc);
          v[h][e] = relu ? fmaxf(t, 0.f) : t;
        }
        mx[i][e] = fmaxf(ok0 ? v[0][e] : -CUDART_INF_F, ok1 ? v[1][e] : -CUDART_INF_F);
      }
      const int c = n0 + 8 * i + c0;
      if (dst != nullptr && c < cout) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!(h == 0 ? ok0 : ok1)) continue;
          float* q = dst + (size_t)(r0 + 8 * h) * cout + c;
          if (pairs) {
            *reinterpret_cast<float2*>(q) = make_float2(v[h][0], v[h][1]);
          } else {
            q[0] = v[h][0];
            if (c + 1 < cout) q[1] = v[h][1];
          }
        }
      }
    }
    if (red4 != nullptr) {  // each column's max over the warp's 16 rows
#pragma unroll
      for (int sh = 4; sh < 32; sh <<= 1) {
#pragma unroll
        for (int i = 0; i < N / 8; ++i) {
          mx[i][0] = fmaxf(mx[i][0], __shfl_xor_sync(0xffffffffu, mx[i][0], sh));
          mx[i][1] = fmaxf(mx[i][1], __shfl_xor_sync(0xffffffffu, mx[i][1], sh));
        }
      }
      if (lane < 4) {
        float* w = red4 + warp * p.npad[p.n_layers - 1] + n0 + c0;
#pragma unroll
        for (int i = 0; i < N / 8; ++i)
          *reinterpret_cast<float2*>(w + 8 * i) = make_float2(mx[i][0], mx[i][1]);
      }
    }
  }

  template <int NMAX>
  __device__ void chain(uint32_t a_addr) {
    int a_kst = p.kpad[0];
    for (int l = 0; l < p.depth; ++l) {
      const int np = p.npad[l];
      uint32_t b_addr = smem_addr(w_smem);
      if (p.resident) {
        b_addr += p.w_off[l];
      } else {  // one layer at a time: the previous layer's products are done
        if (tid == 0) {
          const uint32_t bytes = (uint32_t)np * p.kpad[l];
          mbar_expect_tx(bar_w, bytes);
          bulk_load(b_addr, p.w[l], bytes, bar_w);
        }
        mbar_wait(bar_w, w_loads & 1);
        ++w_loads;
      }
      if (np == 64) layer<64>(l, a_addr, a_kst, b_addr, 0);
      if constexpr (NMAX >= 128) {
        if (np == 128) layer<128>(l, a_addr, a_kst, b_addr, 0);
      }
      if constexpr (NMAX == 128) {
        if (np == 256) {  // split_layer: the host chose this kernel for it
          layer<128>(l, a_addr, a_kst, b_addr, 0);
          layer<128>(l, a_addr, a_kst, b_addr, 128);
        }
      }
      if constexpr (NMAX >= 256) {
        if (np == 256) layer<256>(l, a_addr, a_kst, b_addr, 0);
      }
      a_addr = smem_addr(work);
      a_kst = p.kwork;
    }
  }

  // the group's max|h_depth| into its word (a scale pass)
  __device__ void flush_amax(int grp) {
    const float m = warp_max(habs);
    if (lane == 0) atomicMax(&p.amax[(size_t)p.depth * p.groups + grp], __float_as_uint(m));
    habs = 0.f;
  }

  // this tile's per-warp maxima into the window run's
  __device__ void pool_tile() {
    sync();
    const int ld = p.npad[p.n_layers - 1];
    for (int c = tid; c < p.cout; c += kThreads)
      red[c] = fmaxf(fmaxf(red[c], fmaxf(red4[c], red4[ld + c])),
                     fmaxf(red4[2 * ld + c], red4[3 * ld + c]));
  }

  // the window run's maxima (`tiles` tiles of window win) into device
  // memory; the block that brings the window's last tile decodes its keys
  __device__ void flush_pool(int win, int tiles) {
    unsigned* keys = p.keys + (size_t)win * p.cout;
    for (int c = tid; c < p.cout; c += kThreads) {  // the threads that wrote red[c]
      atomicMax(keys + c, order_key(red[c]));
      red[c] = -CUDART_INF_F;
    }
    __threadfence();
    sync();
    __shared__ int done[kMaxWgs];
    if (tid == 0) done[wg] = atomicAdd(p.win_done + win, tiles) + tiles == p.tiles;
    sync();
    if (done[wg]) {
      __threadfence();
      for (int c = tid; c < p.cout; c += kThreads)
        p.pooled[(size_t)win * p.cout + c] = from_key(__ldcg(keys + c));
    }
    sync();  // `done` is read before the next flush writes it
  }

  // tile t's rows of x quantized with s_0 into the A tile `in`, and into
  // x_q when there is one; rows past the window's end, the zero windows and
  // columns past cin are zeros
  __device__ void stage_x(long long t, unsigned char* in) {
    const int kst = p.kpad[0], kg = kst / 16, cin = p.cin;
    const float s0 = block_scale(p.amax, group), r0 = __frcp_rn(s0);
    const bool real = window < p.m;
    const float* src = p.x + ((size_t)window * p.n + row0) * cin;
    int8_t* out = p.xq != nullptr ? p.xq + (size_t)t * kRows * kst : nullptr;
    const bool vec = (cin & 3) == 0 && ((uintptr_t)p.x & 15) == 0;
    constexpr int kBatch = 4;  // words per thread whose loads are in flight together
    for (int o0 = tid * 4; o0 < kRows * kst; o0 += kThreads * 4 * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int o = o0 + u * kThreads * 4;
        const int cm = o >> 7, rg = cm / kg;
        const int r = rg * 8 + ((o >> 4) & 7), k = (cm - rg * kg) * 16 + (o & 15);
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (o < kRows * kst && real && r < rows && k < cin) {
          const float* q = src + (size_t)r * cin + k;
          if (vec) {
            v[u] = __ldg(reinterpret_cast<const float4*>(q));
          } else {
            v[u].x = __ldg(q);
            if (k + 1 < cin) v[u].y = __ldg(q + 1);
            if (k + 2 < cin) v[u].z = __ldg(q + 2);
            if (k + 3 < cin) v[u].w = __ldg(q + 3);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int o = o0 + u * kThreads * 4;
        if (o >= kRows * kst) break;
        const unsigned word = pack4(v[u].x, v[u].y, v[u].z, v[u].w, s0, r0);
        *reinterpret_cast<unsigned*>(in + o) = word;
        if (out != nullptr) *reinterpret_cast<unsigned*>(out + o) = word;
      }
    }
    fence_async_smem();
    sync();
  }
};

// consumer warpgroups a block may hold, by the widest product: the register
// cap that follows (102, 128 or 255 a thread) lets 5, 4 or 2 warpgroups share
// an SM
template <int NMAX>
constexpr int kWgsFor = NMAX == 64 ? 5 : NMAX == 128 ? 4 : 2;

// one block holds blockDim.x / 128 consumer warpgroups that share the staged
// weights; each walks its own contiguous run of tiles
template <int NMAX>
__global__ void __launch_bounds__(kThreads * kWgsFor<NMAX>, 1)
chain_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nwg = blockDim.x / kThreads;
  const int wg = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  const uint32_t bar_in = smem_addr(smem) + 16 * wg;  // this warpgroup's two x_q buffers
  const uint32_t bar_w = smem_addr(smem) + kWeightBar;
  unsigned char* w_smem = smem + kHeader;
  unsigned char* in = w_smem + p.w_bytes + wg * p.wg_bytes;
  const int in_bytes = kRows * p.kpad[0];
  unsigned char* work = in + p.in_bufs * in_bytes;
  const bool pooling = p.final_pass && p.keys != nullptr;
  const int ld = p.npad[p.n_layers - 1];
  float* red = pooling ? reinterpret_cast<float*>(work + kRows * p.kwork) : nullptr;
  float* red4 = pooling ? red + ld : nullptr;

  // this warpgroup's tiles: a contiguous run, so its window changes rarely
  const long long runs = (long long)gridDim.x * nwg, run = (long long)blockIdx.x * nwg + wg;
  const long long t_begin = p.tiles_total * run / runs;
  const long long t_end = p.tiles_total * (run + 1) / runs;

  if (threadIdx.x == 0) {
    for (int w = 0; w < nwg; ++w) {
      mbar_init(smem_addr(smem) + 16 * w, 1);
      mbar_init(smem_addr(smem) + 16 * w + 8, 1);
    }
    mbar_init(bar_w, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (red != nullptr)
    for (int c = tid; c < ld; c += kThreads) red[c] = -CUDART_INF_F;
  __syncthreads();

  auto load_tile = [&](long long t, int buf) {
    const uint32_t bar = bar_in + 8 * buf;
    mbar_expect_tx(bar, in_bytes);
    bulk_load(smem_addr(in + buf * in_bytes), p.xq + (size_t)t * in_bytes, in_bytes, bar);
  };
  if (threadIdx.x == 0 && p.resident) {
    mbar_expect_tx(bar_w, p.w_bytes);
    for (int l = 0; l < p.depth; ++l)
      bulk_load(smem_addr(w_smem) + p.w_off[l], p.w[l], (uint32_t)p.npad[l] * p.kpad[l], bar_w);
  }
  if (tid == 0 && !p.from_x && t_begin < t_end) load_tile(t_begin, 0);
  uint32_t w_loads = 0;
  if (p.resident) {
    mbar_wait(bar_w, 0);
    w_loads = 1;
  }

  Walker wk{p, w_smem, work, red, red4, bar_w, w_loads, wg, tid / 32, tid % 32, tid};
  wk.habs = 0.f;
  int cur_group = -1, cur_window = -1, run_tiles = 0;
  for (long long t = t_begin; t < t_end; ++t) {
    const int j = (int)(t - t_begin);
    wk.window = (int)(t / p.tiles);
    wk.row0 = (int)(t - (long long)wk.window * p.tiles) * kRows;
    wk.rows = min(kRows, p.n - wk.row0);
    wk.group = wk.window / p.g;
    if (!p.final_pass && wk.group != cur_group && cur_group >= 0) wk.flush_amax(cur_group);
    if (pooling && wk.window != cur_window && cur_window >= 0) {
      wk.flush_pool(cur_window, run_tiles);
      run_tiles = 0;
    }
    cur_group = wk.group;
    cur_window = wk.window;
    uint32_t a_addr;
    if (p.from_x) {
      wk.stage_x(t, in);
      a_addr = smem_addr(in);
    } else {
      // the next tile's copy goes into the buffer the last tile's products
      // have finished reading
      const int buf = j & 1;
      if (tid == 0 && t + 1 < t_end) load_tile(t + 1, buf ^ 1);
      mbar_wait(bar_in + 8 * buf, (j >> 1) & 1);
      a_addr = smem_addr(in + buf * in_bytes);
    }
    wk.chain<NMAX>(a_addr);
    if (pooling) {
      wk.pool_tile();
      ++run_tiles;
    }
  }
  if (cur_group >= 0 && !p.final_pass) wk.flush_amax(cur_group);
  if (pooling && cur_window >= 0) wk.flush_pool(cur_window, run_tiles);
}

using KernelFn = void (*)(const Params);
const KernelFn kKernels[3] = {chain_kernel<64>, chain_kernel<128>, chain_kernel<256>};

std::mutex setup_mu;  // guards the two tables below

// Raise the chain kernels' dynamic shared-memory limit on the current device
// to kSmemLimit, once, and read its SM count. The limit belongs to the
// function on the whole device, not to one launch: setting it per call would
// let a concurrent caller's smaller setting land between another's setting
// and its launch.
cudaError_t device_setup(int* sms) {
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(setup_mu);
  if (sm_count[dev] == 0) {
    for (KernelFn k : kKernels) {
      err = cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemLimit);
      if (err != cudaSuccess) return err;
    }
    err = cudaDeviceGetAttribute(&sm_count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

// Blocks of chain kernel `kind` with `wgs` warpgroups and `smem` bytes of
// dynamic shared memory that fit one SM, asked of the runtime once per
// shape (every device of a process is taken to be the same card).
cudaError_t occupancy(int kind, int wgs, int smem, int* blocks) {
  static std::map<std::tuple<int, int, int>, int> known;
  std::lock_guard<std::mutex> lock(setup_mu);
  const auto key = std::make_tuple(kind, wgs, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, (const void*)kKernels[kind], kThreads * wgs, smem);
  if (err == cudaSuccess) known[key] = *blocks;
  return err;
}

}  // namespace

extern "C" int quantized_mlp_chain_tile_rows(void) { return kRows; }

// x [m, n, cin] fp32, at any float address; m_pad >= m a multiple of g
// (windows m .. m_pad-1 are zero windows, never read); layer l: w[l] as prepare_quantized_chain packs
// it (16-byte aligned) for depth kpad[l] and width npad[l], s[l] and b[l]
// [npad[l]], cout[l] real output channels. The caller chooses the padding
// (ops/quantized_mlp.py::prepare_quantized_chain); this checks that it is one
// the kernel runs. acts (nullable) [m, n, cout_last]; pooled (nullable) [m,
// cout_last]; xq [m_pad * ceil(n / tile_rows) * tile_rows * kpad[0]] int8
// (16-byte aligned; nullable for one layer); scratch [n_layers * m_pad / g
// (+ m * (cout_last + 1) when pooled)] 32-bit words. All contiguous, on the
// current device. Returns the first failing call's cudaError_t (0 = every
// launch was accepted).
extern "C" int quantized_mlp_chain_s8(
    const float* x, int m, int m_pad, int n, int cin, int g, int n_layers,
    const int8_t* const* w, const float* const* s, const float* const* b,
    const int* cout, const int* kpad, const int* npad, int relu_last,
    float* acts, float* pooled, int8_t* xq, unsigned* scratch, void* stream) {
  if (x == nullptr || m <= 0 || n <= 0 || cin <= 0 || cin > kMaxWidth || g <= 0 || m_pad < m ||
      m_pad % g != 0 || m_pad - m >= g || n_layers < 1 || n_layers > kMaxLayers ||
      scratch == nullptr || (acts == nullptr && pooled == nullptr) ||
      (n_layers > 1 && (xq == nullptr || ((uintptr_t)xq & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  for (int l = 0; l < n_layers; ++l) {
    const int np = npad[l], kp = kpad[l];
    if (w[l] == nullptr || s[l] == nullptr || b[l] == nullptr || ((uintptr_t)w[l] & 15) != 0 ||
        cout[l] <= 0 || cout[l] > np || (np != 64 && np != 128 && np != 256) || kp <= 0 ||
        kp > kMaxWidth || kp % kK != 0 || (l == 0 ? kp < cin : kp != npad[l - 1]))
      return (int)cudaErrorInvalidValue;
    p.w[l] = w[l];
    p.s[l] = s[l];
    p.b[l] = b[l];
    p.kpad[l] = kp;
    p.npad[l] = np;
  }
  const int tiles = (n + kRows - 1) / kRows;
  const int groups = m_pad / g;
  if ((long long)m_pad * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.x = x;
  p.xq = xq;
  p.m = m;
  p.n = n;
  p.cin = cin;
  p.cout = cout[n_layers - 1];
  p.g = g;
  p.groups = groups;
  p.tiles = tiles;
  p.n_layers = n_layers;
  p.relu_last = relu_last;
  p.amax = scratch;
  if (pooled != nullptr) {
    p.win_done = reinterpret_cast<int*>(scratch + (size_t)n_layers * groups);
    p.keys = scratch + (size_t)n_layers * groups + m;
  }
  p.acts = acts;
  p.pooled = pooled;

  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t words =
      (size_t)n_layers * groups + (pooled != nullptr ? (size_t)m * (p.cout + 1) : 0);
  err = cudaMemsetAsync(scratch, 0, sizeof(unsigned) * words, st);
  if (err != cudaSuccess) return (int)err;

  // pass 0: the absmax of x per block
  const long long group_elems = (long long)g * n * cin;
  long long chunks = (group_elems + kAbsmaxChunk - 1) / kAbsmaxChunk;
  if (chunks > 65535) chunks = 65535;
  absmax_kernel<<<dim3((unsigned)groups, (unsigned)chunks), kAbsmaxThreads, 0, st>>>(
      x, group_elems, (long long)m * n * cin, p.amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  for (int pass = 1; pass <= n_layers; ++pass) {
    p.depth = pass;
    p.final_pass = pass == n_layers;
    p.from_x = pass == 1;
    p.in_bufs = p.from_x ? 1 : 2;
    p.xq = p.from_x && n_layers == 1 ? nullptr : xq;
    // the final pass skips the zero windows: their outputs are not kept
    p.tiles_total = (long long)(p.final_pass ? m : m_pad) * tiles;
    int nmax = 0, w_sum = 0, w_max = 0;
    p.kwork = 0;
    for (int l = 0; l < pass; ++l) {
      const int bytes = npad[l] * kpad[l];
      p.w_off[l] = w_sum;
      w_sum += bytes;
      w_max = bytes > w_max ? bytes : w_max;
      const int width = split_layer(l, pass, npad[l]) ? 128 : npad[l];
      nmax = width > nmax ? width : nmax;
      if (l < pass - 1 && npad[l] > p.kwork) p.kwork = npad[l];
    }
    p.wg_bytes = p.in_bufs * kRows * kpad[0] + kRows * p.kwork +
                 (p.final_pass && pooled != nullptr ? 5 * 4 * npad[n_layers - 1] : 0);
    p.resident = kHeader + w_sum + p.wg_bytes <= kSmemLimit;
    p.w_bytes = p.resident ? w_sum : w_max;
    // warpgroups per block: as many on an SM as registers and shared memory
    // allow, in as few blocks as that takes (each block stages the weights
    // once); one when the weights stream, since they then go layer by layer
    const int kind = nmax == 64 ? 0 : nmax == 128 ? 1 : 2;
    const int max_wgs = p.resident ? (kind == 0 ? 5 : kind == 1 ? 4 : 2) : 1;
    int wgs = 0, per_sm = 0;
    for (int k = 1; k <= max_wgs; ++k) {
      const int smem = kHeader + p.w_bytes + k * p.wg_bytes;
      if (smem > kSmemLimit) break;
      int blocks_per_sm = 0;
      err = occupancy(kind, k, smem, &blocks_per_sm);
      if (err != cudaSuccess) return (int)err;
      if (blocks_per_sm * k >= per_sm * wgs && blocks_per_sm > 0) wgs = k, per_sm = blocks_per_sm;
    }
    if (wgs == 0) return (int)cudaErrorInvalidConfiguration;
    const int smem = kHeader + p.w_bytes + wgs * p.wg_bytes;
    const long long need = (p.tiles_total + wgs - 1) / wgs, fit = (long long)sms * per_sm;
    const long long blocks = need < fit ? need : fit;
    const int threads = kThreads * wgs;
    if (kind == 0)
      chain_kernel<64><<<(unsigned)blocks, threads, smem, st>>>(p);
    else if (kind == 1)
      chain_kernel<128><<<(unsigned)blocks, threads, smem, st>>>(p);
    else
      chain_kernel<256><<<(unsigned)blocks, threads, smem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
