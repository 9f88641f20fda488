// Fused shared-MLP chain over point windows, fp32-accurate, on Hopper's
// tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel ampnet_tpu/ops/pallas/fused_mlp.py
// (fused_mlp_chain, pl.pallas_call at :144). Per layer it computes
// h <- relu(h @ W' + b') with inference BatchNorm already folded into W', b'
// (ReLU on the last layer optional); it returns the last layer's activations
// [M, N, Cout], the per-window max [M, Cout], or both. Pool-only calls never
// write activations to device memory.
//
// What bounds it on this card: operations, at the 3xTF32 rate (three TF32
// products per fp32 product, 495 TFLOP/s dense), for the T-Net trunks and
// mlp_b; bytes for mlp_a (12->64->64, which writes 256 bytes a point). Its
// chains do 4.9k-61k MACs a point on 12-256 bytes of input a point.
//
// Why three products and not one: the kernel is held to 1e-4 of max|ref|
// against the fp32 plain version. Emulated on the served chains (BatchNorm
// folded, x ~ N(0, 1), rna rounding, fp32 sums), one TF32 product per
// fp32 product errs by 4.1e-4 to 5.9e-4 of max|ref|: 4-6x over. Splitting
// each operand into hi = rna_tf32(x) and lo = rna_tf32(x - hi) and summing
// lo*hi + hi*lo + hi*hi errs by 2.3e-7 to 4.1e-7, as plain fp32 does
// (2.2e-7 to 4.2e-7). So this is an fp32 kernel that uses the tensor cores.
//
// The design:
//   * tensor cores: wgmma.mma_async m64nNk8 .f32.tf32.tf32, N = 64, 128 or
//     256 (each layer's Cout padded up to one of them with zero weights and
//     biases). TF32 wgmma takes both operands K-major from shared memory, in
//     the no-swizzle core-matrix layout (8 rows x 16 bytes a core matrix);
//   * a block owns 64 rows of one window per consumer warpgroup: two
//     warpgroups (128 rows) when the chain's widest stored layer is at most
//     128 wide, else one. A warpgroup's activations stay in its own shared
//     buffer across all layers, as hi and lo planes [64, K]; each hidden
//     layer's epilogue (bias, ReLU, split) runs in registers and writes the
//     next layer's A operand back in place once the layer's wgmmas are done;
//   * weights are prepared once on the host side (ops/fused_mlp.py,
//     prepare_chain): K-major [Cout, Cin], zero-padded, split into tf32 hi
//     and lo, and laid out as 16-deep K slabs in the kernel's shared-memory
//     order, so one 1-D cp.async.bulk moves a slab (hi then lo). One
//     producer warp keeps a ring of 2-4 slab stages in flight, signalled by
//     full and empty mbarriers; the consumers run wgmma on the stage that
//     has landed, one wgmma group behind, and release it when it is read;
//   * the last layer stores its rows as float2 (masking the ragged tile) or
//     reduces each warpgroup's 64 rows to a per-column max in registers,
//     shuffles and shared memory, into [M, ceil(N / 64), Cout] partials; a
//     second small launch reduces them from -inf (relu_last=0 gives
//     negatives). No atomics: sums and maxima are taken in one fixed order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWgRows = 64;  // rows per consumer warpgroup: the wgmma M
constexpr int kWgThreads = 128;
constexpr int kSlabK = 16;  // K per weight slab: two wgmma k8 steps
constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 256;
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;  // the 227 KB a block may use
constexpr int kHeader = 128;        // full and empty mbarriers
constexpr int kMaxDevices = 64;

struct Chain {
  const float* w[kMaxLayers];  // packed slabs [kpad/16][hi, lo][npad/8][4][8][4]
  const float* b[kMaxLayers];  // [npad], zero past cout
  int kpad[kMaxLayers];        // layer depth: cin padded to whole slabs, then npad of the layer before
  int npad[kMaxLayers];        // cout padded to a wgmma N: 64, 128 or 256
  int n_layers;
  int cin;
  int cout;         // the last layer's real width
  int kst;          // activation row length in shared memory: max kpad
  int stages;       // weight ring depth
  int stage_bytes;  // one slab of the widest layer, hi and lo
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32, done as half a tf32 ulp added to
// the magnitude's bits and 13 bits cleared. Integer ops issue faster than
// the cvt (kernel_timing.py --variants measures both), and this is the very
// formula of ops/fused_mlp.py::tf32_split. Finite x.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & ~0x1FFFu);
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(wg + 1), "r"(kWgThreads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, then the byte
// offsets between core matrices adjacent in K (leading) and in M/N (stride)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32);
}

#define ACC8(i)                                                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(i) ACC8(i), ACC8(i + 8), ACC8(i + 16), ACC8(i + 24)

// d[64 x N] += A[64 x 8] . B[N x 8]^T, both tf32 K-major in shared memory
template <int N>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : ACC32(0)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : ACC32(0), ACC32(32)
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1;\n}\n"
        : ACC32(0), ACC32(32), ACC32(64), ACC32(96)
        : "l"(a), "l"(b), "r"(1));
  }
};

#undef ACC32
#undef ACC8

// One consumer warpgroup: 64 rows of one window through every layer.
struct Consumer {
  const Chain& chain;
  int n, relu_last, tiles64;
  float* acts;     // nullable
  float* partial;  // nullable
  int window, t64, row0, rows_here;
  int wg, warp, lane;
  float* a_hi;  // [64, kst] in core-matrix order
  float* a_lo;
  uint32_t a_hi_addr, a_lo_addr, ring_addr, full_addr, empty_addr;
  int slab;  // slabs consumed so far, over all layers

  // float offset of element (r, k) of a [rows, kst] core-matrix layout:
  // core matrix (r / 8, k / 4) at 128 bytes each, row r % 8 at 16 bytes
  __device__ __forceinline__ int offset(int r, int k) const {
    return ((r >> 3) * (chain.kst >> 2) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
  }

  __device__ __forceinline__ void put(int off, float v) {
    const float hi = tf32_rna(v);
    a_hi[off] = hi;
    a_lo[off] = tf32_rna(v - hi);
  }

  // the window's rows [row0, row0 + 64) of x, zero past the window's end and
  // past cin
  __device__ void load_input(const float* __restrict__ x) {
    const int cin = chain.cin, k0 = chain.kpad[0];
    const int tid = threadIdx.x % kWgThreads;
    const float* src = x + ((size_t)window * n + (rows_here > 0 ? row0 : 0)) * cin;
    if ((cin & 3) == 0 && ((uintptr_t)x & 15) == 0) {
      const int groups = k0 / 4;
      for (int q = tid; q < kWgRows * groups; q += kWgThreads) {
        const int r = q / groups, k = (q - r * groups) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows_here && k < cin) v = *reinterpret_cast<const float4*>(src + (size_t)r * cin + k);
        float4 hi, lo;
        hi.x = tf32_rna(v.x), lo.x = tf32_rna(v.x - hi.x);
        hi.y = tf32_rna(v.y), lo.y = tf32_rna(v.y - hi.y);
        hi.z = tf32_rna(v.z), lo.z = tf32_rna(v.z - hi.z);
        hi.w = tf32_rna(v.w), lo.w = tf32_rna(v.w - hi.w);
        const int off = offset(r, k);
        *reinterpret_cast<float4*>(a_hi + off) = hi;
        *reinterpret_cast<float4*>(a_lo + off) = lo;
      }
    } else {
      for (int i = tid; i < kWgRows * k0; i += kWgThreads) {
        const int r = i / k0, k = i - r * k0;
        put(offset(r, k), r < rows_here && k < cin ? src[(size_t)r * cin + k] : 0.f);
      }
    }
    fence_async_smem();
    wg_barrier(wg);
  }

  template <int N>
  __device__ void layer(int l) {
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    const int nslab = chain.kpad[l] / kSlabK;
    const int stages = chain.stages;
    const uint32_t a_stride = chain.kst * 32;  // bytes between 8-row groups
    for (int s = 0; s < nslab; ++s, ++slab) {
      const int st = slab % stages;
      mbar_wait(full_addr + 8 * st, (slab / stages) & 1);
      const uint32_t b_addr = ring_addr + st * chain.stage_bytes;
      fence_regs<N / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSlabK / 8; ++j) {
        const uint32_t k_off = (s * (kSlabK / 8) + j) * 256;  // two core matrices of K a step
        const uint64_t ahi = make_desc(a_hi_addr + k_off, 128, a_stride);
        const uint64_t alo = make_desc(a_lo_addr + k_off, 128, a_stride);
        const uint64_t bhi = make_desc(b_addr + j * 256, 128, kSlabK * 32);
        const uint64_t blo = make_desc(b_addr + N * kSlabK * 4 + j * 256, 128, kSlabK * 32);
        // small terms first, into the one fp32 accumulator
        Mma<N>::run(acc, alo, bhi);
        Mma<N>::run(acc, ahi, blo);
        Mma<N>::run(acc, ahi, bhi);
      }
      wgmma_commit();
      if (s > 0) {  // the slab before this one is read: release its stage
        wgmma_wait<1>();
        mbar_arrive(empty_addr + 8 * ((slab - 1) % stages));
      }
    }
    wgmma_wait<0>();
    fence_regs<N / 2>(acc);
    mbar_arrive(empty_addr + 8 * ((slab - 1) % stages));
    wg_barrier(wg);  // every warp's wgmmas have read this warpgroup's A

    const bool last = l == chain.n_layers - 1;
    const bool relu = !last || relu_last;
    const float* __restrict__ bias = chain.b[l];
    // accumulator layout: acc[4i + 2h + e] is row warp*16 + lane/4 + 8h,
    // column 8i + 2(lane % 4) + e
    const int r0 = warp * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * i + c0));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * i + 2 * h] + bb.x, v1 = acc[4 * i + 2 * h + 1] + bb.y;
        if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
        acc[4 * i + 2 * h] = v0;
        acc[4 * i + 2 * h + 1] = v1;
      }
    }

    if (!last) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = offset(r0 + 8 * h, 8 * i + c0);
          const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
          const float h0 = tf32_rna(v0), h1 = tf32_rna(v1);
          *reinterpret_cast<float2*>(a_hi + off) = make_float2(h0, h1);
          *reinterpret_cast<float2*>(a_lo + off) = make_float2(tf32_rna(v0 - h0), tf32_rna(v1 - h1));
        }
      }
      fence_async_smem();
      wg_barrier(wg);
      return;
    }

    const int cout = chain.cout;
    if (acts != nullptr) {
      float* dst = acts + ((size_t)window * n + row0) * cout;
      const bool pairs = (cout & 1) == 0 && ((uintptr_t)acts & 7) == 0;
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const int c = 8 * i + c0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= rows_here || c >= cout) continue;
          float* p = dst + (size_t)r * cout + c;
          if (pairs) {
            *reinterpret_cast<float2*>(p) = make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
          } else {
            p[0] = acc[4 * i + 2 * h];
            if (c + 1 < cout) p[1] = acc[4 * i + 2 * h + 1];
          }
        }
      }
    }
    if (partial != nullptr) {
      float* red = a_hi;  // [4 warps, N]: this warpgroup's A is free now
      const bool in0 = r0 < rows_here, in1 = r0 + 8 < rows_here;
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        float m0 = fmaxf(in0 ? acc[4 * i] : -CUDART_INF_F, in1 ? acc[4 * i + 2] : -CUDART_INF_F);
        float m1 = fmaxf(in0 ? acc[4 * i + 1] : -CUDART_INF_F, in1 ? acc[4 * i + 3] : -CUDART_INF_F);
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, sh));
          m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, sh));
        }
        if (lane < 4) *reinterpret_cast<float2*>(red + warp * N + 8 * i + c0) = make_float2(m0, m1);
      }
      wg_barrier(wg);
      if (rows_here > 0) {
        float* dst = partial + ((size_t)window * tiles64 + t64) * cout;
        for (int c = threadIdx.x % kWgThreads; c < cout; c += kWgThreads)
          dst[c] = fmaxf(fmaxf(red[c], red[N + c]), fmaxf(red[2 * N + c], red[3 * N + c]));
      }
    }
  }
};

template <int NMAX>
__global__ void __launch_bounds__(2 * kWgThreads + 32, NMAX == 64 ? 2 : 1)
chain_kernel(const float* __restrict__ x, int n, __grid_constant__ const Chain chain, int relu_last,
             float* __restrict__ acts, float* __restrict__ partial, int tiles, int tiles64,
             int ncons) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full_addr = smem_addr(smem);
  const uint32_t empty_addr = full_addr + 8 * kMaxStages;
  unsigned char* ring = smem + kHeader;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < chain.stages; ++s) {
      mbar_init(full_addr + 8 * s, 1);
      mbar_init(empty_addr + 8 * s, ncons * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == ncons * 4) {  // the producer warp: one thread streams the slabs
    if (threadIdx.x % 32 == 0) {
      const int stages = chain.stages;
      int g = 0;
      for (int l = 0; l < chain.n_layers; ++l) {
        const uint32_t bytes = chain.npad[l] * kSlabK * 4 * 2;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(chain.w[l]);
        for (int s = 0; s < chain.kpad[l] / kSlabK; ++s, ++g) {
          const int st = g % stages;
          if (g >= stages) mbar_wait(empty_addr + 8 * st, (g / stages - 1) & 1);
          mbar_expect_tx(full_addr + 8 * st, bytes);
          bulk_load(smem_addr(ring) + st * chain.stage_bytes, src + (size_t)s * bytes, bytes,
                    full_addr + 8 * st);
        }
      }
      // stay until every stage is released, so no copy outlives its reader
      for (int t = 0; t < stages; ++t, ++g)
        if (g >= stages) mbar_wait(empty_addr + 8 * (g % stages), (g / stages - 1) & 1);
    }
    return;
  }

  const int wg = warp / 4;
  const int a_floats = kWgRows * chain.kst;
  float* a_hi = reinterpret_cast<float*>(ring + chain.stages * chain.stage_bytes) + 2 * wg * a_floats;
  Consumer c{chain, n, relu_last, tiles64, acts, partial};
  c.window = blockIdx.x / tiles;
  c.t64 = (blockIdx.x - c.window * tiles) * ncons + wg;
  c.row0 = c.t64 * kWgRows;
  c.rows_here = max(0, min(kWgRows, n - c.row0));
  c.wg = wg;
  c.warp = warp % 4;
  c.lane = threadIdx.x % 32;
  c.a_hi = a_hi;
  c.a_lo = a_hi + a_floats;
  c.a_hi_addr = smem_addr(c.a_hi);
  c.a_lo_addr = smem_addr(c.a_lo);
  c.ring_addr = smem_addr(ring);
  c.full_addr = full_addr;
  c.empty_addr = empty_addr;
  c.slab = 0;

  c.load_input(x);
  for (int l = 0; l < chain.n_layers; ++l) {
    const int np = chain.npad[l];
    if (np == 64) c.layer<64>(l);
    if constexpr (NMAX >= 128) {
      if (np == 128) c.layer<128>(l);
    }
    if constexpr (NMAX >= 256) {
      if (np == 256) c.layer<256>(l);
    }
  }
}

__global__ void pool_kernel(const float* __restrict__ partial, int tiles, int cout,
                            float* __restrict__ pooled, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long window = idx / cout;
  const int c = (int)(idx - window * cout);
  const float* p = partial + (size_t)window * tiles * cout + c;
  float m = -CUDART_INF_F;
  for (int t = 0; t < tiles; ++t) m = fmaxf(m, p[(size_t)t * cout]);
  pooled[idx] = m;
}

// Raise the chain kernels' dynamic shared-memory limit on the current device
// to kSmemLimit, once. The limit belongs to the function on the whole device,
// not to one launch: setting it per call to that call's own size would let a
// concurrent caller's smaller setting land between another's setting and its
// launch, and that launch would then fail.
cudaError_t ensure_smem_limit() {
  static std::mutex mu;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!ready[dev]) {
    const void* kernels[] = {(const void*)chain_kernel<64>, (const void*)chain_kernel<128>,
                             (const void*)chain_kernel<256>};
    for (const void* k : kernels) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return err;
    }
    ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int fused_mlp_chain_tile_rows(void) { return kWgRows; }

// x [m, n, cin]; layer l: w[l] as prepare_chain packs it (16-byte aligned)
// for depth kpad[l] and width npad[l], b[l] [npad[l]], cout[l] real output
// channels. The caller chooses the padding (ops/fused_mlp.py::prepare_chain);
// this checks that it is one the kernel runs. acts (nullable) [m, n,
// cout_last]; pooled (nullable) [m, cout_last] with partial [m, ceil(n /
// tile_rows), cout_last] as scratch. All fp32, contiguous, on the current
// device. Returns the launch's cudaError_t (0 = launched).
extern "C" int fused_mlp_chain_f32(
    const float* x, int m, int n, int cin, int n_layers,
    const float* const* w, const float* const* b,
    const int* cout, const int* kpad, const int* npad, int relu_last,
    float* acts, float* pooled, float* partial, void* stream) {
  if (m <= 0 || n <= 0 || cin <= 0 || cin > kMaxWidth || n_layers < 1 || n_layers > kMaxLayers ||
      (acts == nullptr && pooled == nullptr) || (pooled != nullptr && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Chain chain = {};
  chain.n_layers = n_layers;
  chain.cin = cin;
  int nmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int np = npad[l], kp = kpad[l];
    if (w[l] == nullptr || b[l] == nullptr || ((uintptr_t)w[l] & 15) != 0 ||
        ((uintptr_t)b[l] & 7) != 0 || cout[l] <= 0 || cout[l] > np ||
        (np != 64 && np != 128 && np != 256) || kp <= 0 || kp > kMaxWidth || kp % kSlabK != 0 ||
        kp < (l == 0 ? cin : npad[l - 1]) || (l > 0 && kp != npad[l - 1]))
      return (int)cudaErrorInvalidValue;
    chain.w[l] = w[l];
    chain.b[l] = b[l];
    chain.kpad[l] = kp;
    chain.npad[l] = np;
    chain.kst = kp > chain.kst ? kp : chain.kst;
    nmax = np > nmax ? np : nmax;
  }
  chain.cout = cout[n_layers - 1];
  chain.stage_bytes = nmax * kSlabK * 4 * 2;
  // two consumer warpgroups when both activation buffers and two stages fit
  const int a_bytes = 2 * kWgRows * chain.kst * 4;  // hi and lo
  const int ncons = kHeader + 2 * a_bytes + 2 * chain.stage_bytes <= kSmemLimit ? 2 : 1;
  const int room = (kSmemLimit - kHeader - ncons * a_bytes) / chain.stage_bytes;
  chain.stages = room < kMaxStages ? room : kMaxStages;
  if (chain.stages < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = kHeader + (size_t)chain.stages * chain.stage_bytes + (size_t)ncons * a_bytes;

  const int tile_rows = ncons * kWgRows;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  const int tiles64 = (n + kWgRows - 1) / kWgRows;
  const long long blocks = (long long)m * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = ensure_smem_limit();
  if (err != cudaSuccess) return (int)err;
  const int threads = ncons * kWgThreads + 32;
  float* part = pooled != nullptr ? partial : nullptr;
  if (nmax == 64)
    chain_kernel<64><<<(unsigned)blocks, threads, smem, s>>>(x, n, chain, relu_last, acts, part,
                                                             tiles, tiles64, ncons);
  else if (nmax == 128)
    chain_kernel<128><<<(unsigned)blocks, threads, smem, s>>>(x, n, chain, relu_last, acts, part,
                                                              tiles, tiles64, ncons);
  else
    chain_kernel<256><<<(unsigned)blocks, threads, smem, s>>>(x, n, chain, relu_last, acts, part,
                                                              tiles, tiles64, ncons);
  err = cudaGetLastError();
  if (err != cudaSuccess || pooled == nullptr) return (int)err;
  const long long total = (long long)m * chain.cout;
  const int pool_threads = 256;
  pool_kernel<<<(unsigned)((total + pool_threads - 1) / pool_threads), pool_threads, 0, s>>>(
      partial, tiles64, chain.cout, pooled, total);
  return (int)cudaGetLastError();
}
