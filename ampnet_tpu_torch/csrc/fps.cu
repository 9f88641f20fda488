// Farthest-point sampling of B clouds, one launch for the whole loop, bit for
// bit as the plain PyTorch loop (ops/sampling.py,
// batched_farthest_point_sampling_plain) picks.
//
// Replaces no TPU kernel: the JAX package runs ampnet_tpu/ops/sampling.py's
// farthest_point_sampling as a lax.fori_loop inside its jitted step. The
// port's plain loop launches ~8 tiny ops for each of the S - 1 dependent
// steps (the winner's gather, the subtraction, the square, two adds,
// torch.minimum, torch.argmax, the store of the index): ~11,000 launches a
// PointNet++ forward at 32 x 16,384 points, whose host time the card waits
// for.
//
// Bound: latency. A step is a block-wide argmax that the next step waits
// for; its arithmetic (N points x ~12 instructions) and the shared-memory
// reads of the coordinates (12 bytes a point) are each ~1,500 clocks of an SM
// at N = 16,384, so one block a cloud runs the S - 1 steps back to back with
// its running minima in registers and nothing between the steps but one
// __syncthreads (on an H100: 2.4 us a step at 32 x 16,384 points, 2.47 ms for
// 1,024 samples, where the float32 arithmetic alone would take 0.064 ms at the
// card's peak; 32 of the 132 SMs work).
//
// Bit for bit: each step computes the plain loop's float32 operations in its
// order, d = ((x - x_last)^2 + (y - y_last)^2) + (z - z_last)^2 (.square() is
// x * x), with the _rn intrinsics so that nvcc's default -fmad=true cannot
// contract the sum into an FMA; the running minimum takes torch.minimum's
// NaN (min.NaN.f32); the argmax takes torch.argmax's order: the greatest
// value, NaN above all, ties to the lower index. Both are exact in any order
// of reduction, so the indices are the loop's.
//
// The argmax compares the running minima as int32 bit patterns: they are
// -inf (a masked point), +0 to +inf (a squared distance is never -0: squares
// are +0 or more and +0 + +0 is +0) or min.NaN's canonical NaN 0x7fffffff, and
// on those values the signed integer order is the float order with NaN on
// top. A warp reduces (key, index) with two redux.sync (the largest key, then
// the least index holding it); each warp then reduces the block's 32 pairs
// itself, read from a buffer that alternates by step, so a step takes one
// __syncthreads.
//
// Layout: a cloud of at most 16,384 points keeps its coordinates in shared
// memory as x[N], y[N], z[N] (196,608 bytes at 16,384) and P = 1, 2, 4, 8 or
// 16 running minima a thread in registers (point k * threads + t), threads
// and P from N alone. A larger cloud keeps its running minima in the
// caller's scratch [B, N] and reads its coordinates from global memory (1,024
// threads). Launches on the caller's stream, allocates nothing, never syncs
// the host: it captures into a CUDA graph.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <mutex>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxRegPoints = 16;  // running minima a thread keeps in registers
constexpr int kRegCloud = kMaxThreads * kMaxRegPoints;  // the largest cloud held on chip
constexpr int kSmemLimit = 3 * (int)sizeof(float) * kRegCloud;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct Args {
  const float* xyz;             // [B, N, 3]
  const unsigned char* valid;   // [B, N] torch.bool, or null: every point valid
  float* minima;                // [B, N] scratch of a cloud above kRegCloud, else unused
  long long* selected;          // [B, S] out
  int n, s;
};

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx, float ly,
                                        float lz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// torch.minimum: the canonical NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// P running minima a thread in registers (coordinates in shared memory), or
// P = 0: minima in a.minima, coordinates from global memory
template <int P>
__global__ void __launch_bounds__(kMaxThreads) fps_kernel(const Args a) {
  extern __shared__ float coords[];  // P > 0: x[n], y[n], z[n]
  __shared__ int2 red[2][kMaxWarps];  // each warp's (key, index), by step parity
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int threads = blockDim.x, warps = threads >> 5, n = a.n;
  const size_t cloud = blockIdx.x;
  const float* g = a.xyz + cloud * n * 3;
  const unsigned char* valid = a.valid ? a.valid + cloud * n : nullptr;
  long long* selected = a.selected + cloud * a.s;
  float* xs = coords;
  float* ys = coords + n;
  float* zs = coords + 2 * n;
  float* minima = P > 0 ? nullptr : a.minima + cloud * n;
  float d[P > 0 ? P : 1];

  // valid points start at +inf, masked ones at -inf; the start is the first
  // valid point, 0 when there is none (torch.argmax of the mask)
  unsigned first = kNoIndex;
  if constexpr (P > 0) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int i = k * threads + t;
      if (i < n) {
        const bool ok = valid == nullptr || valid[i];
        d[k] = ok ? INFINITY : -INFINITY;
        if (ok) first = min(first, (unsigned)i);
        xs[i] = g[3 * i];
        ys[i] = g[3 * i + 1];
        zs[i] = g[3 * i + 2];
      }
    }
  } else {
    for (int i = t; i < n; i += threads) {
      const bool ok = valid == nullptr || valid[i];
      minima[i] = ok ? INFINITY : -INFINITY;
      if (ok) first = min(first, (unsigned)i);
    }
  }
  first = __reduce_min_sync(kFull, first);
  if (lane == 0) red[0][warp].y = (int)first;
  __syncthreads();  // also: the coordinates are in shared memory
  first = __reduce_min_sync(kFull, lane < warps ? (unsigned)red[0][lane].y : kNoIndex);
  int last = first == kNoIndex ? 0 : (int)first;
  if (t == 0) selected[0] = last;

  for (int step = 1; step < a.s; ++step) {
    float lx, ly, lz;
    if constexpr (P > 0) {
      lx = xs[last];
      ly = ys[last];
      lz = zs[last];
    } else {
      lx = __ldg(g + 3 * last);
      ly = __ldg(g + 3 * last + 1);
      lz = __ldg(g + 3 * last + 2);
    }
    int best = INT_MIN;  // below -inf's key: a thread without points never wins
    unsigned arg = kNoIndex;
    if constexpr (P > 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int i = k * threads + t;
        if (i < n) {
          d[k] = nan_min(d[k], sqdist(xs[i], ys[i], zs[i], lx, ly, lz));
          const int key = __float_as_int(d[k]);
          if (key > best) {  // ascending i: the first maximum stays
            best = key;
            arg = i;
          }
        }
      }
    } else {
      for (int i = t; i < n; i += threads) {
        const float m = nan_min(minima[i], sqdist(__ldg(g + 3 * i), __ldg(g + 3 * i + 1),
                                                  __ldg(g + 3 * i + 2), lx, ly, lz));
        minima[i] = m;
        const int key = __float_as_int(m);
        if (key > best) {
          best = key;
          arg = i;
        }
      }
    }
    int top = __reduce_max_sync(kFull, best);
    arg = __reduce_min_sync(kFull, best == top ? arg : kNoIndex);
    // a warp writes red[p] again two steps on, after the next step's
    // __syncthreads, which every warp reaches only once it has read red[p]
    int2* r = red[step & 1];
    if (lane == 0) r[warp] = make_int2(top, (int)arg);
    __syncthreads();
    const int2 w = lane < warps ? r[lane] : make_int2(INT_MIN, (int)kNoIndex);
    top = __reduce_max_sync(kFull, w.x);
    last = (int)__reduce_min_sync(kFull, w.x == top ? (unsigned)w.y : kNoIndex);
    if (t == 0) selected[step] = last;
  }
}

// The register variant's P for a cloud of n points, 0 for the scratch
// variant: the least power of two with n <= kMaxThreads * P.
int points_per_thread(int n) {
  const int per = (n + kMaxThreads - 1) / kMaxThreads;
  if (per > kMaxRegPoints) return 0;
  int p = 1;
  while (p < per) p <<= 1;
  return p;
}

// Raise the register variants' dynamic shared-memory limit on the current
// device to kSmemLimit, once (a limit of the function on the whole device,
// not of one launch: see csrc/fused_mlp.cu).
cudaError_t ensure_smem_limit() {
  static std::mutex mu;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!ready[dev]) {
    const void* kernels[] = {(const void*)fps_kernel<1>, (const void*)fps_kernel<2>,
                             (const void*)fps_kernel<4>, (const void*)fps_kernel<8>,
                             (const void*)fps_kernel<16>};
    for (const void* k : kernels) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
      if (err != cudaSuccess) return err;
    }
    ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

// The points a cloud of n points needs in the scratch of fps_sample: n for a
// cloud above 16,384 points, else 0.
extern "C" int fps_scratch_points(int n) {
  return n >= 1 && points_per_thread(n) == 0 ? n : 0;
}

// xyz [batch, n, 3] float32; valid [batch, n] torch.bool or null; minima
// [batch, fps_scratch_points(n)] float32 scratch (null when that is 0);
// selected [batch, s] int64 out. Contiguous, on the current device. Returns
// the launch's cudaError_t (0 = launched).
extern "C" int fps_sample(const float* xyz, const unsigned char* valid, float* minima,
                          long long* selected, int batch, int n, int s, void* stream) {
  if (xyz == nullptr || selected == nullptr || batch < 1 || n < 1 || s < 1)
    return (int)cudaErrorInvalidValue;
  const int p = points_per_thread(n);
  if (p == 0 && minima == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = ensure_smem_limit();
  if (err != cudaSuccess) return (int)err;
  const Args a = {xyz, valid, minima, selected, n, s};
  const int threads = p ? ((n + p - 1) / p + 31) / 32 * 32 : kMaxThreads;
  const size_t smem = p ? 3 * sizeof(float) * (size_t)n : 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (p) {
    case 1: fps_kernel<1><<<batch, threads, smem, st>>>(a); break;
    case 2: fps_kernel<2><<<batch, threads, smem, st>>>(a); break;
    case 4: fps_kernel<4><<<batch, threads, smem, st>>>(a); break;
    case 8: fps_kernel<8><<<batch, threads, smem, st>>>(a); break;
    case 16: fps_kernel<16><<<batch, threads, smem, st>>>(a); break;
    default: fps_kernel<0><<<batch, threads, 0, st>>>(a); break;
  }
  return (int)cudaGetLastError();
}
