// Fused shared-MLP chain over point windows, fp32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ampnet_tpu/ops/pallas/fused_mlp.py
// (fused_mlp_chain, pl.pallas_call at :144). Per layer it computes
// h <- relu(h @ W' + b') with inference BatchNorm already folded into W', b'
// (ReLU on the last layer optional); it returns the last layer's activations
// [M, N, Cout], the per-window max [M, Cout], or both. Pool-only calls never
// write activations to device memory.
//
// What bounds it on this card: operations. Its chains do 4.9k-61k MACs per
// point on 12-256 bytes of input per point, far above the ~20 FLOP/byte where
// fp32 CUDA cores (67 TFLOP/s) overtake HBM (3.35 TB/s). The design keeps
// the FMA units fed from shared memory:
//   * one block owns a tile of kTileRows rows of one window; the tile's
//     activations stay in shared memory across all layers, in two ping-pong
//     buffers of kTileRows x stride floats (stride = widest layer input);
//   * weights do not fit resident (mlp_b's folded weights are 240 KB, above
//     the 227 KB a block may use), so each layer's weights stream through a
//     shared k-slab of kSlab rows;
//   * each thread holds an 8x8 register tile of outputs: a warp shares one row
//     group (activation reads are broadcasts) and spans 32 consecutive output
//     columns (weight reads hit 32 banks), so shared loads are conflict-free;
//   * fp32 FMA on CUDA cores, no TF32, accumulated in k order;
//   * the pooled max is taken in the block, written per tile to a
//     [M, tiles, Cout] scratch, and reduced over tiles by a second small
//     launch: deterministic, and started from -inf (relu_last=0 gives
//     negatives).
// Tensor cores (wgmma, TMA) are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 32;                          // a warp spans columns
constexpr int kRowThreads = kThreads / kColThreads;      // 8 row groups
constexpr int kTileRows = 64;
constexpr int kRowsPerThread = kTileRows / kRowThreads;  // 8
constexpr int kColsPerThread = 8;
constexpr int kMaxWidth = kColThreads * kColsPerThread;  // 256
constexpr int kSlab = 16;
constexpr int kMaxLayers = 4;
// the largest dynamic shared memory a launch asks for: two kMaxWidth-wide
// ping-pong tiles and a kMaxWidth-wide weight slab (144 KB)
constexpr size_t kMaxSmem = sizeof(float) * (2 * kTileRows * kMaxWidth + kSlab * kMaxWidth);
constexpr int kMaxDevices = 64;

struct Chain {
  const float* w[kMaxLayers];  // [cin_l, cout_l] row-major
  const float* b[kMaxLayers];  // [cout_l]
  int cin[kMaxLayers];
  int cout[kMaxLayers];
  int n_layers;
  int stride;  // shared row stride: max over layers of cin_l
  int wmax;    // max over layers of cout_l
};

__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ x, int n, Chain chain, int relu_last,
             float* __restrict__ acts, float* __restrict__ partial, int tiles) {
  extern __shared__ float smem[];
  float* in = smem;
  float* out = smem + kTileRows * chain.stride;
  float* wslab = out + kTileRows * chain.stride;

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const int window = blockIdx.x / tiles;
  const int tile = blockIdx.x - window * tiles;
  const int row0 = tile * kTileRows;
  const int rows_here = min(kTileRows, n - row0);
  const int stride = chain.stride;

  // the tile's input rows; rows past the window's end are zeros and are
  // masked out of every store and of the pool below
  {
    const int cin = chain.cin[0];
    const float* src = x + ((size_t)window * n + row0) * cin;
    for (int idx = tid; idx < kTileRows * cin; idx += kThreads) {
      const int r = idx / cin;
      const int c = idx - r * cin;
      in[r * stride + c] = r < rows_here ? src[idx] : 0.f;
    }
  }

  for (int l = 0; l < chain.n_layers; ++l) {
    const int cin = chain.cin[l];
    const int cout = chain.cout[l];
    const int ncols = (cout + kColThreads - 1) / kColThreads;
    const float* __restrict__ w = chain.w[l];

    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < cin; k0 += kSlab) {
      const int ks = min(kSlab, cin - k0);
      __syncthreads();  // last slab consumed; previous layer's rows written
      for (int idx = tid; idx < ks * cout; idx += kThreads)
        wslab[idx] = w[(size_t)k0 * cout + idx];
      __syncthreads();
      for (int kk = 0; kk < ks; ++kk) {
        float a[kRowsPerThread];
        float wv[kColsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          a[i] = in[(ty + i * kRowThreads) * stride + k0 + kk];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int col = tx + j * kColThreads;
          wv[j] = (j < ncols && col < cout) ? wslab[kk * cout + col] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          if (j < ncols) {
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
          }
        }
      }
    }

    const bool last = l == chain.n_layers - 1;
    const bool relu = !last || relu_last;
    const float* __restrict__ bias = chain.b[l];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = tx + j * kColThreads;
      if (j < ncols && col < cout) {
        const float bj = bias[col];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float v = acc[i][j] + bj;
          acc[i][j] = relu ? fmaxf(v, 0.f) : v;
        }
      }
    }

    if (!last) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = ty + i * kRowThreads;
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int col = tx + j * kColThreads;
          if (j < ncols && col < cout) out[r * stride + col] = acc[i][j];
        }
      }
      float* t = in;
      in = out;
      out = t;
      continue;
    }

    if (acts != nullptr) {
      float* dst = acts + ((size_t)window * n + row0) * cout;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = ty + i * kRowThreads;
        if (r < rows_here) {
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) {
            const int col = tx + j * kColThreads;
            if (j < ncols && col < cout) dst[(size_t)r * cout + col] = acc[i][j];
          }
        }
      }
    }
    if (partial != nullptr) {
      __syncthreads();  // every thread is done reading the last weight slab
      float* red = wslab;  // kRowThreads x cout <= kSlab x wmax floats
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = tx + j * kColThreads;
        if (j < ncols && col < cout) {
          float m = -CUDART_INF_F;
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            if (ty + i * kRowThreads < rows_here) m = fmaxf(m, acc[i][j]);
          red[ty * cout + col] = m;
        }
      }
      __syncthreads();
      float* dst = partial + ((size_t)window * tiles + tile) * cout;
      for (int c = tid; c < cout; c += kThreads) {
        float m = red[c];
        for (int t = 1; t < kRowThreads; ++t) m = fmaxf(m, red[t * cout + c]);
        dst[c] = m;
      }
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

// Raise chain_kernel's dynamic shared-memory limit on the current device to
// kMaxSmem, once. The limit belongs to the function on the whole device, not
// to one launch: setting it per call to that call's own size would let a
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
    err = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int fused_mlp_chain_tile_rows(void) { return kTileRows; }
extern "C" int fused_mlp_chain_max_width(void) { return kMaxWidth; }

// x [m, n, cin]; w_l [cin_l, couts[l]]; b_l [couts[l]]. acts (nullable)
// [m, n, cout_last]; pooled (nullable) [m, cout_last] with partial
// [m, ceil(n / tile_rows), cout_last] as scratch. All fp32, contiguous, on
// the current device. Returns the launch's cudaError_t (0 = launched).
extern "C" int fused_mlp_chain_f32(
    const float* x, int m, int n, int cin, int n_layers,
    const float* w0, const float* w1, const float* w2, const float* w3,
    const float* b0, const float* b1, const float* b2, const float* b3,
    int c0, int c1, int c2, int c3, int relu_last,
    float* acts, float* pooled, float* partial, void* stream) {
  if (m <= 0 || n <= 0 || cin <= 0 || n_layers < 1 || n_layers > kMaxLayers ||
      (acts == nullptr && pooled == nullptr) || (pooled != nullptr && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Chain chain;
  const float* ws[kMaxLayers] = {w0, w1, w2, w3};
  const float* bs[kMaxLayers] = {b0, b1, b2, b3};
  const int cs[kMaxLayers] = {c0, c1, c2, c3};
  chain.n_layers = n_layers;
  chain.stride = 0;
  chain.wmax = 0;
  int c_in = cin;
  for (int l = 0; l < kMaxLayers; ++l) {
    chain.w[l] = l < n_layers ? ws[l] : nullptr;
    chain.b[l] = l < n_layers ? bs[l] : nullptr;
    chain.cin[l] = l < n_layers ? c_in : 0;
    chain.cout[l] = l < n_layers ? cs[l] : 0;
    if (l < n_layers) {
      if (cs[l] <= 0 || cs[l] > kMaxWidth || c_in > kMaxWidth) return (int)cudaErrorInvalidValue;
      chain.stride = c_in > chain.stride ? c_in : chain.stride;
      chain.wmax = cs[l] > chain.wmax ? cs[l] : chain.wmax;
      c_in = cs[l];
    }
  }
  const int cout = chain.cout[n_layers - 1];
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const long long blocks = (long long)m * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * kTileRows * chain.stride +
                                       (size_t)kSlab * chain.wmax);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = ensure_smem_limit();
  if (err != cudaSuccess) return (int)err;
  chain_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      x, n, chain, relu_last, acts, pooled != nullptr ? partial : nullptr, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || pooled == nullptr) return (int)err;
  const long long total = (long long)m * cout;
  const int threads = 256;
  pool_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      partial, tiles, cout, pooled, total);
  return (int)cudaGetLastError();
}
