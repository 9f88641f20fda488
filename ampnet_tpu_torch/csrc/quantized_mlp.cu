// int8 shared-MLP chain over point windows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ampnet_tpu/ops/pallas/quantized_mlp.py
// (quantized_mlp_chain, pl.pallas_call at :121). Per layer it computes
//   s_x = max(absmax(h over the block), 1e-12) / 127
//   hq  = clip(rint(h / s_x), -127, 127)                      (int8)
//   h   = relu(float(hq @ wq) * (s_x * s_w) + b)              (int32 sums)
// where a block is g consecutive windows (the caller pads M to a multiple of
// g with zero windows) and wq, s_w are the per-output-channel int8 weights
// and scales (ReLU on the last layer optional). It returns the last layer's
// activations [M, N, Cout], the per-window max [M, Cout], or both.
//
// The activation scale spans the whole block: at the served N = 4096 a
// block is one window of 4096 rows, whose 256-wide fp32 activations (4 MB)
// do not fit one thread block's shared memory. So layer l+1 cannot quantize
// until every thread block covering the block has finished layer l. The
// chain therefore runs as one launch per layer:
//   * absmax_kernel takes the per-block absmax of x;
//   * layer_kernel, per 64-row tile of one window: quantizes its fp32 input
//     rows with the block's scale into shared memory (K zero-padded to 32,
//     float4 loads where Cin is a multiple of 4), stages the int8 weights
//     beside them as 32-bit words of 4 consecutive k of one column (the
//     mma's B fragment; transposed in registers with byte permutes from
//     4-byte loads where Cout is a multiple of 4), multiplies with
//     mma.sync m16n8k32 s8 x s8 -> s32 on the tensor cores, dequantizes, adds
//     the bias, applies ReLU, and writes fp32 rows (or, for a pooled last
//     layer, the tile's column maxima to a [M, tiles, Cout] scratch); it folds
//     the output's absmax into the next layer's per-block word with atomicMax
//     on the float's bits, which orders like the floats because |h| >= 0;
//   * pool_kernel reduces the tile maxima over tiles.
// max does not depend on order, so the result is deterministic.
//
// Rounding matches the plain PyTorch version bit for bit: true division
// (__fdiv_rn, never a reciprocal), round half to even (rintf), and
// dequantization as a rounded product then a rounded sum (no FMA).
//
// What bounds it on this card: bytes. Its chains do 4.9k (mlp_a) to 61k
// (mlp_b) int8 MACs per point on 48-256 input bytes per point: 32 and 480
// operations per byte, below the ~590 where int8 tensor cores (1,979 TOP/s)
// overtake HBM (3.35 TB/s). This first
// version moves more bytes than the bound counts: every hidden layer's fp32
// activations go to device memory and back, and x is read twice (absmax and
// layer 0). Keeping int8 activations on chip, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;              // 8 warps
constexpr int kWarpsM = 4;                 // warps along rows, 16 rows each
constexpr int kWarpsN = 2;                 // warps along columns
constexpr int kTileRows = 16 * kWarpsM;    // 64 rows of one window per block
constexpr int kMaxWidth = 256;
constexpr int kColAlign = 8 * kWarpsN;     // columns padded to whole n-tiles per warp
constexpr int kMaxNTiles = kMaxWidth / 8 / kWarpsN;  // 16 n-tiles of 8 per warp
constexpr int kK = 32;                     // mma depth in int8 values
// bytes added to each shared row of the tile: the 8 row groups of an A
// fragment load then land on 8 distinct 4-bank sets for every padded K
constexpr int kSkew = 16;
// words added to each shared row of the weights (a row holds 4 k of every
// column): the 4 k-rows of a B fragment load then land on distinct banks
constexpr int kColSkew = 8;
constexpr int kMaxLayers = 4;
constexpr int kAbsmaxChunk = kThreads * 8;  // elements per absmax block
// the largest dynamic shared memory a layer launch asks for: int8 rows of
// the tile, the packed weights, and the pool's reduction floats
constexpr size_t kMaxSmem = (size_t)kTileRows * (kMaxWidth + kSkew) +
                            (size_t)kMaxWidth * (kMaxWidth + kColSkew) +
                            sizeof(float) * kWarpsM * kMaxWidth;
constexpr int kMaxDevices = 64;

struct Layer {
  const float* in;            // [rows, cin] fp32
  const int8_t* w;            // [cin, cout] int8, row-major
  const float* s_w;           // [cout]
  const float* b;             // [cout]
  const unsigned* amax_in;    // [groups] bits of the block's input absmax
  unsigned* amax_out;         // [groups] next layer's words, or null
  float* out;                 // [rows, cout] fp32, or null
  float* partial;             // [windows, tiles, cout] tile maxima, or null
  int cin, cout, relu;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float block_scale(const unsigned* amax, int group) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax[group]), 1e-12f), 127.0f);
}

__device__ __forceinline__ unsigned quantize(float v, float s_x) {
  return (unsigned)(int)fminf(fmaxf(rintf(__fdiv_rn(v, s_x)), -127.f), 127.f) & 0xffu;
}

// four int8 values, the first in the lowest byte
__device__ __forceinline__ unsigned pack4(float a, float b, float c, float d, float s_x) {
  return quantize(a, s_x) | quantize(b, s_x) << 8 | quantize(c, s_x) << 16 |
         quantize(d, s_x) << 24;
}

// grid (groups, chunks): the absmax of each block of g windows of x
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, long long group_elems, unsigned* __restrict__ amax) {
  const float* p = x + (size_t)blockIdx.x * group_elems;
  float m = 0.f;
  for (long long i = (long long)blockIdx.y * kThreads + threadIdx.x; i < group_elems;
       i += (long long)gridDim.y * kThreads)
    m = fmaxf(m, fabsf(p[i]));
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) atomicMax(&amax[blockIdx.x], __float_as_uint(m));
}

// one block per 64-row tile of one window; grid = windows * tiles
__global__ void __launch_bounds__(kThreads)
layer_kernel(Layer L, int n, int g, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kpad = (L.cin + kK - 1) / kK * kK;
  const int kw = kpad / 4;                  // 32-bit words per k-extent
  const int lda = kw + kSkew / 4;           // tile row stride, in words
  const int ncol = (L.cout + kColAlign - 1) / kColAlign * kColAlign;
  const int ldb = ncol + kColSkew;          // weight row stride, in words
  unsigned* As = reinterpret_cast<unsigned*>(smem);  // [kTileRows][lda]: 4 k of a row
  unsigned* Bs = As + kTileRows * lda;               // [kw][ldb]: 4 k of a column
  float* red = reinterpret_cast<float*>(Bs + kw * ldb);  // [kWarpsM][cout]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int gid = lane >> 2, tig = lane & 3;
  const int window = blockIdx.x / tiles;
  const int tile = blockIdx.x - window * tiles;
  const int row0 = tile * kTileRows;
  const int rows_here = min(kTileRows, n - row0);
  const int group = window / g;
  const float s_x = block_scale(L.amax_in, group);

  // weights: word (kq, c) holds w[4kq .. 4kq+3][c], zero past cin and cout
  if (L.cout % 4 == 0) {
    // 4-byte loads of 4 columns from 4 rows, transposed with byte permutes
    const int cq_n = ncol / 4;
    for (int idx = tid; idx < kw * cq_n; idx += kThreads) {
      const int kq = idx / cq_n;
      const int c = (idx - kq * cq_n) * 4;
      unsigned r[4] = {0u, 0u, 0u, 0u};
      if (c < L.cout) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kq * 4 + j;
          if (k < L.cin) r[j] = *reinterpret_cast<const unsigned*>(L.w + (size_t)k * L.cout + c);
        }
      }
      const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140), hi01 = __byte_perm(r[0], r[1], 0x7362);
      const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140), hi23 = __byte_perm(r[2], r[3], 0x7362);
      *reinterpret_cast<uint4*>(Bs + kq * ldb + c) =
          make_uint4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
    }
  } else {
    for (int idx = tid; idx < kw * ncol; idx += kThreads) {
      const int kq = idx / ncol;
      const int c = idx - kq * ncol;
      unsigned word = 0u;
      if (c < L.cout) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = kq * 4 + j;
          if (k < L.cin) word |= ((unsigned)L.w[(size_t)k * L.cout + c] & 0xffu) << (8 * j);
        }
      }
      Bs[kq * ldb + c] = word;
    }
  }
  // the tile's rows quantized with the block's scale; rows past the window's
  // end and columns past cin are zeros (masked out of every output below)
  {
    const float* src = L.in + ((size_t)window * n + row0) * L.cin;
    for (int idx = tid; idx < kTileRows * kw; idx += kThreads) {
      const int r = idx / kw;
      const int k = (idx - r * kw) * 4;
      unsigned word = 0u;
      if (r < rows_here && k < L.cin) {
        const float* p = src + (size_t)r * L.cin + k;
        if (L.cin % 4 == 0) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          word = pack4(v.x, v.y, v.z, v.w, s_x);
        } else {
          word = pack4(p[0], k + 1 < L.cin ? p[1] : 0.f, k + 2 < L.cin ? p[2] : 0.f,
                       k + 3 < L.cin ? p[3] : 0.f, s_x);
        }
      }
      As[r * lda + k / 4] = word;
    }
  }
  __syncthreads();

  const int n_tiles = ncol / 8;  // even: each warp column gets n_tiles / 2
  int acc[kMaxNTiles][4];
#pragma unroll
  for (int j = 0; j < kMaxNTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  const unsigned* a_lo = As + (wm * 16 + gid) * lda + tig;
  const unsigned* a_hi = a_lo + 8 * lda;
  for (int kq = 0; kq < kw; kq += kK / 4) {
    const unsigned a0 = a_lo[kq], a1 = a_hi[kq], a2 = a_lo[kq + 4], a3 = a_hi[kq + 4];
    const unsigned* b_lo = Bs + (kq + tig) * ldb + gid;
#pragma unroll
    for (int j = 0; j < kMaxNTiles; ++j) {
      const int nt = wn + kWarpsN * j;
      if (nt < n_tiles) mma_s8(acc[j], a0, a1, a2, a3, b_lo[nt * 8], b_lo[4 * ldb + nt * 8]);
    }
  }

  // epilogue: the accumulator's (row, col) pairs are (r_lo, c), (r_lo, c+1),
  // (r_hi, c), (r_hi, c+1) with c = nt * 8 + tig * 2
  const int r_lo = wm * 16 + gid, r_hi = r_lo + 8;
  const bool lo_ok = r_lo < rows_here, hi_ok = r_hi < rows_here;
  float* dst = L.out != nullptr ? L.out + ((size_t)window * n + row0) * L.cout : nullptr;
  float habs = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxNTiles; ++j) {
    const int nt = wn + kWarpsN * j;
    if (nt >= n_tiles) continue;  // warp-uniform
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = nt * 8 + tig * 2 + e;
      float cmax = -CUDART_INF_F;
      if (c < L.cout) {
        const float scale = __fmul_rn(s_x, L.s_w[c]);
        const float bc = L.b[c];
        float v_lo = __fadd_rn(__fmul_rn((float)acc[j][e], scale), bc);
        float v_hi = __fadd_rn(__fmul_rn((float)acc[j][2 + e], scale), bc);
        if (L.relu) {
          v_lo = fmaxf(v_lo, 0.f);
          v_hi = fmaxf(v_hi, 0.f);
        }
        if (lo_ok) {
          if (dst != nullptr) dst[(size_t)r_lo * L.cout + c] = v_lo;
          habs = fmaxf(habs, fabsf(v_lo));
          cmax = v_lo;
        }
        if (hi_ok) {
          if (dst != nullptr) dst[(size_t)r_hi * L.cout + c] = v_hi;
          habs = fmaxf(habs, fabsf(v_hi));
          cmax = fmaxf(cmax, v_hi);
        }
      }
      if (L.partial != nullptr) {  // the column's max over the warp's 16 rows
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
        if (gid == 0 && c < L.cout) red[wm * L.cout + c] = cmax;
      }
    }
  }
  if (L.amax_out != nullptr) {
    habs = warp_max(habs);
    if (lane == 0) atomicMax(&L.amax_out[group], __float_as_uint(habs));
  }
  if (L.partial != nullptr) {
    __syncthreads();
    float* p = L.partial + ((size_t)window * tiles + tile) * L.cout;
    for (int c = tid; c < L.cout; c += kThreads) {
      float m = red[c];
#pragma unroll
      for (int w = 1; w < kWarpsM; ++w) m = fmaxf(m, red[w * L.cout + c]);
      p[c] = m;
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

// Raise layer_kernel's dynamic shared-memory limit on the current device to
// kMaxSmem, once: the limit belongs to the function on the whole device, so
// setting it per call would race between threads that launch concurrently.
cudaError_t ensure_smem_limit() {
  static std::mutex mu;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int quantized_mlp_chain_tile_rows(void) { return kTileRows; }
extern "C" int quantized_mlp_chain_max_width(void) { return kMaxWidth; }

// x [m, n, cin] fp32 with m a multiple of g (zero windows already appended);
// w_l [cin_l, couts[l]] int8; s_l, b_l [couts[l]] fp32. acts (nullable)
// [m, n, cout_last]; pooled (nullable) [m, cout_last] with partial
// [m, ceil(n / tile_rows), cout_last] as scratch; buf0, buf1 [m * n * widest
// hidden cout] fp32 scratch (nullable for one layer); amax [n_layers, m / g]
// 32-bit scratch. All contiguous, on the current device. Returns the first
// failing call's cudaError_t (0 = every launch was accepted).
extern "C" int quantized_mlp_chain_s8(
    const float* x, int m, int n, int cin, int g, int n_layers,
    const int8_t* w0, const int8_t* w1, const int8_t* w2, const int8_t* w3,
    const float* s0, const float* s1, const float* s2, const float* s3,
    const float* b0, const float* b1, const float* b2, const float* b3,
    int c0, int c1, int c2, int c3, int relu_last,
    float* acts, float* pooled, float* partial, float* buf0, float* buf1,
    unsigned* amax, void* stream) {
  if (m <= 0 || n <= 0 || cin <= 0 || cin > kMaxWidth || g <= 0 || m % g != 0 ||
      n_layers < 1 || n_layers > kMaxLayers || amax == nullptr ||
      (acts == nullptr && pooled == nullptr) || (pooled != nullptr && partial == nullptr) ||
      (n_layers > 1 && (buf0 == nullptr || (n_layers > 2 && buf1 == nullptr))))
    return (int)cudaErrorInvalidValue;
  const int8_t* ws[kMaxLayers] = {w0, w1, w2, w3};
  const float* ss[kMaxLayers] = {s0, s1, s2, s3};
  const float* bs[kMaxLayers] = {b0, b1, b2, b3};
  const int cs[kMaxLayers] = {c0, c1, c2, c3};
  for (int l = 0; l < n_layers; ++l)
    if (cs[l] <= 0 || cs[l] > kMaxWidth || ws[l] == nullptr || ss[l] == nullptr ||
        bs[l] == nullptr)
      return (int)cudaErrorInvalidValue;
  const int groups = m / g;
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const long long blocks = (long long)m * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = ensure_smem_limit();
  if (err != cudaSuccess) return (int)err;

  err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * (size_t)n_layers * groups, s);
  if (err != cudaSuccess) return (int)err;
  const long long group_elems = (long long)g * n * cin;
  long long chunks = (group_elems + kAbsmaxChunk - 1) / kAbsmaxChunk;
  if (chunks > 65535) chunks = 65535;
  absmax_kernel<<<dim3((unsigned)groups, (unsigned)chunks), kThreads, 0, s>>>(
      x, group_elems, amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  float* bufs[2] = {buf0, buf1};
  const float* in = x;
  int c_in = cin;
  for (int l = 0; l < n_layers; ++l) {
    const bool last = l == n_layers - 1;
    Layer L;
    L.in = in;
    L.w = ws[l];
    L.s_w = ss[l];
    L.b = bs[l];
    L.amax_in = amax + (size_t)l * groups;
    L.amax_out = last ? nullptr : amax + (size_t)(l + 1) * groups;
    L.out = last ? acts : bufs[l % 2];
    L.partial = last && pooled != nullptr ? partial : nullptr;
    L.cin = c_in;
    L.cout = cs[l];
    L.relu = !last || relu_last;
    const int kpad = (c_in + kK - 1) / kK * kK;
    const int ncol = (cs[l] + kColAlign - 1) / kColAlign * kColAlign;
    const size_t smem = (size_t)kTileRows * (kpad + kSkew) + (size_t)kpad * (ncol + kColSkew) +
                        sizeof(float) * kWarpsM * cs[l];
    layer_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(L, n, g, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    in = L.out;
    c_in = cs[l];
  }
  if (pooled == nullptr) return 0;
  const int cout = cs[n_layers - 1];
  const long long total = (long long)m * cout;
  const int threads = 256;
  pool_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
      partial, tiles, cout, pooled, total);
  return (int)cudaGetLastError();
}
