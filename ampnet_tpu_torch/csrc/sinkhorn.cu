// The log-domain Sinkhorn iterations of balanced k-means, bit for bit as the
// plain PyTorch loop rounds them: three kernels and one torch sum an
// iteration.
//
// Replaces no TPU kernel: the JAX package runs ampnet_tpu/ops/kmeans.py's
// sinkhorn_plan inside one XLA program. The port's plain loop (ops/kmeans.py,
// sinkhorn_plan) spends each of its 30 iterations on two torch.logsumexp
// calls over [B, N, k] and the broadcasts around them, ~25 launches of a few
// microseconds, 10 times a tiling: ~8,000 nodes in every tiled-inference
// bucket graph.
//
// Why not one kernel for the whole loop: the tiling rounds a near tie at a
// cluster's capacity otherwise under any other order of the plain loop's
// sums (a float64 mean alone moves points on 2 % of served clouds), and the
// served labels are held to the plain loop's windows. So these kernels do
// the plain loop's float32 operations in its order (no fast-math: expf and
// logf as torch's exp and log compute them), and each sum either stays
// torch's own reduction or takes its order:
//
//   v = log c - logsumexp_n(logK + u):
//     colmax:  M = max_n(logK + u) (0 where infinite, as torch's logsumexp
//              sets it): each block's maxima, then the last block to finish
//              takes theirs; u from the last row update, 0 at the first
//     colexp:  E = exp((logK + u) - M)
//     torch:   S = E.sum(-2)
//   u = -logsumexp_c(logK + v):
//     rows:    v = log c - (log S + M); m = max_c(logK + v) (0 where
//              infinite); e = exp((logK + v) - m); s = the sum of the k
//              e's in the order torch's sum over a last dimension of at most
//              32 takes on the card (lane c holds e_c, 0 past k, then
//              shuffles down by 16, 8, 4, 2, 1); u = -(log s + m)
//
// A max is exact in any order, the row sum takes torch's order, and every
// other operation is one float32 operation on one element, so the outputs
// equal the torch passes' bit for bit, and torch's column sum sees the same
// inputs. Per iteration: 3 launches here and 1 sum instead of ~25 launches
// (logK + u, logK + v, their differences and the row exps are never stored).
//
// Each block takes 256 consecutive points of one cloud, each of its 8 warps
// a tile of 32 points; a tile's 32k contiguous floats move between global
// and shared memory in 128-byte loads and stores, and each lane works its own
// point's row out of the tile. All three launch on the caller's stream,
// allocate nothing and never sync the host: they capture into a CUDA graph.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockRows = kWarps * 32;  // a warp a tile of 32 points
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

int blocks_for(int n) { return (n + kBlockRows - 1) / kBlockRows; }

struct Columns {
  const float* logk;    // [B, N, k]
  const float* u;       // [B, N] the last row update's (unused when first)
  float* partial;       // [B, blocks, k] scratch: the blocks' maxima
  int* done;            // [B] blocks done (colmax), 0 between launches
  float* exps;          // [B, N, k] out: E (colexp)
  float* colmax;        // [B, k] out: M (colmax), in (colexp)
  int n, k, blocks, first;
};

struct Rows {
  const float* logk;    // [B, N, k]
  const float* colsum;  // [B, k] S
  const float* colmax;  // [B, k] M
  const float* logc;    // [k] log capacities
  float* v;             // [B, k] out
  float* u;             // [B, N] out
  int n, k;
};

// row r's u, or the plain loop's zeros at the first iteration
__device__ __forceinline__ float row_u(const Columns& a, size_t r) {
  return a.first ? 0.f : a.u[r];
}

// the sum of e[0, k) (e 0 from k to K) in the order torch.sum takes over a
// last dimension of at most 32 on the card: lane c holds e[c], then each lane
// adds the lane 16, 8, 4, 2 and 1 above it; lane 0's
template <int K>
__device__ __forceinline__ float row_sum(const float (&e)[K]) {
  float p[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) p[c] = c < K ? e[c] : 0.f;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
#pragma unroll
    for (int t = 0; t < o; ++t) p[t] += p[t + o];
  }
  return p[0];
}

// torch's logsumexp replaces an infinite maximum by 0 before it subtracts
__device__ __forceinline__ float finite_max(float m) { return isinf(m) ? 0.f : m; }

// the first point of this warp's tile
__device__ __forceinline__ int tile_row(int warp) { return blockIdx.x * kBlockRows + warp * 32; }

// rows [row0, row0 + rows) of a [N, k] block into tile (row r at r * k)
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, int row0,
                                          int rows, int k, int lane) {
  const float* from = src + (size_t)row0 * k;
  for (int i = lane; i < rows * k; i += 32) tile[i] = from[i];
  __syncwarp();
}

__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* tile, int row0,
                                           int rows, int k, int lane) {
  __syncwarp();
  float* to = dst + (size_t)row0 * k;
  for (int i = lane; i < rows * k; i += 32) to[i] = tile[i];
  __syncwarp();
}

// K: the clusters padded to an even count (k <= K columns are real)
template <int K>
__global__ void __launch_bounds__(kThreads) colmax_kernel(const Columns a) {
  __shared__ float tiles[kWarps][32 * K];
  __shared__ float red[kWarps][K];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.y, n = a.n, k = a.k;
  const size_t base = (size_t)b * n;
  float* tile = tiles[warp];
  const float* mine = tile + lane * k;  // this lane's point's row in the tile
  float mx[K];
#pragma unroll
  for (int c = 0; c < K; ++c) mx[c] = -INFINITY;
  const int row0 = tile_row(warp);
  const int rows = max(0, min(32, n - row0));  // uniform in the warp
  if (rows > 0) {
    load_tile(tile, a.logk + base * k, row0, rows, k, lane);
    if (lane < rows) {
      const float u = row_u(a, base + row0 + lane);
#pragma unroll
      for (int c = 0; c < K; ++c)
        if (c < k) mx[c] = fmaxf(mx[c], mine[c] + u);
    }
  }
#pragma unroll
  for (int c = 0; c < K; ++c) {
    float x = mx[c];
#pragma unroll
    for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
    if (lane == 0) red[warp][c] = x;
  }
  __syncthreads();
  __shared__ bool last;
  if (t < k) {
    float x = red[0][t];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x = fmaxf(x, red[w][t]);
    a.partial[((size_t)b * a.blocks + blockIdx.x) * k + t] = x;
    __threadfence();  // the maxima reach the cloud's last block before its count does
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(&a.done[b], 1) == a.blocks - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every block's maxima (past L1, which another block's
  // writes do not reach), kWarps threads a column
  if (t < kWarps * k) {
    const int c = t % k, q = t / k;
    const float* p = a.partial + (size_t)b * a.blocks * k + c;
    float x = -INFINITY;
    for (int j = q; j < a.blocks; j += kWarps) x = fmaxf(x, __ldcg(p + (size_t)j * k));
    red[q][c] = x;
  }
  __syncthreads();
  if (t < k) {
    float x = red[0][t];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) x = fmaxf(x, red[q][t]);
    a.colmax[(size_t)b * k + t] = finite_max(x);
  }
  if (t == 0) a.done[b] = 0;  // for the next launch
}

template <int K>
__global__ void __launch_bounds__(kThreads) colexp_kernel(const Columns a) {
  __shared__ float tiles[kWarps][32 * K];
  __shared__ float cmax[K];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.y, n = a.n, k = a.k;
  const size_t base = (size_t)b * n;
  if (t < k) cmax[t] = a.colmax[(size_t)b * k + t];
  __syncthreads();
  const int row0 = tile_row(warp);
  if (row0 >= n) return;  // uniform in the warp
  const int rows = min(32, n - row0);
  float* tile = tiles[warp];
  float* mine = tile + lane * k;
  load_tile(tile, a.logk + base * k, row0, rows, k, lane);
  if (lane < rows) {
    const float u = row_u(a, base + row0 + lane);
#pragma unroll
    for (int c = 0; c < K; ++c)
      if (c < k) mine[c] = expf((mine[c] + u) - cmax[c]);
  }
  store_tile(a.exps + base * k, tile, row0, rows, k, lane);
}

template <int K>
__global__ void __launch_bounds__(kThreads) rows_kernel(const Rows a) {
  __shared__ float tiles[kWarps][32 * K];
  __shared__ float vs[K];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.y, n = a.n, k = a.k;
  if (t < k) {
    const size_t j = (size_t)b * k + t;
    const float lse = logf(a.colsum[j]) + a.colmax[j];
    const float v = a.logc[t] - lse;
    vs[t] = v;
    if (blockIdx.x == 0) a.v[j] = v;
  }
  __syncthreads();
  const int row0 = tile_row(warp);
  if (row0 >= n) return;  // uniform in the warp
  const int rows = min(32, n - row0);
  const size_t base = (size_t)b * n;
  float* tile = tiles[warp];
  float* mine = tile + lane * k;
  load_tile(tile, a.logk + base * k, row0, rows, k, lane);
  if (lane < rows) {
    float y[K], m = -INFINITY;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      if (c < k) {
        y[c] = mine[c] + vs[c];
        m = fmaxf(m, y[c]);
      }
    }
    m = finite_max(m);
#pragma unroll
    for (int c = 0; c < K; ++c) y[c] = c < k ? expf(y[c] - m) : 0.f;
    // -(log s + m), as torch rounds log_() then add_() then the negation
    a.u[base + row0 + lane] = -(logf(row_sum<K>(y)) + m);
  }
}

template <int K>
cudaError_t launch_columns(const Columns& a, int batch, cudaStream_t stream) {
  const dim3 grid(a.blocks, batch, 1);
  colmax_kernel<K><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colexp_kernel<K><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_rows(const Rows& a, int batch, cudaStream_t stream) {
  rows_kernel<K><<<dim3(blocks_for(a.n), batch, 1), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// every even K to 32: a padding column costs work, not accuracy
#define SK_EVEN(X) X(2) X(4) X(6) X(8) X(10) X(12) X(14) X(16) X(18) X(20) X(22) X(24) \
  X(26) X(28) X(30) X(32)
#define SK_COLUMNS(K) launch_columns<K>,
#define SK_ROWS(K) launch_rows<K>,

typedef cudaError_t (*ColumnsLaunch)(const Columns&, int, cudaStream_t);
typedef cudaError_t (*RowsLaunch)(const Rows&, int, cudaStream_t);
const ColumnsLaunch kColumns[] = {SK_EVEN(SK_COLUMNS)};
const RowsLaunch kRows[] = {SK_EVEN(SK_ROWS)};

bool bad_shape(int batch, int n, int k) {
  return batch < 1 || batch > 65535 || n < 1 || k < 1 || k > kMaxK;
}

}  // namespace

// The blocks a cloud of n points takes: the rows of the scratch [batch,
// blocks, k] that sinkhorn_columns gets.
extern "C" int sinkhorn_blocks(int n) { return n < 1 ? 0 : blocks_for(n); }

// The column half of an iteration (colmax, then colexp): logk [batch, n, k],
// u [batch, n] (read unless first), partial [batch,
// sinkhorn_blocks(n), k] float scratch, done [batch] int32 zeros (left zero),
// exps [batch, n, k] and colmax [batch, k] out; contiguous, on the current
// device. Returns the launches' cudaError_t (0 = launched).
extern "C" int sinkhorn_columns(const float* logk, const float* u, float* partial, int* done,
                                float* exps, float* colmax, int batch, int n, int k, int first,
                                void* stream) {
  if (logk == nullptr || partial == nullptr || done == nullptr || exps == nullptr ||
      colmax == nullptr || bad_shape(batch, n, k) || (!first && u == nullptr))
    return (int)cudaErrorInvalidValue;
  const Columns a = {logk, u, partial, done, exps, colmax, n, k, blocks_for(n), first ? 1 : 0};
  return (int)kColumns[(k + 1) / 2 - 1](a, batch, (cudaStream_t)stream);
}

// The row half: logk [batch, n, k], colsum and colmax [batch, k], logc [k];
// v [batch, k] and u [batch, n] out.
extern "C" int sinkhorn_rows(const float* logk, const float* colsum, const float* colmax,
                             const float* logc, float* v, float* u, int batch, int n, int k,
                             void* stream) {
  if (logk == nullptr || colsum == nullptr || colmax == nullptr || logc == nullptr ||
      v == nullptr || u == nullptr || bad_shape(batch, n, k))
    return (int)cudaErrorInvalidValue;
  const Rows a = {logk, colsum, colmax, logc, v, u, n, k};
  return (int)kRows[(k + 1) / 2 - 1](a, batch, (cudaStream_t)stream);
}
