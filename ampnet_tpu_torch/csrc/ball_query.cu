// PointNet++'s ball query as a stable compaction of the squared-distance
// block: for each row (a centre) of d2 [rows, n], the first k in-ball indices
// in ascending order, the rest of the row padded with the first of them, or
// n throughout where the row has none; bit for bit as the plain PyTorch body
// (ops/sampling.py, ball_query_members_plain) picks them.
//
// Replaces no TPU kernel: the JAX package runs ampnet_tpu/models/pointnet2.py's
// ball query as a where / sort inside its jitted step. The port's plain body
// writes the sentinel n into an int64 copy of the whole block and sorts every
// row with cub's segmented radix sort on 64-bit keys (at PointNet++'s first
// level a [32, 1024, 16384] block: 4.3 GB of keys, written again as values and
// indices), to keep the first k.
//
// Bound: the bytes of d2 the kernel reads. A row stops at its k-th member, so
// it reads the row up to there (about half of a 16,384-entry row at radius 0.1
// in the unit cube; all of it where the ball holds fewer than k points) and
// writes k int64; at the first level at most 2.15 GB, ~0.64 ms at 3.35 TB/s.
//
// One warp a row: a row is a sequential scan that ends early, and a warp keeps
// it in lockstep with no shared memory, atomics or second pass. Each lane
// tests 4 consecutive entries (one 16-byte load where the row starts on a
// 16-byte boundary, else 4 scalar loads), so a chunk is 128 entries; a warp
// issues the loads of kChunks chunks at once to keep enough bytes in flight,
// then takes the chunks in order. Per chunk one ballot per entry of a lane
// and a popcount of the lanes below give each member its slot; the member
// count, and so the exit, is the same in every lane.
//
// Membership is d <= thr with thr the float32 the caller rounds radius^2 to
// once, as torch compares a float32 tensor with a Python float; NaN is no
// member. Launches on the caller's stream, allocates nothing, never syncs the
// host: it captures into a CUDA graph.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // rows a block
constexpr int kChunk = 128;   // entries a warp tests at once, 4 a lane
constexpr int kChunks = 4;    // chunks whose loads a warp issues together
constexpr unsigned kFull = 0xffffffffu;

// entries i .. i + 3 of a row of n; NaN past its end, which no test admits
__device__ __forceinline__ float4 load4(const float* row, long long n, long long i, bool vec) {
  if (vec && i + 4 <= n) return __ldg(reinterpret_cast<const float4*>(row + i));
  float4 v;
  v.x = i < n ? __ldg(row + i) : NAN;
  v.y = i + 1 < n ? __ldg(row + i + 1) : NAN;
  v.z = i + 2 < n ? __ldg(row + i + 2) : NAN;
  v.w = i + 3 < n ? __ldg(row + i + 3) : NAN;
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
    ball_query_kernel(const float* __restrict__ d2, long long* __restrict__ out, long long rows,
                      int n, int k, float thr) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp
  const float* row = d2 + r * n;
  long long* dst = out + r * k;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const unsigned below = (1u << lane) - 1u;
  int count = 0;          // members seen, the same in every lane
  long long first = n;    // the row's first member
  for (long long base = 0; base < n && count < k; base += kChunk * kChunks) {
    float4 v[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) v[c] = load4(row, n, base + c * kChunk + 4 * lane, vec);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (count >= k) break;
      const unsigned b0 = __ballot_sync(kFull, v[c].x <= thr);
      const unsigned b1 = __ballot_sync(kFull, v[c].y <= thr);
      const unsigned b2 = __ballot_sync(kFull, v[c].z <= thr);
      const unsigned b3 = __ballot_sync(kFull, v[c].w <= thr);
      const unsigned any = b0 | b1 | b2 | b3;
      if (any == 0u) continue;
      const long long at = base + c * kChunk;  // the chunk's first entry
      // entry at + 4 * lane + j comes after every member of the lanes below
      int slot = count + __popc(b0 & below) + __popc(b1 & below) + __popc(b2 & below) +
                 __popc(b3 & below);
      const long long mine = at + 4 * lane;
      if ((b0 >> lane) & 1u) {
        if (slot < k) dst[slot] = mine;
        ++slot;
      }
      if ((b1 >> lane) & 1u) {
        if (slot < k) dst[slot] = mine + 1;
        ++slot;
      }
      if ((b2 >> lane) & 1u) {
        if (slot < k) dst[slot] = mine + 2;
        ++slot;
      }
      if (((b3 >> lane) & 1u) && slot < k) dst[slot] = mine + 3;
      if (count == 0) {  // the lowest lane with a member, its lowest entry
        const int l = __ffs(any) - 1;
        const int j = (b0 >> l) & 1u ? 0 : (b1 >> l) & 1u ? 1 : (b2 >> l) & 1u ? 2 : 3;
        first = at + 4 * l + j;
      }
      count += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
    }
  }
  for (int j = min(count, k) + lane; j < k; j += 32) dst[j] = first;
}

}  // namespace

// d2 [rows, n] float32 and out [rows, k] int64 out, contiguous, on the current
// device; 1 <= k <= n. Returns the launch's cudaError_t (0 = launched).
extern "C" int ball_query_members(const float* d2, long long* out, long long rows, int n, int k,
                                  float thr, void* stream) {
  if (d2 == nullptr || out == nullptr || rows < 1 || n < 1 || k < 1 || k > n)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ball_query_kernel<<<(unsigned)blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(d2, out, rows, n,
                                                                              k, thr);
  return (int)cudaGetLastError();
}
