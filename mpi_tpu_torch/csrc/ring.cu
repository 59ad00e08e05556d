// Ring collectives over P virtual ranks held in one device memory.
//
// Replaces the Pallas TPU ring kernel mpi_tpu/tpu/pallas_ring.py:_kernel
// (launched by _launch, pallas_ring.py:434) in its three modes: allreduce
// (reduce-scatter + allgather halves, rot=0), reduce_scatter (first half
// only, rot=-1) and allgather (second half only).
//
// What it computes.  The TPU kernel moves chunks between chips with RDMA
// and folds each received tile into the local copy, acc = own (+) received.
// Every chunk `a` of a group of g ranks is therefore folded along the ring:
// it starts at group position a - s*rot and walks in steps of s, one fold
// per hop, where s = +1 for the tiles of the right-going flows (tile index
// t < tA) and s = -1 for the left-going mirror ring (t >= tA).  This kernel
// folds every element in exactly that order, so float32 and bfloat16
// results are bitwise those of the reference; bfloat16 rounds after every
// fold, as the TPU kernel folds in VMEM in the input dtype.
//
// What bounds it.  On one card the g inputs of a group sit in one memory,
// so no chunk has to travel: the least work is to read each input once and
// write each output once.  Allreduce reads P*n and writes P*n elements;
// reduce_scatter reads P*g*block and writes P*block; allgather reads
// P*block and writes P*g*block.  All three are bound by device-memory
// bandwidth (the fold is one add per element read).
//
// Design.  One thread per (group, VEC consecutive elements): it reads the
// g ranks' elements with 16-byte vector loads where the layout allows, up
// to eight of them before the first fold (that many loads in flight), folds them in ring
// order in registers and writes the result straight to the output(s).
// That moves the minimum number of bytes.  The fold's grid is 2-D over
// (chunk, offset), so no thread divides.  The RDMA steps,
// landing slots, credits and barriers of the TPU design exist to move
// chunks between chips and have no counterpart here; a pipelined
// peer-to-peer ring over NVLink belongs to the multi-card port.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// OP: 0 sum, 1 max, 2 min.  max/min propagate NaN like torch.maximum and
// jnp.maximum (fmaxf/fminf would drop it).
template <int OP>
__device__ __forceinline__ float combine(float own, float acc) {
  if (OP == 0) return own + acc;
  if (own != own) return own;
  if (acc != acc) return acc;
  if (OP == 1) return own > acc ? own : acc;
  return own < acc ? own : acc;
}

constexpr int kThreads = 256;

// x: [P, n_inner] per-rank inputs; groups: [ngroups, g] world ranks in ring
// order.  Element i of a rank lies in chunk a = i / chunk_len at offset
// inner = i % chunk_len; its fold walks right (s = +1) when inner lies in
// the chunk's first tA tiles (inner < split = tA * tile_elems), else left.
// The grid is (vectors of a chunk, chunk a, group): a block knows its
// chunk, and no thread divides.  scatter == 0 (allreduce): the folded value
// goes to every member at offset i of an [P, n_inner] output.  scatter == 1
// (reduce_scatter): it goes to member a at offset inner of an
// [P, chunk_len] output.  A thread issues the loads of its vector's ranks
// in batches of kBatch before it folds them: the order of the folds is the
// ring's, the order of the loads is free.
constexpr int kBatch = 8;

template <typename T, int OP, int VEC>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const T* __restrict__ x, T* __restrict__ out, const int* __restrict__ groups,
            int g, long long n_inner, long long chunk_len, long long split, int rot,
            int scatter) {
  using V = Pack<T, VEC>;
  const int a = blockIdx.y;
  const int* G = groups + (long long)blockIdx.z * g;
  const long long inner = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  const long long i = a * chunk_len + inner;
  if (inner >= chunk_len || i >= n_inner) return;
  const int s = inner < split ? 1 : -1;
  int p = ((a - s * rot) % g + g) % g;
  V acc;
  for (int k0 = 0; k0 < g; k0 += kBatch) {
    V own[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k0 + b < g) own[b] = *reinterpret_cast<const V*>(x + G[p] * n_inner + i);
      p += s;
      if (p == g) p = 0;
      if (p < 0) p = g - 1;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k0 + b >= g) break;
      if (k0 + b == 0) {
        acc = own[0];
        continue;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc.v[e] = from_f<T>(combine<OP>(to_f(own[b].v[e]), to_f(acc.v[e])));
    }
  }
  if (scatter) {
    *reinterpret_cast<V*>(out + G[a] * chunk_len + inner) = acc;
  } else {
    for (int q = 0; q < g; ++q) *reinterpret_cast<V*>(out + G[q] * n_inner + i) = acc;
  }
}

// x: [P, block_n]; out: [P, g, block_n].  Member q of a group receives
// member b's block at out[G[q], b].
template <typename T, int VEC>
__global__ void gather_kernel(const T* __restrict__ x, T* __restrict__ out,
                              const int* __restrict__ groups, int g,
                              long long block_n) {
  const int* G = groups + (long long)blockIdx.y * g;
  const long long nvec = (long long)g * block_n / VEC;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long i = v * VEC;
    const long long b = i / block_n;
    const long long j = i - b * block_n;
    const Pack<T, VEC> val =
        *reinterpret_cast<const Pack<T, VEC>*>(x + G[b] * block_n + j);
    for (int q = 0; q < g; ++q)
      *reinterpret_cast<Pack<T, VEC>*>(out + ((long long)G[q] * g + b) * block_n + j) = val;
  }
}

dim3 grid_for(long long nvec, int ngroups) {
  long long blocks = (nvec + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // 16 resident blocks' worth per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return dim3((unsigned)blocks, (unsigned)ngroups, 1);
}

// a grid of (vectors of a chunk, chunks, groups)
template <typename T, int OP, int VEC>
void launch_fold(const void* x, void* out, const int* groups, int ngroups, int g,
                 long long n_inner, long long chunk_len, long long tile_elems, int tA,
                 int rot, int scatter, cudaStream_t stream) {
  const long long chunks = (n_inner + chunk_len - 1) / chunk_len;
  const long long blocks = (chunk_len / VEC + kThreads - 1) / kThreads;
  dim3 grid((unsigned)blocks, (unsigned)chunks, (unsigned)ngroups);
  fold_kernel<T, OP, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), groups, g, n_inner, chunk_len,
      tA * tile_elems, rot, scatter);
}

template <typename T, int OP>
void dispatch_vec(int vec, const void* x, void* out, const int* groups, int ngroups,
                  int g, long long n_inner, long long chunk_len, long long tile_elems,
                  int tA, int rot, int scatter, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    launch_fold<T, OP, kVec>(x, out, groups, ngroups, g, n_inner, chunk_len, tile_elems, tA,
                             rot, scatter, stream);
  else
    launch_fold<T, OP, 1>(x, out, groups, ngroups, g, n_inner, chunk_len, tile_elems, tA,
                          rot, scatter, stream);
}

template <typename T>
void dispatch_op(int op, int vec, const void* x, void* out, const int* groups,
                 int ngroups, int g, long long n_inner, long long chunk_len,
                 long long tile_elems, int tA, int rot, int scatter,
                 cudaStream_t stream) {
  if (op == 0)
    dispatch_vec<T, 0>(vec, x, out, groups, ngroups, g, n_inner, chunk_len,
                       tile_elems, tA, rot, scatter, stream);
  else if (op == 1)
    dispatch_vec<T, 1>(vec, x, out, groups, ngroups, g, n_inner, chunk_len,
                       tile_elems, tA, rot, scatter, stream);
  else
    dispatch_vec<T, 2>(vec, x, out, groups, ngroups, g, n_inner, chunk_len,
                       tile_elems, tA, rot, scatter, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  op: 0 sum, 1 max, 2 min.  vec: 16/itemsize
// when every rank's row, chunk and pointer is 16-byte aligned, else 1.
// Returns cudaGetLastError() after the launch.
extern "C" int ring_fold(const void* x, void* out, const void* groups, int ngroups,
                         int g, long long n_inner, long long chunk_len,
                         long long tile_elems, int tA, int rot, int scatter,
                         int dtype, int op, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gr = static_cast<const int*>(groups);
  if (dtype == 0)
    dispatch_op<float>(op, vec, x, out, gr, ngroups, g, n_inner, chunk_len,
                       tile_elems, tA, rot, scatter, s);
  else
    dispatch_op<__nv_bfloat16>(op, vec, x, out, gr, ngroups, g, n_inner,
                               chunk_len, tile_elems, tA, rot, scatter, s);
  return (int)cudaGetLastError();
}

extern "C" int ring_gather(const void* x, void* out, const void* groups, int ngroups,
                           int g, long long block_n, int dtype, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gr = static_cast<const int*>(groups);
  const long long total = (long long)g * block_n;
  if (dtype == 0) {
    if (vec == 4)
      gather_kernel<float, 4><<<grid_for(total / 4, ngroups), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), gr, g, block_n);
    else
      gather_kernel<float, 1><<<grid_for(total, ngroups), kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(out), gr, g, block_n);
  } else {
    if (vec == 8)
      gather_kernel<__nv_bfloat16, 8><<<grid_for(total / 8, ngroups), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), gr, g,
          block_n);
    else
      gather_kernel<__nv_bfloat16, 1><<<grid_for(total, ngroups), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), gr, g,
          block_n);
  }
  return (int)cudaGetLastError();
}
