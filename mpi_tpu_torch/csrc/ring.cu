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
//
// Worlds that span processes (ring_fold_ptrs, ring_gather_ptrs).  When
// the ranks of one world live in several processes, each process keeps
// its ranks' rows in its own memory and exports a staging copy over CUDA
// IPC (mpi_tpu_torch/gpu/peers.py).  The same fold then reads rank w's row
// through a device table of per-rank base pointers (this process's rows
// for its own ranks, a peer's mapped staging buffer for the others) in
// place of x + w * n_inner, in the same order, and writes only the
// outputs of this process's ranks [first, first + count): allreduce rows,
// reduce_scatter chunks owned by local ranks, allgather rows.  The least
// work per process is to read g inputs for every element it writes and
// write each once.  Ordering with the peers is the host's: the staging
// copy is synchronised and every process passes a barrier before the
// launch, and again after it before staging is written anew.  No kernel
// waits on a flag that another process writes (two processes on one card
// are time-sliced, not co-resident).

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

// Where a launch reads rank w's row: one [P, n] array (Dense), or a table
// of per-rank base pointers (Peers), each row wherever its process keeps it.
template <typename T>
struct Dense {
  const T* x;
  long long n;
  __device__ __forceinline__ const T* operator()(int w) const { return x + (long long)w * n; }
};

template <typename T>
struct Peers {
  const unsigned long long* ptrs;
  __device__ __forceinline__ const T* operator()(int w) const {
    return reinterpret_cast<const T*>(ptrs[w]);
  }
};

// Which ranks' outputs a launch writes, and each one's row of out: every
// rank (All, one process holds the world), or this process's span of
// ranks [first, first + count) (Span).
struct All {
  __device__ __forceinline__ bool has(int) const { return true; }
  __device__ __forceinline__ long long row(int w) const { return w; }
};

struct Span {
  int first, count;
  __device__ __forceinline__ bool has(int w) const {
    return (unsigned)(w - first) < (unsigned)count;
  }
  __device__ __forceinline__ long long row(int w) const { return w - first; }
};

// x(w): rank w's [n_inner] input row; groups: [ngroups, g] world ranks in
// ring order.  Element i of a rank lies in chunk a = i / chunk_len at offset
// inner = i % chunk_len; its fold walks right (s = +1) when inner lies in
// the chunk's first tA tiles (inner < split = tA * tile_elems), else left.
// The grid is (vectors of a chunk, chunk a, group): a block knows its
// chunk, and no thread divides.  scatter == 0 (allreduce): the folded value
// goes to every member at offset i of an [*, n_inner] output.  scatter == 1
// (reduce_scatter): it goes to member a at offset inner of an
// [*, chunk_len] output.  Only members that outs holds are written (and a
// reduce_scatter chunk whose owner it does not hold is not folded).  A
// thread issues the loads of its vector's ranks in batches of kBatch
// before it folds them: the order of the folds is the ring's, the order of
// the loads is free.
constexpr int kBatch = 8;

template <typename T, int OP, int VEC, typename Rows, typename Outs>
__global__ void __launch_bounds__(kThreads)
fold_kernel(Rows x, T* __restrict__ out, Outs outs, const int* __restrict__ groups,
            int g, long long n_inner, long long chunk_len, long long split, int rot,
            int scatter) {
  using V = Pack<T, VEC>;
  const int a = blockIdx.y;
  const int* G = groups + (long long)blockIdx.z * g;
  const long long inner = ((long long)blockIdx.x * kThreads + threadIdx.x) * VEC;
  const long long i = a * chunk_len + inner;
  if (inner >= chunk_len || i >= n_inner) return;
  if (scatter && !outs.has(G[a])) return;
  const int s = inner < split ? 1 : -1;
  int p = ((a - s * rot) % g + g) % g;
  V acc;
  for (int k0 = 0; k0 < g; k0 += kBatch) {
    V own[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (k0 + b < g) own[b] = *reinterpret_cast<const V*>(x(G[p]) + i);
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
    *reinterpret_cast<V*>(out + outs.row(G[a]) * chunk_len + inner) = acc;
  } else {
    for (int q = 0; q < g; ++q)
      if (outs.has(G[q])) *reinterpret_cast<V*>(out + outs.row(G[q]) * n_inner + i) = acc;
  }
}

// x(w): rank w's [block_n] block; out: [*, g, block_n].  Member q of a
// group that outs holds receives member b's block at out[row(G[q]), b].
template <typename T, int VEC, typename Rows, typename Outs>
__global__ void gather_kernel(Rows x, T* __restrict__ out, Outs outs,
                              const int* __restrict__ groups, int g, long long block_n) {
  const int* G = groups + (long long)blockIdx.y * g;
  const long long nvec = (long long)g * block_n / VEC;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += (long long)gridDim.x * blockDim.x) {
    const long long i = v * VEC;
    const long long b = i / block_n;
    const long long j = i - b * block_n;
    const Pack<T, VEC> val = *reinterpret_cast<const Pack<T, VEC>*>(x(G[b]) + j);
    for (int q = 0; q < g; ++q)
      if (outs.has(G[q]))
        *reinterpret_cast<Pack<T, VEC>*>(out + (outs.row(G[q]) * g + b) * block_n + j) = val;
  }
}

dim3 grid_for(long long nvec, int ngroups) {
  long long blocks = (nvec + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // 16 resident blocks' worth per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return dim3((unsigned)blocks, (unsigned)ngroups, 1);
}

// The geometry of one fold launch.
struct FoldArgs {
  const int* groups;
  int ngroups, g;
  long long n_inner, chunk_len, tile_elems;
  int tA, rot, scatter;
};

// a grid of (vectors of a chunk, chunks, groups)
template <typename T, int OP, int VEC, typename Rows, typename Outs>
void launch_fold(Rows x, void* out, Outs outs, const FoldArgs& f, cudaStream_t stream) {
  const long long chunks = (f.n_inner + f.chunk_len - 1) / f.chunk_len;
  const long long blocks = (f.chunk_len / VEC + kThreads - 1) / kThreads;
  dim3 grid((unsigned)blocks, (unsigned)chunks, (unsigned)f.ngroups);
  fold_kernel<T, OP, VEC, Rows, Outs><<<grid, kThreads, 0, stream>>>(
      x, static_cast<T*>(out), outs, f.groups, f.g, f.n_inner, f.chunk_len,
      f.tA * f.tile_elems, f.rot, f.scatter);
}

template <typename T, int OP, typename Rows, typename Outs>
void fold_vec(int vec, Rows x, void* out, Outs outs, const FoldArgs& f, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec)
    launch_fold<T, OP, kVec>(x, out, outs, f, stream);
  else
    launch_fold<T, OP, 1>(x, out, outs, f, stream);
}

template <typename T, typename Rows, typename Outs>
void fold(int op, int vec, Rows x, void* out, Outs outs, const FoldArgs& f,
          cudaStream_t stream) {
  if (op == 0)
    fold_vec<T, 0>(vec, x, out, outs, f, stream);
  else if (op == 1)
    fold_vec<T, 1>(vec, x, out, outs, f, stream);
  else
    fold_vec<T, 2>(vec, x, out, outs, f, stream);
}

template <typename T, typename Rows, typename Outs>
void gather(int vec, Rows x, void* out, Outs outs, const int* groups, int ngroups, int g,
            long long block_n, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long total = (long long)g * block_n;
  if (vec == kVec)
    gather_kernel<T, kVec, Rows, Outs><<<grid_for(total / kVec, ngroups), kThreads, 0, stream>>>(
        x, static_cast<T*>(out), outs, groups, g, block_n);
  else
    gather_kernel<T, 1, Rows, Outs><<<grid_for(total, ngroups), kThreads, 0, stream>>>(
        x, static_cast<T*>(out), outs, groups, g, block_n);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  op: 0 sum, 1 max, 2 min.  vec: 16/itemsize
// when every rank's row, chunk and pointer is 16-byte aligned, else 1.
// Every entry point returns cudaGetLastError() after its launch.
extern "C" int ring_fold(const void* x, void* out, const void* groups, int ngroups,
                         int g, long long n_inner, long long chunk_len,
                         long long tile_elems, int tA, int rot, int scatter,
                         int dtype, int op, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FoldArgs f{static_cast<const int*>(groups), ngroups, g, n_inner, chunk_len,
                   tile_elems, tA, rot, scatter};
  if (dtype == 0)
    fold<float>(op, vec, Dense<float>{static_cast<const float*>(x), n_inner}, out, All{},
                f, s);
  else
    fold<__nv_bfloat16>(op, vec,
                        Dense<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x), n_inner},
                        out, All{}, f, s);
  return (int)cudaGetLastError();
}

// ptrs: [P] device table of each world rank's row base (uint64).  out holds
// the rows of ranks [first, first + count) only.
extern "C" int ring_fold_ptrs(const void* ptrs, void* out, const void* groups, int ngroups,
                              int g, long long n_inner, long long chunk_len,
                              long long tile_elems, int tA, int rot, int scatter,
                              int first, int count, int dtype, int op, int vec,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long* p = static_cast<const unsigned long long*>(ptrs);
  const FoldArgs f{static_cast<const int*>(groups), ngroups, g, n_inner, chunk_len,
                   tile_elems, tA, rot, scatter};
  const Span outs{first, count};
  if (dtype == 0)
    fold<float>(op, vec, Peers<float>{p}, out, outs, f, s);
  else
    fold<__nv_bfloat16>(op, vec, Peers<__nv_bfloat16>{p}, out, outs, f, s);
  return (int)cudaGetLastError();
}

extern "C" int ring_gather(const void* x, void* out, const void* groups, int ngroups,
                           int g, long long block_n, int dtype, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gr = static_cast<const int*>(groups);
  if (dtype == 0)
    gather<float>(vec, Dense<float>{static_cast<const float*>(x), block_n}, out, All{}, gr,
                  ngroups, g, block_n, s);
  else
    gather<__nv_bfloat16>(
        vec, Dense<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(x), block_n}, out,
        All{}, gr, ngroups, g, block_n, s);
  return (int)cudaGetLastError();
}

extern "C" int ring_gather_ptrs(const void* ptrs, void* out, const void* groups,
                                int ngroups, int g, long long block_n, int first,
                                int count, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long* p = static_cast<const unsigned long long*>(ptrs);
  const int* gr = static_cast<const int*>(groups);
  const Span outs{first, count};
  if (dtype == 0)
    gather<float>(vec, Peers<float>{p}, out, outs, gr, ngroups, g, block_n, s);
  else
    gather<__nv_bfloat16>(vec, Peers<__nv_bfloat16>{p}, out, outs, gr, ngroups, g, block_n,
                          s);
  return (int)cudaGetLastError();
}
