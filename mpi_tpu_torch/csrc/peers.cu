// Peer memory for SPMD worlds that span processes: one staging buffer a
// process, exported to the other processes of the world over CUDA IPC.
//
// Used by mpi_tpu_torch/gpu/peers.py.  The reference's multi-host runtime
// (mpi_tpu/tpu/multihost.py) lets XLA move data between hosts; here each
// process copies its ranks' rows into its staging buffer and the others
// read them in place: the tiers in torch through a tensor over the mapped
// pointer, the ring kernel (csrc/ring.cu ring_fold_ptrs) through a table of
// per-rank pointers.  With peer access enabled, the same calls map another
// card's memory over NVLink.
//
// The buffer comes from cudaMalloc, not from PyTorch's caching allocator:
// an IPC handle names a whole allocation, and a caching-allocator block is
// a piece of a larger segment (expandable segments cannot be exported at
// all).  cudaIpcOpenMemHandle refuses a handle of its own process, so a
// process reads its own ranks from its own memory.  No kernel is defined
// here.  Every function returns the cudaError_t of its call.

#include <cuda_runtime.h>
#include <stdio.h>
#include <string.h>

extern "C" int peers_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

extern "C" int peers_alloc(void** ptr, long long bytes) {
  return (int)cudaMalloc(ptr, (size_t)bytes);
}

extern "C" int peers_free(void* ptr) { return (int)cudaFree(ptr); }

// handle: sizeof(cudaIpcMemHandle_t) bytes, filled for the allocation at ptr.
extern "C" int peers_export(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)err;
}

extern "C" int peers_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int peers_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// The name and text of a CUDA error, into buf (len bytes, NUL-terminated).
extern "C" int peers_error(int err, char* buf, int len) {
  const cudaError_t e = static_cast<cudaError_t>(err);
  snprintf(buf, (size_t)len, "%s: %s", cudaGetErrorName(e), cudaGetErrorString(e));
  return 0;
}
