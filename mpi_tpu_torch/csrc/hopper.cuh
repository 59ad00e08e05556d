// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// bf16 warpgroup products (wgmma) and their shared-memory descriptors,
// the fences around them, cp.async staging with zero fill, the hi/lo
// operand splits, and split TF32 warp products (mma.sync) for float32
// inputs.
// Inline PTX only, so a kernel that includes this header builds with nvcc
// alone (no include path).
//
// bf16 tiles in shared memory use the 128-byte swizzle that wgmma reads: a
// [rows x D] tile (rows a multiple of 8) is stored as D/64 column blocks of
// rows x 128 bytes, each column block 1024-byte aligned, and the 16-byte
// chunk c of row r lies at chunk c ^ (r % 8) of that row.  One layout
// serves both readings of a tile:
//   K-major (the tile is [M or N][K], K contiguous): start address at
//     (row 0, k), advanced 32 bytes per 16-wide k step inside a column
//     block; stride between 8-row groups (SBO) 1024 bytes;
//   MN-major (the tile is [K][N], N contiguous, read with the transpose
//     bit): start address at (k row, n0), advanced 2048 bytes per 16-row k
//     step; SBO 1024 bytes between 8-row groups of K, LBO rows x 128 bytes
//     between 64-wide column blocks of N.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte aligned address at or after p (swizzle atoms need it)
__device__ __forceinline__ uint8_t* align1024(void* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// byte offset of element (row, col) of a swizzled [rows x D] bf16 tile;
// col is a multiple of 8 (one 16-byte chunk)
__device__ __forceinline__ uint32_t sw128_offset(int row, int col, int rows) {
  return (col >> 6) * rows * 128 + row * 128 + ((((col >> 3) & 7) ^ (row & 7)) << 4);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major tile: LBO is not read under a swizzle
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) { return desc_sw128(addr, 16, 1024); }
// MN-major tile of `rows` K rows
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, int rows) {
  return desc_sw128(addr, rows * 128, 1024);
}

// -- ordering around wgmma ----------------------------------------------------
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// at most N committed groups still pending (groups complete in order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of the generic proxy (cp.async) become visible to
// wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins registers that an asynchronous wgmma writes: no use of them moves
// above the wait, and no write below the fence
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// -- bf16 warpgroup products, float32 accumulators ---------------------------
// Accumulator of m64nN: thread t of the warpgroup holds d[4j + 2i + c] =
// D[16 (t / 32) + (t % 32) / 4 + 8 i][8 j + 2 (t % 4) + c].

// D[64 x 64] += A[64 x 16] B[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (four bf16x2 per
// thread, the accumulator layout of k columns 16kk..16kk+15: see
// acc_to_frag), B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- operand splits ------------------------------------------------------------
// (x, y) -> hi = (bf16_rn(x), bf16_rn(y)), lo = bf16_rn of what hi leaves:
// hi + lo is within 2^-16 |x| of x
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Accumulator columns 16kk..16kk+15 of an m64nN product (N >= 16kk + 16)
// as the A operand of the next product (k = those columns), split hi/lo.
template <int R>
__device__ __forceinline__ void acc_to_frag(const float (&acc)[R], int kk, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_bf16x2(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1], hi[e], lo[e]);
}

// x -> (hi, lo) for TF32 products: hi = x truncated to TF32 (one mask),
// lo = x - hi (exact) as float32 bits.  The tensor core reads the 19 high
// bits of a TF32 register, so lo enters truncated as well: hi + lo as read
// is within 2^-20 |x| of x.  The split takes one integer and one float32
// operation and none of the conversion unit, where cvt.rna.tf32.f32 runs
// (16 results a clock per SM, an eighth of the float32 add rate): every
// operand of every product is split.
struct Tf32x2 { uint32_t hi, lo; };
__device__ __forceinline__ Tf32x2 split(float x) {
  Tf32x2 s;
  s.hi = __float_as_uint(x) & 0xFFFFE000u;
  s.lo = __float_as_uint(x - __uint_as_float(s.hi));
  return s;
}

// -- TF32 warp products (float32 inputs) -----------------------------------------
// m16n8k8: g = lane / 4, t = lane % 4; A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); B b0 (k = t, n = g), b1 (t + 4, g); C c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the same with a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// c += a b as three TF32 products, a_lo b_hi + a_hi b_hi + a_hi b_lo (the
// dropped a_lo b_lo is below 2^-20 |a b|).  The tensor core's float32 sums
// round toward zero, so over a long chain of products its accumulator
// drifts: the products go to two fresh partials on the tensor core (two
// independent chains, so the next product need not wait for the last),
// which are then added to c by round-to-nearest float32 adds.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const Tf32x2 (&a)[4], Tf32x2 b0, Tf32x2 b1) {
  const uint32_t ah[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  const uint32_t al[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
  float p[4], r[4];
  mma_tf32_zero(p, al, b0.hi, b1.hi);
  mma_tf32_zero(r, ah, b0.lo, b1.lo);
  mma_tf32(p, ah, b0.hi, b1.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += p[e] + r[e];
}

// -- cp.async staging --------------------------------------------------------------
// 16 bytes from global to shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace hopper
