// Batched triangular matrix-matrix products  C[b] = tril(L[b]) @ X[b]:
// the unmasked product (kernel B2) and the block-masked one (B4).
//
// repro_trmm_* replaces the Pallas TPU kernel src/repro/kernels/trmm.py
// (trmm / _trmm_kernel): the It-Inv-TRSM solve step X_i = Dt_i @ B_i,
// with Dt_i the inverted lower-triangular diagonal block.
// repro_trmm_masked_* replaces _trmm_masked_kernel of the same file: the
// product with an (n/bt, n/bt) int32 block mask shared by the batch, on
// the device, every block whose entry is 0 skipped and never read.  It
// forms the refinement residual tril(L_hi) @ X of a structured factor,
// with the structure's mask at bt = n0.  The ordered product (ops.gemm)
// stays on trmm.cu's tiles.
//
// What bounds them on the H100: bytes.  At B2's main path shape (L 4096 x
// 4096, X 4096 x 16, bf16) it does 2 * n^2/2 * k = 2.7e8 flops on 16 MiB
// of the triangle: 16 flops per byte, far below the ~295 at which the
// bf16 tensor cores (or the ~20 at which the fp32 CUDA cores) would be
// the limit, so the least time is the triangle's read at 3.35 TB/s.  B4
// reads only the kept blocks: at its main path's shape (L 8192 x 8192
// fp32 under banded:1024 at bt = 512: 29 full blocks and 16 diagonal
// triangles, about 40 MB) the least time is those bytes at 3.35 TB/s,
// 0.0119 ms.
//
// What the design does about it:
// - Balanced over the triangle.  The output is 16-row strips by
//   16-column tiles.  One CTA takes the pair of strips (i, T-1-i), T =
//   ceil(n / 16), so every CTA reads the same number of L tiles: at n =
//   4096 that is 128 CTAs for one matrix, about one per SM.  The grid is
//   (pairs, column tiles, batch); the pair and the strips come from
//   blockIdx, so a launch computes and copies nothing on the host.
// - k split across the CTA's 8 warps without atomics.  Warp w takes the
//   BK-deep k-steps whose absolute index j is w mod 8 (BK = 128 bytes of
//   an L row: 64 bf16, 32 fp32, 16 fp64), of both strips, and
//   accumulates its partial in registers; the partials are summed in
//   shared memory in warp order 0..7.  Each output's sum order then
//   depends on its row and the k-steps only, never on n, the batch, the
//   pairing or the load path: the leading rows of a larger triangle come
//   out bit-equal to a smaller one's, and a padded slot's to the
//   unpadded slot's.
// - Pipelined 16-byte loads.  Each warp streams its own L tiles (16 x BK)
//   and X tiles (BK x 16) through a ring of 3 stages of shared memory
//   with cp.async (zero-filled where a chunk is out of range, so nothing
//   out of range is read), waiting with cp.async.wait_group and
//   __syncwarp: no CTA barrier until the reduction, and loads overlap
//   the math.  Where the operands are not 16-byte aligned (a base
//   pointer, a row or batch stride, k * sizeof(T)), an instantiation of
//   the same kernel fills the same shared-memory tiles with element
//   loads: the same sums in the same order.
// - The triangle, never read above the diagonal tile.  A strip's k-steps
//   stop at its diagonal 16 x 16 block, L chunks right of it are not
//   loaded, and inside it the elements with c > r are zeroed in
//   registers by select (a bit mask), so NaN there never reaches C.
// - bf16 on tensor cores: mma.sync.m16n8k16 (fp32 sums), two n-tiles per
//   16 columns, A from shared memory by ldmatrix and X by ldmatrix.trans,
//   both tiles XOR-swizzled so the ldmatrix phases are conflict-free; the
//   result is rounded once to bf16 (as the reference's
//   preferred_element_type=float32).  fp32 and fp64 stay on IEEE FMAs
//   (no TF32): a lane owns one row of the strip and every other 16-byte
//   chunk of k, each L element read from shared memory feeds 16 FMAs, X
//   rows are warp broadcasts, and the two halves of the warp are added
//   once at the end.
// - Any n >= 1, any k >= 1 (k > 16 by column tiles), batch <= 65535;
//   ragged rows and columns are zero-filled on load and not stored.
//
// B4 is the same kernel over the kept blocks (trmm_masked_kernel, its
// own __global__, so B2's code is untouched):
// - A strip walks only its kept k-steps.  Each warp finds its next 32
//   candidate k-steps (j = w mod 8) at once, one lane each reading the
//   strip's mask entry on the device, and a ballot; the ring then issues
//   only the kept ones, in B2's order.  Kept blocks need not be
//   contiguous: the 8x8 block-sparse mask's last block row walks columns
//   0, 6 and 7.  Where bt is a multiple of BK (and so of 16) a strip lies
//   in one block row and a k-step in one block column, so a skipped
//   k-step is never issued and a kept one is copied whole; otherwise
//   (bt = 4, or bt = 32 in bf16) a k-step is kept when any of the blocks
//   it meets is, and an instantiation with element loads fills each L
//   element outside the mask with 0 without reading it.
// - Its bits are B2's rule: an output depends on its row and its kept
//   k-steps only, never on n, the batch, the pairing, the load path or
//   other block rows' entries; a mask keeping every lower block gives
//   B2's bits.
// - Balance: the pairs (i, T-1-i) balance a dense triangle, and a band
//   nearly so; where the pairs make fewer CTAs than the card has SMs
//   (kPairCtas), one strip per CTA, the last first, fills it better.
//
// Resources (nvcc -Xptxas -v for sm_90a, the log build.py writes beside
// the library): registers per thread, 16-byte / element loads, bf16 80 /
// 128, fp32 105 / 107, fp64 128 / 128 (capped at 128 by the launch
// bounds, no spills); 96 KiB of dynamic shared memory for bf16 (3 stages
// x 8 warps x 4 KiB) and 102 KiB for fp32 and fp64 (L rows padded by 16
// bytes), so two 256-thread CTAs fit on an SM.  chip_probes/b2_stages.py
// times rings of 2 to 6 stages with one or two CTAs per SM (PERF.md
// Sec. 6): deeper rings buy nothing once 8 warps x 2 steps are in flight.
// B4's kernel, 16-byte / element / gated loads: bf16 80 / 128 / 125,
// fp32 112 / 115 / 109, fp64 128 / 128 / 128 registers, no spills, the
// same shared memory, two CTAs per SM (repro_trmm_masked_info_*
// reports the same through the runtime).  On an "NVIDIA H100 80GB HBM3, 700.00 W"
// (chip_smoke.py phase 2) it takes 0.033 ms at 8192^2 x 16 fp32 under
// banded:1024 at bt = 512, 36% of its 0.0119 ms bound; B2's fp32 path
// reaches about as much of its own (PERF.md Sec. 6).
//
// Not done: X is still read once per strip (from L2: as many bytes as
// L's at k = 16), where the two strips of a pair could share the X tiles
// of their common k-steps, or, in B4, the neighbouring strips of a block
// row all of theirs; no TMA or wgmma (at 16 flops per byte mma.sync and
// cp.async suffice); no persistent CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kStages = 3;
constexpr int kRowBytes = 128;        // one L row of a k-step: BK * sizeof(T)
constexpr int kStrip = 16;            // rows of a strip, columns of a tile

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

template <typename T>
struct Layout {
  static constexpr int kEs = sizeof(T);
  static constexpr bool kMma = sizeof(T) == 2;     // bf16 on tensor cores
  static constexpr int kBK = kRowBytes / kEs;      // k per k-step
  static constexpr int kVec = 16 / kEs;            // elements per chunk
  static constexpr int kXChunks = kStrip * kEs / 16;  // chunks per X row
  // L rows padded by one chunk for the FMA path (conflict-free LDS.128)
  static constexpr int kLPitch = kMma ? kRowBytes : kRowBytes + 16;
  static constexpr int kXPitch = kStrip * kEs;
  static constexpr int kXOff = kStrip * kLPitch;
  static constexpr int kStageBytes = kXOff + kBK * kXPitch;
  static constexpr int kPartBytes =
      2 * kWarps * kStrip * kStrip * (int)sizeof(typename Acc<T>::type);
  static constexpr int kSmem = kWarps * kStages * kStageBytes > kPartBytes
                                   ? kWarps * kStages * kStageBytes
                                   : kPartBytes;
  static_assert(kStrip * 8 == 32 * 4 && kBK * kXChunks == 32 * 4,
                "each lane copies 4 L chunks and 4 X chunks per k-step");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T zero() { return T(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// One 16-byte chunk of a tile: cp.async (zero-filled when not valid), or
// element by element, each element out of range read as 0.
template <typename T, bool kAligned>
__device__ __forceinline__ void load_chunk(char* dst, const T* base,
                                           int64_t off, int n_ok) {
  constexpr int kVec = Layout<T>::kVec;
  if constexpr (kAligned) {
    const bool valid = n_ok >= kVec;
    cp_async16(dst, valid ? base + off : base, valid);
  } else {
    T* d = reinterpret_cast<T*>(dst);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      d[e] = e < n_ok ? base[off + e] : zero<T>();
  }
}

// Copy k-step j of strip s: L rows [16 s, 16 s + 16) x columns
// [j BK, j BK + BK) and X rows [j BK, j BK + BK) x columns [c0, c0 + 16),
// every column of L and row of X at or past kend = min(n, 16 s + 16)
// zero-filled (not read).
template <typename T, bool kAligned>
__device__ __forceinline__ void load_step(char* stage, const T* L,
                                          const T* X, int n, int k, int s,
                                          int j, int c0, int lane) {
  using Ly = Layout<T>;
  const int r0 = s * kStrip, k0 = j * Ly::kBK;
  const int kend = min(n, r0 + kStrip);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int cc = lane + 32 * u;
    const int row = cc >> 3, ch = cc & 7;
    const int gr = r0 + row, gc = k0 + ch * Ly::kVec;
    const int sw = Ly::kMma ? (ch ^ (row & 7)) : ch;
    load_chunk<T, kAligned>(stage + row * Ly::kLPitch + sw * 16, L,
                            (int64_t)gr * n + gc,
                            gr < n ? kend - gc : 0);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int cc = lane + 32 * u;
    const int row = cc / Ly::kXChunks, ch = cc % Ly::kXChunks;
    const int gk = k0 + row, gc = c0 + ch * Ly::kVec;
    const int sw = Ly::kMma ? (ch ^ ((row >> 2) & 1)) : ch;
    load_chunk<T, kAligned>(stage + Ly::kXOff + row * Ly::kXPitch + sw * 16,
                            X, (int64_t)gk * k + gc,
                            gk < kend ? k - gc : 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: the 16-deep sub-steps of one k-step on the tensor cores.  acc
// holds n-tile 0 (columns 0-7) in [0, 4) and n-tile 1 in [4, 8), in the
// m16n8 accumulator layout.
__device__ __forceinline__ void compute_mma(float (&acc)[8],
                                            const char* stage, int r0,
                                            int k0, int lane) {
  using Ly = Layout<__nv_bfloat16>;
  const int nsub = min(Ly::kBK / 16, (r0 - k0) / 16 + 1);
  const int g = lane >> 2, tig = lane & 3;
  // the diagonal block's a0 and a3 keep column 2 tig (+1) when <= g
  const uint32_t diag_mask = (2 * tig <= g ? 0x0000ffffu : 0u) |
                             (2 * tig + 1 <= g ? 0xffff0000u : 0u);
#pragma unroll
  for (int t = 0; t < Ly::kBK / 16; ++t) {
    if (t >= nsub) break;
    uint32_t a[4], b[4];
    const int ar = lane & 15, ach = 2 * t + (lane >> 4);
    ldmatrix_x4(a, stage + ar * Ly::kLPitch + ((ach ^ (ar & 7)) * 16));
    const int xr = 16 * t + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int xch = lane >> 4;
    ldmatrix_x4_trans(b, stage + Ly::kXOff + xr * Ly::kXPitch +
                             ((xch ^ ((xr >> 2) & 1)) * 16));
    if (k0 + 16 * t == r0) {         // the diagonal block: tril by select
      a[0] &= diag_mask;
      a[2] = 0u;
      a[3] &= diag_mask;
    }
    mma_bf16(acc, a, b[0], b[1]);
    mma_bf16(acc + 4, a, b[2], b[3]);
  }
}

__device__ __forceinline__ void load16(const char* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load16(const char* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// fp32 / fp64: lane (r = lane % 16, h = lane / 16) runs row r of the
// strip over the chunks h, h + 2, ... of each 16-deep sub-step, 16
// columns per L element.
template <typename T>
__device__ __forceinline__ void compute_fma(T (&acc)[kStrip],
                                            const char* stage, int r0,
                                            int k0, int lane) {
  using Ly = Layout<T>;
  constexpr int kSub = 16 / Ly::kVec;               // chunks per sub-step
  const int nsub = min(Ly::kBK / 16, (r0 - k0) / 16 + 1);
  const int r = lane & 15, h = lane >> 4;
  const char* Lrow = stage + r * Ly::kLPitch;
#pragma unroll
  for (int t = 0; t < Ly::kBK / 16; ++t) {
    if (t >= nsub) break;
    const bool diag = k0 + 16 * t == r0;
#pragma unroll
    for (int c2 = 0; c2 < kSub / 2; ++c2) {
      const int ch = 2 * c2 + h;                    // chunk in the sub-step
      T lv[Ly::kVec];
      load16(Lrow + (t * kSub + ch) * 16, lv);
#pragma unroll
      for (int e = 0; e < Ly::kVec; ++e) {
        const int kk = ch * Ly::kVec + e;           // column in the block
        const T a = diag && kk > r ? T(0) : lv[e];
        const char* xrow = stage + Ly::kXOff + (16 * t + kk) * Ly::kXPitch;
#pragma unroll
        for (int v = 0; v < kStrip / Ly::kVec; ++v) {
          T xv[Ly::kVec];
          load16(xrow + v * 16, xv);
#pragma unroll
          for (int c = 0; c < Ly::kVec; ++c)
            acc[v * Ly::kVec + c] = fma_rn(a, xv[c], acc[v * Ly::kVec + c]);
        }
      }
    }
  }
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ float to_out(float x, float*) { return x; }
__device__ __forceinline__ double to_out(double x, double*) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// The end of a CTA of B2 or B4, once every warp has drained its ring:
// each warp puts its partials of strip q at part[q][warp] in shared
// memory (an fp32 / fp64 lane's row added once from its two halves
// first), then each thread sums one output of each strip in warp order
// 0..7 and stores it.
template <typename T, typename A, int kAccN>
__device__ __forceinline__ void store_sums(char* smem, const A (&acc0)[kAccN],
                                           const A (&acc1)[kAccN], int nq,
                                           int s0, int s1, int c0, T* Cz,
                                           int n, int k) {
  using Ly = Layout<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // partials part[q][warp][row][col]
  A* part = reinterpret_cast<A*>(smem);
  auto put = [&](const A (&acc)[kAccN], int q) {
    A* P = part + (q * kWarps + warp) * kStrip * kStrip;
    if constexpr (Ly::kMma) {
      const int g = lane >> 2, tig = lane & 3;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          P[g * kStrip + nt * 8 + 2 * tig + e] = acc[nt * 4 + e];
          P[(g + 8) * kStrip + nt * 8 + 2 * tig + e] = acc[nt * 4 + 2 + e];
        }
    } else {
      // row r's two halves, added once: chunks h = 0 plus chunks h = 1
#pragma unroll
      for (int c = 0; c < kStrip; ++c) {
        const A other = __shfl_xor_sync(0xffffffffu, acc[c], 16);
        if (lane < 16) P[lane * kStrip + c] = add_rn(acc[c], other);
      }
    }
  };
  put(acc0, 0);
  put(acc1, 1);
  __syncthreads();

  // warp order 0..7, one output per thread per strip
  const int row = threadIdx.x / kStrip, col = threadIdx.x % kStrip;
  for (int q = 0; q < nq; ++q) {
    const A* P = part + q * kWarps * kStrip * kStrip + row * kStrip + col;
    A sum = P[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      sum = add_rn(sum, P[w * kStrip * kStrip]);
    const int gr = (q ? s1 : s0) * kStrip + row, gc = c0 + col;
    if (gr < n && gc < k)
      Cz[(int64_t)gr * k + gc] = to_out(sum, static_cast<T*>(nullptr));
  }
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kWarps * 32, 2)
    trmm_tri_kernel(const T* __restrict__ L, int64_t l_sb,
                    const T* __restrict__ X, int64_t x_sb,
                    T* __restrict__ C, int n, int k) {
  using Ly = Layout<T>;
  using A = typename Acc<T>::type;
  constexpr int kAccN = Ly::kMma ? 8 : kStrip;
  extern __shared__ __align__(128) char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strips = (n + kStrip - 1) / kStrip;
  const int s0 = blockIdx.x, s1 = strips - 1 - blockIdx.x;
  const int nq = s1 > s0 ? 2 : 1;
  const int c0 = blockIdx.y * kStrip;
  const int64_t z = blockIdx.z;
  const T* Lz = L + z * l_sb;
  const T* Xz = X + z * x_sb;
  T* Cz = C + z * (int64_t)n * k;

  // this warp's k-steps j = warp, warp + 8, ... of strip s0, then of s1
  auto steps = [&](int s) {
    const int ks = (s * kStrip + kStrip + Ly::kBK - 1) / Ly::kBK;
    return ks > warp ? (ks - warp + kWarps - 1) / kWarps : 0;
  };
  const int cnt0 = steps(s0), total = cnt0 + (nq == 2 ? steps(s1) : 0);
  char* ring = smem + warp * kStages * Ly::kStageBytes;
  auto issue = [&](int it) {
    if (it < total) {
      const bool q = it >= cnt0;
      load_step<T, kAligned>(ring + (it % kStages) * Ly::kStageBytes, Lz,
                             Xz, n, k, q ? s1 : s0,
                             warp + (q ? it - cnt0 : it) * kWarps, c0, lane);
    }
    cp_async_commit();
  };

  A acc0[kAccN], acc1[kAccN];
#pragma unroll
  for (int i = 0; i < kAccN; ++i) acc0[i] = acc1[i] = A(0);

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                 // step it landed; step it - 1 was read
    issue(it + kStages - 1);
    const char* stage = ring + (it % kStages) * Ly::kStageBytes;
    const bool q = it >= cnt0;
    const int s = q ? s1 : s0;
    const int k0 = (warp + (q ? it - cnt0 : it) * kWarps) * Ly::kBK;
    if constexpr (Ly::kMma) {
      if (q) compute_mma(acc1, stage, s * kStrip, k0, lane);
      else compute_mma(acc0, stage, s * kStrip, k0, lane);
    } else {
      if (q) compute_fma<T>(acc1, stage, s * kStrip, k0, lane);
      else compute_fma<T>(acc0, stage, s * kStrip, k0, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                // every warp is done with its ring
  store_sums<T>(smem, acc0, acc1, nq, s0, s1, c0, Cz, n, k);
}

// ----------------------------------------------------------------------
// B4: the block-masked product

// A CTA of B4 takes the pair of strips (i, T-1-i), as B2, where the pairs
// make at least kPairCtas CTAs, else one strip, the last first: fewer
// pairs than SMs leave SMs idle (chip_probes/b4_parent.py times both
// and an order ranked by the mask on the device, PERF.md Sec. 6).
constexpr int kPairCtas = 132;
constexpr int kStepBits = 30;     // a step's code: strip q << 30 | j

// Whether k-step j of strip s meets a kept lower block of the (nb, nb)
// mask.  Without kGate (bt a multiple of BK) the strip lies in one block
// row and the step in one block column; with it, every pair of the
// strip's block rows and the step's block columns is looked at.
template <typename T, bool kGate>
__device__ __forceinline__ bool step_kept(const int* mask, int bt, int nb,
                                          int n, int s, int j) {
  const int r0 = s * kStrip, k0 = j * Layout<T>::kBK;
  if constexpr (!kGate) {
    return __ldg(mask + (r0 / bt) * nb + k0 / bt) != 0;
  } else {
    const int kend = min(n, r0 + kStrip);
    const int i_hi = (kend - 1) / bt;
    const int j_hi = (min(kend, k0 + Layout<T>::kBK) - 1) / bt;
    for (int i = r0 / bt; i <= i_hi; ++i)
      for (int jb = k0 / bt; jb <= min(j_hi, i); ++jb)
        if (__ldg(mask + i * nb + jb)) return true;
    return false;
  }
}

// load_step<T, false> with every L element outside the block mask read as
// 0 and never loaded (bt not a multiple of BK: a strip or a k-step may
// span several blocks).
template <typename T>
__device__ __forceinline__ void load_step_gated(
    char* stage, const T* L, const T* X, int n, int k, int s, int j, int c0,
    int lane, const int* mask, int bt, int nb) {
  using Ly = Layout<T>;
  const int r0 = s * kStrip, k0 = j * Ly::kBK;
  const int kend = min(n, r0 + kStrip);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int cc = lane + 32 * u;
    const int row = cc >> 3, ch = cc & 7;
    const int gr = r0 + row, gc = k0 + ch * Ly::kVec;
    const int sw = Ly::kMma ? (ch ^ (row & 7)) : ch;
    T* d = reinterpret_cast<T*>(stage + row * Ly::kLPitch + sw * 16);
    const int* mrow = mask + (gr < n ? gr / bt : 0) * nb;
#pragma unroll
    for (int e = 0; e < Ly::kVec; ++e)
      d[e] = gr < n && gc + e < kend && __ldg(mrow + (gc + e) / bt)
                 ? L[(int64_t)gr * n + gc + e]
                 : zero<T>();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int cc = lane + 32 * u;
    const int row = cc / Ly::kXChunks, ch = cc % Ly::kXChunks;
    const int gk = k0 + row, gc = c0 + ch * Ly::kVec;
    const int sw = Ly::kMma ? (ch ^ ((row >> 2) & 1)) : ch;
    load_chunk<T, false>(stage + Ly::kXOff + row * Ly::kXPitch + sw * 16, X,
                         (int64_t)gk * k + gc, gk < kend ? k - gc : 0);
  }
}

// B2's kernel over the kept blocks only: a warp walks the k-steps j = w
// mod 8 of its strips that meet a kept block, in B2's order, found 32 at
// a time by a ballot over the mask.
template <typename T, bool kAligned, bool kGate>
__global__ void __launch_bounds__(kWarps * 32, 2)
    trmm_masked_kernel(const T* __restrict__ L, int64_t l_sb,
                       const T* __restrict__ X, int64_t x_sb,
                       T* __restrict__ C, int n, int k,
                       const int* __restrict__ mask, int bt, bool paired) {
  using Ly = Layout<T>;
  using A = typename Acc<T>::type;
  constexpr int kAccN = Ly::kMma ? 8 : kStrip;
  extern __shared__ __align__(128) char smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strips = (n + kStrip - 1) / kStrip, nb = n / bt;
  int s0, s1 = -1;
  if (paired) {
    s0 = blockIdx.x;
    s1 = strips - 1 - blockIdx.x;
  } else {
    s0 = strips - 1 - blockIdx.x;
  }
  const int nq = s1 > s0 ? 2 : 1;
  const int c0 = blockIdx.y * kStrip;
  const int64_t z = blockIdx.z;
  const T* Lz = L + z * l_sb;
  const T* Xz = X + z * x_sb;
  T* Cz = C + z * (int64_t)n * k;

  // k-steps of strip q: those starting left of its diagonal block's end
  auto ks = [&](int q) {
    return ((q ? s1 : s0) * kStrip + kStrip + Ly::kBK - 1) / Ly::kBK;
  };
  // the next kept k-step of this warp as strip q << kStepBits | j, or -1:
  // round r of strip q looks at j = warp + 8 (32 r + lane), one per lane
  int wq = 0, wbase = -kWarps * 32;
  unsigned wbits = 0;
  auto next = [&]() -> int {
    while (wbits == 0) {
      wbase += kWarps * 32;
      if (warp + wbase >= ks(wq)) {
        if (wq + 1 >= nq) return -1;
        wq = 1;
        wbase = 0;
      }
      const int j = warp + wbase + kWarps * lane;
      wbits = __ballot_sync(0xffffffffu,
                            j < ks(wq) && step_kept<T, kGate>(
                                              mask, bt, nb, n,
                                              wq ? s1 : s0, j));
    }
    const int b = __ffs(wbits) - 1;
    wbits &= wbits - 1;
    return (wq << kStepBits) | (warp + wbase + kWarps * b);
  };
  char* ring = smem + warp * kStages * Ly::kStageBytes;
  auto issue = [&](int code, int slot) {
    if (code >= 0) {
      const int s = code >> kStepBits ? s1 : s0;
      const int j = code & ((1 << kStepBits) - 1);
      char* stage = ring + slot * Ly::kStageBytes;
      if constexpr (kGate)
        load_step_gated<T>(stage, Lz, Xz, n, k, s, j, c0, lane, mask, bt,
                           nb);
      else
        load_step<T, kAligned>(stage, Lz, Xz, n, k, s, j, c0, lane);
    }
    cp_async_commit();
  };

  A acc0[kAccN], acc1[kAccN];
#pragma unroll
  for (int i = 0; i < kAccN; ++i) acc0[i] = acc1[i] = A(0);

  // code[t]: the step issued t steps ahead of the one computed
  int code[kStages];
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    code[t] = next();
    issue(code[t], t);
  }
  for (int it = 0; code[0] >= 0; ++it) {
    cp_async_wait<kStages - 2>();
    __syncwarp();                 // step it landed; step it - 1 was read
    code[kStages - 1] = next();
    issue(code[kStages - 1], (it + kStages - 1) % kStages);
    const char* stage = ring + (it % kStages) * Ly::kStageBytes;
    const bool q = code[0] >> kStepBits;
    const int r0 = (q ? s1 : s0) * kStrip;
    const int k0 = (code[0] & ((1 << kStepBits) - 1)) * Ly::kBK;
    if constexpr (Ly::kMma) {
      if (q) compute_mma(acc1, stage, r0, k0, lane);
      else compute_mma(acc0, stage, r0, k0, lane);
    } else {
      if (q) compute_fma<T>(acc1, stage, r0, k0, lane);
      else compute_fma<T>(acc0, stage, r0, k0, lane);
    }
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) code[t] = code[t + 1];
  }
  cp_async_wait<0>();
  __syncthreads();                // every warp is done with its ring
  store_sums<T>(smem, acc0, acc1, nq, s0, s1, c0, Cz, n, k);
}

// The dynamic shared memory above 48 KiB is opted into once per device
// and kernel.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, unsigned long long& opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(opted >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    opted |= 1ull << dev;
  }
  return cudaSuccess;
}

template <typename T, bool kAligned>
cudaError_t launch(const T* L, int64_t l_sb, const T* X, int64_t x_sb,
                   T* C, int64_t batch, int n, int k, cudaStream_t stream) {
  constexpr int kSmem = Layout<T>::kSmem;
  static unsigned long long opted = 0;
  cudaError_t err = opt_in(trmm_tri_kernel<T, kAligned>, kSmem, opted);
  if (err != cudaSuccess) return err;
  const int64_t strips = (n + kStrip - 1) / kStrip;
  const dim3 grid((unsigned)((strips + 1) / 2),
                  (unsigned)((k + kStrip - 1) / kStrip), (unsigned)batch);
  trmm_tri_kernel<T, kAligned><<<grid, kWarps * 32, kSmem, stream>>>(
      L, l_sb, X, x_sb, C, n, k);
  return cudaGetLastError();
}

template <typename T, bool kAligned, bool kGate>
cudaError_t launch_masked(const T* L, int64_t l_sb, const T* X,
                          int64_t x_sb, T* C, int64_t batch, int n, int k,
                          const int* mask, int bt, cudaStream_t stream) {
  constexpr int kSmem = Layout<T>::kSmem;
  static unsigned long long opted = 0;
  cudaError_t err =
      opt_in(trmm_masked_kernel<T, kAligned, kGate>, kSmem, opted);
  if (err != cudaSuccess) return err;
  const int64_t strips = (n + kStrip - 1) / kStrip;
  const int64_t tiles = (k + kStrip - 1) / kStrip;
  const bool paired = (strips + 1) / 2 * tiles * batch >= kPairCtas;
  const dim3 grid((unsigned)(paired ? (strips + 1) / 2 : strips),
                  (unsigned)tiles, (unsigned)batch);
  trmm_masked_kernel<T, kAligned, kGate>
      <<<grid, kWarps * 32, kSmem, stream>>>(L, l_sb, X, x_sb, C, n, k,
                                             mask, bt, paired);
  return cudaGetLastError();
}

// Whether the 16-byte path takes these operands: base pointers, rows,
// batch strides and X's rows all 16-byte aligned.
template <typename T>
bool aligned16(const void* L, long long l_sb, const void* X, long long x_sb,
               int n, int k) {
  constexpr int64_t es = sizeof(T);
  return reinterpret_cast<uintptr_t>(L) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(X) % 16 == 0 && n * es % 16 == 0 &&
         k * es % 16 == 0 && l_sb * es % 16 == 0 && x_sb * es % 16 == 0;
}

bool bad_shape(long long batch, int n, int k) {
  return n < 1 || k < 1 || batch < 1 || batch > 65535 ||
         (k + kStrip - 1) / kStrip > 65535;
}

template <typename T>
int trmm(const void* L, long long l_sb, const void* X, long long x_sb,
         void* C, long long batch, int n, int k, void* stream) {
  if (bad_shape(batch, n, k)) return (int)cudaErrorInvalidValue;
  const T* l = static_cast<const T*>(L);
  const T* x = static_cast<const T*>(X);
  T* c = static_cast<T*>(C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(aligned16<T>(L, l_sb, X, x_sb, n, k)
                   ? launch<T, true>(l, l_sb, x, x_sb, c, batch, n, k, s)
                   : launch<T, false>(l, l_sb, x, x_sb, c, batch, n, k, s));
}

template <typename T>
int trmm_masked(const void* L, long long l_sb, const void* X, long long x_sb,
                void* C, long long batch, int n, int k, const void* mask,
                int bt, void* stream) {
  if (bad_shape(batch, n, k) || mask == nullptr || bt < 1 || n % bt)
    return (int)cudaErrorInvalidValue;
  const T* l = static_cast<const T*>(L);
  const T* x = static_cast<const T*>(X);
  T* c = static_cast<T*>(C);
  const int* m = static_cast<const int*>(mask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bt % Layout<T>::kBK)
    return (int)launch_masked<T, false, true>(l, l_sb, x, x_sb, c, batch, n,
                                              k, m, bt, s);
  return (int)(aligned16<T>(L, l_sb, X, x_sb, n, k)
                   ? launch_masked<T, true, false>(l, l_sb, x, x_sb, c,
                                                   batch, n, k, m, bt, s)
                   : launch_masked<T, false, false>(l, l_sb, x, x_sb, c,
                                                    batch, n, k, m, bt, s));
}

// B4's kernel on one path (0 the 16-byte copies, 1 element loads, 2 the
// element gate): registers per thread, resident CTAs per SM (CUDA's
// occupancy calculator), threads per CTA, shared bytes per CTA and
// spilled (local) bytes per thread.
template <typename T, bool kAligned, bool kGate>
int masked_info(int* out) {
  constexpr int kSmem = Layout<T>::kSmem;
  static unsigned long long opted = 0;
  const auto fn = trmm_masked_kernel<T, kAligned, kGate>;
  cudaError_t err = opt_in(fn, kSmem, opted);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kWarps * 32, kSmem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = per_sm;
  out[2] = kWarps * 32;
  out[3] = (int)a.sharedSizeBytes + kSmem;
  out[4] = (int)a.localSizeBytes;
  return 0;
}

template <typename T>
int masked_info(int path, int* out) {
  return path == 0   ? masked_info<T, true, false>(out)
         : path == 1 ? masked_info<T, false, false>(out)
                     : masked_info<T, false, true>(out);
}

}  // namespace

#define REPRO_TRMM(SUFFIX, T)                                              \
  extern "C" int repro_trmm_##SUFFIX(const void* L, long long l_sb,       \
                                     const void* X, long long x_sb,       \
                                     void* C, long long batch, int n,     \
                                     int k, void* stream) {               \
    return trmm<T>(L, l_sb, X, x_sb, C, batch, n, k, stream);             \
  }                                                                        \
  extern "C" int repro_trmm_masked_##SUFFIX(                               \
      const void* L, long long l_sb, const void* X, long long x_sb,       \
      void* C, long long batch, int n, int k, const void* mask, int bt,   \
      void* stream) {                                                      \
    return trmm_masked<T>(L, l_sb, X, x_sb, C, batch, n, k, mask, bt,     \
                          stream);                                         \
  }                                                                        \
  extern "C" int repro_trmm_masked_info_##SUFFIX(int path, int* out) {     \
    return masked_info<T>(path, out);                                      \
  }

REPRO_TRMM(f32, float)
REPRO_TRMM(bf16, __nv_bfloat16)
REPRO_TRMM(f64, double)
