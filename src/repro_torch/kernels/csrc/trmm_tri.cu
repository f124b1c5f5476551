// Batched triangular matrix-matrix product  C[b] = tril(L[b]) @ X[b]
// (kernel B2).
//
// repro_trmm_* replaces the Pallas TPU kernel src/repro/kernels/trmm.py
// (trmm / _trmm_kernel): the It-Inv-TRSM solve step X_i = Dt_i @ B_i,
// with Dt_i the inverted lower-triangular diagonal block.  The
// block-masked product (B4) and the ordered product (ops.gemm) stay on
// trmm.cu's tiles.
//
// What bounds it on the H100: bytes.  At the main path's shape (L 4096 x
// 4096, X 4096 x 16, bf16) it does 2 * n^2/2 * k = 2.7e8 flops on 16 MiB
// of the triangle: 16 flops per byte, far below the ~295 at which the
// bf16 tensor cores (or the ~20 at which the fp32 CUDA cores) would be
// the limit, so the least time is the triangle's read at 3.35 TB/s.
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
// Resources (nvcc -Xptxas -v for sm_90a, the log build.py writes beside
// the library): registers per thread, 16-byte / element loads, bf16 80 /
// 128, fp32 105 / 107, fp64 128 / 128 (capped at 128 by the launch
// bounds, no spills); 96 KiB of dynamic shared memory for bf16 (3 stages
// x 8 warps x 4 KiB) and 102 KiB for fp32 and fp64 (L rows padded by 16
// bytes), so two 256-thread CTAs fit on an SM.  chip_probes/b2_stages.py
// times rings of 2 to 6 stages with one or two CTAs per SM (PERF.md
// Sec. 6): deeper rings buy nothing once 8 warps x 2 steps are in flight.
//
// Not done: X is still read once per strip (from L2: as many bytes as
// L's at k = 16), where the two strips of a pair could share the X tiles
// of their common k-steps; no TMA or wgmma (at 16 flops per byte
// mma.sync and cp.async suffice); no persistent CTAs.
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
cudaError_t launch(const T* L, int64_t l_sb, const T* X, int64_t x_sb,
                   T* C, int64_t batch, int n, int k, cudaStream_t stream) {
  constexpr int kSmem = Layout<T>::kSmem;
  // the opt-in above 48 KiB, once per device
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(opted >> dev & 1ull)) {
    err = cudaFuncSetAttribute(trmm_tri_kernel<T, kAligned>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    opted |= 1ull << dev;
  }
  const int64_t strips = (n + kStrip - 1) / kStrip;
  const dim3 grid((unsigned)((strips + 1) / 2),
                  (unsigned)((k + kStrip - 1) / kStrip), (unsigned)batch);
  trmm_tri_kernel<T, kAligned><<<grid, kWarps * 32, kSmem, stream>>>(
      L, l_sb, X, x_sb, C, n, k);
  return cudaGetLastError();
}

template <typename T>
int trmm(const void* L, long long l_sb, const void* X, long long x_sb,
         void* C, long long batch, int n, int k, void* stream) {
  if (n < 1 || k < 1 || batch < 1 || batch > 65535 ||
      (k + kStrip - 1) / kStrip > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int64_t es = sizeof(T);
  const bool aligned =
      reinterpret_cast<uintptr_t>(L) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(X) % 16 == 0 && n * es % 16 == 0 &&
      k * es % 16 == 0 && l_sb * es % 16 == 0 && x_sb * es % 16 == 0;
  const T* l = static_cast<const T*>(L);
  const T* x = static_cast<const T*>(X);
  T* c = static_cast<T*>(C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(aligned ? launch<T, true>(l, l_sb, x, x_sb, c, batch, n, k, s)
                       : launch<T, false>(l, l_sb, x, x_sb, c, batch, n, k,
                                          s));
}

}  // namespace

#define REPRO_TRMM(SUFFIX, T)                                              \
  extern "C" int repro_trmm_##SUFFIX(const void* L, long long l_sb,       \
                                     const void* X, long long x_sb,       \
                                     void* C, long long batch, int n,     \
                                     int k, void* stream) {               \
    return trmm<T>(L, l_sb, X, x_sb, C, batch, n, k, stream);             \
  }

REPRO_TRMM(f32, float)
REPRO_TRMM(bf16, __nv_bfloat16)
REPRO_TRMM(f64, double)
