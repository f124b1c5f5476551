// The ordered product (ops.gemm): C[z] = op(A[z]) @ X[z], op(A) = A, or
// tril(A) with lower, for A (batch, M, K) with unit column stride and
// free row and batch strides (a block column of a resident stack passes
// in place) and X (batch, K, N) contiguous; fp32, bf16 and fp64, partial
// sums in fp32 (fp64 for fp64), the result rounded once to T.  The
// triangular products have kernels of their own in trmm_tri.cu: the
// unmasked trmm (B2) and the block-masked trmm (B4).
//
// It replaces no TPU kernel; it is there for its summation order.  The
// trailing updates and the refinement residual of a width-1 capacity
// bank, and every product of a bank over p > 1 ranks
// (SolveSpec.fixed_order), must give an element the same bits whatever
// the operand's shape: the padding contract (an order-d factor padded
// into an order-n bank solves as the unpadded one, bit for bit), "scan"
// = "vmap" and overlap on = off rest on it.  cuBLAS picks its kernel,
// and with it the order of its sums, by shape.
//
// The order.  The contraction is cut into chunks of a fixed depth KC (a
// constant of this source: 512 for fp32 and bf16, 256 for fp64; never
// chosen from the shape), starting at k = 0 of the operand.  Within a
// chunk an element is an ascending chain of IEEE FMAs from +0; the chunk
// partials are then added in ascending chunk order, p0 + p1 + ....  So
// an element's bits depend on its row of A, its column of X and K only:
// not on M, b, N, the strides, the row tile it falls in, the load path,
// the column tile width, or on lower against explicit zeros above the
// diagonal (a zero product leaves a chain started at +0 unchanged, so
// chunks and k-steps past an element's diagonal or past K, skipped or
// zero-filled, add nothing; X is taken finite).
//
// What bounds it on the H100: bytes.  At the residual, tril(A) @ X at
// (1, 8192^2) x 16 fp32, it does 2 * 8192^2 / 2 * 16 = 1.07 GFLOP on the
// triangle's 134 MB: 8 flops a byte, under the ~20 at which the fp32 CUDA
// cores would be the limit, so the least time is the triangle's read at
// 3.35 TB/s, 0.040 ms (0.016 ms of FMAs at 67 TFLOP/s).
//
// What the design does about it:
// - Work units.  A unit is (a 128-row tile of A, all columns of a
//   16-wide (N <= 16) or 32-wide column tile of X, one chunk), one CTA.
//   With lower only the units at or below the diagonal exist.  Units
//   that run a whole chunk come first, chunk by chunk, then those cut by
//   the diagonal or by K: the heaviest first, so the triangle's tail is
//   short.  blockIdx.x decodes to its unit with a loop over the chunks,
//   so a launch computes and copies nothing on the host.
// - X's chunk read once a unit: every row of the tile shares it, 8x less
//   X traffic than one 16-row strip's.
// - Register tiles.  A thread owns 4 rows x 4 columns; a warp 8 (16-wide)
//   or 4 (32-wide) row groups x 4 or 8 column groups.  Per 16 bytes of an
//   A row read from shared memory (one LDS.128, four lanes sharing it) a
//   thread does 4 x kVec x 4 FMAs; X's rows are read as 16-byte pieces
//   that 8 or 4 lanes share.  A rows are padded by 16 bytes, so the eight
//   row groups of a load fall in eight different bank groups.
// - A ring of 16-byte cp.async (zero-filled past M, K or the unit's last
//   column, so nothing out of range is read), one barrier a k-step, each
//   copy asking L2 to fetch the 256 bytes around it (a unit reads 128
//   bytes of each of its rows a k-step, and the next 128 a step later).
//   BK is one 128-byte row of A: 32 fp32, 64 bf16, 16 fp64.  3 stages
//   for a dense A (3 CTAs an SM); 2 for a lower A, so 5 CTAs fit an SM
//   and the residual's 544 units (64 row tiles, 16 chunks) run in one
//   wave instead of a full wave and a third.  A view that is not 16-byte
//   aligned (a base, a row or batch stride, N * sizeof(T) for X) fills
//   the same tiles element by element (cp.async of 4 or 8 bytes for fp32
//   and fp64, plain loads for bf16): the same sums.
// - bf16 stays bf16 in shared memory and is widened in registers.  The
//   products are IEEE FMAs on the CUDA cores: no TF32, no tensor cores
//   (fixed_order specs compute in their storage type).
// - The chunk sums.  Where K > KC each unit writes its partials (in the
//   accumulator type) to a workspace, and a second small launch adds
//   them in chunk order and rounds once; where K <= KC the unit rounds
//   and writes C itself.  Nothing is set on the host between calls (no
//   memset, no counter), so a captured CUDA graph can replay it.
// - Workspace: ceil(K / KC) * batch * M * N accumulators where K > KC,
//   from torch's allocator (trmm.gemm_workspace_bytes, with trmm.GEMM_KC
//   = this source's KC): 8 MiB at the residual, 2 MiB at a trailing
//   update (4096 x 4096) @ (4096, 16).
//
// - The host's share: the C entry makes the device current itself and
//   takes the raw stream, so the wrapper does no device switch of its
//   own (a p > 1 sweep makes thousands of small products).
//
// Resources (nvcc -Xptxas -v, the log build.py writes beside the
// library; repro_gemm_info_* reports them through the runtime): 60 KiB
// of dynamic shared memory for a dense 16-wide tile (3 x (128 x 144 +
// 2048) bytes), 40 KiB for a lower one, 66 and 44 KiB for 32-wide ones;
// 128 and 256 threads; no spills.  chip_probes/gemm_tiles.py times the
// tile's rows, the ring's depths, the row bytes a k-step and the L2
// prefetch, each copy held bit for bit against this one (PERF.md
// Sec. 6); chip_probes/gemm_parent.py times the tri_gemm.cuh tiles this
// replaces.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;           // rows of a unit
constexpr int kTM = 4;             // rows a thread owns
// the cp.async ring's depth: 3 for a dense A; 2 for a lower one, so 5
// CTAs fit an SM and the residual's 544 units run in one wave
// (chip_probes/gemm_tiles.py times both on every case)
constexpr int kStagesDense = 3;
constexpr int kStagesLower = 2;
constexpr int kRowBytes = 128;     // one A row of a k-step: BK * sizeof(T)
constexpr int kFoldThreads = 256;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

// KC, the chunk depth: a constant per type, never chosen from the shape
// (kernels/trmm.py's GEMM_KC holds the same numbers)
template <typename T> struct Chunk { static constexpr int kKC = 512; };
template <> struct Chunk<double> { static constexpr int kKC = 256; };

template <typename T, int NT, int S>
struct Tile {
  using Elem = T;
  using AccT = typename Acc<T>::type;
  static constexpr int kEs = sizeof(T);
  static constexpr int kBK = kRowBytes / kEs;          // k per k-step
  static constexpr int kVec = 16 / kEs;                // elements a chunk
  static constexpr int kKC = Chunk<T>::kKC;
  static constexpr int kColGroups = NT / 4;            // 4 columns each
  static constexpr int kRowGroups = 32 / kColGroups;
  static constexpr int kWarpRows = kRowGroups * kTM;
  static constexpr int kWarps = kBM / kWarpRows;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kAPitch = kRowBytes + 16;       // bytes
  static constexpr int kXPitch = NT * kEs;             // bytes
  static constexpr int kXChunks = kXPitch / 16;        // a row of X
  static constexpr int kXOff = kBM * kAPitch;
  static constexpr int kStageBytes = kXOff + kBK * kXPitch;
  static constexpr int kSmem = S * kStageBytes;
  static constexpr int kRowChunks = kRowBytes / 16;    // an A row's step
  static constexpr int kAChunks = kBM * kRowChunks / kThreads;
  static constexpr int kXStep = kBK * kXChunks;        // X chunks a step
  static_assert(kKC % kBK == 0, "a chunk is whole k-steps");
  static_assert(kBM * kRowBytes / 16 % kThreads == 0, "whole A chunks");
};

// The units of one (column tile, batch entry): R row tiles, Cn chunks.
// lo(c): the first row tile that meets chunk c (all with lower = 0);
// full(c): the first whose every row takes all of chunk c (R when chunk c
// is cut by K), so tiles [full(c), R) run whole chunks.
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

struct Units {
  int R, Cn, KC, K;
  bool lower;
  __host__ __device__ int lo(int c) const {
    return lower ? imin(R, c * KC / kBM) : 0;
  }
  __host__ __device__ int full(int c) const {
    if ((int64_t)(c + 1) * KC > K) return R;
    return lower ? imax(lo(c), imin(R, ((c + 1) * KC - 1 + kBM - 1) / kBM))
                 : 0;
  }
  __host__ __device__ int64_t count() const {
    int64_t n = 0;
    for (int c = 0; c < Cn; ++c) n += R - lo(c);
    return n;
  }
  // unit u -> (row tile, chunk): the whole-chunk units first, chunk by
  // chunk, then the cut ones
  __host__ __device__ void decode(int64_t u, int& tile, int& c) const {
    for (c = 0; c < Cn; ++c) {
      const int n = R - full(c);
      if (u < n) {
        tile = full(c) + (int)u;
        return;
      }
      u -= n;
    }
    for (c = 0; c < Cn; ++c) {
      const int n = full(c) - lo(c);
      if (u < n) {
        tile = lo(c) + (int)u;
        return;
      }
      u -= n;
    }
    tile = R;                      // past the last unit: none
    c = 0;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the L2 prefetch of a 16-byte copy ("" for none)
#define GEMM_L2_PREFETCH ".L2::256B"

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global" GEMM_L2_PREFETCH
               " [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int B>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One 16-byte chunk of a tile from base[off, off + n_ok) (n_ok may be <= 0
// or above kVec), the rest zero-filled: one cp.async where the operand is
// 16-byte aligned, else element by element.
template <typename T>
__device__ __forceinline__ void load_chunk(char* dst, const T* base,
                                           int64_t off, int n_ok,
                                           bool aligned) {
  constexpr int kEs = sizeof(T), kVec = 16 / kEs;
  n_ok = max(0, min(n_ok, kVec));
  if (aligned) {
    cp_async16(dst, n_ok ? base + off : base, n_ok * kEs);
  } else if constexpr (kEs >= 4) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      cp_async_elem<kEs>(dst + e * kEs, e < n_ok ? base + off + e : base,
                         e < n_ok ? kEs : 0);
  } else {
    T* d = reinterpret_cast<T*>(dst);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      d[e] = e < n_ok ? base[off + e] : __ushort_as_bfloat16(0);
  }
}

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double to_acc(double x) { return x; }

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
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

// One 16-byte piece of shared memory as kVec elements of T.
template <typename T>
__device__ __forceinline__ void lds16(const char* p, T (&v)[16 / sizeof(T)]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&t);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) v[i] = e[i];
}

// Four consecutive elements of an X row in shared memory, widened.
template <typename T, typename A>
__device__ __forceinline__ void x4(const char* p, A (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (sizeof(T) == 8) {
    const double2 t0 = *reinterpret_cast<const double2*>(p);
    const double2 t1 = *reinterpret_cast<const double2*>(p + 16);
    x[0] = t0.x; x[1] = t0.y; x[2] = t1.x; x[3] = t1.y;
  } else {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __bfloat162float(e[i]);
  }
}

// Copy k-step k0 of a unit: A rows [r0, r0 + 128) x columns [k0, k0 + BK)
// and X rows [k0, k0 + BK) x columns [c0, c0 + NT); A columns and X rows
// at or past kend, A rows at or past M and X columns at or past N
// zero-filled (not read).
template <typename Tl, typename T>
__device__ __forceinline__ void load_step(char* stage, const T* A,
                                          int64_t lda, const T* X, int M,
                                          int N, int r0, int c0, int k0,
                                          int kend, bool a16, bool x16) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int u = 0; u < Tl::kAChunks; ++u) {
    const int cc = tid + Tl::kThreads * u;
    const int row = cc / Tl::kRowChunks, ch = cc % Tl::kRowChunks;
    const int gr = r0 + row, gk = k0 + ch * Tl::kVec;
    load_chunk<T>(stage + row * Tl::kAPitch + ch * 16, A,
                  (int64_t)gr * lda + gk, gr < M ? kend - gk : 0, a16);
  }
#pragma unroll
  for (int cc = tid; cc < Tl::kXStep; cc += Tl::kThreads) {
    const int row = cc / Tl::kXChunks, ch = cc % Tl::kXChunks;
    const int gk = k0 + row, gc = c0 + ch * Tl::kVec;
    load_chunk<T>(stage + Tl::kXOff + row * Tl::kXPitch + ch * 16, X,
                  (int64_t)gk * N + gc, gk < kend ? N - gc : 0, x16);
  }
}

// One k-step of a thread's 4 x 4 tile: rows rows[i] of the stage (ri the
// rows' indices in A, for the mask), columns 4 cg .. 4 cg + 3.  With
// kMask an element of A right of its row's diagonal is taken as 0.
template <typename Tl, bool kMask>
__device__ __forceinline__ void compute_step(
    typename Tl::AccT (&acc)[kTM][4], const char* stage,
    const int (&rows)[kTM], const int (&ri)[kTM], int cg, int k0) {
  using T = typename Tl::Elem;
  using A = typename Tl::AccT;
#pragma unroll
  for (int ch = 0; ch < Tl::kBK / Tl::kVec; ++ch) {
    T a[kTM][Tl::kVec];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      lds16<T>(stage + rows[i] * Tl::kAPitch + ch * 16, a[i]);
#pragma unroll
    for (int e = 0; e < Tl::kVec; ++e) {
      const int kk = ch * Tl::kVec + e;
      A x[4];
      x4<T>(stage + Tl::kXOff + kk * Tl::kXPitch + cg * 4 * Tl::kEs, x);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        A av = to_acc(a[i][e]);
        if constexpr (kMask) av = k0 + kk <= ri[i] ? av : A(0);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma_rn(av, x[j], acc[i][j]);
      }
    }
  }
}

// Four consecutive outputs of a row: one vector store where the row and
// the address allow it.
template <typename D>
__device__ __forceinline__ void store4(D* p, const D (&v)[4], int n_ok,
                                       bool vec) {
  if (vec && n_ok >= 4) {
    if constexpr (sizeof(D) == 4) {
      *reinterpret_cast<float4*>(p) =
          make_float4(v[0], v[1], v[2], v[3]);
      return;
    } else if constexpr (sizeof(D) == 8) {
      reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
      reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n_ok) p[j] = v[j];
}

// One unit a CTA: its chunk's partials of a 128 x NT tile, into the
// workspace W[chunk][z][M][N] (accumulator type), or, where K <= KC
// (one chunk), rounded into C.
template <typename T, int NT, int S>
__global__ void __launch_bounds__(Tile<T, NT, S>::kThreads)
    ordered_gemm_kernel(const T* __restrict__ A, int64_t a_sb, int64_t lda,
                        const T* __restrict__ X, int64_t x_sb,
                        T* __restrict__ C, typename Acc<T>::type* W,
                        int M, int K, int N, bool lower, bool a16,
                        bool x16) {
  using Tl = Tile<T, NT, S>;
  using Ac = typename Acc<T>::type;
  extern __shared__ __align__(128) char smem[];

  const Units un{(M + kBM - 1) / kBM, (K + Tl::kKC - 1) / Tl::kKC, Tl::kKC,
                 K, lower};
  int tile, c;
  un.decode(blockIdx.x, tile, c);
  if (tile >= un.R) return;
  const int r0 = tile * kBM, c0 = blockIdx.y * NT;
  const int64_t z = blockIdx.z;
  const T* Az = A + z * a_sb;
  const T* Xz = X + z * x_sb;
  const int kbeg = c * Tl::kKC;
  int kend = min(kbeg + Tl::kKC, K);
  if (lower) kend = min(kend, min(r0 + kBM, M));
  const int steps = kend > kbeg ? (kend - kbeg + Tl::kBK - 1) / Tl::kBK : 0;
  const bool masked = lower && kend - 1 > r0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = lane % Tl::kColGroups, g = lane / Tl::kColGroups;
  int rows[kTM], ri[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    rows[i] = warp * Tl::kWarpRows + i * Tl::kRowGroups + g;
    ri[i] = r0 + rows[i];
  }

  Ac acc[kTM][4];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Ac(0);

  auto issue = [&](int s) {
    if (s < steps)
      load_step<Tl>(smem + (s % S) * Tl::kStageBytes, Az, lda, Xz,
                       M, N, r0, c0, kbeg + s * Tl::kBK, kend, a16, x16);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();               // step s landed; step s - 1 was read
    issue(s + S - 1);
    const char* stage = smem + (s % S) * Tl::kStageBytes;
    if (masked)
      compute_step<Tl, true>(acc, stage, rows, ri, cg,
                                kbeg + s * Tl::kBK);
    else
      compute_step<Tl, false>(acc, stage, rows, ri, cg,
                                 kbeg + s * Tl::kBK);
  }
  cp_async_wait<0>();

  const int gc = c0 + cg * 4;
  const bool vec = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (ri[i] >= M || gc >= N) continue;
    const int64_t at = (z * M + ri[i]) * (int64_t)N + gc;
    if (un.Cn == 1) {
      T v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = to_out(acc[i][j], static_cast<T*>(nullptr));
      store4<T>(C + at, v, N - gc, vec);
    } else {
      const int64_t batch = gridDim.z;
      store4<Ac>(W + c * batch * M * (int64_t)N + at, acc[i], N - gc, vec);
    }
  }
}

// The chunk sums: C[z][r][n] = round(W[0] + W[1] + ... + W[last]), in
// chunk order; with lower, row r's chunks past its diagonal (+0, or not
// written) are left out: last = min(Cn, r / KC + 1) - 1.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
    ordered_gemm_fold(const typename Acc<T>::type* __restrict__ W,
                      T* __restrict__ C, int64_t elems, int M, int N,
                      int Cn, int KC, bool lower) {
  using Ac = typename Acc<T>::type;
  const int64_t e = blockIdx.x * (int64_t)kFoldThreads + threadIdx.x;
  if (e >= elems) return;
  const int r = (int)(e / N % M);
  const int n = lower ? min(Cn, r / KC + 1) : Cn;
  Ac s = W[e];
#pragma unroll 4
  for (int c = 1; c < n; ++c) s = add_rn(s, W[c * elems + e]);
  C[e] = to_out(s, static_cast<T*>(nullptr));
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

template <typename T, int NT, int S>
cudaError_t launch(const T* A, int64_t a_sb, int64_t lda, const T* X,
                   int64_t x_sb, T* C, typename Acc<T>::type* W,
                   int64_t batch, int M, int K, int N, bool lower,
                   cudaStream_t stream) {
  using Tl = Tile<T, NT, S>;
  static unsigned long long opted = 0;
  cudaError_t err = opt_in(ordered_gemm_kernel<T, NT, S>, Tl::kSmem, opted);
  if (err != cudaSuccess) return err;
  const Units un{(M + kBM - 1) / kBM, (K + Tl::kKC - 1) / Tl::kKC, Tl::kKC,
                 K, lower};
  const int64_t units = un.count();
  const int64_t tiles = (N + NT - 1) / NT;
  if (units < 1 || units > 0x7fffffff || tiles > 65535)
    return cudaErrorInvalidValue;
  if (un.Cn > 1 && W == nullptr) return cudaErrorInvalidValue;
  constexpr int64_t es = sizeof(T);
  const bool a16 = reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   lda * es % 16 == 0 && a_sb * es % 16 == 0;
  const bool x16 = reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   N * es % 16 == 0 && x_sb * es % 16 == 0;
  const dim3 grid((unsigned)units, (unsigned)tiles, (unsigned)batch);
  ordered_gemm_kernel<T, NT, S><<<grid, Tl::kThreads, Tl::kSmem, stream>>>(
      A, a_sb, lda, X, x_sb, C, W, M, K, N, lower, a16, x16);
  err = cudaGetLastError();
  if (err != cudaSuccess || un.Cn == 1) return err;
  const int64_t elems = batch * M * (int64_t)N;
  const int64_t blocks = (elems + kFoldThreads - 1) / kFoldThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ordered_gemm_fold<T><<<(unsigned)blocks, kFoldThreads, 0, stream>>>(
      W, C, elems, M, N, un.Cn, Tl::kKC, lower);
  return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_nt(const T* A, int64_t a_sb, int64_t lda, const T* X,
                      int64_t x_sb, T* C, typename Acc<T>::type* W,
                      int64_t batch, int M, int K, int N, bool lower,
                      cudaStream_t s) {
  return lower ? launch<T, NT, kStagesLower>(A, a_sb, lda, X, x_sb, C, W,
                                             batch, M, K, N, true, s)
               : launch<T, NT, kStagesDense>(A, a_sb, lda, X, x_sb, C, W,
                                             batch, M, K, N, false, s);
}

// The launches run on ``device`` (made current for them, then the
// caller's restored) and ``stream``.
template <typename T>
int gemm(const void* A, long long a_sb, long long lda, const void* X,
         long long x_sb, void* C, void* W, long long batch, int M, int K,
         int N, int lower, int device, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  const T* x = static_cast<const T*>(X);
  T* c = static_cast<T*>(C);
  auto* w = static_cast<typename Acc<T>::type*>(W);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = N <= 16 ? launch_nt<T, 16>(a, a_sb, lda, x, x_sb, c, w, batch, M, K,
                                   N, lower != 0, s)
                : launch_nt<T, 32>(a, a_sb, lda, x, x_sb, c, w, batch, M, K,
                                   N, lower != 0, s);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// The kernel of one column tile width (wide: 32, else 16) for a dense or
// a lower A: out[0..4] registers per thread, resident CTAs per SM (CUDA's
// occupancy calculator), threads per CTA, shared bytes per CTA, spilled
// (local) bytes per thread; out[5..9] KC, the tile's rows and columns, BK
// and the ring's stages.
template <typename T, int NT, int S>
int info(int* out) {
  using Tl = Tile<T, NT, S>;
  static unsigned long long opted = 0;
  const auto fn = ordered_gemm_kernel<T, NT, S>;
  cudaError_t err = opt_in(fn, Tl::kSmem, opted);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      Tl::kThreads, Tl::kSmem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = per_sm;
  out[2] = Tl::kThreads;
  out[3] = (int)a.sharedSizeBytes + Tl::kSmem;
  out[4] = (int)a.localSizeBytes;
  out[5] = Tl::kKC;
  out[6] = kBM;
  out[7] = NT;
  out[8] = Tl::kBK;
  out[9] = S;
  return 0;
}

}  // namespace

#define REPRO_GEMM(SUFFIX, T)                                              \
  extern "C" int repro_gemm_##SUFFIX(                                      \
      const void* A, long long a_sb, long long lda, const void* X,        \
      long long x_sb, void* C, void* W, long long batch, int M, int K,    \
      int N, int lower, int device, void* stream) {                       \
    return gemm<T>(A, a_sb, lda, X, x_sb, C, W, batch, M, K, N, lower,    \
                   device, stream);                                        \
  }                                                                        \
  extern "C" int repro_gemm_info_##SUFFIX(int wide, int lower, int* out) { \
    if (lower)                                                             \
      return wide ? info<T, 32, kStagesLower>(out)                         \
                  : info<T, 16, kStagesLower>(out);                        \
    return wide ? info<T, 32, kStagesDense>(out)                           \
                : info<T, 16, kStagesDense>(out);                          \
  }

REPRO_GEMM(f32, float)
REPRO_GEMM(bf16, __nv_bfloat16)
REPRO_GEMM(f64, double)
