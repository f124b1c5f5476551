// Batched inversion of lower-triangular blocks by bottom-up doubling
// (kernels B1 and B5).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/tri_inv_block.py:
// _tri_inv_kernel (:63, B1, repro_tri_inv_leaf_* and repro_tri_inv_level_*)
// and _tri_inv_valid_kernel (:67, B5, the _valid_ entries): phase 1 of
// It-Inv-TRSM, the paper's Diagonal-Inverter, run once per factor at
// admission, refresh or padded admission.
//
// What bounds it on the H100: operations.  A block of order n0 needs
// about n0^3/3 flops on n0^2 words, so at the main path's n0 = 4096 the
// work is ~1,400 flops per byte read: the least time is the flops over
// the IEEE fp32 rate of the CUDA cores, 67 TFLOP/s.  Every preset
// inverts in fp32 (the accumulate dtype), and fp32 means IEEE fp32: no
// TF32, no tensor cores.
//
// The split follows the doubling recursion.  One fp32 block of order
// 4096 is 64 MiB against 227 KB of shared memory per CTA, so
//   * tri_inv_leaf_kernel inverts each S x S diagonal sub-block (S <= 64,
//     32 for fp64) wholly in shared memory: reciprocal of the diagonal,
//     then the doubling levels 1 .. S/2, one CTA per sub-block (about 2%
//     of the flops at n0 = 4096);
//   * every level s >= S is two batched triangular products launched by
//     the Python wrapper through repro_tri_inv_level_*: T = L21 @
//     tril(A11^-1), rounded to the operand dtype as the TPU kernel
//     rounds t, then N21 = -(tril(A22^-1) @ T), written in place into
//     the output.  Level s costs n0 s^2 flops, so the top level holds 3/4
//     of the work and the top two 15/16.
//
// What the level product does about the fp32 rate (each choice measured
// by chip_probes/b1_levels.py, PERF.md):
// - Register tiles.  A CTA of 256 threads computes 128 x 128 outputs,
//   8 x 8 per thread (fp64: 128 x 64, 8 x 4); the next k's fragments
//   load while this k's FMAs run, and 4 16-byte shared loads feed 64
//   FMAs (16 loads fed 16 FMAs in the generic tile it replaces).  An
//   H100 SM's 128 FMA lanes then need 128 bytes of shared memory a
//   clock, all it delivers, so loads and FMAs share the limit: the top
//   level runs at 60% of 67 TFLOP/s with two CTAs per SM, 52% with one.
//   A 16 x 8 thread tile needs ~250 registers, hence 4-warp CTAs, and
//   measured slower.  Where 128 x 128
//   tiles would give fewer CTAs than the card has SMs (kMinCtas), a level
//   takes 128 x 64 tiles of 128 threads, then 64 x 64 tiles of 256
//   threads with 4 x 4 outputs each (the short, latency-bound low levels
//   and small n0).
// - A pipeline.  A ring of kStages k-steps in dynamic shared memory,
//   each a 64-byte slice of BM rows of A and the 64-byte-deep rows of B,
//   filled by 16-byte cp.async copies kStages - 1 steps ahead of the
//   FMAs.  A is needed k-major: each step's slice is transposed in shared
//   memory into one of two k-major buffers (at the accumulator type, so
//   bf16 is widened once) one step before the FMAs read it, one CTA
//   barrier per step.  The ring's A rows are padded by 16 bytes, so the
//   transpose's reads and every fragment load are free of bank conflicts.
//   Every operand row the schedule addresses is 16-byte aligned (offsets
//   and ld are multiples of s >= 32 elements; the wrapper hands over a
//   16-byte aligned L).
// - Balance over the triangle.  The k-bounds are at tile granularity:
//   in T = L21 @ tril(A11^-1) column tile j runs k over [j BN, s), in
//   N21 = tril(A22^-1) @ T row tile i over [0, (i + 1) BM).  Where the
//   level has kPairCtas tiles or more (the tail of the triangle would
//   show), one CTA takes the pair (u, nt - 1 - u) along the triangle, so
//   every CTA runs nt + 1 tiles' k-steps and the ring runs on from the
//   first tile into the second; below that, one tile per CTA, longest
//   first.  The 1-D grid is ordered (matrix, pair, other tile): a gated
//   matrix's CTAs, which return at once, come as one run, so the valid
//   ones spread over the SMs instead of doubling up on some.
// - One summation order.  Each output is one FMA chain over k ascending
//   from zero, with no split-K, atomics or cross-warp sums: the order of
//   the leaf and of the generic tile this replaces (tri_gemm.cuh), so
//   the inverse is theirs bit for bit whatever tile a level takes.  The
//   triangular operands' upper triangles are not masked but read: the
//   leaf writes them as zeros before any level runs, and a zero term
//   leaves a chain's value as it is (the generic tile masked them to
//   the same zeros).
// - The leaf is the parent's; its zeros go out in 16-byte stores.
//
// Partial sums are fp32 (double for fp64; bf16 operands are widened on
// load, exactly) and every level rounds to the operand dtype exactly
// where the TPU kernel does.  The output is the inverse of tril(L): the
// upper triangle of the input is never read and that of the output is
// written as zeros.
//
// The GATED instantiations (B5) take an (m,) int32 mask read on the
// device.  A block flagged 0 comes out as zeros and none of its L is
// read, so no reciprocal is taken of its diagonal.  Its home is padded
// admission: a factor of order d padded to blockdiag(L, I) at order n
// has diagonal blocks that are wholly the identity tail.  A gated leaf
// CTA writes zeros over its sub-block's whole row strip [jS, jS+S) x
// [0, n0) and reads nothing; a level CTA of a gated block returns before
// its first load, so it writes neither T nor the output.  An unflagged
// block runs B1's arithmetic in B1's order: an all-ones mask gives B1's
// output bit for bit.
//
// Resources: repro_tri_inv_info_* reports each kernel's registers,
// resident CTAs per SM, threads and shared bytes (and nvcc -Xptxas -v,
// the log build.py writes beside the library).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 4;       // k-steps in the ring
constexpr int kRowBytes = 64;    // one A row of a k-step
constexpr int kAPitch = kRowBytes + 16;  // padded: conflict-free A loads
constexpr int kMinCtas = 132;    // a level's tile gives at least this many
constexpr int kPairCtas = 256;   // pair tiles from this many unpaired CTAs

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ double to_acc(double x) { return x; }

template <typename T>
__device__ __forceinline__ T from_acc(typename Acc<T>::type x);
template <>
__device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ double from_acc<double>(double x) { return x; }

// x rounded to T's precision, kept in the accumulator type
template <typename T>
__device__ __forceinline__ typename Acc<T>::type round_to(
    typename Acc<T>::type x) {
  return to_acc(from_acc<T>(x));
}

__device__ __forceinline__ float mad(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double mad(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// ------------------------------- the leaf -------------------------------

// largest leaf order: two (S, S+1) accumulator tiles stay under the
// 48 KB of static shared memory (64 for float, 32 for double)
template <typename T>
__host__ __device__ constexpr int leaf_max() {
  return sizeof(typename Acc<T>::type) == 8 ? 32 : 64;
}

constexpr int kLeafThreads = 256;

// rows x width zeros at p, row stride ld, by the CTA: 16-byte stores
// where p, width and ld allow them (every leaf of the schedule: widths
// and ld are multiples of S >= 32 elements on an aligned output), else
// element by element
template <typename T>
__device__ __forceinline__ void zero_rows(T* p, int rows, int width,
                                          int ld) {
  constexpr int kVec = 16 / sizeof(T);
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0 && width % kVec == 0 &&
      ld % kVec == 0) {
    const int chunks = width / kVec;
    for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x)
      *reinterpret_cast<uint4*>(p + (int64_t)(e / chunks) * ld +
                                (e % chunks) * kVec) = make_uint4(0, 0, 0, 0);
  } else {
    for (int e = threadIdx.x; e < rows * width; e += blockDim.x)
      p[(int64_t)(e / width) * ld + e % width] =
          from_acc<T>(typename Acc<T>::type(0));
  }
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(kLeafThreads)
    tri_inv_leaf_kernel(const T* __restrict__ L, T* __restrict__ out, int n0,
                        int S, const int* __restrict__ valid) {
  using A_t = typename Acc<T>::type;
  constexpr int kL = leaf_max<T>();
  __shared__ A_t Am[kL][kL + 1];
  __shared__ A_t Tm[kL][kL + 1];

  const int per = n0 / S;
  const int64_t b = blockIdx.x / per;
  const int j = blockIdx.x % per;
  if constexpr (GATED) {
    if (valid[b] == 0) {  // uniform across the CTA: one block
      zero_rows(out + b * n0 * n0 + (int64_t)j * S * n0, S, n0, n0);
      return;
    }
  }
  const int64_t base = b * n0 * n0 + (int64_t)j * S * n0 + (int64_t)j * S;
  const T* Lb = L + base;
  T* Ob = out + base;

  // level 0: strictly-lower entries as given, reciprocal diagonal
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int r = e / S, c = e % S;
    A_t v = A_t(0);
    if (c <= r) v = to_acc(Lb[(int64_t)r * n0 + c]);
    Am[r][c] = c < r ? v : (c == r ? round_to<T>(A_t(1) / v) : A_t(0));
  }
  __syncthreads();

  for (int s = 1; s < S; s *= 2) {
    const int per_q = s * s, total = (S / (2 * s)) * per_q;
    // t = l21 @ a11^-1 (a11^-1 lower: rows x >= c), rounded to T
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int q = e / per_q, rem = e % per_q, r = rem / s, c = rem % s;
      const int o = q * 2 * s;
      A_t acc = A_t(0);
      for (int x = c; x < s; ++x)
        acc = mad(Am[o + s + r][o + x], Am[o + x][o + c], acc);
      Tm[o + s + r][o + c] = round_to<T>(acc);
    }
    __syncthreads();
    // n21 = -(a22^-1 @ t) (a22^-1 lower: columns x <= r), over l21
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int q = e / per_q, rem = e % per_q, r = rem / s, c = rem % s;
      const int o = q * 2 * s;
      A_t acc = A_t(0);
      for (int x = 0; x <= r; ++x)
        acc = mad(Am[o + s + r][o + s + x], Tm[o + s + x][o + c], acc);
      Am[o + s + r][o + c] = round_to<T>(-acc);
    }
    __syncthreads();
  }

  // the row strip [jS, jS+S) x [jS, n0): the inverted sub-block, then
  // zeros; the strip left of the sub-block belongs to the levels >= S
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) {
    const int r = e / S, c = e % S;
    Ob[(int64_t)r * n0 + c] = from_acc<T>(Am[r][c]);
  }
  zero_rows(Ob + S, S, n0 - (j + 1) * S, n0);
}

// --------------------------- the level product ---------------------------

// A BM x BN output tile of TM x TN outputs per thread; the launch bounds
// ask for kMinBlocks resident CTAs per SM, which caps a thread at 65536 /
// (kMinBlocks * kThreads) registers.
// Shared memory: the ring of kStages raw k-steps as copied (A row-major,
// rows padded to kAPitch bytes, then B), then A of two k-steps k-major
// at the accumulator type, [kBK][BM], which the FMAs read.
template <typename T, int BM_, int BN_, int TM_, int TN_, int kMinBlocks_>
struct Tile {
  using A_t = typename Acc<T>::type;
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kEs = sizeof(T);
  static constexpr int kVec = 16 / kEs;           // elements per chunk
  static constexpr int kBK = kRowBytes / kEs;     // k per step
  // a thread's rows: kGroups runs of kAW, one vector load each
  static constexpr int kAW = TM < 16 / (int)sizeof(A_t)
                                 ? TM : 16 / (int)sizeof(A_t);
  static constexpr int kGroups = TM / kAW;
  static constexpr int kTY = BM / TM, kTX = BN / TN;
  static constexpr int kThreads = kTY * kTX;
  static constexpr int kBPitch = BN * kEs;        // bytes per B row
  static constexpr int kARowChunks = kRowBytes / 16;
  static constexpr int kAChunks = BM * kARowChunks;
  static constexpr int kBRowChunks = BN * kEs / 16;
  static constexpr int kBChunks = kBK * kBRowChunks;
  // chunks a thread copies per k-step, the last round maybe partial
  static constexpr int kAPer = (kAChunks + kThreads - 1) / kThreads;
  static constexpr int kBPer = (kBChunks + kThreads - 1) / kThreads;
  static constexpr int kBOff = BM * kAPitch;
  static constexpr int kStageBytes = kBOff + kBK * kBPitch;
  static constexpr int kATOff = kStages * kStageBytes;
  static constexpr int kATBytes = kBK * BM * (int)sizeof(A_t);
  static constexpr int kSmem = kATOff + 2 * kATBytes;
  static_assert(BM % TM == 0 && BN % TN == 0 && TN % kVec == 0 &&
                    TM % kAW == 0 && BM % kBK == 0 && BN % kBK == 0 &&
                    kStages >= 3,
                "tile shape");
};

// Per operand dtype: the large tile, the medium one and the small one.
template <typename T> struct Tiles;
template <> struct Tiles<float> {
  using Big = Tile<float, 128, 128, 8, 8, 2>;
  using Mid = Tile<float, 128, 64, 8, 8, 3>;
  using Small = Tile<float, 64, 64, 4, 4, 2>;
};
template <> struct Tiles<__nv_bfloat16> {
  using Big = Tile<__nv_bfloat16, 128, 128, 8, 8, 2>;
  using Mid = Tile<__nv_bfloat16, 128, 64, 8, 8, 3>;
  using Small = Tile<__nv_bfloat16, 64, 64, 2, 8, 2>;
};
template <> struct Tiles<double> {
  using Big = Tile<double, 128, 64, 8, 4, 1>;
  using Mid = Tile<double, 64, 64, 4, 4, 2>;
  using Small = Tile<double, 32, 32, 2, 2, 2>;
};

template <typename T>
struct LevelArgs {
  const T* a;
  int64_t lda, a_sb, a_sq;
  const T* b;
  int64_t ldb, b_sb, b_sq;
  T* c;
  int64_t ldc, c_sb, c_sq;
  int s, nq, tri_a, negate, paired;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements of T from shared memory, widened to the
// accumulator type (bf16 to fp32 is exact: the bits shifted up)
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

template <int N, typename T>
__device__ __forceinline__ void lds(const char* p,
                                    typename Acc<T>::type* v) {
  if constexpr (sizeof(T) == 4 && N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else if constexpr (sizeof(T) == 4) {
    static_assert(N == 4, "one 16-byte load");
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (sizeof(T) == 8) {
    static_assert(N == 2, "one 16-byte load");
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x);
    v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
  } else {
    static_assert(N == 8, "one 16-byte load");
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_lo(w[i]);
      v[2 * i + 1] = bf16_hi(w[i]);
    }
  }
}

// one 16-byte chunk of C from kVec accumulators, negated when asked,
// rounded once to T
__device__ __forceinline__ void stg(float* p, const float* v, bool neg) {
  *reinterpret_cast<float4*>(p) =
      neg ? make_float4(-v[0], -v[1], -v[2], -v[3])
          : make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stg(double* p, const double* v, bool neg) {
  *reinterpret_cast<double2*>(p) =
      neg ? make_double2(-v[0], -v[1]) : make_double2(v[0], v[1]);
}
__device__ __forceinline__ void stg(__nv_bfloat16* p, const float* v,
                                    bool neg) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = neg ? -v[2 * i] : v[2 * i];
    const float hi = neg ? -v[2 * i + 1] : v[2 * i + 1];
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// One output tile of the pair: its corner and its k-steps.
struct TileRun {
  int r0, c0, k0, steps;
};

// C[z] = sign * op_a(A[z]) @ op_b(B[z]), s x s operands, exactly one of
// op_a, op_b lower-triangular (tri_a or not).  Operand z sits at
// ptr + (z / nq) * sb + (z % nq) * sq with row stride ld.  The
// triangular operand's upper triangle must hold zeros (the leaf writes
// them); its tiles right of (tri_a) or above (tri_b) the diagonal are
// never loaded.
template <typename T, class Tl, bool GATED>
__global__ void __launch_bounds__(Tl::kThreads, Tl::kMinBlocks)
    tri_level_kernel(const LevelArgs<T> p, const int* __restrict__ valid) {
  using A_t = typename Acc<T>::type;
  extern __shared__ __align__(128) char smem[];
  constexpr int BM = Tl::BM, BN = Tl::BN, TM = Tl::TM, TN = Tl::TN;
  constexpr int kVec = Tl::kVec, kAW = Tl::kAW, kBK = Tl::kBK;
  constexpr int kRowStep = BM / Tl::kGroups;    // between a thread's runs

  // blockIdx.x = (z * nu + u) * no + o: matrix z, pair u of tiles
  // along the triangle, tile o along the other side
  const int nt = p.s / (p.tri_a ? BM : BN), no = p.s / (p.tri_a ? BN : BM);
  const int nu = p.paired ? (nt + 1) / 2 : nt;
  const int o = blockIdx.x % no;
  const int rest = blockIdx.x / no;
  const int u = rest % nu;
  const int64_t z = rest / nu;
  const int64_t zb = z / p.nq, zq = z % p.nq;
  if constexpr (GATED) {
    if (valid[zb] == 0) return;  // uniform across the CTA: one matrix
  }
  const T* A = p.a + zb * p.a_sb + zq * p.a_sq;
  const T* B = p.b + zb * p.b_sb + zq * p.b_sq;
  T* C = p.c + zb * p.c_sb + zq * p.c_sq;

  // rank 0 is the longest tile: the last row tile (tri_a), the first
  // column tile (tri_b)
  auto run = [&](int rank) {
    TileRun t;
    if (p.tri_a) {
      const int i = nt - 1 - rank;
      t.r0 = i * BM; t.c0 = o * BN; t.k0 = 0; t.steps = (i + 1) * BM / kBK;
    } else {
      t.r0 = o * BM; t.c0 = rank * BN; t.k0 = t.c0;
      t.steps = (p.s - t.c0) / kBK;
    }
    return t;
  };
  const TileRun t0 = run(u);
  const bool two = p.paired && nt - 1 - u != u;
  const TileRun t1 = run(two ? nt - 1 - u : u);
  const int total = t0.steps + (two ? t1.steps : 0);

  const int tid = threadIdx.x;
  const int tx = tid % Tl::kTX, ty = tid / Tl::kTX;

  // copy k-step it into its ring slot
  auto issue = [&](int it) {
    if (it < total) {
      const bool q = it >= t0.steps;
      const int r0 = q ? t1.r0 : t0.r0, c0 = q ? t1.c0 : t0.c0;
      const int k0 = (q ? t1.k0 + (it - t0.steps) * kBK : t0.k0 + it * kBK);
      char* st = smem + (it % kStages) * Tl::kStageBytes;
#pragma unroll
      for (int j = 0; j < Tl::kAPer; ++j) {
        const int c = tid + j * Tl::kThreads;
        if (Tl::kAChunks % Tl::kThreads == 0 || c < Tl::kAChunks) {
          const int row = c / Tl::kARowChunks, ch = c % Tl::kARowChunks;
          cp_async16(st + row * kAPitch + ch * 16,
                     A + (int64_t)(r0 + row) * p.lda + k0 + ch * kVec);
        }
      }
#pragma unroll
      for (int j = 0; j < Tl::kBPer; ++j) {
        const int c = tid + j * Tl::kThreads;
        if (Tl::kBChunks % Tl::kThreads == 0 || c < Tl::kBChunks) {
          const int row = c / Tl::kBRowChunks, ch = c % Tl::kBRowChunks;
          cp_async16(st + Tl::kBOff + row * Tl::kBPitch + ch * 16,
                     B + (int64_t)(k0 + row) * p.ldb + c0 + ch * kVec);
        }
      }
    }
    cp_async_commit();
  };
  // k-step it's A from its ring slot into buffer it & 1, k-major: a warp
  // reads 32 rows' chunks 80 bytes apart and writes 32 consecutive words
  auto transpose = [&](int it) {
    const char* raw = smem + (it % kStages) * Tl::kStageBytes;
    A_t* at = reinterpret_cast<A_t*>(smem + Tl::kATOff +
                                     (it & 1) * Tl::kATBytes);
#pragma unroll
    for (int j = 0; j < Tl::kAPer; ++j) {
      const int c = tid + j * Tl::kThreads;
      if (Tl::kAChunks % Tl::kThreads == 0 || c < Tl::kAChunks) {
        const int row = c % BM, ch = c / BM;
        A_t v[kVec];
        lds<kVec, T>(raw + row * kAPitch + ch * 16, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) at[(ch * kVec + e) * BM + row] = v[e];
      }
    }
  };

  A_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = A_t(0);

  // output (i, j) of the thread: row (i / kAW) * kRowStep + ty * kAW +
  // i % kAW, column (j / kVec) * kTX * kVec + tx * kVec + j % kVec
  auto store = [&](const TileRun& t) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      T* row = C + (int64_t)(t.r0 + (i / kAW) * kRowStep + ty * kAW +
                             i % kAW) * p.ldc + t.c0;
#pragma unroll
      for (int v = 0; v < TN / kVec; ++v) {
        stg(row + v * Tl::kTX * kVec + tx * kVec, &acc[i][v * kVec],
            p.negate);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[i][v * kVec + e] = A_t(0);
      }
    }
  };

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) issue(it);
  cp_async_wait<kStages - 2>();
  __syncthreads();
  transpose(0);
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 3>();
    // step it's A is k-major, step it + 1 landed; every thread is done
    // with slot it - 1 and A buffer (it + 1) & 1
    __syncthreads();
    issue(it + kStages - 1);
    if (it + 1 < total) transpose(it + 1);
    const A_t* at = reinterpret_cast<const A_t*>(smem + Tl::kATOff +
                                                 (it & 1) * Tl::kATBytes);
    const char* bs = smem + (it % kStages) * Tl::kStageBytes + Tl::kBOff;
    // k ascending; the next k's fragments load while this k's FMAs run
    A_t a[2][TM], b[2][TN];
    auto frag = [&](int k, A_t (&af)[TM], A_t (&bf)[TN]) {
#pragma unroll
      for (int g = 0; g < Tl::kGroups; ++g)
        lds<kAW, A_t>(reinterpret_cast<const char*>(
                          at + k * BM + g * kRowStep + ty * kAW),
                      &af[g * kAW]);
      const char* brow = bs + k * Tl::kBPitch + tx * 16;
#pragma unroll
      for (int v = 0; v < TN / kVec; ++v)
        lds<kVec, T>(brow + v * Tl::kTX * 16, &bf[v * kVec]);
    };
    frag(0, a[0], b[0]);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k + 1 < kBK) frag(k + 1, a[(k + 1) & 1], b[(k + 1) & 1]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = mad(a[k & 1][i], b[k & 1][j], acc[i][j]);
    }
    if (it == t0.steps - 1) store(t0);
    else if (it == total - 1) store(t1);
  }
  cp_async_wait<0>();
}

// ------------------------------- launches -------------------------------

// the opt-in above 48 KiB of dynamic shared memory, once per device
template <typename T, class Tl, bool GATED>
cudaError_t opt_in() {
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(opted >> dev & 1ull)) {
    err = cudaFuncSetAttribute(tri_level_kernel<T, Tl, GATED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tl::kSmem);
    if (err != cudaSuccess) return err;
    opted |= 1ull << dev;
  }
  return cudaSuccess;
}

// Output tiles of one level product on Tl's tiles; 0 where they do not
// fit
template <class Tl>
int64_t tiles(int s, int64_t batch) {
  if (s < Tl::BM || s < Tl::BN) return 0;
  return (int64_t)(s / Tl::BM) * (s / Tl::BN) * batch;
}

// Whether a level product on Tl's tiles pairs them: where unpaired CTAs
// would fill the card (kPairCtas), a pair evens out the triangle's tail;
// below, unpaired tiles, longest first, end sooner.
template <class Tl>
bool paired(int s, int64_t batch, bool tri_a) {
  return tiles<Tl>(s, batch) >= kPairCtas &&
         s / (tri_a ? Tl::BM : Tl::BN) > 1;
}

// CTAs of one level product on Tl's tiles; 0 where the tile does not fit
template <class Tl>
int64_t ctas(int s, int64_t batch, bool tri_a) {
  const int64_t n = tiles<Tl>(s, batch);
  if (!paired<Tl>(s, batch, tri_a)) return n;
  const int nt = s / (tri_a ? Tl::BM : Tl::BN);
  return n / nt * ((nt + 1) / 2);
}

template <typename T, class Tl, bool GATED>
cudaError_t launch_level(LevelArgs<T> p, int64_t batch, const int* valid,
                         cudaStream_t stream) {
  p.paired = paired<Tl>(p.s, batch, p.tri_a);
  const int64_t n = ctas<Tl>(p.s, batch, p.tri_a);
  if (n < 1 || n > 2147483647LL) return cudaErrorInvalidConfiguration;
  cudaError_t err = opt_in<T, Tl, GATED>();
  if (err != cudaSuccess) return err;
  tri_level_kernel<T, Tl, GATED>
      <<<(unsigned)n, Tl::kThreads, Tl::kSmem, stream>>>(p, valid);
  return cudaGetLastError();
}

template <typename T, bool GATED>
int leaf(const void* L, void* out, long long m, int n0, int S,
         const void* valid, void* stream) {
  if (S < 1 || S > leaf_max<T>() || n0 % S || m < 1)
    return (int)cudaErrorInvalidValue;
  if (GATED && valid == nullptr) return (int)cudaErrorInvalidValue;
  const long long blocks = m * (n0 / S);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  tri_inv_leaf_kernel<T, GATED><<<(unsigned)blocks, kLeafThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<T*>(out), n0, S,
      static_cast<const int*>(valid));
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr, long long ld, long long sb, long long sq,
               int es) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && ld * es % 16 == 0 &&
         sb * es % 16 == 0 && sq * es % 16 == 0;
}

template <typename T, bool GATED>
int level(const void* a, long long lda, long long a_sb, long long a_sq,
          const void* b, long long ldb, long long b_sb, long long b_sq,
          void* c, long long ldc, long long c_sb, long long c_sq, int s,
          int nq, long long batch, int tri_a, int tri_b, int negate,
          const void* valid, void* stream) {
  using Tl = Tiles<T>;
  constexpr int es = sizeof(T);
  if (s < Tl::Small::BM || (s & (s - 1)) || nq < 1 || batch < 1 ||
      batch > 2147483647LL || (tri_a != 0) == (tri_b != 0))
    return (int)cudaErrorInvalidValue;
  if (GATED && valid == nullptr) return (int)cudaErrorInvalidValue;
  if (!aligned16(a, lda, a_sb, a_sq, es) ||
      !aligned16(b, ldb, b_sb, b_sq, es) || !aligned16(c, ldc, c_sb, c_sq, es))
    return (int)cudaErrorMisalignedAddress;
  LevelArgs<T> p;
  p.a = static_cast<const T*>(a);
  p.lda = lda; p.a_sb = a_sb; p.a_sq = a_sq;
  p.b = static_cast<const T*>(b);
  p.ldb = ldb; p.b_sb = b_sb; p.b_sq = b_sq;
  p.c = static_cast<T*>(c);
  p.ldc = ldc; p.c_sb = c_sb; p.c_sq = c_sq;
  p.s = s; p.nq = nq; p.tri_a = tri_a != 0; p.negate = negate != 0;
  const int* v = static_cast<const int*>(valid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ta = p.tri_a;
  if (ctas<typename Tl::Big>(s, batch, ta) >= kMinCtas)
    return (int)launch_level<T, typename Tl::Big, GATED>(p, batch, v, st);
  if (ctas<typename Tl::Mid>(s, batch, ta) >= kMinCtas)
    return (int)launch_level<T, typename Tl::Mid, GATED>(p, batch, v, st);
  return (int)launch_level<T, typename Tl::Small, GATED>(p, batch, v, st);
}

// out: registers per thread, resident CTAs per SM, threads per CTA,
// shared bytes per CTA (static + dynamic), local (spill) bytes per
// thread, and the tile's rows and columns (the leaf: its largest S)
template <typename T, class Tl, bool GATED>
int level_info(int* out) {
  const void* fn = (const void*)tri_level_kernel<T, Tl, GATED>;
  cudaError_t e = opt_in<T, Tl, GATED>();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, Tl::kThreads,
                                                    Tl::kSmem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs; out[1] = per_sm; out[2] = Tl::kThreads;
  out[3] = (int)a.sharedSizeBytes + Tl::kSmem; out[4] = (int)a.localSizeBytes;
  out[5] = Tl::BM; out[6] = Tl::BN;
  return 0;
}

template <typename T, bool GATED>
int leaf_info(int* out) {
  const void* fn = (const void*)tri_inv_leaf_kernel<T, GATED>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kLeafThreads,
                                                    0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs; out[1] = per_sm; out[2] = kLeafThreads;
  out[3] = (int)a.sharedSizeBytes; out[4] = (int)a.localSizeBytes;
  out[5] = out[6] = leaf_max<T>();
  return 0;
}

template <typename T, bool GATED>
int info(int which, int* out) {
  using Tl = Tiles<T>;
  switch (which) {
    case 0: return leaf_info<T, GATED>(out);
    case 1: return level_info<T, typename Tl::Big, GATED>(out);
    case 2: return level_info<T, typename Tl::Mid, GATED>(out);
    case 3: return level_info<T, typename Tl::Small, GATED>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// repro_tri_inv_leaf_*: the leaf over a contiguous (m, n0, n0) stack.
// repro_tri_inv_level_*: one batched level product (exactly one of tri_a,
// tri_b), every operand row and stride 16-byte aligned.  The _valid
// entries (B5) also take a contiguous (m,) int32 mask on the device; in
// a level, batch entry z reads flag z / nq.  repro_tri_inv_info_* fills
// out[7] for the leaf (which = 0) or the large, medium or small level
// tile (1, 2, 3), as level_info() above.
#define REPRO_TRI_INV(SUFFIX, T)                                            \
  extern "C" int repro_tri_inv_leaf_##SUFFIX(const void* L, void* out,     \
                                             long long m, int n0, int S,   \
                                             void* stream) {               \
    return leaf<T, false>(L, out, m, n0, S, nullptr, stream);              \
  }                                                                        \
  extern "C" int repro_tri_inv_level_##SUFFIX(                             \
      const void* a, long long lda, long long a_sb, long long a_sq,       \
      const void* b, long long ldb, long long b_sb, long long b_sq,       \
      void* c, long long ldc, long long c_sb, long long c_sq, int s,      \
      int nq, long long batch, int tri_a, int tri_b, int negate,          \
      void* stream) {                                                      \
    return level<T, false>(a, lda, a_sb, a_sq, b, ldb, b_sb, b_sq, c, ldc, \
                           c_sb, c_sq, s, nq, batch, tri_a, tri_b, negate, \
                           nullptr, stream);                               \
  }                                                                        \
  extern "C" int repro_tri_inv_leaf_valid_##SUFFIX(                        \
      const void* L, void* out, long long m, int n0, int S,               \
      const void* valid, void* stream) {                                   \
    return leaf<T, true>(L, out, m, n0, S, valid, stream);                 \
  }                                                                        \
  extern "C" int repro_tri_inv_level_valid_##SUFFIX(                       \
      const void* a, long long lda, long long a_sb, long long a_sq,       \
      const void* b, long long ldb, long long b_sb, long long b_sq,       \
      void* c, long long ldc, long long c_sb, long long c_sq, int s,      \
      int nq, long long batch, int tri_a, int tri_b, int negate,          \
      const void* valid, void* stream) {                                   \
    return level<T, true>(a, lda, a_sb, a_sq, b, ldb, b_sb, b_sq, c, ldc,  \
                          c_sb, c_sq, s, nq, batch, tri_a, tri_b, negate,  \
                          valid, stream);                                  \
  }                                                                        \
  extern "C" int repro_tri_inv_info_##SUFFIX(int gated, int which,         \
                                             int* out) {                   \
    return gated ? info<T, true>(which, out) : info<T, false>(which, out); \
  }

REPRO_TRI_INV(f32, float)
REPRO_TRI_INV(bf16, __nv_bfloat16)
REPRO_TRI_INV(f64, double)
