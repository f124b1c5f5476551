// Batched inversion of lower-triangular blocks by bottom-up doubling.
//
// Replaces the Pallas TPU kernel src/repro/kernels/tri_inv_block.py
// (tri_inv_blocks / _tri_inv_kernel / _doubling_inverse): phase 1 of
// It-Inv-TRSM, the paper's Diagonal-Inverter, run once per factor at
// admission.
//
// What bounds it on the H100: operations.  A block of order n0 needs
// about n0^3/3 flops on n0^2 words, so at the main path's n0 = 4096 the
// work is ~1,400 flops per byte read: far past the card's balance
// point, the least time is the flops over the fp32 rate (67 TFLOP/s).
//
// What the design does about it: the TPU kernel keeps a whole block in
// VMEM, but one fp32 block of order 4096 is 64 MiB against 227 KB of
// shared memory per block.  So the inversion is split by level:
//   * tri_inv_leaf_kernel inverts each S x S diagonal sub-block (S <= 64,
//     32 for fp64) wholly in shared memory: reciprocal of the diagonal,
//     then the doubling levels 1 .. S/2, one block per sub-block;
//   * every level s >= S is two batched triangular products launched by
//     the Python wrapper through repro_tri_gemm (tri_gemm.cuh's tiles):
//     T = L21 @ tril(A11^-1), rounded to the operand dtype as the TPU
//     kernel rounds t, then N21 = -(tril(A22^-1) @ T), written in place
//     into the output.  The triangular operands bound the k-loops, which
//     halves the flops of both products.
// Partial sums are fp32 (double for fp64) and every level rounds to the
// operand dtype exactly where the TPU kernel does.  The output is the
// inverse of tril(L): the upper triangle of the input is never read and
// the upper triangle of the output is written as zeros.  Not yet done:
// tensor cores for bf16, and pipelining within a level.
//
// The GATED instantiations (kernel B5, repro_tri_inv_leaf_valid_* and
// repro_tri_gemm_valid_*) replace the validity-gated Pallas kernel
// (_tri_inv_valid_kernel of the same file): the same inversion with an
// (m,) int32 mask read on the device.  A block flagged 0 comes out as
// zeros and none of its L is read, so no reciprocal is taken of its
// diagonal.  Its home is padded admission: a factor of order d padded
// to blockdiag(L, I) at order n has diagonal blocks that are wholly
// the identity tail, and those need no inversion.  A gated leaf CTA
// writes zeros over its sub-block's whole row strip [jS, jS+S) x
// [0, n0), the part left of the sub-block included (in an ungated
// block the levels write it), and reads nothing; every level's CTAs
// of a gated block return before their first load (tri_gemm.cuh's
// GATED flag), so they write neither the scratch T nor the output.
// What bounds it: the valid blocks' flops, as B1; the gated blocks cost
// one write of zeros.  An unflagged block runs B1's arithmetic in B1's
// order, so an all-ones mask gives B1's output bit for bit, and the
// ungated instantiations compile to the code they had before.
#include "tri_gemm.cuh"

namespace {

// largest leaf order: two (S, S+1) accumulator tiles stay under the
// 48 KB of static shared memory (64 for float, 32 for double)
template <typename T>
__host__ __device__ constexpr int leaf_max() {
  return sizeof(typename repro::Acc<T>::type) == 8 ? 32 : 64;
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(256)
    tri_inv_leaf_kernel(const T* __restrict__ L, T* __restrict__ out, int n0,
                        int S, const int* __restrict__ valid) {
  using A_t = typename repro::Acc<T>::type;
  constexpr int kL = leaf_max<T>();
  __shared__ A_t Am[kL][kL + 1];
  __shared__ A_t Tm[kL][kL + 1];

  const int per = n0 / S;
  const int64_t b = blockIdx.x / per;
  const int j = blockIdx.x % per;
  if constexpr (GATED) {
    if (valid[b] == 0) {  // uniform across the CTA: one block
      T* strip = out + b * n0 * n0 + (int64_t)j * S * n0;
      for (int64_t e = threadIdx.x; e < (int64_t)S * n0; e += blockDim.x)
        strip[e] = repro::from_acc<T>(A_t(0));
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
    if (c <= r) v = repro::to_acc(Lb[(int64_t)r * n0 + c]);
    Am[r][c] = c < r ? v : (c == r ? repro::round_to<T>(A_t(1) / v) : A_t(0));
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
        acc = repro::mad(Am[o + s + r][o + x], Am[o + x][o + c], acc);
      Tm[o + s + r][o + c] = repro::round_to<T>(acc);
    }
    __syncthreads();
    // n21 = -(a22^-1 @ t) (a22^-1 lower: columns x <= r), over l21
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int q = e / per_q, rem = e % per_q, r = rem / s, c = rem % s;
      const int o = q * 2 * s;
      A_t acc = A_t(0);
      for (int x = 0; x <= r; ++x)
        acc = repro::mad(Am[o + s + r][o + s + x], Tm[o + s + x][o + c], acc);
      Am[o + s + r][o + c] = repro::round_to<T>(-acc);
    }
    __syncthreads();
  }

  // the row strip [jS, jS+S) x [jS, n0): the inverted sub-block, then
  // zeros; the strip left of the sub-block belongs to the levels >= S
  const int width = n0 - j * S;
  for (int e = threadIdx.x; e < S * width; e += blockDim.x) {
    const int r = e / width, c = e % width;
    Ob[(int64_t)r * n0 + c] = repro::from_acc<T>(c < S ? Am[r][c] : A_t(0));
  }
}

template <typename T, bool GATED>
int leaf(const void* L, void* out, long long m, int n0, int S,
         const void* valid, void* stream) {
  if (S < 1 || S > leaf_max<T>() || n0 % S || m < 1)
    return (int)cudaErrorInvalidValue;
  if (GATED && valid == nullptr) return (int)cudaErrorInvalidValue;
  const long long blocks = m * (n0 / S);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  tri_inv_leaf_kernel<T, GATED><<<(unsigned)blocks, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<T*>(out), n0, S,
      static_cast<const int*>(valid));
  return (int)cudaGetLastError();
}

template <typename T, bool GATED>
int gemm(const void* a, long long lda, long long a_sb, long long a_sq,
         const void* b, long long ldb, long long b_sb, long long b_sq,
         void* c, long long ldc, long long c_sb, long long c_sq, int M,
         int N, int K, int nq, long long batch, int tri_a, int tri_b,
         int negate, const void* valid, void* stream) {
  repro::TriGemmArgs<T> p;
  p.a = static_cast<const T*>(a);
  p.lda = lda; p.a_sb = a_sb; p.a_sq = a_sq;
  p.b = static_cast<const T*>(b);
  p.ldb = ldb; p.b_sb = b_sb; p.b_sq = b_sq;
  p.c = static_cast<T*>(c);
  p.ldc = ldc; p.c_sb = c_sb; p.c_sq = c_sq;
  p.M = M; p.N = N; p.K = K;
  p.nq = nq;
  p.tri_a = tri_a; p.tri_b = tri_b; p.negate = negate;
  return (int)repro::launch_tri_gemm<T, false, GATED>(
      p, batch, static_cast<cudaStream_t>(stream),
      repro::BlockMask{nullptr, 0, 0}, static_cast<const int*>(valid));
}

}  // namespace

// The _valid entries (B5) also take a contiguous (m,) int32 mask on the
// device; in repro_tri_gemm_valid_* batch entry z reads flag z / nq.
#define REPRO_TRI_INV(SUFFIX, T)                                            \
  extern "C" int repro_tri_inv_leaf_##SUFFIX(const void* L, void* out,     \
                                             long long m, int n0, int S,   \
                                             void* stream) {               \
    return leaf<T, false>(L, out, m, n0, S, nullptr, stream);              \
  }                                                                        \
  extern "C" int repro_tri_gemm_##SUFFIX(                                  \
      const void* a, long long lda, long long a_sb, long long a_sq,       \
      const void* b, long long ldb, long long b_sb, long long b_sq,       \
      void* c, long long ldc, long long c_sb, long long c_sq, int M,      \
      int N, int K, int nq, long long batch, int tri_a, int tri_b,        \
      int negate, void* stream) {                                          \
    return gemm<T, false>(a, lda, a_sb, a_sq, b, ldb, b_sb, b_sq, c, ldc, \
                          c_sb, c_sq, M, N, K, nq, batch, tri_a, tri_b,   \
                          negate, nullptr, stream);                        \
  }                                                                        \
  extern "C" int repro_tri_inv_leaf_valid_##SUFFIX(                        \
      const void* L, void* out, long long m, int n0, int S,               \
      const void* valid, void* stream) {                                   \
    return leaf<T, true>(L, out, m, n0, S, valid, stream);                 \
  }                                                                        \
  extern "C" int repro_tri_gemm_valid_##SUFFIX(                            \
      const void* a, long long lda, long long a_sb, long long a_sq,       \
      const void* b, long long ldb, long long b_sb, long long b_sq,       \
      void* c, long long ldc, long long c_sb, long long c_sq, int M,      \
      int N, int K, int nq, long long batch, int tri_a, int tri_b,        \
      int negate, const void* valid, void* stream) {                       \
    return gemm<T, true>(a, lda, a_sb, a_sq, b, ldb, b_sb, b_sq, c, ldc,  \
                         c_sb, c_sq, M, N, K, nq, batch, tri_a, tri_b,    \
                         negate, valid, stream);                           \
  }

REPRO_TRI_INV(f32, float)
REPRO_TRI_INV(bf16, __nv_bfloat16)
REPRO_TRI_INV(f64, double)
