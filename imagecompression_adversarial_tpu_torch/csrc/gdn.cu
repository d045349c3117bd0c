// Fused GDN / IGDN forward and backward for Hopper (sm_90a): the channel
// products in fp32 FMA, in the order of an fp32 matrix product.
//
// The forward replaces the Pallas kernel `_gdn_kernel` launched by
// `_gdn_forward` (scripts/pallas_gdn.py:59-100).  On a (rows, C) view of
// channels_last activations it computes
//
//   norm[n, o] = sum_i gamma[o, i] * x[n, i]^2 + beta[o]
//   out[n, o]  = x[n, o] * rsqrt(norm[n, o])     (GDN)
//   out[n, o]  = x[n, o] * sqrt(norm[n, o])      (IGDN)
//
// The backward replaces `_gdn_fused_bwd` (scripts/pallas_gdn.py:125-147,
// plain XLA in the reference): with g the output's gradient and s =
// rsqrt(norm) (GDN) or sqrt(norm) (IGDN), recomputed from x,
//
//   dnorm[n, o] = (g * -0.5) * x * ((s * s) * s)  (GDN)
//               = (g * 0.5) * x / s               (IGDN)
//   dx[n, i]    = g * s + (sum_o dnorm[n, o] * gamma[o, i]) * x * 2
//
// and writes dx, dnorm (for dgamma = dnorm^T @ x^2 and dbeta = sum_n dnorm,
// which stay on cuBLAS and torch) or both.
//
// Bound: operations.  The largest call of a hyper training step (rows
// 131,072, C=128) must read x and write out once, 2 x 67.1 MB, 40 us at
// 3.35 TB/s; its product is 4.3 GFLOP, 64 us at the fp32 peak of 67
// TFLOP/s (8.7 us at the TF32 tensor-core peak).  The backward does both
// products, ~4C + 12 operations a row-channel: at the attack's 98,304 rows
// 6.6 GFLOP, 98 us, against 45 us for reading x and g and writing dx.
//
// Accuracy: each norm is one fp32 FMA chain over i = 0 .. C-1 from zero,
// then + beta: the order cuBLAS's SGEMM takes for these shapes on an H100,
// where the two agree bit for bit (kernels/gdn_accuracy.py).  v4, the previous version,
// ran the product on the tensor cores in 3xTF32 (each factor split into
// TF32 hi and lo parts, three products), within ~1e-6 relative of fp32 in
// every output, but the tensor core adds its products to the accumulator
// without rounding to nearest: at trained weights that small bias did not
// cancel in the training gradients' sums over rows, and dgamma sat 2.1e-4
// from the fp32 product's, 24x fp32's own distance from float64
// (PERF.md).  Summing each k step apart fixed the gradients but not the
// attacks' kernel-vs-plain spread, which fp32 FMA in cuBLAS's order closes.
// The backward takes the same chain for the norm, dnorm @ gamma as one fp32
// FMA chain over o = 0 .. C-1 (cuBLAS's order for that product,
// kernels/gdn_accuracy.py), and every elementwise step of the plain
// backward as its own rounded operation in the plain backward's order
// (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc contracts none of them into an
// FMA), so that dx and dnorm are the plain backward's bit for bit.
//
// Design: 8 warps a block.  Each block copies gamma once into shared memory
// (row-major (o, i), row stride Cp + 4 floats, zero-padded; it serves as the
// col-major B = gamma^T of the product), then walks tiles of 16, 32 or 64
// rows of x in a grid-stride loop; the tile height is chosen per call so that
// small calls still spread over the SMs.
// - Copies are cp.async, every thread's copies in flight at once: a
//   load-then-store loop waits out one memory latency per element.  The x
//   tile is single-buffered: the next tile's copy starts after this tile's
//   epilogue, and the other resident blocks of the SM compute meanwhile.
//   The hyper attack's calls all take 16-row tiles: three blocks an SM at
//   C=128 (a second tile buffer would cost one), one at C=192.  There a
//   double buffer saved about 4% of the device time of a call that the
//   host's launch cost already exceeds (PERF.md), so it was left out.
// - Each warp owns 16 rows and kJ (a template parameter: 2, 4, 6 or 8)
//   8-column output tiles; a lane holds rows g and g + 8 and channels 2t and
//   2t + 1 of each tile (g = lane / 4, t = lane % 4; v4's m16n8k8
//   accumulator layout, which the epilogue keeps).  Per k step of 8 a lane
//   loads and squares its two rows' 8 channels of x (two float4 loads a
//   row, shared by the kJ tiles), then for each tile loads its two gamma
//   rows' 8 channels and issues 32 FMAs: 1 shared load to 8 FMAs.  With kJ
//   fixed and gamma padded to the rows the warps cover, that loop unrolls
//   without branches.  The padded row stride keeps the loads free of bank
//   conflicts (lanes that share a row read one address).
// - The epilogue works on the accumulator registers: add beta, apply
//   rsqrt/sqrt, multiply by x from the shared tile, write out (four lanes
//   write a 32-byte run of a row).  x is read from device memory once and
//   out written once; x^2 and norm stay on chip.
// - The backward copies the x and g tiles, runs the forward's product into
//   the same accumulator layout and turns each sum into s (kept in those
//   registers) and dnorm, which it writes into a shared dnorm tile (and to
//   device memory where asked).  After a barrier, product 2 reads the
//   dnorm tile by rows, as product 1 reads x, and gamma by column pairs
//   (one float2 a lane and k, 1 shared load to 4 FMAs), into accumulators
//   laid out as product 1's, so dx's epilogue finds s, x and g at its
//   own positions.  Its warps own kJ 8-column tiles (1 to 6) and gamma is
//   padded only to the columns they cover, Gp (Gp = Cp at C = 128 and
//   192), in both directions: at C=192 gamma's 150.5 KB and the x, g and
//   dnorm tiles take 188.9 KB of shared memory at 16 rows and 226.6 KB at
//   32.  Nothing but dx (and dnorm) reaches device memory.
// Its times beside v4's and the bound are in PERF.md.
// icat_gdn_layout and icat_gdn_bwd_layout report the tile height, blocks an
// SM and grid a call picks.
// C may be any value up to kMaxC; rows whose byte offset or base pointer is
// not 16-byte aligned take 4-byte copies and stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 192;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileHeights[] = {64, 32, 16};  // tried in this order
constexpr int kNumTileHeights = 3;
// 16-column output tiles a warp owns at most (8 accumulator registers each);
// a tile height that would give a warp more is not used for that C, so the
// kernel fits 128 registers (two blocks an SM) without spilling
constexpr int kMaxTilesPerWarp = 4;
// 8-column output tiles a backward warp owns at most (two sets of 4
// accumulator registers each: s and dnorm @ gamma); 6 covers C=192 in 32-row
// tiles and C=128 in 16- and 32-row ones (64-row tiles only up to C=96)
constexpr int kMaxBwdTilesPerWarp = 6;

struct Layout {
  int Cp;         // C rounded up to a multiple of 16 (backward: Gp)
  int ld;         // row stride of gamma and the tiles in shared memory, Cp + 4
  int tile;       // rows per tile
  int groups;     // 16-row groups per tile
  int per_warp;   // output tiles per warp: 16-column (forward), 8-column
                  // (backward, the kernel's kJ)
  int Gp;         // output channels the warps cover, >= Cp: gamma's rows
  size_t smem;    // bytes of dynamic shared memory
};

Layout layout(int C, int tile) {
  Layout l;
  l.Cp = (C + 15) / 16 * 16;
  l.ld = l.Cp + 4;
  l.tile = tile;
  l.groups = tile / 16;
  const int col_groups = kWarps / l.groups;
  l.per_warp = (l.Cp / 16 + col_groups - 1) / col_groups;
  l.Gp = 16 * col_groups * l.per_warp;
  // gamma [Gp][ld], x [tile][ld], beta [Gp], each 16-byte aligned
  l.smem = sizeof(float) * ((size_t)l.Gp * l.ld + (size_t)tile * l.ld + l.Gp);
  return l;
}

// The backward's: C padded to Gp, the columns the warps' 8-column tiles
// cover, which is both products' reduction length (the padding is zeros)
Layout layout_bwd(int C, int tile) {
  Layout l;
  l.tile = tile;
  l.groups = tile / 16;
  const int col_groups = kWarps / l.groups;
  const int tiles8 = (C + 15) / 16 * 2;
  l.per_warp = (tiles8 + col_groups - 1) / col_groups;
  l.Gp = 8 * col_groups * l.per_warp;
  l.Cp = l.Gp;
  l.ld = l.Gp + 4;
  // gamma [Gp][ld]; x, g and dnorm [tile][ld]; beta [Gp]
  l.smem = sizeof(float) * ((size_t)l.Gp * l.ld + 3 * (size_t)tile * l.ld + l.Gp);
  return l;
}

__device__ __forceinline__ float gdn_out(float x, float norm, bool inverse) {
  return inverse ? x * sqrtf(norm) : x * rsqrtf(norm);
}

// The plain backward's dnorm in its order, each step rounded
__device__ __forceinline__ float dnorm_of(float g, float x, float s, bool inverse) {
  const float gx = __fmul_rn(__fmul_rn(g, inverse ? 0.5f : -0.5f), x);
  return inverse ? __fdiv_rn(gx, s) : __fmul_rn(gx, __fmul_rn(__fmul_rn(s, s), s));
}

// dx = g * s + (m * x) * 2, m = (dnorm @ gamma)[n, i], each step rounded
__device__ __forceinline__ float dx_of(float g, float s, float m, float x) {
  return __fadd_rn(__fmul_rn(g, s), __fmul_rn(__fmul_rn(m, x), 2.0f));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Starts copying rows [0, n) of the row-major (., C) array at src into
// dst[m][ld], and zero-fills columns C..Cp-1 and rows n..m-1.  vec: C is a
// multiple of 4 and src 16-byte aligned, so whole float4s are copied.
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n,
                                          int m, int C, const Layout& l,
                                          bool vec) {
  if (vec) {
    const int c4 = C / 4, cp4 = l.Cp / 4;
    for (int k = threadIdx.x; k < m * cp4; k += kThreads) {
      const int r = k / cp4;
      const int i = k - r * cp4;
      float* d = dst + r * l.ld + 4 * i;
      if (r < n && i < c4)
        cp_async16(d, src + (size_t)r * C + 4 * i);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else {
    for (int k = threadIdx.x; k < m * l.Cp; k += kThreads) {
      const int r = k / l.Cp;
      const int i = k - r * l.Cp;
      float* d = dst + r * l.ld + i;
      if (r < n && i < C)
        cp_async4(d, src + (size_t)r * C + i);
      else
        *d = 0.0f;
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until all of this thread's copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v[0..7] = p[0..7]; p 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// out[n][o] = a and out[n][o + 1] = b, within rows and C (vec: C is even,
// so o < C covers o + 1; four lanes write a 32-byte run of a row)
__device__ __forceinline__ void store2(float* out, int n, int o, int rows,
                                       int C, bool vec, float a, float b) {
  if (n >= rows || o >= C) return;
  float* p = out + (size_t)n * C + o;
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (o + 1 < C) p[1] = b;
  }
}

// Product 1, x^2 @ gamma^T, for the lane's rows (xr and xr + 8 ld) and the
// output channels o = 8 (first + j) + 2t and o + 1 of its kJ tiles: acc[j]
// = (row g, o), (g, o + 1), (g + 8, o), (g + 8, o + 1), each one fp32 FMA
// chain over k = 0 .. Cp-1 from zero
template <int kJ>
__device__ __forceinline__ void norm_sums(const float* xr, const float* gs,
                                          const Layout& l, int first, int g,
                                          int t, float (&acc)[kJ][4]) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int k0 = 0; k0 < l.Cp; k0 += 8) {
    float s0[8], s1[8];  // x^2 of rows g and g + 8, channels k0 .. k0 + 7
    load8(xr + k0, s0);
    load8(xr + 8 * l.ld + k0, s1);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      s0[kk] *= s0[kk];
      s1[kk] *= s1[kk];
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      // gamma's rows for output channels o and o + 1 of tile j
      const float* gc = gs + (8 * (first + j) + 2 * t) * l.ld + k0;
      float c0[8], c1[8];
      load8(gc, c0);
      load8(gc + l.ld, c1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        acc[j][0] = fmaf(s0[kk], c0[kk], acc[j][0]);
        acc[j][1] = fmaf(s0[kk], c1[kk], acc[j][1]);
        acc[j][2] = fmaf(s1[kk], c0[kk], acc[j][2]);
        acc[j][3] = fmaf(s1[kk], c1[kk], acc[j][3]);
      }
    }
  }
}

// Product 2, dnorm @ gamma, for the lane's rows (dr and dr + 8 ld) and the
// input channels i = 8 (first + j) + 2t and i + 1, in product 1's layout:
// each one fp32 FMA chain over o = 0 .. Cp-1 from zero
template <int kJ>
__device__ __forceinline__ void grad_sums(const float* dr, const float* gs,
                                          const Layout& l, int first, int t,
                                          float (&acc)[kJ][4]) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int o0 = 0; o0 < l.Cp; o0 += 8) {
    float d0[8], d1[8];  // dnorm of rows g and g + 8, channels o0 .. o0 + 7
    load8(dr + o0, d0);
    load8(dr + 8 * l.ld + o0, d1);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      // gamma[o0 + kk][i .. i + 1], a column pair
      const float* gc = gs + o0 * l.ld + 8 * (first + j) + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float2 c = *reinterpret_cast<const float2*>(gc + kk * l.ld);
        acc[j][0] = fmaf(d0[kk], c.x, acc[j][0]);
        acc[j][1] = fmaf(d0[kk], c.y, acc[j][1]);
        acc[j][2] = fmaf(d1[kk], c.x, acc[j][2]);
        acc[j][3] = fmaf(d1[kk], c.y, acc[j][3]);
      }
    }
  }
}

template <bool kInverse, int kJ>
__global__ void __launch_bounds__(kThreads, 2)
gdn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ out,
               int rows, int C, Layout l, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                    // [Gp][ld]: gamma, zero-padded
  float* xs = gs + l.Gp * l.ld;        // [tile][ld]: x tile
  float* bs = xs + l.tile * l.ld;      // [Gp]: beta
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  for (int i = threadIdx.x; i < l.Gp; i += kThreads)
    bs[i] = i < C ? beta[i] : 1.0f;

  const int group = warp % l.groups;
  const int first = kJ * (warp / l.groups);  // first 8-column tile
  const int ntiles = (rows + l.tile - 1) / l.tile;
  // x tile `tile` into shared memory, rows past the end zero-filled
  auto copy_tile = [&](int tile) {
    const int row0 = tile * l.tile;
    copy_rows(xs, x + (size_t)row0 * C, min(l.tile, rows - row0), l.tile, C,
              l, vec);
  };

  // gamma and the first tile (every block has one)
  copy_rows(gs, gamma, C, l.Gp, C, l, vec);
  copy_tile(blockIdx.x);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    const int row0 = tile * l.tile;
    // this lane's row g of the warp's 16 rows; row g + 8 is 8 * ld further
    const float* xr = xs + (16 * group + g) * l.ld;

    float acc[kJ][4];
    norm_sums<kJ>(xr, gs, l, first, g, t, acc);

    const int n0 = row0 + 16 * group + g;  // rows n0 and n0 + 8
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int o = 8 * (first + j) + 2 * t;  // channels o and o + 1
      if (o < C) {  // x's tile is Cp wide, the warps cover Gp columns
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* xv = xr + 8 * h * l.ld + o;
          store2(out, n0 + 8 * h, o, rows, C, vec,
                 gdn_out(xv[0], acc[j][2 * h] + bs[o], kInverse),
                 gdn_out(xv[1], acc[j][2 * h + 1] + bs[o + 1], kInverse));
        }
      }
    }
    __syncthreads();  // every warp is done with the tile
    if (tile + gridDim.x < ntiles) {
      copy_tile(tile + gridDim.x);
      cp_async_commit();
    }
  }
}

// dx (where dx is not null) and dnorm (where dnorm is not null) of the
// rows of x, for the output gradient gy; inverse is a block-uniform branch
// (as a template parameter it would double the build's kernels)
template <int kJ>
__global__ void __launch_bounds__(kThreads, 1)
gdn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ gy,
               float* __restrict__ dx, float* __restrict__ dnorm, int rows,
               int C, Layout l, bool vec, bool inverse) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                    // [Gp][ld]: gamma, zero-padded
  float* xs = gs + l.Gp * l.ld;        // [tile][ld]: x tile
  float* ys = xs + l.tile * l.ld;      // [tile][ld]: gy tile
  float* ds = ys + l.tile * l.ld;      // [tile][ld]: dnorm tile
  float* bs = ds + l.tile * l.ld;      // [Gp]: beta
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  for (int i = threadIdx.x; i < l.Gp; i += kThreads)
    bs[i] = i < C ? beta[i] : 1.0f;

  const int group = warp % l.groups;
  const int first = kJ * (warp / l.groups);  // first 8-column tile
  const int ntiles = (rows + l.tile - 1) / l.tile;
  // the x and gy tiles into shared memory, rows past the end zero-filled
  // (their dnorm is then 0 and adds nothing to product 2)
  auto copy_tile = [&](int tile) {
    const int row0 = tile * l.tile;
    const int n = min(l.tile, rows - row0);
    copy_rows(xs, x + (size_t)row0 * C, n, l.tile, C, l, vec);
    copy_rows(ys, gy + (size_t)row0 * C, n, l.tile, C, l, vec);
  };

  copy_rows(gs, gamma, C, l.Gp, C, l, vec);
  copy_tile(blockIdx.x);
  cp_async_commit();
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();
    const int r = 16 * group + g;  // the lane's rows r and r + 8 of the tile
    const int n0 = tile * l.tile + r;
    const float* xr = xs + r * l.ld;
    const float* yr = ys + r * l.ld;
    float* dr = ds + r * l.ld;

    float s[kJ][4];  // product 1's sums, then s
    norm_sums<kJ>(xr, gs, l, first, g, t, s);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int o = 8 * (first + j) + 2 * t;  // channels o and o + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float dn[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = 8 * h * l.ld + o + q;
          const float norm = __fadd_rn(s[j][2 * h + q], bs[o + q]);
          s[j][2 * h + q] = inverse ? __fsqrt_rn(norm) : rsqrtf(norm);
          dn[q] = dnorm_of(yr[e], xr[e], s[j][2 * h + q], inverse);
          dr[e] = dn[q];
        }
        if (dnorm != nullptr)
          store2(dnorm, n0 + 8 * h, o, rows, C, vec, dn[0], dn[1]);
      }
    }
    if (dx != nullptr) {
      __syncthreads();  // the dnorm tile is whole
      float m[kJ][4];
      grad_sums<kJ>(dr, gs, l, first, t, m);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int i = 8 * (first + j) + 2 * t;  // channels i and i + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 8 * h * l.ld + i;
          store2(dx, n0 + 8 * h, i, rows, C, vec,
                 dx_of(yr[e], s[j][2 * h], m[j][2 * h], xr[e]),
                 dx_of(yr[e + 1], s[j][2 * h + 1], m[j][2 * h + 1], xr[e + 1]));
        }
      }
    }
    __syncthreads();  // every warp is done with the tiles
    if (tile + gridDim.x < ntiles) {
      copy_tile(tile + gridDim.x);
      cp_async_commit();
    }
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, int,
                       int, Layout, bool);
using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, float*, float*, int, int, Layout,
                           bool, bool);

// the forward kernel for (inverse, 16-column tiles per warp)
Kernel kernel_for(bool inverse, int per_warp) {
  static const Kernel kernels[2][kMaxTilesPerWarp] = {
      {gdn_fwd_kernel<false, 2>, gdn_fwd_kernel<false, 4>,
       gdn_fwd_kernel<false, 6>, gdn_fwd_kernel<false, 8>},
      {gdn_fwd_kernel<true, 2>, gdn_fwd_kernel<true, 4>,
       gdn_fwd_kernel<true, 6>, gdn_fwd_kernel<true, 8>}};
  return kernels[inverse][per_warp - 1];
}

// the backward kernel for 8-column tiles per warp
BwdKernel bwd_kernel_for(int per_warp) {
  static const BwdKernel kernels[kMaxBwdTilesPerWarp] = {
      gdn_bwd_kernel<1>, gdn_bwd_kernel<2>, gdn_bwd_kernel<3>,
      gdn_bwd_kernel<4>, gdn_bwd_kernel<5>, gdn_bwd_kernel<6>};
  return kernels[per_warp - 1];
}

// (layout, kernel) of the forward (backward false) or the backward
Layout layout_for(bool backward, int C, int tile) {
  return backward ? layout_bwd(C, tile) : layout(C, tile);
}

const void* kernel_ptr(bool backward, bool inverse, int per_warp) {
  return backward ? reinterpret_cast<const void*>(bwd_kernel_for(per_warp))
                  : reinterpret_cast<const void*>(kernel_for(inverse, per_warp));
}

constexpr int kMaxDevices = 16;

struct Occupancy {
  int sms;     // SMs on the card
  int per_sm;  // resident blocks an SM; -1: the block does not fit
};

// The occupancy for (direction, device, inverse, C, tile height), filled on
// first use: the attribute and occupancy queries cost host time on every
// launch otherwise.  Concurrent first uses write the same value.
Occupancy g_occupancy[2][kMaxDevices][2][kMaxC + 1][kNumTileHeights];

cudaError_t occupancy(bool backward, bool inverse, int C, int t,
                      Occupancy* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  Occupancy& cached = g_occupancy[backward][device][inverse][C][t];
  if (cached.per_sm == 0) {
    const Layout l = layout_for(backward, C, kTileHeights[t]);
    const void* kernel = kernel_ptr(backward, inverse, l.per_warp);
    int limit = 0, sms = 0, per_sm = 0;
    // the limit is per function, so it is set to the most a block may have:
    // a smaller value set for one C would refuse a later launch at another
    if ((err = cudaDeviceGetAttribute(
             &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    if (l.smem <= (size_t)limit &&
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, l.smem)) != cudaSuccess)
      return err;
    cached = Occupancy{sms, per_sm < 1 ? -1 : per_sm};
  }
  *out = cached;
  return cudaSuccess;
}

struct Choice {
  Layout l;
  int per_sm;  // resident blocks an SM
  int grid;    // blocks launched: the tiles, at most the resident blocks
};

// The tile height whose busiest block walks the fewest rows; on a tie the
// taller tile, which loads each x fragment for more output columns.
cudaError_t choose(bool backward, int rows, int C, bool inverse, Choice* best) {
  long long best_rows = -1;
  for (int t = 0; t < kNumTileHeights; ++t) {
    const Layout l = layout_for(backward, C, kTileHeights[t]);
    if (l.per_warp > (backward ? kMaxBwdTilesPerWarp : kMaxTilesPerWarp)) continue;
    Occupancy o;
    const cudaError_t err = occupancy(backward, inverse, C, t, &o);
    if (err != cudaSuccess) return err;
    if (o.per_sm < 1) continue;
    const long long cap = (long long)o.sms * o.per_sm;
    const long long ntiles = ((long long)rows + l.tile - 1) / l.tile;
    const long long busiest = (ntiles + cap - 1) / cap * l.tile;
    if (best_rows < 0 || busiest < best_rows) {
      best_rows = busiest;
      *best = Choice{l, o.per_sm, (int)(ntiles < cap ? ntiles : cap)};
    }
  }
  return best_rows < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t launch(const float* x, const float* gamma, const float* beta,
                   float* out, int rows, int C, bool inverse,
                   cudaStream_t stream) {
  Choice c;
  const cudaError_t err = choose(false, rows, C, inverse, &c);
  if (err != cudaSuccess) return err;
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(gamma) && aligned16(out);
  kernel_for(inverse, c.l.per_warp)<<<c.grid, kThreads, c.l.smem, stream>>>(
      x, gamma, beta, out, rows, C, c.l, vec);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const float* x, const float* gamma, const float* beta,
                       const float* gy, float* dx, float* dnorm, int rows,
                       int C, bool inverse, cudaStream_t stream) {
  Choice c;
  const cudaError_t err = choose(true, rows, C, inverse, &c);
  if (err != cudaSuccess) return err;
  const bool vec = C % 4 == 0 && aligned16(x) && aligned16(gamma) &&
                   aligned16(gy) && aligned16(dx) && aligned16(dnorm);
  bwd_kernel_for(c.l.per_warp)<<<c.grid, kThreads, c.l.smem, stream>>>(
      x, gamma, beta, gy, dx, dnorm, rows, C, c.l, vec, inverse);
  return cudaGetLastError();
}

// out[0] rows per tile, out[1] resident blocks an SM, out[2] blocks
// launched (0 for no rows), out[3] bytes of dynamic shared memory a block
int report_layout(bool backward, int rows, int C, int inverse, int* out) {
  if (C < 1 || C > kMaxC || rows < 0) return (int)cudaErrorInvalidValue;
  Choice c;
  const cudaError_t err = choose(backward, rows, C, inverse != 0, &c);
  if (err != cudaSuccess) return (int)err;
  out[0] = c.l.tile;
  out[1] = c.per_sm;
  out[2] = c.grid;
  out[3] = (int)c.l.smem;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int icat_gdn_fwd(const float* x, const float* gamma,
                            const float* beta, float* out, int rows, int C,
                            int inverse, void* stream) {
  if (C < 1 || C > kMaxC || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return (int)launch(x, gamma, beta, out, rows, C, inverse != 0,
                    static_cast<cudaStream_t>(stream));
}

// dx and dnorm of (rows, C) for the output gradient g; either output may be
// null (not computed), not both.
extern "C" int icat_gdn_bwd(const float* x, const float* gamma,
                            const float* beta, const float* g, float* dx,
                            float* dnorm, int rows, int C, int inverse,
                            void* stream) {
  if (C < 1 || C > kMaxC || rows < 0 || (dx == nullptr && dnorm == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  return (int)launch_bwd(x, gamma, beta, g, dx, dnorm, rows, C, inverse != 0,
                        static_cast<cudaStream_t>(stream));
}

// The launch icat_gdn_fwd makes for (rows, C, inverse) on the current
// device (report_layout's out).
extern "C" int icat_gdn_layout(int rows, int C, int inverse, int* out) {
  return report_layout(false, rows, C, inverse, out);
}

// The launch icat_gdn_bwd makes.
extern "C" int icat_gdn_bwd_layout(int rows, int C, int inverse, int* out) {
  return report_layout(true, rows, C, inverse, out);
}
