// Fused GDN / IGDN forward for Hopper (sm_90a), plain fp32 CUDA C++.
//
// Replaces the Pallas kernel `_gdn_kernel` launched by `_gdn_forward`
// (scripts/pallas_gdn.py:59-100).  On a (rows, C) view of channels_last
// activations it computes
//
//   norm[n, o] = sum_i gamma[o, i] * x[n, i]^2 + beta[o]
//   out[n, o]  = x[n, o] * rsqrt(norm[n, o])     (GDN)
//   out[n, o]  = x[n, o] * sqrt(norm[n, o])      (IGDN)
//
// Bound: the sum runs on the fp32 pipes (no tensor cores in this version),
// 2*C*C flops a row, which at C=128 takes longer than reading x and writing
// out once; so the kernel is bounded by operations, and what limits it in
// practice is feeding those FMAs from shared memory.
//
// Design: each block copies gamma into shared memory once, transposed to
// gT[i][o] (64 KB at C=128, 144 KB at C=192, so dynamic shared memory above
// 48 KB), then walks row tiles in a grid-stride loop.  Per tile it stages
// x^2 in shared memory.  Thread (t, y) owns channels t and t + blockDim.x
// for kRowsPerThread rows: 2 * kRowsPerThread sums in registers.  Each step
// of the channel sum reads 4 gT values per channel (consecutive threads,
// consecutive addresses) and 4 x^2 values per row as one broadcast float4,
// and issues 64 FMAs for 16 shared loads.  bias, rsqrt/sqrt and the
// multiply by x happen in registers, and out is written once.
//
// gT rows have an odd stride, so the transposing copy from the coalesced
// gamma read is free of bank conflicts.  C may be any value up to kMaxC; x^2
// rows are zero-padded to a multiple of 4 channels for the float4 reads.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 192;
constexpr int kRowsPerThread = 8;
constexpr int kRowGroups = 4;  // blockDim.y
constexpr int kTileRows = kRowsPerThread * kRowGroups;
constexpr int kMaxThreads = (kMaxC / 2) * kRowGroups;

struct Layout {
  int Cp;        // C rounded up to a multiple of 4: x^2 row stride
  int half;      // blockDim.x: channels t and t + half per thread
  int ldg;       // gT row stride, odd
  int xs_off;    // offset of the x^2 tile, a multiple of 4 floats
  size_t smem;   // bytes of dynamic shared memory
};

Layout layout(int C) {
  Layout l;
  l.Cp = (C + 3) / 4 * 4;
  l.half = ((C + 1) / 2 + 31) / 32 * 32;
  l.ldg = 2 * l.half + 1;
  l.xs_off = (l.Cp * l.ldg + 3) / 4 * 4;
  l.smem = sizeof(float) * ((size_t)l.xs_off + (size_t)kTileRows * l.Cp);
  return l;
}

template <bool kInverse>
__global__ void __launch_bounds__(kMaxThreads)
gdn_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, float* __restrict__ out,
               int rows, int C, Layout l) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* gT = smem;              // [Cp][ldg]: gT[i * ldg + o] = gamma[o * C + i]
  float* xs = smem + l.xs_off;   // [kTileRows][Cp]: x^2 of the current tile

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // zero the padding (channels o >= C and rows i >= C), then copy gamma
  // with coalesced reads
  for (int k = tid; k < l.Cp * l.ldg; k += nthreads) gT[k] = 0.0f;
  __syncthreads();
  for (int k = tid; k < C * C; k += nthreads) {
    const int o = k / C;
    const int i = k - o * C;
    gT[i * l.ldg + o] = gamma[k];
  }

  const int o0 = threadIdx.x;
  const int o1 = threadIdx.x + l.half;
  const float b0 = (o0 < C) ? beta[o0] : 0.0f;
  const float b1 = (o1 < C) ? beta[o1] : 0.0f;
  const int rbase = threadIdx.y * kRowsPerThread;
  const int ntiles = (rows + kTileRows - 1) / kTileRows;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * kTileRows;
    __syncthreads();  // gT is written; the last tile's xs reads are done
    for (int k = tid; k < kTileRows * l.Cp; k += nthreads) {
      const int r = k / l.Cp;
      const int i = k - r * l.Cp;
      const int n = row0 + r;
      float v = 0.0f;
      if (n < rows && i < C) v = x[(size_t)n * C + i];
      xs[k] = v * v;
    }
    __syncthreads();

    float acc0[kRowsPerThread], acc1[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc0[r] = acc1[r] = 0.0f;
    for (int i = 0; i < l.Cp; i += 4) {
      const float* g = gT + i * l.ldg;
      const float g00 = g[o0], g01 = g[l.ldg + o0];
      const float g02 = g[2 * l.ldg + o0], g03 = g[3 * l.ldg + o0];
      const float g10 = g[o1], g11 = g[l.ldg + o1];
      const float g12 = g[2 * l.ldg + o1], g13 = g[3 * l.ldg + o1];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float4 v =
            *reinterpret_cast<const float4*>(&xs[(rbase + r) * l.Cp + i]);
        acc0[r] = fmaf(g00, v.x, acc0[r]);
        acc0[r] = fmaf(g01, v.y, acc0[r]);
        acc0[r] = fmaf(g02, v.z, acc0[r]);
        acc0[r] = fmaf(g03, v.w, acc0[r]);
        acc1[r] = fmaf(g10, v.x, acc1[r]);
        acc1[r] = fmaf(g11, v.y, acc1[r]);
        acc1[r] = fmaf(g12, v.z, acc1[r]);
        acc1[r] = fmaf(g13, v.w, acc1[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int n = row0 + rbase + r;
      if (n >= rows) break;
      const size_t base = (size_t)n * C;
      if (o0 < C) {
        const float norm = acc0[r] + b0;
        const float xv = x[base + o0];
        out[base + o0] = kInverse ? xv * sqrtf(norm) : xv * rsqrtf(norm);
      }
      if (o1 < C) {
        const float norm = acc1[r] + b1;
        const float xv = x[base + o1];
        out[base + o1] = kInverse ? xv * sqrtf(norm) : xv * rsqrtf(norm);
      }
    }
  }
}

constexpr int kMaxDevices = 16;

// Resident blocks the whole card holds for (device, inverse, C), filled on
// first use: the attribute and occupancy queries cost host time on every
// launch otherwise.  Concurrent first uses write the same value.
int g_grid_cap[kMaxDevices][2][kMaxC + 1];

template <bool kInverse>
cudaError_t grid_cap(int C, const Layout& l, int* cap) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int& cached = g_grid_cap[device][kInverse][C];
  if (cached == 0) {
    int sms = 0, per_sm = 0;
    // the limit is per function, so it is set for the widest C: a smaller
    // value set for one C would refuse a later launch at a wider one
    if ((err = cudaFuncSetAttribute(
             gdn_fwd_kernel<kInverse>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)layout(kMaxC).smem)) != cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, gdn_fwd_kernel<kInverse>, l.half * kRowGroups,
             l.smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached = sms * per_sm;
  }
  *cap = cached;
  return cudaSuccess;
}

template <bool kInverse>
cudaError_t launch(const float* x, const float* gamma, const float* beta,
                   float* out, int rows, int C, cudaStream_t stream) {
  const Layout l = layout(C);
  int cap = 0;
  const cudaError_t err = grid_cap<kInverse>(C, l, &cap);
  if (err != cudaSuccess) return err;
  const int ntiles = (rows + kTileRows - 1) / kTileRows;
  const int grid = ntiles < cap ? ntiles : cap;
  gdn_fwd_kernel<kInverse><<<grid, dim3(l.half, kRowGroups), l.smem, stream>>>(
      x, gamma, beta, out, rows, C, l);
  return cudaGetLastError();
}

}  // namespace

extern "C" int icat_gdn_fwd(const float* x, const float* gamma,
                            const float* beta, float* out, int rows, int C,
                            int inverse, void* stream) {
  if (C < 1 || C > kMaxC || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      inverse ? launch<true>(x, gamma, beta, out, rows, C, s)
              : launch<false>(x, gamma, beta, out, rows, C, s);
  return (int)err;
}
