// Stand-ins for the CUDA built-ins that csrc/gdn.cu uses, so that the file
// compiles with g++ and its kernels run on the host
// (tests/test_torch_gdn_emulated.py).  A launch runs its blocks one after
// another and a block's threads as std::threads; __syncthreads and bar.sync
// are std::barriers; cp.async copies its bytes when the thread waits for its
// group (emu::defer) or at once; shared memory starts as NaNs.
// The arithmetic intrinsics are the host's IEEE operations (rsqrtf is
// 1 / sqrt), so the kernels are compared with plain loops built alike.
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9,
       cudaErrorInvalidDevice = 101 };
typedef void* cudaStream_t;
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

namespace emu {
constexpr int kSmemPerBlock = 232448;  // an H100's opt-in limit
constexpr int kSmemPerSm = 233472;
inline int sms = 3;
inline int defer = 1;
inline thread_local dim3 tid, bid, bdim, gdim;
inline thread_local float* smem;
struct Block {
  std::mutex mu;
  std::map<int, std::unique_ptr<std::barrier<>>> bars;
  std::map<int, int> counts;
  std::barrier<>& bar(int id, int n) {
    std::lock_guard<std::mutex> g(mu);
    auto it = bars.find(id);
    if (it == bars.end()) {
      counts[id] = n;
      it = bars.emplace(id, std::make_unique<std::barrier<>>(n)).first;
    } else if (counts[id] != n) {
      throw std::runtime_error("a barrier used with two thread counts");
    }
    return *it->second;
  }
};
inline thread_local Block* block;
using Copies = std::vector<std::function<void()>>;
inline thread_local Copies open_group;
inline thread_local std::vector<Copies> committed;
template <class K, class... A>
void launch(K kernel, int grid, int threads, size_t smem_bytes, cudaStream_t, A... args) {
  if (threads > 1024 || smem_bytes > (size_t)kSmemPerBlock)
    throw std::runtime_error("a launch the card would refuse");
  for (int b = 0; b < grid; ++b) {
    std::vector<float> shared(smem_bytes / 4 + 4, std::nanf(""));
    Block blk;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        tid.x = t; bid.x = b; bdim.x = threads; gdim.x = grid;
        smem = shared.data(); block = &blk;
        open_group.clear(); committed.clear();
        kernel(args...);
        open_group.clear(); committed.clear();
      });
    for (auto& t : ts) t.join();
  }
}
inline void copy(float* dst, const float* src, int n, bool ok) {
  std::vector<float> v(n, 0.0f);
  if (ok) std::memcpy(v.data(), src, 4 * n);
  if (defer)
    open_group.push_back([dst, v] { std::memcpy(dst, v.data(), 4 * v.size()); });
  else
    std::memcpy(dst, v.data(), 4 * n);
}
inline void wait(size_t keep) {
  while (committed.size() > keep) {
    for (auto& f : committed.front()) f();
    committed.erase(committed.begin());
  }
}
}  // namespace emu

#define threadIdx emu::tid
#define blockIdx emu::bid
#define blockDim emu::bdim
#define gridDim emu::gdim
using std::min;
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? emu::sms : emu::kSmemPerBlock;
  return cudaSuccess;
}
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return cudaSuccess; }
// blocks an SM by shared memory (1 KB reserved a block) and threads alone
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, const void*, int threads,
                                                                 size_t smem) {
  *n = std::min((int)(emu::kSmemPerSm / (smem + 1024)), 2048 / threads);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline void cp_async4(float* dst, const float* src) { emu::copy(dst, src, 1, true); }
inline void cp_async16(float* dst, const float* src) { emu::copy(dst, src, 4, true); }
inline void cp_async16_zfill(float* dst, const float* src, bool ok) { emu::copy(dst, src, 4, ok); }
inline void cp_async4_zfill(float* dst, const float* src, bool ok) { emu::copy(dst, src, 1, ok); }
inline void cp_async_commit() {
  emu::committed.push_back(emu::open_group);
  emu::open_group.clear();
}
inline void cp_async_wait_all() { emu::wait(0); }
inline void cp_async_wait_but_last() { emu::wait(1); }
inline void group_sync(int id, int threads) { emu::block->bar(id, threads).arrive_and_wait(); }
inline void __syncthreads() { emu::block->bar(0, emu::bdim.x).arrive_and_wait(); }

// ---- the plain chains, in the plain backward's order ----
extern "C" void emu_ref_bwd(const float* x, const float* gamma, const float* beta,
                            const float* g, float* dx, float* dnorm, int rows, int C,
                            int inverse) {
  std::vector<float> s(C), dn(C);
  for (int n = 0; n < rows; ++n) {
    const float* xr = x + (size_t)n * C;
    const float* gr = g + (size_t)n * C;
    for (int o = 0; o < C; ++o) {
      float acc = 0.0f;
      for (int i = 0; i < C; ++i) acc = std::fma(xr[i] * xr[i], gamma[(size_t)o * C + i], acc);
      const float norm = acc + beta[o];
      s[o] = inverse ? std::sqrt(norm) : 1.0f / std::sqrt(norm);
      const float gx = (gr[o] * (inverse ? 0.5f : -0.5f)) * xr[o];
      dn[o] = inverse ? gx / s[o] : gx * ((s[o] * s[o]) * s[o]);
      dnorm[(size_t)n * C + o] = dn[o];
    }
    for (int i = 0; i < C; ++i) {
      float m = 0.0f;
      for (int o = 0; o < C; ++o) m = std::fma(dn[o], gamma[(size_t)o * C + i], m);
      dx[(size_t)n * C + i] = gr[i] * s[i] + (m * xr[i]) * 2.0f;
    }
  }
}

extern "C" void emu_ref_fwd(const float* x, const float* gamma, const float* beta, float* out,
                            int rows, int C, int inverse) {
  for (int n = 0; n < rows; ++n)
    for (int o = 0; o < C; ++o) {
      const float* xr = x + (size_t)n * C;
      float acc = 0.0f;
      for (int i = 0; i < C; ++i) acc = std::fma(xr[i] * xr[i], gamma[(size_t)o * C + i], acc);
      const float norm = acc + beta[o];
      out[(size_t)n * C + o] = inverse ? xr[o] * std::sqrt(norm) : xr[o] * (1.0f / std::sqrt(norm));
    }
}

extern "C" void emu_set(int sms, int defer) {
  emu::sms = sms;
  emu::defer = defer;
}
