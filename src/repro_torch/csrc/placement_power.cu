// Batched full evaluation of the CFN placement objective (paper Eq. 1 + 2).
//
// Replaces placement_power_tpu (src/repro/kernels/placement_power.py:160),
// which builds one-hot [bc, J, P] / [bc, L, P, K] operands so the TPU's
// matrix unit can do the gathers.  Here one thread block evaluates one
// candidate placement X[b, :]:
//
//   omega[P], theta[P], lambda[N] accumulate in shared memory
//   ((2P + N) * 4 bytes: 4.2 KB at P = 468, N = 126) by shared-memory
//   atomics -- each VM adds its GFLOPS at its node, each virtual link adds
//   its bitrate at both endpoint nodes (once when they coincide) and along
//   its <= K route ids, read straight from the int32 CSR route table
//   (sentinel N ends a route; 12.3 MB at P = 468, K = 14, so it stays in L2);
//   then the block reduces the Eq.(1)/(2) terms to (objective, net, proc,
//   violation).
//
// Bound on the H100: the bytes of X (B * J * 4) and of the route rows the
// links touch; the arithmetic is a few adds per VM and per route id.  The
// design reads each operand once per candidate and keeps every load vector
// on chip; the cost it pays instead is shared-memory atomic contention when
// many VMs of a candidate share a node.
#include <cuda_runtime.h>

namespace {

constexpr float kActiveEps = 1.0e-6f;
constexpr float kPenalty = 1.0e4f;
constexpr int kThreads = 256;

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

// Sum of v over the block; the result is valid in thread 0.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) s += red[w];
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
placement_power_kernel(const int* __restrict__ X,
                       const int* __restrict__ link_src,
                       const int* __restrict__ link_dst,
                       const float* __restrict__ F,
                       const float* __restrict__ H,
                       const int* __restrict__ route,
                       const float* __restrict__ pp,
                       const float* __restrict__ nn,
                       float* __restrict__ out,
                       int J, int L, int P, int N, int K) {
  extern __shared__ float smem[];
  float* omega = smem;
  float* theta = smem + P;
  float* lam = smem + 2 * P;
  __shared__ float red[kThreads / 32];

  const int* x = X + (size_t)blockIdx.x * J;
  for (int i = threadIdx.x; i < 2 * P + N; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();

  for (int j = threadIdx.x; j < J; j += blockDim.x) atomicAdd(&omega[x[j]], F[j]);
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int a = x[link_src[l]], b = x[link_dst[l]];
    const float h = H[l];
    atomicAdd(&theta[a], h);
    if (b != a) {
      atomicAdd(&theta[b], h);
      const int* r = route + ((size_t)a * P + b) * K;
      for (int k = 0; k < K; ++k) {
        const int n = r[k];
        if (n >= N) break;  // routes are left-packed; sentinel N pads
        atomicAdd(&lam[n], h);
      }
    }
  }
  __syncthreads();

  float net = 0.0f, proc = 0.0f, viol = 0.0f;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const float E = pp[p], C_pr = pp[P + p], NS = pp[2 * P + p];
    const float pi_pr = pp[3 * P + p], pue_pr = pp[4 * P + p];
    const float EL = pp[5 * P + p], C_lan = pp[6 * P + p];
    const float pi_lan = pp[7 * P + p], lan_share = pp[8 * P + p];
    const float om = omega[p], th = theta[p];
    const float phi = (om > kActiveEps || th > kActiveEps) ? 1.0f : 0.0f;
    proc += pue_pr * (E * om + ceilf(om / C_pr) * pi_pr + EL * th / 1e3f +
                      phi * lan_share * pi_lan);
    viol += relu(om - NS * C_pr) + relu(th / 1e3f - C_lan);
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const float eps = nn[n], C_net = nn[N + n], pi_net = nn[2 * N + n];
    const float pue_net = nn[3 * N + n], idle_share = nn[4 * N + n];
    const float lm = lam[n];
    const float beta = lm > kActiveEps ? 1.0f : 0.0f;
    net += pue_net * (eps * lm / 1e3f + beta * idle_share * pi_net);
    viol += relu(lm / 1e3f - C_net);
  }
  net = block_sum(net, red);
  proc = block_sum(proc, red);
  viol = block_sum(viol, red);
  if (threadIdx.x == 0) {
    float* o = out + (size_t)blockIdx.x * 4;
    o[0] = net + proc + kPenalty * viol;
    o[1] = net;
    o[2] = proc;
    o[3] = viol;
  }
}

}  // namespace

// X [B, J] int32 (pins applied), link_src/link_dst [L] int32, F [J],
// H [L], route [P*P, K] int32, pp [9, P], nn [5, N] -> out [B, 4].
// Returns cudaGetLastError() after the launch.
extern "C" int placement_power_launch(const int* X, const int* link_src,
                                      const int* link_dst, const float* F,
                                      const float* H, const int* route,
                                      const float* pp, const float* nn,
                                      float* out, int B, int J, int L, int P,
                                      int N, int K, void* stream) {
  const size_t smem = (size_t)(2 * P + N) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        placement_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  placement_power_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      X, link_src, link_dst, F, H, route, pp, nn, out, J, L, P, N, K);
  return (int)cudaGetLastError();
}
