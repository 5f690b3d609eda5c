// Fused Metropolis annealing of the CFN placement: whole chains in one launch.
//
// Replaces fused_anneal_tpu (src/repro/kernels/placement_power.py:377).  One
// thread block runs one chain for all T steps; the chain's placement X[J],
// its best placement bX[J] and its loads omega[P], theta[P], lambda[N] stay
// in shared memory throughout ((2J + 2P + N + 6M) * 4 bytes with
// M = 2 * D * K: about 30 KB at city scale, J = 3072, P = 468, N = 126,
// D = 2, K = 14).
//
// Each step follows the ENTRY-WISE delta of core.power._move_core /
// _delta_objective rather than the TPU kernel's full-width one-hots:
//   * omega and theta change only at p_old and p_new (thread 0);
//   * lambda changes only on the <= 2*D*K touched route ids, one slot per
//     (leg, incident link, route position), read straight from the int32
//     CSR route table.  A node id that appears in several slots (shared by
//     the removal and insertion routes, whose +-h often cancel) has its
//     signed bitrates summed at its first slot BEFORE snapping and before
//     the ACTIVE_EPS activation test; only that slot scores and commits it.
// Then the Metropolis test -- delta < 0 || u < expf(-max(delta, 0) / T),
// with expf, not __expf, so the kernel and its plain PyTorch version accept
// the same moves -- and best-state tracking.
//
// Bound on the H100: the work is a sequential chain of T small steps per
// chain, so latency (a few block barriers per step) bounds it, not bytes or
// operations; one block per chain means C = 32 chains fill 32 of the 132
// SMs.  Both are known limits of this first version.
#include <cuda_runtime.h>

namespace {

constexpr float kActiveEps = 1.0e-6f;
constexpr float kPenalty = 1.0e4f;
constexpr float kSnapGflops = 1.0e-3f;
constexpr float kSnapMbps = 1.0e-2f;
constexpr int kThreads = 128;

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ float snap(float x, float e) {
  return fabsf(x) < e ? 0.0f : x;
}

// Eq.(2) power of processing node p under hard activation indicators;
// pp [9, P] = E, C_pr, NS, pi_pr, pue_pr, EL, C_lan, pi_lan, lan_share.
__device__ __forceinline__ float proc_power(float om, float th,
                                            const float* pp, int P, int p) {
  const float E = pp[p], C_pr = pp[P + p], pi_pr = pp[3 * P + p];
  const float pue = pp[4 * P + p], EL = pp[5 * P + p];
  const float share_pi = pp[8 * P + p] * pp[7 * P + p];
  const float phi = (om > kActiveEps || th > kActiveEps) ? 1.0f : 0.0f;
  return pue * (E * om + ceilf(om / C_pr) * pi_pr + EL * th / 1e3f +
                phi * share_pi);
}

// Capacity-violation change at processing node p.
__device__ __forceinline__ float proc_viol(float om, float om2, float th,
                                           float th2, const float* pp, int P,
                                           int p) {
  const float cap = pp[2 * P + p] * pp[P + p], C_lan = pp[6 * P + p];
  return relu(om2 - cap) - relu(om - cap) + relu(th2 / 1e3f - C_lan) -
         relu(th / 1e3f - C_lan);
}

__global__ void __launch_bounds__(kThreads)
fused_anneal_kernel(const int* __restrict__ X0, const int* __restrict__ jprop,
                    const int* __restrict__ pprop,
                    const float* __restrict__ uprop,
                    const float* __restrict__ temps,
                    const int* __restrict__ inc_other,
                    const float* __restrict__ inc_h,
                    const int* __restrict__ inc_src,
                    const float* __restrict__ omega0,
                    const float* __restrict__ theta0,
                    const float* __restrict__ lam0,
                    const float* __restrict__ obj0,
                    const float* __restrict__ F, const int* __restrict__ route,
                    const float* __restrict__ pp, const float* __restrict__ nn,
                    int* __restrict__ bX_out, float* __restrict__ stats, int J,
                    int T, int D, int P, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DK = D * K, M = 2 * DK;
  int* sX = reinterpret_cast<int*>(smem_raw);  // [J] live placement
  int* sbX = sX + J;                           // [J] best placement
  int* s_id = sbX + J;                         // [M] route id per slot
  int* s_first = s_id + M;                     // [M] first slot of its id
  float* omega = reinterpret_cast<float*>(s_first + M);  // [P]
  float* theta = omega + P;                              // [P]
  float* lam = theta + P;                                // [N]
  float* s_hh = lam + N;                                 // [M] signed bitrate
  float* s_lam_new = s_hh + M;                           // [M]
  float* s_dnet = s_lam_new + M;                         // [M]
  float* s_dviol = s_dnet + M;                           // [M]
  __shared__ float s_obj, s_bobj;
  __shared__ int s_acc, s_better;

  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < J; i += nt) {
    const int v = X0[(size_t)c * J + i];
    sX[i] = v;
    sbX[i] = v;
  }
  for (int p = tid; p < P; p += nt) {
    omega[p] = omega0[(size_t)c * P + p];
    theta[p] = theta0[(size_t)c * P + p];
  }
  for (int n = tid; n < N; n += nt) lam[n] = lam0[(size_t)c * N + n];
  if (tid == 0) {
    s_obj = obj0[c];
    s_bobj = s_obj;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int j = jprop[(size_t)c * T + t];
    const int pn = pprop[(size_t)c * T + t];
    const int po = sX[j];
    const int* oj = inc_other + (size_t)j * D;
    const float* hj = inc_h + (size_t)j * D;
    const int* sj = inc_src + (size_t)j * D;

    // ---- the touched route ids: slot = (leg, incident link d, k) ----------
    for (int s = tid; s < M; s += nt) {
      const int leg = s / DK, d = (s % DK) / K, k = s % K;
      const float h = hj[d];
      int id = N;  // padding links (h == 0) touch nothing
      if (h != 0.0f) {
        const int o = oj[d];
        const int a = leg ? pn : po;
        const int q = (o == j) ? a : sX[o];
        const int row = sj[d] ? a * P + q : q * P + a;
        id = route[(size_t)row * K + k];
      }
      s_id[s] = id;
      s_hh[s] = leg ? h : -h;
    }
    __syncthreads();

    // ---- per node id: aggregate at its first slot, score Eq.(1) there -----
    for (int s = tid; s < M; s += nt) {
      const int id = s_id[s];
      int first = id < N;
      for (int s2 = 0; first && s2 < s; ++s2) first = s_id[s2] != id;
      float dnet = 0.0f, dviol = 0.0f, ln = 0.0f;
      if (first) {
        float tot = 0.0f;
        for (int s2 = s; s2 < M; ++s2)
          if (s_id[s2] == id) tot += s_hh[s2];
        const float lo = lam[id];
        ln = snap(lo + tot, kSnapMbps);
        const float eps = nn[id], C_net = nn[N + id], pi_net = nn[2 * N + id];
        const float pue = nn[3 * N + id], idle = nn[4 * N + id];
        const float b_d = (ln > kActiveEps ? 1.0f : 0.0f) -
                          (lo > kActiveEps ? 1.0f : 0.0f);
        dnet = pue * (eps * (ln - lo) / 1e3f + b_d * (idle * pi_net));
        dviol = relu(ln / 1e3f - C_net) - relu(lo / 1e3f - C_net);
      }
      s_first[s] = first;
      s_lam_new[s] = ln;
      s_dnet[s] = dnet;
      s_dviol[s] = dviol;
    }
    __syncthreads();

    // ---- processing terms at p_old / p_new, accept, commit (thread 0) ----
    if (tid == 0) {
      const float Fj = F[j];
      float H_tot = 0.0f, sr = 0.0f, si = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float h = hj[d];
        const int o = oj[d];
        const int q_rm = (o == j) ? po : sX[o];
        const int q_in = (o == j) ? pn : sX[o];
        H_tot += h;
        sr += (q_rm == po) ? h : 0.0f;
        si += (q_in == pn) ? h : 0.0f;
      }
      // sums over the signed legs [-h removal ..., +h insertion ...]
      float s_old = 0.0f, s_new = 0.0f;
      for (int leg = 0; leg < 2; ++leg) {
        for (int d = 0; d < D; ++d) {
          const float hh = leg ? hj[d] : -hj[d];
          const int o = oj[d];
          const int q = (o == j) ? (leg ? pn : po) : sX[o];
          s_old += (q == po) ? hh : 0.0f;
          s_new += (q == pn) ? hh : 0.0f;
        }
      }
      const float alpha = -(H_tot - sr) + s_old;
      const float beta = (H_tot - si) + s_new;
      const bool same = po == pn;
      const float om0 = omega[po], om1 = omega[pn];
      const float th0 = theta[po], th1 = theta[pn];
      const float om0n = snap(om0 + (same ? 0.0f : -Fj), kSnapGflops);
      const float om1n = snap(om1 + (same ? 0.0f : Fj), kSnapGflops);
      const float th0n = snap(th0 + (same ? alpha + beta : alpha), kSnapMbps);
      const float th1n = snap(th1 + (same ? beta + alpha : beta), kSnapMbps);
      const float d_proc =
          (proc_power(om0n, th0n, pp, P, po) - proc_power(om0, th0, pp, P, po)) +
          (proc_power(om1n, th1n, pp, P, pn) - proc_power(om1, th1, pp, P, pn));
      float d_viol = proc_viol(om0, om0n, th0, th0n, pp, P, po) +
                     proc_viol(om1, om1n, th1, th1n, pp, P, pn);
      float d_net = 0.0f, d_viol_net = 0.0f;
      for (int s = 0; s < M; ++s) {
        d_net += s_dnet[s];
        d_viol_net += s_dviol[s];
      }
      d_viol += d_viol_net;
      const float delta = d_proc + d_net + kPenalty * d_viol;
      const float u = uprop[(size_t)c * T + t];
      const int acc =
          delta < 0.0f || u < expf(-fmaxf(delta, 0.0f) / fmaxf(temps[t], 1e-9f));
      if (acc) {
        sX[j] = pn;
        omega[po] = om0n;
        omega[pn] = om1n;
        theta[po] = th0n;
        theta[pn] = th1n;
        s_obj = s_obj + delta;
      }
      const int better = s_obj < s_bobj;
      if (better) s_bobj = s_obj;
      s_acc = acc;
      s_better = better;
    }
    __syncthreads();

    if (s_acc) {
      for (int s = tid; s < M; s += nt)
        if (s_first[s]) lam[s_id[s]] = s_lam_new[s];
    }
    if (s_better) {
      for (int i = tid; i < J; i += nt) sbX[i] = sX[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < J; i += nt) bX_out[(size_t)c * J + i] = sbX[i];
  if (tid == 0) {
    stats[2 * c] = s_bobj;
    stats[2 * c + 1] = s_obj;
  }
}

}  // namespace

// X [C, J] int32 (pins applied); jprop/pprop/uprop [C, T]; temps [T];
// inc_other/inc_h/inc_src [J, D]; omega0/theta0 [C, P], lam0 [C, N],
// obj0 [C]; F [J]; route [P*P, K] int32; pp [9, P]; nn [5, N]
// -> bX [C, J] int32, stats [C, 2] = (best objective, final objective).
// Returns cudaGetLastError() after the launch.
extern "C" int fused_anneal_launch(
    const int* X0, const int* jprop, const int* pprop, const float* uprop,
    const float* temps, const int* inc_other, const float* inc_h,
    const int* inc_src, const float* omega0, const float* theta0,
    const float* lam0, const float* obj0, const float* F, const int* route,
    const float* pp, const float* nn, int* bX, float* stats, int C, int J,
    int T, int D, int P, int N, int K, void* stream) {
  const int M = 2 * D * K;
  const size_t smem = (size_t)(2 * J + 2 * P + N + 6 * M) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_anneal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_anneal_kernel<<<C, kThreads, smem, (cudaStream_t)stream>>>(
      X0, jprop, pprop, uprop, temps, inc_other, inc_h, inc_src, omega0,
      theta0, lam0, obj0, F, route, pp, nn, bX, stats, J, T, D, P, N, K);
  return (int)cudaGetLastError();
}
