// PPO's update for Hopper (sm_90a): the dual-clip loss head and its gradient, the
// gradient's squared norms, and the global-norm clip fused with Adam.
//
// What it replaces: one grad step of PPOTrainer._sgd (gymrl_tpu_torch/algos/ppo.py)
// after the MLP's forward and before its backward, and after that backward:
//   ppo_loss_fwd   ppo_head_loss_plain (algos/ppo.py): log-softmax, ratio, clip, dual
//                  clip, value MSE, entropy bonus, the loss and its five metrics;
//   ppo_loss_bwd   autograd's gradient of that loss with respect to logits and values;
//   grad_sq_norms  the squared norm of every gradient tensor (torch._foreach_norm);
//   clip_adam      clip_grads_by_global_norm_ + torch.optim.Adam's step, in place.
// The reference is the XLA-compiled scan body of gymrl_tpu/algos/ppo.py (`_loss` under
// jax.value_and_grad, then optax.chain(clip_by_global_norm, adam)). The JAX package has no
// Pallas kernel for it: XLA fused these elementwise passes, and these kernels are that
// fusion written by hand, ~95 eager launches of a grad step in four.
//
// What bounds them: bytes, and far below that the launch. The loss reads 36 B a row and its
// gradient 56 B (a few us at most at 16,384 rows); clip_adam moves 28 B a parameter (5.6 MB
// for ActorCritic at hidden 256, ~1.7 us at 3.35 TB/s). Their design: one thread per row for
// the loss (its A logits and its four packed columns at the row's stride, no copies), and
// multi-tensor kernels over a table of up to PPO_MAX_TENSORS tensors passed by value, so a
// step needs no host-to-device copy although every step's gradients are new tensors.
//
// Deterministic: no float atomics. A reduction across blocks writes per-block partials in
// float64; the last block to finish (an integer ticket that resets itself) sums them in a
// fixed order. Two runs give the same bits.
//
// Rounding follows the plain path op for op where it can be known (build with -fmad=false):
//   * PyTorch's CUDA kernels fuse a multiply and an add inside one op: lerp is
//     fma(w, end - self, self), addcmul fma(value, t1 * t2, self), addcdiv
//     fma(value, t1 / t2, self), the log-softmax backward fma(-exp(out), sum, grad);
//     separate ops round separately (chip_smoke.py phase 19 (b) finds Adam equal to the
//     bit where the clip does not act).
//   * `tensor / python_float` multiplies by the double reciprocal rounded to float32
//     (torch.optim.Adam without foreach); `_foreach_div_` by a scalar list divides
//     (with foreach); both arrive here as `bc2_terms` and the flag `divide`.
//   * log_softmax over a row sums its exps as PyTorch's warp softmax does: a butterfly
//     over the next power of two of A lanes.
//   * autograd's tie rules: minimum and maximum split the gradient in half on a tie; clamp
//     passes it at both bounds; `where` routes it.
// Where the plain path's order cannot be known (its mean reductions, the entropy's row sum,
// the order in which autograd adds a tensor's gradients, the norm of norms), the kernels sum
// in a fixed order, in float64 for the means and the norm.

#include <cuda_runtime.h>
#include <math.h>

#define THREADS PPO_THREADS
#define CHUNK PPO_CHUNK
#define MAX_TENSORS PPO_MAX_TENSORS
#define MAX_ACTIONS PPO_MAX_ACTIONS
#define N_METRICS 5

static_assert(THREADS % 32 == 0 && THREADS >= MAX_TENSORS, "whole warps; a thread per tensor");
static_assert((MAX_ACTIONS & (MAX_ACTIONS - 1)) == 0, "a power of two of lanes");

namespace {

// The sum of one float64 per thread of the block, in a fixed order; valid in thread 0.
// Every thread of the block calls it.
__device__ double block_sum(double x) {
  __shared__ double warp_sums[THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  __syncthreads();  // the previous call's sums have been read
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < THREADS / 32; ++w) s += warp_sums[w];
  return s;
}

// Whether this block is the last of the grid to get here. Every thread calls it after
// the block's partials are written; the ticket wraps back to 0 for the next launch.
__device__ bool last_block(unsigned int* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// ---- the loss head -----------------------------------------------------------------

struct HeadIn {
  const float* logits;  // [n, A]
  const float* values;  // [n]
  const float* action;  // [n] at stride s_action (float, as packed)
  const float* logp_old;
  const float* adv;
  const float* ret;
  int n, n_actions, s_action, s_logp, s_adv, s_ret;
  float lo, hi;          // float32(1 - clip_eps), float32(1 + clip_eps)
  float dual_clip, value_coef, entropy_coef, inv_n;
};

// One row's forward values, as the plain path computes them.
struct RowFwd {
  float lp[MAX_ACTIONS];  // log_softmax(logits)
  int a;
  float logp, logp_old, adv, ratio, surr1, surr2, min_surr, dual, obj;
};

__device__ __forceinline__ int lanes(int n_actions) {
  int p = 1;
  while (p < n_actions) p <<= 1;
  return p;
}

__device__ void row_forward(const HeadIn& in, int i, RowFwd& r) {
  const int A = in.n_actions;
  const float* x = in.logits + (long long)i * A;
  float mx = x[0];
  for (int j = 1; j < A; ++j) mx = mx > x[j] ? mx : x[j];
  float e[MAX_ACTIONS];
  const int P = lanes(A);
  for (int j = 0; j < P; ++j) e[j] = j < A ? expf(x[j] - mx) : 0.0f;
  for (int off = P >> 1; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l) e[l] = e[l] + e[l + off];
  const float lsum = logf(e[0]);
  for (int j = 0; j < A; ++j) r.lp[j] = (x[j] - mx) - lsum;

  r.a = (int)in.action[(long long)i * in.s_action];  // .long() truncates, as here
  r.logp = (r.a >= 0 && r.a < A) ? r.lp[r.a] : __int_as_float(0x7fc00000);  // gather
  r.logp_old = in.logp_old[(long long)i * in.s_logp];
  r.adv = in.adv[(long long)i * in.s_adv];
  r.ratio = expf(r.logp - r.logp_old);
  r.surr1 = r.ratio * r.adv;
  const float clamped = fminf(fmaxf(r.ratio, in.lo), in.hi);
  r.surr2 = clamped * r.adv;
  r.min_surr = fminf(r.surr1, r.surr2);
  r.dual = in.dual_clip * r.adv;
  r.obj = r.adv < 0.0f ? fmaxf(r.min_surr, r.dual) : r.min_surr;
}

__global__ void __launch_bounds__(THREADS) ppo_loss_fwd(HeadIn in, double* partials,
                                                        unsigned int* ticket, float* loss,
                                                        float* metrics) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  double s[N_METRICS] = {0.0, 0.0, 0.0, 0.0, 0.0};  // obj, sq err, entropy, clipped, kl
  if (i < in.n) {
    RowFwd r;
    row_forward(in, i, r);
    const float d = in.values[i] - in.ret[(long long)i * in.s_ret];
    float ent = 0.0f;
    for (int j = 0; j < in.n_actions; ++j) ent = ent + expf(r.lp[j]) * r.lp[j];
    s[0] = r.obj;
    s[1] = d * d;
    s[2] = -ent;
    s[3] = (r.ratio < in.lo) | (r.ratio > in.hi) ? 1.0 : 0.0;
    s[4] = r.logp_old - r.logp;
  }
  for (int k = 0; k < N_METRICS; ++k) {
    const double b = block_sum(s[k]);
    if (threadIdx.x == 0) partials[blockIdx.x * N_METRICS + k] = b;
  }
  if (!last_block(ticket)) return;

  float mean[N_METRICS];
  for (int k = 0; k < N_METRICS; ++k) {
    double t = 0.0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
      t += __ldcg(partials + b * N_METRICS + k);
    mean[k] = (float)block_sum(t) * in.inv_n;
  }
  if (threadIdx.x == 0) {
    const float policy_loss = -mean[0];
    const float value_loss = in.value_coef * mean[1];
    loss[0] = (policy_loss + value_loss) - in.entropy_coef * mean[2];
    metrics[0] = policy_loss;
    metrics[1] = value_loss;
    metrics[2] = mean[2];
    metrics[3] = mean[3];
    metrics[4] = mean[4];
  }
}

// The gradient of the loss, times *grad_out, with respect to logits and values; autograd's
// chain for the plain loss, node by node.
__global__ void __launch_bounds__(THREADS) ppo_loss_bwd(HeadIn in, const float* grad_out,
                                                        float* dlogits, float* dvalues) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= in.n) return;
  const float g = *grad_out;
  RowFwd r;
  row_forward(in, i, r);

  // policy: loss = (-mean(obj) + value) - c * entropy
  const float g_obj = (-g) * in.inv_n;
  float g_min = g_obj;  // where(adv < 0, maximum(min_surr, dual), min_surr)
  if (r.adv < 0.0f)
    g_min = r.min_surr == r.dual ? g_obj * 0.5f : (r.min_surr < r.dual ? 0.0f : g_obj);
  const bool tie = r.surr1 == r.surr2;  // minimum(surr1, surr2)
  const float g1 = tie ? g_min * 0.5f : (r.surr1 > r.surr2 ? 0.0f : g_min);
  const float g2 = tie ? g_min * 0.5f : (r.surr1 < r.surr2 ? 0.0f : g_min);
  const float from_clamp = (r.ratio >= in.lo && r.ratio <= in.hi) ? g2 * r.adv : 0.0f;
  const float g_ratio = from_clamp + g1 * r.adv;
  const float g_logp = g_ratio * r.ratio;  // exp's backward reads its result

  // entropy: -(sum_j exp(lp_j) * lp_j) per row, its mean times -entropy_coef
  const float g_t = -(((-g) * in.entropy_coef) * in.inv_n);
  const int A = in.n_actions;
  const int P = lanes(A);
  float p[MAX_ACTIONS], G[MAX_ACTIONS], S[MAX_ACTIONS];
  for (int j = 0; j < A; ++j) {
    p[j] = expf(r.lp[j]);
    G[j] = g_t * p[j] + (g_t * r.lp[j]) * p[j];  // through mul, then through exp
    if (j == r.a) G[j] = G[j] + g_logp;             // through gather
  }
  for (int j = 0; j < P; ++j) S[j] = j < A ? G[j] : 0.0f;
  for (int off = P >> 1; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l) S[l] = S[l] + S[l + off];
  float* out = dlogits + (long long)i * A;
  for (int j = 0; j < A; ++j) out[j] = fmaf(-p[j], S[0], G[j]);  // log_softmax's backward

  // value: value_coef * mean((v - ret)^2)
  const float d = in.values[i] - in.ret[(long long)i * in.s_ret];
  dvalues[i] = ((g * in.value_coef) * in.inv_n) * (2.0f * d);
}

// ---- the multi-tensor kernels ---------------------------------------------------------

struct NormTable {
  const float* g[MAX_TENSORS];
  long long numel[MAX_TENSORS];
  int chunk_start[MAX_TENSORS + 1];  // block b works on tensor k where start[k] <= b < start[k+1]
  int n;
};

struct AdamTable {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  float* m[MAX_TENSORS];
  float* v[MAX_TENSORS];
  long long numel[MAX_TENSORS];
  float step_size[MAX_TENSORS];  // float32(-lr / bias_correction1)
  float bc2[MAX_TENSORS];        // sqrt(bias_correction2), or its reciprocal (see `divide`)
  int chunk_start[MAX_TENSORS + 1];
  int n;
};

struct AdamScalars {
  const float* sq;  // [n_sq] squared norms of every gradient tensor of the step
  int n_sq;
  float max_norm, lerp_weight, beta2, one_minus_beta2, eps;
  int divide;  // 1: denom = sqrt(v) / bc2 (foreach); 0: sqrt(v) * bc2 (one tensor at a time)
};

static_assert(sizeof(AdamTable) + sizeof(AdamScalars) <= 4096, "kernel parameters");

__device__ __forceinline__ int tensor_of(const int* chunk_start, int n) {
  int k = 0;
  while (k + 1 < n && (int)blockIdx.x >= chunk_start[k + 1]) ++k;
  return k;
}

__global__ void __launch_bounds__(THREADS) grad_sq_norms(NormTable t, float* sq, double* partials,
                                                         unsigned int* ticket) {
  const int k = tensor_of(t.chunk_start, t.n);
  const long long begin = (long long)(blockIdx.x - t.chunk_start[k]) * CHUNK;
  const long long end = min(begin + CHUNK, t.numel[k]);
  double acc = 0.0;
  for (long long e = begin + threadIdx.x; e < end; e += THREADS) {
    const double x = t.g[k][e];
    acc += x * x;
  }
  const double b = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = b;
  if (!last_block(ticket)) return;
  if ((int)threadIdx.x < t.n) {
    double total = 0.0;
    for (int c = t.chunk_start[threadIdx.x]; c < t.chunk_start[threadIdx.x + 1]; ++c)
      total += __ldcg(partials + c);
    sq[threadIdx.x] = (float)total;
  }
}

__global__ void __launch_bounds__(THREADS) clip_adam(AdamTable t, AdamScalars s) {
  __shared__ float scale;
  if (threadIdx.x == 0) {  // the global norm, from the squares in a fixed order
    double total = 0.0;
    for (int j = 0; j < s.n_sq; ++j) total += s.sq[j];
    const float norm = (float)sqrt(total);
    // where(norm < max, 1, max / norm), and max / norm is reciprocal(norm) * max
    scale = norm < s.max_norm ? 1.0f : (1.0f / norm) * s.max_norm;
  }
  __syncthreads();
  const int k = tensor_of(t.chunk_start, t.n);
  const long long begin = (long long)(blockIdx.x - t.chunk_start[k]) * CHUNK;
  const long long end = min(begin + CHUNK, t.numel[k]);
  float* p = t.p[k];
  float* m = t.m[k];
  float* v = t.v[k];
  const float* g = t.g[k];
  const float step_size = t.step_size[k], bc2 = t.bc2[k];
  for (long long e = begin + threadIdx.x; e < end; e += THREADS) {
    const float gc = g[e] * scale;                              // _foreach_mul_(grads, scale)
    const float m1 = fmaf(s.lerp_weight, gc - m[e], m[e]);      // exp_avg.lerp_(g, 1 - b1)
    const float v1 = fmaf(s.one_minus_beta2, gc * gc, v[e] * s.beta2);  // mul_, addcmul_
    const float root = sqrtf(v1);
    const float denom = (s.divide ? root / bc2 : root * bc2) + s.eps;
    p[e] = fmaf(step_size, m1 / denom, p[e]);                   // addcdiv_(m, denom, -ss)
    m[e] = m1;
    v[e] = v1;
  }
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

// chunk_start[0..n] from the tensors' sizes; returns the number of chunks (blocks).
inline int chunk_table(const long long* numel, int n, int* chunk_start) {
  int c = 0;
  for (int k = 0; k < n; ++k) {
    chunk_start[k] = c;
    c += (int)((numel[k] + CHUNK - 1) / CHUNK);
  }
  chunk_start[n] = c;
  return c;
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes). Each makes `device`, the card
// that holds the tensors and the stream, current in this library's own CUDA runtime
// (linked statically) before it launches, and returns the cudaError_t: 0, or the error
// that refused the device or the launch. Host arrays (the tables) are read here, on the
// host, and reach the kernel by value.
extern "C" int ppo_loss_fwd_launch(
    const float* logits, const float* values, const float* action, const float* logp_old,
    const float* adv, const float* ret, double* partials, unsigned int* ticket, float* loss,
    float* metrics, int n, int n_actions, int s_action, int s_logp, int s_adv, int s_ret,
    float lo, float hi, float dual_clip, float value_coef, float entropy_coef, float inv_n,
    int device, cudaStream_t stream) {
  if (n <= 0 || n_actions <= 0 || n_actions > MAX_ACTIONS) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const HeadIn in{logits, values, action, logp_old, adv, ret, n, n_actions, s_action, s_logp,
                  s_adv, s_ret, lo, hi, dual_clip, value_coef, entropy_coef, inv_n};
  ppo_loss_fwd<<<blocks(n), THREADS, 0, stream>>>(in, partials, ticket, loss, metrics);
  return (int)cudaGetLastError();
}

extern "C" int ppo_loss_bwd_launch(
    const float* logits, const float* values, const float* action, const float* logp_old,
    const float* adv, const float* ret, const float* grad_out, float* dlogits, float* dvalues,
    int n, int n_actions, int s_action, int s_logp, int s_adv, int s_ret, float lo, float hi,
    float dual_clip, float value_coef, float entropy_coef, float inv_n, int device,
    cudaStream_t stream) {
  if (n <= 0 || n_actions <= 0 || n_actions > MAX_ACTIONS) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const HeadIn in{logits, values, action, logp_old, adv, ret, n, n_actions, s_action, s_logp,
                  s_adv, s_ret, lo, hi, dual_clip, value_coef, entropy_coef, inv_n};
  ppo_loss_bwd<<<blocks(n), THREADS, 0, stream>>>(in, grad_out, dlogits, dvalues);
  return (int)cudaGetLastError();
}

extern "C" int grad_sq_norms_launch(const float* const* grads, const long long* numels,
                                    int n_tensors, float* sq, double* partials,
                                    unsigned int* ticket, int device, cudaStream_t stream) {
  if (n_tensors <= 0 || n_tensors > MAX_TENSORS) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  NormTable t{};
  t.n = n_tensors;
  for (int k = 0; k < n_tensors; ++k) {
    t.g[k] = grads[k];
    t.numel[k] = numels[k];
  }
  const int chunks = chunk_table(t.numel, n_tensors, t.chunk_start);
  if (chunks <= 0) return (int)cudaErrorInvalidValue;
  grad_sq_norms<<<chunks, THREADS, 0, stream>>>(t, sq, partials, ticket);
  return (int)cudaGetLastError();
}

extern "C" int clip_adam_launch(
    float* const* params, const float* const* grads, float* const* exp_avgs,
    float* const* exp_avg_sqs, const long long* numels, const float* step_sizes,
    const float* bc2_terms, int n_tensors, const float* sq, int n_sq, float max_norm,
    float lerp_weight, float beta2, float one_minus_beta2, float eps, int divide, int device,
    cudaStream_t stream) {
  if (n_tensors <= 0 || n_tensors > MAX_TENSORS || n_sq <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  AdamTable t{};
  t.n = n_tensors;
  for (int k = 0; k < n_tensors; ++k) {
    t.p[k] = params[k];
    t.g[k] = grads[k];
    t.m[k] = exp_avgs[k];
    t.v[k] = exp_avg_sqs[k];
    t.numel[k] = numels[k];
    t.step_size[k] = step_sizes[k];
    t.bc2[k] = bc2_terms[k];
  }
  const int chunks = chunk_table(t.numel, n_tensors, t.chunk_start);
  if (chunks <= 0) return (int)cudaErrorInvalidValue;
  const AdamScalars s{sq, n_sq, max_norm, lerp_weight, beta2, one_minus_beta2, eps, divide};
  clip_adam<<<chunks, THREADS, 0, stream>>>(t, s);
  return (int)cudaGetLastError();
}
