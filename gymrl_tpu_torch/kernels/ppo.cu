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
// for ActorCritic at hidden 256, ~1.7 us at 3.35 TB/s). Their design: the loss reads its A
// logits and its four packed columns where they lie (no copies), and the multi-tensor kernels
// take a table of up to PPO_MAX_TENSORS tensors by value, so a step needs no host-to-device
// copy although every step's gradients are new tensors. At these sizes a kernel's time is its
// chain of dependent latencies, so the two reductions are built to keep that chain short:
//   ppo_loss_fwd   templated on the padded row width P, so a row's logits, exps and
//                  log-probabilities live in registers (unrolled loops, the gather a select);
//                  the four columns in one float4 load where they sit side by side on 16 B;
//                  one row per thread, so every SM that holds rows takes a short chain; the
//                  five sums in one interleaved block reduction; one block finishes in place,
//                  more write their sums and the last block reduces them all at once. (A
//                  cluster of at most 8 blocks reducing through distributed shared memory,
//                  no ticket, was 1.6x slower on an H100 at 16,384 rows: 8 SMs, 2 rows a
//                  thread.)
//   ppo_loss_bwd   the forward's row in registers, templated the same way, no reduction; its
//                  own block size (PPO_BWD_THREADS), so the bench's rows fill one wave; the
//                  rows of logits and dlogits as vectors where A is a power of two and they lie
//                  on 4 * A bytes (one float4 a row at A = 4, one float2 at A = 2).
//   grad_sq_norms  16-byte loads where a tensor lies on 16 B, all of a thread's loads in
//                  flight before it sums; the last block stages every partial in shared memory
//                  at once, and a warp per tensor sums that tensor's with a shuffle tree.
//   clip_adam      its own chunk (PPO_ADAM_CHUNK, one float4 of each array a thread), so the
//                  200,965 parameters of the bench's net are ~200 blocks, more than one wave
//                  of 132 SMs; every thread issues its loads of g, p, m and v (float4 where
//                  all four lie on 16 B) before any arithmetic, and computes the clip scale
//                  from the squares itself after its loads: no serial prologue, no barrier.
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
#include <stdint.h>

#include <type_traits>

#define THREADS PPO_THREADS
#define BWD_THREADS PPO_BWD_THREADS
#define CHUNK PPO_CHUNK
#define ADAM_CHUNK PPO_ADAM_CHUNK
#define MAX_TENSORS PPO_MAX_TENSORS
#define MAX_ACTIONS PPO_MAX_ACTIONS
#define N_METRICS 5

constexpr int WARPS = THREADS / 32;
constexpr int LOADS = CHUNK / (4 * THREADS);  // float4 loads a thread of grad_sq_norms makes
constexpr int STAGED = 4 * THREADS;     // partials the norms' last block stages in shared memory
constexpr int ADAM_VEC = ADAM_CHUNK / (4 * THREADS);  // float4 of each array a thread of clip_adam

static_assert(THREADS % 32 == 0 && (WARPS & (WARPS - 1)) == 0 && WARPS <= 32,
              "whole warps, a power of two of them");
static_assert(BWD_THREADS % 32 == 0, "ppo_loss_bwd's blocks are whole warps");
static_assert(MAX_ACTIONS == 32, "with_lanes instantiates P = 1, 2, 4, ..., 32");
static_assert(MAX_TENSORS <= 32, "NormTable::aligned holds a bit per tensor");
static_assert(CHUNK % (4 * THREADS) == 0, "a chunk is whole float4 loads of every thread");
static_assert(ADAM_CHUNK % (4 * THREADS) == 0, "clip_adam's chunk is whole float4 loads too");

namespace {

// The sums over the block of K float64 per thread, each in a fixed order: a shuffle tree in
// every warp, the K trees interleaved, then warp 0's tree over the warps' sums. Valid in
// thread 0. Every thread calls it; between two calls a barrier (last_block's) must pass.
template <int K>
__device__ __forceinline__ void block_sums(double (&s)[K]) {
  __shared__ double warp_sums[K][WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) warp_sums[k][warp] = s[k];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = lane < WARPS ? warp_sums[k][lane] : 0.0;
#pragma unroll
    for (int off = WARPS / 2; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
  }
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

// A row's four packed columns.
struct Cols {
  float action, logp_old, adv, ret;
};

// PACKED: the columns lie side by side at one stride, the first on 16 B (the launcher
// checks), so one float4 load reads all four; else four loads, each at its own stride.
template <bool PACKED>
__device__ __forceinline__ Cols load_cols(const HeadIn& in, int i) {
  if (PACKED) {
    const float4 c = *reinterpret_cast<const float4*>(in.action + (long long)i * in.s_action);
    return {c.x, c.y, c.z, c.w};
  }
  return {in.action[(long long)i * in.s_action], in.logp_old[(long long)i * in.s_logp],
          in.adv[(long long)i * in.s_adv], in.ret[(long long)i * in.s_ret]};
}

// A row's A logits, padded with zeros to P (the padding is never read as a logit).
template <int P>
__device__ __forceinline__ void load_logits(const HeadIn& in, int i, float (&x)[P]) {
  const float* row = in.logits + (long long)i * in.n_actions;
#pragma unroll
  for (int j = 0; j < P; ++j) x[j] = j < in.n_actions ? row[j] : 0.0f;
}

__host__ __device__ constexpr int log2_of(int p) { return p <= 1 ? 0 : 1 + log2_of(p / 2); }

// One row's forward values, as the plain path computes them; lp[j] for j < A.
template <int P>
struct RowFwd {
  float lp[P];  // log_softmax(logits)
  int a;
  float logp, logp_old, adv, ratio, surr1, surr2, min_surr, dual, obj;
};

// P = lanes(A) (below): every loop runs over the constant P, so the arrays stay in registers.
template <int P>
__device__ __forceinline__ void row_forward(const HeadIn& in, const float (&x)[P], const Cols& c,
                                            RowFwd<P>& r) {
  const int A = in.n_actions;
  float mx = x[0];
#pragma unroll
  for (int j = 1; j < P; ++j)
    if (j < A) mx = mx > x[j] ? mx : x[j];
  float e[P];
#pragma unroll
  for (int j = 0; j < P; ++j) e[j] = j < A ? expf(x[j] - mx) : 0.0f;
#pragma unroll
  for (int level = 0; level < log2_of(P); ++level)  // off = P/2, P/4, ..., 1
#pragma unroll
    for (int l = 0; l < P / 2; ++l)
      if (l < (P >> (level + 1))) e[l] = e[l] + e[l + (P >> (level + 1))];
  const float lsum = logf(e[0]);
#pragma unroll
  for (int j = 0; j < P; ++j) r.lp[j] = (x[j] - mx) - lsum;

  r.a = (int)c.action;  // .long() truncates, as here
  r.logp = __int_as_float(0x7fc00000);  // the gather: NaN where the action is out of range
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j < A && j == r.a) r.logp = r.lp[j];
  r.logp_old = c.logp_old;
  r.adv = c.adv;
  r.ratio = expf(r.logp - r.logp_old);
  r.surr1 = r.ratio * r.adv;
  const float clamped = fminf(fmaxf(r.ratio, in.lo), in.hi);
  r.surr2 = clamped * r.adv;
  r.min_surr = fminf(r.surr1, r.surr2);
  r.dual = in.dual_clip * r.adv;
  r.obj = r.adv < 0.0f ? fmaxf(r.min_surr, r.dual) : r.min_surr;
}

// The loss and its five metrics from the five sums over the rows.
__device__ void head_out(const HeadIn& in, const double (&sum)[N_METRICS], float* out) {
  float mean[N_METRICS];
#pragma unroll
  for (int k = 0; k < N_METRICS; ++k) mean[k] = (float)sum[k] * in.inv_n;
  const float policy_loss = -mean[0];
  const float value_loss = in.value_coef * mean[1];
  out[0] = (policy_loss + value_loss) - in.entropy_coef * mean[2];
  out[1] = policy_loss;
  out[2] = value_loss;
  out[3] = mean[2];
  out[4] = mean[3];
  out[5] = mean[4];
}

// out = [loss, policy_loss, value_loss, entropy, clip_frac, approx_kl]; one row per thread.
// A grid of one block finishes in place; a larger one writes each block's five sums to
// partials, and the last block to finish sums them.
template <int P, bool PACKED>
__global__ void __launch_bounds__(THREADS) ppo_loss_fwd(HeadIn in, float* out, double* partials,
                                                        unsigned int* ticket) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  double s[N_METRICS] = {0.0, 0.0, 0.0, 0.0, 0.0};  // obj, sq err, entropy, clipped, kl
  if (i < in.n) {
    const Cols c = load_cols<PACKED>(in, i);
    float x[P];
    load_logits<P>(in, i, x);
    const float v = in.values[i];
    RowFwd<P> r;
    row_forward<P>(in, x, c, r);
    const float d = v - c.ret;
    float ent = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < in.n_actions) ent = ent + expf(r.lp[j]) * r.lp[j];
    s[0] = r.obj;
    s[1] = d * d;
    s[2] = -ent;
    s[3] = (r.ratio < in.lo) | (r.ratio > in.hi) ? 1.0 : 0.0;
    s[4] = r.logp_old - r.logp;
  }
  block_sums<N_METRICS>(s);
  if (gridDim.x == 1) {  // one block finishes in place
    if (threadIdx.x == 0) head_out(in, s, out);
    return;
  }
  if (threadIdx.x == 0)
#pragma unroll
    for (int k = 0; k < N_METRICS; ++k) partials[blockIdx.x * N_METRICS + k] = s[k];
  if (!last_block(ticket)) return;
#pragma unroll
  for (int k = 0; k < N_METRICS; ++k) s[k] = 0.0;  // every block's sums, at once, in one reduction
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
#pragma unroll
    for (int k = 0; k < N_METRICS; ++k) s[k] += __ldcg(partials + b * N_METRICS + k);
  block_sums<N_METRICS>(s);
  if (threadIdx.x == 0) head_out(in, s, out);
}

// A row of P floats (A == P) as one vector: a float2 for P = 2, P / 4 float4 from P = 4 up.
// The row lies on 4 * P bytes (the launcher checks).
template <int P>
__device__ __forceinline__ void load_row(const float* row, float (&x)[P]) {
  static_assert(P >= 2, "a row of one float is one scalar");
  if constexpr (P == 2) {
    const float2 v = *reinterpret_cast<const float2*>(row);
    x[0] = v.x;
    x[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(row)[q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  }
}

template <int P>
__device__ __forceinline__ void store_row(float* row, const float (&x)[P]) {
  static_assert(P >= 2, "a row of one float is one scalar");
  if constexpr (P == 2) {
    *reinterpret_cast<float2*>(row) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int q = 0; q < P / 4; ++q)
      reinterpret_cast<float4*>(row)[q] =
          make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  }
}

// The gradient of the loss, times *grad_out, with respect to logits and values; autograd's
// chain for the plain loss, node by node, one row per thread, BWD_THREADS a block (16,384 rows
// are 128 blocks, about one wave of 132 SMs). As the forward: every loop runs over the constant
// P with `j < A` guards and the butterfly over log2(P) constant levels, so the row's arrays stay
// in registers at every P; the gather is a select; PACKED reads the four columns as one float4.
// ROW_VECTORS (A == P >= 2, both rows on 4 * P bytes) moves the logits and dlogits rows as
// vectors, else as scalars. Each value keeps the operations, and their order, that autograd's
// nodes apply (build with -fmad=false). One block an SM at least is all the launch bounds ask:
// with the thread count alone, ptxas held P = 32 to 80 registers and spilled.
template <int P, bool PACKED, bool ROW_VECTORS>
__global__ void __launch_bounds__(BWD_THREADS, 1) ppo_loss_bwd(HeadIn in, const float* grad_out,
                                                               float* dlogits, float* dvalues) {
  const int i = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (i >= in.n) return;
  const float g = *grad_out;
  const int A = in.n_actions;
  float x[P];
  if constexpr (ROW_VECTORS)
    load_row<P>(in.logits + (long long)i * P, x);
  else
    load_logits<P>(in, i, x);
  const Cols c = load_cols<PACKED>(in, i);
  const float v = in.values[i];
  RowFwd<P> r;
  row_forward<P>(in, x, c, r);

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
  float p[P], G[P], S[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    p[j] = j < A ? expf(r.lp[j]) : 0.0f;
    const float through_exp = g_t * p[j] + (g_t * r.lp[j]) * p[j];  // through mul, then exp
    G[j] = j < A ? (j == r.a ? through_exp + g_logp : through_exp) : 0.0f;  // through gather
    S[j] = G[j];
  }
#pragma unroll
  for (int level = 0; level < log2_of(P); ++level)  // off = P/2, P/4, ..., 1
#pragma unroll
    for (int l = 0; l < P / 2; ++l)
      if (l < (P >> (level + 1))) S[l] = S[l] + S[l + (P >> (level + 1))];
  float out[P];
#pragma unroll
  for (int j = 0; j < P; ++j) out[j] = fmaf(-p[j], S[0], G[j]);  // log_softmax's backward
  if constexpr (ROW_VECTORS) {
    store_row<P>(dlogits + (long long)i * P, out);
  } else {
    float* row = dlogits + (long long)i * A;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < A) row[j] = out[j];
  }

  // value: value_coef * mean((v - ret)^2)
  const float d = v - c.ret;
  dvalues[i] = ((g * in.value_coef) * in.inv_n) * (2.0f * d);
}

// ---- the multi-tensor kernels ---------------------------------------------------------

struct NormTable {
  const float* g[MAX_TENSORS];
  long long numel[MAX_TENSORS];
  int chunk_start[MAX_TENSORS + 1];  // block b works on tensor k where start[k] <= b < start[k+1]
  unsigned int aligned;               // bit k: g[k] lies on 16 B, so it loads as float4
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
  int chunk_start[MAX_TENSORS + 1];  // in ADAM_CHUNK chunks
  unsigned int aligned;  // bit k: p, g, m and v of tensor k all lie on 16 B (float4 loads)
  int n;
};

struct AdamScalars {
  const float* sq;  // [n_sq] squared norms of every gradient tensor of the step
  // null, or the (step_size, bc2) of every tensor of the table, on the card: a launch
  // captured into a CUDA graph reads its step's terms there, filled before each replay,
  // where the table's own values would be frozen at their capture
  const float* terms;
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

__device__ __forceinline__ double sq4(const float4 v) {
  const double x = v.x, y = v.y, z = v.z, w = v.w;
  return ((x * x + y * y) + z * z) + w * w;
}

// Each block sums the squares of its chunk in float64 (the float4 loads of an aligned tensor
// all issued before the sum, then its numel % 4 tail, or an unaligned tensor, one float at a
// time); the last block sums each tensor's partials: all staged in shared memory by all
// threads at once, then a warp per tensor, each lane over every 32nd partial, a shuffle tree.
__global__ void __launch_bounds__(THREADS) grad_sq_norms(NormTable t, float* sq, double* partials,
                                                         unsigned int* ticket) {
  const int k = tensor_of(t.chunk_start, t.n);
  const long long begin = (long long)(blockIdx.x - t.chunk_start[k]) * CHUNK;
  const int len = (int)min((long long)CHUNK, t.numel[k] - begin);
  const float* g = t.g[k] + begin;
  double acc[1] = {0.0};
  int tail = 0;
  if ((t.aligned >> k) & 1u) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const int n4 = len >> 2;
    float4 v[LOADS];
#pragma unroll
    for (int r = 0; r < LOADS; ++r) {
      const int q = threadIdx.x + r * THREADS;
      v[r] = q < n4 ? g4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int r = 0; r < LOADS; ++r) acc[0] += sq4(v[r]);
    tail = n4 << 2;
  }
  for (int e = tail + threadIdx.x; e < len; e += THREADS) {
    const double x = g[e];
    acc[0] += x * x;
  }
  block_sums<1>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
  if (!last_block(ticket)) return;

  __shared__ double staged[STAGED];
  const int chunks = t.chunk_start[t.n];
#pragma unroll
  for (int r = 0; r < STAGED / THREADS; ++r) {
    const int c = threadIdx.x + r * THREADS;
    if (c < chunks) staged[c] = __ldcg(partials + c);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < t.n; j += WARPS) {
    double total = 0.0;
    for (int c = t.chunk_start[j] + lane; c < t.chunk_start[j + 1]; c += 32)
      total += c < STAGED ? staged[c] : __ldcg(partials + c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) total += __shfl_down_sync(0xffffffffu, total, off);
    if (lane == 0) sq[j] = (float)total;
  }
}

// The clip scale from the squares: their float64 sum in order j = 0, 1, ..., n_sq - 1 (all
// loads of a group of 32 issued before its adds), the norm rounded to float32 once, then
// where(norm < max, 1, max / norm) with max / norm as reciprocal(norm) * max.
__device__ __forceinline__ float clip_scale(const AdamScalars& s) {
  double total = 0.0;
  for (int j0 = 0; j0 < s.n_sq; j0 += 32) {
    float q[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) q[j] = j0 + j < s.n_sq ? __ldg(s.sq + j0 + j) : 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      if (j0 + j < s.n_sq) total += q[j];
  }
  const float norm = (float)sqrt(total);
  return norm < s.max_norm ? 1.0f : (1.0f / norm) * s.max_norm;
}

// torch.optim.Adam's step of one element with the clipped gradient, op for op as the plain
// path rounds it.
__device__ __forceinline__ void adam_element(float g, float& p, float& m, float& v, float scale,
                                             const AdamScalars& s, float step_size, float bc2) {
  const float gc = g * scale;                                 // _foreach_mul_(grads, scale)
  const float m1 = fmaf(s.lerp_weight, gc - m, m);            // exp_avg.lerp_(g, 1 - b1)
  const float v1 = fmaf(s.one_minus_beta2, gc * gc, v * s.beta2);  // mul_, addcmul_
  const float root = sqrtf(v1);
  const float denom = (s.divide ? root / bc2 : root * bc2) + s.eps;
  p = fmaf(step_size, m1 / denom, p);                         // addcdiv_(m, denom, -ss)
  m = m1;
  v = v1;
}

__device__ __forceinline__ void adam4(const float4 g, float4& p, float4& m, float4& v,
                                      float scale, const AdamScalars& s, float step_size,
                                      float bc2) {
  adam_element(g.x, p.x, m.x, v.x, scale, s, step_size, bc2);
  adam_element(g.y, p.y, m.y, v.y, scale, s, step_size, bc2);
  adam_element(g.z, p.z, m.z, v.z, scale, s, step_size, bc2);
  adam_element(g.w, p.w, m.w, v.w, scale, s, step_size, bc2);
}

// One chunk of ADAM_CHUNK elements of one tensor per block. Every thread issues all of its
// loads (ADAM_VEC float4 of each of g, p, m and v where the tensor's four arrays lie on
// 16 B; else 4 * ADAM_VEC floats of each) before any arithmetic; the clip scale is computed
// in every thread after its loads are in flight, so no barrier and no serial prologue sits
// before them; then the arithmetic and the stores, float4 where the loads were.
__global__ void __launch_bounds__(THREADS) clip_adam(AdamTable t, AdamScalars s) {
  const int k = tensor_of(t.chunk_start, t.n);
  const long long begin = (long long)(blockIdx.x - t.chunk_start[k]) * ADAM_CHUNK;
  const int len = (int)min((long long)ADAM_CHUNK, t.numel[k] - begin);
  float* p = t.p[k] + begin;
  float* m = t.m[k] + begin;
  float* v = t.v[k] + begin;
  const float* g = t.g[k] + begin;
  const float step_size = s.terms ? __ldg(s.terms) : t.step_size[k];
  const float bc2 = s.terms ? __ldg(s.terms + 1) : t.bc2[k];
  if ((t.aligned >> k) & 1u) {
    const int n4 = len >> 2;
    float4 G[ADAM_VEC], P[ADAM_VEC], M[ADAM_VEC], V[ADAM_VEC];
#pragma unroll
    for (int r = 0; r < ADAM_VEC; ++r) {
      const int q = threadIdx.x + r * THREADS;
      if (q < n4) {
        G[r] = reinterpret_cast<const float4*>(g)[q];
        P[r] = reinterpret_cast<const float4*>(p)[q];
        M[r] = reinterpret_cast<const float4*>(m)[q];
        V[r] = reinterpret_cast<const float4*>(v)[q];
      }
    }
    // the numel % 4 tail of the tensor's last chunk, one float a thread
    const int e = (n4 << 2) + threadIdx.x;
    const bool tail = e < len;
    float tg = 0.0f, tp = 0.0f, tm = 0.0f, tv = 0.0f;
    if (tail) {
      tg = g[e];
      tp = p[e];
      tm = m[e];
      tv = v[e];
    }
    const float scale = clip_scale(s);
#pragma unroll
    for (int r = 0; r < ADAM_VEC; ++r) {
      const int q = threadIdx.x + r * THREADS;
      if (q < n4) {
        adam4(G[r], P[r], M[r], V[r], scale, s, step_size, bc2);
        reinterpret_cast<float4*>(p)[q] = P[r];
        reinterpret_cast<float4*>(m)[q] = M[r];
        reinterpret_cast<float4*>(v)[q] = V[r];
      }
    }
    if (tail) {
      adam_element(tg, tp, tm, tv, scale, s, step_size, bc2);
      p[e] = tp;
      m[e] = tm;
      v[e] = tv;
    }
  } else {
    constexpr int SCALARS = 4 * ADAM_VEC;
    float G[SCALARS], P[SCALARS], M[SCALARS], V[SCALARS];
#pragma unroll
    for (int r = 0; r < SCALARS; ++r) {
      const int e = threadIdx.x + r * THREADS;
      if (e < len) {
        G[r] = g[e];
        P[r] = p[e];
        M[r] = m[e];
        V[r] = v[e];
      }
    }
    const float scale = clip_scale(s);
#pragma unroll
    for (int r = 0; r < SCALARS; ++r) {
      const int e = threadIdx.x + r * THREADS;
      if (e < len) {
        adam_element(G[r], P[r], M[r], V[r], scale, s, step_size, bc2);
        p[e] = P[r];
        m[e] = M[r];
        v[e] = V[r];
      }
    }
  }
}

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }
inline int bwd_blocks(int n) { return (n + BWD_THREADS - 1) / BWD_THREADS; }

// chunk_start[0..n] from the tensors' sizes in chunks of `chunk`; returns the number of
// chunks (blocks).
inline int chunk_table(const long long* numel, int n, int* chunk_start, int chunk) {
  int c = 0;
  for (int k = 0; k < n; ++k) {
    chunk_start[k] = c;
    c += (int)((numel[k] + chunk - 1) / chunk);
  }
  chunk_start[n] = c;
  return c;
}

// The padded row width: the next power of two of A, the lanes over which PyTorch's warp
// softmax sums a row.
constexpr int lanes(int n_actions) {
  int p = 1;
  while (p < n_actions) p <<= 1;
  return p;
}

// f(std::integral_constant<int, lanes(n_actions)>{}): the loss kernels' instantiation for
// 1 <= n_actions <= MAX_ACTIONS.
template <class F>
void with_lanes(int n_actions, F&& f) {
  switch (lanes(n_actions)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
  }
}

// Whether the four columns lie side by side at one stride with the first on 16 B: then
// every row's four are one aligned float4.
bool columns_packed(const HeadIn& in) {
  return in.s_logp == in.s_action && in.s_adv == in.s_action && in.s_ret == in.s_action &&
         in.logp_old == in.action + 1 && in.adv == in.action + 2 && in.ret == in.action + 3 &&
         reinterpret_cast<uintptr_t>(in.action) % 16 == 0 && in.s_action % 4 == 0;
}

// Whether ppo_loss_bwd may move each row of logits and dlogits as one vector: A is its own
// padded width (a power of two, at least 2) and both arrays lie on 4 * A bytes, so every row does.
bool rows_on_vectors(const float* logits, const float* dlogits, int n_actions) {
  const uintptr_t width = 4u * (unsigned int)n_actions;
  return n_actions >= 2 && lanes(n_actions) == n_actions &&
         reinterpret_cast<uintptr_t>(logits) % width == 0 &&
         reinterpret_cast<uintptr_t>(dlogits) % width == 0;
}

}  // namespace

// Launchers with a plain C interface (bound with ctypes). Each makes `device`, the card
// that holds the tensors and the stream, current in this library's own CUDA runtime
// (linked statically) before it launches, and returns the cudaError_t: 0, or the error
// that refused the device or the launch. Host arrays (the tables) are read here, on the
// host, and reach the kernel by value.
// `packed` asks for the float4 column loads; refused (cudaErrorInvalidValue) unless the
// columns are packed. out: f32[6], the loss and the five metrics; partials (5 float64 a
// block) and ticket are read only when n > THREADS.
extern "C" int ppo_loss_fwd_launch(
    const float* logits, const float* values, const float* action, const float* logp_old,
    const float* adv, const float* ret, float* out, double* partials, unsigned int* ticket,
    int n, int n_actions, int s_action, int s_logp, int s_adv, int s_ret, int packed, float lo,
    float hi, float dual_clip, float value_coef, float entropy_coef, float inv_n, int device,
    cudaStream_t stream) {
  if (n <= 0 || n_actions <= 0 || n_actions > MAX_ACTIONS) return (int)cudaErrorInvalidValue;
  const HeadIn in{logits, values, action, logp_old, adv, ret, n, n_actions, s_action, s_logp,
                  s_adv, s_ret, lo, hi, dual_clip, value_coef, entropy_coef, inv_n};
  if (packed && !columns_packed(in)) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  with_lanes(n_actions, [&](auto p) {
    constexpr int P = decltype(p)::value;
    if (packed)
      ppo_loss_fwd<P, true><<<blocks(n), THREADS, 0, stream>>>(in, out, partials, ticket);
    else
      ppo_loss_fwd<P, false><<<blocks(n), THREADS, 0, stream>>>(in, out, partials, ticket);
  });
  return (int)cudaGetLastError();
}

// `packed` as for the forward; `row_vectors` asks for the vector row loads and stores, refused
// (cudaErrorInvalidValue) unless rows_on_vectors holds.
extern "C" int ppo_loss_bwd_launch(
    const float* logits, const float* values, const float* action, const float* logp_old,
    const float* adv, const float* ret, const float* grad_out, float* dlogits, float* dvalues,
    int n, int n_actions, int s_action, int s_logp, int s_adv, int s_ret, int packed,
    int row_vectors, float lo, float hi, float dual_clip, float value_coef, float entropy_coef,
    float inv_n, int device, cudaStream_t stream) {
  if (n <= 0 || n_actions <= 0 || n_actions > MAX_ACTIONS) return (int)cudaErrorInvalidValue;
  const HeadIn in{logits, values, action, logp_old, adv, ret, n, n_actions, s_action, s_logp,
                  s_adv, s_ret, lo, hi, dual_clip, value_coef, entropy_coef, inv_n};
  if (packed && !columns_packed(in)) return (int)cudaErrorInvalidValue;
  if (row_vectors && !rows_on_vectors(logits, dlogits, n_actions))
    return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  with_lanes(n_actions, [&](auto p) {
    constexpr int P = decltype(p)::value;
    if constexpr (P >= 2) {
      if (row_vectors) {
        if (packed)
          ppo_loss_bwd<P, true, true><<<bwd_blocks(n), BWD_THREADS, 0, stream>>>(
              in, grad_out, dlogits, dvalues);
        else
          ppo_loss_bwd<P, false, true><<<bwd_blocks(n), BWD_THREADS, 0, stream>>>(
              in, grad_out, dlogits, dvalues);
        return;
      }
    }
    if (packed)
      ppo_loss_bwd<P, true, false><<<bwd_blocks(n), BWD_THREADS, 0, stream>>>(in, grad_out,
                                                                            dlogits, dvalues);
    else
      ppo_loss_bwd<P, false, false><<<bwd_blocks(n), BWD_THREADS, 0, stream>>>(in, grad_out,
                                                                             dlogits, dvalues);
  });
  return (int)cudaGetLastError();
}

// aligned[k] != 0: grads[k] lies on 16 bytes and is read with float4 loads (refused if not).
extern "C" int grad_sq_norms_launch(const float* const* grads, const long long* numels,
                                    const int* aligned, int n_tensors, float* sq,
                                    double* partials, unsigned int* ticket, int device,
                                    cudaStream_t stream) {
  if (n_tensors <= 0 || n_tensors > MAX_TENSORS) return (int)cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  NormTable t{};
  t.n = n_tensors;
  for (int k = 0; k < n_tensors; ++k) {
    t.g[k] = grads[k];
    t.numel[k] = numels[k];
    if (!aligned[k]) continue;
    if (reinterpret_cast<uintptr_t>(grads[k]) % 16 != 0) return (int)cudaErrorInvalidValue;
    t.aligned |= 1u << k;
  }
  const int chunks = chunk_table(t.numel, n_tensors, t.chunk_start, CHUNK);
  if (chunks <= 0) return (int)cudaErrorInvalidValue;
  grad_sq_norms<<<chunks, THREADS, 0, stream>>>(t, sq, partials, ticket);
  return (int)cudaGetLastError();
}

// aligned[k] != 0: params[k], grads[k], exp_avgs[k] and exp_avg_sqs[k] all lie on 16 bytes and
// are read and written as float4 (refused if one does not). device_terms: null (each tensor's
// step_sizes[k] and bc2_terms[k] reach the kernel by value), or a (step_size, bc2) pair on the
// card for every tensor, which the kernel reads when it runs (a launch captured into a graph).
extern "C" int clip_adam_launch(
    float* const* params, const float* const* grads, float* const* exp_avgs,
    float* const* exp_avg_sqs, const long long* numels, const float* step_sizes,
    const float* bc2_terms, const float* device_terms, const int* aligned, int n_tensors,
    const float* sq, int n_sq,
    float max_norm, float lerp_weight, float beta2, float one_minus_beta2, float eps, int divide,
    int device, cudaStream_t stream) {
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
    if (!aligned[k]) continue;
    const uintptr_t any = reinterpret_cast<uintptr_t>(params[k]) |
                          reinterpret_cast<uintptr_t>(grads[k]) |
                          reinterpret_cast<uintptr_t>(exp_avgs[k]) |
                          reinterpret_cast<uintptr_t>(exp_avg_sqs[k]);
    if (any % 16 != 0) return (int)cudaErrorInvalidValue;
    t.aligned |= 1u << k;
  }
  const int chunks = chunk_table(t.numel, n_tensors, t.chunk_start, ADAM_CHUNK);
  if (chunks <= 0) return (int)cudaErrorInvalidValue;
  const AdamScalars s{sq, device_terms, n_sq, max_norm, lerp_weight,
                      beta2, one_minus_beta2, eps, divide};
  clip_adam<<<chunks, THREADS, 0, stream>>>(t, s);
  return (int)cudaGetLastError();
}
