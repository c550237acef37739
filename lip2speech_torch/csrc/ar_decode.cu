// Free-running autoregressive mel decode, all steps in one launch (sm_90a).
//
// Replaces the Pallas TPU kernel lip2speech_tpu/ops/pallas_decoder.py
// (_make_kernel, :47-138; wrapper pallas_ar_decode, :154-247) and computes
// the same function in the same output layout: mels (M, B, n_mels), stop
// logits (M, B, 1) and attention weights (M, B, T), f32. Each step runs the
// prenet, the attention query, softmax attention over the T encoder keys,
// the attention projection, content attention over the S codebook slots
// (queried by the CELL states), two LSTM cells (gates i, f, g, o), fc_out
// (the next input frame) and the stop logit from [h1, encoder_cell].
// State (h, c, ys) is f32 as in the Pallas kernel; matrix inputs are rounded
// to the weight type before each product, products accumulate in f32.
//
// What bounds it on an H100: the 300 steps are strictly sequential and each
// step is six dependent stages of small products over ~5.25 M weights
// (10.5 MB in bf16). At small batch the time is latency (stage count x
// barrier + L2 round trips); at B=256 it is ~2.7 GFLOP of f32 FMA per step.
// The design keeps everything in one cooperative launch: the grid stays
// resident for all steps, the weights stay in device memory where the 50 MB
// L2 holds them across steps, and a grid-wide barrier separates the six
// stages. Stage work is split into tiles of (BT batch rows x 32 output
// columns); a block takes tiles round-robin. A tile stages its BT input rows
// in shared memory, each warp reduces one slice of K for 32 columns (one per
// lane, coalesced weight reads), and the warps' partial sums are added in
// shared memory. LSTM weight columns are permuted on the host so one tile
// holds the four gates of 8 hidden units: the cell update needs no extra
// barrier. No tensor cores, TMA or warp specialisation yet.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface (lip2speech_torch/kernels/ar_decode.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int NT = 32;  // output columns per tile: one per lane
constexpr int kErrNoCooperativeLaunch = 10001;
constexpr int kErrNoOccupancy = 10002;
constexpr int kErrBadShape = 10003;
constexpr int kNumPtrs = 35;
constexpr int kNumDims = 8;

struct Params {
  int B, T, S, F, L, NM, M;
  const float* h_init;  // (2, B, F)
  const void* k;        // (B, T, F) weight type
  const void* v;        // (B, T, F)
  const void* ck;       // (B, S, L)
  const void* cv;       // (B, S, L)
  const float* ec;      // (B, F) encoder cell projection
  const float* bos;     // (B, NM)
  const float* pos;     // (M, F)
  const void* w_pre0; const float* b_pre0; const float* s_pre0;  // (NM, F/2)
  const void* w_pre1; const float* b_pre1; const float* s_pre1;  // (F/2, F/2)
  const void* w_q; const float* b_q; const float* s_q;           // (2F, F)
  const void* w_attn; const float* b_attn;                       // (F, F/2)
  const void* w_cq; const float* b_cq;                           // (2F, L)
  const void* w_l0; const float* b_l0;  // (2F, 4F), [wx; wh], columns permuted
  const void* w_l1; const float* b_l1;
  const void* w_out; const float* b_out;    // (F, NM)
  const void* w_stop; const float* b_stop;  // (2F, 1)
  const float* temps;                       // [attention, content]
  float* mel;    // (M, B, NM)
  float* stop;   // (M, B)
  float* attn;   // (M, B, T)
  float* scratch;
  unsigned int* barrier;  // 3 zeroed words: arrivals, generation, timeout flag
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }

// per-warp shared floats of the attention stage: the scaled query, then scores
__host__ __device__ inline int warp_floats(const Params& p) {
  const int q = p.F > p.L ? p.F : p.L;
  const int s = p.T > p.S ? p.T : p.S;
  return q + round_up(s, 32);
}

__host__ __device__ inline int max_k(const Params& p) {
  return round_up(2 * p.F > p.NM ? 2 * p.F : p.NM, 4);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// a product's input is rounded to the weight type, as the Pallas kernel's
// _dot casts x to w.dtype
template <typename WT>
__device__ __forceinline__ float round_to(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Grid-wide barrier. The launch is cooperative, so every block is resident.
// A wait longer than ~4 s sets a flag and releases every later barrier at
// once: a fault then ends the launch with wrong outputs instead of a hang.
__device__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    volatile unsigned int* timed_out = bar + 2;
    const unsigned int my_gen = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long start = clock64();
      while (*gen == my_gen && !*timed_out) {
        __nanosleep(32);
        if (clock64() - start > (1ll << 33)) *timed_out = 1u;
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// One (BT x NT) tile of X @ W with X = [xa | xb] (B x (ka + kb), f32, written
// by this launch, so read through L2) and W ((ka + kb) x n, row-major).
// Returns the tile sums in shared memory, red[r * NT + c], and the tile's
// first row and column.
template <typename WT, int BT>
__device__ const float* gemm_tile(const float* xa, int lda, int ka, const float* xb,
                                  int ldb, int kb, const WT* __restrict__ w, int n,
                                  int B, int tile, float* smem, int& row0, int& col0) {
  const int K = ka + kb;
  const int Kp = round_up(K, 4);
  const int nct = cdiv(n, NT);
  row0 = (tile / nct) * BT;
  col0 = (tile % nct) * NT;
  float* xs = smem;             // [BT][Kp]
  float* red = smem + BT * Kp;  // [kWarps][BT][NT]

  __syncthreads();  // the block's previous user of shared memory is done
  for (int idx = threadIdx.x; idx < BT * Kp; idx += kThreads) {
    const int r = idx / Kp, k = idx - r * Kp, row = row0 + r;
    float x = 0.f;
    if (row < B && k < K)
      x = k < ka ? __ldcg(xa + (size_t)row * lda + k) : __ldcg(xb + (size_t)row * ldb + (k - ka));
    xs[idx] = round_to<WT>(x);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = col0 + lane;
  float acc[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = 0.f;
  if (col < n) {
#pragma unroll 2
    for (int k = warp * 4; k < K; k += kWarps * 4) {
      const WT* wk = w + (size_t)k * n + col;
      const float w0 = to_f(wk[0]);
      const float w1 = k + 1 < K ? to_f(wk[n]) : 0.f;
      const float w2 = k + 2 < K ? to_f(wk[2 * n]) : 0.f;
      const float w3 = k + 3 < K ? to_f(wk[3 * n]) : 0.f;
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(xs + r * Kp + k);
        acc[r] = fmaf(x.x, w0, acc[r]);
        acc[r] = fmaf(x.y, w1, acc[r]);
        acc[r] = fmaf(x.z, w2, acc[r]);
        acc[r] = fmaf(x.w, w3, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) red[(warp * BT + r) * NT + lane] = acc[r];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BT * NT; idx += kThreads) {
    float s = 0.f;
    for (int g = 0; g < kWarps; ++g) s += red[g * BT * NT + idx];
    red[idx] = s;
  }
  __syncthreads();
  return red;
}

// Calls fn(row, col, sum) for every valid element of a finished tile.
template <int BT, typename Fn>
__device__ __forceinline__ void for_tile(const float* red, int row0, int col0, int B, int n,
                                         Fn fn) {
  for (int idx = threadIdx.x; idx < BT * NT; idx += kThreads) {
    const int r = idx / NT, c = idx - r * NT;
    const int row = row0 + r, col = col0 + c;
    if (row < B && col < n) fn(row, col, red[idx]);
  }
}

// One LSTM layer for all rows: gates = [x | h] @ w + bias; a tile's 32
// columns are gates i, f, g, o (8 columns each) of 8 consecutive units.
template <typename WT, int BT>
__device__ void lstm_stage(const float* x, const float* h, const WT* __restrict__ w,
                           const float* __restrict__ bias, float* c, float* h_out, int B,
                           int F, float* smem) {
  const int n_tiles = cdiv(B, BT) * (4 * F / NT);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int r0, c0;
    const float* red = gemm_tile<WT, BT>(x, F, F, h, F, F, w, 4 * F, B, t, smem, r0, c0);
    const int u0 = c0 / 4;
    for (int idx = threadIdx.x; idx < BT * 8; idx += kThreads) {
      const int r = idx >> 3, u = idx & 7, row = r0 + r;
      if (row >= B) continue;
      const float* g = red + r * NT;
      const float gi = g[u] + bias[c0 + u];
      const float gf = g[8 + u] + bias[c0 + 8 + u];
      const float gg = g[16 + u] + bias[c0 + 16 + u];
      const float go = g[24 + u] + bias[c0 + 24 + u];
      const size_t o = (size_t)row * F + u0 + u;
      const float cn = sigmoid(gf) * __ldcg(c + o) + sigmoid(gi) * tanhf(gg);
      c[o] = cn;
      h_out[o] = sigmoid(go) * tanhf(cn);
    }
  }
}

// Softmax attention for batch row b on one warp: encoder attention (writes
// the weights to attn[i] and the read to ob) and content attention (writes
// rnn_in[:, :L]). ws is the warp's shared scratch.
template <typename WT>
__device__ void attend_row(const Params& p, int i, int b, const float* qb, const float* cqb,
                           float* ob, float* rnn, float* ws) {
  const int lane = threadIdx.x & 31;
  const int T = p.T, F = p.F, S = p.S, L = p.L;
  const int qf = p.F > p.L ? p.F : p.L;
  float* qs = ws;
  float* sc = ws + qf;

  // encoder attention: the temperature scales q before the dot
  const WT* kb = static_cast<const WT*>(p.k) + (size_t)b * T * F;
  const WT* vb = static_cast<const WT*>(p.v) + (size_t)b * T * F;
  const float ta = p.temps[0];
  for (int f = lane; f < F; f += 32) qs[f] = __ldcg(qb + (size_t)b * F + f) * ta;
  __syncwarp();
  for (int t = 0; t < T; ++t) {
    float s = 0.f;
    for (int f = lane; f < F; f += 32) s = fmaf(qs[f], to_f(kb[(size_t)t * F + f]), s);
    s = warp_sum(s);
    if (lane == 0) sc[t] = s;
  }
  __syncwarp();
  float m = -INFINITY;
  for (int t = lane; t < T; t += 32) m = fmaxf(m, sc[t]);
  m = warp_max(m);
  float z = 0.f;
  for (int t = lane; t < T; t += 32) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    z += e;
  }
  z = warp_sum(z);
  float* attn_row = p.attn + ((size_t)i * p.B + b) * T;
  for (int t = lane; t < T; t += 32) {
    const float a = sc[t] / z;
    sc[t] = a;
    attn_row[t] = a;
  }
  __syncwarp();
  for (int f = lane; f < F; f += 32) {
    float o = 0.f;
    for (int t = 0; t < T; ++t) o = fmaf(sc[t], to_f(vb[(size_t)t * F + f]), o);
    ob[(size_t)b * F + f] = o;
  }
  __syncwarp();

  // content attention over the S slots
  const WT* ckb = static_cast<const WT*>(p.ck) + (size_t)b * S * L;
  const WT* cvb = static_cast<const WT*>(p.cv) + (size_t)b * S * L;
  const float tc = p.temps[1];
  for (int l = lane; l < L; l += 32) qs[l] = __ldcg(cqb + (size_t)b * L + l) * tc;
  __syncwarp();
  for (int s = 0; s < S; ++s) {
    float d = 0.f;
    for (int l = lane; l < L; l += 32) d = fmaf(qs[l], to_f(ckb[(size_t)s * L + l]), d);
    d = warp_sum(d);
    if (lane == 0) sc[s] = d;
  }
  __syncwarp();
  m = -INFINITY;
  for (int s = lane; s < S; s += 32) m = fmaxf(m, sc[s]);
  m = warp_max(m);
  z = 0.f;
  for (int s = lane; s < S; s += 32) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    z += e;
  }
  z = warp_sum(z);
  __syncwarp();
  for (int l = lane; l < L; l += 32) {
    float o = 0.f;
    for (int s = 0; s < S; ++s) o = fmaf(sc[s] / z, to_f(cvb[(size_t)s * L + l]), o);
    rnn[(size_t)b * F + l] = o;
  }
  __syncwarp();
}

template <typename WT, int BT>
__global__ void __launch_bounds__(kThreads) ar_decode_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, F = p.F, L = p.L, NM = p.NM, H = p.F / 2;
  const size_t BF = (size_t)B * F;
  float* hbuf = p.scratch;                // [2 parity][2 layer][B][F]
  float* cbuf = hbuf + 4 * BF;            // [2 layer][B][F]
  float* ys = cbuf + 2 * BF;              // [B][NM] last output frame
  float* pre0 = ys + (size_t)B * NM;      // [B][H]
  float* pre1 = pre0 + (size_t)B * H;     // [B][H]
  float* qb = pre1 + (size_t)B * H;       // [B][F] attention query
  float* cqb = qb + BF;                   // [B][L] content query
  float* ob = cqb + (size_t)B * L;        // [B][F] attention read
  float* rnn = ob + BF;                   // [B][F] [content_o | ys_mid]
  const WT* w_pre0 = static_cast<const WT*>(p.w_pre0);
  const WT* w_pre1 = static_cast<const WT*>(p.w_pre1);
  const WT* w_q = static_cast<const WT*>(p.w_q);
  const WT* w_attn = static_cast<const WT*>(p.w_attn);
  const WT* w_cq = static_cast<const WT*>(p.w_cq);
  const WT* w_l0 = static_cast<const WT*>(p.w_l0);
  const WT* w_l1 = static_cast<const WT*>(p.w_l1);
  const WT* w_out = static_cast<const WT*>(p.w_out);
  const WT* w_stop = static_cast<const WT*>(p.w_stop);
  const int RT = cdiv(B, BT);
  const int wf = warp_floats(p);

  // h <- encoder finals, c <- 0, ys <- BOS
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * kThreads;
  for (size_t idx = gtid; idx < 2 * BF; idx += gstride) {
    hbuf[idx] = p.h_init[idx];
    cbuf[idx] = 0.f;
  }
  for (size_t idx = gtid; idx < (size_t)B * NM; idx += gstride) ys[idx] = p.bos[idx];
  grid_barrier(p.barrier);

  for (int i = 0; i < p.M; ++i) {
    float* hc = hbuf + (size_t)(i & 1) * 2 * BF;        // h at the step's start
    float* hn = hbuf + (size_t)((i + 1) & 1) * 2 * BF;  // h at its end

    // 1. prenet0, attention query, content query
    {
      const int n0 = RT * cdiv(H, NT);
      const int n1 = n0 + RT * cdiv(F, NT);
      const int n2 = n1 + RT * cdiv(L, NT);
      const float* pos = p.pos + (size_t)i * F;
      for (int t = blockIdx.x; t < n2; t += gridDim.x) {
        int r0, c0;
        if (t < n0) {
          const float* red = gemm_tile<WT, BT>(ys, NM, NM, nullptr, 0, 0, w_pre0, H, B, t, smem, r0, c0);
          for_tile<BT>(red, r0, c0, B, H, [&](int row, int col, float acc) {
            pre0[(size_t)row * H + col] = sinf(acc + p.b_pre0[col]) * p.s_pre0[col];
          });
        } else if (t < n1) {
          const float* red = gemm_tile<WT, BT>(hc, F, F, hc + BF, F, F, w_q, F, B, t - n0, smem, r0, c0);
          for_tile<BT>(red, r0, c0, B, F, [&](int row, int col, float acc) {
            qb[(size_t)row * F + col] = sinf(acc + p.b_q[col]) * p.s_q[col] + pos[col];
          });
        } else {
          const float* red = gemm_tile<WT, BT>(cbuf, F, F, cbuf + BF, F, F, w_cq, L, B, t - n1, smem, r0, c0);
          for_tile<BT>(red, r0, c0, B, L, [&](int row, int col, float acc) {
            const float x = acc + p.b_cq[col];
            cqb[(size_t)row * L + col] = x * sigmoid(x);
          });
        }
      }
    }
    grid_barrier(p.barrier);

    // 2. prenet1; attention and content attention, one warp per batch row
    {
      const int n0 = RT * cdiv(H, NT);
      const int n1 = n0 + cdiv(B, kWarps);
      for (int t = blockIdx.x; t < n1; t += gridDim.x) {
        if (t < n0) {
          int r0, c0;
          const float* red = gemm_tile<WT, BT>(pre0, H, H, nullptr, 0, 0, w_pre1, H, B, t, smem, r0, c0);
          for_tile<BT>(red, r0, c0, B, H, [&](int row, int col, float acc) {
            pre1[(size_t)row * H + col] = sinf(acc + p.b_pre1[col]) * p.s_pre1[col];
          });
        } else {
          __syncthreads();  // shared memory may still hold this block's last tile
          const int warp = threadIdx.x >> 5;
          const int b = (t - n0) * kWarps + warp;
          if (b < B) attend_row<WT>(p, i, b, qb, cqb, ob, rnn, smem + warp * wf);
        }
      }
    }
    grid_barrier(p.barrier);

    // 3. attention projection + prenet -> rnn_in[:, L:]
    {
      const int n0 = RT * cdiv(H, NT);
      for (int t = blockIdx.x; t < n0; t += gridDim.x) {
        int r0, c0;
        const float* red = gemm_tile<WT, BT>(ob, F, F, nullptr, 0, 0, w_attn, H, B, t, smem, r0, c0);
        for_tile<BT>(red, r0, c0, B, H, [&](int row, int col, float acc) {
          rnn[(size_t)row * F + L + col] = __ldcg(pre1 + (size_t)row * H + col) + (acc + p.b_attn[col]);
        });
      }
    }
    grid_barrier(p.barrier);

    // 4. LSTM layer 0 on [rnn_in | h0]
    lstm_stage<WT, BT>(rnn, hc, w_l0, p.b_l0, cbuf, hn, B, F, smem);
    grid_barrier(p.barrier);

    // 5. LSTM layer 1 on [h0' | h1]
    lstm_stage<WT, BT>(hn, hc + BF, w_l1, p.b_l1, cbuf + BF, hn + BF, B, F, smem);
    grid_barrier(p.barrier);

    // 6. next frame (fc_out) and stop logit from [h1', encoder_cell]
    {
      const int n0 = RT * cdiv(NM, NT);
      const int n1 = n0 + RT;
      for (int t = blockIdx.x; t < n1; t += gridDim.x) {
        int r0, c0;
        if (t < n0) {
          const float* red = gemm_tile<WT, BT>(hn + BF, F, F, nullptr, 0, 0, w_out, NM, B, t, smem, r0, c0);
          for_tile<BT>(red, r0, c0, B, NM, [&](int row, int col, float acc) {
            const float y = acc + p.b_out[col];
            ys[(size_t)row * NM + col] = y;
            p.mel[((size_t)i * B + row) * NM + col] = y;
          });
        } else {
          const float* red = gemm_tile<WT, BT>(hn + BF, F, F, p.ec, F, F, w_stop, 1, B, t - n0, smem, r0, c0);
          for_tile<BT>(red, r0, c0, B, 1, [&](int row, int, float acc) {
            p.stop[(size_t)i * B + row] = acc + p.b_stop[0];
          });
        }
      }
    }
    grid_barrier(p.barrier);
  }
}

template <typename WT, int BT>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = ar_decode_kernel<WT, BT>;
  const int gemm_floats = BT * max_k(p) + kWarps * BT * NT;
  const int attn_floats = kWarps * warp_floats(p);
  const size_t smem = sizeof(float) * (size_t)(gemm_floats > attn_floats ? gemm_floats : attn_floats);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return kErrNoCooperativeLaunch;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return kErrNoOccupancy;
  const int grid = sms * (per_sm < 2 ? per_sm : 2);
  Params arg = p;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads), args,
                                  smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename WT>
int launch_for_batch(const Params& p, cudaStream_t stream) {
  if (p.B <= 1) return launch<WT, 1>(p, stream);
  if (p.B <= 2) return launch<WT, 2>(p, stream);
  if (p.B <= 4) return launch<WT, 4>(p, stream);
  if (p.B <= 8) return launch<WT, 8>(p, stream);
  if (p.B <= 16) return launch<WT, 16>(p, stream);
  return launch<WT, 32>(p, stream);
}

}  // namespace

extern "C" {

// Floats of f32 scratch the launch needs for these sizes.
long long ar_decode_scratch_floats(int B, int F, int L, int NM) {
  return (long long)B * (10LL * F + NM + L);
}

// ptrs: the kNumPtrs device pointers in Params order (h_init ... barrier);
// dims: B, T, S, F, L, NM, M, weights_are_bf16. Launches on `stream` and
// returns 0 or an error code for ar_decode_error_string.
int ar_decode_launch(void* const* ptrs, const int* dims, void* stream) {
  Params p;
  p.B = dims[0]; p.T = dims[1]; p.S = dims[2]; p.F = dims[3];
  p.L = dims[4]; p.NM = dims[5]; p.M = dims[6];
  const bool bf16 = dims[7] != 0;
  if (p.B < 1 || p.T < 1 || p.S < 1 || p.M < 1 || p.F % 8 != 0 || p.L + p.F / 2 != p.F)
    return kErrBadShape;
  int i = 0;
  p.h_init = static_cast<const float*>(ptrs[i++]);
  p.k = ptrs[i++]; p.v = ptrs[i++]; p.ck = ptrs[i++]; p.cv = ptrs[i++];
  p.ec = static_cast<const float*>(ptrs[i++]);
  p.bos = static_cast<const float*>(ptrs[i++]);
  p.pos = static_cast<const float*>(ptrs[i++]);
  p.w_pre0 = ptrs[i++]; p.b_pre0 = static_cast<const float*>(ptrs[i++]); p.s_pre0 = static_cast<const float*>(ptrs[i++]);
  p.w_pre1 = ptrs[i++]; p.b_pre1 = static_cast<const float*>(ptrs[i++]); p.s_pre1 = static_cast<const float*>(ptrs[i++]);
  p.w_q = ptrs[i++]; p.b_q = static_cast<const float*>(ptrs[i++]); p.s_q = static_cast<const float*>(ptrs[i++]);
  p.w_attn = ptrs[i++]; p.b_attn = static_cast<const float*>(ptrs[i++]);
  p.w_cq = ptrs[i++]; p.b_cq = static_cast<const float*>(ptrs[i++]);
  p.w_l0 = ptrs[i++]; p.b_l0 = static_cast<const float*>(ptrs[i++]);
  p.w_l1 = ptrs[i++]; p.b_l1 = static_cast<const float*>(ptrs[i++]);
  p.w_out = ptrs[i++]; p.b_out = static_cast<const float*>(ptrs[i++]);
  p.w_stop = ptrs[i++]; p.b_stop = static_cast<const float*>(ptrs[i++]);
  p.temps = static_cast<const float*>(ptrs[i++]);
  p.mel = static_cast<float*>(ptrs[i++]);
  p.stop = static_cast<float*>(ptrs[i++]);
  p.attn = static_cast<float*>(ptrs[i++]);
  p.scratch = static_cast<float*>(ptrs[i++]);
  p.barrier = static_cast<unsigned int*>(ptrs[i++]);
  if (i != kNumPtrs) return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_for_batch<__nv_bfloat16>(p, s) : launch_for_batch<float>(p, s);
}

int ar_decode_num_ptrs() { return kNumPtrs; }
int ar_decode_num_dims() { return kNumDims; }

const char* ar_decode_error_string(int code) {
  switch (code) {
    case kErrNoCooperativeLaunch: return "device does not support cooperative launch";
    case kErrNoOccupancy: return "kernel does not fit on one SM (shared memory or registers)";
    case kErrBadShape: return "unsupported shapes (need F % 8 == 0 and latent == F / 2)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
