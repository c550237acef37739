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
// State (c, the accumulators) is f32 as in the Pallas kernel; every product
// input is rounded to the weight type, so activations that only feed
// products (h, ys, the prenet output, the attention read, the LSTM input)
// are stored in that type.
//
// What bounds it on an H100: the 300 steps are strictly sequential, and
// each is a chain of small products over ~5.24 M weights (10.5 MB in
// bf16). At small batch the step time is latency: the grid barriers and
// the round trips that feed each stage. At B=256 it is ~2.7 GFLOP a step.
//
// The design, against that:
// - One cooperative launch of one block per SM runs every step. Every
//   matrix's output columns are split in contiguous runs over the blocks
//   (pack_ar_weights in the wrapper, which also writes the ownership table
//   this kernel reads). LSTM columns are owned by whole hidden units, so a
//   block finishes its units' cell updates without another barrier.
// - bf16 weights stay resident: each block copies its ~80 KB of slices
//   into shared memory once, before the first step. f32 weights (~21 MB)
//   do not fit; the same code then reads the slices through L2.
// - Five stages a step, each closed by one grid barrier:
//   (A) fc_out and stop of step i-1, the attention query and the content
//   query of step i (all read the LSTM outputs of step i-1);
//   (B) prenet0, attention, content attention; (C) prenet1 + attention
//   projection; (D) LSTM0; (E) LSTM1. The stop logit's encoder_cell part
//   is constant over the steps and is computed once before the loop.
// - A product stages row chunks of its input in shared memory with 16-byte
//   cp.async copies and splits K over the 8 warps, which add their partial
//   sums in shared memory. In bf16 each warp runs mma.sync m16n8k16 on
//   ldmatrix fragments (a block's 16 LSTM columns are two n8 tiles); in f32
//   it runs FMA over register tiles (1 or 4 rows x 4 or 2 column groups a
//   lane). An epilogue's own operand (the cell state, the position row) is
//   loaded before the product, so its latency hides behind it.
// - Attention takes a whole block per batch row, and content attention
//   another: lanes run over the keys, each reading its key's slice with
//   16-byte loads, so no load waits on a shuffle; one block-wide softmax;
//   the read runs over F with independent loads.
// - A grid barrier that waits more than ~4 s executes __trap(): the launch
//   fails with a CUDA error at the next synchronisation instead of hanging
//   the card or finishing with wrong outputs.
// No TMA, clusters or warp specialisation yet.
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
constexpr int kTileCols = 16;           // packed columns of one product tile
constexpr int kRedLd = kTileCols + 1;   // row stride of the reduction buffers
constexpr int kNumMats = 6;
constexpr int kTableCols = 2 + 3 * kNumMats;
constexpr int kMetaCols = 5;
constexpr int kVecHead = 4;             // vec: t_attn, t_content, b_stop, 0, then w_stop[F:]
constexpr int kNumStages = 7;
constexpr int kErrNoCooperativeLaunch = 10001;
constexpr int kErrNoOccupancy = 10002;
constexpr int kErrBadShape = 10003;
constexpr int kNumPtrs = 18;
constexpr int kNumDims = 10;
constexpr unsigned long long kBarrierTimeoutNs = 4000000000ull;
constexpr int kLoads = 8;  // loads an attention thread issues before it uses them

// the packed matrices, in the order of the wrapper's MATRICES
enum { kQueryOut = 0, kContentQuery, kPrenet0, kProjPrenet1, kLstm0, kLstm1 };

struct Params {
  int B, T, S, F, L, NM, M;
  int G;        // blocks in the grid = rows of the ownership table
  int w_elems;  // weight elements a block keeps in shared memory (bf16)
  const float* h_init;  // (2, B, F), rounded to the weight type
  const void* k;        // (B, T, F) weight type
  const void* v;        // (B, T, F)
  const void* ck;       // (B, S, L)
  const void* cv;       // (B, S, L)
  const float* ec;      // (B, F) encoder cell projection, rounded
  const float* bos;     // (B, NM), rounded
  const float* pos;     // (M, F), rounded
  const void* w;        // packed weight slices, block after block
  const int* table;     // (G, kTableCols): region offset, length, (unit0, units, offset) per matrix
  const int* meta;      // (kNumMats, kMetaCols): K, ldw, unit width, vec offset, columns
  const float* vec;     // kVecHead scalars, w_stop[F:], then each matrix's bias and scale
  float* mel;    // (M, B, NM)
  float* stop;   // (M, B)
  float* attn;   // (M, B, T)
  void* scratch;
  unsigned int* barrier;         // one zeroed word: arrivals so far
  unsigned long long* stage_ns;  // null, or kNumStages slots of ns summed over steps
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ constexpr size_t align_up(size_t a, size_t b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int nm_pad(int nm) { return round_up(nm, 16); }

// Byte offsets of the launch's global scratch (activations and state).
struct Scratch {
  size_t h, cw, cf, ys, pre0, o, rnn, q, cq, stop_c, total;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes) {
  const size_t at = off;
  off += align_up(bytes, 256);
  return at;
}

__host__ __device__ inline Scratch scratch_layout(int B, int F, int L, int NM, int wbytes) {
  const size_t BF = (size_t)B * F;
  Scratch s;
  size_t off = 0;
  s.h = take(off, 4 * BF * wbytes);     // [parity][layer][B][F] h, weight type
  s.cw = take(off, 2 * BF * wbytes);    // [layer][B][F] c rounded (content query input)
  s.cf = take(off, 2 * BF * 4);         // [layer][B][F] c, f32
  s.ys = take(off, (size_t)B * nm_pad(NM) * wbytes);  // last frame, zero-padded
  s.pre0 = take(off, BF / 2 * wbytes);  // [B][F/2] prenet0 output
  s.o = take(off, BF * wbytes);         // [B][F] attention read
  s.rnn = take(off, BF * wbytes);       // [B][F] LSTM0 input [content_o | ys_mid]
  s.q = take(off, BF * 4);              // [B][F] attention query, f32
  s.cq = take(off, (size_t)B * L * 4);  // [B][L] content query, f32
  s.stop_c = take(off, (size_t)B * 4);  // [B] encoder_cell part of the stop logit
  s.total = off;
  return s;
}

// shared floats of the attention stage (inside the staging area)
__host__ __device__ inline int attn_floats(int F, int T, int L, int S, int vec) {
  const int enc = F + (kWarps + 1) * round_up(T, 32) + kThreads * vec;
  const int content = L + round_up(S, 32);
  return enc > content ? enc : content;
}

// Byte offsets of a block's dynamic shared memory.
struct Smem {
  size_t w, x, red, out, total;
  int x_elems;
};

template <typename WT>
__host__ __device__ inline Smem smem_layout(const Params& p, int RC) {
  constexpr int VEC = 16 / sizeof(WT);
  Smem s;
  size_t off = 0;
  s.w = off;
  if (sizeof(WT) == 2) off += align_up((size_t)p.w_elems * sizeof(WT), 16);
  int x_elems = RC * (2 * p.F + VEC);
  const int a = cdiv(attn_floats(p.F, p.T, p.L, p.S, VEC) * 4, sizeof(WT));
  if (a > x_elems) x_elems = a;
  s.x_elems = x_elems;
  s.x = off;
  off += align_up((size_t)x_elems * sizeof(WT), 16);
  s.red = off;
  off += align_up((size_t)kWarps * RC * kRedLd * 4, 16);
  s.out = off;
  off += align_up((size_t)RC * kRedLd * 4, 16);
  s.total = off;
  return s;
}

// One packed matrix as this block sees it.
template <typename WT>
struct Mat {
  int K, ldw, width, ncols, u0, nu;
  const WT* w;         // this block's slice: nu * width columns of ldw elements
  const float* bias;   // (ncols), packed column order
  const float* scale;  // (ncols)
};

// One piece of a product's input rows: columns [0, width) of a (B, ld) array.
template <typename WT>
struct Piece {
  const WT* ptr;
  int ld, width;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename WT>
__device__ __forceinline__ WT from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element e of 16 bytes of WT values, as f32 (e is a constant after unrolling)
template <typename WT>
__device__ __forceinline__ float elem(const uint4& v, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& v, int e) {
  return __uint_as_float(word(v, e));
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int e) {
  const unsigned u = word(v, e >> 1);
  return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier on one global counter that only grows: each block adds
// 1 with release order and waits, with acquire loads, until the count
// reaches `target`, its number of barriers so far times the grid size. The
// launch is cooperative, so every block is resident. A wait longer than
// kBarrierTimeoutNs traps, which fails the launch with a CUDA error.
__device__ void grid_barrier(unsigned int* bar, unsigned int& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(bar), "r"(1u) : "memory");
    unsigned long long start = 0;
    unsigned polls = 0;
    while (ld_acquire(bar) < target) {
      if ((++polls & 1023u) == 0) {
        const unsigned long long now = global_ns();
        if (start == 0) {
          start = now;
        } else if (now - start > kBarrierTimeoutNs) {
          __trap();
        }
      }
    }
  }
  __syncthreads();
}

// Copies rows [r0, r0 + nr) of the pieces, side by side, into xs (row
// stride ldx). Rows past nr keep what they held; their results are dropped.
template <typename WT>
__device__ void stage_rows(WT* xs, int ldx, const Piece<WT>* pcs, int np, int r0, int nr) {
  constexpr int VEC = 16 / sizeof(WT);
  int off = 0;
  for (int q = 0; q < np; ++q) {
    const int nv = pcs[q].width / VEC;
    for (int idx = threadIdx.x; idx < nr * nv; idx += kThreads) {
      const int r = idx / nv, v = idx - r * nv;
      cp_async16(xs + (size_t)r * ldx + off + v * VEC, pcs[q].ptr + (size_t)(r0 + r) * pcs[q].ld + v * VEC);
    }
    off += pcs[q].width;
  }
  cp_async_wait_all();
  __syncthreads();
}

// Rows a product handles in one pass: mma tiles are 16 rows, FMA tiles 8
// (RT = 1) or 32 (RT = 4).
template <typename WT>
__host__ __device__ constexpr int pass_rows(int RT) {
  return sizeof(WT) == 2 ? (RT == 1 ? 16 : 32) : 8 * RT;
}

// Each warp's partial sums red[warp][r][c] -> out[r * kRedLd + c].
template <int RC>
__device__ __forceinline__ void reduce_warps(float* red, float* out) {
  __syncthreads();
  for (int idx = threadIdx.x; idx < RC * kTileCols; idx += kThreads) {
    const int r = idx / kTileCols, c = idx - r * kTileCols;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) s += red[(g * RC + r) * kRedLd + c];
    out[r * kRedLd + c] = s;
  }
  __syncthreads();
}

// out[r * kRedLd + c] = sum_k xs[r][k] * w[c][k] for the RC staged rows and
// the tile's nc <= 16 columns (w column-major, ldw apart); warps split K.
// bf16 (weights in shared memory): per warp and k16 step, one ldmatrix.x4
// of w (two n8 tiles) and one of xs per 16 rows, then mma.sync. Columns
// past nc repeat column nc - 1; their sums are never read.
template <typename WT, int RC>
__device__ void tile_product_mma(const WT* xs, int ldx, int K, const WT* w, int ldw, int nc, float* red,
                                 float* out) {
  constexpr int MT = RC / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const WT* bp = w + (size_t)min((lane & 7) + ((lane >> 4) << 3), nc - 1) * ldw + ((lane >> 3) & 1) * 8;
  const WT* ap[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ap[mt] = xs + (size_t)(mt * 16 + (lane & 15)) * ldx + (lane >> 4) * 8;
  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const int nk = K / 16;
#pragma unroll 2
  for (int ks = warp; ks < nk; ks += kWarps) {
    unsigned b[4];
    ldmatrix_x4(b, bp + ks * 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      unsigned a[4];
      ldmatrix_x4(a, ap[mt] + ks * 16);
      mma_bf16(acc[mt][0], a, b[0], b[1]);
      mma_bf16(acc[mt][1], a, b[2], b[3]);
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* r0 = red + (warp * RC + mt * 16 + g) * kRedLd + nt * 8 + 2 * t;
      r0[0] = acc[mt][nt][0];
      r0[1] = acc[mt][nt][1];
      r0[8 * kRedLd] = acc[mt][nt][2];
      r0[8 * kRedLd + 1] = acc[mt][nt][3];
    }
  reduce_warps<RC>(red, out);
}

// The same in f32 (weights read through L2): lane (rg, cg) of each warp
// holds rows rg + 8 j and columns cg + 4 m of the tile, nc <= 4 * MC; the
// sums of columns past 4 * MC are never read.
template <typename WT, int RC, int MC>
__device__ void tile_product_fma(const WT* xs, int ldx, int K, const WT* w, int ldw, int nc, float* red,
                                 float* out) {
  constexpr int VEC = 16 / sizeof(WT);
  constexpr int RT = RC / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 2, cg = lane & 3;
  const WT* wp[MC];
#pragma unroll
  for (int m = 0; m < MC; ++m) wp[m] = w + (size_t)min(cg + 4 * m, nc - 1) * ldw;
  const WT* xp[RT];
#pragma unroll
  for (int j = 0; j < RT; ++j) xp[j] = xs + (size_t)(rg + 8 * j) * ldx;
  float acc[RT][MC];
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int m = 0; m < MC; ++m) acc[j][m] = 0.f;

  const int nv = K / VEC;
#pragma unroll 2
  for (int v = warp; v < nv; v += kWarps) {
    const int k = v * VEC;
    uint4 wr[MC], xr[RT];
#pragma unroll
    for (int m = 0; m < MC; ++m) wr[m] = *reinterpret_cast<const uint4*>(wp[m] + k);
#pragma unroll
    for (int j = 0; j < RT; ++j) xr[j] = *reinterpret_cast<const uint4*>(xp[j] + k);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float wf[MC], xf[RT];
#pragma unroll
      for (int m = 0; m < MC; ++m) wf[m] = elem<WT>(wr[m], e);
#pragma unroll
      for (int j = 0; j < RT; ++j) xf[j] = elem<WT>(xr[j], e);
#pragma unroll
      for (int j = 0; j < RT; ++j)
#pragma unroll
        for (int m = 0; m < MC; ++m) acc[j][m] = fmaf(xf[j], wf[m], acc[j][m]);
    }
  }
#pragma unroll
  for (int j = 0; j < RT; ++j)
#pragma unroll
    for (int m = 0; m < MC; ++m) red[(warp * RC + rg + 8 * j) * kRedLd + cg + 4 * m] = acc[j][m];
  reduce_warps<RC>(red, out);
}

// All rows of this block's columns of one matrix. The input rows are the
// pieces side by side (K = the sum of their widths). Calls
// epi(row, unit, sums, pre(row, unit)) with the unit's `width` column sums;
// pre's load is issued before the product, so its latency hides behind it.
template <typename WT, int RC, typename Pre, typename Epi>
__device__ void run_matrix(const Mat<WT>& m, const Piece<WT>* pcs, int np, int B, WT* xs, int x_elems,
                           float* red, float* out, Pre pre, Epi epi) {
  static_assert(RC * kTileCols <= 2 * kThreads, "two epilogue items a thread");
  constexpr int VEC = 16 / sizeof(WT);
  if (m.nu == 0) return;
  const int ldx = m.K + VEC;
  const int cap = (x_elems / ldx) / RC * RC;
  const int upt = kTileCols / m.width;
  for (int r0 = 0; r0 < B; r0 += cap) {
    const int nr = min(cap, B - r0);
    __syncthreads();  // the staging area is free
    stage_rows<WT>(xs, ldx, pcs, np, r0, nr);
    for (int rs = 0; rs < nr; rs += RC) {
      for (int ut = 0; ut < m.nu; ut += upt) {
        const int nut = min(upt, m.nu - ut), nc = nut * m.width;
        const WT* w = m.w + (size_t)ut * m.width * m.ldw;
        const WT* x = xs + (size_t)rs * ldx;
        float pv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int idx = threadIdx.x + j * kThreads, r = idx / nut, row = r0 + rs + r;
          pv[j] = idx < RC * nut && row < B ? pre(row, m.u0 + ut + idx - r * nut) : 0.f;
        }
        if constexpr (sizeof(WT) == 2)
          tile_product_mma<WT, RC>(x, ldx, m.K, w, m.ldw, nc, red, out);
        else if (nc <= 8)
          tile_product_fma<WT, RC, 2>(x, ldx, m.K, w, m.ldw, nc, red, out);
        else
          tile_product_fma<WT, RC, 4>(x, ldx, m.K, w, m.ldw, nc, red, out);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int idx = threadIdx.x + j * kThreads, r = idx / nut, u = idx - r * nut, row = r0 + rs + r;
          if (idx < RC * nut && row < B) epi(row, m.u0 + ut + u, out + r * kRedLd + u * m.width, pv[j]);
        }
        __syncthreads();
      }
    }
  }
}

// Attention of batch row b at step i on the whole block: writes attn[i, b]
// and the attention read o[b]. fs: attn_floats() shared floats.
template <typename WT>
__device__ void attend(const Params& p, int i, int b, const float* q, WT* o, float* fs) {
  constexpr int VEC = 16 / sizeof(WT);
  const int T = p.T, F = p.F;
  const int Tp = round_up(T, 32);
  const int nvF = F / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qs = fs;                   // [F] scaled query
  float* sp = qs + F;               // [kWarps][Tp] partial scores
  float* prob = sp + kWarps * Tp;   // [Tp]
  float* op = prob + Tp;            // [kThreads * VEC] partial reads

  // encoder attention: the temperature scales q before the dot
  const WT* kb = static_cast<const WT*>(p.k) + (size_t)b * T * F;
  const WT* vb = static_cast<const WT*>(p.v) + (size_t)b * T * F;
  const float ta = p.vec[0];
  for (int f = threadIdx.x; f < F; f += kThreads) qs[f] = __ldcg(q + (size_t)b * F + f) * ta;
  __syncthreads();
  // warp w takes a contiguous run of F; lane t takes key t and issues its
  // loads kLoads at a time before using any
  const int v0 = nvF * warp / kWarps, v1 = nvF * (warp + 1) / kWarps;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    if (t < T) {
      const WT* kr = kb + (size_t)t * F;
      float s = 0.f;
      for (int vb = v0; vb < v1; vb += kLoads) {
        uint4 raw[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          if (vb + j < v1) raw[j] = __ldg(reinterpret_cast<const uint4*>(kr + (vb + j) * VEC));
#pragma unroll
        for (int j = 0; j < kLoads; ++j)
          if (vb + j < v1)
#pragma unroll
            for (int e = 0; e < VEC; ++e) s = fmaf(qs[(vb + j) * VEC + e], elem<WT>(raw[j], e), s);
      }
      sp[warp * Tp + t] = s;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) {
      float s = 0.f;
      for (int g = 0; g < kWarps; ++g) s += sp[g * Tp + t];
      prob[t] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float z = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(prob[t] - m);
      prob[t] = e;
      z += e;
    }
    z = warp_sum(z);
    float* attn_row = p.attn + ((size_t)i * p.B + b) * T;
    for (int t = lane; t < T; t += 32) {
      const float a = prob[t] / z;
      prob[t] = a;
      attn_row[t] = a;
    }
  }
  __syncthreads();
  // the read: thread (group g, vector v) sums keys g, g + ng, ...
  const int ng = kThreads / nvF;
  {
    const int g = threadIdx.x / nvF, v = threadIdx.x - g * nvF;
    if (g < ng) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      for (int tb = g; tb < T; tb += ng * kLoads) {
        uint4 raw[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int t = tb + j * ng;
          if (t < T) raw[j] = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)t * F + v * VEC));
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int t = tb + j * ng;
          if (t < T) {
            const float a = prob[t];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = fmaf(a, elem<WT>(raw[j], e), acc[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) op[g * F + v * VEC + e] = acc[e];
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += kThreads) {
    float s = 0.f;
    for (int g = 0; g < ng; ++g) s += op[g * F + f];
    o[(size_t)b * F + f] = from_f<WT>(s);
  }
  __syncthreads();  // the shared floats are free for the next row
}

// Content attention of batch row b over the S codebook slots, queried by
// the cell states, on the whole block: writes rnn[b, :L].
template <typename WT>
__device__ void attend_content(const Params& p, int b, const float* cq, WT* rnn, float* fs) {
  const int F = p.F, S = p.S, L = p.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qc = fs;      // [L]
  float* csc = qc + L; // [round_up(S, 32)]
  const WT* ckb = static_cast<const WT*>(p.ck) + (size_t)b * S * L;
  const WT* cvb = static_cast<const WT*>(p.cv) + (size_t)b * S * L;
  const float tc = p.vec[1];
  for (int l = threadIdx.x; l < L; l += kThreads) qc[l] = __ldcg(cq + (size_t)b * L + l) * tc;
  __syncthreads();
  for (int s = warp; s < S; s += kWarps) {
    float d = 0.f;
    for (int lb = lane; lb < L; lb += 32 * kLoads) {
      float kv[kLoads];
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int l = lb + 32 * j;
        kv[j] = l < L ? to_f(ckb[(size_t)s * L + l]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int l = lb + 32 * j;
        if (l < L) d = fmaf(qc[l], kv[j], d);
      }
    }
    d = warp_sum(d);
    if (lane == 0) csc[s] = d;
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, csc[s]);
    m = warp_max(m);
    float z = 0.f;
    for (int s = lane; s < S; s += 32) z += expf(csc[s] - m);
    z = warp_sum(z);
    for (int s = lane; s < S; s += 32) csc[s] = expf(csc[s] - m) / z;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kThreads) {
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < S; ++s) acc = fmaf(csc[s], to_f(cvb[(size_t)s * L + l]), acc);
    rnn[(size_t)b * F + l] = from_f<WT>(acc);
  }
  __syncthreads();  // the shared floats are free for the next row
}

template <typename WT, int RC>
__global__ void __launch_bounds__(kThreads, 1) ar_decode_kernel(Params p) {
  constexpr int VEC = 16 / sizeof(WT);
  constexpr bool kResident = sizeof(WT) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Mat<WT> mats[kNumMats];
  const Smem sl = smem_layout<WT>(p, RC);
  WT* ws = reinterpret_cast<WT*>(smem + sl.w);
  WT* xs = reinterpret_cast<WT*>(smem + sl.x);
  float* red = reinterpret_cast<float*>(smem + sl.red);
  float* out = reinterpret_cast<float*>(smem + sl.out);

  const int B = p.B, F = p.F, L = p.L, NM = p.NM, H = p.F / 2, NMp = nm_pad(p.NM);
  const size_t BF = (size_t)B * F;
  const Scratch lo = scratch_layout(B, F, L, NM, sizeof(WT));
  unsigned char* sc = static_cast<unsigned char*>(p.scratch);
  WT* hw = reinterpret_cast<WT*>(sc + lo.h);
  WT* cw = reinterpret_cast<WT*>(sc + lo.cw);
  float* cf = reinterpret_cast<float*>(sc + lo.cf);
  WT* ys = reinterpret_cast<WT*>(sc + lo.ys);
  WT* pre0 = reinterpret_cast<WT*>(sc + lo.pre0);
  WT* ob = reinterpret_cast<WT*>(sc + lo.o);
  WT* rnn = reinterpret_cast<WT*>(sc + lo.rnn);
  float* qb = reinterpret_cast<float*>(sc + lo.q);
  float* cqb = reinterpret_cast<float*>(sc + lo.cq);
  float* stop_c = reinterpret_cast<float*>(sc + lo.stop_c);

  // this block's weight slices: into shared memory once (bf16), or in place (f32)
  const int* row = p.table + (size_t)blockIdx.x * kTableCols;
  const WT* region = static_cast<const WT*>(p.w) + row[0];
  if (kResident) {
    for (int idx = threadIdx.x; idx < row[1] / VEC; idx += kThreads)
      cp_async16(ws + idx * VEC, region + idx * VEC);
  }
  const WT* wbase = kResident ? ws : region;
  if (threadIdx.x < kNumMats) {
    const int m = threadIdx.x;
    const int* me = p.meta + m * kMetaCols;
    Mat<WT> mt;
    mt.K = me[0];
    mt.ldw = me[1];
    mt.width = me[2];
    mt.bias = p.vec + me[3];
    mt.ncols = me[4];
    mt.scale = mt.bias + mt.ncols;
    mt.u0 = row[2 + 3 * m];
    mt.nu = row[3 + 3 * m];
    mt.w = wbase + row[4 + 3 * m];
    mats[m] = mt;
  }

  // h <- encoder finals, c <- 0, ys <- BOS (zero-padded), the stop logit's
  // encoder_cell part: ec . w_stop[F:] + b_stop
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gstride = (size_t)gridDim.x * kThreads;
  for (size_t idx = gtid; idx < 2 * BF; idx += gstride) {
    hw[idx] = from_f<WT>(p.h_init[idx]);
    cw[idx] = from_f<WT>(0.f);
    cf[idx] = 0.f;
  }
  for (size_t idx = gtid; idx < (size_t)B * NMp; idx += gstride) {
    const int r = (int)(idx / NMp), c = (int)(idx - (size_t)r * NMp);
    ys[idx] = from_f<WT>(c < NM ? p.bos[(size_t)r * NM + c] : 0.f);
  }
  {
    const int lane = threadIdx.x & 31;
    const float* w_stop_e = p.vec + kVecHead;
    for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < B; b += gridDim.x * kWarps) {
      float s = 0.f;
      for (int f = lane; f < F; f += 32) s = fmaf(p.ec[(size_t)b * F + f], w_stop_e[f], s);
      s = warp_sum(s);
      if (lane == 0) stop_c[b] = s + p.vec[2];
    }
  }
  cp_async_wait_all();

  const bool timer = p.stage_ns != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long t_last = timer ? global_ns() : 0ull;
  unsigned long long acc_ns[kNumStages] = {0, 0, 0, 0, 0, 0, 0};
  auto lap = [&](int slot) {
    if (timer) {
      const unsigned long long t = global_ns();
      acc_ns[slot] += t - t_last;
      t_last = t;
    }
  };
  const auto no_pre = [](int, int) { return 0.f; };
  unsigned int arrivals = 0;
  grid_barrier(p.barrier, arrivals);  // also publishes mats[] and the shared weights
  lap(0);

  for (int i = 0; i <= p.M; ++i) {
    const WT* hc = hw + (size_t)(i & 1) * 2 * BF;  // h after step i-1
    WT* hn = hw + (size_t)((i + 1) & 1) * 2 * BF;  // h after step i

    // (A) fc_out -> ys, mel[i-1]; stop[i-1]; Q -> q_i; content_Q -> cq_i
    {
      const Mat<WT>& m = mats[kQueryOut];
      const Piece<WT> pcs[2] = {{hc, F, F}, {hc + BF, F, F}};
      const float* pos = p.pos + (size_t)i * F;
      const auto pre = [&](int, int col) { return col < F && i < p.M ? __ldg(pos + col) : 0.f; };
      run_matrix<WT, RC>(m, pcs, 2, B, xs, sl.x_elems, red, out, pre, [&](int r, int col, const float* s, float pc) {
        if (col < F) {
          if (i < p.M) qb[(size_t)r * F + col] = sinf(s[0] + m.bias[col]) * m.scale[col] + pc;
        } else if (i > 0) {
          const int c = col - F;
          if (c < NM) {
            const float y = s[0] + m.bias[col];
            ys[(size_t)r * NMp + c] = from_f<WT>(y);
            p.mel[((size_t)(i - 1) * B + r) * NM + c] = y;
          } else {
            p.stop[(size_t)(i - 1) * B + r] = s[0] + stop_c[r];
          }
        }
      });
    }
    if (i < p.M) {
      const Mat<WT>& m = mats[kContentQuery];
      const Piece<WT> pcs[2] = {{cw, F, F}, {cw + BF, F, F}};
      run_matrix<WT, RC>(m, pcs, 2, B, xs, sl.x_elems, red, out, no_pre, [&](int r, int col, const float* s, float) {
        const float x = s[0] + m.bias[col];
        cqb[(size_t)r * L + col] = x * sigmoid(x);
      });
    }
    grid_barrier(p.barrier, arrivals);
    if (i == p.M) {
      lap(6);
      break;
    }
    lap(1);

    // (B) prenet0; attention and content attention, a block per row and kind
    {
      const Mat<WT>& m = mats[kPrenet0];
      const Piece<WT> pcs[1] = {{ys, NMp, NMp}};
      run_matrix<WT, RC>(m, pcs, 1, B, xs, sl.x_elems, red, out, no_pre, [&](int r, int col, const float* s, float) {
        pre0[(size_t)r * H + col] = from_f<WT>(sinf(s[0] + m.bias[col]) * m.scale[col]);
      });
      // 2B jobs (the rows' attention, then their content attention) from
      // the last block down: prenet0's columns are on the first half
      float* fs = reinterpret_cast<float*>(xs);
      for (int j = gridDim.x - 1 - blockIdx.x; j < 2 * B; j += gridDim.x) {
        if (j < B)
          attend<WT>(p, i, j, qb, ob, fs);
        else
          attend_content<WT>(p, j - B, cqb, rnn, fs);
      }
    }
    grid_barrier(p.barrier, arrivals);
    lap(2);

    // (C) rnn[:, L:] = prenet1(pre0) + attention_proj(o): unit j is the
    // column pair (attention_proj j, prenet1 j)
    {
      const Mat<WT>& m = mats[kProjPrenet1];
      const Piece<WT> pcs[2] = {{ob, F, F}, {pre0, H, H}};
      run_matrix<WT, RC>(m, pcs, 2, B, xs, sl.x_elems, red, out, no_pre, [&](int r, int j, const float* s, float) {
        const float pre = sinf(s[1] + m.bias[2 * j + 1]) * m.scale[2 * j + 1];
        rnn[(size_t)r * F + L + j] = from_f<WT>(pre + (s[0] + m.bias[2 * j]));
      });
    }
    grid_barrier(p.barrier, arrivals);
    lap(3);

    // (D, E) the LSTM layers; unit u's gates i, f, g, o are its 4 columns
    for (int layer = 0; layer < 2; ++layer) {
      const Mat<WT>& m = mats[kLstm0 + layer];
      const Piece<WT> pcs[2] = {{layer == 0 ? rnn : hn, F, F}, {hc + layer * BF, F, F}};
      float* cl = cf + layer * BF;
      WT* cwl = cw + layer * BF;
      WT* hl = hn + layer * BF;
      // the cell state is prefetched: this block alone writes its units' c
      const auto pre = [&](int r, int u) { return __ldcg(cl + (size_t)r * F + u); };
      run_matrix<WT, RC>(m, pcs, 2, B, xs, sl.x_elems, red, out, pre, [&](int r, int u, const float* s, float c_old) {
        const float* b = m.bias + 4 * u;
        const size_t at = (size_t)r * F + u;
        const float c = sigmoid(s[1] + b[1]) * c_old + sigmoid(s[0] + b[0]) * tanhf(s[2] + b[2]);
        cl[at] = c;
        cwl[at] = from_f<WT>(c);
        hl[at] = from_f<WT>(sigmoid(s[3] + b[3]) * tanhf(c));
      });
      grid_barrier(p.barrier, arrivals);
      lap(4 + layer);
    }
  }
  if (timer)
    for (int k = 0; k < kNumStages; ++k) p.stage_ns[k] += acc_ns[k];
}

template <typename WT, int RC>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = ar_decode_kernel<WT, RC>;
  const size_t smem = smem_layout<WT>(p, RC).total;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return kErrNoCooperativeLaunch;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1 || p.G > sms * per_sm) return kErrNoOccupancy;
  Params arg = p;
  void* args[] = {&arg};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(p.G), dim3(kThreads), args,
                                  smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// one small row pass up to B = 8, 32 rows a pass above
template <typename WT>
int launch_for_batch(const Params& p, cudaStream_t stream) {
  return p.B <= 8 ? launch<WT, pass_rows<WT>(1)>(p, stream) : launch<WT, pass_rows<WT>(4)>(p, stream);
}

}  // namespace

extern "C" {

// Bytes of scratch the launch needs for these sizes.
long long ar_decode_scratch_bytes(int B, int F, int L, int NM, int weights_are_bf16) {
  return (long long)scratch_layout(B, F, L, NM, weights_are_bf16 ? 2 : 4).total;
}

// ptrs: the kNumPtrs device pointers in Params order (h_init ... stage_ns,
// which may be null); dims: B, T, S, F, L, NM, M, weights_are_bf16, G,
// w_elems. Launches on `stream` and returns 0 or an error code for
// ar_decode_error_string.
int ar_decode_launch(void* const* ptrs, const int* dims, void* stream) {
  Params p;
  p.B = dims[0]; p.T = dims[1]; p.S = dims[2]; p.F = dims[3];
  p.L = dims[4]; p.NM = dims[5]; p.M = dims[6];
  const bool bf16 = dims[7] != 0;
  p.G = dims[8]; p.w_elems = dims[9];
  if (p.B < 1 || p.T < 1 || p.S < 1 || p.M < 1 || p.G < 1 || p.F % 32 != 0 || p.L * 2 != p.F ||
      p.F / (bf16 ? 8 : 4) > kThreads || nm_pad(p.NM) > 2 * p.F)
    return kErrBadShape;
  int i = 0;
  p.h_init = static_cast<const float*>(ptrs[i++]);
  p.k = ptrs[i++]; p.v = ptrs[i++]; p.ck = ptrs[i++]; p.cv = ptrs[i++];
  p.ec = static_cast<const float*>(ptrs[i++]);
  p.bos = static_cast<const float*>(ptrs[i++]);
  p.pos = static_cast<const float*>(ptrs[i++]);
  p.w = ptrs[i++];
  p.table = static_cast<const int*>(ptrs[i++]);
  p.meta = static_cast<const int*>(ptrs[i++]);
  p.vec = static_cast<const float*>(ptrs[i++]);
  p.mel = static_cast<float*>(ptrs[i++]);
  p.stop = static_cast<float*>(ptrs[i++]);
  p.attn = static_cast<float*>(ptrs[i++]);
  p.scratch = ptrs[i++];
  p.barrier = static_cast<unsigned int*>(ptrs[i++]);
  p.stage_ns = static_cast<unsigned long long*>(ptrs[i++]);
  if (i != kNumPtrs) return kErrBadShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_for_batch<__nv_bfloat16>(p, s) : launch_for_batch<float>(p, s);
}

int ar_decode_num_ptrs() { return kNumPtrs; }
int ar_decode_num_dims() { return kNumDims; }

// Names of the stage_ns slots, comma-separated; each slot ends at a grid
// barrier. "init" and "last" occur once a launch, the others once a step.
const char* ar_decode_stage_names() {
  return "init,A fc_out+stop+Q+content_Q,B prenet0+attention,C prenet1+attention_proj,"
         "D lstm0,E lstm1,last";
}

const char* ar_decode_error_string(int code) {
  switch (code) {
    case kErrNoCooperativeLaunch: return "device does not support cooperative launch";
    case kErrNoOccupancy:
      return "kernel does not fit: one block per SM for every row of the ownership table "
             "(shared memory or registers)";
    case kErrBadShape:
      return "unsupported shapes (need ffn_hidden_dim % 32 == 0, at most 2048 (bf16) or 1024 "
             "(f32), n_mels <= 2 * ffn_hidden_dim and content_latent_dim == ffn_hidden_dim / 2)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
