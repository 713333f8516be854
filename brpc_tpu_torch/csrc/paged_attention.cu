// Paged attention over the KV arena, one query per row, split across
// blocks (flash-decoding).
//
// Replaces brpc_tpu/ops/paged_attention.py::_paged_kernel (the Pallas
// kernel behind paged_attention_pallas, pallas_call at :259) together
// with the plain-jax folds of its wrapper (:270-305): the decode step's
// self key and the speculative verify's local key block.  Same
// contract: row n's query attends over the K/V of the pages named by
// tables[n, :], a key at position p is visible iff p < lengths[n] and its
// page entry is >= 0, GQA query heads share their K/V head.  With a local
// block, rows come in G groups of W and row n = g*W + i also sees local
// key j of its group iff mask[g, i, j].  A row with nothing visible gives
// zeros.
//
// Bound: bytes.  Each row reads its visible pages once per K/V head and
// does 4*D flops per key and query head, far below the flops per byte
// where an H100 turns compute bound.
//
// Design, two kernels on one stream:
//   * paged_split_kernel, grid (N, Hkv, S_split): block (n, g, s) folds
//     page entries [s*pps, (s+1)*pps) of row n into a partial (o, m, l)
//     for the G = H/Hkv query heads of kv head g, which share every page
//     staged in shared memory.  A block whose range starts past
//     ceil(lengths[n]/T) writes o = 0, m = -inf, l = 0 and exits;
//   * the block's page entries are read once into shared memory; pages
//     stream through a three-stage shared-memory ring by 16-byte
//     cp.async copies (two pages in flight while one computes), only
//     the visible tokens of each page; a -1 entry is
//     skipped and never dereferenced; K/V are addressed through the
//     arena's strides, so the arena is never copied;
//   * a quad of threads scores each (query head, token) pair with float4
//     reads of rows padded to stay off shared-memory bank conflicts;
//     warp w takes the per-head max and sum of heads w, w+4, ... as warp
//     reductions; o stays in registers, one float4 of (head, d) per
//     thread slot, the page's tokens dealt over the threads left idle;
//   * paged_combine_kernel, grid (N, ceil(H/4)): a warp per (row, head)
//     merges the splits (lanes over splits for the weights, then over
//     d in float4s), folds the optional self key (the decode step's
//     in-flight K/V) or the row's visible local keys (the verify's
//     draft K/V, at most kMaxW per group: lanes over d for the W dot
//     products, all in flight together, then one warp sum each) into the
//     same max and sum, and writes the normalised output.
// Scores are kept in the log2 domain (q pre-scaled by log2(e)/sqrt(d));
// m is converted back to natural units where it leaves the kernels.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxV = 4;            // float4 o slots per thread: G*D <= 2048
constexpr int kStages = 3;          // pages in the shared-memory ring
constexpr int kMaxW = 16;           // local block width the combine takes
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Padded K/V row in shared memory, in floats: a stride of 16 mod 32 words
// puts the four quads that score two neighbouring tokens on distinct banks
__host__ __device__ __forceinline__ int kv_row(int D) {
  return D + (D % 32 == 0 ? 16 : 4);
}

// Floats of the page ring, which at the end also holds the o parts (one
// float4 per thread) while they are summed.
__host__ __device__ __forceinline__ int ring_floats(int T, int D) {
  const int ring = kStages * 2 * T * kv_row(D);
  return ring > 4 * kThreads ? ring : 4 * kThreads;
}

// visible tokens of page entry pm of a row of length len
__device__ __forceinline__ int page_tokens(int pm, int T, int len) {
  return min(T, len - pm * T);
}

__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const float* __restrict__ q, long long q_sn, long long q_sh,
    const float* __restrict__ k, const float* __restrict__ v,
    long long kv_sp, long long kv_st, long long kv_sh,
    const int* __restrict__ tables, long long tab_sn,
    const int* __restrict__ lengths, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int N, int H,
    int Hkv, int D, int T, int MP, int pps, float scale_log2) {
  extern __shared__ float4 smem4[];
  // rows of a prefill bucket come in increasing length: the last rows
  // launch first so the longest do not trail
  const int n = N - 1 - blockIdx.x, g = blockIdx.y, split = blockIdx.z;
  const int G = H / Hkv, h0 = g * G;
  const int LD = kv_row(D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long part = ((long long)split * N + n) * H + h0;  // head h0

  // the row's length and this block's table entries, read together
  const int pb = split * pps;
  const int len = lengths[n];
  const int entry =
      tid < pps && pb + tid < MP ? tables[n * tab_sn + pb + tid] : -1;
  const int npages = len > 0 ? min((len + T - 1) / T, MP) : 0;
  const int pe = min(pb + pps, npages);
  if (pb >= pe) {                       // nothing of this row to fold
    for (int i = tid; i < G * D / 4; i += kThreads)
      reinterpret_cast<float4*>(o_part + part * D)[i] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    for (int h = tid; h < G; h += kThreads) {
      m_part[part + h] = -INFINITY;
      l_part[part + h] = 0.f;
    }
    return;
  }

  float* smem = reinterpret_cast<float*>(smem4);
  float* kv_s = smem;                   // [kStages][K, V][T, LD]
  float* q_s = kv_s + ring_floats(T, D);     // [G, D], in log2 units
  float* p_s = q_s + G * D;             // [G, T] scores, then weights
  float* m_s = p_s + G * T;             // [G] running max (log2 units)
  float* l_s = m_s + G;                 // [G] running sum
  float* a_s = l_s + G;                 // [G] this page's rescale factor
  int* tab_s = reinterpret_cast<int*>(a_s + G);   // [pps] page entries
  if (tid < pps) tab_s[tid] = entry;
  for (int i = kThreads + tid; i < pe - pb; i += kThreads)
    tab_s[i] = tables[n * tab_sn + pb + i];
  __syncthreads();

  const float* kg = k + g * kv_sh;
  const float* vg = v + g * kv_sh;
  const int C = D / 4;                  // float4 chunks per token row
  auto issue = [&](int pm) {
    const int page = tab_s[pm - pb];
    if (page < 0) return;               // same in every thread
    float* ks = kv_s + ((pm - pb) % kStages) * 2 * T * LD;
    float* vs = ks + T * LD;
    const long long base = (long long)page * kv_sp;
    const int nt = page_tokens(pm, T, len);
    for (int i = tid; i < nt * C; i += kThreads) {
      const int t = i / C, c = (i - t * C) * 4;
      const long long off = base + t * kv_st + c;
      cp_async16(ks + t * LD + c, kg + off);
      cp_async16(vs + t * LD + c, vg + off);
    }
  };
  // kStages - 1 pages in flight ahead of the one computing
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (pb + st < pe) issue(pb + st);
    cp_async_commit();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    q_s[i] = q[n * q_sn + (h0 + h) * q_sh + d] * scale_log2;
  }
  for (int h = tid; h < G; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  // o slots: (head, float4 chunk) pairs; when they leave threads idle,
  // P parts each fold every P-th token of a page and are summed at the end
  const int GC = G * C;
  const int P = GC >= kThreads ? 1 : kThreads / GC;
  float4 oacc[kMaxV];
#pragma unroll
  for (int j = 0; j < kMaxV; ++j) oacc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int pm = pb; pm < pe; ++pm) {
    if (pm + kStages - 1 < pe) issue(pm + kStages - 1);
    cp_async_commit();                  // possibly empty: keeps the count
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (tab_s[pm - pb] >= 0) {
      const float* ks = kv_s + ((pm - pb) % kStages) * 2 * T * LD;
      const float* vs = ks + T * LD;
      const int nt = page_tokens(pm, T, len);
      // scores: a quad of threads per (head, token), D dealt in float4s
      const unsigned quad = 0xfu << (lane & ~3);
      for (int pair = tid >> 2; pair < G * nt; pair += kThreads / 4) {
        const int h = pair / nt, t = pair - h * nt;
        const float4* qh = reinterpret_cast<const float4*>(q_s + h * D);
        const float4* kr = reinterpret_cast<const float4*>(ks + t * LD);
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = tid & 3; c < C; c += 4) {
          const float4 a = qh[c], b = kr[c];
          acc.x = fmaf(a.x, b.x, acc.x);
          acc.y = fmaf(a.y, b.y, acc.y);
          acc.z = fmaf(a.z, b.z, acc.z);
          acc.w = fmaf(a.w, b.w, acc.w);
        }
        float sc = (acc.x + acc.y) + (acc.z + acc.w);
        sc += __shfl_xor_sync(quad, sc, 1);
        sc += __shfl_xor_sync(quad, sc, 2);
        if ((tid & 3) == 0) p_s[h * T + t] = sc;
      }
      __syncthreads();
      // per-head max and sum as warp reductions
      for (int h = warp; h < G; h += kWarps) {
        float* ph = p_s + h * T;
        float mx = -INFINITY;
        for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, ph[t]);
        mx = warp_max(mx);
        const float m_prev = m_s[h];
        const float m_new = fmaxf(m_prev, mx);   // finite: nt >= 1
        float sum = 0.f;
        for (int t = lane; t < nt; t += 32) {
          const float p = exp2f(ph[t] - m_new);
          ph[t] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        __syncwarp();
        if (lane == 0) {
          const float alpha = exp2f(m_prev - m_new);  // 0 when m_prev=-inf
          m_s[h] = m_new;
          l_s[h] = l_s[h] * alpha + sum;
          a_s[h] = alpha;
        }
      }
      __syncthreads();
      // o += p v: slot (part, head, chunk), part p taking tokens p, p+P..
#pragma unroll
      for (int j = 0; j < kMaxV; ++j) {
        const int idx = tid + j * kThreads;
        if (idx >= GC * P) break;
        const int part = idx / GC, r = idx - part * GC;
        const int h = r / C, c = (r - h * C) * 4;
        const float a = a_s[h];
        const float* ph = p_s + h * T;
        float4 acc = oacc[j];
        acc.x *= a;
        acc.y *= a;
        acc.z *= a;
        acc.w *= a;
#pragma unroll 4
        for (int t = part; t < nt; t += P) {
          const float p = ph[t];
          const float4 x = *reinterpret_cast<const float4*>(vs + t * LD + c);
          acc.x = fmaf(p, x.x, acc.x);
          acc.y = fmaf(p, x.y, acc.y);
          acc.z = fmaf(p, x.z, acc.z);
          acc.w = fmaf(p, x.w, acc.w);
        }
        oacc[j] = acc;
      }
    }
    __syncthreads();                    // the next issue refills a buffer
  }

  float4* o4 = reinterpret_cast<float4*>(o_part + part * D);
  if (P == 1) {
#pragma unroll
    for (int j = 0; j < kMaxV; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < GC) o4[idx] = oacc[j];
    }
  } else {                              // sum the parts through the ring
    cp_async_wait<0>();
    float4* red = reinterpret_cast<float4*>(kv_s);
    if (tid < GC * P) red[tid] = oacc[0];
    __syncthreads();
    for (int r = tid; r < GC; r += kThreads) {
      float4 acc = red[r];
      for (int q = 1; q < P; ++q) {
        const float4 x = red[q * GC + r];
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      }
      o4[r] = acc;
    }
  }
  for (int h = tid; h < G; h += kThreads) {
    m_part[part + h] = m_s[h];
    l_part[part + h] = l_s[h];
  }
}

// A warp per (row n, head h): merge the S_split partials, fold the self
// key (ek != nullptr) or the local block (W > 0), divide.
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ o_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, int S_split,
    const float* __restrict__ q, long long q_sn, long long q_sh,
    const float* __restrict__ ek, const float* __restrict__ ev,
    long long e_sn, long long e_sh, const float* __restrict__ lk,
    const float* __restrict__ lv, long long l_sg, long long l_sw,
    long long l_sh, const unsigned char* __restrict__ lmask, long long m_sg,
    long long m_si, long long m_sj, int W, float* __restrict__ out, int N,
    int H, int Hkv, int D, float scale_log2) {
  const int n = blockIdx.x;
  const int h = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (h >= H) return;                   // whole warp
  const int hk = h / (H / Hkv);
  const long long nh = (long long)n * H + h;
  const long long stride = (long long)N * H;   // between splits
  extern __shared__ float w_smem[];
  float* w = w_smem + (threadIdx.x >> 5) * 2 * S_split;   // this warp's
  float* lw = w + S_split;                                // m, then weights
  const float* qr = q + n * q_sn + h * q_sh;

  // the self key's score and every partial's (m, l): independent loads,
  // issued together
  float es = -INFINITY;
  const float* evr = nullptr;
  if (ek != nullptr) {
    const float* ekr = ek + n * e_sn + hk * e_sh;
    evr = ev + n * e_sn + hk * e_sh;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32) dot = fmaf(qr[d], ekr[d], dot);
    es = warp_sum(dot) * scale_log2;
  }
  // the local block: key j's score (log2 units) in ls[j] of every lane,
  // -inf where the mask hides it
  float ls[kMaxW];
#pragma unroll
  for (int j = 0; j < kMaxW; ++j) ls[j] = 0.f;
  const float* lkg = nullptr;
  const float* lvg = nullptr;
  unsigned vis = 0;
  if (W > 0) {
    const int g = n / W, i = n - g * W;
    lkg = lk + g * l_sg + hk * l_sh;
    lvg = lv + g * l_sg + hk * l_sh;
    vis = __ballot_sync(0xffffffffu,
                        lane < W && lmask[g * m_sg + i * m_si + lane * m_sj]);
    for (int d = lane; d < D; d += 32) {
      const float qd = qr[d];
#pragma unroll
      for (int j = 0; j < kMaxW; ++j)
        if ((vis >> j) & 1u) ls[j] = fmaf(qd, lkg[j * l_sw + d], ls[j]);
    }
#pragma unroll
    for (int j = 0; j < kMaxW; ++j)     // vis is the same in every lane
      ls[j] = (vis >> j) & 1u ? warp_sum(ls[j]) * scale_log2 : -INFINITY;
  }
  float M = es;
#pragma unroll
  for (int j = 0; j < kMaxW; ++j)
    if ((vis >> j) & 1u) M = fmaxf(M, ls[j]);
  for (int s = lane; s < S_split; s += 32) {
    const float ms = m_part[s * stride + nh];
    w[s] = ms;
    lw[s] = l_part[s * stride + nh];
    M = fmaxf(M, ms);
  }
  M = warp_max(M);
  float4* orow = reinterpret_cast<float4*>(out + nh * D);
  const int C = D / 4;
  if (M == -INFINITY) {                 // nothing visible: zeros
    for (int c = lane; c < C; c += 32)
      orow[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  // an empty split has m = -inf (weight 0) and o = 0
  float L = 0.f;
  for (int s = lane; s < S_split; s += 32) {
    const float ws = exp2f(w[s] - M);
    w[s] = ws;
    L = fmaf(ws, lw[s], L);
  }
  const float we = ek != nullptr ? exp2f(es - M) : 0.f;
  float lsum = we;
#pragma unroll
  for (int j = 0; j < kMaxW; ++j) {     // exp2(-inf) = 0 for hidden keys
    ls[j] = (vis >> j) & 1u ? exp2f(ls[j] - M) : 0.f;
    lsum += ls[j];
  }
  L = warp_sum(L) + lsum;
  __syncwarp();
  const float inv = 1.f / L;            // L > 0: M is finite
  const float4* op = reinterpret_cast<const float4*>(o_part) + nh * C;
  const float4* evr4 = reinterpret_cast<const float4*>(evr);
  for (int c = lane; c < C; c += 32) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ek != nullptr) {
      const float4 x = evr4[c];
      acc = make_float4(we * x.x, we * x.y, we * x.z, we * x.w);
    }
#pragma unroll
    for (int j = 0; j < kMaxW; ++j) {
      if ((vis >> j) & 1u) {
        const float wj = ls[j];
        const float4 x = reinterpret_cast<const float4*>(lvg + j * l_sw)[c];
        acc.x = fmaf(wj, x.x, acc.x);
        acc.y = fmaf(wj, x.y, acc.y);
        acc.z = fmaf(wj, x.z, acc.z);
        acc.w = fmaf(wj, x.w, acc.w);
      }
    }
#pragma unroll 4
    for (int s = 0; s < S_split; ++s) {
      const float ws = w[s];
      const float4 x = op[s * stride * C + c];
      acc.x = fmaf(ws, x.x, acc.x);
      acc.y = fmaf(ws, x.y, acc.y);
      acc.z = fmaf(ws, x.z, acc.z);
      acc.w = fmaf(ws, x.w, acc.w);
    }
    orow[c] = make_float4(acc.x * inv, acc.y * inv, acc.z * inv,
                          acc.w * inv);
  }
}

}  // namespace

extern "C" {

// Shared memory one split block needs, in bytes, for at most pps page
// entries per block.
long long paged_attention_smem_bytes(int H, int Hkv, int D, int T, int pps) {
  const long long G = H / Hkv;
  return (long long)sizeof(float) *
         ((long long)ring_floats(T, D) + G * D + G * T + 3 * G + pps);
}

// Largest G*D the split kernel's register slots hold.
int paged_attention_max_group_width() { return kMaxV * kThreads * 4; }

// Largest local block width W the combine kernel folds.
int paged_attention_max_local_width() { return kMaxW; }

// q [N, H, D] (d contiguous), k/v pages addressed as
// base + page*kv_sp + token*kv_st + head*kv_sh + d (16-byte aligned, D a
// multiple of 4), tables [N, MP] int32 (row stride tab_sn), lengths [N]
// int32; o_part [S_split, N, H, D], m_part/l_part [S_split, N, H] f32
// scratch.  ek/ev [N, Hkv, D] (strides e_sn, e_sh) or null.  With
// W > 0: lk/lv [G, W, Hkv, D] (strides l_sg, l_sw, l_sh; 16-byte aligned
// rows) and lmask [G, W, W] bool (strides m_sg, m_si, m_sj), N == G*W,
// W <= kMaxW.  out [N, H, D] contiguous.  Launches the split and the
// combine kernel on `stream`; returns cudaGetLastError().
int paged_attention_f32(const float* q, long long q_sn, long long q_sh,
                        const float* k, const float* v, long long kv_sp,
                        long long kv_st, long long kv_sh, const int* tables,
                        long long tab_sn, const int* lengths, float* o_part,
                        float* m_part, float* l_part, int N, int H, int Hkv,
                        int D, int T, int MP, int S_split, int pps,
                        float scale, const float* ek, const float* ev,
                        long long e_sn, long long e_sh, const float* lk,
                        const float* lv, long long l_sg, long long l_sw,
                        long long l_sh, const unsigned char* lmask,
                        long long m_sg, long long m_si, long long m_sj,
                        int W, float* out, void* stream) {
  if (N == 0) return 0;
  if (W < 0 || W > kMaxW || (W > 0 && N % W))
    return (int)cudaErrorInvalidValue;
  static long long smem_set = 48 * 1024;
  const long long smem = paged_attention_smem_bytes(H, Hkv, D, T, pps);
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const float sl2 = scale * kLog2e;
  paged_split_kernel<<<dim3(N, Hkv, S_split), kThreads, smem, st>>>(
      q, q_sn, q_sh, k, v, kv_sp, kv_st, kv_sh, tables, tab_sn, lengths,
      o_part, m_part, l_part, N, H, Hkv, D, T, MP, pps, sl2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_kernel<<<dim3(N, (H + kWarps - 1) / kWarps), kThreads,
                         2 * kWarps * S_split * sizeof(float), st>>>(
      o_part, m_part, l_part, S_split, q, q_sn, q_sh, ek, ev, e_sn, e_sh, lk,
      lv, l_sg, l_sw, l_sh, lmask, m_sg, m_si, m_sj, W, out, N, H, Hkv, D,
      sl2);
  return (int)cudaGetLastError();
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
