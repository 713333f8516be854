// Flash attention forward: exact softmax(Q K^T / sqrt(d)) V on the tensor
// cores.
//
// Replaces brpc_tpu/ops/attention.py::_flash_kernel (the Pallas kernel
// behind flash_attention, pallas_call at :171).  Same contract: q, k, v
// [B, S, H(kv), D], online softmax, scale 1/sqrt(D), and when causal the
// K loop stops at each query tile's diagonal.  Unlike the TPU wrapper it
// takes GQA K/V unexpanded (query head h reads K/V head h / (H/Hkv)) and
// masks the ragged last tile itself, so any S runs the kernel.
//
// Bound: operations.  4*D flops per visible (query, key) pair against
// 2*D input elements per key tile shared by a whole query tile.
//
// Design (FlashAttention-2 on mma.sync):
//   * one block per (b*h, query tile) with 4 warps of MT 16-row m-tiles
//     each (64 or 128 rows; the wrapper takes MT = 2, which halves the
//     K/V reads per flop, where the grid still fills the card); the
//     tiles launch longest first, so the causal tail does not idle SMs;
//   * K/V tiles stream through a double-buffered shared-memory ring
//     filled by 16-byte cp.async copies: tile j+1 is in flight while
//     tile j computes.  Rows are padded by 16 bytes, which makes every
//     ldmatrix / fragment load free of bank conflicts;
//   * bf16: S = Q K^T by mma.m16n8k16 (f32 accumulate), Q held in
//     registers as A fragments (ldmatrix) where they fit; P is rounded
//     to bf16 in registers and is the A operand of P V, V read with
//     ldmatrix.trans;
//   * f32: 3xTF32 on mma.m16n8k8 (x = hi + lo, both tf32; the sum
//     lo*hi + hi*lo + hi*hi keeps f32 accuracy with TF32 off
//     everywhere else).  The C fragment of S is used as the A fragment
//     of P V with the keys of each 8-key block permuted (k-slot t holds
//     key 2t, slot t+4 key 2t+1), so P never leaves its registers;
//   * online softmax on the accumulator fragments: row max and sum by
//     quad shuffles, ex2.approx with log2(e)/sqrt(d) folded into one
//     scale, and O rescaled only when a row maximum moved;
//   * head dims up to 256 in multiples of 8; D pads to the next of 16,
//     32, 64, 128, 256 with zeros in shared memory (D = 8 runs one
//     16-deep k-step);
//   * keys past S or above the diagonal are masked per element, only in
//     the tiles that straddle them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// d += a * b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a * b, m16n8k8, tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo with both halves representable in tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// A B fragment (two values) split into tf32 halves
struct SplitB {
  uint32_t h0, h1, l0, l1;
};
__device__ __forceinline__ SplitB split_b(float x0, float x1) {
  SplitB b;
  split_tf32(x0, b.h0, b.l0);
  split_tf32(x1, b.h1, b.l1);
  return b;
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Tile geometry.  MT: 16-row m-tiles per warp (a block has 4 warps and
// 64*MT query rows).  LDS: shared-memory row stride in elements (DP plus
// 16 bytes of padding).  QREG: Q stays in registers as A fragments.
template <typename T, int DP, int MT>
struct Geo;
template <int DP, int MT>
struct Geo<__nv_bfloat16, DP, MT> {
  static constexpr int BK = 64;        // keys per tile
  static constexpr int LDS = DP + 8;
  static constexpr int CE = 8;         // elements per 16-byte chunk
  static constexpr bool QREG = DP * MT <= 128;
};
template <int DP, int MT>
struct Geo<float, DP, MT> {
  // f32 tiles take twice the bytes: two m-tiles halve the key tile, so
  // that two blocks still share an SM
  static constexpr int BK = MT == 1 ? 32 : 16;
  static constexpr int LDS = DP + 4;
  static constexpr int CE = 4;
  static constexpr bool QREG = false;
};

template <typename T, int DP, int MT>
constexpr int smem_bytes() {
  using G = Geo<T, DP, MT>;
  return (int)sizeof(T) * G::LDS * (64 * MT + 4 * G::BK);
}

// rows [r0, r0 + R) of a [S, D] slab (row stride rs elements) into
// shared [R, LDS]; rows past S and columns past D become zeros
template <typename T, int LDS, int CPR, int R>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int r0, int S, int D, int tid) {
  constexpr int CE = 16 / sizeof(T);
  for (int i = tid; i < R * CPR; i += kThreads) {
    const int r = i / CPR, c = (i - r * CPR) * CE;
    T* d = dst + r * LDS + c;
    if (r0 + r < S && c < D)
      cp_async16(d, src + (long long)(r0 + r) * rs + c);
    else
      *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The loops below run to compile-time bounds: zero padding past D keeps
// them exact, and with no early exit the compiler can issue the next
// fragment loads under the current mma.

// S += Q K^T for the warp's MT m-tiles over one BK-key tile.  q_s: the
// warp's first row.
template <int DP, int MT>
__device__ __forceinline__ void qk_bf16(
    float (&s)[MT][Geo<__nv_bfloat16, DP, MT>::BK / 8][4],
    const uint32_t (&qf)[Geo<__nv_bfloat16, DP, MT>::QREG ? MT : 1]
                        [Geo<__nv_bfloat16, DP, MT>::QREG ? DP / 16 : 1][4],
    const __nv_bfloat16* q_s, const __nv_bfloat16* k_s, int lane) {
  using G = Geo<__nv_bfloat16, DP, MT>;
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (G::QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[mt][i] = qf[mt][kk][i];
      } else {
        ldsm_x4(a[mt], q_s + (mt * 16 + (mi & 1) * 8 + r8) * G::LDS +
                           kk * 16 + (mi >> 1) * 8);
      }
    }
#pragma unroll
    for (int np = 0; np < G::BK / 16; ++np) {
      uint32_t b[4];
      ldsm_x4(b, k_s + (np * 16 + (mi >> 1) * 8 + r8) * G::LDS + kk * 16 +
                     (mi & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// O += P V: P (bf16) from the S accumulators, V by ldmatrix.trans
template <int DP, int MT>
__device__ __forceinline__ void pv_bf16(
    float (&o)[MT][DP / 8][4],
    const float (&s)[MT][Geo<__nv_bfloat16, DP, MT>::BK / 8][4],
    const __nv_bfloat16* v_s, int lane) {
  using G = Geo<__nv_bfloat16, DP, MT>;
  const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int j = 0; j < G::BK / 16; ++j) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(s[mt][2 * j][0], s[mt][2 * j][1]);
      a[mt][1] = pack_bf16(s[mt][2 * j][2], s[mt][2 * j][3]);
      a[mt][2] = pack_bf16(s[mt][2 * j + 1][0], s[mt][2 * j + 1][1]);
      a[mt][3] = pack_bf16(s[mt][2 * j + 1][2], s[mt][2 * j + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, v_s + (j * 16 + (mi & 1) * 8 + r8) * G::LDS + dp * 16 +
                       (mi >> 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * dp], a[mt], b[0], b[1]);
        mma_bf16(o[mt][2 * dp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// The 3xTF32 products below are issued term by term over independent
// accumulators -- both small cross terms lo*hi and hi*lo first, then
// hi*hi -- so consecutive mma never wait on one product's last term.

// S += Q K^T in 3xTF32.  q_s: the warp's first row.
template <int DP, int MT>
__device__ __forceinline__ void qk_f32(
    float (&s)[MT][Geo<float, DP, MT>::BK / 8][4], const float* q_s,
    const float* k_s, int lane) {
  using G = Geo<float, DP, MT>;
  constexpr int NT = G::BK / 8;
  const int g = lane >> 2, t = lane & 3;
  // the cross terms sum apart from hi*hi: twice the independent chains
  float sx[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sx[mt][nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float* qa = q_s + (mt * 16 + g) * G::LDS + kk * 8 + t;
      split_tf32(qa[0], ah[mt][0], al[mt][0]);
      split_tf32(qa[8 * G::LDS], ah[mt][1], al[mt][1]);
      split_tf32(qa[4], ah[mt][2], al[mt][2]);
      split_tf32(qa[8 * G::LDS + 4], ah[mt][3], al[mt][3]);
    }
    SplitB b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* kb = k_s + (nt * 8 + g) * G::LDS + kk * 8 + t;
      b[nt] = split_b(kb[0], kb[4]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(sx[mt][nt], al[mt], b[nt].h0, b[nt].h1);
        mma_tf32(s[mt][nt], ah[mt], b[nt].h0, b[nt].h1);
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(sx[mt][nt], ah[mt], b[nt].l0, b[nt].l1);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][nt][e] += sx[mt][nt][e];
}

// O += P V in 3xTF32, keys of each 8-block permuted (see the header);
// the head dim in chunks of DC n-tiles
template <int DP, int MT>
__device__ __forceinline__ void pv_f32(
    float (&o)[MT][DP / 8][4],
    const float (&s)[MT][Geo<float, DP, MT>::BK / 8][4], const float* v_s,
    int lane) {
  using G = Geo<float, DP, MT>;
  constexpr int DC = DP / 8 < 4 ? DP / 8 : 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < G::BK / 8; ++j) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_tf32(s[mt][j][0], ah[mt][0], al[mt][0]);
      split_tf32(s[mt][j][2], ah[mt][1], al[mt][1]);
      split_tf32(s[mt][j][1], ah[mt][2], al[mt][2]);
      split_tf32(s[mt][j][3], ah[mt][3], al[mt][3]);
    }
    const float* vb = v_s + (j * 8 + 2 * t) * G::LDS + g;
#pragma unroll
    for (int d0 = 0; d0 < DP / 8; d0 += DC) {
      SplitB b[DC];
#pragma unroll
      for (int i = 0; i < DC; ++i)
        b[i] = split_b(vb[(d0 + i) * 8], vb[G::LDS + (d0 + i) * 8]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < DC; ++i)
          mma_tf32(o[mt][d0 + i], al[mt], b[i].h0, b[i].h1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < DC; ++i)
          mma_tf32(o[mt][d0 + i], ah[mt], b[i].l0, b[i].l1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < DC; ++i)
          mma_tf32(o[mt][d0 + i], ah[mt], b[i].h0, b[i].h1);
    }
  }
}

template <typename T, int DP, int MT>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, int S, int H, int Hkv, int D, int causal,
    float scale_log2) {
  using G = Geo<T, DP, MT>;
  constexpr int BK = G::BK, NT = BK / 8, BQ = 64 * MT, WR = 16 * MT;
  constexpr int LDS = G::LDS, CPR = DP / G::CE;
  extern __shared__ int4 smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);          // [BQ, LDS]
  T* k_s = q_s + BQ * LDS;                          // [2][BK, LDS]
  T* v_s = k_s + 2 * BK * LDS;                      // [2][BK, LDS]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tile first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = q0 + warp * WR;                     // warp's first row
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kv_end + BK - 1) / BK;

  load_tile<T, LDS, CPR, BQ>(q_s, qb, q_ss, q0, S, D, tid);
  load_tile<T, LDS, CPR, BK>(k_s, kb, k_ss, 0, S, D, tid);
  load_tile<T, LDS, CPR, BK>(v_s, vb, v_ss, 0, S, D, tid);
  cp_async_commit();

  float oacc[MT][DP / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) oacc[mt][i][j] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  uint32_t qf[G::QREG ? MT : 1][G::QREG ? DP / 16 : 1][4];

  for (int kt = 0; kt < ntiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < ntiles) {
      const int nb = buf ^ 1;
      load_tile<T, LDS, CPR, BK>(k_s + nb * BK * LDS, kb, k_ss,
                                 (kt + 1) * BK, S, D, tid);
      load_tile<T, LDS, CPR, BK>(v_s + nb * BK * LDS, vb, v_ss,
                                 (kt + 1) * BK, S, D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * BK;
    const T* kt_s = k_s + buf * BK * LDS;
    const T* vt_s = v_s + buf * BK * LDS;
    if constexpr (G::QREG) {
      if (kt == 0) {
        const int mi = lane >> 3, r8 = lane & 7;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            ldsm_x4(qf[mt][kk],
                    q_s + (warp * WR + mt * 16 + (mi & 1) * 8 + r8) * LDS +
                        kk * 16 + (mi >> 1) * 8);
      }
    }
    // a warp whose rows all precede the tile sees none of its keys
    if (!(causal && k0 > wr0 + WR - 1)) {
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[mt][i][j] = 0.f;
      if constexpr (sizeof(T) == 2)
        qk_bf16<DP, MT>(s, qf, q_s + warp * WR * LDS, kt_s, lane);
      else
        qk_f32<DP, MT>(s, q_s + warp * WR * LDS, kt_s, lane);
      // mask only the tiles that straddle S or the diagonal
      if (k0 + BK > S || (causal && k0 + BK - 1 > wr0)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + nt * 8 + 2 * t + (e & 1);
              const int row = wr0 + mt * 16 + g + (e >> 1) * 8;
              if (key >= S || (causal && key > row)) s[mt][nt][e] = -INFINITY;
            }
      }
      float alpha[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float mx = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hf], s[mt][nt][2 * hf + 1]));
          mx = quad_max(mx);
          const float m_new = fmaxf(m[mt][hf], mx);
          // a row with nothing visible yet keeps m = -inf: guard every exp
          const float m_use = m_new == -INFINITY ? 0.f : m_new * scale_log2;
          alpha[mt][hf] = fast_exp2(m[mt][hf] * scale_log2 - m_use);
          m[mt][hf] = m_new;
          float rs = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
              const float p = fast_exp2(fmaf(s[mt][nt][e], scale_log2, -m_use));
              s[mt][nt][e] = p;
              rs += p;
            }
          l[mt][hf] = l[mt][hf] * alpha[mt][hf] + rs;
        }
      // once the row maxima settle, alpha is exactly 1 and O needs no
      // rescale; skip it when that holds for the whole warp
      bool moved = false;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        moved |= alpha[mt][0] != 1.f || alpha[mt][1] != 1.f;
      if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int dt = 0; dt < DP / 8; ++dt) {
            oacc[mt][dt][0] *= alpha[mt][0];
            oacc[mt][dt][1] *= alpha[mt][0];
            oacc[mt][dt][2] *= alpha[mt][1];
            oacc[mt][dt][3] *= alpha[mt][1];
          }
      }
      if constexpr (sizeof(T) == 2)
        pv_bf16<DP, MT>(oacc, s, vt_s, lane);
      else
        pv_f32<DP, MT>(oacc, s, vt_s, lane);
    }
    __syncthreads();   // the next iteration refills this buffer
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = wr0 + mt * 16 + g + hf * 8;
      const float lt = quad_sum(l[mt][hf]);
      const float inv = lt > 0.f ? 1.f / lt : 0.f;
      if (row >= S) continue;
      T* orow = o + b * o_sb + row * o_ss + h * o_sh;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const int c = dt * 8 + 2 * t;
        if (c < D)
          store2<T>(orow + c, oacc[mt][dt][2 * hf] * inv,
                    oacc[mt][dt][2 * hf + 1] * inv);
      }
    }
}

template <typename T, int DP, int MT>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int S, int H, int Hkv, int D,
           int causal, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, DP, MT>();
  static bool attr_set = false;
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, DP, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid(B * H, (S + 64 * MT - 1) / (64 * MT));
  flash_kernel<T, DP, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], S, H,
      Hkv, D, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

// mt: 16-row m-tiles per warp, 1 or 2 (2 only for DP <= 128, where its
// accumulators fit the registers)
template <typename T, int DP>
int launch_mt(const void* q, const void* k, const void* v, void* o,
              const long long* st, int B, int S, int H, int Hkv, int D,
              int causal, float scale, int mt, cudaStream_t stream) {
  if (mt == 1)
    return launch<T, DP, 1>(q, k, v, o, st, B, S, H, Hkv, D, causal, scale,
                            stream);
  if constexpr (DP <= 128)
    return launch<T, DP, 2>(q, k, v, o, st, B, S, H, Hkv, D, causal, scale,
                            stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* st, int B, int S, int H, int Hkv, int D,
             int causal, float scale, int mt, cudaStream_t stream) {
  if (D <= 16)
    return launch_mt<T, 16>(q, k, v, o, st, B, S, H, Hkv, D, causal, scale,
                            mt, stream);
  if (D <= 32)
    return launch_mt<T, 32>(q, k, v, o, st, B, S, H, Hkv, D, causal, scale,
                            mt, stream);
  if (D <= 64)
    return launch_mt<T, 64>(q, k, v, o, st, B, S, H, Hkv, D, causal, scale,
                            mt, stream);
  if (D <= 128)
    return launch_mt<T, 128>(q, k, v, o, st, B, S, H, Hkv, D, causal, scale,
                             mt, stream);
  return launch_mt<T, 256>(q, k, v, o, st, B, S, H, Hkv, D, causal, scale,
                           mt, stream);
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16.  strides (elements, d contiguous):
// q b,s,h | k b,s,h | v b,s,h | o b,s,h.  D a multiple of 8, every row
// start 16-byte aligned (the wrapper checks).  mt: 16-row m-tiles per
// warp, 1 or 2 (the wrapper chooses).  Launches on `stream` and returns
// cudaGetLastError().
int flash_attention_fwd(int dtype, const void* q, const void* k,
                        const void* v, void* o, const long long* strides,
                        int B, int S, int H, int Hkv, int D, int causal,
                        float scale, int mt, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (D > kMaxD || D % 8 || H % Hkv != 0 || mt < 1 || mt > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, strides, B, S, H, Hkv, D, causal,
                           scale, mt, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, S, H, Hkv, D,
                                   causal, scale, mt, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
