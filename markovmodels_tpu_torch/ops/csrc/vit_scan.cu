// Fused tropical Viterbi sweep (K7) and the backtrace walk on Hopper (sm_90a).
//
// Replaces the Pallas kernel of markovmodels_tpu/ops/pallas_block.py:
//   K7 mm_vit_fwd  <- _run_vit_slice pallas_call, _make_vit_kernel
// (the max-product form of its in-kernel matvec K1 is tier_max_arg() plus
// the band epilogue of vit_item()), and the walk of
// markovmodels_tpu/viterbi.py's _viterbi_scale_bp, which the JAX package
// leaves to XLA:
//   mm_vit_walk    one thread per sequence.
// and, for the chunk-recompute decode of markovmodels_tpu/viterbi.py's
// _viterbi_scale (XLA there: its fstep on _trop_prob_matvec's 'block' form):
//   K7n mm_vit_fwd_noid  the same sweep without the ids (IDS = false): the
//                        tier keeps its max only, no id is stored and no
//                        fins; it starts from a given state and scale at a
//                        given global frame and saves every frame's state
//                        (a chunk's recompute) or every stride-th one (the
//                        checkpoints of the first sweep), the phony row
//                        included, with its scale.
//
// What K7 computes, per frame t and column b of the (Sp, B) state a:
//   y[j] = max( max_o band_w[o, j] * a[j - off_o],          (bands, in order)
//               max_s W[k, s, d] * a[src(k, s)] )            (tier, j = dst(k, d))
//   with the winning candidate id (Sm + o for a band, s for the tier, 255
//   for no incoming mass) stored as one uint8 per (t, j, b) for the main
//   region j < RW = R*W; the phony final state gets max_j omega[j] * a[j]
//   and its smallest argmax j (fins); frame 0 keeps a = alpha0; then the
//   emission multiply and an exact power-of-two rescale.
// Ties follow the TPU kernel: bands in offset order with a strict >, the
// smallest s among equal tier maxima, the tier merged with a strict >.
//
// What bounds it on the card, at the 2M-arc graph (Sp = 49,280; one tier of
// K = 128 panels of Sm x D = 128 x 128) and B = 128: the tier's 268 M
// candidate products per frame on the CUDA cores (the max-product reduction
// has no tensor-core form).  The function needs a multiply and a max for
// each; the id costs ~1/GS of that.  A loop that keeps a running (max,
// argmax) per output pays a multiply, a compare and two selects per
// candidate, three of them on the half-rate ALU pipe (the per-frame step
// kernels this sweep replaced: ~70 us of a 110 us frame).  Here a
// candidate costs an FMUL and 0.875 ALU instructions (the maxima three at
// a time), and the group loop is bound by its issue (PERF.md section 6).
// The memory per frame is 6.3 MB of ids written once plus the state
// (25 MB read by the tier and the bands, 25 MB written), against a 50 MB
// L2.
//
// Design: one persistent cooperative launch per sweep (every CTA
// co-resident), the frame loop inside, one grid barrier per frame, as the
// blocked forward K2 (block_scan.cu fwd_chunk_kernel):
//   * a frame's work items (row tile x 64-column tile: tier tiles, band
//     tiles) come from a queue that the host plan orders (ops/vit_scan.py
//     vit_plan: every tier item, then every band item, each in tile
//     order); a CTA takes the next item from an atomic position as it
//     finishes the last;
//   * a tier tile keeps its whole contraction resident in shared memory:
//     the 64 destination columns of its panel, transposed on the host
//     (W[k, s, d] at [d][s]), by cp.async, and the 128 gathered, rescaled
//     state rows transposed as they are staged ([b][s]), each row padded to
//     132 floats so that the loop's 16-byte reads and the staging's stores
//     meet no bank conflict.  tier_max_arg() then finds, for each of a
//     thread's 4x4 outputs, the max over groups of GS consecutive s by
//     maxima alone, moving the running value and the group index only
//     where a group's max is strictly greater; the winning group's GS
//     products are then recomputed from the resident operands and the
//     first s equal to the max is the id.  That is the rule "strict >,
//     smallest s among equal maxima" bit for bit: the final group is the
//     first to hold the global max, the first equal s in it is the
//     smallest overall, and the products are the same FMULs.  Every
//     product is >= 0 (no NaN), so its float bits order as its value and
//     the maxima are taken on the bits as ints: exact, and three at a
//     time (VIMNMX3), 4 instructions for 8 products where FMNMX takes 7;
//   * every item then takes the band epilogue (the loads of a pair of rows'
//     first two band terms issued before any is used), the emission
//     multiply, the state store (L2 evict_last: the next frame reads it) and
//     the id store (4 columns in one streaming 32-bit store: written once,
//     never read back in the sweep);
//   * the tier items come first in the queue: with 2 CTAs per SM they take
//     two rounds, and the band items fill the rest of the frame.  Measured
//     slower (PERF.md section 6): tier items spread among the band
//     items, one CTA of each SM taking the tier items first, groups of 16,
//     3 CTAs per SM (spills), the epilogue's rows by cp.async or held in
//     registers across the recovery, the contraction in two pipelined
//     passes, the next item's panel fetched during the epilogue;
//   * the per-frame finalize has no launch of its own and no pass: both of
//     its reductions are order-free maxima.  Each item takes its column max
//     of the new state by atomicMax on the float bits, and the (max,
//     smallest argmax) of omega[j] * a[j] over its rows j of the previous
//     state by atomicMax on a 64-bit key (value bits, then 2^32 - 1 - j),
//     each into CM copies (CTA c into copy c % CM).  After the barrier every
//     CTA reads the copies of its columns and derives the phony state of the
//     frame just ended, y[fin] = max(omega a) * e_fin, and from the column
//     max with it the power-of-two scale; CTA 0 also records fins and
//     advances ksum and the Kahan-compensated emission shift.  y[fin] is
//     never stored in the sweep: the one item that reads it (omega[fin] *
//     a[fin]) takes it from the same derivation; the last frame's is
//     written after the loop;
//   * the state is stored unscaled and the scale applied as the next frame
//     reads it (exact: powers of two), so the products, hence the ids, are
//     those of the TPU kernel's rescaled state; what another CTA of the
//     launch wrote is read past L1 (ld.global.cg, under L2 evict_first).
// The results are those of the per-frame step and finalize launches it
// replaced, bit for bit.
//
// The capped layout of a separate-state backoff graph (ov_layout: overflow
// rows [ov_lo, ov_hi), each with its own pdf, joined to the core by
// overflow families) takes a template branch (FAM) that the TPU K7 does not
// have (it refuses such graphs; the JAX package decodes them in XLA,
// blocked.py block_matvec_max_arg's ov_span branch).  The families arrive as
// K2's per-row lists of (source, weight) terms (block_scan.cu Layout), each
// term with its candidate id in the uint8 encoding of that row
// (ops/vit_scan.py fam_tables): a core row's out-family term is Sm + nO; an
// overflow row of group g takes its in-families at [0, C_g) and its bands at
// C_g + o (cbase[g] = C_g).  A row's family candidate is the max of its
// terms' products and the smallest id among the terms equal to it, merged
// after the bands and the tier with a strict >: the ids of "families in
// descriptor order, each merged with a strict >, the smallest index within
// a family", since the ids rise in descriptor order.  A row's few terms
// are pulled by its own thread in the epilogue, their range and the row's
// first band id staged in shared memory as the item's rows are set up; a
// heavy row (an 'in' window: 129 terms on the graph of chip_smoke.py
// phase 18) takes an item of its own, heavy_max_arg(), whose 16 thread
// rows split the terms and merge their partials in the same rule (one
// thread pulling 128 terms cost K2 97 us per frame, PERF.md section 6);
// the heavy items come first in the queue (measured faster than after the
// tier items or last, PERF.md section 6).  An overflow
// row's emission comes from its own pdf (row_pdf).  The branch sits
// outside the group loop, and the uniform instantiations (FAM = false)
// compile as before.
//
// The value type T (the last template argument): float, or double for a
// float64 graph (the JAX package decodes those in XLA; its K7 takes float32).
// A double instantiation keeps every value in double (state, scales,
// emissions, panels, bands, family weights, omega, checkpoints) and keeps
// the rules bit for bit: the tier's products are compared on their 64 bits
// as ints (the bits of a non-negative double order as its value), a pass
// stages 64 positions (half the float rows, the same bytes), the column
// maxima are 64-bit words.  The omega key does not fit: the double's 64
// bits leave no room for j.  So each (frame, copy, column) keeps the
// positive candidates as a pair (value bits, 2^32 - 1 - j) that an item
// replaces under a spin lock of the pair's own (after a lock-free check
// against the value, which only rises), and the zero candidates' largest
// 2^32 - 1 - j by atomicMax; the end of the frame takes the largest value,
// the largest j-word among the copies holding it, or the zero word where
// every product is 0.  Both give the (max, smallest argmax) of the float
// rule whatever the items' order.  K7n (no ids) keeps the value alone.
// The ids, the queue and the walk do not depend on T.
//
// Conventions: state (Sp, B) row-major T; ext (Nf, P1, B), the emission of
// state j is ext[t, j / cmax, b] (uniform pdf-grouped layout) or
// ext[t, row_pdf[j], b] (FAM); ids (Nf, RW, B) uint8; fins (Nf, B) int32.
// Index maps of the tier come from the host as ints: src(k, s) = g0 + k*gk +
// s*gs, dst(k, d) = d0 + k*dk + d*dd.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_common.cuh"
#include "coop_common.cuh"

namespace {

constexpr int TB = 64;       // batch columns per item
constexpr int NT = 256;      // threads per CTA: 16 x 16, 4x4 outputs each
// tier contraction resident per pass (float 128, double 64: the same
// bytes), and the padded row of a resident tier operand (16 bytes more)
template <class T>
constexpr int SC = is_f64<T>() ? 64 : 128;
template <class T>
constexpr int ST = SC<T> + 16 / static_cast<int>(sizeof(T));
constexpr int GS = 8;        // tier candidates per max group
constexpr int PB = 2;        // band terms of a pair of rows loaded ahead
constexpr int CM = 16;       // copies of each frame's column max and omega key
constexpr int SYNC_GEN = 32;  // the barrier takes SYNC_GEN + 1 words
constexpr int NO_CAND = 255;
constexpr int WALK_THREADS = 128;
// CTAs resident per SM (caps registers at 128; shared memory allows 3)
constexpr int VIT_BLOCKS = 2;
static_assert(SC<float> % GS == 0 && SC<double> % GS == 0 && GS % 4 == 0 &&
                  TR == TB,
              "tier tiles");

// The omega key of a thread row or an item: float, one ordered 64-bit word
// (omega_key); double, the value's bits and the j-word 2^32 - 1 - j apart.
struct DKey {
  unsigned long long v;
  unsigned w;
};
template <class T>
using OKey = typename std::conditional<is_f64<T>(), DKey,
                                       unsigned long long>::type;

// Shared memory of one CTA (dynamic; 2 x B values follow it: the scale and
// the phony state of the frame before, per column).
template <class T>
struct VitSmem {
  union {
    struct {  // a tier item's resident operands
      T W[TR][ST<T>];  // W[k, s0 + s, dbase + d] at [d][s]
      T X[TB][ST<T>];  // a[src(k, s0 + s), b0 + b] at [b][s], rescaled
    } op;
    struct {  // the epilogue
      T val[TR][TB + 1];  // the tier's max of each output
      uint8_t id[TR][TB];     // and its id
      BitsT<T> rm[16][TB];    // column max of each thread row
      OKey<T> rk[16][TB];     // omega key of each thread row
    } ep;
    struct {  // a heavy row's partial family candidates (FAM), past ep
      T skip[TR][ST<T>];
      T v[16][TB];      // each thread row's max product
      int id[16][TB];   // and its smallest id among equal products
    } hv;
  } u;
  int rows[TR];  // state row of each tile row, -1 if none
  int grp[TR];   // its pdf group (emission row)
  int2 next[2];  // the queue entries taken for the next items
};

// A sweep's shared memory: the uniform layout's, and with FAM each tile
// row's family terms [x, y) and first band id z, read as the rows are set
// up (the uniform instantiations keep exactly the uniform layout).
template <bool FAM, class T>
struct VitSmemT : VitSmem<T> {};
template <class T>
struct VitSmemT<true, T> : VitSmem<T> {
  int3 fr[TR];
};

// The double instantiation's omega scratch beside the keys' words (none for
// float): per (frame, copy, column) the positive pair's j-word, the zero
// candidates' j-word and the pair's lock, each zeroed.
template <class T>
struct OmegaWords {};
template <>
struct OmegaWords<double> {
  unsigned* omw;
  unsigned* omz;
  unsigned* olock;
};

template <class T>
struct VitArgs : OmegaWords<T> {
  Meta m;
  int B, Nf, RW;
  // K7n (IDS = false) only: launch frame f is global frame t0 + f (frame 0
  // skips the product only where that is 0); a0 has the scale s0; frame f
  // is saved when (f + 1) % stride == 0, into slot (f + 1) / stride - 1
  // (stride 1: every frame, which is then the sweep's own state buffer)
  int t0, stride;
  const T* s0;     // (B,)
  T* save;         // (Nf / stride, Sp, B) unscaled, the phony row too
  T* save_scale;   // (Nf / stride, B)
  const T* a0;      // (Sp, B) the state before frame 0 (scale 1)
  const T* ext;     // (Nf, P1, B)
  const T* mshift;  // (Nf, 1, B)
  const T* band_w;  // (nO, Sp)
  const T* Wt;      // (K, D, Sm4) the tier panels transposed, zero-padded
  long long Sm4;        // Sm rounded up to 4
  const T* omega;   // (Sp,)
  const int* band_rows;
  const int2* queue;  // (n_items,) item, first row of a band tile or -1
  int n_items;
  T* work;   // (2, Sp, B) the state of frame t at work[t % 2], unscaled
  uint8_t* bps;  // (Nf, RW, B)
  int* fins;     // (Nf, B)
  T* scale;  // (B,) the last frame's scale
  T* ksum;   // (B,) sum of the exponents, zero on entry
  T* shift;  // (B,) the Kahan-compensated emission shift, zero
  T* comp;   // (B,) its compensation, zero
  BitsT<T>* cm;  // (Nf, CM, B) column max of each frame (its bits), zeroed
  // (Nf, CM, B) omega keys of each frame (double: the pairs' value bits),
  // zeroed
  unsigned long long* omk;
  unsigned* ctr;   // (Nf,) each frame's queue position, zeroed
  unsigned* sync;  // (SYNC_GEN + 1,) barrier counter, generation, zeroed
};

// The family branch's tables (FAM; host: vit_scan._vlayout, the same order).
template <class T>
struct VitFam {
  const int* row_pdf;       // (Sp,) pdf of each state row
  const int* fam_ptr;       // (Sp + 1,) row j's terms [fam_ptr[j], fam_ptr[j+1])
  const int* fam_src;       // (nfam,) source row of each term
  const T* fam_w;           // (nfam,) its weight
  const uint8_t* fam_cid;   // (nfam,) its candidate id
  const int* heavy_rows;    // (nheavy,) the rows with an item each
  const int* cbase;         // (nOv,) band id base of each overflow group
};

// A sweep's arguments: the uniform layout's, and with FAM the family tables
// too (the uniform instantiations take exactly the uniform arguments).
template <bool FAM, class T>
struct VitArgsT : VitArgs<T> {};
template <class T>
struct VitArgsT<true, T> : VitArgs<T> {
  VitFam<T> f;
};

// The pdf of the phony state (the emission row of its frame-end value):
// the tail's phony pdf P1 - 1 in the capped layout (block_scan._row_pdf).
template <bool FAM, class T>
__device__ __forceinline__ int phony_pdf(const VitArgsT<FAM, T>& p) {
  if constexpr (FAM)
    return p.m.P1 - 1;
  else
    return p.m.fin / p.m.cmax;
}

// (v, id) beats the family candidate (bv, bid): a larger product, or with
// ids (IDS) an equal one of a smaller id.
template <bool IDS, class T>
__device__ __forceinline__ bool fam_beats(T v, int id, T bv, int bid) {
  return v > bv || (IDS && v == bv && id < bid);
}

// The (max, smallest argmax) of omega[j] * a[j] as one ordered 64-bit key:
// the product's float bits (non-negative: they order as the values), then
// 2^32 - 1 - j, so that of equal products the smaller j is the larger key.
__device__ __forceinline__ unsigned long long omega_key(float v, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
         (0xffffffffu - static_cast<unsigned>(j));
}

// The same order in double, as a pair: the larger value, then the larger
// j-word.
__device__ __forceinline__ DKey omega_key(double v, int j) {
  return DKey{to_bits(v), 0xffffffffu - static_cast<unsigned>(j)};
}
__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
  return max(a, b);
}
__device__ __forceinline__ DKey key_max(DKey a, DKey b) {
  return b.v > a.v || (b.v == a.v && b.w > a.w) ? b : a;
}
template <class T>
__device__ __forceinline__ OKey<T> key_zero() {
  if constexpr (is_f64<T>())
    return DKey{0ull, 0u};
  else
    return 0ull;
}

// A double item's omega candidate of one column into its copy: a zero
// product's j-word by atomicMax into omz; a positive one into the pair
// (omk, omw) under the pair's lock, unless the pair's value, which only
// rises, is already above it.  K7n (no ids) keeps the value alone.
template <bool IDS>
__device__ __forceinline__ void omega_put(const VitArgs<double>& p, size_t at,
                                          DKey k) {
  if constexpr (!IDS) {
    atomicMax(p.omk + at, k.v);
  } else if (k.v == 0ull) {
    atomicMax(p.omz + at, k.w);
  } else if (k.v >= __ldcg(p.omk + at)) {
    unsigned* lock = p.olock + at;
    while (atomicCAS(lock, 0u, 1u) != 0u) {
    }
    __threadfence();
    const unsigned long long cv = __ldcg(p.omk + at);
    if (k.v > cv || (k.v == cv && k.w > __ldcg(p.omw + at))) {
      __stcg(p.omw + at, k.w);
      __stcg(p.omk + at, k.v);
    }
    __threadfence();
    atomicExch(lock, 0u);
  }
}

// The product's bits as a signed int of its width (non-negative values
// order as their bits), and back.
__device__ __forceinline__ int ibits(float v) { return __float_as_int(v); }
__device__ __forceinline__ long long ibits(double v) {
  return __double_as_longlong(v);
}
__device__ __forceinline__ float of_ibits(int b) { return __int_as_float(b); }
__device__ __forceinline__ double of_ibits(long long b) {
  return __longlong_as_double(b);
}
template <class T>
using IBits = typename std::conditional<is_f64<T>(), long long, int>::type;

// 4 ids in one streaming store (written once, never read in the sweep).
__device__ __forceinline__ void st_cs_u32(uint8_t* p, unsigned v) {
  asm volatile("st.global.cs.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The end of frame t - 1 (t >= 1) for column b: the phony state y[fin] =
// max_j omega[j] a[j] * e_fin (frame 0 has none: it keeps a0 * e), the scale
// 2^-k from the column max with it; CTA 0 (``record``) writes fins[t - 1]
// and advances ksum and the Kahan-compensated emission shift.  Returns the
// scale; *yfin receives the phony state (unscaled), or frame 0's stored one.
template <bool IDS, bool FAM, class T>
__device__ __forceinline__ T end_of_frame(const VitArgsT<FAM, T>& p, int t,
                                         int b, const T* prev, bool record,
                                         T* yfin) {
  const Meta& m = p.m;
  const int B = p.B;
  const size_t at = static_cast<size_t>(t - 1) * CM * B + b;
  const BitsT<T>* cm = p.cm + at;
  const unsigned long long* kp = p.omk + at;
  BitsT<T> mx = 0;
  unsigned long long key = 0ull;
  unsigned jw = 0u;  // double: the j-word of the largest value
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    mx = max(mx, __ldcg(cm + c * B));
    key = max(key, __ldcg(kp + c * B));
  }
  T mxf = from_bits(mx);
  T om;  // max_j omega[j] * a[j]
  if constexpr (is_f64<T>()) {
    om = from_bits(key);
    if constexpr (IDS) {
#pragma unroll
      for (int c = 0; c < CM; ++c)
        if (key == 0ull)
          jw = max(jw, __ldcg(p.omz + at + c * B));
        else if (__ldcg(kp + c * B) == key)
          jw = max(jw, __ldcg(p.omw + at + c * B));
    }
  } else {
    om = __uint_as_float(static_cast<unsigned>(key >> 32));
    jw = static_cast<unsigned>(key);
  }
  if ((IDS ? t : p.t0 + t) - 1 >= 1) {  // global frame 0 has no omega arc
    const T e =
        p.ext[(static_cast<size_t>(t - 1) * m.P1 + phony_pdf<FAM>(p)) * B + b];
    *yfin = om * e;
    mxf = fmax_(mxf, *yfin);
  } else {
    *yfin = __ldcg(prev + static_cast<size_t>(m.fin) * B + b);
  }
  const T k = pow2_exponent(mxf);
  if (record) {
    if constexpr (IDS)
      p.fins[static_cast<size_t>(t - 1) * B + b] =
          static_cast<int>(0xffffffffu - jw);
    p.ksum[b] += k;
    const T xc = p.mshift[static_cast<size_t>(t - 1) * B + b] - p.comp[b];
    const T ts = p.shift[b] + xc;
    p.comp[b] = (ts - p.shift[b]) - xc;
    p.shift[b] = ts;
  }
  return pow2_scale(k);
}

// The tier of one item over one resident pass (s0 .. s0 + SC - 1): for the
// thread's outputs (d = ty*4 + i, b = tx + 16c) the running max over groups
// of GS candidates and the group that first reached it (gid >= 0: a group of
// this pass; < 0: the id -gid - 1, recovered in an earlier pass), then the
// id of each output whose group lies in this pass, recovered from the
// resident operands.  Every product is >= 0 (no NaN), so its float bits
// order as its value: the maxima are taken on the bits as ints, which the
// card does three at a time (VIMNMX3: 4 instructions for a group of 8
// products, 7 as float maxima), exactly.  In double the same rule on the
// products' 64 bits as long longs.
// Without ids (IDS = false) only the running max is kept.
template <bool IDS, class T>
__device__ __forceinline__ void tier_max_arg(const VitSmem<T>& s, int nG,
                                             long long s0,
                                             IBits<T> (&best)[4][4],
                                             int (&gid)[4][4]) {
  using I = IBits<T>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int g = 0; g < nG; ++g) {
    I mx[4][4];
#pragma unroll
    for (int h = 0; h < GS / 4; ++h) {
      const int sb = g * GS + h * 4;
      V4<T> w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = lds4(&s.u.op.W[ty * 4 + i][sb]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const V4<T> x = lds4(&s.u.op.X[tx + 16 * c][sb]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const I p0 = ibits(w[i].x * x.x);
          const I p1 = ibits(w[i].y * x.y);
          const I p2 = ibits(w[i].z * x.z);
          const I p3 = ibits(w[i].w * x.w);
          const I q = max(max(p0, p1), p2);
          mx[i][c] = h == 0 ? max(q, p3) : max(max(mx[i][c], q), p3);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (IDS) {
          if (mx[i][c] > best[i][c]) {
            best[i][c] = mx[i][c];
            gid[i][c] = g;
          }
        } else {
          best[i][c] = max(best[i][c], mx[i][c]);
        }
      }
  }
  if constexpr (!IDS) return;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (gid[i][c] < 0) continue;
      const T* wr = &s.u.op.W[ty * 4 + i][gid[i][c] * GS];
      const T* xr = &s.u.op.X[tx + 16 * c][gid[i][c] * GS];
      int first = GS - 1;
#pragma unroll
      for (int h = GS / 4 - 1; h >= 0; --h) {
        const V4<T> w = lds4(wr + 4 * h);
        const V4<T> x = lds4(xr + 4 * h);
        if (ibits(w.w * x.w) == best[i][c]) first = 4 * h + 3;
        if (ibits(w.z * x.z) == best[i][c]) first = 4 * h + 2;
        if (ibits(w.y * x.y) == best[i][c]) first = 4 * h + 1;
        if (ibits(w.x * x.x) == best[i][c]) first = 4 * h;
      }
      gid[i][c] = -static_cast<int>(s0 + gid[i][c] * GS + first) - 1;
    }
}

// Stage one resident pass of a tier item: the panel's 64 destination
// columns by cp.async (L2 evict_last: every frame reads them), and the
// gathered state rows src(k, s0 + s) of the previous frame for the item's
// 64 columns, read past L1 under ``once``, rescaled and stored transposed.
// Lane (sl, h) of warp w takes rows s0 + 16u + sl (u = 0 .. SC/16 - 1),
// columns b0 + 4(2w + h) .. + 3: each warp's stores meet 32 distinct banks
// (float).  A 16-byte copy of the panel is 4 floats or 2 doubles.
template <bool VEC, class T>
__device__ __forceinline__ void stage_tier(const VitArgs<T>& p, VitSmem<T>& s,
                                           const T* __restrict__ prev,
                                           const T* sc, long long k,
                                           long long dbase, int b0,
                                           long long s0,
                                           unsigned long long once) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // values per copy
  const Meta& m = p.m;
  const int B = p.B, tid = threadIdx.x;
  const unsigned long long keep = evict_last_policy();
#pragma unroll
  for (int u = 0; u < TR * SC<T> / E / NT; ++u) {
    const int c = tid + u * NT, r = c / (SC<T> / E), q = c % (SC<T> / E);
    const long long d = dbase + r, sq = s0 + E * q;
    const bool ok = d < m.D && sq < p.Sm4;
    const T* src = ok ? p.Wt + (k * m.D + d) * p.Sm4 + sq : p.Wt;
    cp_async16_hint(&s.u.op.W[r][E * q], src, ok, keep);
  }
  cp_async_commit();
  const int lane = tid % 32, w = tid / 32, sl = lane % 16;
  const int bb = 4 * (2 * w + lane / 16), b = b0 + bb;
  V4<T> x[SC<T> / 16];
#pragma unroll
  for (int u = 0; u < SC<T> / 16; ++u) {
    const long long sr = s0 + 16 * u + sl;
    const long long j = m.g0 + k * m.gk + sr * m.gs;
    const bool ok = sr < m.Sm && j < p.RW;  // the main region only
    const T* row = prev + (ok ? j : 0) * B;
    if constexpr (is_f64<T>())
      x[u] = ok ? load4<VEC, true>(row, b, B) : zero4<T>();
    else if constexpr (VEC)
      x[u] = ok && b < B ? ldcg4_hint(row + b, once)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    else
      x[u] = ok ? load4<false, true>(row, b, B)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  T scb[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) scb[c] = b + c < B ? sc[b + c] : T(0);
#pragma unroll
  for (int u = 0; u < SC<T> / 16; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s.u.op.X[bb + c][16 * u + sl] = get(x[u], c) * scb[c];
  cp_async_wait<0>();
  __syncthreads();
}

// The family candidate of a heavy row j (FAM: an item of its own) for the
// item's 64 columns: thread row ty takes every 16th of the row's terms,
// keeping per column the max product and the smallest id among the terms
// equal to it (fam_beats); the 16 partials are merged in ty order by the
// same rule into the epilogue's table of row 0 (ep.val, ep.id), which the
// row's epilogue merges after its bands with a strict >.  The products are
// w * (a * s), the band terms' and the twin's, so the ids are the twin's.
template <bool VEC, bool IDS, class T>
__device__ __forceinline__ void heavy_max_arg(const VitArgsT<true, T>& p,
                                              VitSmem<T>& s,
                                              const T* __restrict__ prev,
                                              const T* sc, int j, int b0,
                                              unsigned long long once) {
  const VitFam<T>& f = p.f;
  const int B = p.B, tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bcol = b0 + tx * 4;
  T scv[4], bv[4];
  int bid[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    scv[c] = bcol + c < B ? sc[bcol + c] : T(0);
    bv[c] = T(-1);  // below every product: the first term enters
    bid[c] = NO_CAND;
  }
  const int q1 = f.fam_ptr[j + 1];
#pragma unroll 4
  for (int q = f.fam_ptr[j] + ty; q < q1; q += NT / 16) {
    const T w = f.fam_w[q];
    const int id = IDS ? f.fam_cid[q] : 0;
    const V4<T> x = load4_hint<VEC>(
        prev + static_cast<size_t>(f.fam_src[q]) * B, bcol, B, once);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const T v = w * (get(x, c) * scv[c]);
      if (fam_beats<IDS>(v, id, bv[c], bid[c])) {
        bv[c] = v;
        bid[c] = id;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s.u.hv.v[ty][tx * 4 + c] = bv[c];
    s.u.hv.id[ty][tx * 4 + c] = bid[c];
  }
  __syncthreads();
  if (tid < TB) {
    T v = T(-1);
    int id = NO_CAND;
    for (int q = 0; q < NT / 16; ++q)
      if (fam_beats<IDS>(s.u.hv.v[q][tid], s.u.hv.id[q][tid], v, id)) {
        v = s.u.hv.v[q][tid];
        id = s.u.hv.id[q][tid];
      }
    s.u.ep.val[0][tid] = v;
    s.u.ep.id[0][tid] = static_cast<uint8_t>(id);
  }
}

// One work item of frame t over one (row tile, column tile): a heavy row's
// tile (FAM only: tiles 0 .. nheavy-1), a tier tile (64 destinations of
// one tier block) or a band tile (64 rows of band_rows).  y = max(bands, tier) of the rescaled previous state a =
// prev * s (with ids), u = y * e (frame 0: u = a * e), stored unscaled; its
// column max and omega keys into copy blockIdx.x % CM of the frame's.
// Without ids (IDS = false) the same values, no id, and the state stored to
// ``ck`` too where that is not null (a checkpoint frame).  FAM: the row's
// family candidate merged last (heavy_max_arg for a heavy row's tile, the
// row's own thread for its few terms otherwise), the band ids of an
// overflow row from its group's base, the emission from the row's pdf.
template <bool VEC, bool IDS, bool FAM, class T>
__device__ __forceinline__ void vit_item(const VitArgsT<FAM, T>& p, int t,
                                         long long tile, int b0, int row0,
                                         VitSmemT<FAM, T>& s, const T* sc,
                                         const T* pf,
                                         const T* __restrict__ prev,
                                         T* __restrict__ out,
                                         T* __restrict__ ck) {
  const Meta& m = p.m;
  const int B = p.B, RW = p.RW, tid = threadIdx.x, tx = tid % 16,
            ty = tid / 16;
  const int bcol = b0 + tx * 4;  // this thread's epilogue columns
  const bool first = (IDS ? t : p.t0 + t) == 0;
  const bool is_heavy = FAM && tile < m.nheavy;
  const long long tt = tile - (FAM ? m.nheavy : 0);  // tier or band tile
  const bool is_tier = !is_heavy && tt < m.n_tier_tiles;
  const long long dtiles = (m.D + TR - 1) / TR;
  const long long k = is_tier ? tt / dtiles : 0;
  const long long dbase = is_tier ? (tt % dtiles) * TR : 0;
  const T* __restrict__ ext_t = p.ext + static_cast<size_t>(t) * m.P1 * B;
  uint8_t* __restrict__ bp_t = p.bps + static_cast<size_t>(t) * RW * B;
  // the state read under evict_first, the new state stored under
  // evict_last: what the next frame reads stays in L2 before what this
  // frame has read
  const unsigned long long once = evict_first_policy();
  const unsigned long long keep = evict_last_policy();

  if (tid < TR) {
    long long j = -1;
    if (is_tier) {
      const long long d = dbase + tid;
      if (d < m.D) j = m.d0 + k * m.dk + d * m.dd;
    } else if (!is_heavy) {
      const long long r = (tt - m.n_tier_tiles) * TR + tid;
      if (r < m.nband) j = row0 >= 0 ? row0 + tid : p.band_rows[r];
    }
    if constexpr (FAM) {
      if (is_heavy && tid == 0) j = p.f.heavy_rows[tile];
      int3 fr = make_int3(0, 0, static_cast<int>(m.Sm));
      if (j >= 0) {
        fr.x = p.f.fam_ptr[j];
        fr.y = p.f.fam_ptr[j + 1];
        if (j >= m.ov_lo && j < m.ov_hi)
          fr.z = p.f.cbase[(j - m.ov_lo) / m.cmax];
      }
      s.fr[tid] = fr;
      // the pdf table is read for the overflow rows only: a core row's pdf
      // is its group's, the tail's the phony one (block_scan._row_pdf)
      s.grp[tid] = j < 0          ? -1
                   : j < m.ov_lo  ? static_cast<int>(j / m.cmax)
                   : j >= m.ov_hi ? m.P1 - 1
                                  : p.f.row_pdf[j];
    } else {
      s.grp[tid] = j < 0 ? -1 : static_cast<int>(j / m.cmax);
    }
    s.rows[tid] = static_cast<int>(j);
  }
  if (is_tier) {
    IBits<T> best[4][4];  // the bits of the running max
    int gid[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        best[i][c] = -1;  // below every product's bits: the first group enters
        gid[i][c] = -1;
      }
    for (long long s0 = 0; s0 < m.Sm; s0 += SC<T>) {
      stage_tier<VEC>(p, s, prev, sc, k, dbase, b0, s0, once);
      const long long nS = m.Sm - s0 < SC<T> ? m.Sm - s0 : SC<T>;
      tier_max_arg<IDS>(s, static_cast<int>((nS + GS - 1) / GS), s0, best,
                        gid);
      __syncthreads();  // the resident operands are free
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s.u.ep.val[ty * 4 + i][tx + 16 * c] = of_ibits(best[i][c]);
        if constexpr (IDS)
          s.u.ep.id[ty * 4 + i][tx + 16 * c] =
              static_cast<uint8_t>(-gid[i][c] - 1);
      }
  }
  if constexpr (FAM)
    if (is_heavy)
      heavy_max_arg<VEC, IDS>(p, s, prev, sc, p.f.heavy_rows[tile], b0,
                              once);
  __syncthreads();

  T scv[4], pfv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    scv[c] = bcol + c < B ? sc[bcol + c] : T(0);
    pfv[c] = bcol + c < B ? pf[bcol + c] : T(0);
  }
  T colmax[4] = {T(0), T(0), T(0), T(0)};
  OKey<T> okey[4] = {key_zero<T>(), key_zero<T>(), key_zero<T>(),
                     key_zero<T>()};
  // rows in pairs: a pair's own rows and first PB band terms (weight and
  // state row) are all loaded before any is used
#pragma unroll
  for (int i0 = 0; i0 < 4; i0 += 2) {
    V4<T> pv[2], xb[2][PB];
    T wb[2][PB];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = s.rows[ty * 4 + i0 + h];
      pv[h] = j >= 0 ? load4_hint<VEC>(prev + static_cast<size_t>(j) * B,
                                       bcol, B, once)
                     : zero4<T>();
#pragma unroll
      for (int o = 0; o < PB; ++o) {
        const int src = j - m.off[o];
        const bool ok = j >= 0 && j < RW && o < m.nO && m.off[o] != 0 &&
                        src >= 0 && src < RW;
        wb[h][o] = ok ? p.band_w[static_cast<size_t>(o) * m.Sp + j] : T(0);
        xb[h][o] = ok ? load4_hint<VEC>(prev + static_cast<size_t>(src) * B,
                                        bcol, B, once)
                      : zero4<T>();
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ty * 4 + i0 + h, j = s.rows[r];
      if (j < 0) continue;
      const size_t jB = static_cast<size_t>(j) * B;
      const V4<T> e =
          load4<VEC>(ext_t + static_cast<size_t>(s.grp[r]) * B, bcol, B);
      const T om = p.omega[j];
      T a[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // the phony row of the frame before is never stored: derived
        a[c] = (j == m.fin ? pfv[c] : get(pv[h], c)) * scv[c];
        okey[c] = key_max(okey[c], omega_key(om * a[c], j));
      }
      const bool main_row = j < RW;
      T vb[4] = {T(0), T(0), T(0), T(0)};
      int cb[4] = {NO_CAND, NO_CAND, NO_CAND, NO_CAND};
      if (main_row) {
        int cb0 = static_cast<int>(m.Sm);
        if constexpr (FAM) cb0 = s.fr[r].z;
#pragma unroll
        for (int o = 0; o < MAX_BANDS; ++o) {
          if (o >= m.nO) break;  // uniform across the block
          const int src = j - m.off[o];
          if (src < 0 || src >= RW) continue;  // no arc from outside
          const T w = o < PB && m.off[o] != 0
                          ? wb[h][o < PB ? o : 0]
                          : p.band_w[static_cast<size_t>(o) * m.Sp + j];
          const V4<T> x =
              m.off[o] == 0 ? pv[h]
              : o < PB      ? xb[h][o < PB ? o : 0]
                            : load4_hint<VEC>(
                                  prev + static_cast<size_t>(src) * B, bcol,
                                  B, once);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const T v = w * (get(x, c) * scv[c]);
            if (v > vb[c]) {
              vb[c] = v;
              cb[c] = cb0 + o;
            }
          }
        }
        if (is_tier || is_heavy) {  // a heavy row's: its family candidate
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const T tv = s.u.ep.val[r][tx * 4 + c];
            if (tv > vb[c]) {
              vb[c] = tv;
              if constexpr (IDS) cb[c] = s.u.ep.id[r][tx * 4 + c];
            }
          }
        }
        if constexpr (FAM) {  // the row's few family terms, pulled here
          if (!is_heavy) {
            T fv[4] = {T(-1), T(-1), T(-1), T(-1)};
            int fid[4] = {NO_CAND, NO_CAND, NO_CAND, NO_CAND};
            const int e1 = s.fr[r].y;
            for (int q = s.fr[r].x; q < e1; ++q) {
              const T w = p.f.fam_w[q];
              const int id = IDS ? p.f.fam_cid[q] : 0;
              const V4<T> x = load4_hint<VEC>(
                  prev + static_cast<size_t>(p.f.fam_src[q]) * B, bcol, B,
                  once);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const T v = w * (get(x, c) * scv[c]);
                if (fam_beats<IDS>(v, id, fv[c], fid[c])) {
                  fv[c] = v;
                  fid[c] = id;
                }
              }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (fv[c] > vb[c]) {
                vb[c] = fv[c];
                cb[c] = fid[c];
              }
          }
        }
      }
      T y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y[c] = (first ? a[c] : vb[c]) * get(e, c);
        colmax[c] = fmax_(colmax[c], y[c]);
      }
      if (first || j != m.fin) {
        store4_hint<VEC>(out + jB, bcol, B, make4<T>(y[0], y[1], y[2], y[3]),
                         keep);
        if constexpr (!IDS)
          if (ck != nullptr)
            store4_hint<VEC>(ck + jB, bcol, B,
                             make4<T>(y[0], y[1], y[2], y[3]), once);
      }
      if (IDS && main_row) {
        if constexpr (VEC) {
          if (bcol < B)
            st_cs_u32(bp_t + jB + bcol,
                      static_cast<unsigned>(cb[0]) |
                          (static_cast<unsigned>(cb[1]) << 8) |
                          (static_cast<unsigned>(cb[2]) << 16) |
                          (static_cast<unsigned>(cb[3]) << 24));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (bcol + c < B) bp_t[jB + bcol + c] = static_cast<uint8_t>(cb[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s.u.ep.rm[ty][tx * 4 + c] = to_bits(colmax[c]);
    s.u.ep.rk[ty][tx * 4 + c] = okey[c];
  }
  __syncthreads();
  if (tid < TB && b0 + tid < B) {
    BitsT<T> mx = 0;
    OKey<T> key = key_zero<T>();
    for (int q = 0; q < 16; ++q) {
      mx = max(mx, s.u.ep.rm[q][tid]);
      key = key_max(key, s.u.ep.rk[q][tid]);
    }
    const size_t at = (static_cast<size_t>(t) * CM + blockIdx.x % CM) * B +
                      b0 + tid;
    atomicMax(p.cm + at, mx);
    if constexpr (is_f64<T>())
      omega_put<IDS>(p, at, key);
    else
      atomicMax(p.omk + at, key);
  }
  __syncthreads();  // the tables and the union are free for the next item
}

// The slot frame f of a K7n launch is saved in, or -1.
template <class T>
__device__ __forceinline__ int save_slot(const VitArgs<T>& p, int f) {
  return (f + 1) % p.stride == 0 ? (f + 1) / p.stride - 1 : -1;
}

// Where frame f's state is kept: K7's ping-pong pair, or K7n's saved frames
// when it saves every frame.
template <bool IDS, class T>
__device__ __forceinline__ T* state_of(const VitArgs<T>& p, int f,
                                       size_t SB) {
  if (!IDS && p.stride == 1) return p.save + static_cast<size_t>(f) * SB;
  return p.work + (f % 2) * SB;
}

// K7n's record of frame f (CTA 0, column b): its scale and its phony row
// in the frame's save slot, if it has one.  Returns the slot.
template <class T>
__device__ __forceinline__ int record_save(const VitArgs<T>& p, int f, int b,
                                           T scale, T yfin, size_t SB) {
  const int slot = save_slot(p, f);
  if (slot >= 0) {
    p.save_scale[static_cast<size_t>(slot) * p.B + b] = scale;
    p.save[slot * SB + static_cast<size_t>(p.m.fin) * p.B + b] = yfin;
  }
  return slot;
}

// K7 over frames 0 .. Nf-1: each frame, every CTA derives the scale and the
// phony state of the frame before for all B columns (CTA 0 also records its
// fins, ksum and shift), then takes items from the frame's queue; one grid
// barrier per frame.  After the last: frame Nf-1's end, its scale and its
// phony state.  K7n (IDS = false) saves its frames on the way (save_slot).
template <bool VEC, bool IDS, bool FAM, class T>
__global__ void __launch_bounds__(NT, VIT_BLOCKS)
    vit_sweep_kernel(const __grid_constant__ VitArgsT<FAM, T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  VitSmemT<FAM, T>& s = *reinterpret_cast<VitSmemT<FAM, T>*>(smem_raw);
  T* sc = reinterpret_cast<T*>(smem_raw + sizeof(VitSmemT<FAM, T>));
  T* pf = sc + p.B;
  const Meta& m = p.m;
  const int B = p.B, ncb = (B + TB - 1) / TB, tid = threadIdx.x;
  const size_t SB = static_cast<size_t>(m.Sp) * B;
  const size_t PB1 = static_cast<size_t>(m.P1) * B;
  for (int t = 0; t < p.Nf; ++t) {
    const T* prev = t == 0 ? p.a0 : state_of<IDS>(p, t - 1, SB);
    T* out = state_of<IDS>(p, t, SB);
    T* ck = nullptr;  // K7n: a checkpoint frame's save slot
    if constexpr (!IDS)
      if (p.stride > 1 && save_slot(p, t) >= 0)
        ck = p.save + static_cast<size_t>(save_slot(p, t)) * SB;
    if (t + 1 < p.Nf) {  // the next frame's emissions into L2, spread
      constexpr int LINE = 128 / sizeof(T);  // values per 128-byte line
      const T* e = p.ext + (t + 1) * PB1;
      const size_t n_e = (PB1 + LINE - 1) / LINE;
      for (size_t i = static_cast<size_t>(blockIdx.x) * NT + tid; i < n_e;
           i += static_cast<size_t>(gridDim.x) * NT)
        prefetch_l2(e + i * LINE);
    }
    for (int b = tid; b < B; b += NT) {
      if (t == 0) {
        sc[b] = IDS || p.s0 == nullptr ? T(1) : p.s0[b];
        pf[b] = p.a0[static_cast<size_t>(m.fin) * B + b];
      } else {
        sc[b] = end_of_frame<IDS, FAM>(p, t, b, prev, blockIdx.x == 0,
                                       &pf[b]);
        if constexpr (!IDS)
          if (blockIdx.x == 0) record_save(p, t - 1, b, sc[b], pf[b], SB);
      }
    }
    // items from the frame's queue: thread 0 takes the next position and
    // reads its entry while the current item runs
    auto take = [&]() {
      const int q = static_cast<int>(atomicAdd(p.ctr + t, 1u));
      return q < p.n_items ? p.queue[q] : make_int2(-1, -1);
    };
    if (tid == 0) s.next[0] = take();
    __syncthreads();
    int par = 0;
    for (int2 q = s.next[0]; q.x >= 0; q = s.next[par]) {
      if (tid == 0) s.next[par ^ 1] = take();
      vit_item<VEC, IDS, FAM>(p, t, q.x / ncb, (q.x % ncb) * TB, q.y, s, sc,
                              pf, prev, out, ck);
      par ^= 1;  // vit_item ends with a block barrier: s.next[par] is set
    }
    grid_sync<SYNC_GEN, 256, true>(p.sync);
  }
  if (blockIdx.x == 0) {  // frame Nf-1's end
    const int t = p.Nf;
    T* prev = state_of<IDS>(p, t - 1, SB);
    for (int b = tid; b < B; b += NT) {
      T yfin;
      p.scale[b] = end_of_frame<IDS, FAM>(p, t, b, prev, true, &yfin);
      if ((IDS ? t : p.t0 + t) - 1 >= 1)
        prev[static_cast<size_t>(m.fin) * B + b] = yfin;
      if constexpr (!IDS) record_save(p, t - 1, b, p.scale[b], yfin, SB);
    }
  }
}

// The backtrace of one sequence per thread (viterbi._viterbi_scale_bp's
// wstep): from the phony state at frame Nf-1 down to frame 1, decode the id
// c of the current state s to its source: on a core row the tier source
// (c < Sm), a band offset, or the out-family source ovout[s] (c = Sm + nO);
// on an overflow row [ov_lo, ov_hi) ov_dec[s - ov_lo, c]; the phony state
// for an id without a source (255, or -1 in a table).  At t == length the
// source is the frame's omega argmax, past the length the phony state.
// states[t-1, b] receives the state of frame t-1 (compiled numbering).
__global__ void __launch_bounds__(WALK_THREADS) vit_walk_kernel(
    const uint8_t* __restrict__ bps, const int* __restrict__ fins,
    const int* __restrict__ lengths, const int* __restrict__ k_of,
    const int* __restrict__ sidx, const int* __restrict__ offs,
    const int* __restrict__ ov_dec, const int* __restrict__ ovout, int Nf,
    int RW, int B, int Sp, int K, int Sm, int nO, int fin, int ov_lo,
    int ov_hi, int n_dec, int* __restrict__ states) {
  const int b = blockIdx.x * WALK_THREADS + threadIdx.x;
  if (b >= B) return;
  const int L = lengths[b];
  const int nOff = nO > 0 ? nO : 1;
  int s = fin;
  for (int t = Nf - 1; t >= 1; --t) {
    const int c =
        s < RW ? bps[(static_cast<size_t>(t) * RW + s) * B + b] : NO_CAND;
    const int sc = min(max(s, 0), Sp - 1);
    const int ks = min(max(k_of[sc], 0), K - 1);
    const int tier_src = sidx[ks * Sm + min(max(c, 0), Sm - 1)];
    const int band_src = s - offs[min(max(c - Sm, 0), nOff - 1)];
    int src = c < Sm ? tier_src : band_src;
    if (c == Sm + nO) src = ovout[sc] >= 0 ? ovout[sc] : fin;
    if (s >= ov_lo && s < ov_hi) {
      const int od = ov_dec[static_cast<size_t>(s - ov_lo) * 256 + c];
      src = od >= 0 ? od : fin;
    }
    if (c == NO_CAND) src = fin;
    int sp = t == L ? fins[static_cast<size_t>(t) * B + b] : src;
    if (t > L) sp = fin;
    states[static_cast<size_t>(t - 1) * B + b] = sp;
    s = sp;
  }
}

// Dynamic shared memory of one CTA at batch B.
size_t vit_smem_bytes(int B, bool fam, bool f64) {
  if (f64)
    return (fam ? sizeof(VitSmemT<true, double>) : sizeof(VitSmem<double>)) +
           2 * static_cast<size_t>(B) * sizeof(double);
  return (fam ? sizeof(VitSmemT<true, float>) : sizeof(VitSmem<float>)) +
         2 * static_cast<size_t>(B) * sizeof(float);
}

template <bool FAM, class T>
const void* vit_kernel(bool vec, bool ids) {
  if (ids)
    return vec ? (const void*)vit_sweep_kernel<true, true, FAM, T>
               : (const void*)vit_sweep_kernel<false, true, FAM, T>;
  return vec ? (const void*)vit_sweep_kernel<true, false, FAM, T>
             : (const void*)vit_sweep_kernel<false, false, FAM, T>;
}

const void* vit_kernel(bool vec, bool ids, bool fam, bool f64) {
  if (f64)
    return fam ? vit_kernel<true, double>(vec, ids)
               : vit_kernel<false, double>(vec, ids);
  return fam ? vit_kernel<true, float>(vec, ids)
             : vit_kernel<false, float>(vec, ids);
}

// CTAs of the sweep that can be co-resident on the current device at batch
// B (0 where the device cannot launch cooperatively).
cudaError_t vit_co_resident(bool vec, bool ids, bool fam, bool f64, int B,
                            int* n) {
  const void* kern = vit_kernel(vec, ids, fam, f64);
  const size_t smem = vit_smem_bytes(B, fam, f64);
  int dev = 0, n_sm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                        smem);
  *n = coop ? per_sm * n_sm : 0;
  return err;
}

// The zeroed scratch of a sweep at batch B and Nf frames, carved from one
// buffer, n = Nf x CM x B words each: the omega keys omk (64-bit; double:
// the pairs' value bits), the column maxima cm (32-bit; double: 64-bit),
// double only the pairs' j-words omw, the zero j-words omz and the pairs'
// locks (32-bit each), then the queue positions ctr (Nf) and the barrier's
// SYNC_GEN + 1 words.  Bytes, or -1 past 2^62.
long long vit_scratch_bytes(int B, int Nf, bool f64) {
  if (B <= 0 || Nf <= 0) return -1;
  const long long n_cm = static_cast<long long>(Nf) * CM * B;
  if (f64) return n_cm * 16 + (3 * n_cm + Nf + SYNC_GEN + 1) * 4;
  return n_cm * 8 + (n_cm + Nf + SYNC_GEN + 1) * 4;
}

// The family tables from the host's int64 array (vit_scan._vlayout: seven
// device addresses).
template <class T>
VitFam<T> parse_fam(const long long* a) {
  VitFam<T> f;
  f.row_pdf = reinterpret_cast<const int*>(a[0]);
  f.fam_ptr = reinterpret_cast<const int*>(a[1]);
  f.fam_src = reinterpret_cast<const int*>(a[2]);
  f.fam_w = reinterpret_cast<const T*>(a[3]);
  f.fam_cid = reinterpret_cast<const uint8_t*>(a[4]);
  f.heavy_rows = reinterpret_cast<const int*>(a[5]);
  f.cbase = reinterpret_cast<const int*>(a[6]);
  return f;
}

// The cooperative launch of K7 (ids) or K7n on n_ctas CTAs, all of them
// co-resident, in the family instantiation (FAM, its tables from ilay) or
// the uniform one.
template <bool FAM, class T>
cudaError_t launch(const VitArgs<T>& a, const long long* ilay, bool ids,
                   int n_ctas, void* stream) {
  const bool vec = a.B % 4 == 0, f64 = is_f64<T>();
  int max_ctas = 0;
  cudaError_t err = vit_co_resident(vec, ids, FAM, f64, a.B, &max_ctas);
  if (err != cudaSuccess) return err;
  if (n_ctas > max_ctas) return cudaErrorCooperativeLaunchTooLarge;
  VitArgsT<FAM, T> arg{};
  static_cast<VitArgs<T>&>(arg) = a;
  if constexpr (FAM) arg.f = parse_fam<T>(ilay);
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(vit_kernel(vec, ids, FAM, f64),
                                    dim3(n_ctas), dim3(NT), args,
                                    vit_smem_bytes(a.B, FAM, f64),
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <class T>
cudaError_t launch(const VitArgs<T>& a, const long long* ilay, bool ids,
                   int n_ctas, void* stream) {
  return is_fam(a.m) ? launch<true>(a, ilay, ids, n_ctas, stream)
                     : launch<false>(a, ilay, ids, n_ctas, stream);
}

// The layout predicates of a descriptor: the uniform one (no overflow rows,
// family terms or heavy rows; Sm + nO ids), or the capped one (FAM: its
// tables in ilay, the overflow rows inside the main region, Sm + nO + 1
// ids on the core rows).
bool layout_ok(const Meta& m, const long long* ilay, int RW) {
  if (!is_fam(m))
    return m.ov_lo == m.Sp && m.nfam == 0 && m.nheavy == 0 &&
           m.Sm + m.nO < NO_CAND;
  return ilay != nullptr && m.Sm + m.nO + 1 < NO_CAND && m.ov_hi <= RW;
}

// The arguments K7 and K7n share, checked; false if any is out of range.
template <class T>
bool common_args(VitArgs<T>* a, const long long* imeta, const long long* ilay,
                 int B, int Nf, int RW, int n_items, int n_ctas,
                 void* scratch, long long scratch_bytes) {
  if (!parse_meta(imeta, &a->m) || !layout_ok(a->m, ilay, RW) || B <= 0 ||
      Nf <= 0 || RW <= 0 || RW > a->m.Sp || a->m.fin < RW || n_ctas <= 0 ||
      n_items != a->m.n_tiles * ((B + TB - 1) / TB) ||
      scratch_bytes != vit_scratch_bytes(B, Nf, is_f64<T>()) ||
      reinterpret_cast<size_t>(scratch) % 8 != 0)
    return false;
  const size_t n_cm = static_cast<size_t>(Nf) * CM * B;
  a->B = B;
  a->Nf = Nf;
  a->RW = RW;
  a->omk = static_cast<unsigned long long*>(scratch);
  unsigned* words;
  if constexpr (is_f64<T>()) {
    a->cm = a->omk + n_cm;
    a->omw = reinterpret_cast<unsigned*>(a->cm + n_cm);
    a->omz = a->omw + n_cm;
    a->olock = a->omz + n_cm;
    words = a->olock + n_cm;
  } else {
    a->cm = reinterpret_cast<unsigned*>(a->omk + n_cm);
    words = a->cm + n_cm;
  }
  a->ctr = words;
  a->sync = a->ctr + Nf;
  return true;
}

// K7's arguments in the value type T (K7n adds its own).
template <class T>
VitArgs<T> sweep_args(const void* a0, const void* ext, const void* mshift,
                      const void* band_w, const void* Wt, const void* omega,
                      const int* band_rows, const int* queue, int n_items,
                      void* work, void* scale, void* ksum, void* shift,
                      void* comp) {
  VitArgs<T> a{};
  a.a0 = static_cast<const T*>(a0);
  a.ext = static_cast<const T*>(ext);
  a.mshift = static_cast<const T*>(mshift);
  a.band_w = static_cast<const T*>(band_w);
  a.Wt = static_cast<const T*>(Wt);
  a.omega = static_cast<const T*>(omega);
  a.band_rows = band_rows;
  a.queue = reinterpret_cast<const int2*>(queue);
  a.n_items = n_items;
  a.work = static_cast<T*>(work);
  a.scale = static_cast<T*>(scale);
  a.ksum = static_cast<T*>(ksum);
  a.shift = static_cast<T*>(shift);
  a.comp = static_cast<T*>(comp);
  a.stride = 1;
  return a;
}

template <class T>
int vit_fwd(const void* a0, const void* ext, const void* mshift,
            const void* band_w, const void* Wt, const void* omega,
            const int* band_rows, const long long* imeta,
            const long long* ilay, const int* queue, int n_items, int n_ctas,
            int B, int Nf, int RW, void* work, uint8_t* bps, int* fins,
            void* scale, void* ksum, void* shift, void* comp, void* scratch,
            long long scratch_bytes, void* stream) {
  VitArgs<T> a = sweep_args<T>(a0, ext, mshift, band_w, Wt, omega, band_rows,
                               queue, n_items, work, scale, ksum, shift,
                               comp);
  if (!common_args(&a, imeta, ilay, B, Nf, RW, n_items, n_ctas, scratch,
                   scratch_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  a.Sm4 = (a.m.Sm + 3) / 4 * 4;
  a.bps = bps;
  a.fins = fins;
  return static_cast<int>(launch(a, ilay, true, n_ctas, stream));
}

template <class T>
int vit_fwd_noid(const void* a0, const void* s0, const void* ext,
                 const void* mshift, const void* band_w, const void* Wt,
                 const void* omega, const int* band_rows,
                 const long long* imeta, const long long* ilay,
                 const int* queue, int n_items, int n_ctas, int B, int Nf,
                 int RW, int t0, int stride, void* work, void* save,
                 void* save_scale, int n_save, void* scale, void* ksum,
                 void* shift, void* comp, void* scratch,
                 long long scratch_bytes, void* stream) {
  VitArgs<T> a = sweep_args<T>(a0, ext, mshift, band_w, Wt, omega, band_rows,
                               queue, n_items, work, scale, ksum, shift,
                               comp);
  if (!common_args(&a, imeta, ilay, B, Nf, RW, n_items, n_ctas, scratch,
                   scratch_bytes) ||
      t0 < 0 || stride <= 0 || n_save != Nf / stride ||
      (n_save > 0 && (save == nullptr || save_scale == nullptr)) ||
      (stride > 1 && work == nullptr) || s0 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.Sm4 = (a.m.Sm + 3) / 4 * 4;
  a.s0 = static_cast<const T*>(s0);
  a.save = static_cast<T*>(save);
  a.save_scale = static_cast<T*>(save_scale);
  a.t0 = t0;
  a.stride = stride;
  return static_cast<int>(launch(a, ilay, false, n_ctas, stream));
}

}  // namespace

// K7's layout at batch B and Nf frames in float (f64 == 0) or double: out[0]
// the bytes of the zeroed scratch mm_vit_fwd takes, out[1] the tier
// candidates per max group (GS).
extern "C" int mm_vit_layout(int B, int Nf, int f64, long long* out) {
  const long long n = vit_scratch_bytes(B, Nf, f64 != 0);
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = n;
  out[1] = GS;
  return static_cast<int>(cudaSuccess);
}

// CTAs of the K7 launch (ids != 0) or the K7n one (ids == 0), in the family
// instantiation (fam != 0) or the uniform one, in double (f64 != 0) or
// float, that can be co-resident on the current device at batch B (vec:
// B % 4 == 0), or minus a CUDA error code.
extern "C" int mm_vit_ctas(int vec, int ids, int fam, int f64, int B) {
  int n = 0;
  if (B <= 0) return -static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      vit_co_resident(vec != 0, ids != 0, fam != 0, f64 != 0, B, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// K7: the tropical sweep over frames 0 .. Nf-1 from a0 (the initial state,
// (Sp, B), with scale 1) in one cooperative launch of n_ctas CTAs, which
// take every frame's items from queue (ops/vit_scan.py vit_plan: n_items =
// n_tiles * ceil(B / 64) pairs of ints).  Wt: the tier panels transposed,
// (K, D, Sm4) with Sm4 = Sm rounded up to 4, zero-padded.  Frame t writes
// work[t % 2] (unscaled; the phony row only for t = 0 and t = Nf - 1),
// ids[t] and fins[t]; on return scale is the last frame's, so v_final =
// work[(Nf-1) % 2][fin] * scale.  ksum, shift and comp are zero on entry;
// scratch: scratch_bytes (mm_vit_layout) of zeroes, 8-byte aligned.  A
// capped layout (imeta's overflow rows, family terms or heavy rows) takes
// the family instantiation, its tables at the addresses of ilay
// (vit_scan._vlayout); the uniform one does not read ilay.  f64 != 0: every
// value (a0 .. omega, work, scale .. comp, the family weights) is double.
extern "C" int mm_vit_fwd(
    const void* a0, const void* ext, const void* mshift, const void* band_w,
    const void* Wt, const void* omega, const int* band_rows,
    const long long* imeta, const long long* ilay, const int* queue,
    int n_items, int n_ctas, int B, int Nf, int RW, int f64, void* work,
    uint8_t* bps, int* fins, void* scale, void* ksum, void* shift, void* comp,
    void* scratch, long long scratch_bytes, void* stream) {
  auto run = f64 ? &vit_fwd<double> : &vit_fwd<float>;
  return run(a0, ext, mshift, band_w, Wt, omega, band_rows, imeta, ilay,
             queue, n_items, n_ctas, B, Nf, RW, work, bps, fins, scale, ksum,
             shift, comp, scratch, scratch_bytes, stream);
}

// K7n: K7 without the ids over launch frames 0 .. Nf-1, which are global
// frames t0 .. t0 + Nf - 1 (ext and mshift hold just these), from a0 with
// the per-column scale s0.  Frame f is saved, unscaled with its phony row,
// in save[slot] with its scale in save_scale[slot] when (f + 1) % stride ==
// 0, slot = (f + 1) / stride - 1: n_save = Nf / stride slots.  With stride
// 1 every frame is saved and save is the sweep's state buffer (work may be
// null); otherwise the sweep runs in work (2, Sp, B).  On return scale is
// the last frame's; ksum, shift and comp carry on from their values on
// entry (zero for a sweep from frame 0).  The other arguments as for
// mm_vit_fwd.
extern "C" int mm_vit_fwd_noid(
    const void* a0, const void* s0, const void* ext, const void* mshift,
    const void* band_w, const void* Wt, const void* omega,
    const int* band_rows, const long long* imeta, const long long* ilay,
    const int* queue, int n_items, int n_ctas, int B, int Nf, int RW, int t0,
    int stride, int f64, void* work, void* save, void* save_scale,
    int n_save, void* scale, void* ksum, void* shift, void* comp,
    void* scratch, long long scratch_bytes, void* stream) {
  auto run = f64 ? &vit_fwd_noid<double> : &vit_fwd_noid<float>;
  return run(a0, s0, ext, mshift, band_w, Wt, omega, band_rows, imeta, ilay,
             queue, n_items, n_ctas, B, Nf, RW, t0, stride, work, save,
             save_scale, n_save, scale, ksum, shift, comp, scratch,
             scratch_bytes, stream);
}

// The walk over ids (Nf, RW, B) and fins (Nf, B) into states (Nf-1, B).
// ov_dec (n_dec, 256): the sources of the overflow rows [ov_lo, ov_hi)
// (n_dec = ov_hi - ov_lo; ov_lo = ov_hi = Sp and one row of -1 without
// families); ovout (Sp,): the core rows' out-family sources, -1 for none.
extern "C" int mm_vit_walk(const uint8_t* bps, const int* fins,
                           const int* lengths, const int* k_of,
                           const int* sidx, const int* offs,
                           const int* ov_dec, const int* ovout, int Nf,
                           int RW, int B, int Sp, int K, int Sm, int nO,
                           int fin, int ov_lo, int ov_hi, int n_dec,
                           int* states, void* stream) {
  if (Nf <= 0 || RW <= 0 || B <= 0 || Sp < RW || K <= 0 || Sm <= 0 ||
      nO < 0 || fin < 0 || fin >= Sp || ov_lo < 0 || ov_lo > ov_hi ||
      ov_hi > Sp || n_dec < ov_hi - ov_lo || n_dec <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Nf == 1) return static_cast<int>(cudaSuccess);
  vit_walk_kernel<<<(B + WALK_THREADS - 1) / WALK_THREADS, WALK_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      bps, fins, lengths, k_of, sidx, offs, ov_dec, ovout, Nf, RW, B, Sp, K,
      Sm, nO, fin, ov_lo, ov_hi, n_dec, states);
  return static_cast<int>(cudaGetLastError());
}
