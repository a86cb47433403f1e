// The content-attention pair: the ContentUnit between its projections,
// forward and backward, shared by every kernel that runs the content unit
// (K4 and K2 through smin_units.cuh's `content_pair`, K3's recompute, K7,
// K9 and K10; the backward by K3, K7 and K10 through content_bwd.cuh).
//
// Function (per element b, for each pair n of its N and each clip row c of
// the pair's C; h, q (B*N*C, dl) n-major rows, h already masked by vmask;
// khat, fwh (B*Nq, dl) with fwh masked by the query mask; fsh (B, dl)):
//   p[c]  = softmax_m(q[c] . khat[m] / sqrt(dl), -1e9 at a masked word m)
//   g[c]  = h[c] * ((p[c] fwh) * vm[n] + fsh)
//   A     = softmax_e(g[c] . g[e] / sqrt(dl)) * vm[n]   (unmasked, then scaled)
//   fcc[c] = sum_e A[c, e] h[e]
// and its backward from dfcc: dh (the paths through A and g; the attn_q
// path is the caller's GEMM), dq, and the per-element sums dfwh[m] =
// sum_r p[r, m] da[r], dkhat[m] = sum_r ds[r, m] q[r], dfsh = sum_r dg[r] *
// h[r], with da = dg * h * vm and ds the word logits' gradient.
//
// Replaces the content attention inside the JAX package's kernels
// (ops/smin_pallas.py:351-406 in `smi_layer_rows`, the body of
// smin_stack_fused, smin_train_pallas.py's layer kernels, which run the same
// body, and content_train_pallas.py's `_content_rows`).
//
// What bounds it on the H100: bytes. About 12 kFLOP per clip row (C * Nq *
// dl * 4 for the word attention, C * C * dl * 4 for the clip attention)
// against 3 * dl * 4 bytes moved (h, q in, fcc out; 5 * dl * 4 for the
// backward: h, q, dfcc in, dh, dq out): 0.128 ms at Charades B=512 and
// 0.244 ms at ActivityNet B=64 for the forward over 3.35 TB/s.
//
// Design. A block of 256 threads takes one element and a tile of pairs,
// cut on the host (`content_attn_plan`) into passes of `pp` pairs (at most
// 64 clip rows); the tile ends at the element's last pair. The element's
// khat and fwh are staged once per block in shared memory with 16-byte
// cp.async, then each pass stages its rows (contiguous in memory, n-major)
// once, coalesced, and runs in phases over shared memory, each spread over
// all 256 threads:
//   word logits   q khat^T as a register-tiled product (a thread: up to 4
//                 rows x a word group, over a quarter of dl's chunks; a
//                 transposing shuffle reduction), the softmax over the
//                 row's lanes with shuffles;
//   p fwh, g      a thread: 4 rows x 16-byte chunks of dl;
//   clip logits   one dot product of two of a pair's rows per thread;
//   clip softmax  one row per thread over its C logits;
//   A h           as p fwh, written to fcc with 16-byte stores.
// With C = 4 (every shipped config) a thread's 4 rows are one pair, so the
// last four phases run as one: g, the pair's Gram sums (added across the
// pair's lanes with shuffles), A and A h stay in registers (the backward's
// clip softmax, dA = dfcc h^T and the rows' gradients the same way).
// The backward recomputes p, g and A per pass and adds dfwh, dkhat (in
// shared memory, each float owned by one thread) and dfsh (in registers)
// over its tile's rows in a fixed order, then writes one partial per tile;
// `content_partial_reduce_kernel` adds an element's partials in tile order.
// No atomics anywhere: a run is bit for bit repeatable. Widths that are no
// multiple of 4 (or unaligned pointers) take the same kernels with scalar
// copies (kVec false). Both have a bf16 variant (`content_attn_forward` and
// `content_attn_backward` on bf16 rows; K4-bf16 and K2-bf16 run the forward,
// K3-bf16, K7-bf16 and K10-bf16 both), with the fp32 kernels' arithmetic on
// the bf16 values. The forward converts the rows to fp32 as it stages them,
// so its plan and shared memory are the fp32 forward's. The backward keeps
// them bf16 (`ca_bwd_layout`), staged by 8-byte cp.async, at half the fp32
// rows' bytes (a block's shared memory 120 KB against 213 KB at the
// Charades width); its passes, tiles and arithmetic are the fp32
// backward's. (Two blocks an SM on passes of 32 rows, and the next pass
// staged behind the current one, were each measured no faster, PERF.md §6:
// the kernel is held by its phases' latency at one block an SM, and at two
// by the 128-register cap.) The
// forward writes fcc in bf16; the backward writes dq and dkhat (the operands
// of K3-bf16's next products) and dfsh in bf16, and dh and dfwh in fp32,
// since the layer's projections add to them before they are rounded.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "gemm.cuh"

namespace vml {

constexpr float kNegInf = -1e9f;          // the JAX units' mask fill, not -inf
constexpr int kCaThreads = 256;
constexpr int kCaRows = 64;               // clip rows per pass
constexpr int kCaSms = 132;               // H100 SXM
constexpr int kCaMaxPasses = 16;
constexpr size_t kCaMaxSmem = 232448;     // dynamic shared memory of one block
constexpr size_t kCaSmemPerSm = 233472;   // 228 KB per SM
constexpr size_t kCaReservedPerBlock = 1024;

// Launches of the pair's two kernels by this library's host code (forward,
// backward), for the launch counts of a run. A namespace-scope static has
// internal linkage: each .cu (its own library) keeps its own.
static long long g_content_attn_launches[2];

// The shapes of one block's shared memory. Rows of dl floats are padded to
// a stride of DS = 4 * ceil(dl / 4) + 4 floats (16-byte chunks, and
// consecutive rows on other banks); words to NQ4 = a multiple of 4 (zero
// keys and values past Nq, no softmax weight).
struct CaShape {
    int dl4, DS, NQ4, R, RP, PP4;
};

__host__ __device__ inline CaShape ca_shape(int pp, int C, int Nq, int dl) {
    CaShape s;
    s.dl4 = (dl + 3) / 4;
    s.DS = s.dl4 * 4 + 4;
    s.NQ4 = (Nq + 3) / 4 * 4;
    s.R = pp * C;
    s.RP = (s.R + 3) / 4 * 4;
    s.PP4 = (pp + 3) / 4 * 4;
    return s;
}

// Floats of one block's shared memory (every array a multiple of 4 floats).
__host__ __device__ inline size_t ca_smem_floats(int pp, int C, int Nq, int dl, bool backward) {
    const CaShape s = ca_shape(pp, C, Nq, dl);
    size_t f = (size_t)2 * s.NQ4 * s.DS + s.DS + s.NQ4 + s.PP4;   // K, V, fsh, qmask, vm
    if (!backward) return f + (size_t)2 * s.RP * s.DS + (size_t)s.RP * s.NQ4 + (size_t)s.RP * C;
    return f + (size_t)5 * s.RP * s.DS       // Q, H, dfcc, G, U (U turns into da)
           + (size_t)2 * s.RP * s.NQ4        // p and ds
           + (size_t)2 * s.RP * C            // clip attention, its logit gradient
           + (size_t)2 * s.NQ4 * s.dl4 * 4;  // the tile's dfwh, dkhat
}

// Row-group layout of the "4 rows x chunks" phases: RG groups of 4 rows, DG
// threads over the chunks of each group.
__host__ __device__ inline int ca_row_groups(int RP) { return RP / 4; }
__host__ __device__ inline int ca_chunk_threads(int RP) { return kCaThreads / (RP / 4); }

// With C = 4 a pass's row group of 4 rows is one pair, and its DG threads
// (a power of two up to a warp) are consecutive lanes: the clip attention
// of the pair then runs in their registers, its sums over dl added across
// the DG lanes with shuffles (`ca_fused_pairs`).
__host__ __device__ inline bool ca_fused_pairs(int C, int DG) {
    return C == 4 && DG <= 32 && (DG & (DG - 1)) == 0;
}

// The backward's shared memory, byte offsets of its arrays (each 16-byte
// aligned). fp32 rows: the arrays of `ca_smem_floats`, in its order. bf16
// rows (the bf16 backward): khat, fwh, q, h and dfcc staged as bf16 rows of
// DSH = 4 * dl4 + 8 elements (8-byte cp.async chunks; consecutive rows 4
// banks apart), and on the fused path (`ca_fused_pairs`) neither g nor the
// clip attention's arrays (registers): 120 KB at the Charades and TACoS
// widths where the fp32 rows take 213 KB.
struct CaBwdLayout {
    size_t K, V, fsh, qm, vm, Q, H, O, G, U, Pr, Dr, As, dAs, Fw, Fk, bytes;
    int DSS;      // the stride of the staged rows K, V, Q, H, O, in elements
    bool fused;
};

__host__ __device__ inline CaBwdLayout ca_bwd_layout(int pp, int C, int Nq, int dl, bool bf16) {
    const CaShape s = ca_shape(pp, C, Nq, dl);
    CaBwdLayout l{};
    l.fused = ca_fused_pairs(C, ca_chunk_threads(s.RP));
    l.DSS = bf16 ? s.dl4 * 4 + 8 : s.DS;
    const size_t row = (size_t)l.DSS * (bf16 ? 2 : 4);   // bytes of a staged row
    const size_t row32 = (size_t)s.DS * 4;
    const bool all = !bf16 || !l.fused;
    size_t off = 0;
    auto take = [&off](size_t bytes) {
        const size_t at = off;
        off += (bytes + 15) / 16 * 16;
        return at;
    };
    l.K = take(s.NQ4 * row);
    l.V = take(s.NQ4 * row);
    l.fsh = take(row32);
    l.qm = take((size_t)s.NQ4 * 4);
    l.vm = take((size_t)s.PP4 * 4);
    l.Q = take(s.RP * row);
    l.H = take(s.RP * row);
    l.O = take(s.RP * row);
    l.G = all ? take(s.RP * row32) : 0;
    l.U = take(s.RP * row32);
    l.Pr = take((size_t)s.RP * s.NQ4 * 4);
    l.Dr = take((size_t)s.RP * s.NQ4 * 4);
    l.As = all ? take((size_t)s.RP * C * 4) : 0;
    l.dAs = all ? take((size_t)s.RP * C * 4) : 0;
    l.Fw = take((size_t)s.NQ4 * s.dl4 * 16);
    l.Fk = take((size_t)s.NQ4 * s.dl4 * 16);
    l.bytes = off;
    return l;
}

struct ContentAttnPlan {
    int pp;        // pairs per pass
    int passes;    // passes per block
    int tiles;     // blocks (tiles) per element
    size_t smem;   // dynamic shared memory of a block, bytes; 0: shape not taken
};

// The tile plan of the forward or the backward (fp32 rows, or with `bf16`
// the bf16 backward's shared memory; the bf16 forward stages fp32 rows) for
// B elements of N pairs. Mirrored in ops/content_attn_cuda.py::plan; change
// both together.
inline ContentAttnPlan content_attn_plan(int B, int N, int C, int Nq, int dl, bool backward,
                                         bool bf16 = false) {
    ContentAttnPlan p{0, 0, 0, 0};
    if (B < 1 || N < 1 || C < 1 || C > kCaRows || Nq < 1 || Nq > 32 || dl < 1) return p;
    const bool bf16_bwd = backward && bf16;
    auto smem_of = [&](int pp) {
        return bf16_bwd ? ca_bwd_layout(pp, C, Nq, dl, true).bytes
                        : sizeof(float) * ca_smem_floats(pp, C, Nq, dl, backward);
    };
    int pp = kCaRows / C;
    // The backward keeps dfsh for at most two chunks per thread in registers.
    while (backward && pp > 1 && ca_shape(pp, C, Nq, dl).dl4 >
                                     2 * ca_chunk_threads(ca_shape(pp, C, Nq, dl).RP))
        pp = (pp + 1) / 2;
    size_t smem = smem_of(pp);
    while (smem > kCaMaxSmem && pp > 1) {
        pp = (pp + 1) / 2;
        smem = smem_of(pp);
    }
    const CaShape s = ca_shape(pp, C, Nq, dl);
    if (smem > kCaMaxSmem || (backward && s.dl4 > 2 * ca_chunk_threads(s.RP))) return p;
    // Blocks an SM holds: by shared memory, but the bf16 backward's registers
    // (about 220 a thread) allow one whatever its shared memory.
    const long long per_sm =
        bf16_bwd ? 1 : (long long)(kCaSmemPerSm / (smem + kCaReservedPerBlock));
    const long long target = 4LL * kCaSms * (per_sm < 1 ? 1 : per_sm);
    const int pass_tiles = (N + pp - 1) / pp;
    int passes = 1;
    while (passes < kCaMaxPasses && passes < pass_tiles &&
           (long long)B * ((N + pp * (passes + 1) - 1) / (pp * (passes + 1))) >= target)
        ++passes;
    p.pp = pp;
    p.passes = passes;
    p.tiles = (N + pp * passes - 1) / (pp * passes);
    p.smem = smem;
    return p;
}

// A block's dynamic shared memory for the admission checks of the entry
// points, past the 227 KB a block may have when the plan does not take the
// shape.
inline size_t content_attn_smem_bytes(int N, int C, int Nq, int dl, bool backward,
                                      bool bf16 = false) {
    const ContentAttnPlan p = content_attn_plan(1, N, C, Nq, dl, backward, bf16);
    return p.smem ? p.smem : kCaMaxSmem + 1;
}

// Floats of the backward's per-tile partials: B * tiles tiles of
// (dfwh (Nq, dl), dkhat (Nq, dl), dfsh (dl)).
inline size_t content_attn_partial_floats(int B, int N, int C, int Nq, int dl,
                                          bool bf16 = false) {
    const ContentAttnPlan p = content_attn_plan(B, N, C, Nq, dl, true, bf16);
    return (size_t)B * p.tiles * ((size_t)2 * Nq * dl + dl);
}

struct CaArgs {
    int N, C, Nq, dl, pp, passes, tiles;
    float inv_sdl;
    const float* h;
    const float* q;
    const float* khat;
    const float* fwh;
    const float* fsh;
    const float* qmask;
    const float* vmask;
    float* out;           // forward: fcc
    // The forward's bf16 variant (K4 at bf16): h, q, khat, fwh and fcc in
    // bf16 (fsh and the masks stay fp32); the rows are converted to fp32 as
    // they are staged, so shared memory and the arithmetic are the fp32
    // forward's.
    const bf16* h16;
    const bf16* q16;
    const bf16* khat16;
    const bf16* fwh16;
    bf16* out16;
    const float* dfcc;    // backward
    float* dh;            // fp32 at either type
    float* dq;
    float* part;          // (B * tiles, 2 * Nq * dl + dl)
    // The backward's bf16 variant (K3-bf16): dfcc and dq in bf16, besides
    // the forward's bf16 rows.
    const bf16* dfcc16;
    bf16* dq16;
};

// Copies `rows` rows of dl floats (source stride dl) into shared rows of
// stride DS, zero-filling the padding chunk by chunk, and zero rows from
// `rows` up to `rows_pad`. 16-byte cp.async when kVec, else plain loads.
template <bool kVec>
__device__ __forceinline__ void ca_stage_rows(float* dst, const float* __restrict__ src,
                                              int rows, int rows_pad, int dl, int dl4, int DS) {
    const int total = rows_pad * dl4;
    for (int e = threadIdx.x; e < total; e += kCaThreads) {
        const int r = e / dl4;
        const int c4 = e - r * dl4;
        float* d = dst + r * DS + c4 * 4;
        if constexpr (kVec) {
            const bool ok = r < rows;
            cp_async16(d, ok ? src + (size_t)r * dl + c4 * 4 : src, ok);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int col = c4 * 4 + k;
                d[k] = (r < rows && col < dl) ? src[(size_t)r * dl + col] : 0.f;
            }
        }
    }
}

// ca_stage_rows for bf16 rows: converted to fp32 as they land (8-byte loads
// of 4 values when kVec, synchronous: cp.async cannot convert).
template <bool kVec>
__device__ __forceinline__ void ca_stage_rows_bf16(float* dst, const bf16* __restrict__ src,
                                                   int rows, int rows_pad, int dl, int dl4,
                                                   int DS) {
    const int total = rows_pad * dl4;
    for (int e = threadIdx.x; e < total; e += kCaThreads) {
        const int r = e / dl4;
        const int c4 = e - r * dl4;
        float* d = dst + r * DS + c4 * 4;
        if constexpr (kVec) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < rows) {
                const uint2 u = *reinterpret_cast<const uint2*>(src + (size_t)r * dl + c4 * 4);
                const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
                const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
                v = make_float4(a.x, a.y, b.x, b.y);
            }
            *reinterpret_cast<float4*>(d) = v;
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int col = c4 * 4 + k;
                d[k] = (r < rows && col < dl) ? __bfloat162float(src[(size_t)r * dl + col]) : 0.f;
            }
        }
    }
}

// ca_stage_rows for bf16 rows kept as bf16 (the bf16 backward): shared rows
// of stride DSH elements, 8-byte cp.async of 4 values when kVec.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 8 : 0));
}

template <bool kVec>
__device__ __forceinline__ void ca_stage_rows16(bf16* dst, const bf16* __restrict__ src,
                                                int rows, int rows_pad, int dl, int dl4,
                                                int DSH) {
    const int total = rows_pad * dl4;
    for (int e = threadIdx.x; e < total; e += kCaThreads) {
        const int r = e / dl4;
        const int c4 = e - r * dl4;
        bf16* d = dst + r * DSH + c4 * 4;
        if constexpr (kVec) {
            const bool ok = r < rows;
            cp_async8(d, ok ? src + (size_t)r * dl + c4 * 4 : src, ok);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int col = c4 * 4 + k;
                d[k] = (r < rows && col < dl) ? src[(size_t)r * dl + col] : __float2bfloat16(0.f);
            }
        }
    }
}

// Stages rows of an activation of the forward, fp32 or (kBf16) bf16, from
// element offset `off`.
template <bool kVec, bool kBf16>
__device__ __forceinline__ void ca_stage_act(float* dst, const float* src32, const bf16* src16,
                                             size_t off, int rows, int rows_pad, int dl,
                                             int dl4, int DS) {
    if constexpr (kBf16)
        ca_stage_rows_bf16<kVec>(dst, src16 + off, rows, rows_pad, dl, dl4, DS);
    else
        ca_stage_rows<kVec>(dst, src32 + off, rows, rows_pad, dl, dl4, DS);
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
// Four bf16 values (8 bytes) as fp32.
__device__ __forceinline__ float4 ld4(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float dot4(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void fma4(float4& acc, float s, float4 v) {
    acc.x = fmaf(s, v.x, acc.x);
    acc.y = fmaf(s, v.y, acc.y);
    acc.z = fmaf(s, v.z, acc.z);
    acc.w = fmaf(s, v.w, acc.w);
}
__device__ __forceinline__ float4 f4(float v) { return make_float4(v, v, v, v); }

// Writes one 16-byte chunk of an output row: a float4 store when kVec, else
// the columns below dl.
template <bool kVec>
__device__ __forceinline__ void ca_store(float* __restrict__ row, int c4, int dl, float4 v) {
    if constexpr (kVec) {
        st4(row + c4 * 4, v);
    } else {
        const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (c4 * 4 + k < dl) row[c4 * 4 + k] = a[k];
    }
}

// ca_store for a bf16 output row: 4 values rounded once, an 8-byte store
// when kVec.
template <bool kVec>
__device__ __forceinline__ void ca_store_bf16(bf16* __restrict__ row, int c4, int dl, float4 v) {
    if constexpr (kVec) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        uint2 u;
        u.x = *reinterpret_cast<const unsigned*>(&lo);
        u.y = *reinterpret_cast<const unsigned*>(&hi);
        *reinterpret_cast<uint2*>(row + c4 * 4) = u;
    } else {
        const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (c4 * 4 + k < dl) row[c4 * 4 + k] = __float2bfloat16(a[k]);
    }
}

// Writes one chunk of the forward's output row starting at element `off`.
template <bool kVec, bool kBf16>
__device__ __forceinline__ void ca_store_out(const CaArgs& a, size_t off, int c4, float4 v) {
    if constexpr (kBf16)
        ca_store_bf16<kVec>(a.out16 + off, c4, a.dl, v);
    else
        ca_store<kVec>(a.out + off, c4, a.dl, v);
}

// The word phases' layout: a product X K^T over the pass's rows (X: q, or
// da backward) gives each group of 16 consecutive lanes 4 rows; in a group,
// 4 word groups of TW = NQ4 / 4 words each, and 4 lanes per word group that
// split dl's chunks between them (chunk c4 to lane c4 % 4). A lane's
// partial sums then meet in a transposing reduction over its 4 lanes (two
// shuffles for every 4 values), which leaves each lane the finished sums of
// one row and its word group.
constexpr int kCaMaxTW = 8;          // NQ4 <= 32

struct CaWordSums {
    float v[kCaMaxTW];   // the sums of row `r`, words m0 + t (t < TW)
    int r, m0;
    bool live;           // the lane's rows are rows of the pass
};

template <typename XT, typename KT>
__device__ __forceinline__ CaWordSums ca_word_dots(const XT* X, int ldx, const KT* Ks, int ldk,
                                                   const CaShape& s, int group_base) {
    constexpr int V = 4 * kCaMaxTW, H = V / 2, Q = V / 4;
    const int TW = s.NQ4 / 4;
    const int G = s.RP / 4;
    const int lane16 = threadIdx.x % 16;
    const int ds = lane16 % 4;
    const int wg = lane16 / 4;
    const int g_raw = group_base + threadIdx.x / 16;
    const int g = g_raw < G ? g_raw : G - 1;   // lanes past the rows shadow the last group
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int c4 = ds; c4 < s.dl4; c4 += 4) {
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = ld4(X + (g * 4 + i) * ldx + c4 * 4);
#pragma unroll
        for (int t = 0; t < kCaMaxTW; ++t) {
            if (t < TW) {
                const float4 k = ld4(Ks + (wg * TW + t) * ldk + c4 * 4);
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i * kCaMaxTW + t] += dot4(x[i], k);
            }
        }
    }
    // Lane ds keeps row ds: first the half of the rows its bit 1 names, then
    // the row its bit 0 names.
    {
        const bool up = ds & 2;
#pragma unroll
        for (int k = 0; k < H; ++k) {
            const float send = up ? acc[k] : acc[k + H];
            const float keep = up ? acc[k + H] : acc[k];
            acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
        }
    }
    {
        const bool up = ds & 1;
#pragma unroll
        for (int k = 0; k < Q; ++k) {
            const float send = up ? acc[k] : acc[k + Q];
            const float keep = up ? acc[k + Q] : acc[k];
            acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
        }
    }
    CaWordSums out;
    out.r = g * 4 + ds;
    out.m0 = wg * TW;
    out.live = g_raw < G;
#pragma unroll
    for (int k = 0; k < Q; ++k) out.v[k] = acc[k];
    return out;
}

// Reduces over the 4 word groups of a row (lanes 4 and 8 apart).
__device__ __forceinline__ float ca_row_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
}
__device__ __forceinline__ float ca_row_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    return v + __shfl_xor_sync(0xffffffffu, v, 8);
}

// Word attention of the pass's rows into Pr (RP, NQ4): the softmax of the
// -1e9-masked logits q khat^T / sqrt(dl), 0 past Nq. Qs and Ks: rows of
// stride ld (fp32, or bf16 in the bf16 backward).
template <typename ST>
__device__ __forceinline__ void ca_word_softmax(const CaArgs& a, const CaShape& s, const ST* Qs,
                                                const ST* Ks, int ld, const float* qms,
                                                float* Pr) {
    const int TW = s.NQ4 / 4;
    for (int gb = 0; gb < s.RP / 4; gb += kCaThreads / 16) {
        CaWordSums w = ca_word_dots(Qs, ld, Ks, ld, s, gb);
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < kCaMaxTW; ++t) {
            const int m = w.m0 + t;
            if (t < TW && m < a.Nq) {
                w.v[t] = qms[m] > 0.f ? w.v[t] * a.inv_sdl : kNegInf;
                mx = fmaxf(mx, w.v[t]);
            }
        }
        mx = ca_row_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kCaMaxTW; ++t) {
            if (t < TW && w.m0 + t < a.Nq) {
                w.v[t] = expf(w.v[t] - mx);
                sum += w.v[t];
            }
        }
        sum = ca_row_sum(sum);
        if (!w.live) continue;
#pragma unroll
        for (int t = 0; t < kCaMaxTW; ++t)
            if (t < TW) Pr[w.r * s.NQ4 + w.m0 + t] = w.m0 + t < a.Nq ? w.v[t] / sum : 0.f;
    }
}

// The word logits' gradient into Dr (RP, NQ4): dp = da fwh^T, ds = p * (dp
// - sum_m p dp) / sqrt(dl), 0 at a masked word and past Nq. DAs: fp32 rows
// of stride DS; Vs: rows of stride ldv.
template <typename VT>
__device__ __forceinline__ void ca_word_grad(const CaArgs& a, const CaShape& s, const float* DAs,
                                             const VT* Vs, int ldv, const float* qms,
                                             const float* Pr, float* Dr) {
    const int TW = s.NQ4 / 4;
    for (int gb = 0; gb < s.RP / 4; gb += kCaThreads / 16) {
        const CaWordSums w = ca_word_dots(DAs, s.DS, Vs, ldv, s, gb);
        float pv[kCaMaxTW];
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < kCaMaxTW; ++t) {
            pv[t] = (t < TW && w.m0 + t < a.Nq) ? Pr[w.r * s.NQ4 + w.m0 + t] : 0.f;
            dot += pv[t] * w.v[t];
        }
        dot = ca_row_sum(dot);
        if (!w.live) continue;
#pragma unroll
        for (int t = 0; t < kCaMaxTW; ++t) {
            const int m = w.m0 + t;
            if (t < TW)
                Dr[w.r * s.NQ4 + m] =
                    (m < a.Nq && qms[m] > 0.f) ? pv[t] * (w.v[t] - dot) * a.inv_sdl : 0.f;
        }
    }
}

// acc[i][j] = sum_m W[r0 + i][m] * V[m][chunk j] for the thread's 4 rows
// (W row-major RP x NQ4) and its chunks c4 = c0 + dgi + DG * j; V's rows of
// stride ldv.
template <int kJ, typename VT>
__device__ __forceinline__ void ca_mix_words(const float* Wr, const VT* Vs, int ldv,
                                             const CaShape& s, int r0, int dgi, int DG, int c0,
                                             float4 (&acc)[4][kJ]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] = f4(0.f);
    for (int m = 0; m < s.NQ4; ++m) {
        float w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = Wr[(r0 + i) * s.NQ4 + m];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
            const int c4 = c0 + dgi + DG * j;
            if (c4 < s.dl4) {
                const float4 v = ld4(Vs + m * ldv + c4 * 4);
#pragma unroll
                for (int i = 0; i < 4; ++i) fma4(acc[i][j], w[i], v);
            }
        }
    }
}

template <int K>
__device__ __forceinline__ void ca_lanes_add(float (&v)[K], int DG) {
    for (int o = DG / 2; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
}

// Index of (c, e) in the 10 sums of a symmetric 4 x 4 Gram matrix.
__host__ __device__ constexpr int ca_sym(int c, int e) {
    return c <= e ? c * 4 - c * (c - 1) / 2 + (e - c) : e * 4 - e * (e - 1) / 2 + (c - e);
}

// The clip attention of a pair from its Gram sums: P = softmax_e(gram /
// sqrt(dl)) (unmasked).
__device__ __forceinline__ void ca_pair_softmax(const float (&gram)[10], float inv_sdl,
                                                float (&P)[4][4]) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        float mx = -INFINITY;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            P[c][e] = gram[ca_sym(c, e)] * inv_sdl;
            mx = fmaxf(mx, P[c][e]);
        }
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            P[c][e] = expf(P[c][e] - mx);
            sum += P[c][e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) P[c][e] /= sum;
    }
}

// Loads the element's keys, values, fsh and query mask into shared memory
// (cp.async when kVec; the caller commits and waits with the first pass).
template <bool kVec, bool kBf16 = false>
__device__ __forceinline__ void ca_stage_element(const CaArgs& a, const CaShape& s, int b,
                                                 float* Ks, float* Vs, float* fshs, float* qms) {
    const size_t off = (size_t)b * a.Nq * a.dl;
    ca_stage_act<kVec, kBf16>(Ks, a.khat, a.khat16, off, a.Nq, s.NQ4, a.dl, s.dl4, s.DS);
    ca_stage_act<kVec, kBf16>(Vs, a.fwh, a.fwh16, off, a.Nq, s.NQ4, a.dl, s.dl4, s.DS);
    ca_stage_rows<kVec>(fshs, a.fsh + (size_t)b * a.dl, 1, 1, a.dl, s.dl4, s.DS);
    for (int m = threadIdx.x; m < s.NQ4; m += kCaThreads)
        qms[m] = m < a.Nq ? a.qmask[(size_t)b * a.Nq + m] : 0.f;
}

__device__ __forceinline__ void ca_wait_all() {
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
}

// The forward. Grid: B * tiles blocks of kCaThreads. kBf16: the bf16
// variant (CaArgs' h16, q16, khat16, fwh16, out16).
template <bool kVec, bool kBf16 = false>
__global__ void __launch_bounds__(kCaThreads, 2) content_attn_fwd_kernel(CaArgs a) {
    extern __shared__ __align__(16) float smem[];
    const CaShape s = ca_shape(a.pp, a.C, a.Nq, a.dl);
    float* Ks = smem;
    float* Vs = Ks + s.NQ4 * s.DS;
    float* fshs = Vs + s.NQ4 * s.DS;
    float* qms = fshs + s.DS;
    float* vms = qms + s.NQ4;
    float* Qs = vms + s.PP4;          // q, then g
    float* Hs = Qs + s.RP * s.DS;
    float* Pr = Hs + s.RP * s.DS;     // p (RP, NQ4)
    float* As = Pr + s.RP * s.NQ4;    // (RP, C): clip logits, then A

    const int b = blockIdx.x / a.tiles;
    const int tile = blockIdx.x - b * a.tiles;
    const int n_begin = tile * a.pp * a.passes;
    const int n_end = min(a.N, n_begin + a.pp * a.passes);
    const int C = a.C;
    const int RG = ca_row_groups(s.RP);
    const int DG = ca_chunk_threads(s.RP);
    const int rg = threadIdx.x / DG;
    const int dgi = threadIdx.x - rg * DG;
    const int r0 = rg * 4;

    ca_stage_element<kVec, kBf16>(a, s, b, Ks, Vs, fshs, qms);
    for (int n0 = n_begin; n0 < n_end; n0 += a.pp) {
        const int npair = min(a.pp, n_end - n0);
        const int rows = npair * C;
        const size_t row0 = ((size_t)b * a.N + n0) * C;
        ca_stage_act<kVec, kBf16>(Qs, a.q, a.q16, row0 * a.dl, rows, s.RP, a.dl, s.dl4, s.DS);
        ca_stage_act<kVec, kBf16>(Hs, a.h, a.h16, row0 * a.dl, rows, s.RP, a.dl, s.dl4, s.DS);
        for (int j = threadIdx.x; j < s.PP4; j += kCaThreads)
            vms[j] = j < npair ? a.vmask[(size_t)b * a.N + n0 + j] : 0.f;
        ca_wait_all();

        ca_word_softmax(a, s, Qs, Ks, s.DS, qms, Pr);
        __syncthreads();

        if (ca_fused_pairs(C, DG)) {
            // g = h * ((p fwh) * vm + fsh) and the pair's Gram sums g g^T in
            // registers, A = softmax(g g^T / sqrt(dl)) * vm, fcc = A h.
            const float vm = vms[rg];
            float gram[10];
#pragma unroll
            for (int k = 0; k < 10; ++k) gram[k] = 0.f;
            for (int c0 = 0; c0 < s.dl4; c0 += 2 * DG) {
                float4 acc[4][2];
                ca_mix_words(Pr, Vs, s.DS, s, r0, dgi, DG, c0, acc);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int c4 = c0 + dgi + DG * j;
                    if (c4 >= s.dl4) continue;
                    const float4 f = ld4(fshs + c4 * 4);
                    float4 g[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float4 hv = ld4(Hs + (r0 + i) * s.DS + c4 * 4);
                        const float4 o = acc[i][j];
                        g[i] = make_float4(hv.x * (o.x * vm + f.x), hv.y * (o.y * vm + f.y),
                                           hv.z * (o.z * vm + f.z), hv.w * (o.w * vm + f.w));
                    }
#pragma unroll
                    for (int c = 0; c < 4; ++c)
#pragma unroll
                        for (int e = c; e < 4; ++e) gram[ca_sym(c, e)] += dot4(g[c], g[e]);
                }
            }
            ca_lanes_add(gram, DG);
            float P[4][4];
            ca_pair_softmax(gram, a.inv_sdl, P);
            for (int c4 = dgi; c4 < s.dl4; c4 += DG) {
                float4 hv[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) hv[e] = ld4(Hs + (r0 + e) * s.DS + c4 * 4);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    if (r0 + c >= rows) break;
                    float4 o = f4(0.f);
#pragma unroll
                    for (int e = 0; e < 4; ++e) fma4(o, P[c][e] * vm, hv[e]);
                    ca_store_out<kVec, kBf16>(a, (row0 + r0 + c) * a.dl, c4, o);
                }
            }
            __syncthreads();
            continue;
        }

        // g = h * ((p fwh) * vm + fsh), over q's rows.
        if (rg < RG) {
            for (int c0 = 0; c0 < s.dl4; c0 += 2 * DG) {
                float4 acc[4][2];
                ca_mix_words(Pr, Vs, s.DS, s, r0, dgi, DG, c0, acc);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float vm = vms[min((r0 + i) / C, s.PP4 - 1)];
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int c4 = c0 + dgi + DG * j;
                        if (c4 >= s.dl4) continue;
                        const float4 f = ld4(fshs + c4 * 4);
                        const float4 hv = ld4(Hs + (r0 + i) * s.DS + c4 * 4);
                        const float4 o = acc[i][j];
                        st4(Qs + (r0 + i) * s.DS + c4 * 4,
                            make_float4(hv.x * (o.x * vm + f.x), hv.y * (o.y * vm + f.y),
                                        hv.z * (o.z * vm + f.z), hv.w * (o.w * vm + f.w)));
                    }
                }
            }
        }
        __syncthreads();

        // Clip logits, one dot product of two rows of a pair per thread.
        for (int idx = threadIdx.x; idx < rows * C; idx += kCaThreads) {
            const int r = idx / C;
            const int e = (r / C) * C + (idx - r * C);
            const float* x = Qs + r * s.DS;
            const float* y = Qs + e * s.DS;
            float t = 0.f;
            for (int c4 = 0; c4 < s.dl4; ++c4) t += dot4(ld4(x + c4 * 4), ld4(y + c4 * 4));
            As[idx] = t * a.inv_sdl;
        }
        __syncthreads();
        for (int r = threadIdx.x; r < rows; r += kCaThreads) {
            float* l = As + r * C;
            float mx = l[0];
            for (int e = 1; e < C; ++e) mx = fmaxf(mx, l[e]);
            float sum = 0.f;
            for (int e = 0; e < C; ++e) {
                l[e] = expf(l[e] - mx);
                sum += l[e];
            }
            const float vm = vms[r / C];
            for (int e = 0; e < C; ++e) l[e] = l[e] / sum * vm;
        }
        __syncthreads();

        // fcc = A h.
        if (rg < RG) {
            for (int i = 0; i < 4; ++i) {
                const int r = r0 + i;
                if (r >= rows) break;
                const int base = (r / C) * C;
                const float* l = As + r * C;
                for (int c4 = dgi; c4 < s.dl4; c4 += DG) {
                    float4 o = f4(0.f);
                    for (int e = 0; e < C; ++e) fma4(o, l[e], ld4(Hs + (base + e) * s.DS + c4 * 4));
                    ca_store_out<kVec, kBf16>(a, (row0 + r) * a.dl, c4, o);
                }
            }
        }
        __syncthreads();
    }
}

// The backward. Grid: B * tiles blocks of kCaThreads; writes dh, dq and the
// block's partial sums part[b * tiles + tile] = (dfwh, dkhat, dfsh). kBf16:
// the bf16 variant (CaArgs' h16, q16, khat16, fwh16, dfcc16 and dq16; dh
// fp32), with the bf16 layout of `ca_bwd_layout`: the rows staged as bf16
// by 8-byte cp.async. Its arithmetic is the fp32 kernel's on the bf16
// values: a bf16 value's fp32 is exact wherever it is read. kJ: the chunks
// of dl a lane of a row group holds in registers (1 or 2; `ca_bwd_kernel_for`).
template <bool kVec, bool kBf16, int kJ>
__global__ void __launch_bounds__(kCaThreads, 1) content_attn_bwd_kernel(CaArgs a) {
    using S = typename std::conditional<kBf16, bf16, float>::type;   // staged rows
    extern __shared__ __align__(16) unsigned char smem_bytes[];
    const CaShape s = ca_shape(a.pp, a.C, a.Nq, a.dl);
    const CaBwdLayout l = ca_bwd_layout(a.pp, a.C, a.Nq, a.dl, kBf16);
    const int C = a.C;
    const int dlp = s.dl4 * 4;
    const int DSS = l.DSS;
    S* Ks = reinterpret_cast<S*>(smem_bytes + l.K);
    S* Vs = reinterpret_cast<S*>(smem_bytes + l.V);
    float* fshs = reinterpret_cast<float*>(smem_bytes + l.fsh);
    float* qms = reinterpret_cast<float*>(smem_bytes + l.qm);
    float* Gs = reinterpret_cast<float*>(smem_bytes + l.G);    // g (off the bf16 fused path)
    float* Us = reinterpret_cast<float*>(smem_bytes + l.U);    // p fwh * vm + fsh, then da
    float* Pr = reinterpret_cast<float*>(smem_bytes + l.Pr);   // p (RP, NQ4)
    float* Dr = reinterpret_cast<float*>(smem_bytes + l.Dr);   // ds (RP, NQ4)
    float* As = reinterpret_cast<float*>(smem_bytes + l.As);   // (RP, C): clip logits, softmax
    float* dAs = reinterpret_cast<float*>(smem_bytes + l.dAs); // (RP, C): dfcc . h, dS
    float* Fw = reinterpret_cast<float*>(smem_bytes + l.Fw);   // the tile's dfwh (NQ4, dlp)
    float* Fk = reinterpret_cast<float*>(smem_bytes + l.Fk);   // and dkhat

    const int b = blockIdx.x / a.tiles;
    const int tile = blockIdx.x - b * a.tiles;
    const int n_begin = tile * a.pp * a.passes;
    const int n_end = min(a.N, n_begin + a.pp * a.passes);
    const int RG = ca_row_groups(s.RP);
    const int DG = ca_chunk_threads(s.RP);
    const int rg = threadIdx.x / DG;
    const int dgi = threadIdx.x - rg * DG;
    const int r0 = rg * 4;
    const int items = (s.NQ4 / 4) * s.dl4;   // (4 words, one chunk) of dfwh / dkhat

    float* vms = reinterpret_cast<float*>(smem_bytes + l.vm);
    S* Qs = reinterpret_cast<S*>(smem_bytes + l.Q);
    S* Hs = reinterpret_cast<S*>(smem_bytes + l.H);
    S* Os = reinterpret_cast<S*>(smem_bytes + l.O);      // dfcc

    for (int e = threadIdx.x; e < 2 * s.NQ4 * dlp; e += kCaThreads) Fw[e] = 0.f;
    float4 fsh_acc[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) fsh_acc[j] = f4(0.f);
    {
        const size_t off = (size_t)b * a.Nq * a.dl;
        if constexpr (kBf16) {
            ca_stage_rows16<kVec>(Ks, a.khat16 + off, a.Nq, s.NQ4, a.dl, s.dl4, DSS);
            ca_stage_rows16<kVec>(Vs, a.fwh16 + off, a.Nq, s.NQ4, a.dl, s.dl4, DSS);
        } else {
            ca_stage_rows<kVec>(Ks, a.khat + off, a.Nq, s.NQ4, a.dl, s.dl4, DSS);
            ca_stage_rows<kVec>(Vs, a.fwh + off, a.Nq, s.NQ4, a.dl, s.dl4, DSS);
        }
        ca_stage_rows<kVec>(fshs, a.fsh + (size_t)b * a.dl, 1, 1, a.dl, s.dl4, s.DS);
        for (int m = threadIdx.x; m < s.NQ4; m += kCaThreads)
            qms[m] = m < a.Nq ? a.qmask[(size_t)b * a.Nq + m] : 0.f;
    }
    for (int n0 = n_begin; n0 < n_end; n0 += a.pp) {
        const int npair = min(a.pp, n_end - n0);
        const int rows = npair * C;
        const size_t row0 = ((size_t)b * a.N + n0) * C;
        if constexpr (kBf16) {
            ca_stage_rows16<kVec>(Qs, a.q16 + row0 * a.dl, rows, s.RP, a.dl, s.dl4, DSS);
            ca_stage_rows16<kVec>(Hs, a.h16 + row0 * a.dl, rows, s.RP, a.dl, s.dl4, DSS);
            ca_stage_rows16<kVec>(Os, a.dfcc16 + row0 * a.dl, rows, s.RP, a.dl, s.dl4, DSS);
        } else {
            ca_stage_rows<kVec>(Qs, a.q + row0 * a.dl, rows, s.RP, a.dl, s.dl4, DSS);
            ca_stage_rows<kVec>(Hs, a.h + row0 * a.dl, rows, s.RP, a.dl, s.dl4, DSS);
            ca_stage_rows<kVec>(Os, a.dfcc + row0 * a.dl, rows, s.RP, a.dl, s.dl4, DSS);
        }
        for (int j = threadIdx.x; j < s.PP4; j += kCaThreads)
            vms[j] = j < npair ? a.vmask[(size_t)b * a.N + n0 + j] : 0.f;
        ca_wait_all();

        // Recompute p, u = p fwh * vm + fsh and g = h * u.
        ca_word_softmax(a, s, Qs, Ks, DSS, qms, Pr);
        __syncthreads();
        if (ca_fused_pairs(C, DG)) {
            // The pair's u, g, Gram sums g g^T and dA = dfcc h^T in registers
            // of its DG lanes, then the clip softmax's backward and the rows'
            // gradients (the same as the phases below, without their
            // barriers and shared buffers).
            auto h_at = [&](int i, int c4) { return ld4(Hs + (r0 + i) * DSS + c4 * 4); };
            auto o_at = [&](int i, int c4) { return ld4(Os + (r0 + i) * DSS + c4 * 4); };
            const float vm = vms[rg];
            float4 u[kJ][4], g[kJ][4];
            float gram[10], dA[16];
#pragma unroll
            for (int k = 0; k < 10; ++k) gram[k] = 0.f;
#pragma unroll
            for (int k = 0; k < 16; ++k) dA[k] = 0.f;
            {
                float4 acc[4][kJ];
                ca_mix_words(Pr, Vs, DSS, s, r0, dgi, DG, 0, acc);
#pragma unroll
                for (int j = 0; j < kJ; ++j) {
                    const int c4 = dgi + DG * j;
                    if (c4 >= s.dl4) continue;
                    const float4 f = ld4(fshs + c4 * 4);
                    float4 hv[4], ov[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        hv[i] = h_at(i, c4);
                        ov[i] = o_at(i, c4);
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float4 o = acc[i][j];
                        u[j][i] = make_float4(o.x * vm + f.x, o.y * vm + f.y, o.z * vm + f.z,
                                              o.w * vm + f.w);
                        g[j][i] = make_float4(hv[i].x * u[j][i].x, hv[i].y * u[j][i].y,
                                              hv[i].z * u[j][i].z, hv[i].w * u[j][i].w);
                    }
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
#pragma unroll
                        for (int e = c; e < 4; ++e) gram[ca_sym(c, e)] += dot4(g[j][c], g[j][e]);
#pragma unroll
                        for (int e = 0; e < 4; ++e) dA[c * 4 + e] += dot4(ov[c], hv[e]);
                    }
                }
            }
            ca_lanes_add(gram, DG);
            ca_lanes_add(dA, DG);
            float P[4][4], dS[4][4];
            ca_pair_softmax(gram, a.inv_sdl, P);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float dot = 0.f;
#pragma unroll
                for (int e = 0; e < 4; ++e) dot += P[c][e] * (dA[c * 4 + e] * vm);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dS[c][e] = P[c][e] * (dA[c * 4 + e] * vm - dot) * a.inv_sdl;
            }
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
                const int c4 = dgi + DG * j;
                if (c4 >= s.dl4) continue;
                float4 ov[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) ov[e] = o_at(e, c4);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int r = r0 + c;
                    float4 mix = f4(0.f), dg = f4(0.f);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        fma4(mix, P[e][c], ov[e]);
                        fma4(dg, dS[c][e] + dS[e][c], g[j][e]);
                    }
                    const float4 hv = h_at(c, c4);
                    const float4 uu = u[j][c];
                    if (r < rows)
                        ca_store<kVec>(a.dh + (row0 + r) * a.dl, c4, a.dl,
                                       make_float4(mix.x * vm + dg.x * uu.x,
                                                   mix.y * vm + dg.y * uu.y,
                                                   mix.z * vm + dg.z * uu.z,
                                                   mix.w * vm + dg.w * uu.w));
                    const float4 dgh = make_float4(dg.x * hv.x, dg.y * hv.y, dg.z * hv.z,
                                                   dg.w * hv.w);
                    fsh_acc[j].x += dgh.x;
                    fsh_acc[j].y += dgh.y;
                    fsh_acc[j].z += dgh.z;
                    fsh_acc[j].w += dgh.w;
                    st4(Us + r * s.DS + c4 * 4,
                        make_float4(dgh.x * vm, dgh.y * vm, dgh.z * vm, dgh.w * vm));
                }
            }
        } else {
            if (rg < RG) {
                float4 acc[4][kJ];
                ca_mix_words(Pr, Vs, DSS, s, r0, dgi, DG, 0, acc);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float vm = vms[min((r0 + i) / C, s.PP4 - 1)];
#pragma unroll
                    for (int j = 0; j < kJ; ++j) {
                        const int c4 = dgi + DG * j;
                        if (c4 >= s.dl4) continue;
                        const float4 f = ld4(fshs + c4 * 4);
                        const float4 hv = ld4(Hs + (r0 + i) * DSS + c4 * 4);
                        const float4 o = acc[i][j];
                        const float4 u = make_float4(o.x * vm + f.x, o.y * vm + f.y, o.z * vm + f.z,
                                                     o.w * vm + f.w);
                        st4(Us + (r0 + i) * s.DS + c4 * 4, u);
                        st4(Gs + (r0 + i) * s.DS + c4 * 4,
                            make_float4(hv.x * u.x, hv.y * u.y, hv.z * u.z, hv.w * u.w));
                    }
                }
            }
            __syncthreads();

            // Clip logits and dA[r, e] = dfcc[r] . h[e], one pair of rows per thread.
            for (int idx = threadIdx.x; idx < rows * C; idx += kCaThreads) {
                const int r = idx / C;
                const int e = (r / C) * C + (idx - r * C);
                float t = 0.f, u = 0.f;
                for (int c4 = 0; c4 < s.dl4; ++c4) {
                    t += dot4(ld4(Gs + r * s.DS + c4 * 4), ld4(Gs + e * s.DS + c4 * 4));
                    u += dot4(ld4(Os + r * DSS + c4 * 4), ld4(Hs + e * DSS + c4 * 4));
                }
                As[idx] = t * a.inv_sdl;
                dAs[idx] = u;
            }
            __syncthreads();
            // The clip softmax (A = P * vm) and its backward: dP = dA * vm, dS =
            // P * (dP - sum P dP) / sqrt(dl).
            for (int r = threadIdx.x; r < rows; r += kCaThreads) {
                float* l_ = As + r * C;
                float* dl_ = dAs + r * C;
                const float vm = vms[r / C];
                float mx = l_[0];
                for (int e = 1; e < C; ++e) mx = fmaxf(mx, l_[e]);
                float sum = 0.f;
                for (int e = 0; e < C; ++e) {
                    l_[e] = expf(l_[e] - mx);
                    sum += l_[e];
                }
                float dot = 0.f;
                for (int e = 0; e < C; ++e) {
                    l_[e] /= sum;
                    dl_[e] *= vm;
                    dot += l_[e] * dl_[e];
                }
                for (int e = 0; e < C; ++e) dl_[e] = l_[e] * (dl_[e] - dot) * a.inv_sdl;
            }
            __syncthreads();

            // dh = (sum_c2 P[c2, c] dfcc[c2]) * vm + dg * u, dg = sum_c2 (dS[c, c2] +
            // dS[c2, c]) g[c2]; da = dg * h * vm replaces u; dfsh += dg * h.
            if (rg < RG) {
                for (int i = 0; i < 4; ++i) {
                    const int r = r0 + i;
                    if (r >= rows) break;
                    const int base = (r / C) * C;
                    const int c = r - base;
                    const float vm = vms[r / C];
#pragma unroll
                    for (int j = 0; j < kJ; ++j) {
                        const int c4 = dgi + DG * j;
                        if (c4 >= s.dl4) continue;
                        float4 mix = f4(0.f), dg = f4(0.f);
                        for (int e = 0; e < C; ++e) {
                            fma4(mix, As[(base + e) * C + c], ld4(Os + (base + e) * DSS + c4 * 4));
                            fma4(dg, dAs[r * C + e] + dAs[(base + e) * C + c],
                                 ld4(Gs + (base + e) * s.DS + c4 * 4));
                        }
                        const float4 u = ld4(Us + r * s.DS + c4 * 4);
                        const float4 hv = ld4(Hs + r * DSS + c4 * 4);
                        ca_store<kVec>(
                            a.dh + (row0 + r) * a.dl, c4, a.dl,
                            make_float4(mix.x * vm + dg.x * u.x, mix.y * vm + dg.y * u.y,
                                        mix.z * vm + dg.z * u.z, mix.w * vm + dg.w * u.w));
                        const float4 dgh = make_float4(dg.x * hv.x, dg.y * hv.y, dg.z * hv.z,
                                                       dg.w * hv.w);
                        fsh_acc[j].x += dgh.x;
                        fsh_acc[j].y += dgh.y;
                        fsh_acc[j].z += dgh.z;
                        fsh_acc[j].w += dgh.w;
                        st4(Us + r * s.DS + c4 * 4,
                            make_float4(dgh.x * vm, dgh.y * vm, dgh.z * vm, dgh.w * vm));
                    }
                }
            }
        }
        __syncthreads();

        // The word logits' gradient: dp = da fwh^T, ds = p * (dp - sum p dp) /
        // sqrt(dl), 0 at a masked word.
        ca_word_grad(a, s, Us, Vs, DSS, qms, Pr, Dr);
        __syncthreads();

        // dq = ds khat.
        if (rg < RG) {
            float4 acc[4][kJ];
            ca_mix_words(Dr, Ks, DSS, s, r0, dgi, DG, 0, acc);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (r0 + i >= rows) break;
#pragma unroll
                for (int j = 0; j < kJ; ++j) {
                    const int c4 = dgi + DG * j;
                    if (c4 >= s.dl4) continue;
                    if constexpr (kBf16)
                        ca_store_bf16<kVec>(a.dq16 + (row0 + r0 + i) * a.dl, c4, a.dl, acc[i][j]);
                    else
                        ca_store<kVec>(a.dq + (row0 + r0 + i) * a.dl, c4, a.dl, acc[i][j]);
                }
            }
        }
        // The tile's sums over this pass's rows, in row order: dfwh[m] += p[r, m]
        // da[r], dkhat[m] += ds[r, m] q[r]; each thread owns 4 words x a chunk.
        for (int it = threadIdx.x; it < items; it += kCaThreads) {
            const int m0 = (it / s.dl4) * 4;
            const int c4 = it - (m0 / 4) * s.dl4;
            float4 fw[4], fk[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                fw[k] = ld4(Fw + (m0 + k) * dlp + c4 * 4);
                fk[k] = ld4(Fk + (m0 + k) * dlp + c4 * 4);
            }
            for (int r = 0; r < rows; ++r) {
                const float4 pw = ld4(Pr + r * s.NQ4 + m0);
                const float4 pk = ld4(Dr + r * s.NQ4 + m0);
                const float4 dav = ld4(Us + r * s.DS + c4 * 4);
                const float4 qv = ld4(Qs + r * DSS + c4 * 4);
                fma4(fw[0], pw.x, dav);
                fma4(fw[1], pw.y, dav);
                fma4(fw[2], pw.z, dav);
                fma4(fw[3], pw.w, dav);
                fma4(fk[0], pk.x, qv);
                fma4(fk[1], pk.y, qv);
                fma4(fk[2], pk.z, qv);
                fma4(fk[3], pk.w, qv);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                st4(Fw + (m0 + k) * dlp + c4 * 4, fw[k]);
                st4(Fk + (m0 + k) * dlp + c4 * 4, fk[k]);
            }
        }
        __syncthreads();
    }

    // The block's partials: dfwh, dkhat from shared memory; dfsh summed over
    // the row groups in order (through Q's space, which holds RG rows of dlp
    // floats at either type).
    float* part = a.part + (size_t)blockIdx.x * ((size_t)2 * a.Nq * a.dl + a.dl);
    float* red = reinterpret_cast<float*>(Qs);
    if (rg < RG) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
            const int c4 = dgi + DG * j;
            if (c4 < s.dl4) st4(red + rg * dlp + c4 * 4, fsh_acc[j]);
        }
    }
    __syncthreads();
    for (int d = threadIdx.x; d < a.dl; d += kCaThreads) {
        float t = 0.f;
        for (int g = 0; g < RG; ++g) t += red[g * dlp + d];
        part[2 * a.Nq * a.dl + d] = t;
    }
    for (int e = threadIdx.x; e < a.Nq * a.dl; e += kCaThreads) {
        const int m = e / a.dl;
        const int d = e - m * a.dl;
        part[e] = Fw[m * dlp + d];
        part[a.Nq * a.dl + e] = Fk[m * dlp + d];
    }
}

// Adds the partials of an element's tiles in tile order: grid (ceil(PF /
// 256), B), PF = 2 * Nq * dl + dl floats per tile; dkhat and dfsh rounded
// once to TK (fp32, or bf16 for the bf16 variant), dfwh fp32.
template <typename TK = float>
static __global__ void content_partial_reduce_kernel(int tiles, int Nq, int dl,
                                                     const float* __restrict__ part,
                                                     float* __restrict__ dfwh,
                                                     TK* __restrict__ dkhat,
                                                     TK* __restrict__ dfsh) {
    const int PF = 2 * Nq * dl + dl;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int b = blockIdx.y;
    if (e >= PF) return;
    const float* src = part + (size_t)b * tiles * PF + e;
    float t = 0.f;
    for (int k = 0; k < tiles; ++k) t += src[(size_t)k * PF];
    const int QD = Nq * dl;
    if (e < QD)
        dfwh[(size_t)b * QD + e] = t;
    else if (e < 2 * QD)
        dkhat[(size_t)b * QD + e - QD] = from_f<TK>(t);
    else
        dfsh[(size_t)b * dl + e - 2 * QD] = from_f<TK>(t);
}

inline CaArgs ca_args(const ContentAttnPlan& p, int N, int C, int Nq, int dl) {
    CaArgs a{};
    a.N = N;
    a.C = C;
    a.Nq = Nq;
    a.dl = dl;
    a.pp = p.pp;
    a.passes = p.passes;
    a.tiles = p.tiles;
    a.inv_sdl = 1.f / sqrtf((float)dl);
    return a;
}

// fcc from h, q, khat, fwh, fsh and the masks (see the head of this file).
// Returns the launch's CUDA error.
inline cudaError_t content_attn_forward(cudaStream_t st, int B, int N, int C, int Nq, int dl,
                                        const float* h, const float* q, const float* khat,
                                        const float* fwh, const float* fsh,
                                        const float* qmask, const float* vmask, float* fcc) {
    const ContentAttnPlan p = content_attn_plan(B, N, C, Nq, dl, false);
    if (!p.smem) return cudaErrorInvalidValue;
    CaArgs a = ca_args(p, N, C, Nq, dl);
    a.h = h;
    a.q = q;
    a.khat = khat;
    a.fwh = fwh;
    a.fsh = fsh;
    a.qmask = qmask;
    a.vmask = vmask;
    a.out = fcc;
    const bool vec = dl % 4 == 0 && aligned16(h) && aligned16(q) && aligned16(khat) &&
                     aligned16(fwh) && aligned16(fsh) && aligned16(fcc);
    auto kernel = vec ? content_attn_fwd_kernel<true> : content_attn_fwd_kernel<false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)((long long)B * p.tiles), kCaThreads, p.smem, st>>>(a);
    ++g_content_attn_launches[0];
    return cudaGetLastError();
}

inline bool aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

// The forward's bf16 variant: h, q (B*N*C, dl), khat, fwh (B*Nq, dl) and
// fcc in bf16; fsh (B, dl) and the masks fp32. Same plan and shared memory
// as the fp32 forward (the rows are staged in fp32). Returns the launch's
// CUDA error.
inline cudaError_t content_attn_forward(cudaStream_t st, int B, int N, int C, int Nq, int dl,
                                        const bf16* h, const bf16* q, const bf16* khat,
                                        const bf16* fwh, const float* fsh, const float* qmask,
                                        const float* vmask, bf16* fcc) {
    const ContentAttnPlan p = content_attn_plan(B, N, C, Nq, dl, false);
    if (!p.smem) return cudaErrorInvalidValue;
    CaArgs a = ca_args(p, N, C, Nq, dl);
    a.h16 = h;
    a.q16 = q;
    a.khat16 = khat;
    a.fwh16 = fwh;
    a.fsh = fsh;
    a.qmask = qmask;
    a.vmask = vmask;
    a.out16 = fcc;
    const bool vec = dl % 4 == 0 && aligned8(h) && aligned8(q) && aligned8(khat) &&
                     aligned8(fwh) && aligned16(fsh) && aligned8(fcc);
    auto kernel = vec ? content_attn_fwd_kernel<true, true> : content_attn_fwd_kernel<false, true>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)((long long)B * p.tiles), kCaThreads, p.smem, st>>>(a);
    ++g_content_attn_launches[0];
    return cudaGetLastError();
}

// The backward kernel for a plan: kJ, the chunks of dl a lane of a row
// group takes, 1 or 2 (the plan keeps dl4 <= 2 DG), sizes its registers.
using CaBwdKernel = void (*)(CaArgs);

template <bool kBf16>
inline CaBwdKernel ca_bwd_kernel_for(const ContentAttnPlan& p, int C, int Nq, int dl, bool vec) {
    const CaShape s = ca_shape(p.pp, C, Nq, dl);
    const bool one = s.dl4 <= ca_chunk_threads(s.RP);
    if (vec)
        return one ? content_attn_bwd_kernel<true, kBf16, 1> : content_attn_bwd_kernel<true, kBf16, 2>;
    return one ? content_attn_bwd_kernel<false, kBf16, 1> : content_attn_bwd_kernel<false, kBf16, 2>;
}

// The backward from dfcc: dh, dq (B*N*C, dl), and dfwh, dkhat (B*Nq, dl),
// dfsh (B, dl) through the per-tile partials `part`
// (content_attn_partial_floats floats). Returns the first CUDA error.
inline cudaError_t content_attn_backward(cudaStream_t st, int B, int N, int C, int Nq, int dl,
                                         const float* h, const float* q, const float* khat,
                                         const float* fwh, const float* fsh,
                                         const float* qmask, const float* vmask,
                                         const float* dfcc, float* dh, float* dq, float* part,
                                         float* dfwh, float* dkhat, float* dfsh) {
    const ContentAttnPlan p = content_attn_plan(B, N, C, Nq, dl, true);
    if (!p.smem) return cudaErrorInvalidValue;
    CaArgs a = ca_args(p, N, C, Nq, dl);
    a.h = h;
    a.q = q;
    a.khat = khat;
    a.fwh = fwh;
    a.fsh = fsh;
    a.qmask = qmask;
    a.vmask = vmask;
    a.dfcc = dfcc;
    a.dh = dh;
    a.dq = dq;
    a.part = part;
    const bool vec = dl % 4 == 0 && aligned16(h) && aligned16(q) && aligned16(khat) &&
                     aligned16(fwh) && aligned16(fsh) && aligned16(dfcc) && aligned16(dh) &&
                     aligned16(dq);
    auto kernel = ca_bwd_kernel_for<false>(p, C, Nq, dl, vec);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)((long long)B * p.tiles), kCaThreads, p.smem, st>>>(a);
    ++g_content_attn_launches[1];
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int PF = 2 * Nq * dl + dl;
    content_partial_reduce_kernel<<<dim3((PF + 255) / 256, B), 256, 0, st>>>(
        p.tiles, Nq, dl, part, dfwh, dkhat, dfsh);
    return cudaGetLastError();
}

// The backward's bf16 variant: h, q, dfcc (B*N*C, dl), khat, fwh (B*Nq, dl)
// bf16 and fsh fp32 in; dh (B*N*C, dl) and dfwh (B*Nq, dl) fp32 out, dq,
// dkhat and dfsh rounded once to bf16. Its plan (`content_attn_plan` with
// bf16) is the fp32 backward's with the shared memory of the bf16 layout
// (`ca_bwd_layout`). Returns the first CUDA error.
inline cudaError_t content_attn_backward(cudaStream_t st, int B, int N, int C, int Nq, int dl,
                                         const bf16* h, const bf16* q, const bf16* khat,
                                         const bf16* fwh, const float* fsh,
                                         const float* qmask, const float* vmask,
                                         const bf16* dfcc, float* dh, bf16* dq, float* part,
                                         float* dfwh, bf16* dkhat, bf16* dfsh) {
    const ContentAttnPlan p = content_attn_plan(B, N, C, Nq, dl, true, true);
    if (!p.smem) return cudaErrorInvalidValue;
    CaArgs a = ca_args(p, N, C, Nq, dl);
    a.h16 = h;
    a.q16 = q;
    a.khat16 = khat;
    a.fwh16 = fwh;
    a.fsh = fsh;
    a.qmask = qmask;
    a.vmask = vmask;
    a.dfcc16 = dfcc;
    a.dh = dh;
    a.dq16 = dq;
    a.part = part;
    const bool vec = dl % 4 == 0 && aligned8(h) && aligned8(q) && aligned8(khat) &&
                     aligned8(fwh) && aligned16(fsh) && aligned8(dfcc) && aligned16(dh) &&
                     aligned8(dq);
    auto kernel = ca_bwd_kernel_for<true>(p, C, Nq, dl, vec);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)((long long)B * p.tiles), kCaThreads, p.smem, st>>>(a);
    ++g_content_attn_launches[1];
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int PF = 2 * Nq * dl + dl;
    content_partial_reduce_kernel<bf16><<<dim3((PF + 255) / 256, B), 256, 0, st>>>(
        p.tiles, Nq, dl, part, dfwh, dkhat, dfsh);
    return cudaGetLastError();
}

}  // namespace vml

// Each .cu file that includes this header is its own shared library, so
// each defines these once: the pair's launches by this library (forward,
// backward) since the last reset.
extern "C" void vml_content_attn_launches(long long* out) {
    out[0] = vml::g_content_attn_launches[0];
    out[1] = vml::g_content_attn_launches[1];
}

extern "C" void vml_content_attn_reset_launches() {
    vml::g_content_attn_launches[0] = vml::g_content_attn_launches[1] = 0;
}
