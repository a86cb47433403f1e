// Tiled fp32 GEMM with a fused epilogue, shared by the biLSTM (lstm.cu), the
// SMI-stack (smin_stack.cu), the SMI train-layer (smin_train.cu) and the
// content-unit train (content_train.cu) kernels, plus the small device helpers
// they use, and its bf16 path (below: a wgmma / TMA kernel and an mma.sync
// one). gemm.cu exposes it alone for the card tests.
//
//   C[r, c] = (sum_k A(r, k) * ascale[.] * B(k, c) + bias[c] + pre[r, c])
//             * rmask[r / mask_div] + post[r, c] + post2[r / post2_div, c]
//
// Three operand layouts, one kernel template:
//   gemm_nt  C = A W^T   A (M, K) row-major, W (N, K) row-major: torch's
//            nn.Linear / 1x1-conv weight layout, so no weight is transposed
//            or copied (the forward projections);
//   gemm_nn  C = A W     A (M, K), W (K, N) row-major: dX = dY W of a
//            projection's backward;
//   gemm_tn  C = A^T B   A (R, M), B (R, N) row-major, reduced over the R
//            rows: dW = dY^T X. R is up to B*N*C rows into as few as
//            128 x 128 outputs, so the rows are split over gridDim.z blocks
//            that write partial sums, and `reduce_partials_kernel` adds the
//            partials in a fixed order: deterministic, no atomics. The same
//            pass can return the column sums of the scaled A (the bias
//            gradient sum_r dY[r] of the same projection): the blocks of the
//            first column tile add their staged A slice per column.
// `ascale` (optional) scales each stored row of A (row / adiv): the row
// masks of the backward (dY * vmask) without a masked copy of dY.
// Every epilogue term is optional (null pointer). The order (mask, then the
// residuals) is that of the JAX units, e.g. cu = f_cc * mask + f_c + fbar
// and mu = (conv_fb + conv_fc) * mask + f_m. An output may alias `pre` or
// `post`: each element is read, then written, by the same thread.
// gemm_nt2 / gemm_nn2 run two products that share A (one weight, output and
// epilogue each) as one launch, the problem index along gridDim.y.
//
// Two paths, one plan (tiles, split-K, grid). Bound on the H100: the
// operations; the K7 shapes (up to 532,480 x 512 x 512) are far above the
// bytes line on either path.
//
// The tensor-core path (`gemm_tc_kernel`; chosen by shape, `gemm_path_for`):
// 3xTF32. The results are held to the JAX fp32 kernels, which run their
// matmuls at HIGHEST precision, so a single TF32 product (10 explicit
// mantissa bits, about 3 decimal digits) is never used. Each operand value
// x is split into big = rna(x) and small = rna(x - big) (rna: the rounding
// of cvt.rna.tf32.f32), and a_s b_b + a_b b_s + a_b b_b are added, small
// terms first; the dropped a_s b_s and the rounding of the small parts are
// about 2^-22 of |a||b| a product, near the 2^-24 of an fp32 FMA. That is 3
// TF32 products per fp32 product: 495 / 3 = 165 TFLOP/s of fp32-accurate
// products, against the 67 TFLOP/s of the CUDA cores. What the design does
// about what bounds it (measured on the H100, PERF.md §6):
//   * accuracy: the tensor cores' adder truncates as it aligns its addends,
//     which biases a long running sum (accumulating there put 1.7e-1 of
//     error into a 532,480-row reduction that fp32 FMAs keep at 5e-3), so
//     each k8 step's three products go into a zeroed fragment that an
//     ordinary FADD adds to the fp32 running sum (the card tests' float64
//     tolerances hold unchanged; tests/test_torch_gemm_tf32x3.py holds a
//     numpy mirror of the split and this order to them on the CPU);
//   * instruction issue: splitting every fragment value in registers, as it
//     is loaded, spends more issue slots than the mma themselves (each value
//     reaches 2 to 4 warps); so a slice is split once, in shared memory, one
//     slice ahead of its use (the landed copy becomes the big parts, the
//     small parts go beside it), and the loop only loads fragments and
//     multiplies. rna is done in integer ops (bit for bit the conversion's,
//     NaN passed through), which issue at four times its rate;
//   * shared-memory reads (mma.sync): fragments of a k-contiguous tile come
//     by ldmatrix (four 8 x 4 tf32 matrices a lane group, from rows at the
//     `raw_off` swizzle, conflict-free); a row-contiguous tile lies k-major
//     at a stride of R + 8 floats, conflict-free for scalar reads;
//   * latency (mma.sync): two blocks an SM (<= 128 registers: a warp's 64 x
//     32 running sums, one m16 row of step sums), each with a ring of 3
//     stages of both operands' slices twice over (<= 101 KB);
//   * the instruction: gemm_tn (`gemm_wg_kernel`) takes wgmma (m64n128k8,
//     both operands from shared memory as core-matrix tiles that the split
//     writes, one 115 KB block an SM, the split of the next slice under the
//     current slice's products); its blocks reduce thousands of rows, and
//     it ran at 1.3 times the mma.sync kernel there. gemm_nt / gemm_nn
//     (`gemm_tc_kernel`) take mma.sync m16n8k8 (about 320 TFLOP/s of TF32
//     on this card, measured): with 8 to 32 slices a block, the same wgmma
//     design ran at 0.7-0.8 times the mma.sync kernel, whose two blocks an
//     SM hide each other's prologue, barriers and epilogue.
// The same tiles, grid, epilogue terms, split-K and fixed-order reduction as
// the CUDA-core path.
//
// The CUDA-core path (`gemm_kernel`), for the sites `gemm_path_for` keeps
// on it: fp32 FMAs, bound by their issue rate (67 TFLOP/s), shared-memory
// reads and load latency keeping it from that rate. Design, shared by both
// paths where it says so:
//   * block tiles of 128x128 (256 threads, an 8x8 micro-tile per thread held
//     as 2x2 sub-tiles of 4x4 at a stride of 64, so the inner loop's float4
//     shared reads are conflict-free), or 128x64 / 64x64 where the output
//     has too few tiles to fill the 132 SMs twice (`gemm_tile_for`, both);
//   * 16-deep K slices in a 5-stage ring of 16-byte `cp.async` copies, so
//     three slices load while one is transposed and one multiplied, and no
//     load stages through registers; two blocks fit an SM (<= 128
//     registers, <= 112 KB of dynamic shared memory), so one block's
//     prologue and epilogue overlap the other's products (the tensor path:
//     the same slices and copies in a 3-stage ring);
//   * the inner loop reads both operands k-major (a float4 of 4 rows at one
//     k), conflict-free: an operand contiguous along its rows lands k-major
//     as it lies; one contiguous along k lands row-major (16-byte units,
//     XOR-swizzled, `raw_off`) and is transposed in shared memory into one of
//     two k-major buffers one slice ahead of its use, with `ascale` applied
//     on the way;
//   * a float4 epilogue where the output and its residuals are aligned
//     (both: the tensor-core kernels stage their sums through shared memory
//     first, since their fragments hold column pairs of 8 rows; written from
//     the fragments, the residual-heavy c_out epilogue ran 1.5 times slower);
//   * a scalar path (synchronous guarded loads into the same layout) for
//     operands that are not 16-byte aligned or whose extents are not
//     multiples of 4; guarded edges, so M, N and K need not be tile
//     multiples (both).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "bf16.cuh"
#include "tma.cuh"

namespace vml {

struct Epilogue {
    const float* bias = nullptr;   // (N,)
    const float* pre = nullptr;    // (M, ldpre), added before the mask
    int ldpre = 0;
    const float* rmask = nullptr;  // (M / mask_div,)
    int mask_div = 1;
    const float* post = nullptr;   // (M, ldpost), added after the mask
    int ldpost = 0;
    const float* post2 = nullptr;  // (M / post2_div, ldpost2), after the mask
    int ldpost2 = 0;
    int post2_div = 1;
};

constexpr int kGemmBK = 16;
constexpr int kGemmThreads = 256;
constexpr int kGemmSMs = 132;            // H100 SXM

// Block tiles, in the order `gemm_tile_for` tries them.
enum GemmTile { kTile128x128 = 0, kTile128x64 = 1, kTile64x64 = 2 };
constexpr int kGemmTileM[3] = {128, 128, 64};
constexpr int kGemmTileN[3] = {128, 64, 64};

inline long long gemm_tiles(int tile, int M, int N) {
    return (long long)((M + kGemmTileM[tile] - 1) / kGemmTileM[tile]) *
           ((N + kGemmTileN[tile] - 1) / kGemmTileN[tile]);
}

// The largest tile that still fills both block slots of every SM; the
// smallest if none does (a few hundred rows at serving's B=16).
inline int gemm_tile_for(int M, int N, int groups) {
    for (int t = kTile128x128; t < kTile64x64; ++t)
        if (gemm_tiles(t, M, N) * groups >= 2 * kGemmSMs) return t;
    return kTile64x64;
}

struct GemmParams {
    int M, N, K, kchunk;
    const float* A;
    int lda;
    const float* ascale;
    int adiv;
    int ldw, ldc;
    const float* W[2];        // per problem (blockIdx.y)
    float* C[2];
    Epilogue ep[2];
    bool vec_out;             // float4 epilogue
    float* colsum;            // gemm_tn: (gridDim.z, M) partial column sums of A
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Float offset of element (row r, k) of an operand tile kept as it lies in
// global memory, contiguous in k: rows of kGemmBK floats in 16-byte units,
// the unit index XOR-swizzled by (r / 2) % 4, so both the copies (4 units of
// 2 rows per 8 threads) and the transposing reads (one unit of 8
// consecutive rows per 8 threads) hit 8 different bank groups.
__device__ __forceinline__ int raw_off(int r, int k) {
    return ((((r << 2) | (k >> 2)) ^ ((r >> 1) & 3)) << 2) | (k & 3);
}

// One operand's tile of R rows (m or n) x kGemmBK, from global to shared.
// kRowContig: element (row r, k) at P[k * ld + r], stored k-major as it
// lies, KLD floats per k; else at P[r * ld + k], stored row-major
// (`raw_off`). Each thread copies R * kGemmBK / 4 / 256 chunks of 4 floats.
template <int R, bool kRowContig, bool kVec, int KLD = R>
__device__ __forceinline__ void gemm_load_tile(float* s, const float* __restrict__ P, int ld,
                                               int rows, int r0, int k0, int kend) {
    constexpr int kChunks = R * kGemmBK / 4 / kGemmThreads;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
        const int c = threadIdx.x + j * kGemmThreads;
        int r, k;
        float* dst;
        if (kRowContig) {
            k = c / (R / 4);
            r = (c % (R / 4)) * 4;
            dst = s + k * KLD + r;
        } else {
            r = c / (kGemmBK / 4);
            k = (c % (kGemmBK / 4)) * 4;
            dst = s + raw_off(r, k);
        }
        const int gr = r0 + r, gk = k0 + k;
        if (kVec) {
            const bool ok = gr < rows && gk < kend;
            const float* src = ok ? (kRowContig ? P + (size_t)gk * ld + gr
                                                : P + (size_t)gr * ld + gk)
                                  : P;
            cp_async16(dst, src, ok);
        } else {
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if (kRowContig)
                    v[i] = (gk < kend && gr + i < rows) ? P[(size_t)gk * ld + gr + i] : 0.f;
                else
                    v[i] = (gr < rows && gk + i < kend) ? P[(size_t)gr * ld + gk + i] : 0.f;
            }
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        }
    }
}

// Makes a landed tile ready for the inner loop, which reads every operand
// k-major: a row-contiguous tile is used in place (scaled in place when
// `scale` is given: `scale_k`, by the stored row k of A (R, M)); a
// k-contiguous one is transposed from `raw` into `km` (R floats per k),
// scaled by its row when `scale` is given. A thread moves one 16-byte unit
// (4 k) of row r = c % R, so a warp writes 32 consecutive floats per k.
template <int R, bool kRowContig>
__device__ __forceinline__ void gemm_prepare(float* raw, float* km,
                                             const float* __restrict__ scale, int adiv,
                                             int lim, int row0) {
    if (kRowContig) {
        if (!scale) return;
        constexpr int kChunks = R * kGemmBK / 4 / kGemmThreads;
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
            const int c = threadIdx.x + j * kGemmThreads;
            const int k = c / (R / 4);
            float* at = raw + k * R + (c % (R / 4)) * 4;
            const int row = row0 + k;
            const float sc = row < lim ? scale[row / adiv] : 0.f;
            float4 v = *reinterpret_cast<float4*>(at);
            v.x *= sc; v.y *= sc; v.z *= sc; v.w *= sc;
            *reinterpret_cast<float4*>(at) = v;
        }
        return;
    }
    constexpr int kUnits = R * (kGemmBK / 4) / kGemmThreads;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
        const int c = threadIdx.x + j * kGemmThreads;
        const int r = c % R;
        const int q = c / R;
        float4 v = *reinterpret_cast<const float4*>(raw + raw_off(r, 4 * q));
        if (scale) {
            const int row = row0 + r;
            const float sc = row < lim ? scale[row / adiv] : 0.f;
            v.x *= sc; v.y *= sc; v.z *= sc; v.w *= sc;
        }
        km[(4 * q + 0) * R + r] = v.x;
        km[(4 * q + 1) * R + r] = v.y;
        km[(4 * q + 2) * R + r] = v.z;
        km[(4 * q + 3) * R + r] = v.w;
    }
}

// Stores outputs (r, c .. c + 3) of a problem with its epilogue: bias, pre,
// the row mask, post, post2, in that order; c + 3 < N unless !vec_out, when
// the columns past N are skipped.
__device__ __forceinline__ void epilogue_store4(const GemmParams& p, const Epilogue& ep,
                                                float* C, int r, int c, float (&v)[4]) {
    const float mk = ep.rmask ? ep.rmask[r / ep.mask_div] : 1.f;
    if (p.vec_out) {   // N % 4 == 0, so c + 3 < N
        auto add4 = [&](const float* src) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            v[0] += t.x; v[1] += t.y; v[2] += t.z; v[3] += t.w;
        };
        if (ep.bias) add4(ep.bias + c);
        if (ep.pre) add4(ep.pre + (size_t)r * ep.ldpre + c);
        if (ep.rmask)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] *= mk;
        if (ep.post) add4(ep.post + (size_t)r * ep.ldpost + c);
        if (ep.post2) add4(ep.post2 + (size_t)(r / ep.post2_div) * ep.ldpost2 + c);
        *reinterpret_cast<float4*>(C + (size_t)r * p.ldc + c) = make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int cj = c + j;
        if (cj >= p.N) continue;
        float t = v[j];
        if (ep.bias) t += ep.bias[cj];
        if (ep.pre) t += ep.pre[(size_t)r * ep.ldpre + cj];
        if (ep.rmask) t *= mk;
        if (ep.post) t += ep.post[(size_t)r * ep.ldpost + cj];
        if (ep.post2) t += ep.post2[(size_t)(r / ep.post2_div) * ep.ldpost2 + cj];
        C[(size_t)r * p.ldc + cj] = t;
    }
}

constexpr int kGemmStages = 5;

// Floats of a block's dynamic shared memory: the ring of kGemmStages slices
// of both operands, and two k-major slices of each k-contiguous operand.
template <int BM, int BN, bool kAT, bool kBN>
constexpr int gemm_smem_floats() {
    return kGemmStages * (BM + BN) * kGemmBK + 2 * ((kAT ? 0 : BM) + (kBN ? 0 : BN)) * kGemmBK;
}

// kAT: A is stored (K, M), element (m, k) at A[k * lda + m]; else (M, K).
// kBN: B is stored (K, N), element (k, n) at W[k * ldw + n]; else (N, K).
// kVec: every operand's contiguous extent and row stride are multiples of 4
// and its base is 16-byte aligned (16-byte asynchronous copies).
// Block z reduces k in [z * kchunk, min(K, (z + 1) * kchunk)) into
// C + z * M * ldc (kchunk a multiple of kGemmBK; one block when kchunk >= K).
// Slice kt + 1 is made ready (transposed, scaled) while slice kt is
// multiplied, and slices up to kt + 4 are in flight: one barrier a slice.
template <int BM, int BN, bool kAT, bool kBN, bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_kernel(GemmParams p) {
    constexpr int S = kGemmStages;
    constexpr int MI = BM / 16, NI = BN / 16;   // rows / columns of a thread
    extern __shared__ float4 gemm_smem4[];
    float* const ringA = reinterpret_cast<float*>(gemm_smem4);   // (S, BM * BK)
    float* const ringW = ringA + S * BM * kGemmBK;               // (S, BN * BK)
    float* const kmA = ringW + S * BN * kGemmBK;                 // (2, BK, BM) unless kAT
    float* const kmW = kmA + (kAT ? 0 : 2 * BM * kGemmBK);       // (2, BK, BN) unless kBN

    const int tid = threadIdx.x;
    const int g = blockIdx.y;                   // the problem of gemm_*2
    const float* __restrict__ W = p.W[g];
    // Output tiles are numbered along x, column tiles fastest: B * N * C rows
    // can be more row tiles than the 65,535 that gridDim.y admits.
    const int col_tiles = (p.N + BN - 1) / BN;
    const int m0 = (blockIdx.x / col_tiles) * BM;
    const int n0 = (blockIdx.x % col_tiles) * BN;
    const int kbeg = blockIdx.z * p.kchunk;
    const int kend = min(p.K, kbeg + p.kchunk);
    const int nk = (kend - kbeg + kGemmBK - 1) / kGemmBK;
    const int tr = tid / 16;   // micro-tile rows x * 64 + tr * 4 + i
    const int tc = tid % 16;   // micro-tile cols y * 64 + tc * 4 + j
    const bool colsum = p.colsum && n0 == 0;
    float cs = 0.f;            // colsum: column m0 + tid of A

    auto load = [&](int kt) {
        const int s = kt % S;
        gemm_load_tile<BM, kAT, kVec>(ringA + s * BM * kGemmBK, p.A, p.lda, p.M, m0,
                                      kbeg + kt * kGemmBK, kend);
        gemm_load_tile<BN, kBN, kVec>(ringW + s * BN * kGemmBK, W, p.ldw, p.N, n0,
                                      kbeg + kt * kGemmBK, kend);
    };
    auto prepare = [&](int kt) {
        const int s = kt % S;
        // ascale's rows: k of A (R, M) for gemm_tn, m of A (M, K) otherwise.
        gemm_prepare<BM, kAT>(ringA + s * BM * kGemmBK, kmA + (kt & 1) * BM * kGemmBK,
                              p.ascale, p.adiv, kAT ? kend : p.M,
                              kAT ? kbeg + kt * kGemmBK : m0);
        gemm_prepare<BN, kBN>(ringW + s * BN * kGemmBK, kmW + (kt & 1) * BN * kGemmBK,
                              nullptr, 1, 0, 0);
    };

    float acc[MI][NI];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < nk) load(s);
        cp_async_commit();
    }
    cp_async_wait<S - 2>();
    __syncthreads();
    prepare(0);
    for (int kt = 0; kt < nk; ++kt) {
        // Slice kt + 1 has landed for every thread; every thread is done with
        // slice kt - 1, whose ring stage and k-major buffer are reused now.
        cp_async_wait<S - 3>();
        __syncthreads();
        if (kt + S - 1 < nk) load(kt + S - 1);
        cp_async_commit();
        if (kt + 1 < nk) prepare(kt + 1);
        const float* as = kAT ? ringA + (kt % S) * BM * kGemmBK : kmA + (kt & 1) * BM * kGemmBK;
        const float* ws = kBN ? ringW + (kt % S) * BN * kGemmBK : kmW + (kt & 1) * BN * kGemmBK;
        if (colsum && tid < BM) {   // gemm_tn: A's scaled slice, k-major
#pragma unroll
            for (int kk = 0; kk < kGemmBK; ++kk) cs += as[kk * BM + tid];
        }
#pragma unroll
        for (int kk = 0; kk < kGemmBK; ++kk) {
            float a[MI], b[NI];
#pragma unroll
            for (int x = 0; x < MI / 4; ++x) {
                const float4 v = *reinterpret_cast<const float4*>(as + kk * BM + x * 64 + tr * 4);
                a[x * 4] = v.x; a[x * 4 + 1] = v.y; a[x * 4 + 2] = v.z; a[x * 4 + 3] = v.w;
            }
#pragma unroll
            for (int y = 0; y < NI / 4; ++y) {
                const float4 v = *reinterpret_cast<const float4*>(ws + kk * BN + y * 64 + tc * 4);
                b[y * 4] = v.x; b[y * 4 + 1] = v.y; b[y * 4 + 2] = v.z; b[y * 4 + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < MI; ++i)
#pragma unroll
                for (int j = 0; j < NI; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
    }
    cp_async_wait<0>();
    if (colsum && tid < BM && m0 + tid < p.M)
        p.colsum[(size_t)blockIdx.z * p.M + m0 + tid] = cs;

    const Epilogue& ep = p.ep[g];
    float* C = p.C[g] + (size_t)blockIdx.z * p.M * p.ldc;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
        const int r = m0 + (i / 4) * 64 + tr * 4 + i % 4;
        if (r >= p.M) continue;
#pragma unroll
        for (int y = 0; y < NI / 4; ++y) {
            const int c = n0 + y * 64 + tc * 4;
            if (c >= p.N) continue;
            float v[4] = {acc[i][y * 4], acc[i][y * 4 + 1], acc[i][y * 4 + 2], acc[i][y * 4 + 3]};
            epilogue_store4(p, ep, C, r, c, v);
        }
    }
}

// ---------------------------------------------------------------------
// The tensor-core path: 3xTF32 on mma.sync m16n8k8 (see the head of the
// file). Same slices and plan as gemm_kernel, in a ring of kTcStages; a
// row-contiguous operand lands k-major at a stride of R + kTcPad floats.
// Each stage holds a slice twice over: the landed copy, which the split
// overwrites with the big parts, and the small parts beside it.
constexpr int kTcPad = 8;
constexpr int kTcStages = 3;

template <int R, bool kRowContig>
__host__ __device__ constexpr int tc_stage_floats() {
    return 2 * (kRowContig ? kGemmBK * (R + kTcPad) : R * kGemmBK);
}

template <int BM, int BN, bool kAT, bool kBN>
__host__ __device__ constexpr int gemm_tc_smem_floats() {
    return kTcStages * (tc_stage_floats<BM, kAT>() + tc_stage_floats<BN, kBN>());
}

// cvt.rna.tf32.f32 (the nearest TF32 value, ties away from zero) in
// integer ops, bit for bit the same for every float but NaN, which it
// passes through unchanged: half a TF32 ulp added to the magnitude, the 13
// low bits cleared.
__device__ __forceinline__ float rna_tf32(float x) {
    const uint32_t b = __float_as_uint(x);
    return x != x ? x : __uint_as_float((b + 0x1000u) & 0xffffe000u);
}

// c += a b over one k8 step: a the m16 x k8 fragment (rows g, g + 8; k t,
// t + 4), b the k8 x n8 fragment (k t, t + 4; column g).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 4 tf32 matrices from shared memory (ldmatrix's 8 x 8 b16): lane
// l gives the address of row l % 8 of matrix l / 8 (16 bytes) and gets
// element (l / 4, l % 4) of each, the layout of mma's tf32 fragments.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a)
                 : "memory");
}

// Splits a landed slice of one operand (R rows x kGemmBK, layout as
// gemm_load_tile<R, kRowContig, ..., KLD> wrote it) in place: each value x
// (scaled first by scale[(row0 + r) / adiv], 0 past lim, when scale is
// given: gemm_nn's A) becomes big = rna(x), and small = rna(x - big) goes to
// the same offset of `sm`.
template <int R, bool kRowContig, int KLD>
__device__ __forceinline__ void tc_split_tile(float* s, float* sm, const float* __restrict__ scale,
                                              int adiv, int lim, int row0) {
    constexpr int kChunks = R * kGemmBK / 4 / kGemmThreads;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
        const int c = threadIdx.x + j * kGemmThreads;
        int off, row;
        if (kRowContig) {
            const int k = c / (R / 4);
            off = k * KLD + (c % (R / 4)) * 4;
            row = row0 + k;
        } else {
            const int r = c / (kGemmBK / 4);
            off = raw_off(r, (c % (kGemmBK / 4)) * 4);
            row = row0 + r;
        }
        float4 v = *reinterpret_cast<const float4*>(s + off);
        if (scale) {
            const float sc = row < lim ? scale[row / adiv] : 0.f;
            v.x *= sc; v.y *= sc; v.z *= sc; v.w *= sc;
        }
        const float4 big = make_float4(rna_tf32(v.x), rna_tf32(v.y), rna_tf32(v.z), rna_tf32(v.w));
        *reinterpret_cast<float4*>(s + off) = big;
        *reinterpret_cast<float4*>(sm + off) =
            make_float4(rna_tf32(v.x - big.x), rna_tf32(v.y - big.y), rna_tf32(v.z - big.z),
                        rna_tf32(v.w - big.w));
    }
}

// gemm_nt and gemm_nn (A (M, K) k-contiguous; W (N, K) or (K, N)): kBN,
// kVec and the grid as gemm_kernel. Warp w owns rows (w / 4) * BM / 2 .. +
// BM / 2 and columns (w % 4) * BN / 4 .. + BN / 4 of the block tile as MT x
// NT fragments of m16n8; lane = 4 g + t. Slice kt + 1 is split while slice
// kt is multiplied; one barrier a slice.
template <int BM, int BN, bool kAT, bool kBN, bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_tc_kernel(GemmParams p) {
    static_assert(!kAT, "gemm_tn takes gemm_wg_kernel");
    constexpr int S = kTcStages;
    constexpr int WM = BM / 2, WN = BN / 4;
    constexpr int MT = WM / 16, NT = WN / 8;
    constexpr int LW = BN + kTcPad;                       // W's k-major stride (nn)
    constexpr int SA = tc_stage_floats<BM, false>() / 2;  // one copy of a slice
    constexpr int SW = tc_stage_floats<BN, kBN>() / 2;
    static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
    extern __shared__ float4 gemm_smem4[];
    float* const ringA = reinterpret_cast<float*>(gemm_smem4);   // (S, 2, SA): big, small
    float* const ringW = ringA + S * 2 * SA;                     // (S, 2, SW)

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int wr = (warp / 4) * WM, wc = (warp % 4) * WN;
    const int prob = blockIdx.y;
    const float* __restrict__ W = p.W[prob];
    const int col_tiles = (p.N + BN - 1) / BN;
    const int m0 = (blockIdx.x / col_tiles) * BM;
    const int n0 = (blockIdx.x % col_tiles) * BN;
    const int kbeg = blockIdx.z * p.kchunk;
    const int kend = min(p.K, kbeg + p.kchunk);
    const int nk = (kend - kbeg + kGemmBK - 1) / kGemmBK;

    auto load = [&](int kt) {
        const int s = kt % S;
        gemm_load_tile<BM, false, kVec>(ringA + s * 2 * SA, p.A, p.lda, p.M, m0,
                                        kbeg + kt * kGemmBK, kend);
        gemm_load_tile<BN, kBN, kVec, LW>(ringW + s * 2 * SW, W, p.ldw, p.N, n0,
                                          kbeg + kt * kGemmBK, kend);
    };
    auto prepare = [&](int kt) {
        float* a = ringA + (kt % S) * 2 * SA;
        float* w = ringW + (kt % S) * 2 * SW;
        tc_split_tile<BM, false, BM>(a, a + SA, p.ascale, p.adiv, p.M, m0);
        tc_split_tile<BN, kBN, LW>(w, w + SW, nullptr, 1, 0, 0);
    };

    // Fragment addresses. A k-major W: element (r0 + c, k0 + t) at (k0 + t)
    // * LW + r0 + c, r0 = wc + g. k-contiguous tiles
    // (`raw_off`, 16-byte units XOR-swizzled by (r / 2) % 4): ldmatrix rows,
    // lane l giving row q = l % 8 of matrix l / 8; for A matrix (h, u) is rows
    // 8 h .. 8 h + 7 of a fragment at k unit u (the fragment's a0..a3 are (0,
    // 0), (1, 0), (0, 1), (1, 1)); for W it is n8 tile 2 jj + h at unit u, in
    // the order (0, 0), (0, 1), (1, 0), (1, 1) (b0, b1 of two tiles). A row's
    // swizzle is (q / 2) % 4 for every fragment, so the k8 step's two units
    // take two per-thread offsets and all else is immediate.
    const int lq = lane % 8, lm = lane / 8;
    const int xq = (lq >> 1) & 3;
    int koA[2], koW[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        koA[h] = 16 * (wr + 8 * (lm & 1) + lq) + 4 * ((2 * h + (lm >> 1)) ^ xq);
        koW[h] = 16 * (wc + 8 * (lm >> 1) + lq) + 4 * ((2 * h + (lm & 1)) ^ xq);
    }

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < nk) load(s);
        cp_async_commit();
    }
    cp_async_wait<S - 2>();
    __syncthreads();
    prepare(0);
    for (int kt = 0; kt < nk; ++kt) {
        // Slice kt + 1 has landed for every thread, slice kt is split, and
        // every thread is done with slice kt - 1, whose stage is reused now.
        cp_async_wait<S - 3>();
        __syncthreads();
        if (kt + S - 1 < nk) load(kt + S - 1);
        cp_async_commit();
        if (kt + 1 < nk) prepare(kt + 1);
        const float* ab_ = ringA + (kt % S) * 2 * SA;   // big parts; small at + SA
        const float* wb_ = ringW + (kt % S) * 2 * SW;
#pragma unroll
        for (int k8 = 0; k8 < kGemmBK; k8 += 8) {
            uint32_t bb[NT][2], bs[NT][2];
            if (kBN) {
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int off = (k8 + 4 * q + t) * LW + wc + g + 8 * j;
                        bb[j][q] = __float_as_uint(wb_[off]);
                        bs[j][q] = __float_as_uint(wb_[SW + off]);
                    }
            } else {
#pragma unroll
                for (int jj = 0; jj < NT / 2; ++jj) {
                    uint32_t r[4];
                    ldsm_x4(r, wb_ + koW[k8 / 8] + 256 * jj);
                    bb[2 * jj][0] = r[0]; bb[2 * jj][1] = r[1];
                    bb[2 * jj + 1][0] = r[2]; bb[2 * jj + 1][1] = r[3];
                    ldsm_x4(r, wb_ + SW + koW[k8 / 8] + 256 * jj);
                    bs[2 * jj][0] = r[0]; bs[2 * jj][1] = r[1];
                    bs[2 * jj + 1][0] = r[2]; bs[2 * jj + 1][1] = r[3];
                }
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                uint32_t ab[4], asml[4];
                ldsm_x4(ab, ab_ + koA[k8 / 8] + 256 * i);
                ldsm_x4(asml, ab_ + SA + koA[k8 / 8] + 256 * i);
                // Small terms first (a_s b_b, a_b b_s, then a_b b_b) into a
                // zeroed fragment that is added to the running sum in fp32:
                // the tensor cores' own accumulation truncates as it aligns
                // its addends, and over a long K that error is biased, so the
                // running sum never passes through it.
                float step[NT][4];
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) step[j][e] = 0.f;
#pragma unroll
                for (int j = 0; j < NT; ++j) mma_tf32(step[j], asml, bb[j][0], bb[j][1]);
#pragma unroll
                for (int j = 0; j < NT; ++j) mma_tf32(step[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
                for (int j = 0; j < NT; ++j) mma_tf32(step[j], ab, bb[j][0], bb[j][1]);
#pragma unroll
                for (int j = 0; j < NT; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][e] += step[j][e];
            }
        }
    }
    // The epilogue reads and writes whole rows: the block's sums go through
    // shared memory (the ring is free now; rows BN + 8 floats apart, so the
    // fragments' column pairs land conflict-free) and come back 4 columns a
    // thread, a warp along a row, as gemm_kernel's epilogue takes them.
    cp_async_wait<0>();
    __syncthreads();
    constexpr int LT = BN + 8;
    static_assert(BM * LT <= gemm_tc_smem_floats<BM, BN, kAT, kBN>(), "the tile fits the ring");
    float* const tile = reinterpret_cast<float*>(gemm_smem4);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < NT; ++j)
                *reinterpret_cast<float2*>(tile + (wr + i * 16 + g + 8 * h) * LT + wc + j * 8 + 2 * t) =
                    make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    __syncthreads();
    const Epilogue& ep = p.ep[prob];
    float* C = p.C[prob];
    for (int e = tid; e < BM * BN / 4; e += kGemmThreads) {
        const int rr = e / (BN / 4), cc = (e % (BN / 4)) * 4;
        const int r = m0 + rr, c = n0 + cc;
        if (r >= p.M || c >= p.N) continue;
        const float4 t4 = *reinterpret_cast<const float4*>(tile + rr * LT + cc);
        float v[4] = {t4.x, t4.y, t4.z, t4.w};
        epilogue_store4(p, ep, C, r, c, v);
    }
}

// ---------------------------------------------------------------------
// gemm_tn on the tensor cores: 3xTF32 on wgmma (m64n128k8, both operands
// from shared memory). A warpgroup issues a slice's six products (two k8
// steps, small terms first) as one group and splits the next slice while
// they run; the group writes zeroed step sums (scale-d 0 on its first
// product) that an FADD adds to the fp32 running sum after the wait. The
// operands are K-major tiles of core matrices (8 rows x 16 bytes, rows 16
// bytes apart; the 4 units of a row's 16 k adjacent, 128 bytes apart: the
// descriptor's leading byte offset; row groups 512 bytes apart: its stride
// byte offset), written by the split from the landed k-major slices.
constexpr int kWgStages = 3;

__host__ __device__ constexpr int wg_raw_floats() { return kGemmBK * (128 + kTcPad); }

__host__ __device__ constexpr int gemm_wg_smem_floats() {
    return kWgStages * 2 * wg_raw_floats() + 2 * 2 * 2 * 128 * kGemmBK;
}

// Float offset of (row r, k unit u) in a core-matrix tile.
__device__ __forceinline__ int core_off(int r, int u) {
    return ((((r >> 3) << 2) + u) << 5) + ((r & 7) << 2);
}

// A shared-memory matrix descriptor of a core-matrix tile, no swizzle:
// leading byte offset 128 (next unit of k), stride byte offset 512 (next 8
// rows).
__device__ __forceinline__ uint64_t wg_desc(const float* p) {
    const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
    return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)(512 >> 4) << 32);
}

// Orders the compiler's use of registers that an asynchronous wgmma
// writes: after the wait, no read of them moves above it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}


// Splits a landed k-major slice (128 rows x kGemmBK, k at a stride of
// KLD) into big and small core-matrix tiles; with `scale` (the slice's
// kGemmBK row scales), each stored row k is scaled first by scale[k].
template <int KLD>
__device__ __forceinline__ void wg_split_tile(const float* raw, float* big, float* small,
                                              const float* scale) {
    constexpr int kUnits = 128 * (kGemmBK / 4) / kGemmThreads;
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
        const int c = threadIdx.x + j * kGemmThreads;
        const int r = c % 128, u = c / 128;
        float v[4], b[4], sm[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            v[q] = raw[(4 * u + q) * KLD + r];
            if (scale) v[q] *= scale[4 * u + q];
            b[q] = rna_tf32(v[q]);
            sm[q] = rna_tf32(v[q] - b[q]);
        }
        const int off = core_off(r, u);
        *reinterpret_cast<float4*>(big + off) = make_float4(b[0], b[1], b[2], b[3]);
        *reinterpret_cast<float4*>(small + off) = make_float4(sm[0], sm[1], sm[2], sm[3]);
    }
}

// gemm_tn's 128x128 blocks (A (K, M), B (K, N), both k-major as they land;
// split-K, column sums and grid as gemm_kernel): warpgroup w owns rows 64 w
// .. 64 w + 63 of the tile; its running sums lie as wgmma's m64n128
// accumulator (rows 16 (warp % 4) + g and + 8, columns 8 j + 2 t, + 1).
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 1) gemm_wg_kernel(GemmParams p) {
    constexpr int S = kWgStages;
    constexpr int L = 128 + kTcPad;
    constexpr int R = wg_raw_floats();
    constexpr int CT = 128 * kGemmBK;   // one core-matrix tile
    constexpr int NR = 64;              // running sums a thread
    extern __shared__ float4 gemm_smem4[];
    float* const ringA = reinterpret_cast<float*>(gemm_smem4);   // (S, R)
    float* const ringW = ringA + S * R;                          // (S, R)
    float* const splitA = ringW + S * R;                         // (2, big | small, CT)
    float* const splitW = splitA + 4 * CT;                       // (2, big | small, CT)
    __shared__ float row_scale[S][kGemmBK];   // A's row scales of a ring stage

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int wg = warp / 4, wi = warp % 4;
    const float* __restrict__ W = p.W[0];
    const int col_tiles = (p.N + 127) / 128;
    const int m0 = (blockIdx.x / col_tiles) * 128;
    const int n0 = (blockIdx.x % col_tiles) * 128;
    const int kbeg = blockIdx.z * p.kchunk;
    const int kend = min(p.K, kbeg + p.kchunk);
    const int nk = (kend - kbeg + kGemmBK - 1) / kGemmBK;
    const bool colsum = p.colsum && n0 == 0;
    float cs = 0.f;

    auto load = [&](int kt) {
        const int s = kt % S;
        gemm_load_tile<128, true, kVec, L>(ringA + s * R, p.A, p.lda, p.M, m0,
                                           kbeg + kt * kGemmBK, kend);
        gemm_load_tile<128, true, kVec, L>(ringW + s * R, W, p.ldw, p.N, n0,
                                           kbeg + kt * kGemmBK, kend);
        if (p.ascale && tid < kGemmBK) {   // one division and load a row
            const int row = kbeg + kt * kGemmBK + tid;
            row_scale[s][tid] = row < kend ? p.ascale[row / p.adiv] : 0.f;
        }
    };
    // The split's shared-memory writes are generic-proxy stores that wgmma
    // reads through the async proxy: each writer fences them before the
    // barrier that precedes the reads.
    auto prepare = [&](int kt) {
        float* a = splitA + (kt & 1) * 2 * CT;
        float* w = splitW + (kt & 1) * 2 * CT;
        wg_split_tile<L>(ringA + (kt % S) * R, a, a + CT, p.ascale ? row_scale[kt % S] : nullptr);
        wg_split_tile<L>(ringW + (kt % S) * R, w, w + CT, nullptr);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };

    float acc[NR], step[NR];
#pragma unroll
    for (int e = 0; e < NR; ++e) acc[e] = step[e] = 0.f;

#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
        if (s < nk) load(s);
        cp_async_commit();
    }
    cp_async_wait<S - 2>();
    __syncthreads();
    prepare(0);
    for (int kt = 0; kt < nk; ++kt) {
        // Slice kt + 1 has landed, slice kt is split, and slice kt - 1's
        // products are done (each warpgroup waited on them), so its stage
        // and split tiles are free.
        cp_async_wait<S - 3>();
        __syncthreads();
        if (kt + S - 1 < nk) load(kt + S - 1);
        cp_async_commit();
        const float* ab = splitA + (kt & 1) * 2 * CT + core_off(64 * wg, 0);
        const float* as_ = ab + CT;
        const float* wb = splitW + (kt & 1) * 2 * CT;
        const float* ws = wb + CT;
        fence_regs(step);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int ku = 64 * h;   // two units of k
            wgmma_tf32_n128(step, wg_desc(as_ + ku), wg_desc(wb + ku), h);
            wgmma_tf32_n128(step, wg_desc(ab + ku), wg_desc(ws + ku), 1);
            wgmma_tf32_n128(step, wg_desc(ab + ku), wg_desc(wb + ku), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (kt + 1 < nk) prepare(kt + 1);
        if (colsum && tid < 128) {   // A's scaled slice, from the landed copy
            const float* raw = ringA + (kt % S) * R;
#pragma unroll
            for (int kk = 0; kk < kGemmBK; ++kk)
                cs += p.ascale ? raw[kk * L + tid] * row_scale[kt % S][kk] : raw[kk * L + tid];
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_regs(step);
#pragma unroll
        for (int e = 0; e < NR; ++e) acc[e] += step[e];
    }
    cp_async_wait<0>();
    if (colsum && tid < 128 && m0 + tid < p.M)
        p.colsum[(size_t)blockIdx.z * p.M + m0 + tid] = cs;

    // The partial sums go out in whole rows through shared memory, as
    // gemm_tc_kernel's.
    __syncthreads();
    constexpr int LT = 128 + 8;
    static_assert(128 * LT <= gemm_wg_smem_floats(), "the tile fits the ring");
    float* const tile = reinterpret_cast<float*>(gemm_smem4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
            *reinterpret_cast<float2*>(tile + (64 * wg + 16 * wi + g + 8 * h) * LT + 8 * j + 2 * t) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    __syncthreads();
    float* C = p.C[0] + (size_t)blockIdx.z * p.M * p.ldc;
    for (int e = tid; e < 128 * 32; e += kGemmThreads) {
        const int rr = e / 32, cc = (e % 32) * 4;
        const int r = m0 + rr, c = n0 + cc;
        if (r >= p.M || c >= p.N) continue;
        const float4 t4 = *reinterpret_cast<const float4*>(tile + rr * LT + cc);
        float v[4] = {t4.x, t4.y, t4.z, t4.w};
        epilogue_store4(p, p.ep[0], C, r, c, v);
    }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether a (rows, ld) operand or epilogue term takes float4 accesses.
inline bool vec_ok(const void* p, int ld) { return !p || (aligned16(p) && ld % 4 == 0); }

// How gemm_tn splits its R rows (on either path): as many 128x128 blocks as
// two blocks on each of the 132 SMs hold at once (one wave of the CUDA-core
// kernel, two of the tensor-core one, no ragged tail), at least 64 rows
// each.
struct SplitK {
    int splits, kchunk;
};
inline SplitK splitk_for(int M, int N, int R) {
    const long long tiles = gemm_tiles(kTile128x128, M, N);
    long long z = 2 * kGemmSMs / tiles;
    const long long zmax = (R + 63) / 64;
    if (z > zmax) z = zmax;
    if (z < 1) z = 1;
    int kchunk = (int)((R + z - 1) / z);
    kchunk = (kchunk + kGemmBK - 1) / kGemmBK * kGemmBK;
    return {(R + kchunk - 1) / kchunk, kchunk};
}

// The two paths; `gemm_path_for` picks one by layout (0 nt, 1 nn, 2 tn) and
// shape, statically (the Python mirror in ops/gemm_cuda.py restates the
// rule), from the two paths' times on the H100 (chip_smoke.py phase 14,
// PERF.md §6). gemm_nt and gemm_nn take the tensor cores from M N K =
// 2^29 on (per problem): there the tensor path ran at 0.96-1.23 times the
// CUDA cores' speed, most products at 1.1-1.2; below (a few hundred to a
// few thousand rows) at 0.5-1.15 times, within the noise of launches that
// short. gemm_tn's tensor-core blocks (one an SM) pay their prologue and
// epilogue over the rows a block reduces: from kWgMinRows rows on they take
// the tensor cores (528-8,320 rows a block ran at 1.19-1.42 times), below
// the CUDA cores (64-144 rows at 0.92-1.04 times).
enum GemmPath { kPathCudaCore = 0, kPathTensor = 1 };
constexpr int kWgMinRows = 512;
constexpr long long kTcMinWork = 1LL << 29;

inline int gemm_path_for(int layout, int M, int N, int K, int groups) {
    (void)groups;
    if (layout == 2) return splitk_for(M, N, K).kchunk >= kWgMinRows ? kPathTensor : kPathCudaCore;
    return (long long)M * N * K >= kTcMinWork ? kPathTensor : kPathCudaCore;
}

// The one call site that fixes its path instead: the moment unit's product
// over [x1 | x2] (K = 2D, smin_units.cuh::layer_forward) takes the tensor
// cores at every shape, for accuracy. At the top of an SMI stack x1 = bu[i]
// bu[j] reaches about 2,500 and mu cancels to near zero at some pairs; there
// no fp32 evaluation stays within K2's tolerance of float64 (the fp32 plain
// version misses it at 11 to 1,172 elements of a layer), 3xTF32 comes
// closest (at 0 to 284), and the CUDA cores' one FMA chain over K = 2D lands
// farther from float64 than the plain version (PERF.md §6).
// ops/gemm_cuda.py::SITE_PATHS mirrors it.
constexpr int kMomentProductPath = kPathTensor;

// Dynamic shared memory of one block of a path, layout and tile.
template <int BM, int BN, bool kAT, bool kBN>
constexpr size_t gemm_smem_bytes(int path) {
    if (path != kPathTensor) return sizeof(float) * gemm_smem_floats<BM, BN, kAT, kBN>();
    return sizeof(float) * (kAT ? gemm_wg_smem_floats() : gemm_tc_smem_floats<BM, BN, kAT, kBN>());
}

// Whether this library has raised a kernel instance's shared-memory limit on
// a device, by [device][path][layout nt / nn / tn][tile][vec]. A
// namespace-scope static has internal linkage: each .cu (its own library)
// keeps its own, as it must, since each has its own copy of the kernels. (A
// function-local static in an inline function or template would be one
// object across the libraries of a process.)
static bool g_gemm_smem_raised[8][2][3][3][2];

template <int BM, int BN, bool kAT, bool kBN>
inline void gemm_run(cudaStream_t st, dim3 grid, const GemmParams& p, bool vec, int path) {
    const size_t smem = gemm_smem_bytes<BM, BN, kAT, kBN>(path);
    constexpr int layout = kAT ? 2 : kBN ? 1 : 0;
    constexpr int tile = BM == 128 ? (BN == 128 ? kTile128x128 : kTile128x64) : kTile64x64;
    void (*tensor)(GemmParams);
    if constexpr (kAT)   // gemm_tn: 128x128 tiles only
        tensor = vec ? gemm_wg_kernel<true> : gemm_wg_kernel<false>;
    else
        tensor = vec ? gemm_tc_kernel<BM, BN, kAT, kBN, true> : gemm_tc_kernel<BM, BN, kAT, kBN, false>;
    auto kernel = path == kPathTensor ? tensor
                                      : (vec ? gemm_kernel<BM, BN, kAT, kBN, true>
                                             : gemm_kernel<BM, BN, kAT, kBN, false>);
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return;   // the caller's cudaGetLastError() reports it
    bool* raised = dev < 8 ? &g_gemm_smem_raised[dev][path][layout][tile][vec] : nullptr;
    if (!raised || !*raised) {
        if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem) != cudaSuccess)
            return;
        if (raised) *raised = true;
    }
    kernel<<<grid, kGemmThreads, smem, st>>>(p);
}

// Launches one layout over `groups` problems (p.W / p.C / p.ep [0 ..
// groups)) and `splits` blocks along z; tile < 0 picks the tile, path < 0
// the path (by shape). gemm_tn runs on 128x128 tiles only (its split-K
// fills the SMs).
template <bool kAT, bool kBN>
inline void gemm_launch(cudaStream_t st, GemmParams p, int groups, int splits, int tile,
                        int path) {
    if (kAT) tile = kTile128x128;
    if (tile < 0) tile = gemm_tile_for(p.M, p.N, groups);
    if (path < 0) path = gemm_path_for(kAT ? 2 : kBN ? 1 : 0, p.M, p.N, p.K, groups);
    const dim3 grid((unsigned)gemm_tiles(tile, p.M, p.N), groups, splits);
    // 16-byte copies: the extent along which each operand is contiguous.
    bool vec = (kAT ? p.M : p.K) % 4 == 0 && (kBN ? p.N : p.K) % 4 == 0 &&
                 p.lda % 4 == 0 && p.ldw % 4 == 0 && aligned16(p.A);
    bool vec_out = p.N % 4 == 0;
    for (int g = 0; g < groups; ++g) {
        const Epilogue& e = p.ep[g];
        vec = vec && aligned16(p.W[g]);
        vec_out = vec_out && vec_ok(p.C[g], p.ldc) && vec_ok(e.bias, 0) &&
                  vec_ok(e.pre, e.ldpre) && vec_ok(e.post, e.ldpost) && vec_ok(e.post2, e.ldpost2);
    }
    p.vec_out = vec_out;
    if constexpr (kAT) {
        gemm_run<128, 128, kAT, kBN>(st, grid, p, vec, path);
    } else {
        switch (tile) {
            case kTile128x128: gemm_run<128, 128, kAT, kBN>(st, grid, p, vec, path); break;
            case kTile128x64: gemm_run<128, 64, kAT, kBN>(st, grid, p, vec, path); break;
            default: gemm_run<64, 64, kAT, kBN>(st, grid, p, vec, path); break;
        }
    }
}

inline GemmParams gemm_params(int M, int N, int K, const float* A, int lda, const float* ascale,
                              int adiv, int ldw, int ldc) {
    GemmParams p{};
    p.M = M; p.N = N; p.K = K; p.kchunk = K;
    p.A = A; p.lda = lda; p.ascale = ascale; p.adiv = adiv;
    p.ldw = ldw; p.ldc = ldc;
    return p;
}

// C = epilogue(A @ W^T) on `stream`; W (N, K). `tile`, `path` < 0: by
// shape (the card tests force them).
inline void gemm_nt(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                    const float* W, int ldw, float* C, int ldc, const Epilogue& ep,
                    int tile = -1, int path = -1) {
    GemmParams p = gemm_params(M, N, K, A, lda, nullptr, 1, ldw, ldc);
    p.W[0] = W; p.C[0] = C; p.ep[0] = ep;
    gemm_launch<false, false>(stream, p, 1, 1, tile, path);
}

// Two products of one A in one launch: C0 = ep0(A @ W0^T), C1 = ep1(A @ W1^T).
inline void gemm_nt2(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                     const float* W0, const float* W1, int ldw, float* C0, float* C1, int ldc,
                     const Epilogue& ep0, const Epilogue& ep1) {
    GemmParams p = gemm_params(M, N, K, A, lda, nullptr, 1, ldw, ldc);
    p.W[0] = W0; p.W[1] = W1; p.C[0] = C0; p.C[1] = C1; p.ep[0] = ep0; p.ep[1] = ep1;
    gemm_launch<false, false>(stream, p, 2, 1, -1, -1);
}

// C = epilogue((A * ascale[row / adiv]) @ W) on `stream`; W (K, N).
inline void gemm_nn(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                    const float* ascale, int adiv, const float* W, int ldw, float* C,
                    int ldc, const Epilogue& ep, int tile = -1, int path = -1) {
    GemmParams p = gemm_params(M, N, K, A, lda, ascale, adiv, ldw, ldc);
    p.W[0] = W; p.C[0] = C; p.ep[0] = ep;
    gemm_launch<false, true>(stream, p, 1, 1, tile, path);
}

// Two products of one scaled A in one launch, as gemm_nt2.
inline void gemm_nn2(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                     const float* ascale, int adiv, const float* W0, const float* W1, int ldw,
                     float* C0, float* C1, int ldc, const Epilogue& ep0, const Epilogue& ep1) {
    GemmParams p = gemm_params(M, N, K, A, lda, ascale, adiv, ldw, ldc);
    p.W[0] = W0; p.W[1] = W1; p.C[0] = C0; p.C[1] = C1; p.ep[0] = ep0; p.ep[1] = ep1;
    gemm_launch<false, true>(stream, p, 2, 1, -1, -1);
}

// out[e] = sum_z partial[z * count + e] and bout[m] = sum_z bpartial[z * bcount
// + m], z ascending (bcount 0: no column sums). With out2 (two products of
// one A side by side, `gemm_tn2`): the (count / N, N) sums are split at
// column N0, the first N0 columns to out (rows of N0), the rest to out2
// (rows of N - N0), and the column sums go to bout and bout2 both.
__global__ void reduce_partials_kernel(int Z, size_t count, const float* __restrict__ partial,
                                       float* __restrict__ out, size_t bcount,
                                       const float* __restrict__ bpartial,
                                       float* __restrict__ bout, int N = 0, int N0 = 0,
                                       float* __restrict__ out2 = nullptr,
                                       float* __restrict__ bout2 = nullptr) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count + bcount;
         e += (size_t)gridDim.x * blockDim.x) {
        const bool b = e >= count;
        const size_t i = b ? e - count : e;
        const size_t n = b ? bcount : count;
        const float* src = b ? bpartial : partial;
        float s = 0.f;
        for (int z = 0; z < Z; ++z) s += src[(size_t)z * n + i];
        if (b) {
            bout[i] = s;
            if (bout2) bout2[i] = s;
        } else if (out2) {
            const size_t row = i / N;
            const int col = (int)(i - row * N);
            if (col < N0)
                out[row * N0 + col] = s;
            else
                out2[row * (N - N0) + col - N0] = s;
        } else {
            out[i] = s;
        }
    }
}

// The reduction of a split gemm_tn's partials (`reduce_partials_kernel`);
// `split` > 0 splits the (M, N) sums at that column into out and out2.
inline void launch_reduce_partials(cudaStream_t stream, int splits, int M, int N,
                                   const float* partial, float* out, const float* colsum,
                                   float* bias_out, int split = 0, float* out2 = nullptr,
                                   float* bias_out2 = nullptr) {
    const size_t count = (size_t)M * N;
    const size_t bcount = bias_out ? (size_t)M : 0;
    const size_t total = count + bcount;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    reduce_partials_kernel<<<blocks, 256, 0, stream>>>(splits, count, partial, out, bcount,
                                                       colsum, bias_out, N, split, out2,
                                                       bias_out2);
}

// Floats of the partial-sum buffer gemm_tn needs: the split products and
// the split column sums.
inline size_t gemm_tn_partial_floats(int M, int N, int R) {
    return (size_t)splitk_for(M, N, R).splits * ((size_t)M * N + M);
}

// out (M, N) = (A * ascale[row / adiv])^T @ B, A (R, M), B (R, N), reduced
// over the R rows through `partial`; bias_out (M,) (optional) = the column
// sums of the scaled A, a bias gradient, from the same pass over A. The
// split, and so `partial`'s size, is the same on both paths. `split` > 0
// (`gemm_tn2`): out gets B's first `split` columns' products, out2 the
// rest's, bias_out2 the column sums too.
inline void gemm_tn(cudaStream_t stream, int M, int N, int R, const float* A, int lda,
                    const float* ascale, int adiv, const float* B, int ldb, float* partial,
                    float* out, float* bias_out = nullptr, int path = -1, int split = 0,
                    float* out2 = nullptr, float* bias_out2 = nullptr) {
    const SplitK s = splitk_for(M, N, R);
    GemmParams p = gemm_params(M, N, R, A, lda, ascale, adiv, ldb, N);
    p.kchunk = s.kchunk;
    p.W[0] = B;
    p.C[0] = partial;
    p.colsum = bias_out ? partial + (size_t)s.splits * M * N : nullptr;
    gemm_launch<true, true>(stream, p, 1, s.splits, kTile128x128, path);
    launch_reduce_partials(stream, s.splits, M, N, partial, out, p.colsum, bias_out, split, out2,
                           bias_out2);
}

// C = A @ W^T + bias, the epilogue of a plain nn.Linear.
inline void linear(cudaStream_t stream, int M, int N, int K, const float* A,
                   const float* W, const float* bias, float* C) {
    Epilogue ep;
    ep.bias = bias;
    gemm_nt(stream, M, N, K, A, K, W, K, C, N, ep);
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// ------------------------------------------------------------------------
// The bf16 path: C = epilogue(op(A) op(W)) with A and W in bf16, products of
// bf16 operands added in fp32 (mma.sync m16n8k16, bf16 -> fp32), the
// epilogue in fp32 and the result stored in bf16 or fp32; the counterpart of
// the JAX kernels' single-pass bf16 products with fp32 accumulation
// (preferred_element_type=f32). The three layouts of the fp32 path:
//   gemm_nt_bf16  C = A W^T, A (M, K), W (N, K): the forward projections of
//                 the bf16 variants of K4, K5 and K2;
//   gemm_nn_bf16  C = A W, W (K, N): dX = dY W of K3-bf16;
//   gemm_tn_bf16  C = (A * ascale)^T B, A (R, M), B (R, N), reduced over R
//                 in split blocks whose fp32 partial sums
//                 `reduce_partials_kernel` adds in a fixed order (no
//                 atomics), with the column sums of the scaled A from the
//                 same pass: the weight and bias gradients of K3-bf16, fp32.
// Two kernels, chosen statically by `gemm_path_for_bf16` from layout,
// shape and alignment: the wgmma / TMA kernel below (`gemm_bf16_wg_kernel`)
// for every product whose operands TMA can read, and `gemm_bf16_kernel`
// (mma.sync) for the rest: operands off 16-byte alignment or with leading
// dimensions no multiple of 8 (the card tests' odd widths and shifted
// views). The mma.sync kernel:
//   * block tiles and grid as the fp32 path (`gemm_tile_for`: 128x128,
//     128x64 or 64x64, the problem index along gridDim.y; gemm_tn 128x128
//     with `splitk_for`'s split along gridDim.z), 256 threads as 8 warps of
//     64x32, 32x32 or 32x16 outputs;
//   * 32-deep K slices in a 4-stage ring of 16-byte cp.async copies. An
//     operand contiguous along k lands as rows of 40 bf16 (80 bytes:
//     ldmatrix's 8 row addresses fall on 8 distinct groups of 4 banks); one
//     contiguous along its rows (A of gemm_tn, W of gemm_nn and gemm_tn)
//     lands k-major as it lies, 32 rows of R + 8 bf16 (272 or 144 bytes:
//     the same 8 distinct groups);
//   * fragments by ldmatrix (x4 for A's 16 x 16, x4 for two n8 tiles of W),
//     with .trans for a k-major tile: ldmatrix.trans hands each lane the
//     elements of the transposed 8 x 8 matrix, which is the fragment mma
//     wants, so no operand is transposed in memory;
//   * gemm_tn's row scale (the backward's row masks) is applied to the
//     landed A slice in shared memory, and the blocks of the first column
//     tile add that scaled slice per column, in order (the bias gradient);
//   * the epilogue from the fragments: bias, pre (fp32), the row mask and
//     the residuals (bf16 post and post2, fp32 post32) in fp32, one rounding
//     to the output type (with `round_each`, a rounding after the mask and
//     after post too: residuals added in bf16);
//   * operands that are not 16-byte aligned or whose contiguous extents or
//     leading dimensions are no multiple of 8 take synchronous guarded loads.
struct EpilogueBf16 {
    const float* bias = nullptr;   // (N,)
    const float* pre = nullptr;    // (M, ldpre) fp32, added before the mask
    int ldpre = 0;
    const float* rmask = nullptr;  // (M / mask_div,)
    int mask_div = 1;
    const bf16* post = nullptr;    // (M, ldpost), added after the mask
    int ldpost = 0;
    const float* post32 = nullptr; // (M, ldpost32) fp32, added after the mask
    int ldpost32 = 0;
    const bf16* post2 = nullptr;   // (M / post2_div, ldpost2), after the mask
    int ldpost2 = 0;
    int post2_div = 1;
    bool round_each = false;       // round to bf16 after the mask and after post:
                                   // the residuals added in bf16 (K10-bf16)
};

constexpr int kBfBK = 32;             // K of a stage
constexpr int kBfLd = kBfBK + 8;      // bf16 per shared row of a k-contiguous tile
constexpr int kBfPad = 8;             // bf16 past R per shared row of a k-major tile
constexpr int kBfStages = 4;
constexpr int kPathBf16 = 2;          // ops/gemm_cuda.py::BF16

struct GemmBf16Params {
    int M, N, K, kchunk;
    const bf16* A;
    int lda, ldw, ldc;
    const float* ascale;      // gemm_tn: scale of A's stored row r (r / adiv)
    int adiv;
    const bf16* W[2];
    void* C[2];               // bf16 or, when out_f32, float (gemm_tn: the partials)
    EpilogueBf16 ep[2];
    bool out_f32;
    float* colsum;            // gemm_tn: (gridDim.z, M) partial column sums of the scaled A
};

// bf16 elements of one operand's slice of R rows (m or n): k-major (kKM,
// kBfBK rows of R + kBfPad) or k-contiguous (R rows of kBfLd).
template <int R, bool kKM>
__host__ __device__ constexpr int gemm_bf16_tile_elems() {
    return kKM ? kBfBK * (R + kBfPad) : R * kBfLd;
}

template <int BM, int BN, bool kAT, bool kBN>
constexpr size_t gemm_bf16_smem_bytes() {
    return sizeof(bf16) * (size_t)kBfStages *
           (gemm_bf16_tile_elems<BM, kAT>() + gemm_bf16_tile_elems<BN, kBN>());
}

// By layout (0 nt, 1 nn, 2 tn) and tile.
inline size_t gemm_bf16_smem_bytes_for(int layout, int tile) {
    switch (layout * 3 + tile) {
        case 0: return gemm_bf16_smem_bytes<128, 128, false, false>();
        case 1: return gemm_bf16_smem_bytes<128, 64, false, false>();
        case 2: return gemm_bf16_smem_bytes<64, 64, false, false>();
        case 3: return gemm_bf16_smem_bytes<128, 128, false, true>();
        case 4: return gemm_bf16_smem_bytes<128, 64, false, true>();
        case 5: return gemm_bf16_smem_bytes<64, 64, false, true>();
        case 6: return gemm_bf16_smem_bytes<128, 128, true, true>();
        case 7: return gemm_bf16_smem_bytes<128, 64, true, true>();
        default: return gemm_bf16_smem_bytes<64, 64, true, true>();
    }
}

__device__ __forceinline__ void cp_async16_any(void* dst, const void* src, bool valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand's slice of R rows from r0 on (of `rows`) and kBfBK k from k0 on
// (k below kend), into shared memory. kKM: element (k, r) at P[k * ld + r],
// stored k-major (row k at s + k * (R + kBfPad)); else at P[r * ld + k],
// stored k-contiguous (row r at s + r * kBfLd). kVec: 16-byte copies of 8
// elements along the contiguous extent, which then is a multiple of 8 (a
// copy is wholly inside or outside it).
template <int R, bool kKM, bool kVec>
__device__ __forceinline__ void gemm_bf16_load(bf16* s, const bf16* __restrict__ P, int ld,
                                               int rows, int r0, int k0, int kend) {
    constexpr int kChunks = R * (kBfBK / 8);     // 16-byte chunks of the slice
    for (int c = threadIdx.x; c < kChunks; c += kGemmThreads) {
        int r, k;
        bf16* dst;
        if constexpr (kKM) {
            k = c / (R / 8);
            r = (c % (R / 8)) * 8;
            dst = s + k * (R + kBfPad) + r;
        } else {
            r = c / (kBfBK / 8);
            k = (c % (kBfBK / 8)) * 8;
            dst = s + r * kBfLd + k;
        }
        const int gr = r0 + r, gk = k0 + k;
        if constexpr (kVec) {
            const bool ok = gr < rows && gk < kend;
            const bf16* src = ok ? (kKM ? P + (size_t)gk * ld + gr : P + (size_t)gr * ld + gk) : P;
            cp_async16_any(dst, src, ok);
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int er = kKM ? gr + e : gr, ek = kKM ? gk : gk + e;
                dst[e] = (er < rows && ek < kend) ? P[(size_t)(kKM ? ek : er) * ld + (kKM ? er : ek)]
                                                  : __float2bfloat16(0.f);
            }
        }
    }
}

// kAT: A stored (K, M) (gemm_tn); kBN: W stored (K, N) (gemm_nn, gemm_tn);
// else (M, K) and (N, K). Block z reduces k in [z * kchunk, min(K, (z + 1)
// * kchunk)) into C + z * M * ldc (one block when kchunk >= K).
template <int BM, int BN, bool kAT, bool kBN, bool kVec>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_bf16_kernel(GemmBf16Params p) {
    extern __shared__ __align__(16) unsigned char gemm_bf16_smem[];
    constexpr int WARPS_M = BN == 128 ? 2 : (BM == 128 ? 4 : 2);
    constexpr int WARPS_N = 8 / WARPS_M;
    constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
    constexpr int MT = WM / 16, NT = WN / 8;
    constexpr int AE = gemm_bf16_tile_elems<BM, kAT>(), WE = gemm_bf16_tile_elems<BN, kBN>();
    constexpr int ALD = BM + kBfPad, WLD = BN + kBfPad;   // k-major row strides
    static_assert(NT % 2 == 0, "two n8 tiles per ldmatrix");
    bf16* As = reinterpret_cast<bf16*>(gemm_bf16_smem);
    bf16* Ws = As + (size_t)kBfStages * AE;

    const int g = blockIdx.y;
    const bf16* __restrict__ W = p.W[g];
    const int tiles_n = (p.N + BN - 1) / BN;
    const int m0 = (int)(blockIdx.x / tiles_n) * BM;
    const int n0 = (int)(blockIdx.x % tiles_n) * BN;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
    const int kbeg = blockIdx.z * p.kchunk;
    const int kend = min(p.K, kbeg + p.kchunk);
    const bool colsum = kAT && p.colsum && n0 == 0;

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    float csum = 0.f;

    auto load = [&](int st, int k0) {
        gemm_bf16_load<BM, kAT, kVec>(As + st * AE, p.A, p.lda, p.M, m0, k0, kend);
        gemm_bf16_load<BN, kBN, kVec>(Ws + st * WE, W, p.ldw, p.N, n0, k0, kend);
    };
    const int ktiles = (kend - kbeg + kBfBK - 1) / kBfBK;
#pragma unroll
    for (int st = 0; st < kBfStages - 1; ++st) {
        if (st < ktiles) load(st, kbeg + st * kBfBK);
        cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
        cp_async_wait<kBfStages - 2>();
        __syncthreads();
        const int nk = kt + kBfStages - 1;
        if (nk < ktiles) load(nk % kBfStages, kbeg + nk * kBfBK);
        cp_async_commit();
        bf16* a_s = As + (kt % kBfStages) * AE;
        const bf16* w_s = Ws + (kt % kBfStages) * WE;
        if constexpr (kAT) {
            const int k0 = kbeg + kt * kBfBK;
            if (p.ascale) {   // the row scale of the landed slice, in place
                for (int e = threadIdx.x; e < kBfBK * BM; e += kGemmThreads) {
                    const int k = e / BM, m = e % BM;
                    const float sc = k0 + k < kend ? p.ascale[(k0 + k) / p.adiv] : 0.f;
                    bf16* at = a_s + k * ALD + m;
                    *at = __float2bfloat16(__bfloat162float(*at) * sc);
                }
                __syncthreads();
            }
            if (colsum && threadIdx.x < BM)
                for (int k = 0; k < kBfBK; ++k) csum += __bfloat162float(a_s[k * ALD + threadIdx.x]);
        }
#pragma unroll
        for (int kk = 0; kk < kBfBK; kk += 16) {
            unsigned af[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                if constexpr (kAT)
                    ldmatrix_x4_trans(af[i], a_s + (kk + lane % 8 + (lane / 16) * 8) * ALD + wm0 +
                                                 i * 16 + ((lane / 8) % 2) * 8);
                else
                    ldmatrix_x4(af[i], a_s + (wm0 + i * 16 + lane % 16) * kBfLd + kk +
                                           (lane / 16) * 8);
            }
#pragma unroll
            for (int j = 0; j < NT; j += 2) {
                unsigned bfr[4];
                if constexpr (kBN)
                    ldmatrix_x4_trans(bfr, w_s + (kk + lane % 8 + ((lane / 8) % 2) * 8) * WLD + wn0 +
                                               j * 8 + (lane / 16) * 8);
                else
                    ldmatrix_x4(bfr, w_s + (wn0 + j * 8 + lane % 8 + (lane / 16) * 8) * kBfLd + kk +
                                         ((lane / 8) % 2) * 8);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    mma_bf16(acc[i][j], af[i], bfr[0], bfr[1]);
                    mma_bf16(acc[i][j + 1], af[i], bfr[2], bfr[3]);
                }
            }
        }
    }
    cp_async_wait<0>();
    if (colsum && threadIdx.x < BM && m0 + (int)threadIdx.x < p.M)
        p.colsum[(size_t)blockIdx.z * p.M + m0 + threadIdx.x] = csum;

    const EpilogueBf16& ep = p.ep[g];
    const int gq = lane / 4, tq = lane % 4;
    const size_t zoff = (size_t)blockIdx.z * p.M * p.ldc;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int r = m0 + wm0 + i * 16 + gq + half * 8;
            if (r >= p.M) continue;
            const float mask = ep.rmask ? ep.rmask[r / ep.mask_div] : 1.f;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int c = n0 + wn0 + j * 8 + tq * 2 + e;
                    if (c >= p.N) continue;
                    float v = acc[i][j][half * 2 + e];
                    if (ep.bias) v += ep.bias[c];
                    if (ep.pre) v += ep.pre[(size_t)r * ep.ldpre + c];
                    v *= mask;
                    if (ep.round_each) v = to_f(__float2bfloat16(v));
                    if (ep.post) v += to_f(ep.post[(size_t)r * ep.ldpost + c]);
                    if (ep.round_each) v = to_f(__float2bfloat16(v));
                    if (ep.post32) v += ep.post32[(size_t)r * ep.ldpost32 + c];
                    if (ep.post2) v += to_f(ep.post2[(size_t)(r / ep.post2_div) * ep.ldpost2 + c]);
                    const size_t o = zoff + (size_t)r * p.ldc + c;
                    if (p.out_f32)
                        static_cast<float*>(p.C[g])[o] = v;
                    else
                        static_cast<bf16*>(p.C[g])[o] = __float2bfloat16(v);
                }
            }
        }
    }
}

// Whether this library has raised a bf16 kernel instance's shared-memory
// limit on a device, by [device][layout][tile][vec] (internal linkage: one
// per library, as g_gemm_smem_raised).
static bool g_gemm_bf16_smem_raised[8][3][3][2];

template <int BM, int BN, bool kAT, bool kBN>
inline void gemm_bf16_run(cudaStream_t st, dim3 grid, const GemmBf16Params& p, bool vec) {
    constexpr int tile = BM == 128 ? (BN == 128 ? kTile128x128 : kTile128x64) : kTile64x64;
    constexpr int layout = kAT ? 2 : kBN ? 1 : 0;
    const size_t smem = gemm_bf16_smem_bytes<BM, BN, kAT, kBN>();
    auto kernel = vec ? gemm_bf16_kernel<BM, BN, kAT, kBN, true>
                      : gemm_bf16_kernel<BM, BN, kAT, kBN, false>;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return;   // the caller's cudaGetLastError() reports it
    bool* raised = dev < 8 ? &g_gemm_bf16_smem_raised[dev][layout][tile][vec] : nullptr;
    if (!raised || !*raised) {
        if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem) != cudaSuccess)
            return;
        if (raised) *raised = true;
    }
    kernel<<<grid, kGemmThreads, smem, st>>>(p);
}

// ---------------------------------------------------------------------
// The bf16 path on Hopper's own units (`gemm_bf16_wg_kernel`): the same
// function as gemm_bf16_kernel in all three layouts, both problems of
// gemm_nt2_bf16 / gemm_nn2_bf16 and gemm_tn_bf16's splits, for every
// product whose operands TMA can read (`gemm_path_for_bf16`). Bound on the
// H100 (PERF.md §6): the bytes. These products have K and N of 128 to 512,
// about 100 operations a byte or fewer against the 295 at which the tensor
// cores would be the limit, so each product's time is its operands read
// once and its output and residuals moved once. What the design does:
//   * loads: a producer warp keeps TMA copies of both operands in flight
//     into a ring of slices (128-byte swizzle), on full and empty mbarriers
//     (tma.cuh); an operand contiguous along k lands as one box of 64 k (a
//     128-byte row) by its rows, one contiguous along its rows (A of tn, W
//     of nn and tn) as boxes of 64 columns by the slice's k rows, and wgmma
//     reads it that way (its transpose bits: 16-bit operands may be M- or
//     N-major), so nothing is transposed in shared memory;
//   * products: the consumer warpgroups issue wgmma m64n128k16 (bf16 ->
//     fp32) from shared memory, adding into the running sums in order of k;
//   * nt / nn (short K, residual-heavy epilogues): a tile is 64 x 128 and a
//     consumer warpgroup takes every other tile of its block (ping-pong),
//     so that one warpgroup's epilogue runs under the other's products and
//     the ring streams on; 64-deep slices in a ring of 5;
//   * tn (K of thousands of rows, an epilogue of fp32 partial sums): both
//     consumer warpgroups share a 128 x 128 tile (B read once for 128 rows)
//     and the slices are 128 deep (16 KB boxes), in a ring of 2;
//   * persistence: one block an SM walks the output tiles in a fixed order
//     (column tiles fastest, then the problem, then the row tiles, then
//     gemm_tn's splits), so that the ring loads the next tile's slices while
//     this tile's epilogue runs; the order of additions of every output is
//     fixed by the plan, not by which block takes the tile;
//   * the epilogue: the running sums are staged in shared memory (a
//     warpgroup's 64 x 128 fp32, in 128-byte-swizzled boxes); 16 threads a
//     row, 8 columns a thread, apply the epilogue with 16-byte loads of
//     every residual issued for eight rows (four with fp32 residuals)
//     before any is used, and write the result tile back (fp32 in place,
//     bf16 into a tile of its own), which one thread stores by TMA; the
//     kernel is compiled for three kinds of epilogue (`WgEpi`), so that a
//     launch carries only its own terms' loads and arithmetic; the
//     arithmetic and roundings are gemm_bf16_kernel's, term for term;
//   * gemm_tn keeps splitk_for's split (the same rows into one accumulator
//     as the mma.sync kernel, so no longer a chain through the tensor cores'
//     truncating adder) and the fixed-order `reduce_partials_kernel`; a
//     split is a 3-D view (split, row, column) of A and B whose rows past
//     kchunk read as 0, the last split its own map, so no box reaches into
//     the next split's rows; the row scale is applied to the landed A slice
//     by the consumers (fence.proxy.async before wgmma reads it) and the
//     first column tile's consumers add the scaled slice per column (the
//     bias gradient) in eight chains of every eighth row, summed in a fixed
//     tree (one chain of 128 adds a slice held those blocks back).
constexpr int kWgBfTile = 128;               // columns of an output tile (and rows of tn's)
constexpr int kWgBfThreads = 384;            // a producer warpgroup, two consumer warpgroups
constexpr int kPathBf16Wg = 3;               // ops/gemm_cuda.py::BF16_WG

// The shape of the wgmma kernel's work by layout (kAT: gemm_tn).
template <bool kAT>
struct WgBf {
    static constexpr int kRows = kAT ? 128 : 64;   // rows of an output tile
    static constexpr int kBK = kAT ? 128 : 64;     // K of a slice
    static constexpr int kStages = kAT ? 2 : 5;
    static constexpr int kABytes = kRows * kBK * 2;
    static constexpr int kBBytes = kWgBfTile * kBK * 2;
    static constexpr int kStageBytes = kABytes + kBBytes;
    static constexpr int kBoxBytes = 64 * kBK * 2;         // an M- / N-major box of 64 columns
    static constexpr int kArrivals = kAT ? 8 : 4;          // consumer warps a slice
    // 1024 bytes of alignment slack, the ring, each consumer warpgroup's
    // staged fp32 tile and bf16 output tile (64 x 128), the mbarriers.
    static constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                                    2 * 64 * kWgBfTile * (sizeof(float) + sizeof(bf16)) +
                                    2 * kStages * sizeof(uint64_t);
    static_assert(kSmem <= 232448, "one block an SM within 227 KB");
};

// Dynamic shared memory of the wgmma kernel by layout (0 nt, 1 nn, 2 tn).
constexpr size_t gemm_bf16_wg_smem_bytes(int layout) {
    return layout == 2 ? WgBf<true>::kSmem : WgBf<false>::kSmem;
}

struct GemmBf16WgParams {
    // nt / nn: A, W of problem 0, W of problem 1, -, C of problem 0, C of
    // problem 1; tn: A and B of the splits before the last (3-D), A and B of
    // the last split, the partial sums (3-D). The C maps where vec_out.
    CUtensorMap map[6];
    int M, N, K, kchunk, splits, groups;
    int tiles_n, tiles_m, tiles;
    int ldc;
    const float* ascale;
    int adiv;
    void* C[2];
    EpilogueBf16 ep[2];
    bool out_f32, vec_out;
    float* colsum;
};

// A wgmma shared-memory descriptor of a 128-byte-swizzled tile: leading byte
// offset `lbo` (MN-major: the next 64 columns), stride byte offset 1024 (the
// next 8 rows of 128 bytes).
__device__ __forceinline__ uint64_t wg_bf16_desc(const void* p, uint32_t lbo) {
    const uint32_t a = smem_addr(p);
    return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset, in a warpgroup's staged tile, of the 16-byte unit holding
// fp32 element (row, col) (col a multiple of 4): boxes of 32 columns by 64
// rows of 128 bytes, units XOR-swizzled by the row (TMA's 128-byte swizzle).
__device__ __forceinline__ int wg_staged_off(int row, int col) {
    return (col >> 5) * 8192 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4);
}

// The same for the bf16 output tile's element (row, col), col a multiple of
// 8: boxes of 64 columns by 64 rows.
__device__ __forceinline__ int wg_out16_off(int row, int col) {
    return (col >> 6) * 8192 + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void wg_bar(int id) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// A handoff between the two consumer warpgroups on named barrier `id`: one
// arrives, the other waits for its arrival.
__device__ __forceinline__ void wg_bar256(int id) {
    asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wg_arrive256(int id) {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// d (m64 x n128, fp32) += A (64 x 16) B (16 x 128) from shared memory; kTA /
// kTB: the operand is M- / N-major (wgmma's transpose bits).
template <bool kTA, bool kTB>
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16_n128<false, false>(float (&d)[64], uint64_t da,
                                                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16_n128<false, true>(float (&d)[64], uint64_t da,
                                                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16_n128<true, false>(float (&d)[64], uint64_t da,
                                                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_bf16_n128<true, true>(float (&d)[64], uint64_t da,
                                                                   uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// Eight bf16 values of a 16-byte word to fp32.
__device__ __forceinline__ void unpack8(uint4 w, float (&v)[8]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void load8f(const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The kinds of epilogue the wgmma kernel is compiled for, by the terms a
// launch has (`wg_epilogue_kind`): each instance carries only their loads,
// registers and arithmetic. (One generic epilogue spent most of its
// instructions on the addresses and predicates of absent terms, at the
// register cap: PERF.md §6.)
enum WgEpi {
    kEpiPlain = 0,   // bias and the row mask (every layout; tn has none)
    kEpiBf16 = 1,    // + the bf16 residuals post and post2, round_each
    kEpiAny = 2,     // + the fp32 residuals pre and post32
};

// The epilogue of one output value, gemm_bf16_kernel's terms in its order
// with its roundings (a term is added only where it is given).
template <int kEpi>
__device__ __forceinline__ float wg_bf16_term(float v, float bias, float pre, float mask,
                                              float post, float post32, float post2,
                                              const EpilogueBf16& ep) {
    if (ep.bias) v += bias;
    if (kEpi >= kEpiAny && ep.pre) v += pre;
    v *= mask;
    if (kEpi >= kEpiBf16 && ep.round_each) v = to_f(__float2bfloat16(v));
    if (kEpi >= kEpiBf16 && ep.post) v += post;
    if (kEpi >= kEpiBf16 && ep.round_each) v = to_f(__float2bfloat16(v));
    if (kEpi >= kEpiAny && ep.post32) v += post32;
    if (kEpi >= kEpiBf16 && ep.post2) v += post2;
    return v;
}

// r / div, by a shift where div is a power of two (shift >= 0).
__device__ __forceinline__ int row_div(int r, int div, int shift) {
    return shift >= 0 ? r >> shift : r / div;
}
__device__ __forceinline__ int div_shift(int div) {
    return div > 0 && (div & (div - 1)) == 0 ? __ffs(div) - 1 : -1;
}

// kAT: A stored (K, M) (gemm_tn); kBN: W stored (K, N) (gemm_nn, gemm_tn);
// else (M, K) and (N, K). kEpi: the WgEpi the launch's epilogue needs.
template <bool kAT, bool kBN, int kEpi>
__global__ void __launch_bounds__(kWgBfThreads, 1)
    gemm_bf16_wg_kernel(const __grid_constant__ GemmBf16WgParams p) {
    using S = WgBf<kAT>;
    extern __shared__ unsigned char gemm_wg_smem_raw[];
    unsigned char* const ring = reinterpret_cast<unsigned char*>(   // 1024-aligned boxes
        (reinterpret_cast<uintptr_t>(gemm_wg_smem_raw) + 1023) & ~(uintptr_t)1023);
    float* const staged = reinterpret_cast<float*>(ring + S::kStages * S::kStageBytes);
    bf16* const out16s = reinterpret_cast<bf16*>(staged + 2 * 64 * kWgBfTile);
    uint64_t* const full = reinterpret_cast<uint64_t*>(out16s + 2 * 64 * kWgBfTile);
    uint64_t* const empty = full + S::kStages;

    if (threadIdx.x == 0) {
        for (int s = 0; s < S::kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], S::kArrivals);   // one arrival a consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // Tile t: column tile fastest, then the problem (nt / nn) or the row
    // tile (tn), then the row tile (nt / nn) or the split (tn).
    auto decode = [&](int t, int& g, int& z, int& m0, int& n0) {
        n0 = (t % p.tiles_n) * kWgBfTile;
        t /= p.tiles_n;
        if (kAT) {
            g = 0;
            m0 = (t % p.tiles_m) * S::kRows;
            z = t / p.tiles_m;
        } else {
            g = t % p.groups;
            m0 = (t / p.groups) * S::kRows;
            z = 0;
        }
    };
    auto slices = [&](int z) {
        const int kbeg = z * p.kchunk;
        const int kend = min(p.K, kbeg + p.kchunk);
        return (kend - kbeg + S::kBK - 1) / S::kBK;
    };

    if (threadIdx.x < 128) {   // the producer warpgroup: one thread issues
        if (threadIdx.x != 0) return;
        int it = 0;
        for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
            int g, z, m0, n0;
            decode(t, g, z, m0, n0);
            const int nk = slices(z);
            // tn: the split's own view, at split index zc of it.
            const bool last = kAT && z == p.splits - 1;
            const CUtensorMap* mapA = kAT ? &p.map[last ? 2 : 0] : &p.map[0];
            const CUtensorMap* mapB = kAT ? &p.map[last ? 3 : 1] : &p.map[1 + g];
            const int zc = kAT && !last ? z : 0;
            for (int s = 0; s < nk; ++s, ++it) {
                const int st = it % S::kStages, use = it / S::kStages;
                if (use > 0) mbar_wait_sleep(&empty[st], (use - 1) & 1);
                unsigned char* a = ring + st * S::kStageBytes;
                unsigned char* b = a + S::kABytes;
                mbar_expect(&full[st], S::kStageBytes);
                const int k0 = s * S::kBK;
                if (kAT) {
                    tma_box3(a, mapA, m0, k0, zc, &full[st]);
                    tma_box3(a + S::kBoxBytes, mapA, m0 + 64, k0, zc, &full[st]);
                } else {
                    tma_box3(a, mapA, k0, m0, 0, &full[st]);
                }
                if (kBN) {
                    tma_box3(b, mapB, n0, k0, zc, &full[st]);
                    tma_box3(b + S::kBoxBytes, mapB, n0 + 64, k0, zc, &full[st]);
                } else {
                    tma_box3(b, mapB, k0, n0, 0, &full[st]);
                }
            }
        }
        return;
    }

    // The consumers. tn: warpgroup wg owns rows 64 wg .. 64 wg + 63 of every
    // tile; nt / nn: warpgroup wg owns the block's tiles i with i % 2 == wg.
    const int wg = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, tq = lane % 4;
    float* const tile = staged + wg * 64 * kWgBfTile;   // 32 KB, 1024-aligned
    bf16* const out16 = out16s + wg * 64 * kWgBfTile;   // 16 KB, 1024-aligned
    // Byte offsets of this warpgroup's A rows and of a k16 step.
    constexpr uint32_t kLboA = kAT ? S::kBoxBytes : 16, kLboB = kBN ? S::kBoxBytes : 16;
    constexpr int kStepA = kAT ? 16 * 128 : 32, kStepB = kBN ? 16 * 128 : 32;
    const int offA = kAT ? wg * S::kBoxBytes : 0;
    const float* const ascale = p.ascale;
    const int adiv = p.adiv;
    int it = 0;   // the ring's slice count, as the producer's
    int i = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++i) {
        int g, z, m0, n0;
        decode(t, g, z, m0, n0);
        const int nk = slices(z);
        if (!kAT && (i & 1) != wg) {   // the other warpgroup's tile
            it += nk;
            continue;
        }
        // nt / nn: the mainloops run in tile order, one warpgroup after the
        // other (each waits for the other's mainloop of the previous tile),
        // so that no warpgroup waits on a stage two fills ahead of the ring
        // (whose parity would read as the fill before); the epilogues overlap.
        if (!kAT && i > 0) wg_bar256(3 + wg);
        const int r0 = m0 + (kAT ? 64 * wg : 0);   // this warpgroup's first row
        const int kbeg = z * p.kchunk;
        const int kend = min(p.K, kbeg + p.kchunk);
        const bool colsum = kAT && p.colsum && n0 == 0;
        // colsum: column r0 + tid of the scaled A (tid < 64), rows k = j mod 8
        // of every slice in cs[j], added in order of k; cs[0..7] are summed
        // in a fixed tree at the tile's end.
        float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        float acc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[e] = 0.f;
        for (int s = 0; s < nk; ++s, ++it) {
            const int st = it % S::kStages;
            // tn: the row scales of this thread's units of the slice, read
            // before the wait for the slice.
            constexpr int kUnits = kAT ? S::kBK * 8 / 128 : 1;
            float sc[kUnits];
            if (kAT && ascale) {
#pragma unroll
                for (int j = 0; j < kUnits; ++j) {
                    const int row = kbeg + s * S::kBK + (tid + 128 * j) / 8;
                    sc[j] = row < kend ? ascale[row / adiv] : 0.f;
                }
            }
            mbar_wait_sleep(&full[st], (it / S::kStages) & 1);
            unsigned char* a = ring + st * S::kStageBytes + offA;
            const unsigned char* b = ring + st * S::kStageBytes + S::kABytes;
            if (kAT && ascale) {
                // The row scale of the landed slice, in place: k rows of 128
                // bytes (the swizzle permutes 16-byte units within a row, so
                // a unit's 8 values share their row k), rounded to bf16.
#pragma unroll
                for (int j = 0; j < kUnits; ++j) {
                    uint4* u = reinterpret_cast<uint4*>(a) + tid + 128 * j;
                    float v[8];
                    unpack8(*u, v);
#pragma unroll
                    for (int e = 0; e < 8; ++e) v[e] *= sc[j];
                    *u = pack8(v);
                }
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
                wg_bar(1 + wg);
            }
            fence_regs(acc);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int kk = 0; kk < S::kBK / 16; ++kk)
                wgmma_bf16_n128<kAT, kBN>(acc, wg_bf16_desc(a + kk * kStepA, kLboA),
                                          wg_bf16_desc(b + kk * kStepB, kLboB), 1);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            if (colsum && tid < 64) {
                // Column tid of this warpgroup's 64: unit (tid / 8) ^ (k % 8)
                // of row k holds it (128-byte swizzle).
#pragma unroll 4
                for (int k0 = 0; k0 < S::kBK; k0 += 8)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        cs[j] += __bfloat162float(*reinterpret_cast<const bf16*>(
                            a + (k0 + j) * 128 + (((tid >> 3) ^ j) << 4) + (tid & 7) * 2));
            }
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            fence_regs(acc);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[st]);
        }
        if (!kAT && t + (int)gridDim.x < p.tiles) wg_arrive256(4 - wg);   // the next tile's turn
        if (colsum && tid < 64 && r0 + tid < p.M)
            p.colsum[(size_t)z * p.M + r0 + tid] =
                ((cs[0] + cs[1]) + (cs[2] + cs[3])) + ((cs[4] + cs[5]) + (cs[6] + cs[7]));

        // The staged tile and the bf16 output tile are read by the previous
        // tile's TMA stores until those have read them.
        if (tid == 0) tma_store_wait_read<0>();
        wg_bar(1 + wg);
        // The running sums (wgmma's m64n128 layout: rows 16 warp + gq and + 8,
        // columns 8 j + 2 tq and + 1) into the staged tile: four boxes of 32
        // columns x 64 rows of 128 bytes, 16-byte units XOR-swizzled by the
        // row (`wg_staged_off`), the layout of a 128-byte-swizzled TMA box.
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int row = 16 * warp + gq + 8 * h, col = 8 * j + 2 * tq;
                *reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(tile) +
                                           wg_staged_off(row, col) + (col & 2) * 4) =
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            }
        wg_bar(1 + wg);

        // Rows rq + 8 q of the warpgroup's 64, columns cc .. cc + 7, with the
        // problem's epilogue and the shape in registers.
        const EpilogueBf16 ep = p.ep[g];
        const int M = p.M, N = p.N, ldc = p.ldc;
        const bool out_f32 = p.out_f32;
        const int cc = (tid % 16) * 8, rq = tid / 16;
        const int c = n0 + cc;
        unsigned char* const st8 = reinterpret_cast<unsigned char*>(tile);
        const int msh = div_shift(ep.mask_div), p2sh = div_shift(ep.post2_div);
        if (p.vec_out) {   // N % 8 == 0: a thread's 8 columns are all in or all out
            float bias[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            if (ep.bias && c < N) load8f(ep.bias + c, bias);
            // Every residual of kB rows is loaded before any is used.
            constexpr int kB = kEpi == kEpiAny ? 4 : 8;
            constexpr int kB16 = kEpi >= kEpiBf16 ? kB : 1, kB32 = kEpi >= kEpiAny ? kB : 1;
#pragma unroll
            for (int q0 = 0; q0 < 8; q0 += kB) {
                float pre[kB32][8] = {}, p32[kB32][8] = {}, mk[kB];
                uint4 post[kB16], post2[kB16];
#pragma unroll
                for (int q = 0; q < kB; ++q) {
                    const int r = r0 + rq + 8 * (q0 + q);
                    const bool ok = r < M && c < N;
                    mk[q] = ok && ep.rmask ? ep.rmask[row_div(r, ep.mask_div, msh)] : 1.f;
                    if constexpr (kEpi >= kEpiBf16) {
                        post[q] = post2[q] = make_uint4(0u, 0u, 0u, 0u);
                        if (ok && ep.post)
                            post[q] = *reinterpret_cast<const uint4*>(
                                ep.post + (size_t)r * ep.ldpost + c);
                        if (ok && ep.post2)
                            post2[q] = *reinterpret_cast<const uint4*>(
                                ep.post2 + (size_t)row_div(r, ep.post2_div, p2sh) * ep.ldpost2 +
                                c);
                    }
                    if constexpr (kEpi >= kEpiAny) {
                        if (ok && ep.pre) load8f(ep.pre + (size_t)r * ep.ldpre + c, pre[q]);
                        if (ok && ep.post32)
                            load8f(ep.post32 + (size_t)r * ep.ldpost32 + c, p32[q]);
                    }
                }
#pragma unroll
                for (int q = 0; q < kB; ++q) {
                    const int rr = rq + 8 * (q0 + q);
                    float4* at0 = reinterpret_cast<float4*>(st8 + wg_staged_off(rr, cc));
                    float4* at1 = reinterpret_cast<float4*>(st8 + wg_staged_off(rr, cc + 4));
                    const float4 a0 = *at0, a1 = *at1;
                    float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                    float po[8] = {}, p2[8] = {};
                    if constexpr (kEpi >= kEpiBf16) {
                        unpack8(post[q], po);
                        unpack8(post2[q], p2);
                    }
#pragma unroll
                    for (int e = 0; e < 8; ++e)
                        v[e] = wg_bf16_term<kEpi>(v[e], bias[e], pre[q % kB32][e], mk[q], po[e],
                                                  p32[q % kB32][e], p2[e], ep);
                    // The output tile for the TMA store: fp32 in place of the
                    // staged sums, bf16 into its own swizzled tile.
                    if (out_f32) {
                        *at0 = make_float4(v[0], v[1], v[2], v[3]);
                        *at1 = make_float4(v[4], v[5], v[6], v[7]);
                    } else {
                        *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(out16) +
                                                  wg_out16_off(rr, cc)) = pack8(v);
                    }
                }
            }
            // Each writer fences its generic-proxy writes for the TMA unit's
            // reads; then one thread stores the warpgroup's 64 rows.
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            wg_bar(1 + wg);
            if (tid == 0) {
                const CUtensorMap* mapC = &p.map[kAT ? 4 : 4 + g];
                if (out_f32) {
#pragma unroll
                    for (int b4 = 0; b4 < 4; ++b4)
                        tma_store3(mapC, st8 + b4 * 8192, n0 + 32 * b4, r0, z);
                } else {
#pragma unroll
                    for (int b2 = 0; b2 < 2; ++b2)
                        tma_store3(mapC, reinterpret_cast<unsigned char*>(out16) + b2 * 8192,
                                   n0 + 64 * b2, r0, z);
                }
                tma_store_commit();
            }
        } else {
            const size_t zoff = (size_t)z * M * ldc;
            for (int q = 0; q < 8; ++q) {
                const int rr = rq + 8 * q, r = r0 + rr;
                if (r >= M) continue;
                const float mk = ep.rmask ? ep.rmask[r / ep.mask_div] : 1.f;
                for (int e = 0; e < 8; ++e) {
                    const int ce = c + e;
                    if (ce >= N) continue;
                    const float v = wg_bf16_term<kEpiAny>(
                        *reinterpret_cast<const float*>(st8 + wg_staged_off(rr, cc + e) +
                                                        (e & 3) * 4),
                        ep.bias ? ep.bias[ce] : 0.f,
                        ep.pre ? ep.pre[(size_t)r * ep.ldpre + ce] : 0.f, mk,
                        ep.post ? to_f(ep.post[(size_t)r * ep.ldpost + ce]) : 0.f,
                        ep.post32 ? ep.post32[(size_t)r * ep.ldpost32 + ce] : 0.f,
                        ep.post2 ? to_f(ep.post2[(size_t)(r / ep.post2_div) * ep.ldpost2 + ce])
                                 : 0.f,
                        ep);
                    const size_t o = zoff + (size_t)r * ldc + ce;
                    if (out_f32)
                        static_cast<float*>(p.C[g])[o] = v;
                    else
                        static_cast<bf16*>(p.C[g])[o] = __float2bfloat16(v);
                }
            }
        }
    }
    if (tid == 0) tma_store_wait<0>();   // the shared memory outlives the stores
}

// Whether this library has raised the wgmma kernel's shared-memory limit on
// a device, by [device][layout][WgEpi] (internal linkage, as
// g_gemm_smem_raised).
static bool g_gemm_bf16_wg_smem_raised[8][3][3];

// The WgEpi of a launch's epilogues.
inline int wg_epilogue_kind(const EpilogueBf16* ep, int groups) {
    int kind = kEpiPlain;
    for (int g = 0; g < groups; ++g) {
        if (ep[g].pre || ep[g].post32) return kEpiAny;
        if (ep[g].post || ep[g].post2 || ep[g].round_each) kind = kEpiBf16;
    }
    return kind;
}

// Whether TMA can read both operands of a launch: 16-byte-aligned bases and
// row strides that are multiples of 8 bf16 (16 bytes).
inline bool gemm_bf16_tma_ok(const GemmBf16Params& p, int groups) {
    bool ok = aligned16(p.A) && p.lda % 8 == 0 && p.ldw % 8 == 0;
    for (int g = 0; g < groups; ++g) ok = ok && aligned16(p.W[g]);
    return ok;
}

// The bf16 path of a product, by layout (0 nt, 1 nn, 2 tn) and whether TMA
// can read its operands: the wgmma kernel, or the mma.sync one
// (ops/gemm_cuda.py::path_for mirrors it). No shape keeps the mma.sync
// kernel: with every product on the wgmma kernel the bf16 serving
// forward's device time fell at B=16 as at B=512 (PERF.md §5).
inline int gemm_path_for_bf16(int layout, bool tma_ok) {
    if (layout < 0 || layout > 2) return -1;
    return tma_ok ? kPathBf16Wg : kPathBf16;
}

// The wgmma kernel's output tiles of a layout (0 nt, 1 nn, 2 tn), and its
// persistent grid: one block an SM, or one a tile where there are fewer.
inline long long gemm_bf16_wg_tiles(int layout, int M, int N, int groups, int splits) {
    const int rows = layout == 2 ? WgBf<true>::kRows : WgBf<false>::kRows;
    return (long long)((M + rows - 1) / rows) * ((N + kWgBfTile - 1) / kWgBfTile) * groups *
           splits;
}
inline int gemm_bf16_wg_blocks(long long tiles) {
    return (int)(tiles < kGemmSMs ? tiles : kGemmSMs);
}

// The 3-D tensor map of a bf16 operand: `cols` contiguous, `rows` rows
// `ld` apart, `depth` blocks of them `rows * ld` apart; boxes of 64 columns
// by box_rows rows, 128-byte swizzle.
inline cudaError_t wg_operand_map(CUtensorMap* map, const bf16* base, long long cols,
                                  long long rows, long long depth, int ld, int box_rows) {
    const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)depth};
    const uint64_t strides[2] = {(uint64_t)ld * 2, (uint64_t)rows * ld * 2};
    const uint32_t box[3] = {64, (uint32_t)box_rows, 1};
    return bf16_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool kAT, bool kBN>
inline void gemm_bf16_wg_run(cudaStream_t st, const GemmBf16Params& q, int groups, int splits) {
    using S = WgBf<kAT>;
    constexpr int layout = kAT ? 2 : kBN ? 1 : 0;
    GemmBf16WgParams p{};
    p.M = q.M; p.N = q.N; p.K = q.K; p.kchunk = q.kchunk; p.splits = splits; p.groups = groups;
    p.tiles_n = (q.N + kWgBfTile - 1) / kWgBfTile;
    p.tiles_m = (q.M + S::kRows - 1) / S::kRows;
    p.tiles = (int)gemm_bf16_wg_tiles(layout, q.M, q.N, groups, splits);
    p.ldc = q.ldc; p.ascale = q.ascale; p.adiv = q.adiv; p.out_f32 = q.out_f32;
    p.colsum = q.colsum;
    // 16-byte epilogue rows: the output and every residual aligned, N and
    // every leading dimension a multiple of 8.
    auto vec = [](const void* ptr, int ld) { return !ptr || (aligned16(ptr) && ld % 8 == 0); };
    bool vec_out = q.N % 8 == 0;
    for (int g = 0; g < groups; ++g) {
        const EpilogueBf16& e = q.ep[g];
        p.C[g] = q.C[g];
        p.ep[g] = e;
        vec_out = vec_out && vec(q.C[g], q.ldc) && vec(e.bias, 0) && vec(e.pre, e.ldpre) &&
                  vec(e.post, e.ldpost) && vec(e.post32, e.ldpost32) && vec(e.post2, e.ldpost2);
    }
    p.vec_out = vec_out;
    cudaError_t err = cudaSuccess;
    if (kAT) {   // A (R, M), B (R, N): the splits before the last, then the last
        const long long done = (long long)(splits - 1) * q.kchunk;
        if (splits > 1) {
            err = wg_operand_map(&p.map[0], q.A, q.M, q.kchunk, splits - 1, q.lda, S::kBK);
            if (err == cudaSuccess)
                err = wg_operand_map(&p.map[1], q.W[0], q.N, q.kchunk, splits - 1, q.ldw,
                                     S::kBK);
        }
        if (err == cudaSuccess)
            err = wg_operand_map(&p.map[2], q.A + done * q.lda, q.M, q.K - done, 1, q.lda,
                                 S::kBK);
        if (err == cudaSuccess)
            err = wg_operand_map(&p.map[3], q.W[0] + done * q.ldw, q.N, q.K - done, 1, q.ldw,
                                 S::kBK);
    } else {
        err = wg_operand_map(&p.map[0], q.A, q.K, q.M, 1, q.lda, S::kRows);
        for (int g = 0; g < groups && err == cudaSuccess; ++g)
            err = kBN ? wg_operand_map(&p.map[1 + g], q.W[g], q.N, q.K, 1, q.ldw, S::kBK)
                      : wg_operand_map(&p.map[1 + g], q.W[g], q.K, q.N, 1, q.ldw, kWgBfTile);
    }
    // The outputs, stored by TMA from 128-byte-swizzled tiles of 64 rows by
    // 64 bf16 or 32 fp32 columns (tn: the splits' partial sums, 3-D).
    const int esize = q.out_f32 ? 4 : 2;
    for (int g = 0; g < (kAT ? 1 : groups) && err == cudaSuccess && vec_out; ++g) {
        const uint64_t dims[3] = {(uint64_t)q.N, (uint64_t)q.M, (uint64_t)splits};
        const uint64_t strides[2] = {(uint64_t)q.ldc * esize, (uint64_t)q.M * q.ldc * esize};
        const uint32_t box[3] = {q.out_f32 ? 32u : 64u, 64u, 1u};
        err = bf16_map(&p.map[4 + g], q.C[g], 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                       q.out_f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
    }
    // gemm_tn writes partial sums: no epilogue terms.
    const int kind = kAT ? kEpiPlain : wg_epilogue_kind(q.ep, groups);
    auto kernel = gemm_bf16_wg_kernel<kAT, kBN, kEpiPlain>;
    if constexpr (!kAT) {
        if (kind == kEpiBf16) kernel = gemm_bf16_wg_kernel<kAT, kBN, kEpiBf16>;
        if (kind == kEpiAny) kernel = gemm_bf16_wg_kernel<kAT, kBN, kEpiAny>;
    }
    const size_t smem = S::kSmem;
    if (err != cudaSuccess) {
        // A launch of no blocks, so that the caller's cudaGetLastError()
        // reports the refused tensor map.
        kernel<<<0, kWgBfThreads, smem, st>>>(p);
        return;
    }
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return;   // the caller's cudaGetLastError() reports it
    bool* raised = dev < 8 ? &g_gemm_bf16_wg_smem_raised[dev][layout][kind] : nullptr;
    if (!raised || !*raised) {
        if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem) != cudaSuccess)
            return;
        if (raised) *raised = true;
    }
    kernel<<<gemm_bf16_wg_blocks(p.tiles), kWgBfThreads, smem, st>>>(p);
}

// Launches one layout over `groups` problems and `splits` splits of K (the
// rows gemm_tn reduces) on the path the plan gives (`path` < 0) or on a
// forced one (kPathBf16 or kPathBf16Wg; the wgmma kernel refuses operands
// TMA cannot read); tile < 0 picks the mma.sync kernel's tile (gemm_tn:
// 128x128).
template <bool kAT, bool kBN>
inline void gemm_bf16_launch(cudaStream_t st, GemmBf16Params p, int groups, int splits, int tile,
                             int path = -1) {
    constexpr int layout = kAT ? 2 : kBN ? 1 : 0;
    const bool tma_ok = gemm_bf16_tma_ok(p, groups);
    if (path < 0) path = gemm_path_for_bf16(layout, tma_ok);
    if (path == kPathBf16Wg) {
        if (!tma_ok) {   // a launch of no blocks: cudaGetLastError() reports it
            gemm_bf16_wg_kernel<kAT, kBN, kEpiPlain><<<0, kWgBfThreads, 0, st>>>(
                GemmBf16WgParams{});
            return;
        }
        gemm_bf16_wg_run<kAT, kBN>(st, p, groups, splits);
        return;
    }
    if (kAT) tile = kTile128x128;
    if (tile < 0) tile = gemm_tile_for(p.M, p.N, groups);
    const dim3 grid((unsigned)gemm_tiles(tile, p.M, p.N), groups, splits);
    // 16-byte copies: the extent along which each operand is contiguous.
    bool vec = (kAT ? p.M : p.K) % 8 == 0 && (kBN ? p.N : p.K) % 8 == 0 && p.lda % 8 == 0 &&
               p.ldw % 8 == 0 && aligned16(p.A);
    for (int g = 0; g < groups; ++g) vec = vec && aligned16(p.W[g]);
    if constexpr (kAT) {
        gemm_bf16_run<128, 128, kAT, kBN>(st, grid, p, vec);
    } else {
        switch (tile) {
            case kTile128x128: gemm_bf16_run<128, 128, kAT, kBN>(st, grid, p, vec); break;
            case kTile128x64: gemm_bf16_run<128, 64, kAT, kBN>(st, grid, p, vec); break;
            default: gemm_bf16_run<64, 64, kAT, kBN>(st, grid, p, vec); break;
        }
    }
}

inline GemmBf16Params gemm_bf16_params(int M, int N, int K, const bf16* A, int lda, int ldw,
                                       int ldc, bool out_f32) {
    GemmBf16Params p{};
    p.M = M; p.N = N; p.K = K; p.kchunk = K;
    p.A = A; p.lda = lda; p.ldw = ldw; p.ldc = ldc; p.adiv = 1;
    p.out_f32 = out_f32;
    return p;
}

// C = epilogue(A @ W^T) on `stream`, A (M, K) and W (N, K) bf16; C bf16, or
// fp32 when out_f32. `tile` < 0: by shape (the mma.sync kernel's); `path`
// < 0: by the plan, else forced (the card tests).
inline void gemm_nt_bf16(cudaStream_t stream, int M, int N, int K, const bf16* A, int lda,
                         const bf16* W, int ldw, void* C, int ldc, bool out_f32,
                         const EpilogueBf16& ep, int tile = -1, int path = -1) {
    GemmBf16Params p = gemm_bf16_params(M, N, K, A, lda, ldw, ldc, out_f32);
    p.W[0] = W; p.C[0] = C; p.ep[0] = ep;
    gemm_bf16_launch<false, false>(stream, p, 1, 1, tile, path);
}

// Two products of one A in one launch (as gemm_nt2), bf16 outputs.
inline void gemm_nt2_bf16(cudaStream_t stream, int M, int N, int K, const bf16* A, int lda,
                          const bf16* W0, const bf16* W1, int ldw, bf16* C0, bf16* C1, int ldc,
                          const EpilogueBf16& ep0, const EpilogueBf16& ep1, int path = -1) {
    GemmBf16Params p = gemm_bf16_params(M, N, K, A, lda, ldw, ldc, false);
    p.W[0] = W0; p.W[1] = W1; p.C[0] = C0; p.C[1] = C1; p.ep[0] = ep0; p.ep[1] = ep1;
    gemm_bf16_launch<false, false>(stream, p, 2, 1, -1, path);
}

// C = epilogue(A @ W) on `stream`, A (M, K) and W (K, N) bf16; C bf16, or
// fp32 when out_f32. (A row mask of dY is the epilogue's rmask: with a 0 / 1
// mask (A * m) W and (A W) * m are the same numbers.)
inline void gemm_nn_bf16(cudaStream_t stream, int M, int N, int K, const bf16* A, int lda,
                         const bf16* W, int ldw, void* C, int ldc, bool out_f32,
                         const EpilogueBf16& ep, int tile = -1, int path = -1) {
    GemmBf16Params p = gemm_bf16_params(M, N, K, A, lda, ldw, ldc, out_f32);
    p.W[0] = W; p.C[0] = C; p.ep[0] = ep;
    gemm_bf16_launch<false, true>(stream, p, 1, 1, tile, path);
}

// Two products of one A in one launch, as gemm_nn2.
inline void gemm_nn2_bf16(cudaStream_t stream, int M, int N, int K, const bf16* A, int lda,
                          const bf16* W0, const bf16* W1, int ldw, void* C0, void* C1, int ldc,
                          bool out_f32, const EpilogueBf16& ep0, const EpilogueBf16& ep1,
                          int path = -1) {
    GemmBf16Params p = gemm_bf16_params(M, N, K, A, lda, ldw, ldc, out_f32);
    p.W[0] = W0; p.W[1] = W1; p.C[0] = C0; p.C[1] = C1; p.ep[0] = ep0; p.ep[1] = ep1;
    gemm_bf16_launch<false, true>(stream, p, 2, 1, -1, path);
}

// out (M, N) fp32 = (A * ascale[row / adiv])^T @ B, A (R, M), B (R, N) bf16,
// reduced over the R rows through `partial` (gemm_tn_partial_floats(M, N, R)
// floats: the split of the fp32 gemm_tn); bias_out (M,) (optional) = the
// column sums of the scaled A from the same pass.
inline void gemm_tn_bf16(cudaStream_t stream, int M, int N, int R, const bf16* A, int lda,
                         const float* ascale, int adiv, const bf16* B, int ldb, float* partial,
                         float* out, float* bias_out = nullptr, int path = -1, int split = 0,
                         float* out2 = nullptr, float* bias_out2 = nullptr) {
    const SplitK s = splitk_for(M, N, R);
    GemmBf16Params p = gemm_bf16_params(M, N, R, A, lda, ldb, N, true);
    p.kchunk = s.kchunk;
    p.ascale = ascale;
    p.adiv = adiv;
    p.W[0] = B;
    p.C[0] = partial;
    p.colsum = bias_out ? partial + (size_t)s.splits * M * N : nullptr;
    gemm_bf16_launch<true, true>(stream, p, 1, s.splits, kTile128x128, path);
    launch_reduce_partials(stream, s.splits, M, N, partial, out, p.colsum, bias_out, split, out2,
                           bias_out2);
}

// C = A @ W^T + bias in bf16 operands (a plain nn.Linear), C bf16 or fp32
// (TC).
template <typename TC>
inline void linear(cudaStream_t stream, int M, int N, int K, const bf16* A, const bf16* W,
                   const float* bias, TC* C) {
    EpilogueBf16 ep;
    ep.bias = bias;
    gemm_nt_bf16(stream, M, N, K, A, K, W, K, C, N, std::is_same<TC, float>::value, ep);
}

}  // namespace vml

// Each .cu file is its own shared library, so each defines this once.
extern "C" const char* vml_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
