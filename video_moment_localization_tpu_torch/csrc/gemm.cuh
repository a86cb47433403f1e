// Tiled fp32 GEMM with a fused epilogue, shared by the biLSTM (lstm.cu), the
// SMI-stack (smin_stack.cu), the SMI train-layer (smin_train.cu) and the
// content-unit train (content_train.cu) kernels, plus the small device helpers
// they use. gemm.cu exposes it alone for the card tests.
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
// Bound on the H100: fp32 outside the tensor cores (67 TFLOP/s); the K7
// shapes (up to 532,480 x 512 x 512) are far above the bytes line, so the
// kernel is bound by its FMA issue rate, and shared-memory reads and load
// latency are what keep it from that rate. Design:
//   * block tiles of 128x128 (256 threads, an 8x8 micro-tile per thread held
//     as 2x2 sub-tiles of 4x4 at a stride of 64, so the inner loop's float4
//     shared reads are conflict-free), or 128x64 / 64x64 where the output
//     has too few tiles to fill the 132 SMs twice (`gemm_tile_for`);
//   * 16-deep K slices in a 5-stage ring of 16-byte `cp.async` copies, so
//     three slices load while one is transposed and one multiplied, and no
//     load stages through registers; two blocks fit an SM (<= 128
//     registers, <= 112 KB of dynamic shared memory), so one block's
//     prologue and epilogue overlap the other's products;
//   * the inner loop reads both operands k-major (a float4 of 4 rows at one
//     k), conflict-free: an operand contiguous along its rows lands k-major
//     as it lies; one contiguous along k lands row-major (16-byte units,
//     XOR-swizzled, `raw_off`) and is transposed in shared memory into one of
//     two k-major buffers one slice ahead of its use, with `ascale` applied
//     on the way;
//   * a float4 epilogue where the output and its residuals are aligned;
//   * a scalar path (synchronous guarded loads into the same layout) for
//     operands that are not 16-byte aligned or whose extents are not
//     multiples of 4; guarded edges, so M, N and K need not be tile
//     multiples.
// No TF32 and no wgmma: the results are held to the JAX fp32 kernels, which
// run their matmuls at HIGHEST precision.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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
// lies; else at P[r * ld + k], stored row-major (`raw_off`). Each thread
// copies R * kGemmBK / 4 / 256 chunks of 4 floats.
template <int R, bool kRowContig, bool kVec>
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
            dst = s + k * R + r;
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
        const float mk = ep.rmask ? ep.rmask[r / ep.mask_div] : 1.f;
#pragma unroll
        for (int y = 0; y < NI / 4; ++y) {
            const int c = n0 + y * 64 + tc * 4;
            if (c >= p.N) continue;
            float v[4] = {acc[i][y * 4], acc[i][y * 4 + 1], acc[i][y * 4 + 2], acc[i][y * 4 + 3]};
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
                *reinterpret_cast<float4*>(C + (size_t)r * p.ldc + c) =
                    make_float4(v[0], v[1], v[2], v[3]);
            } else {
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
        }
    }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether a (rows, ld) operand or epilogue term takes float4 accesses.
inline bool vec_ok(const void* p, int ld) { return !p || (aligned16(p) && ld % 4 == 0); }

// Whether this library has raised a kernel instance's shared-memory limit on
// a device, by [device][layout nt / nn / tn][tile][vec]. A namespace-scope
// static has internal linkage: each .cu (its own library) keeps its own, as
// it must, since each has its own copy of the kernels. (A function-local
// static in an inline function or template would be one object across the
// libraries of a process.)
static bool g_gemm_smem_raised[8][3][3][2];

template <int BM, int BN, bool kAT, bool kBN>
inline void gemm_run(cudaStream_t st, dim3 grid, const GemmParams& p, bool vec) {
    constexpr size_t smem = sizeof(float) * gemm_smem_floats<BM, BN, kAT, kBN>();
    constexpr int layout = kAT ? 2 : kBN ? 1 : 0;
    constexpr int tile = BM == 128 ? (BN == 128 ? kTile128x128 : kTile128x64) : kTile64x64;
    auto kernel = vec ? gemm_kernel<BM, BN, kAT, kBN, true> : gemm_kernel<BM, BN, kAT, kBN, false>;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return;   // the caller's cudaGetLastError() reports it
    bool* raised = dev < 8 ? &g_gemm_smem_raised[dev][layout][tile][vec] : nullptr;
    if (!raised || !*raised) {
        if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem) != cudaSuccess)
            return;
        if (raised) *raised = true;
    }
    kernel<<<grid, kGemmThreads, smem, st>>>(p);
}

// Launches one layout of gemm_kernel over `groups` problems (p.W / p.C /
// p.ep [0 .. groups)) and `splits` blocks along z; tile < 0 picks the tile.
// gemm_tn runs on 128x128 tiles only (its split-K fills the SMs).
template <bool kAT, bool kBN>
inline void gemm_launch(cudaStream_t st, GemmParams p, int groups, int splits, int tile) {
    if (kAT) tile = kTile128x128;
    if (tile < 0) tile = gemm_tile_for(p.M, p.N, groups);
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
        gemm_run<128, 128, kAT, kBN>(st, grid, p, vec);
    } else {
        switch (tile) {
            case kTile128x128: gemm_run<128, 128, kAT, kBN>(st, grid, p, vec); break;
            case kTile128x64: gemm_run<128, 64, kAT, kBN>(st, grid, p, vec); break;
            default: gemm_run<64, 64, kAT, kBN>(st, grid, p, vec); break;
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

// C = epilogue(A @ W^T) on `stream`; W (N, K). `tile` < 0: by shape.
inline void gemm_nt(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                    const float* W, int ldw, float* C, int ldc, const Epilogue& ep,
                    int tile = -1) {
    GemmParams p = gemm_params(M, N, K, A, lda, nullptr, 1, ldw, ldc);
    p.W[0] = W; p.C[0] = C; p.ep[0] = ep;
    gemm_launch<false, false>(stream, p, 1, 1, tile);
}

// Two products of one A in one launch: C0 = ep0(A @ W0^T), C1 = ep1(A @ W1^T).
inline void gemm_nt2(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                     const float* W0, const float* W1, int ldw, float* C0, float* C1, int ldc,
                     const Epilogue& ep0, const Epilogue& ep1) {
    GemmParams p = gemm_params(M, N, K, A, lda, nullptr, 1, ldw, ldc);
    p.W[0] = W0; p.W[1] = W1; p.C[0] = C0; p.C[1] = C1; p.ep[0] = ep0; p.ep[1] = ep1;
    gemm_launch<false, false>(stream, p, 2, 1, -1);
}

// C = epilogue((A * ascale[row / adiv]) @ W) on `stream`; W (K, N).
inline void gemm_nn(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                    const float* ascale, int adiv, const float* W, int ldw, float* C,
                    int ldc, const Epilogue& ep, int tile = -1) {
    GemmParams p = gemm_params(M, N, K, A, lda, ascale, adiv, ldw, ldc);
    p.W[0] = W; p.C[0] = C; p.ep[0] = ep;
    gemm_launch<false, true>(stream, p, 1, 1, tile);
}

// Two products of one scaled A in one launch, as gemm_nt2.
inline void gemm_nn2(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                     const float* ascale, int adiv, const float* W0, const float* W1, int ldw,
                     float* C0, float* C1, int ldc, const Epilogue& ep0, const Epilogue& ep1) {
    GemmParams p = gemm_params(M, N, K, A, lda, ascale, adiv, ldw, ldc);
    p.W[0] = W0; p.W[1] = W1; p.C[0] = C0; p.C[1] = C1; p.ep[0] = ep0; p.ep[1] = ep1;
    gemm_launch<false, true>(stream, p, 2, 1, -1);
}

// out[e] = sum_z partial[z * count + e] and bout[m] = sum_z bpartial[z * bcount
// + m], z ascending (bcount 0: no column sums).
__global__ void reduce_partials_kernel(int Z, size_t count, const float* __restrict__ partial,
                                       float* __restrict__ out, size_t bcount,
                                       const float* __restrict__ bpartial,
                                       float* __restrict__ bout) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count + bcount;
         e += (size_t)gridDim.x * blockDim.x) {
        const bool b = e >= count;
        const size_t i = b ? e - count : e;
        const size_t n = b ? bcount : count;
        const float* src = b ? bpartial : partial;
        float s = 0.f;
        for (int z = 0; z < Z; ++z) s += src[(size_t)z * n + i];
        (b ? bout : out)[i] = s;
    }
}

// How gemm_tn splits its R rows: as many 128x128 blocks as two blocks on
// each of the 132 SMs hold at once (one wave, no ragged tail), at least 64
// rows each.
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
// Floats of the partial-sum buffer gemm_tn needs: the split products and
// the split column sums.
inline size_t gemm_tn_partial_floats(int M, int N, int R) {
    return (size_t)splitk_for(M, N, R).splits * ((size_t)M * N + M);
}

// out (M, N) = (A * ascale[row / adiv])^T @ B, A (R, M), B (R, N), reduced
// over the R rows through `partial`; bias_out (M,) (optional) = the column
// sums of the scaled A, a bias gradient, from the same pass over A.
inline void gemm_tn(cudaStream_t stream, int M, int N, int R, const float* A, int lda,
                    const float* ascale, int adiv, const float* B, int ldb, float* partial,
                    float* out, float* bias_out = nullptr) {
    const SplitK s = splitk_for(M, N, R);
    GemmParams p = gemm_params(M, N, R, A, lda, ascale, adiv, ldb, N);
    p.kchunk = s.kchunk;
    p.W[0] = B;
    p.C[0] = partial;
    const size_t count = (size_t)M * N;
    p.colsum = bias_out ? partial + (size_t)s.splits * count : nullptr;
    gemm_launch<true, true>(stream, p, 1, s.splits, kTile128x128);
    const size_t bcount = bias_out ? (size_t)M : 0;
    const size_t total = count + bcount;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    reduce_partials_kernel<<<blocks, 256, 0, stream>>>(s.splits, count, partial, out, bcount,
                                                       p.colsum, bias_out);
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

}  // namespace vml

// Each .cu file is its own shared library, so each defines this once.
extern "C" const char* vml_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
