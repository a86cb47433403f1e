// Tiled fp32 GEMM with a fused epilogue, shared by the biLSTM (lstm.cu), the
// SMI-stack (smin_stack.cu), the SMI train-layer (smin_train.cu) and the
// content-unit train (content_train.cu) kernels, plus the small device helpers
// they use.
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
//            partials in a fixed order: deterministic, no atomics.
// `ascale` (optional) scales each stored row of A (row / adiv): the row
// masks of the backward (dY * vmask) without a masked copy of dY.
// Every epilogue term is optional (null pointer). The order (mask, then the
// residuals) is that of the JAX units, e.g. cu = f_cc * mask + f_c + fbar
// and mu = (conv_fb + conv_fc) * mask + f_m. An output may alias `pre` or
// `post`: each element is read, then written, by the same thread.
//
// Bound on the H100: fp32 outside the tensor cores (67 TFLOP/s); at the
// serving shapes the operands mostly fit the 50 MB L2, so the kernel is
// bound by its FMA issue rate, shared-memory reads and load latency. Design:
// 64x64 output tiles, 16-deep K slices double-buffered in shared memory (A
// and B both stored k-major so the inner loop reads float4 rows), the next
// slice fetched into registers while the current one is multiplied, a 4x4
// register micro-tile per thread, guarded loads so M, N and K need not be
// tile multiples. No TF32 and no wgmma: the results are held to the JAX
// fp32 kernels, which run their matmuls at HIGHEST precision.
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

constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 16;
constexpr int kGemmThreads = 256;

// kAT: A is stored (K, M), element (m, k) at A[k * lda + m]; else (M, K).
// kBN: B is stored (K, N), element (k, n) at W[k * ldw + n]; else (N, K).
// kVec: every operand's contiguous extent and row stride are multiples of 4
// and its base is 16-byte aligned, so each thread fetches its share of a
// K-slice as one float4 per operand.
// Block z reduces k in [z * kchunk, min(K, (z + 1) * kchunk)) into
// C + z * M * ldc (kchunk a multiple of kGemmBK; one block when kchunk >= K).
template <bool kAT, bool kBN, bool kVec>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(int M, int N, int K, int kchunk, const float* __restrict__ A, int lda,
            const float* __restrict__ ascale, int adiv, const float* __restrict__ W,
            int ldw, float* C, int ldc, Epilogue ep) {
    __shared__ __align__(16) float As[2][kGemmBK][kGemmBM + 4];
    __shared__ __align__(16) float Ws[2][kGemmBK][kGemmBN + 4];

    const int tid = threadIdx.x;
    // Output tiles are numbered along x, column tiles fastest: B * N * C rows
    // can be more 64-row tiles than the 65,535 that gridDim.y admits.
    const int col_tiles = (N + kGemmBN - 1) / kGemmBN;
    const int m0 = (blockIdx.x / col_tiles) * kGemmBM;
    const int n0 = (blockIdx.x % col_tiles) * kGemmBN;
    const int kbeg = blockIdx.z * kchunk;
    const int kend = min(K, kbeg + kchunk);
    C += (size_t)blockIdx.z * M * ldc;
    const int tr = tid / 16;   // micro-tile rows tr*4 .. tr*4+3
    const int tc = tid % 16;   // micro-tile cols tc*4 .. tc*4+3
    // An operand contiguous in k: this thread fetches 4 consecutive k of one
    // tile row; contiguous in m / n: 4 consecutive rows at one k.
    const int lr = tid / 4;         // tile row (k-contiguous operand)
    const int lk = (tid % 4) * 4;   // first of its 4 k
    const int tk = tid / 16;        // k of the slice (m- / n-contiguous operand)
    const int tm = (tid % 16) * 4;  // first of its 4 tile rows
    float a_reg[4], w_reg[4];

    // One operand's 4 values of the K-slice starting at k0. `rows` is the
    // operand's extent along the tile (M or N), `r0` the tile's first row.
    auto load = [&](const float* __restrict__ P, int ld, bool kmajor, int rows, int r0,
                    int k0, float* reg) {
        if (!kmajor) {
            const int r = r0 + lr;
            const int gk = k0 + lk;
            if (kVec) {
                const float4 v = (r < rows && gk < kend)
                    ? *reinterpret_cast<const float4*>(P + (size_t)r * ld + gk)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
                reg[0] = v.x; reg[1] = v.y; reg[2] = v.z; reg[3] = v.w;
            } else {
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    reg[i] = (r < rows && gk + i < kend) ? P[(size_t)r * ld + gk + i] : 0.f;
            }
        } else {
            const int r = r0 + tm;
            const int gk = k0 + tk;
            if (kVec) {
                const float4 v = (r < rows && gk < kend)
                    ? *reinterpret_cast<const float4*>(P + (size_t)gk * ld + r)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
                reg[0] = v.x; reg[1] = v.y; reg[2] = v.z; reg[3] = v.w;
            } else {
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    reg[i] = (r + i < rows && gk < kend) ? P[(size_t)gk * ld + r + i] : 0.f;
            }
        }
    };
    // Global -> registers: the next K-slice, fetched while the current one
    // is multiplied out of shared memory.
    auto fetch = [&](int k0) {
        load(A, lda, kAT, M, m0, k0, a_reg);
        load(W, ldw, kBN, N, n0, k0, w_reg);
        if (ascale) {
            const int row = kAT ? k0 + tk : m0 + lr;   // the stored row of A
            const int lim = kAT ? kend : M;
            const float s = row < lim ? ascale[row / adiv] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) a_reg[i] *= s;
        }
    };
    auto stage = [&](int buf) {   // registers -> shared, k-major
        if (kAT) {
            *reinterpret_cast<float4*>(&As[buf][tk][tm]) =
                make_float4(a_reg[0], a_reg[1], a_reg[2], a_reg[3]);
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) As[buf][lk + i][lr] = a_reg[i];
        }
        if (kBN) {
            *reinterpret_cast<float4*>(&Ws[buf][tk][tm]) =
                make_float4(w_reg[0], w_reg[1], w_reg[2], w_reg[3]);
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) Ws[buf][lk + i][lr] = w_reg[i];
        }
    };

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    fetch(kbeg);
    stage(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = kbeg; k0 < kend; k0 += kGemmBK) {
        const bool more = k0 + kGemmBK < kend;
        if (more) fetch(k0 + kGemmBK);
#pragma unroll
        for (int kk = 0; kk < kGemmBK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&As[buf][kk][tr * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Ws[buf][kk][tc * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        // The other buffer was last read before the previous barrier.
        if (more) stage(buf ^ 1);
        __syncthreads();
        buf ^= 1;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = m0 + tr * 4 + i;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = n0 + tc * 4 + j;
            if (c >= N) continue;
            float v = acc[i][j];
            if (ep.bias) v += ep.bias[c];
            if (ep.pre) v += ep.pre[(size_t)r * ep.ldpre + c];
            if (ep.rmask) v *= ep.rmask[r / ep.mask_div];
            if (ep.post) v += ep.post[(size_t)r * ep.ldpost + c];
            if (ep.post2) v += ep.post2[(size_t)(r / ep.post2_div) * ep.ldpost2 + c];
            C[(size_t)r * ldc + c] = v;
        }
    }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launches one layout of gemm_kernel; `splits` blocks along z share the K
// range in chunks of `kchunk`.
template <bool kAT, bool kBN>
inline void gemm_launch(cudaStream_t stream, int M, int N, int K, int splits, int kchunk,
                        const float* A, int lda, const float* ascale, int adiv,
                        const float* W, int ldw, float* C, int ldc, const Epilogue& ep) {
    const dim3 grid(((N + kGemmBN - 1) / kGemmBN) * ((M + kGemmBM - 1) / kGemmBM), 1, splits);
    // The extent along which each operand is read 4 at a time.
    const bool vec = (kAT ? M : K) % 4 == 0 && (kBN ? N : K) % 4 == 0 && lda % 4 == 0 &&
                     ldw % 4 == 0 && aligned16(A) && aligned16(W);
    if (vec)
        gemm_kernel<kAT, kBN, true><<<grid, kGemmThreads, 0, stream>>>(
            M, N, K, kchunk, A, lda, ascale, adiv, W, ldw, C, ldc, ep);
    else
        gemm_kernel<kAT, kBN, false><<<grid, kGemmThreads, 0, stream>>>(
            M, N, K, kchunk, A, lda, ascale, adiv, W, ldw, C, ldc, ep);
}

// C = epilogue(A @ W^T) on `stream`; W (N, K).
inline void gemm_nt(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                    const float* W, int ldw, float* C, int ldc, const Epilogue& ep) {
    gemm_launch<false, false>(stream, M, N, K, 1, K, A, lda, nullptr, 1, W, ldw, C, ldc, ep);
}

// C = epilogue((A * ascale[row / adiv]) @ W) on `stream`; W (K, N).
inline void gemm_nn(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                    const float* ascale, int adiv, const float* W, int ldw, float* C,
                    int ldc, const Epilogue& ep) {
    gemm_launch<false, true>(stream, M, N, K, 1, K, A, lda, ascale, adiv, W, ldw, C, ldc, ep);
}

// out[e] = sum_z partial[z * count + e], z ascending.
__global__ void reduce_partials_kernel(int Z, size_t count, const float* __restrict__ partial,
                                       float* __restrict__ out) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
         e += (size_t)gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int z = 0; z < Z; ++z) s += partial[(size_t)z * count + e];
        out[e] = s;
    }
}

// How gemm_tn splits its R rows: enough blocks for two waves of the 132
// SMs, at least 64 rows each.
struct SplitK {
    int splits, kchunk;
};
inline SplitK splitk_for(int M, int N, int R) {
    const int tiles = ((M + kGemmBM - 1) / kGemmBM) * ((N + kGemmBN - 1) / kGemmBN);
    int z = (264 + tiles - 1) / tiles;
    const int zmax = (R + 63) / 64;
    if (z > zmax) z = zmax;
    if (z < 1) z = 1;
    int kchunk = (R + z - 1) / z;
    kchunk = (kchunk + kGemmBK - 1) / kGemmBK * kGemmBK;
    return {(R + kchunk - 1) / kchunk, kchunk};
}
// Floats of the partial-sum buffer gemm_tn needs.
inline size_t gemm_tn_partial_floats(int M, int N, int R) {
    return (size_t)splitk_for(M, N, R).splits * M * N;
}

// out (M, N) = (A * ascale[row / adiv])^T @ B, A (R, M), B (R, N), reduced
// over the R rows through `partial`.
inline void gemm_tn(cudaStream_t stream, int M, int N, int R, const float* A, int lda,
                    const float* ascale, int adiv, const float* B, int ldb, float* partial,
                    float* out) {
    const SplitK s = splitk_for(M, N, R);
    gemm_launch<true, true>(stream, M, N, R, s.splits, s.kchunk, A, lda, ascale, adiv, B,
                            ldb, partial, N, Epilogue());
    const size_t count = (size_t)M * N;
    reduce_partials_kernel<<<(int)((count + 255) / 256), 256, 0, stream>>>(s.splits, count,
                                                                          partial, out);
}

constexpr int kColsumSplits = 64;

// partial[z, c] = sum over the rows r of chunk z of Y[r, c] * scale[r / div].
__global__ void colsum_partial_kernel(int R, int N, int chunk, const float* __restrict__ Y,
                                      int ld, const float* __restrict__ scale, int div,
                                      float* __restrict__ partial) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= N) return;
    const int r0 = blockIdx.y * chunk;
    const int r1 = min(R, r0 + chunk);
    float s = 0.f;
    for (int r = r0; r < r1; ++r)
        s += Y[(size_t)r * ld + c] * (scale ? scale[r / div] : 1.f);
    partial[(size_t)blockIdx.y * N + c] = s;
}

// out (N,) = column sums of Y (R, N) * scale[row / div]: a bias gradient.
// `partial` holds kColsumSplits * N floats.
inline void colsum(cudaStream_t stream, int R, int N, const float* Y, int ld,
                   const float* scale, int div, float* partial, float* out) {
    const int chunk = (R + kColsumSplits - 1) / kColsumSplits;
    const int splits = (R + chunk - 1) / chunk;
    colsum_partial_kernel<<<dim3((N + 127) / 128, splits), 128, 0, stream>>>(
        R, N, chunk, Y, ld, scale, div, partial);
    reduce_partials_kernel<<<(N + 255) / 256, 256, 0, stream>>>(splits, (size_t)N, partial,
                                                                out);
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
