// Tiled fp32 GEMM with a fused epilogue, shared by the biLSTM (lstm.cu) and
// SMI-stack (smin_stack.cu) kernels, plus the small device helpers both use.
//
//   C[r, c] = (A[r, :] . W[c, :] + bias[c] + pre[r, c]) * rmask[r / mask_div]
//             + post[r, c] + post2[r / post2_div, c]
//
// A is (M, K) row-major with row stride lda, W is (N, K) row-major with row
// stride ldw: torch's nn.Linear / 1x1-conv weight layout, so no weight is
// transposed or copied. Every epilogue term is optional (null pointer). The
// order (mask, then the residuals) is that of the JAX units, e.g.
// cu = f_cc * mask + f_c + fbar and mu = (conv_fb + conv_fc) * mask + f_m.
// An output may alias `post`: each element is read, then written, by the
// same thread.
//
// Bound on the H100: fp32 outside the tensor cores (67 TFLOP/s); at the
// serving shapes the operands mostly fit the 50 MB L2, so the kernel is
// bound by its FMA issue rate, shared-memory reads and load latency. Design:
// 64x64 output tiles, 16-deep K slices double-buffered in shared memory (A
// and W both stored k-major so the inner loop reads float4 rows), the next
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

// kVec: K, lda and ldw are multiples of 4 and A, W are 16-byte aligned, so
// each thread fetches its slice of a K-slice as one float4 per operand.
template <bool kVec>
__global__ void __launch_bounds__(kGemmThreads)
gemm_nt_kernel(int M, int N, int K, const float* __restrict__ A, int lda,
               const float* __restrict__ W, int ldw, float* C, int ldc,
               Epilogue ep) {
    __shared__ __align__(16) float As[2][kGemmBK][kGemmBM + 4];
    __shared__ __align__(16) float Ws[2][kGemmBK][kGemmBN + 4];

    const int tid = threadIdx.x;
    const int m0 = blockIdx.y * kGemmBM;
    const int n0 = blockIdx.x * kGemmBN;
    const int tr = tid / 16;   // micro-tile rows tr*4 .. tr*4+3
    const int tc = tid % 16;   // micro-tile cols tc*4 .. tc*4+3
    const int lr = tid / 4;         // row of the tile this thread fetches
    const int lk = (tid % 4) * 4;   // its 4 consecutive k of the slice
    float a_reg[4], w_reg[4];

    // Global -> registers: the next K-slice, fetched while the current one
    // is multiplied out of shared memory.
    auto fetch = [&](int k0) {
        const int gk = k0 + lk;
        const int ga = m0 + lr;
        const int gw = n0 + lr;
        if (kVec) {
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 a = (ga < M && gk < K)
                ? *reinterpret_cast<const float4*>(A + (size_t)ga * lda + gk) : z;
            const float4 w = (gw < N && gk < K)
                ? *reinterpret_cast<const float4*>(W + (size_t)gw * ldw + gk) : z;
            a_reg[0] = a.x; a_reg[1] = a.y; a_reg[2] = a.z; a_reg[3] = a.w;
            w_reg[0] = w.x; w_reg[1] = w.y; w_reg[2] = w.z; w_reg[3] = w.w;
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                a_reg[i] = (ga < M && gk + i < K) ? A[(size_t)ga * lda + gk + i] : 0.f;
                w_reg[i] = (gw < N && gk + i < K) ? W[(size_t)gw * ldw + gk + i] : 0.f;
            }
        }
    };
    auto stage = [&](int buf) {   // registers -> shared, k-major
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            As[buf][lk + i][lr] = a_reg[i];
            Ws[buf][lk + i][lr] = w_reg[i];
        }
    };

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    fetch(0);
    stage(0);
    __syncthreads();
    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += kGemmBK) {
        const bool more = k0 + kGemmBK < K;
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

// C = epilogue(A @ W^T) on `stream`.
inline void gemm_nt(cudaStream_t stream, int M, int N, int K, const float* A, int lda,
                    const float* W, int ldw, float* C, int ldc, const Epilogue& ep) {
    const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM);
    const bool vec = K % 4 == 0 && lda % 4 == 0 && ldw % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(W) % 16 == 0;
    if (vec)
        gemm_nt_kernel<true><<<grid, kGemmThreads, 0, stream>>>(M, N, K, A, lda, W, ldw, C, ldc, ep);
    else
        gemm_nt_kernel<false><<<grid, kGemmThreads, 0, stream>>>(M, N, K, A, lda, W, ldw, C, ldc, ep);
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
