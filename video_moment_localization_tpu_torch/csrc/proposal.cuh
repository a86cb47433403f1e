// Proposal-map geometry and pooling shared by the serving stack
// (smin_stack.cu) and the training proposal kernels (proposal_rows.cu).
//
// Pairs are in np.triu_indices(L) order; rows are n-major: row (b, n, c) of
// fc is ((b * N) + n) * C + c.
#pragma once

#include <cuda_runtime.h>

namespace vml {

// Pair n of the np.triu_indices(L) order -> (i, j), i <= j.
__device__ __forceinline__ void pair_of(int n, int L, int& i, int& j) {
    int rem = n, row = 0;
    while (rem >= L - row) {
        rem -= L - row;
        ++row;
    }
    i = row;
    j = row + rem;
}

// Index of pair (i, j), i <= j, in the np.triu_indices(L) order.
__device__ __forceinline__ int pair_index(int i, int j, int L) {
    return i * L - i * (i - 1) / 2 + (j - i);
}

// grid B * (N + L), one block per (element, pair) and per (element, snippet).
// Clip geometry of ops/content_matrix.py: pair (i, j) covers frames
// [i*T/L, (j+1)*T/L), split into min(C, frames) clips of max(1, frames / C).
static __global__ void pool_kernel(int T, int L, int C, int D, const float* __restrict__ f,
                            const float* __restrict__ vmask, float* __restrict__ fc,
                            float* __restrict__ fm, float* __restrict__ fb) {
    const int N = L * (L + 1) / 2;
    const int b = blockIdx.x / (N + L);
    const int row = blockIdx.x % (N + L);
    const int tl = T / L;
    const float* fe = f + (size_t)b * T * D;
    if (row >= N) {
        const int l = row - N;
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
            float s = 0.f;
            for (int t = 0; t < tl; ++t) s += fe[(size_t)(l * tl + t) * D + d];
            fb[((size_t)b * L + l) * D + d] = s / (float)tl;
        }
        return;
    }
    int i, j;
    pair_of(row, L, i, j);
    const int frames = (j - i + 1) * tl;
    const int clip = max(1, frames / C);
    const int valid = min(C, frames);
    const float w = 1.f / (float)clip;
    const float vm = vmask[(size_t)b * N + row];
    const size_t pr = (size_t)b * N + row;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float msum = 0.f;
        for (int c = 0; c < C; ++c) {
            float v = 0.f;
            if (c < valid) {
                const int s = i * tl + c * clip;
                float acc = 0.f;
                for (int t = s; t < s + clip; ++t) acc += fe[(size_t)t * D + d];
                v = acc * w * vm;
            }
            fc[(pr * C + c) * D + d] = v;
            msum += v;
        }
        fm[pr * D + d] = msum / (float)C;
    }
}

}  // namespace vml
