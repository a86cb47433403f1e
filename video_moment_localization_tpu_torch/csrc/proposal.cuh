// Proposal-map geometry and pooling shared by the serving stack
// (smin_stack.cu) and the training proposal kernels (proposal_rows.cu).
//
// Two layouts of the moment map, rows n-major in both (row (b, n, c) of fc
// is ((b * P) + n) * C + c, P moments per element):
//   packed  P = N = L(L+1)/2 pairs in np.triu_indices(L) order, masked by
//           the pair validity vmask (B, N);
//   dense   P = L * L cells (i, j) in row-major order, masked by a given
//           moment_mask (B, L, L); a cell with i > j has no clip and is 0.
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

// Moment n of a layout -> its (i, j); i > j only for a dense cell below
// the diagonal.
template <bool Dense>
__device__ __forceinline__ void moment_of(int n, int L, int& i, int& j) {
    if (Dense) {
        i = n / L;
        j = n % L;
    } else {
        pair_of(n, L, i, j);
    }
}

// Index of moment (i, j), i <= j, in a layout.
template <bool Dense>
__device__ __forceinline__ int moment_index(int i, int j, int L) {
    return Dense ? i * L + j : pair_index(i, j, L);
}

// grid B * (P + L), one block per (element, moment) and per (element,
// snippet). Clip geometry of ops/content_matrix.py: moment (i, j) covers
// frames [i*T/L, (j+1)*T/L), split into min(C, frames) clips of
// max(1, frames / C); a clip is its frames' mean times the moment's mask
// value, and every element of fc and fm is written (zeros included).
template <bool Dense>
__global__ void pool_kernel(int T, int L, int C, int D, const float* __restrict__ f,
                            const float* __restrict__ mask, float* __restrict__ fc,
                            float* __restrict__ fm, float* __restrict__ fb) {
    const int P = Dense ? L * L : L * (L + 1) / 2;
    const int b = blockIdx.x / (P + L);
    const int row = blockIdx.x % (P + L);
    const int tl = T / L;
    const float* fe = f + (size_t)b * T * D;
    if (row >= P) {
        const int l = row - P;
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
            float s = 0.f;
            for (int t = 0; t < tl; ++t) s += fe[(size_t)(l * tl + t) * D + d];
            fb[((size_t)b * L + l) * D + d] = s / (float)tl;
        }
        return;
    }
    int i, j;
    moment_of<Dense>(row, L, i, j);
    const int frames = i <= j ? (j - i + 1) * tl : 0;
    const int clip = max(1, frames / C);
    const int valid = min(C, frames);
    const float w = 1.f / (float)clip;
    const float vm = mask[(size_t)b * P + row];
    const size_t pr = (size_t)b * P + row;
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
