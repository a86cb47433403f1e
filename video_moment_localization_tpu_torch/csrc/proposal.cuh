// Proposal-map geometry and the pooling forward shared by the serving stack
// (smin_stack.cu) and the training proposal kernels (proposal_rows.cu).
//
// Two layouts of the moment map, rows n-major in both (row (b, n, c) of fc
// is ((b * P) + n) * C + c, P moments per element):
//   packed  P = N = L(L+1)/2 pairs in np.triu_indices(L) order, masked by
//           the pair validity, formed in the kernels from the length mask
//           (B, L);
//   dense   P = L * L cells (i, j) in row-major order, masked by a given
//           moment_mask (B, L, L); a cell with i > j has no clip and is 0.
//
// Clip geometry of ops/content_matrix.py, in closed form: moment (i, j)
// covers frames [i*T/L, (j+1)*T/L), split into min(C, frames) clips of
// max(1, frames / C); clip c is [i*T/L + c*clip, i*T/L + (c+1)*clip).
#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace vml {

// Both proposal kernels give a block one element and kPropCols columns, one
// per lane; the forward's blocks have kPoolWarps warps.
constexpr int kPropCols = 32;
constexpr int kPoolWarps = 8;

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

// Mask value of moment (i, j), i <= j, of element b: the given moment_mask
// (B, L, L) in the dense layout; in the packed layout the pair validity
// length_mask[i] * length_mask[j] of the length mask (B, L), the product
// ops/packing.py::packed_valid_mask forms.
template <bool Dense>
__device__ __forceinline__ float moment_mask(const float* __restrict__ mask, int b, int L, int i,
                                             int j) {
    return Dense ? mask[((size_t)b * L + i) * L + j]
                 : mask[(size_t)b * L + i] * mask[(size_t)b * L + j];
}

// (i, j) of moment n -> that of moment n + step in a layout's order; the
// caller makes sure that moment n + step exists.
template <bool Dense>
__device__ __forceinline__ void advance_moment(int step, int L, int& i, int& j) {
    j += step;
    if (Dense) {
        i += j / L;
        j %= L;
    } else {
        while (j >= L) {   // row i holds j = i .. L-1; row i+1 starts at i+1
            ++i;
            j += i - L;
        }
    }
}

// Static shared memory of the forward: the fp64 totals of each warp's run
// of frames in its scan over t.
constexpr size_t kRunTotalBytes = (size_t)kPoolWarps * kPropCols * sizeof(double);

// Dynamic shared memory of pool_kernel: the fp64 prefix sums of its tile.
__host__ __device__ inline size_t pool_smem_bytes(int T) {
    return (size_t)(T + 1) * kPropCols * sizeof(double);
}

// Forward. One block per (element, column tile, moment split): the block
// stages its T x 32 tile of f in shared memory once, as fp64 prefix sums
// P[t] = sum of frames < t (a two-level scan: each warp scans a run of frames,
// then adds the totals of the runs before it in a fixed order), and writes
// every fc and fm row of its moments, and for split 0 every fb row, as
// 128-byte row segments. A clip mean is (P[end] - P[start]) / size, the
// plain version's and the JAX XLA path's formula; in fp64 the difference
// loses nothing to the size of P, so each mean is the exact mean rounded
// once to fp32. A direct sum over the clip's frames would cost the block
// one shared-memory read per frame of every clip (11 per clip on average at
// the ActivityNet map, against 2 here). Every element of fc and fm is written, zeros
// included (a clip that does not exist, a dense cell below the diagonal).
//
// What bounds it: bytes. Each element of f is read once and each output
// written once; the splits (only where element x tile blocks are too few
// to fill the card) each read the f tile again, which is small beside the
// rows they write.
// TI / TO: the element types of f and of fc, fm, fb (float, or bf16 for
// K4's bf16 variant: the prefix sums and means stay fp64 / fp32, each output
// is rounded to bf16 once).
template <bool Dense, typename TI = float, typename TO = float>
__global__ void __launch_bounds__(kPoolWarps * 32)
pool_kernel(int T, int L, int C, int D, int splits, const TI* __restrict__ f,
            const float* __restrict__ mask, TO* __restrict__ fc, TO* __restrict__ fm,
            TO* __restrict__ fb) {
    extern __shared__ double prefix[];            // [T + 1][kPropCols]
    __shared__ double run_total[kPoolWarps][kPropCols];   // kRunTotalBytes
    const int P = Dense ? L * L : L * (L + 1) / 2;
    const int tiles = (D + kPropCols - 1) / kPropCols;
    const int tile = blockIdx.x % tiles;
    const int split = (blockIdx.x / tiles) % splits;
    const int b = blockIdx.x / (tiles * splits);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int d = tile * kPropCols + lane;
    const bool live = d < D;
    const int tl = T / L;
    const TI* fe = f + (size_t)b * T * D;

    // Stage the tile, every load independent of the others.
#pragma unroll 4
    for (int t = warp; t < T; t += kPoolWarps)
        prefix[(t + 1) * kPropCols + lane] = live ? (double)to_f(fe[(size_t)t * D + d]) : 0.0;
    if (warp == 0) prefix[lane] = 0.0;
    __syncthreads();
    const int run = (T + kPoolWarps - 1) / kPoolWarps;
    const int t0 = min(T, warp * run), t1 = min(T, t0 + run);
    double acc = 0.0;
    for (int t = t0; t < t1; ++t) {
        acc += prefix[(t + 1) * kPropCols + lane];
        prefix[(t + 1) * kPropCols + lane] = acc;
    }
    run_total[warp][lane] = acc;
    __syncthreads();
    double off = 0.0;
    for (int w = 0; w < warp; ++w) off += run_total[w][lane];
    for (int t = t0; t < t1; ++t) prefix[(t + 1) * kPropCols + lane] += off;
    __syncthreads();

    if (split == 0) {
        for (int l = warp; l < L; l += kPoolWarps) {
            const double s = prefix[(l + 1) * tl * kPropCols + lane] -
                             prefix[l * tl * kPropCols + lane];
            if (live) fb[((size_t)b * L + l) * D + d] = from_f<TO>((float)(s / (double)tl));
        }
    }

    const int n_begin = (int)((long long)P * split / splits);
    const int n_end = (int)((long long)P * (split + 1) / splits);
    int n = n_begin + warp;
    int i = 0, j = 0;
    if (n < n_end) moment_of<Dense>(n, L, i, j);
    for (; n < n_end; n += kPoolWarps) {
        const size_t pr = (size_t)b * P + n;
        float msum = 0.f;
        if (i <= j) {
            const float vm = moment_mask<Dense>(mask, b, L, i, j);
            const int frames = (j - i + 1) * tl;
            const int clip = max(1, frames / C);
            const int valid = min(C, frames);
            const double w = 1.0 / (double)clip;
            int s = i * tl;
            for (int c = 0; c < C; ++c, s += clip) {
                float v = 0.f;
                if (c < valid)
                    v = (float)((prefix[(s + clip) * kPropCols + lane] -
                                 prefix[s * kPropCols + lane]) * w) * vm;
                if (live) fc[(pr * C + c) * D + d] = from_f<TO>(v);
                msum += v;
            }
        } else if (live) {
            for (int c = 0; c < C; ++c) fc[(pr * C + c) * D + d] = from_f<TO>(0.f);
        }
        if (live) fm[pr * D + d] = from_f<TO>(msum / (float)C);
        if (n + kPoolWarps < n_end) advance_moment<Dense>(kPoolWarps, L, i, j);
    }
}

// Allows a kernel the dynamic shared memory it is launched with (a launch
// above 48 KB needs it) and reads the device's SM count.
inline cudaError_t prepare_launch(const void* kernel, size_t smem, int* sms) {
    int dev = 0;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    return err;
}

// Launches pool_kernel on B elements; returns the first CUDA error. Splits
// the moments over up to 8 blocks per (element, tile) where fewer than four
// blocks per SM would run otherwise (serving at B=16).
template <bool Dense, typename TI = float, typename TO = float>
cudaError_t pool_forward(cudaStream_t st, int B, int T, int L, int C, int D, const TI* f,
                         const float* mask, TO* fc, TO* fm, TO* fb) {
    int sms = 0;
    cudaError_t err = prepare_launch((const void*)pool_kernel<Dense, TI, TO>, pool_smem_bytes(T),
                                     &sms);
    if (err != cudaSuccess) return err;
    const int P = Dense ? L * L : L * (L + 1) / 2;
    const long long blocks = (long long)B * ((D + kPropCols - 1) / kPropCols);
    long long splits = (4LL * sms + blocks - 1) / blocks;
    splits = splits < 1 ? 1 : (splits > 8 ? 8 : splits);
    splits = splits > P ? P : splits;
    pool_kernel<Dense, TI, TO><<<(unsigned)(blocks * splits), kPoolWarps * 32, pool_smem_bytes(T),
                                 st>>>(
        T, L, C, D, (int)splits, f, mask, fc, fm, fb);
    return cudaGetLastError();
}

}  // namespace vml
