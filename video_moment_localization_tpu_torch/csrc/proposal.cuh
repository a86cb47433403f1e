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
//
// Two pooling forwards: pool_kernel for fp32 (K1, K6, K8, K4), and
// pool_kernel_bf16 for bf16 (their bf16 variants), which gives a lane four
// columns so that every warp store is a 256-byte row segment.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"

namespace vml {

// The fp32 proposal kernels give a block one element and kPropCols columns,
// one per lane; the forward's blocks have kPoolWarps warps. The bf16
// backward gives a lane two adjacent columns (kPairCols a block), the bf16
// forward kPoolCPL.
constexpr int kPropCols = 32;
constexpr int kPoolWarps = 8;
constexpr int kPairCols = 64;

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
template <bool Dense>
__global__ void __launch_bounds__(kPoolWarps * 32)
pool_kernel(int T, int L, int C, int D, int splits, const float* __restrict__ f,
            const float* __restrict__ mask, float* __restrict__ fc, float* __restrict__ fm,
            float* __restrict__ fb) {
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
    const float* fe = f + (size_t)b * T * D;

    // Stage the tile, every load independent of the others.
#pragma unroll 4
    for (int t = warp; t < T; t += kPoolWarps)
        prefix[(t + 1) * kPropCols + lane] = live ? (double)fe[(size_t)t * D + d] : 0.0;
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
            if (live) fb[((size_t)b * L + l) * D + d] = (float)(s / (double)tl);
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
                if (live) fc[(pr * C + c) * D + d] = v;
                msum += v;
            }
        } else if (live) {
            for (int c = 0; c < C; ++c) fc[(pr * C + c) * D + d] = 0.f;
        }
        if (live) fm[pr * D + d] = msum / (float)C;
        if (n + kPoolWarps < n_end) advance_moment<Dense>(kPoolWarps, L, i, j);
    }
}

// ---------------------------------------------------------------------------
// The bf16 forward (K1-bf16, K6-bf16, K8-bf16, and K4-bf16's pooling).
//
// A lane owns kPoolCPL = 4 adjacent columns, so each warp store of fc, fm
// and fb is one 256-byte row segment (an 8-byte store a lane; one column a
// lane, as at fp32, would store 64-byte segments), and a block owns 128
// columns. The prefix sums of the block's tile are fp32 (the plain
// version's and the JAX XLA path's type), (T + 1) x 128 x 4 bytes (66 KB at
// T=128, three blocks an SM). A moment's C clips tile one run of frames, so
// the warp reads its C + 1 clip boundaries once each (a clip's end is the
// next one's start). The masks of a warp's next 32 moments load one batch
// ahead, a lane each, and reach the warp by shuffles, and the tile's rows
// load as raw words before any is converted (`load_raw2`): a load whose
// value is used right behind it stalls the warp on each load in turn.
// PERF.md §6 has the variants timed on the H100.
//
// Work: block (element, split, tile), the tiles of one element and split
// side by side, the P moments cut into `pool_splits` equal ranges. The
// arithmetic is pool_kernel's in fp32: a two-level scan over t, each clip
// mean (P[end] - P[start]) * (1 / size), times the mask, fm the fp32 sum of
// the C means over C, each output rounded once to bf16; every element of
// fc and fm is written, zeros included.
//
// The vector path (4- or 8-byte accesses) needs D % 8 == 0 and every
// pointer 16-byte aligned (`pair_vector`); anything else takes the scalar
// path of the same kernel, one 2-byte access a column.
constexpr int kPool16Warps = 8;
constexpr int kPoolCPL = 4;      // columns a lane
constexpr int kMaxPoolSplits = 8;
constexpr int kStageRows = 16;   // rows of f a warp loads together

// A lane's kPoolCPL columns of one prefix row (16 bytes: a warp's read of a
// row is one contiguous run of 512 bytes).
struct alignas(16) PoolCell {
    float v[kPoolCPL];
};

// Dynamic shared memory of pool_kernel_bf16: the prefix sums of its
// (T + 1) x 128 tile; and its static run totals.
__host__ __device__ inline size_t pool16_smem_bytes(int T) {
    return (size_t)(T + 1) * 32 * sizeof(PoolCell);
}
constexpr size_t kPool16StaticBytes = (size_t)kPool16Warps * 32 * sizeof(PoolCell);

// Whether the bf16 kernels take their vector path: D a multiple of 8 (every
// row starts 16-byte aligned) and every pointer 16-byte aligned.
inline bool pair_vector(int D, const void* const* ptrs, int n) {
    if (D % 8 != 0) return false;
    for (int k = 0; k < n; ++k)
        if (reinterpret_cast<uintptr_t>(ptrs[k]) % 16 != 0) return false;
    return true;
}

// Writes the two columns d, d + 1 of a bf16 row, each rounded once.
__device__ __forceinline__ void store_pair(bf16* p, float2 v, bool vec, bool live0, bool live1) {
    if (vec) {
        if (live0) *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
        return;
    }
    if (live0) p[0] = __float2bfloat16(v.x);
    if (live1) p[1] = __float2bfloat16(v.y);
}

// A raw load of two bf16 columns, converted only where used (`unpack2`): a
// conversion or select right behind its load would stall the warp on each
// load, one row at a time. The vector path loads unconditionally (a lane
// with no live column passes its tile's first column: it reads valid memory
// and its value is never stored); the scalar path reads the ``live`` columns
// that exist, 0 for the rest.
__device__ __forceinline__ uint32_t bits_of(bf16 x) {
    return (uint32_t)*reinterpret_cast<const unsigned short*>(&x);
}
__device__ __forceinline__ uint32_t load_raw2(const bf16* p, bool vec, int live) {
    if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
    return (live > 0 ? bits_of(p[0]) : 0u) | (live > 1 ? bits_of(p[1]) << 16 : 0u);
}
__device__ __forceinline__ float2 unpack2(uint32_t raw) {
    return make_float2(__uint_as_float(raw << 16), __uint_as_float(raw & 0xffff0000u));
}

// Writes a lane's CPL columns d .. d + CPL - 1 of a bf16 row (``live`` of
// them exist), each rounded once; the vector path as one access (a tile's
// lanes have all or none of their columns when D % 8 == 0).
template <int CPL>
__device__ __forceinline__ void store_cols(bf16* p, const float (&v)[CPL], bool vec, int live) {
    if constexpr (CPL == 4) {
        if (vec) {
            if (live <= 0) return;
            __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                                   __floats2bfloat162_rn(v[2], v[3])};
            *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < CPL; e += 2)
        store_pair(p + e, make_float2(v[e], v[e + 1]), vec, e < live, e + 1 < live);
}

// grid B * tiles * splits, blockDim kPool16Warps * 32, dynamic shared memory
// pool16_smem_bytes(T). ``vec``: pair_vector of D and the four bf16
// pointers. Block (b, split, tile), the tile fastest (the tiles of one
// element and split run side by side), the P moments cut into ``splits``
// equal ranges.
template <bool Dense>
__global__ void __launch_bounds__(kPool16Warps * 32)
pool_kernel_bf16(int T, int L, int C, int D, int splits, int vec,
                 const bf16* __restrict__ f, const float* __restrict__ mask,
                 bf16* __restrict__ fc, bf16* __restrict__ fm, bf16* __restrict__ fb) {
    using Cell = PoolCell;
    using Acc = float;
    constexpr int CPL = kPoolCPL;
    constexpr int W = kPool16Warps;
    constexpr int COLS = 32 * CPL;
    extern __shared__ __align__(16) unsigned char pool_raw[];
    Cell* prefix = reinterpret_cast<Cell*>(pool_raw);   // [T + 1][32]: a lane's CPL columns
    __shared__ Cell run_total[W][32];                   // kPool16StaticBytes
    const int P = Dense ? L * L : L * (L + 1) / 2;
    const int tiles = (D + COLS - 1) / COLS;
    const int split = (blockIdx.x / tiles) % splits;
    const int b = blockIdx.x / (tiles * splits), tile = blockIdx.x % tiles;
    const int n_begin = (int)((long long)P * split / splits);
    const int n_end = (int)((long long)P * (split + 1) / splits);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int tl = T / L;
    const int run = (T + W - 1) / W;
    const int r0 = min(T, warp * run), r1 = min(T, r0 + run);

    const int d = tile * COLS + CPL * lane;
    const int live = min(CPL, D - d);
    const bf16* fe = f + (size_t)b * T * D + (live > 0 ? d : tile * COLS);

    for (int tb = warp; tb < T; tb += kStageRows * W) {
        uint32_t raw[kStageRows][CPL / 2];
#pragma unroll
        for (int u = 0; u < kStageRows; ++u) {
            const bf16* row = fe + (size_t)min(tb + u * W, T - 1) * D;
#pragma unroll
            for (int h = 0; h < CPL / 2; ++h)
                raw[u][h] = load_raw2(row + 2 * h, vec, live - 2 * h);
        }
#pragma unroll
        for (int u = 0; u < kStageRows; ++u) {
            if (tb + u * W >= T) continue;
            Cell c;
#pragma unroll
            for (int h = 0; h < CPL / 2; ++h) {
                const float2 x = unpack2(raw[u][h]);
                c.v[2 * h] = (Acc)x.x;
                c.v[2 * h + 1] = (Acc)x.y;
            }
            prefix[(tb + u * W + 1) * 32 + lane] = c;
        }
    }
    if (warp == 0) {
        Cell z;
#pragma unroll
        for (int e = 0; e < CPL; ++e) z.v[e] = (Acc)0;
        prefix[lane] = z;
    }
    __syncthreads();
    Cell acc;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc.v[e] = (Acc)0;
    for (int t = r0; t < r1; ++t) {
        const Cell x = prefix[(t + 1) * 32 + lane];
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc.v[e] += x.v[e];
        prefix[(t + 1) * 32 + lane] = acc;
    }
    run_total[warp][lane] = acc;
    __syncthreads();
    Cell off;
#pragma unroll
    for (int e = 0; e < CPL; ++e) off.v[e] = (Acc)0;
    for (int w = 0; w < warp; ++w) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) off.v[e] += run_total[w][lane].v[e];
    }
    for (int t = r0; t < r1; ++t) {
        Cell x = prefix[(t + 1) * 32 + lane];
#pragma unroll
        for (int e = 0; e < CPL; ++e) x.v[e] += off.v[e];
        prefix[(t + 1) * 32 + lane] = x;
    }
    __syncthreads();

    if (n_begin == 0) {
        for (int l = warp; l < L; l += W) {
            const Cell e1 = prefix[(l + 1) * tl * 32 + lane];
            const Cell e0 = prefix[l * tl * 32 + lane];
            float v[CPL];
#pragma unroll
            for (int e = 0; e < CPL; ++e) v[e] = (float)((e1.v[e] - e0.v[e]) / (Acc)tl);
            store_cols<CPL>(fb + ((size_t)b * L + l) * D + d, v, vec, live);
        }
    }
    // A warp's moments n = n_begin + warp + k W, 32 at a time: lane l
    // loads the mask of the batch's l-th moment, one batch ahead, and
    // the warp reads them by shuffles (a load in flight behind the
    // rows' stores takes far longer than one moment's work).
    int base = n_begin + warp;
    int ni = 0, nj = 0;
    float nvm = 0.f;
    if (base + lane * W < n_end) {
        moment_of<Dense>(base + lane * W, L, ni, nj);
        if (ni <= nj) nvm = moment_mask<Dense>(mask, b, L, ni, nj);
    }
    for (; base < n_end; base += 32 * W) {
        const int bi = ni, bj = nj;
        const float bvm = nvm;
        const int next = base + 32 * W + lane * W;
        ni = nj = 0;
        nvm = 0.f;
        if (next < n_end) {
            moment_of<Dense>(next, L, ni, nj);
            if (ni <= nj) nvm = moment_mask<Dense>(mask, b, L, ni, nj);
        }
        const int count = min(32, (n_end - base + W - 1) / W);
        for (int k = 0; k < count; ++k) {
            const int i = __shfl_sync(0xffffffffu, bi, k);
            const int j = __shfl_sync(0xffffffffu, bj, k);
            const float vm = __shfl_sync(0xffffffffu, bvm, k);
            const size_t pr = (size_t)b * P + base + k * W;
            bf16* out = fc + pr * C * D + d;
            float msum[CPL];
#pragma unroll
            for (int e = 0; e < CPL; ++e) msum[e] = 0.f;
            if (i <= j) {
                const int frames = (j - i + 1) * tl;
                const int clip = max(1, frames / C);
                const int valid = min(C, frames);
                const Acc w = (Acc)1 / (Acc)clip;
                int s = i * tl;
                Cell start = prefix[s * 32 + lane];
#pragma unroll 4
                for (int c = 0; c < C; ++c) {
                    float v[CPL];
#pragma unroll
                    for (int e = 0; e < CPL; ++e) v[e] = 0.f;
                    if (c < valid) {
                        s += clip;
                        const Cell end = prefix[s * 32 + lane];
#pragma unroll
                        for (int e = 0; e < CPL; ++e)
                            v[e] = (float)((end.v[e] - start.v[e]) * w) * vm;
                        start = end;
                    }
                    store_cols<CPL>(out + (size_t)c * D, v, vec, live);
#pragma unroll
                    for (int e = 0; e < CPL; ++e) msum[e] += v[e];
                }
            } else {
                float z[CPL];
#pragma unroll
                for (int e = 0; e < CPL; ++e) z[e] = 0.f;
                for (int c = 0; c < C; ++c) store_cols<CPL>(out + (size_t)c * D, z, vec, live);
            }
#pragma unroll
            for (int e = 0; e < CPL; ++e) msum[e] /= (float)C;
            store_cols<CPL>(fm + pr * D + d, msum, vec, live);
        }
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

// The splits of a pooling forward's P moments over ``blocks`` (element,
// column tile) blocks on ``sms`` SMs: enough blocks for four an SM, 1 to
// kMaxPoolSplits and at most P (more than one only at small batches, as in
// serving at B=16).
inline int pool_splits(long long blocks, int P, int sms) {
    long long splits = (4LL * sms + blocks - 1) / blocks;
    splits = splits < 1 ? 1 : (splits > kMaxPoolSplits ? kMaxPoolSplits : splits);
    return (int)(splits > P ? P : splits);
}

// Launches pool_kernel_bf16<Dense> on B elements; returns the first CUDA
// error.
template <bool Dense>
cudaError_t pool_forward_bf16(cudaStream_t st, int B, int T, int L, int C, int D, const bf16* f,
                              const float* mask, bf16* fc, bf16* fm, bf16* fb) {
    const void* kernel = (const void*)pool_kernel_bf16<Dense>;
    const size_t smem = pool16_smem_bytes(T);
    int sms = 0;
    const cudaError_t err = prepare_launch(kernel, smem, &sms);
    if (err != cudaSuccess) return err;
    const int P = Dense ? L * L : L * (L + 1) / 2;
    const long long blocks = (long long)B * ((D + 32 * kPoolCPL - 1) / (32 * kPoolCPL));
    const int splits = pool_splits(blocks, P, sms);
    const void* ptrs[] = {f, fc, fm, fb};
    pool_kernel_bf16<Dense><<<(unsigned)(blocks * splits), kPool16Warps * 32, smem, st>>>(
        T, L, C, D, splits, pair_vector(D, ptrs, 4) ? 1 : 0, f, mask, fc, fm, fb);
    return cudaGetLastError();
}

// Launches the pooling forward on B elements of element type E (float:
// pool_kernel; bf16: pool_kernel_bf16), both split by `pool_splits`;
// returns the first CUDA error.
template <bool Dense, typename E>
cudaError_t pool_forward(cudaStream_t st, int B, int T, int L, int C, int D, const E* f,
                         const float* mask, E* fc, E* fm, E* fb) {
    if constexpr (sizeof(E) == 2) {
        return pool_forward_bf16<Dense>(st, B, T, L, C, D, f, mask, fc, fm, fb);
    } else {
        int sms = 0;
        const int P = Dense ? L * L : L * (L + 1) / 2;
        cudaError_t err = prepare_launch((const void*)pool_kernel<Dense>, pool_smem_bytes(T),
                                         &sms);
        if (err != cudaSuccess) return err;
        const long long blocks = (long long)B * ((D + kPropCols - 1) / kPropCols);
        const int splits = pool_splits(blocks, P, sms);
        pool_kernel<Dense><<<(unsigned)(blocks * splits), kPoolWarps * 32, pool_smem_bytes(T),
                             st>>>(T, L, C, D, splits, f, mask, fc, fm, fb);
        return cudaGetLastError();
    }
}

}  // namespace vml
