// One SMI layer on the device: the per-unit kernels and the host functions
// that sequence them, shared by the serving stack (smin_stack.cu, K4), the
// training layer kernels (smin_train.cu, K2 and the recompute of K3) and the
// content-unit training kernels (content_train.cu, K7, which runs
// `content_forward` alone).
//
// Because the ~1.1 MB of fp32 state per element does not fit a block's
// 227 KB of shared memory, a layer is a sequence of kernels (on two streams
// from kSideStreamRows content rows on, below) with its intermediates in a
// device scratch:
//   gate_kernel            fbar = sigmoid(fm * fs) * fm (rows, 16-byte
//                          accesses: bound by its bytes)
//   gemm_nt (gemm.cuh)     every projection, with bias / mask / residual
//                          epilogues
//   content_attn_forward   word attention of each clip row (-1e9 key mask),
//   (content_attn.cuh)     f_cq, the C x C clip attention (softmax unmasked,
//                          mask after), a block per tile of an element's
//                          pairs
//   boundary_query_kernel  word attention and f_bq of one snippet row
//   boundary_unit_kernel   A_b, f_bb and the moment message f_bm of one
//                          snippet row
//   moment_outer_kernel    x1[n] = bu[i_n] * bu[j_n], a block per snippet
//                          row i (its pairs' rows are consecutive)
//   moment_prologue_kernel x2[n] = mean_c(cu) (rows, 16-byte accesses:
//                          bytes)
//   moment_weights_kernel  [W_fb | W_fc] and b_fb + b_fc, so the moment
//                          unit is one product over K = 2D
// The layer's side work (w_hat, attn_k, s_hat, the boundary unit's two
// projections and two kernels, x1, the moment unit's weight and its
// product) reads only the layer's inputs and weights, fbar, x2 and what it
// wrote itself, so `layer_forward` runs it on a second stream of this host
// thread (`SideStream`), beside the content unit's chain (c_hat, attn_q,
// the gate, the pair, c_out, x2) on the caller's stream, joined by events:
// the pair waits for w_hat, attn_k and s_hat; the boundary kernels for the
// gate; the moment product for x2; the caller's stream for the moment
// product at the layer's end, or a stack's. The kernels and their
// arithmetic are those of one stream, so are the bits. Layers under
// kSideStreamRows content rows keep one stream.
// The products (gemm.cuh) bound the layer: at the Charades shapes they are
// nearly all of its operations. They take the path `gemm_path_for` picks by
// shape, but for the moment unit's, which takes the 3xTF32 tensor-core path
// at every shape (kMomentProductPath, gemm.cuh).
// Rows are n-major: row (b, n, c) of fc/cu is ((b * N) + n) * C + c, the
// layout of the plain version, models/smin.py::smi_block_packed.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "content_attn.cuh"
#include "gemm.cuh"
#include "proposal.cuh"

namespace vml {

constexpr int kWeightsPerLayer = 20;

// The bandwidth kernels of the layer (gate, moment prologue) walk rows of D
// elements: a thread takes V consecutive columns (16-byte accesses when V
// is 4 at fp32 or 8 at bf16: `row_width`), a block of 256 threads takes 256
// / (D / V) whole rows at a time (D / V <= 256) or one row in strides of
// 256, and a row's element index comes from one 32-bit division per row,
// none per element.
constexpr int kRowThreads = 256;

struct RowWalk {
    int rows_per_pass, first_col, col_step;
};
__device__ __forceinline__ RowWalk row_walk(int cols) {
    if (cols < kRowThreads)
        return {kRowThreads / cols, (int)threadIdx.x % cols, cols};
    return {1, (int)threadIdx.x, kRowThreads};
}
// The grid of a row walk over `rows` rows of `cols` column groups.
inline int row_walk_blocks(long long rows, int cols) {
    const long long per = cols < kRowThreads ? kRowThreads / cols : 1;
    const long long blocks = (rows + per - 1) / per;
    return (int)(blocks < 8192 ? blocks : 8192);
}
// Whether rows of D elements take V-wide accesses: D a multiple of V and
// every operand's start aligned to `align` bytes (V elements).
inline bool rows_vec(int D, int V, std::initializer_list<const void*> ptrs, int align) {
    if (D % V) return false;
    for (const void* p : ptrs)
        if (p && reinterpret_cast<uintptr_t>(p) % align) return false;
    return true;
}
// V = 4 when every row of every operand starts aligned to 4 elements
// (`align` bytes: 16 for fp32, 8 for bf16).
inline bool rows_vec4(int D, std::initializer_list<const void*> ptrs, int align = 16) {
    return rows_vec(D, 4, ptrs, align);
}

// V consecutive values of a row: 16-byte accesses when V is a multiple of 4.
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int k = 0; k < V; k += 4) {
            const float4 t = *reinterpret_cast<const float4*>(p + k);
            v[k] = t.x; v[k + 1] = t.y; v[k + 2] = t.z; v[k + 3] = t.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = p[k];
    }
}
template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&v)[V]) {
    if constexpr (V % 4 == 0) {
#pragma unroll
        for (int k = 0; k < V; k += 4)
            *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else {
#pragma unroll
        for (int k = 0; k < V; ++k) p[k] = v[k];
    }
}
// The same for bf16 rows (8-byte accesses when V is 4, 16-byte when 8),
// converted to and from fp32.
template <int V>
__device__ __forceinline__ void load_vec(const bf16* __restrict__ p, float (&v)[V]) {
    if constexpr (V == 4 || V == 8) {
        unsigned u[V / 2];
        if constexpr (V == 4) {
            const uint2 t = *reinterpret_cast<const uint2*>(p);
            u[0] = t.x; u[1] = t.y;
        } else {
            const uint4 t = *reinterpret_cast<const uint4*>(p);
            u[0] = t.x; u[1] = t.y; u[2] = t.z; u[3] = t.w;
        }
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[k]));
            v[2 * k] = f.x;
            v[2 * k + 1] = f.y;
        }
    } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = __bfloat162float(p[k]);
    }
}
template <int V>
__device__ __forceinline__ void store_vec(bf16* __restrict__ p, const float (&v)[V]) {
    if constexpr (V == 4 || V == 8) {
        unsigned u[V / 2];
#pragma unroll
        for (int k = 0; k < V / 2; ++k) {
            const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
            u[k] = *reinterpret_cast<const unsigned*>(&t);
        }
        if constexpr (V == 4)
            *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
        else
            *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
#pragma unroll
        for (int k = 0; k < V; ++k) p[k] = __float2bfloat16(v[k]);
    }
}

// fbar = sigmoid(fm * fs) * fm over the B * N rows of (B, N, D); bound by
// its bytes (fm read, fbar written). T: the rows' element type (fp32 math).
template <int V, typename T = float>
static __global__ void __launch_bounds__(kRowThreads) gate_kernel(int rows, int N, int D,
                                                                  const T* __restrict__ fm,
                                                                  const T* __restrict__ fs,
                                                                  T* __restrict__ fbar) {
    const int cols = D / V;
    const RowWalk w = row_walk(cols);
    const int lr = (int)threadIdx.x / cols;
    if (lr >= w.rows_per_pass) return;
    for (int row = blockIdx.x * w.rows_per_pass + lr; row < rows;
         row += gridDim.x * w.rows_per_pass) {
        const T* x = fm + (size_t)row * D;
        const T* s = fs + (size_t)(row / N) * D;
        T* y = fbar + (size_t)row * D;
        for (int c = w.first_col; c < cols; c += w.col_step) {
            float xv[V], sv[V], out[V];
            load_vec<V>(x + c * V, xv);
            load_vec<V>(s + c * V, sv);
#pragma unroll
            for (int k = 0; k < V; ++k) out[k] = sigmoidf_(xv[k] * sv[k]) * xv[k];
            store_vec<V>(y + c * V, out);
        }
    }
}

// The widest access (V elements) that rows of D elements of T take, every
// pointer aligned to it: 16 bytes (4 fp32, 8 bf16), 8 bytes of bf16 (4),
// else one element.
template <typename T>
inline int row_width(int D, std::initializer_list<const void*> ptrs) {
    if (sizeof(T) == 2 && rows_vec(D, 8, ptrs, 16)) return 8;
    return rows_vec(D, 4, ptrs, 4 * (int)sizeof(T)) ? 4 : 1;
}

template <typename T>
inline void launch_gate(cudaStream_t st, int B, int N, int D, const T* fm, const T* fs,
                          T* fbar) {
    const int V = row_width<T>(D, {fm, fs, fbar});
    const int blocks = row_walk_blocks((long long)B * N, D / V);
    if (V == 8)
        gate_kernel<8, T><<<blocks, kRowThreads, 0, st>>>(B * N, N, D, fm, fs, fbar);
    else if (V == 4)
        gate_kernel<4, T><<<blocks, kRowThreads, 0, st>>>(B * N, N, D, fm, fs, fbar);
    else
        gate_kernel<1, T><<<blocks, kRowThreads, 0, st>>>(B * N, N, D, fm, fs, fbar);
}

// The boundary unit between its projections, in two kernels of one block
// per (element, snippet row i). bq (B*L, D) = attn_q(fb), bk (B*Nq, D) =
// attn_k(fw); fw (B, Nq, D), fb (B, L, D), fs (B, D), fbar (B, N, D). A
// row's dot products run a warp each (a lane every 32nd column) and its
// softmax in one thread, in the order the serving stack's results are held
// to; the sums over rows that make the outputs give a thread V consecutive
// columns (16-byte loads of fp32 rows, 8-byte of bf16, when V is 4:
// `launch_boundary`), each column summed in the same order.
//
// boundary_query_kernel: word attention of row i (-1e9 key mask), then
// f_bq[i] = fb[i] * (f_baq[i] * lmask[i] + fs).
// T: the element type of bq, bk, fw, fb, fs and fbq (fp32 math).
constexpr int kBoundaryThreads = 128;

// The softmax of the n logits in p (shared), in place, by thread 0 in
// order; the caller syncs before and after.
__device__ __forceinline__ void serial_softmax(float* p, int n) {
    if (threadIdx.x != 0) return;
    float mx = p[0];
    for (int k = 1; k < n; ++k) mx = fmaxf(mx, p[k]);
    float sum = 0.f;
    for (int k = 0; k < n; ++k) {
        p[k] = expf(p[k] - mx);
        sum += p[k];
    }
    for (int k = 0; k < n; ++k) p[k] /= sum;
}

template <int V, typename T = float>
static __global__ void __launch_bounds__(kBoundaryThreads) boundary_query_kernel(
    int L, int Nq, int D, const T* __restrict__ bq, const T* __restrict__ bk,
    const T* __restrict__ fw, const T* __restrict__ fb, const T* __restrict__ fs,
    const float* __restrict__ qmask, const float* __restrict__ lmask, T* __restrict__ fbq) {
    extern __shared__ float smem[];
    float* p = smem;                  // (Nq,): word attention of row i
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    constexpr int nwarps = kBoundaryThreads / 32;
    const int cols = D / V;
    const float inv_sd = 1.f / sqrtf((float)D);
    const T* x = bq + (size_t)row * D;

    for (int m = warp; m < Nq; m += nwarps) {
        const T* y = bk + ((size_t)b * Nq + m) * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += to_f(x[d]) * to_f(y[d]);
        s = warp_sum(s);
        if (lane == 0) p[m] = qmask[(size_t)b * Nq + m] > 0.f ? s * inv_sd : kNegInf;
    }
    __syncthreads();
    serial_softmax(p, Nq);
    __syncthreads();
    const float lm = lmask[row];
    const T* fwe = fw + (size_t)b * Nq * D;
    for (int c = threadIdx.x; c < cols; c += kBoundaryThreads) {
        const int d = c * V;
        float a[V], t[V], f[V], sv[V], out[V];
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = 0.f;
        for (int m = 0; m < Nq; ++m) {
            load_vec<V>(fwe + (size_t)m * D + d, t);
#pragma unroll
            for (int k = 0; k < V; ++k) a[k] += p[m] * t[k];
        }
        load_vec<V>(fb + (size_t)row * D + d, f);
        load_vec<V>(fs + (size_t)b * D + d, sv);
#pragma unroll
        for (int k = 0; k < V; ++k) out[k] = f[k] * (a[k] * lm + sv[k]);
        store_vec<V>(fbq + (size_t)row * D + d, out);
    }
}

// boundary_unit_kernel: A_b[i] = softmax_j(f_bq[i] . f_bq[j] / sqrt(D), -1e9
// on invalid j) * lmask[i], then bu[i] = f_bb[i] + fb[i] + f_bm[i] with
// f_bb[i] = (A_b[i] @ fb) * lmask[i] and f_bm[i] = sum over pairs n = (i, j)
// of A_b[i, j] * fbar[n].
// T: the element type of fbq, fb, fbar and bu (fp32 math).
template <int V, typename T = float>
static __global__ void __launch_bounds__(kBoundaryThreads) boundary_unit_kernel(
    int L, int D, const T* __restrict__ fbq, const T* __restrict__ fb,
    const T* __restrict__ fbar, const float* __restrict__ lmask, T* __restrict__ bu) {
    extern __shared__ float smem[];
    float* a = smem;                  // (L,): A_b row i
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int i = row % L;
    const int N = L * (L + 1) / 2;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    constexpr int nwarps = kBoundaryThreads / 32;
    const int cols = D / V;
    const float inv_sd = 1.f / sqrtf((float)D);
    const float* lm = lmask + (size_t)b * L;
    const T* x = fbq + (size_t)row * D;

    for (int j = warp; j < L; j += nwarps) {
        const T* y = fbq + ((size_t)b * L + j) * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += to_f(x[d]) * to_f(y[d]);
        s = warp_sum(s);
        if (lane == 0) a[j] = lm[j] > 0.f ? s * inv_sd : kNegInf;
    }
    __syncthreads();
    serial_softmax(a, L);
    __syncthreads();
    const float lmi = lm[i];
    const T* fbe = fb + (size_t)b * L * D;
    const T* fbar_i = fbar + ((size_t)b * N + pair_index(i, i, L)) * D;
    for (int c = threadIdx.x; c < cols; c += kBoundaryThreads) {
        const int d = c * V;
        float bb[V], bm[V], t[V], out[V];
#pragma unroll
        for (int k = 0; k < V; ++k) bb[k] = bm[k] = 0.f;
        for (int j = 0; j < L; ++j) {
            const float w = a[j] * lmi;
            load_vec<V>(fbe + (size_t)j * D + d, t);
#pragma unroll
            for (int k = 0; k < V; ++k) bb[k] += w * t[k];
        }
        for (int j = i; j < L; ++j) {
            const float w = a[j] * lmi;
            load_vec<V>(fbar_i + (size_t)(j - i) * D + d, t);
#pragma unroll
            for (int k = 0; k < V; ++k) bm[k] += w * t[k];
        }
        load_vec<V>(fbe + (size_t)i * D + d, t);
#pragma unroll
        for (int k = 0; k < V; ++k) out[k] = bb[k] * lmi + t[k] + bm[k];
        store_vec<V>(bu + (size_t)row * D + d, out);
    }
}

// The boundary unit's two kernels, V = 4 where every row allows it.
template <typename T>
inline void launch_boundary(cudaStream_t st, int B, int L, int Nq, int D, const T* bq,
                            const T* bk, const T* fw, const T* fb, const T* fs,
                            const float* qmask, const float* lmask, T* fbq, const T* fbar,
                            T* bu) {
    const bool v4 = rows_vec4(D, {bq, bk, fw, fb, fs, fbq, fbar, bu}, 4 * (int)sizeof(T));
    const size_t q_smem = Nq * sizeof(float), u_smem = L * sizeof(float);
    if (v4) {
        boundary_query_kernel<4, T><<<B * L, kBoundaryThreads, q_smem, st>>>(
            L, Nq, D, bq, bk, fw, fb, fs, qmask, lmask, fbq);
        boundary_unit_kernel<4, T><<<B * L, kBoundaryThreads, u_smem, st>>>(L, D, fbq, fb, fbar,
                                                                           lmask, bu);
    } else {
        boundary_query_kernel<1, T><<<B * L, kBoundaryThreads, q_smem, st>>>(
            L, Nq, D, bq, bk, fw, fb, fs, qmask, lmask, fbq);
        boundary_unit_kernel<1, T><<<B * L, kBoundaryThreads, u_smem, st>>>(L, D, fbq, fb, fbar,
                                                                           lmask, bu);
    }
}

// The moment unit's operand [x1 | x2] (rows ldx apart; the layer writes
// them side by side, the moment product's one operand).
//
// moment_outer_kernel: x1[n] = bu[i] * bu[j] for the pairs n = (i, j >= i)
// of snippet row i of element b (block b * L + i): rows (i, i) .. (i, L - 1)
// are consecutive, bu[i] and bu[j] come from L2, V columns a thread.
// Bound by its bytes (x1 written).
template <int V, typename T>
static __global__ void __launch_bounds__(kRowThreads) moment_outer_kernel(
    int L, int D, const T* __restrict__ bu, T* __restrict__ x1, int ldx) {
    const int b = blockIdx.x / L, i = blockIdx.x % L;
    const int cols = D / V;
    const T* bi = bu + ((size_t)b * L + i) * D;
    T* x = x1 + ((size_t)b * (L * (L + 1) / 2) + pair_index(i, i, L)) * ldx;
    for (int e = threadIdx.x; e < (L - i) * cols; e += kRowThreads) {
        const int jj = e / cols, d = (e % cols) * V;   // pair (i, i + jj)
        float u[V], v[V], out[V];
        load_vec<V>(bi + d, u);
        load_vec<V>(bi + (size_t)jj * D + d, v);
#pragma unroll
        for (int k = 0; k < V; ++k) out[k] = u[k] * v[k];
        store_vec<V>(x + (size_t)jj * ldx + d, out);
    }
}

template <typename T>
inline void launch_moment_outer(cudaStream_t st, int B, int L, int D, const T* bu, T* x1,
                                int ldx) {
    int V = row_width<T>(D, {bu, x1});
    while (ldx % V) V /= 2;
    if (V == 8)
        moment_outer_kernel<8, T><<<B * L, kRowThreads, 0, st>>>(L, D, bu, x1, ldx);
    else if (V == 4)
        moment_outer_kernel<4, T><<<B * L, kRowThreads, 0, st>>>(L, D, bu, x1, ldx);
    else
        moment_outer_kernel<1, T><<<B * L, kRowThreads, 0, st>>>(L, D, bu, x1, ldx);
}

// moment_prologue_kernel: x2[n] = mean_c cu[n, c] over the pairs (the fp32
// layer's clip mean; the bf16 layer's comes from c_out's epilogue), and
// K10's, x2 alone). Bound by its bytes (cu read, x2 written).
template <int V, typename T = float>
static __global__ void __launch_bounds__(kRowThreads) moment_prologue_kernel(
    int pairs, int C, int D, const T* __restrict__ cu, T* __restrict__ x2, int ldx) {
    const int cols = D / V;
    const RowWalk w = row_walk(cols);
    const int lr = (int)threadIdx.x / cols;
    if (lr >= w.rows_per_pass) return;
    for (int pair = blockIdx.x * w.rows_per_pass + lr; pair < pairs;
         pair += gridDim.x * w.rows_per_pass) {
        const T* cp = cu + (size_t)pair * C * D;
        for (int c = w.first_col; c < cols; c += w.col_step) {
            const int d = c * V;
            float sum[V];
#pragma unroll
            for (int k = 0; k < V; ++k) sum[k] = 0.f;
#pragma unroll 4
            for (int q = 0; q < C; ++q) {
                float t[V];
                load_vec<V>(cp + (size_t)q * D + d, t);
#pragma unroll
                for (int k = 0; k < V; ++k) sum[k] += t[k];
            }
#pragma unroll
            for (int k = 0; k < V; ++k) sum[k] /= (float)C;
            store_vec<V>(x2 + (size_t)pair * ldx + d, sum);
        }
    }
}

template <typename T>
inline void launch_moment_prologue(cudaStream_t st, int pairs, int C, int D, const T* cu,
                                   T* x2, int ldx) {
    int V = row_width<T>(D, {cu, x2});
    while (ldx % V) V /= 2;
    const int blocks = row_walk_blocks(pairs, D / V);
    if (V == 8)
        moment_prologue_kernel<8, T><<<blocks, kRowThreads, 0, st>>>(pairs, C, D, cu, x2, ldx);
    else if (V == 4)
        moment_prologue_kernel<4, T><<<blocks, kRowThreads, 0, st>>>(pairs, C, D, cu, x2, ldx);
    else
        moment_prologue_kernel<1, T><<<blocks, kRowThreads, 0, st>>>(pairs, C, D, cu, x2, ldx);
}

// The moment unit's weight [W_fb | W_fc] (D, 2D) into wm (2 D^2 values of
// T) and its bias b_fb + b_fc (D floats) into wb, from the two 1x1
// convolutions' (D, D) weights (T) and biases (fp32).
template <typename T = float>
static __global__ void moment_weights_kernel(int D, const T* __restrict__ wfb,
                                             const float* __restrict__ bfb,
                                             const T* __restrict__ wfc,
                                             const float* __restrict__ bfc,
                                             T* __restrict__ wm, float* __restrict__ wb) {
    const size_t dd = (size_t)D * D;
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < 2 * dd + D;
         e += (size_t)gridDim.x * blockDim.x) {
        if (e < 2 * dd) {
            const size_t o = e / (2 * D);
            const int k = (int)(e - o * 2 * D);
            wm[e] = k < D ? wfb[o * D + k] : wfc[o * D + k - D];
        } else {
            wb[e - 2 * dd] = bfb[e - 2 * dd] + bfc[e - 2 * dd];
        }
    }
}

// The intermediates of one layer, in the layer's element type T (fp32, or
// bf16 for the bf16 variants of K4, K2 and K3); f_s_hat and the moment
// unit's bias stay fp32
// at either type. K4 and K2 only pass through them; the backward (K3) reads
// them after the recompute. x12 (B * N, 2D) holds [x1 | x2], the moment
// unit's operand; wm its weight [W_fb | W_fc] and wb its bias b_fb + b_fc.
template <typename T>
struct LayerScratchT {
    T *fbar, *h, *q, *fcc, *fwh, *khat, *bq, *bk, *fbq, *x12, *wm;
    float *fsh, *wb;
};
using LayerScratch = LayerScratchT<float>;

// Carves slots of the given sizes out of `ws` (null: only measure), each
// 16-byte aligned; returns the floats used from `off` on.
inline size_t carve_slots(float* ws, size_t off, const size_t* sizes, float*** slots, int n) {
    for (int k = 0; k < n; ++k) {
        *slots[k] = ws ? ws + off : nullptr;
        off += (sizes[k] + 3) / 4 * 4;
    }
    return off;
}

// As carve_slots, in bytes: returns the bytes used from `off` on.
inline size_t carve_bytes(unsigned char* ws, size_t off, const size_t* sizes, void** slots,
                          int n) {
    for (int k = 0; k < n; ++k) {
        slots[k] = ws ? ws + off : nullptr;
        off += (sizes[k] + 15) / 16 * 16;
    }
    return off;
}

// Carves the layer's scratch out of `ws` from byte `off` on (null: only
// measure); returns the bytes used from `off` on.
template <typename T>
inline size_t carve_layer_scratch(unsigned char* ws, size_t off, int B, int L, int C, int Nq,
                                  int D, int dl, LayerScratchT<T>* s) {
    const size_t N = (size_t)L * (L + 1) / 2;
    const size_t NC = N * C;
    const size_t t = sizeof(T), f4 = sizeof(float);
    const size_t sizes[13] = {
        t * B * N * D,                                    // fbar
        t * B * NC * dl, t * B * NC * dl, t * B * NC * dl,   // h, q, fcc
        t * B * Nq * dl, t * B * Nq * dl,                 // fwh, khat
        t * B * L * D, t * B * Nq * D, t * B * L * D,     // bq, bk, fbq
        t * 2 * B * N * D, t * 2 * (size_t)D * D,         // x12, wm
        f4 * B * dl, f4 * D,                              // fsh, wb
    };
    void* slots[13];
    off = carve_bytes(ws, off, sizes, slots, 13);
    T** typed[11] = {&s->fbar, &s->h, &s->q, &s->fcc, &s->fwh, &s->khat,
                     &s->bq, &s->bk, &s->fbq, &s->x12, &s->wm};
    for (int k = 0; k < 11; ++k) *typed[k] = static_cast<T*>(slots[k]);
    s->fsh = static_cast<float*>(slots[11]);
    s->wb = static_cast<float*>(slots[12]);
    return off;
}

// The fp32 layer's scratch in a float workspace, from float `off` on;
// returns the floats used from `off` on.
inline size_t carve_layer_scratch(float* ws, size_t off, int B, int L, int C, int Nq, int D,
                                  int dl, LayerScratch* s) {
    return carve_layer_scratch<float>(reinterpret_cast<unsigned char*>(ws), off * sizeof(float),
                                      B, L, C, Nq, D, dl, s) / sizeof(float);
}

// Largest dynamic shared memory of the forward kernels of a layer.
inline size_t layer_forward_smem_bytes(int L, int C, int Nq, int dl) {
    const size_t a = content_attn_smem_bytes(L * (L + 1) / 2, C, Nq, dl, false);
    const size_t b = sizeof(float) * (size_t)(Nq > L ? Nq : L);   // boundary kernels
    return a > b ? a : b;
}

// The layer's products by element type: fp32 operands on gemm.cuh's fp32
// paths (`path` < 0: by shape), bf16 operands on its bf16 path (bf16
// operands, fp32 sums; it has one path, so `path` is the fp32 product's
// only), the output fp32 or bf16. EpilogueOf<T>: the epilogue of the
// operands' type.
template <typename T>
using EpilogueOf =
    typename std::conditional<std::is_same<T, float>::value, Epilogue, EpilogueBf16>::type;

inline void product(cudaStream_t st, int M, int N, int K, const float* A, int lda,
                    const float* W, int ldw, float* C, int ldc, const Epilogue& ep,
                    int path = -1) {
    gemm_nt(st, M, N, K, A, lda, W, ldw, C, ldc, ep, -1, path);
}

template <typename TC>
inline void product(cudaStream_t st, int M, int N, int K, const bf16* A, int lda, const bf16* W,
                    int ldw, TC* C, int ldc, const EpilogueBf16& ep, int /*path*/ = -1) {
    gemm_nt_bf16(st, M, N, K, A, lda, W, ldw, C, ldc, std::is_same<TC, float>::value, ep);
}

// The backward's products by element type, as `product` is the forward's:
// product_nn C = A W (A (M, K), W (K, N)); product_nn2 one A against W0 and
// W1 with one epilogue; product_tn out (M, N) = (A * ascale[row / adiv])^T B
// (A (R, M), B (R, N)) reduced over R through `partial` in a fixed order,
// bias_out the column sums of the scaled A (gemm_tn, gemm_tn_bf16).
inline void product_nn(cudaStream_t st, int M, int N, int K, const float* A, int lda,
                       const float* W, int ldw, float* C, int ldc, const Epilogue& ep) {
    gemm_nn(st, M, N, K, A, lda, nullptr, 1, W, ldw, C, ldc, ep);
}

template <typename TC>
inline void product_nn(cudaStream_t st, int M, int N, int K, const bf16* A, int lda,
                       const bf16* W, int ldw, TC* C, int ldc, const EpilogueBf16& ep) {
    gemm_nn_bf16(st, M, N, K, A, lda, W, ldw, C, ldc, std::is_same<TC, float>::value, ep);
}

inline void product_nn2(cudaStream_t st, int M, int N, int K, const float* A, int lda,
                        const float* W0, const float* W1, int ldw, float* C0, float* C1, int ldc,
                        const Epilogue& ep) {
    gemm_nn2(st, M, N, K, A, lda, nullptr, 1, W0, W1, ldw, C0, C1, ldc, ep, ep);
}

inline void product_nn2(cudaStream_t st, int M, int N, int K, const bf16* A, int lda,
                        const bf16* W0, const bf16* W1, int ldw, bf16* C0, bf16* C1, int ldc,
                        const EpilogueBf16& ep) {
    gemm_nn2_bf16(st, M, N, K, A, lda, W0, W1, ldw, C0, C1, ldc, false, ep, ep);
}

inline void product_tn(cudaStream_t st, int M, int N, int R, const float* A, int lda,
                       const float* ascale, int adiv, const float* B, int ldb, float* partial,
                       float* out, float* bias_out = nullptr) {
    gemm_tn(st, M, N, R, A, lda, ascale, adiv, B, ldb, partial, out, bias_out);
}

inline void product_tn(cudaStream_t st, int M, int N, int R, const bf16* A, int lda,
                       const float* ascale, int adiv, const bf16* B, int ldb, float* partial,
                       float* out, float* bias_out = nullptr) {
    gemm_tn_bf16(st, M, N, R, A, lda, ascale, adiv, B, ldb, partial, out, bias_out);
}

// Two weight gradients of one cotangent A whose inputs lie side by side in
// B (R, N), one product_tn over all N columns: out (M, split) takes B's
// first `split` columns, out2 (M, N - split) the rest; bias_out and
// bias_out2 both the column sums of the scaled A.
template <typename T>
inline void product_tn2(cudaStream_t st, int M, int N, int R, const T* A, int lda,
                        const float* ascale, int adiv, const T* B, int ldb, int split,
                        float* partial, float* out, float* out2, float* bias_out,
                        float* bias_out2) {
    if constexpr (std::is_same<T, float>::value)
        gemm_tn(st, M, N, R, A, lda, ascale, adiv, B, ldb, partial, out, bias_out, -1, split,
                out2, bias_out2);
    else
        gemm_tn_bf16(st, M, N, R, A, lda, ascale, adiv, B, ldb, partial, out, bias_out, -1,
                     split, out2, bias_out2);
}

// Adds the fp32 rows `acc` (M, ld) after the mask, or nothing when it is
// null: Epilogue's post, EpilogueBf16's post32.
inline void add_f32(Epilogue& ep, const float* acc, int ld) {
    ep.post = acc;
    ep.ldpost = ld;
}

inline void add_f32(EpilogueBf16& ep, const float* acc, int ld) {
    ep.post32 = acc;
    ep.ldpost32 = ld;
}

// Adds an epilogue's residuals in the output's type, rounding after the
// mask and after each residual (EpilogueBf16's round_each): at fp32 the one
// sum it already is.
inline void round_residuals(Epilogue& /*ep*/) {}
inline void round_residuals(EpilogueBf16& ep) { ep.round_each = true; }

// Where a gradient of element type T gathers its fp32 shares before its
// last product: at fp32 the gradient itself, at bf16 the fp32 `scratch`.
inline float* f32_sum(float* grad, float* /*scratch*/) { return grad; }
inline float* f32_sum(bf16* /*grad*/, float* scratch) { return scratch; }

// The second stream of a layer's query side, with its events, one per host
// thread and device; created at first use and kept (internal linkage: each
// library that includes this header has its own). The stream has the
// highest priority, so its short kernels take SMs as the content unit's
// long ones free them; it does not synchronise with the legacy default
// stream, only through the events.
struct SideStream {
    cudaStream_t stream = nullptr;
    cudaEvent_t fork = nullptr, gate = nullptr, query = nullptr, cout = nullptr,
                join = nullptr;
};

static cudaError_t side_stream(SideStream** out) {
    static thread_local SideStream per_device[16];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 16) return cudaErrorInvalidDevice;
    SideStream& s = per_device[dev];
    if (!s.stream) {
        int least = 0, greatest = 0;
        if ((err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) != cudaSuccess) return err;
        for (cudaEvent_t* e : {&s.fork, &s.gate, &s.query, &s.cout, &s.join})
            if ((err = cudaEventCreateWithFlags(e, cudaEventDisableTiming)) != cudaSuccess)
                return err;
        err = cudaStreamCreateWithPriority(&s.stream, cudaStreamNonBlocking, greatest);
        if (err != cudaSuccess) return err;
    }
    *out = &s;
    return cudaSuccess;
}

// Layers of fewer content rows (B * N * C) than this run on the caller's
// stream alone: serving at B=16 (8,704 rows) lost more host time to the
// second stream's event calls than its overlap saved (PERF.md §6).
constexpr long long kSideStreamRows = 16384;

// `to` waits for the work `from` has queued so far, through `ev`.
inline cudaError_t stream_after(cudaStream_t to, cudaStream_t from, cudaEvent_t ev) {
    cudaError_t err = cudaEventRecord(ev, from);
    return err != cudaSuccess ? err : cudaStreamWaitEvent(to, ev, 0);
}

#define VML_CHECK_LAUNCH()                                                  \
    do {                                                                    \
        cudaError_t vml_err_ = cudaGetLastError();                          \
        if (vml_err_ != cudaSuccess) return vml_err_;                       \
    } while (0)

// The ContentUnit of a layer over N pairs: (fc, fbar) -> cu = c_out(f_cc_hat)
// * vmask + fc + fbar, with h, q, fwh, khat, fsh and fcc left in `s`. p: the
// unit's 12 device pointers, the first 12 of `layer_forward`'s order (the
// matrices of type T, the biases fp32). The residual sum is fp32, rounded
// once to T; with `residual_in_t` (K10) it is added in T, each term rounded,
// as the JAX package's fused unit adds it. cu may be null (K10's backward
// recompute, which reads only the intermediates): the c_out product is then
// skipped. Its three parts, which `content_forward` runs in order on one
// stream and `layer_forward` on two:
//   content_clip   c_hat * vmask and attn_q (reads fc)
//   content_query  w_hat * qmask, attn_k and s_hat (reads fw, fs)
//   content_pair   the pair's forward and c_out (reads both parts, fbar)
template <typename T, typename P>
inline cudaError_t content_clip(cudaStream_t st, int B, int N, int C, int D, int dl,
                                const T* fc, const float* vmask, const P* const* p,
                                const LayerScratchT<T>& s) {
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    auto bias = [p](int k) { return static_cast<const float*>(p[k]); };
    EpilogueOf<T> ep;
    ep.bias = bias(1);
    ep.rmask = vmask;
    ep.mask_div = C;
    product(st, B * N * C, dl, D, fc, D, W(0), D, s.h, dl, ep);       // c_hat * vmask
    VML_CHECK_LAUNCH();
    linear(st, B * N * C, dl, dl, s.h, W(8), bias(9), s.q);             // attn_q
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

template <typename T, typename P>
inline cudaError_t content_query(cudaStream_t st, int B, int Nq, int D, int dl, const T* fw,
                                 const T* fs, const float* qmask, const P* const* p,
                                 const LayerScratchT<T>& s) {
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    auto bias = [p](int k) { return static_cast<const float*>(p[k]); };
    EpilogueOf<T> ep;
    ep.bias = bias(3);
    ep.rmask = qmask;
    product(st, B * Nq, dl, D, fw, D, W(2), D, s.fwh, dl, ep);        // w_hat * qmask
    VML_CHECK_LAUNCH();
    linear(st, B * Nq, dl, dl, s.fwh, W(10), bias(11), s.khat);         // attn_k
    VML_CHECK_LAUNCH();
    linear(st, B, dl, D, fs, W(4), bias(5), s.fsh);                     // s_hat, fp32
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

template <typename T, typename P>
inline cudaError_t content_pair(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                                const T* fc, const T* fbar, const float* qmask,
                                const float* vmask, const P* const* p, const LayerScratchT<T>& s,
                                T* cu, bool residual_in_t) {
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    auto bias = [p](int k) { return static_cast<const float*>(p[k]); };
    cudaError_t err = content_attn_forward(st, B, N, C, Nq, dl, s.h, s.q, s.khat, s.fwh, s.fsh,
                                           qmask, vmask, s.fcc);
    if (err != cudaSuccess || !cu) return err;
    EpilogueOf<T> ep;         // cu = c_out(f_cc_hat) * vmask + fc + fbar
    ep.bias = bias(7);
    ep.rmask = vmask;
    ep.mask_div = C;
    ep.post = fc;
    ep.ldpost = D;
    ep.post2 = fbar;
    ep.ldpost2 = D;
    ep.post2_div = C;
    if (residual_in_t) round_residuals(ep);
    product(st, B * N * C, D, dl, s.fcc, dl, W(6), dl, cu, D, ep);
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

template <typename T, typename P>
inline cudaError_t content_forward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                                   const T* fc, const T* fbar, const T* fw, const T* fs,
                                   const float* qmask, const float* vmask, const P* const* p,
                                   const LayerScratchT<T>& s, T* cu,
                                   bool residual_in_t = false) {
    cudaError_t err = content_clip(st, B, N, C, D, dl, fc, vmask, p, s);
    if (err == cudaSuccess) err = content_query(st, B, Nq, D, dl, fw, fs, qmask, p, s);
    if (err == cudaSuccess)
        err = content_pair(st, B, N, C, Nq, D, dl, fc, fbar, qmask, vmask, p, s, cu,
                           residual_in_t);
    return err;
}

// One SMI layer: (fc, fm, fb) -> (cu, mu, bu), intermediates left in `s`,
// in the element type T: fp32 (K4, K2, K9, K3's recompute) or bf16 (the
// bf16 variants of K4, K2 and K3's recompute; its plain version is
// models/smin.py::smi_layer_bf16): activations of type T, fp32
// arithmetic inside every kernel, one rounding per stored value.
// p: the layer's 20 device pointers in the order
//   c_hat.w, c_hat.b, w_hat.w, w_hat.b, s_hat.w, s_hat.b, c_out.w, c_out.b,
//   content attn W_q.w, .b, W_k.w, .b, boundary attn W_q.w, .b, W_k.w, .b,
//   conv_fb.w, .b, conv_fc.w, .b
// (torch layouts: Linear (out, in), 1x1 conv (out, in, 1, 1)); the matrices
// of type T, the biases fp32.
// mu may be null: the moment product is then skipped (the backward's
// recompute needs only its operand [x1 | x2]). The moment product runs on
// the query side; with `join` false the caller's stream does not wait for
// it (nor for bu): a stack of layers joins after its last, so that the
// next layer's c_hat and attn_q, which read only cu, overlap it; the next
// layer's gate waits for it (side->join), its query side follows it in
// stream order.
// Returns the first CUDA error of the launches.
template <typename T, typename P>
inline cudaError_t layer_forward(cudaStream_t st, int B, int L, int C, int Nq, int D, int dl,
                                 const T* fc, const T* fm, const T* fb, const T* fw,
                                 const T* fs, const float* qmask, const float* lmask,
                                 const float* vmask, const P* const* p,
                                 const LayerScratchT<T>& s, T* cu, T* mu, T* bu,
                                 bool join = true) {
    const int N = L * (L + 1) / 2;
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    auto bias = [p](int k) { return static_cast<const float*>(p[k]); };
    // The query side waits for the caller's stream (its inputs, and the
    // scratch the stream's earlier work reads).
    SideStream* side = nullptr;
    cudaError_t err = cudaSuccess;
    if ((long long)B * N * C >= kSideStreamRows) {
        if ((err = side_stream(&side)) != cudaSuccess) return err;
        if ((err = stream_after(side->stream, st, side->fork)) != cudaSuccess) return err;
    }
    const cudaStream_t qs = side ? side->stream : st;

    // The content unit: its clip side and the gate here, its query side on
    // qs. The gate waits for a stack's previous layer's side work (its mu)
    // and comes after attn_q, so that c_hat and attn_q, which read only fc,
    // overlap that layer's moment product.
    if ((err = content_clip(st, B, N, C, D, dl, fc, vmask, p, s)) != cudaSuccess) return err;
    if ((err = content_query(qs, B, Nq, D, dl, fw, fs, qmask, p, s)) != cudaSuccess) return err;
    if (side && (err = cudaStreamWaitEvent(st, side->join, 0)) != cudaSuccess) return err;
    launch_gate(st, B, N, D, fm, fs, s.fbar);
    VML_CHECK_LAUNCH();
    if (side) {
        if ((err = cudaEventRecord(side->gate, st)) != cudaSuccess) return err;
        if ((err = stream_after(st, qs, side->query)) != cudaSuccess) return err;
    }
    err = content_pair(st, B, N, C, Nq, D, dl, fc, s.fbar, qmask, vmask, p, s, cu, false);
    if (err != cudaSuccess) return err;
    if (mu) {   // the moment unit's weight and bias
        moment_weights_kernel<T><<<(2 * D * D + D + 255) / 256, 256, 0, qs>>>(
            D, W(16), bias(17), W(18), bias(19), s.wm, s.wb);
        VML_CHECK_LAUNCH();
    }

    // BoundaryUnit, on the query side.
    linear(qs, B * L, D, D, fb, W(12), bias(13), s.bq);
    VML_CHECK_LAUNCH();
    linear(qs, B * Nq, D, D, fw, W(14), bias(15), s.bk);
    VML_CHECK_LAUNCH();
    if (side && (err = cudaStreamWaitEvent(qs, side->gate, 0)) != cudaSuccess) return err;
    launch_boundary<T>(qs, B, L, Nq, D, s.bq, s.bk, fw, fb, fs, qmask, lmask, s.fbq, s.fbar, bu);
    VML_CHECK_LAUNCH();

    // MomentUnit: mu = (conv_fb(outer) + conv_fc(mean_c cu)) * vmask + fm, one
    // product [x1 | x2] [W_fb | W_fc]^T over K = 2D with b_fb + b_fc. Its
    // operand's x1 = bu[i] * bu[j] on the query side, x2 = mean_c cu here.
    launch_moment_outer<T>(qs, B, L, D, bu, s.x12, 2 * D);
    VML_CHECK_LAUNCH();
    launch_moment_prologue<T>(st, B * N, C, D, cu, s.x12 + D, 2 * D);
    VML_CHECK_LAUNCH();
    if (mu) {   // on the query side, once x2 is written
        if (side && (err = stream_after(qs, st, side->cout)) != cudaSuccess) return err;
        EpilogueOf<T> ep;
        ep.bias = s.wb;
        ep.rmask = vmask;
        ep.post = fm;
        ep.ldpost = D;
        product(qs, B * N, D, 2 * D, s.x12, 2 * D, s.wm, 2 * D, mu, D, ep, kMomentProductPath);
        VML_CHECK_LAUNCH();
    }
    if (!side) return cudaSuccess;
    if ((err = cudaEventRecord(side->join, qs)) != cudaSuccess) return err;
    return join ? cudaStreamWaitEvent(st, side->join, 0) : cudaSuccess;
}

}  // namespace vml
