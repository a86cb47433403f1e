// The backward of the ContentUnit on the device, shared by the SMI layer
// backward (smin_train.cu, K3) and the content-unit backward
// (content_train.cu, K7 and K10): the host functions that sequence the
// content-attention backward (content_attn.cuh) with the GEMMs of gemm.cuh,
// the cotangent sum of K3 and K7, and the moment gate's backward of K3 and
// K10. The derivation heads smin_train.cu
// ("ContentUnit"). Everything a kernel writes it owns: no atomics, so a run
// is deterministic. One sequence serves both element types: at bf16 (K3-bf16)
// it runs on bf16 activations and gradients with gemm.cuh's bf16 products,
// and a gradient that two paths add to (dh, dfwh, dfw, dfs) stays fp32 until
// its last product's epilogue rounds it once.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "smin_units.cuh"

namespace vml {

// dcut[n, c, d] = dcu[n, c, d] + dx2[n, d] / C over the B * N pairs of C
// clip rows, and (dfbar not null, K7) dfbar[n, d] = sum_c dcut[n, c, d];
// dcu may be null (zero). A row walk over the pairs (smin_units.cuh): a
// thread takes V consecutive columns of a pair (16-byte accesses when V is
// 16 / sizeof(T)), so the share dx2 / C is loaded and scaled once for the
// pair's C rows and no element index is divided. Bound by its bytes (dcu
// read, dcut written). T: fp32, or bf16, where the share, the gradient of
// the clip mean's input, is rounded to bf16 before the outer cotangent is
// added and the sum is rounded again (cu is a stored bf16 value whose layer
// also reads it), and dfbar sums the stored dcut in fp32, rounded once.
template <int V, typename T>
static __global__ void __launch_bounds__(kRowThreads) dcut_kernel(
    int pairs, int C, int D, const T* __restrict__ dcu, const T* __restrict__ dx2,
    T* __restrict__ dcut, T* __restrict__ dfbar) {
    const int cols = D / V;
    const RowWalk w = row_walk(cols);
    const int lr = (int)threadIdx.x / cols;
    if (lr >= w.rows_per_pass) return;
    const float inv_c = 1.f / (float)C;
    for (int n = blockIdx.x * w.rows_per_pass + lr; n < pairs; n += gridDim.x * w.rows_per_pass) {
        for (int col = w.first_col; col < cols; col += w.col_step) {
            const int d = col * V;
            float share[V], sum[V];
            load_vec<V>(dx2 + (size_t)n * D + d, share);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                share[k] = to_f(from_f<T>(share[k] * inv_c));
                sum[k] = 0.f;
            }
            for (int c = 0; c < C; ++c) {
                const size_t off = ((size_t)n * C + c) * D + d;
                float v[V];
                if (dcu) {
                    load_vec<V>(dcu + off, v);
#pragma unroll
                    for (int k = 0; k < V; ++k) v[k] = to_f(from_f<T>(v[k] + share[k]));
                } else {
#pragma unroll
                    for (int k = 0; k < V; ++k) v[k] = share[k];
                }
                store_vec<V>(dcut + off, v);
#pragma unroll
                for (int k = 0; k < V; ++k) sum[k] += v[k];
            }
            if (dfbar) store_vec<V>(dfbar + (size_t)n * D + d, sum);
        }
    }
}

template <typename T>
inline void launch_dcut(cudaStream_t st, int pairs, int C, int D, const T* dcu, const T* dx2,
                        T* dcut, T* dfbar) {
    constexpr int V = 16 / sizeof(T);
    const bool vec = rows_vec(D, V, {dcu, dx2, dcut, dfbar}, 16);
    const int cols = vec ? D / V : D;
    const int blocks = row_walk_blocks(pairs, cols);
    if (vec)
        dcut_kernel<V, T><<<blocks, kRowThreads, 0, st>>>(pairs, C, D, dcu, dx2, dcut, dfbar);
    else
        dcut_kernel<1, T><<<blocks, kRowThreads, 0, st>>>(pairs, C, D, dcu, dx2, dcut, dfbar);
}

// The moment gate's backward, fbar = sigmoid(fm * fs) * fm, shared by the
// SMI layer (K3, kLayer) and the fused content unit (K10), split along an
// element's pairs so that the card fills (`gate_bwd_splits`): block (column
// block, split) of element b gives a thread V consecutive columns d (16-byte
// loads when V is 4 at fp32, 8-byte at bf16) and the pairs [n_begin, n_end)
// of its split, in order:
//   dfbar[n] = sum_c dcut[n, c] (+ A[i_n, j_n] * G[i_n], kLayer: the
//              boundary unit's share)
//   dfm[n]   = dfbar[n] * (s + z * s * (1 - s)) (+ dmu[n], kLayer: the
//              moment unit's residual),  z = fm * fs, s = sigmoid(z)
// and writes its split's share of dfs, sum_n dfbar[n] * fm[n]^2 * s * (1 -
// s), to part[split, b]; gate_dfs_kernel adds the splits in order. T: the
// type of fm, fs, dmu, dcut and dfm; at bf16 dfbar (the gradient of the
// stored fbar) is rounded to bf16 before it is used.
constexpr int kGateThreads = 128;
constexpr int kGateMaxSplits = 32;

template <int V, typename T, bool kLayer>
static __global__ void __launch_bounds__(kGateThreads) gate_bwd_kernel(
    int N, int L, int C, int D, int splits, const T* __restrict__ fm, const T* __restrict__ fs,
    const T* __restrict__ dmu, const T* __restrict__ dcut, const float* __restrict__ Ab,
    const float* __restrict__ G, T* __restrict__ dfm, float* __restrict__ part) {
    const int cols = D / V;
    const int col_blocks = (cols + kGateThreads - 1) / kGateThreads;
    const int b = blockIdx.y;
    const int split = blockIdx.x / col_blocks;
    const int col = (blockIdx.x - split * col_blocks) * kGateThreads + threadIdx.x;
    if (col >= cols) return;
    const int d = col * V;
    const int per = (N + splits - 1) / splits;
    const int n_begin = split * per;
    const int n_end = min(N, n_begin + per);
    float fsv[V], acc[V];
    load_vec<V>(fs + (size_t)b * D + d, fsv);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    if (n_begin < n_end) {
        int i = 0, j = 0;
        float g[V];
        if constexpr (kLayer) {
            pair_of(n_begin, L, i, j);
            load_vec<V>(G + ((size_t)b * L + i) * D + d, g);
        }
        for (int n = n_begin; n < n_end; ++n) {
            const size_t pn = (size_t)b * N + n;
            float dfbar[V], x[V], out[V];
            if constexpr (kLayer) {
                const float a = Ab[((size_t)b * L + i) * L + j];
#pragma unroll
                for (int k = 0; k < V; ++k) dfbar[k] = a * g[k];
            } else {
#pragma unroll
                for (int k = 0; k < V; ++k) dfbar[k] = 0.f;
            }
            for (int c = 0; c < C; ++c) {
                float t[V];
                load_vec<V>(dcut + (pn * C + c) * D + d, t);
#pragma unroll
                for (int k = 0; k < V; ++k) dfbar[k] += t[k];
            }
            load_vec<V>(fm + pn * D + d, x);
            float dm[V];
            if constexpr (kLayer) load_vec<V>(dmu + pn * D + d, dm);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                dfbar[k] = to_f(from_f<T>(dfbar[k]));
                const float z = x[k] * fsv[k];
                const float sg = sigmoidf_(z);
                const float t = sg * (1.f - sg);
                out[k] = dfbar[k] * (sg + z * t);
                if constexpr (kLayer) out[k] = dm[k] + out[k];
                acc[k] += dfbar[k] * x[k] * x[k] * t;
            }
            store_vec<V>(dfm + pn * D + d, out);
            if constexpr (kLayer) {
                if (++j == L && n + 1 < n_end) {
                    ++i;
                    j = i;
                    load_vec<V>(G + ((size_t)b * L + i) * D + d, g);
                }
            }
        }
    }
    store_vec<V>(part + ((size_t)split * gridDim.y + b) * D + d, acc);
}

// dfs[b, d] = sum over the splits, in order, of part[split, b, d] + sum_i
// dfs_b[b, i, d] (K3's boundary share; L 0 and dfs_b null for K10); the
// s_hat path of dfs is added by the caller's GEMM.
static __global__ void gate_dfs_kernel(int B, int L, int D, int splits,
                                       const float* __restrict__ part,
                                       const float* __restrict__ dfs_b, float* __restrict__ dfs) {
    const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (e >= (size_t)B * D) return;
    const size_t b = e / D;
    const int d = (int)(e % D);
    float acc = 0.f;
    for (int k = 0; k < splits; ++k) acc += part[(size_t)k * B * D + e];
    for (int i = 0; i < L; ++i) acc += dfs_b[(b * L + i) * D + d];
    dfs[e] = acc;
}

// Splits of an element's pairs for gate_bwd_kernel: about four blocks per SM
// in all, at most kGateMaxSplits, at most N. Mirrored in
// ops/content_cuda.py::gate_bwd_splits.
inline int gate_bwd_splits(int B, int N, int cols) {
    const long long col_blocks = (cols + kGateThreads - 1) / kGateThreads;
    long long splits = (4LL * 132 + B * col_blocks - 1) / (B * col_blocks);
    splits = splits < 1 ? 1 : (splits > kGateMaxSplits ? kGateMaxSplits : splits);
    return (int)(splits > N ? N : splits);
}

// Floats of gate_bwd_kernel's split partials for B elements of D columns.
inline size_t gate_part_floats(int B, int D) { return (size_t)kGateMaxSplits * B * D; }

// The gate's backward: dfm and dfs (fp32; the splits' and dfs_b's sums) from
// dcut over B elements of N pairs. kLayer (K3): with the boundary share A G
// over the packed map of L snippets and the residual dmu; else (K10) Ab, G,
// dmu and dfs_b are null and L is 0.
template <bool kLayer, typename T>
inline cudaError_t gate_backward(cudaStream_t st, int B, int N, int L, int C, int D,
                                 const T* fm, const T* fs, const T* dmu, const T* dcut,
                                 const float* Ab, const float* G, const float* dfs_b, T* dfm,
                                 float* part, float* dfs) {
    const bool vec = rows_vec4(D, {fm, fs, dmu, dcut, dfm}, 4 * sizeof(T));
    const int cols = vec ? D / 4 : D;
    const int splits = gate_bwd_splits(B, N, cols);
    const dim3 grid(splits * ((cols + kGateThreads - 1) / kGateThreads), B);
    if (vec)
        gate_bwd_kernel<4, T, kLayer><<<grid, kGateThreads, 0, st>>>(N, L, C, D, splits, fm, fs,
                                                                     dmu, dcut, Ab, G, dfm, part);
    else
        gate_bwd_kernel<1, T, kLayer><<<grid, kGateThreads, 0, st>>>(N, L, C, D, splits, fm, fs,
                                                                     dmu, dcut, Ab, G, dfm, part);
    VML_CHECK_LAUNCH();
    const size_t bd = (size_t)B * D;
    gate_dfs_kernel<<<(unsigned)((bd + 255) / 256), 256, 0, st>>>(B, kLayer ? L : 0, D, splits,
                                                                   part, dfs_b, dfs);
    return cudaGetLastError();
}

// The content backward's buffers beyond the recomputed forward's own, in
// the unit's element type T where the next products read them (dfcc, dq,
// dkhat, dfsh) and fp32 where the pair leaves sums that the projections add
// to (dh, dfwh) and for the pair's partials. dh_t and dfwh_t are those two
// gradients' totals as the last products read them: at fp32 dh and dfwh
// themselves (summed in place), at bf16 their one rounding.
template <typename T>
struct ContentBackwardScratchT {
    T *dfcc, *dq, *dkhat, *dfsh, *dh_t, *dfwh_t;
    float *dh, *part, *dfwh;
};
using ContentBackwardScratch = ContentBackwardScratchT<float>;
constexpr int kContentBackwardSlots = 9;

// Carves the slots of `w` out of the byte workspace `ws` from byte `off` on
// (ws null: only measure); returns the offset past them.
template <typename T>
inline size_t carve_content_backward(unsigned char* ws, size_t off, int B, int N, int C, int Nq,
                                     int dl, ContentBackwardScratchT<T>* w) {
    constexpr bool f32 = std::is_same<T, float>::value;
    const size_t rows = (size_t)B * N * C;
    const size_t BQ = (size_t)B * Nq;
    const size_t t = sizeof(T), f = sizeof(float);
    const size_t sizes[kContentBackwardSlots] = {
        t * rows * dl, t * rows * dl, t * BQ * dl, t * B * dl,   // dfcc, dq, dkhat, dfsh
        f32 ? 0 : t * rows * dl, f32 ? 0 : t * BQ * dl,          // dh_t, dfwh_t
        f * rows * dl, f * content_attn_partial_floats(B, N, C, Nq, dl, !f32), f * BQ * dl,
    };
    void* slots[kContentBackwardSlots];
    off = carve_bytes(ws, off, sizes, slots, kContentBackwardSlots);
    T** typed[6] = {&w->dfcc, &w->dq, &w->dkhat, &w->dfsh, &w->dh_t, &w->dfwh_t};
    for (int k = 0; k < 6; ++k) *typed[k] = static_cast<T*>(slots[k]);
    w->dh = static_cast<float*>(slots[6]);
    w->part = static_cast<float*>(slots[7]);
    w->dfwh = static_cast<float*>(slots[8]);
    if (f32) {
        w->dh_t = reinterpret_cast<T*>(w->dh);
        w->dfwh_t = reinterpret_cast<T*>(w->dfwh);
    }
    return off;
}

// The fp32 slots in a float workspace, from float `off` on; returns the
// offset past them in floats.
inline size_t carve_content_backward(float* ws, size_t off, int B, int N, int C, int Nq, int dl,
                                     ContentBackwardScratch* w) {
    return carve_content_backward<float>(reinterpret_cast<unsigned char*>(ws),
                                         off * sizeof(float), B, N, C, Nq, dl, w) /
           sizeof(float);
}

// Floats of the partial-sum buffer that `content_backward`'s split
// reductions (gemm_tn with its column sums) need.
inline size_t content_partial_floats(int B, int N, int C, int Nq, int D, int dl) {
    const int NC = N * C;
    const int shapes[][3] = {{D, dl, B * NC}, {dl, dl, B * NC}, {dl, dl, B * Nq},
                             {dl, D, B * Nq}, {dl, D, B}, {dl, D, B * NC}};
    size_t most = 0;
    for (const auto& s : shapes) {
        const size_t f = gemm_tn_partial_floats(s[0], s[1], s[2]);
        if (f > most) most = f;
    }
    return most;
}

// Backward of cu = c_out(fcc) * vm + fc + fbar from dcut (B*N*C, D), the
// total cotangent of cu, through the unit recomputed into `s` by
// `content_forward`, in its element type T: fills w (dh_t, dfwh_t and dfsh
// are the cotangents of the three projections' outputs, which
// `content_input_grads` pushes to the inputs) and the 12 fp32 weight
// gradients dw[0..11] in `content_forward`'s order of p (matrices of type T,
// biases fp32). The products: dfcc = (dcut Wco) * vm; dh_t = (dq Wcq + dh) *
// vm and dfwh_t = (dkhat Wck + dfwh) * qmask; the weight gradients dY^T X
// with the bias gradients the column sums of dY. Returns the first CUDA
// error of the launches.
template <typename T, typename P>
inline cudaError_t content_backward(cudaStream_t st, int B, int N, int C, int Nq, int D, int dl,
                                    const T* fc, const T* fw, const T* fs, const float* qmask,
                                    const float* vmask, const P* const* p,
                                    const LayerScratchT<T>& s, const ContentBackwardScratchT<T>& w,
                                    float* partial, const T* dcut, float* const* dw) {
    const int NC = N * C;
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    EpilogueOf<T> ep;
    ep.rmask = vmask;
    ep.mask_div = C;
    product_nn(st, B * NC, dl, D, dcut, D, W(6), dl, w.dfcc, dl, ep);
    VML_CHECK_LAUNCH();
    product_tn(st, D, dl, B * NC, dcut, D, vmask, C, s.fcc, dl, partial, dw[6], dw[7]);
    VML_CHECK_LAUNCH();
    cudaError_t err = content_attn_backward(st, B, N, C, Nq, dl, s.h, s.q, s.khat, s.fwh, s.fsh,
                                            qmask, vmask, w.dfcc, w.dh, w.dq, w.part, w.dfwh,
                                            w.dkhat, w.dfsh);
    if (err != cudaSuccess) return err;
    // attn_q: dh_t = (dq Wcq + dh) * vm.
    ep = EpilogueOf<T>();
    ep.pre = w.dh;
    ep.ldpre = dl;
    ep.rmask = vmask;
    ep.mask_div = C;
    product_nn(st, B * NC, dl, dl, w.dq, dl, W(8), dl, w.dh_t, dl, ep);
    VML_CHECK_LAUNCH();
    product_tn(st, dl, dl, B * NC, w.dq, dl, nullptr, 1, s.h, dl, partial, dw[8], dw[9]);
    VML_CHECK_LAUNCH();
    // attn_k: dfwh_t = (dkhat Wck + dfwh) * qmask.
    ep = EpilogueOf<T>();
    ep.pre = w.dfwh;
    ep.ldpre = dl;
    ep.rmask = qmask;
    product_nn(st, B * Nq, dl, dl, w.dkhat, dl, W(10), dl, w.dfwh_t, dl, ep);
    VML_CHECK_LAUNCH();
    product_tn(st, dl, dl, B * Nq, w.dkhat, dl, nullptr, 1, s.fwh, dl, partial, dw[10], dw[11]);
    VML_CHECK_LAUNCH();
    // w_hat, s_hat, c_hat weights.
    product_tn(st, dl, D, B * Nq, w.dfwh_t, dl, nullptr, 1, fw, D, partial, dw[2], dw[3]);
    VML_CHECK_LAUNCH();
    product_tn(st, dl, D, B, w.dfsh, dl, nullptr, 1, fs, D, partial, dw[4], dw[5]);
    VML_CHECK_LAUNCH();
    product_tn(st, dl, D, B * NC, w.dh_t, dl, nullptr, 1, fc, D, partial, dw[0], dw[1]);
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

// The unit's input gradients from what `content_backward` left in w, each
// rounded once to T: dfw = dfwh_t Wwh (+ dfw_acc), dfs = dfsh Wsh (+
// dfs_acc), dfc = dcut + dh_t Wch (dcut may be dfc itself: K3 and K7 keep
// dcut there; K10's dcut is its cotangent dcu). dfw_acc and dfs_acc (fp32,
// may be null) hold the other units' shares: K3 passes both (at fp32 dfw and
// dfs themselves, summed in place), K10 the gate's share of dfs, K7 none.
template <typename T, typename P>
inline cudaError_t content_input_grads(cudaStream_t st, int B, int N, int C, int Nq, int D,
                                       int dl, const P* const* p,
                                       const ContentBackwardScratchT<T>& w, const float* dfw_acc,
                                       const float* dfs_acc, const T* dcut, T* dfc, T* dfw,
                                       T* dfs) {
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    EpilogueOf<T> ep;
    add_f32(ep, dfw_acc, D);
    product_nn(st, B * Nq, D, dl, w.dfwh_t, dl, W(2), D, dfw, D, ep);
    VML_CHECK_LAUNCH();
    add_f32(ep, dfs_acc, D);
    product_nn(st, B, D, dl, w.dfsh, dl, W(4), D, dfs, D, ep);
    VML_CHECK_LAUNCH();
    ep = EpilogueOf<T>();
    ep.post = dcut;
    ep.ldpost = D;
    product_nn(st, B * N * C, D, dl, w.dh_t, dl, W(0), D, dfc, D, ep);
    VML_CHECK_LAUNCH();
    return cudaSuccess;
}

}  // namespace vml
