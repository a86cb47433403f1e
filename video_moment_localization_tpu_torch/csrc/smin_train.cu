// K2 and K3: one SMI layer of the training path, forward and backward; K9:
// all layers' forward from one entry point.
//
// Replaces ops/smin_train_pallas.py::_layer_fwd_call (`_fwd_kernel`, K2),
// ::_layer_bwd_call (`_bwd_kernel`, K3) and ::_stack_fwd_call
// (`_stack_fwd_kernel`, K9, the forward of `VML_SMIN_TRAIN_FUSED_FWD=1`) of
// the JAX package. K9 runs K2's device code for every layer in turn, writing
// each inner layer's carry (its input to the next layer, the carry K3
// recomputes from) to the caller's stacked buffers. K2 maps the
// carry (fc (B, N, C, D), fm (B, N, D), fb (B, L, D)) and the query features
// (fw (B, Nq, D), fs (B, D)) to (cu, mu, bu); K3 recomputes the layer from
// the same inputs and maps the cotangents (dcu or none, dmu, dbu) to dfc,
// dfm, dfb, dfw, dfs and the fp32 gradients of the layer's 10 weights and
// 10 biases. Rows are n-major (see smin_units.cuh).
//
// What bounds them on the H100: operations. A layer is about 324 MFLOP per
// element at the Charades shapes and its backward twice that on top of the
// recompute, against about 3 MB (K2) and 6 MB (K3) of carries moved per
// element. About 77 % of those operations are the projections, which run
// on the tensor cores as 3xTF32 (gemm.cuh: fp32-accurate, 165 TFLOP/s of
// fp32 products); the rest (attention, gate, boundary unit) is fp32 on the
// CUDA cores (67 TFLOP/s) or bound by its bytes. K2's moment unit is one
// product over [x1 | x2] (K = 2D, no intermediate written and read back),
// and its gate and moment prologue walk rows with 16-byte accesses
// (smin_units.cuh).
//
// Design. K2 is `vml::layer_forward`, the layer sequence the serving stack
// runs. The TPU backward kernel has no hand-written gradient (JAX takes the
// VJP of the layer body at trace time, in VMEM); here the gradient is
// derived by hand, unit by unit in reverse, as kernels that each own what
// they write, so nothing is accumulated with atomics and a run is
// deterministic:
//
//   MomentUnit  mu = (conv_fb(x1) + conv_fc(x2)) * vm + fm, x1[n] = bu[i_n] *
//     bu[j_n], x2[n] = mean_c cu[n, c]. With dz = dmu * vm: dx1 = dz Wfb,
//     dx2 = dz Wfc (one nn product, the mask on its rows); G[i] = dbu[i] +
//     sum_{n: i_n = i} dx1[n] bu[j_n] + sum_{n: j_n = i} dx1[n] bu[i_n]
//     (moment_bwd_kernel gathers per snippet row; the pair (i, i) counts in
//     both sums); dcut[n, c] = dcu[n, c] + dx2[n] / C (dcu_total_kernel; a
//     null dcu is the top layer's zero cotangent); dfm = dmu.
//   ContentUnit  cu = c_out(fcc) * vm + fc + fbar. dfcc = (dcut * vm) Wco.
//     content_attn_bwd_kernel (content_attn.cuh; a block per tile of an
//     element's pairs) recomputes the word attention p, f_cq = g and the
//     clip attention P in shared memory and backpropagates fcc = (P * vm) h,
//     P = softmax(g g^T / sqrt(dl)) (g enters twice), g = h * (a * vm +
//     fsh), a = p fwh, p = softmax of the -1e9-masked q khat^T / sqrt(dl) (no
//     gradient through a masked logit): it writes dh (the A and g paths) and
//     dq, and sums dfwh[m] = sum_rows p[r, m] da[r], dkhat[m] = sum_rows
//     ds[r, m] q[r] and dfsh = sum_rows dg[r] h[r] over its tile's rows;
//     content_partial_reduce_kernel adds the tiles' partials in order. Then
//     the projections: dh += dq Wcq, masked by vm; dfwh += dkhat Wck, masked
//     by qmask; dfc = dcut + dh Wch; dfw += dfwh Wwh; dfs += dfsh Wsh.
//   BoundaryUnit  bu[i] = (A[i] fb) * lm[i] + fb[i] + sum_{j >= i} A[i, j]
//     fbar[(i, j)], A = softmax_j(fbq fbq^T / sqrt(D), -1e9 on invalid j) *
//     lm[i], fbq[i] = fb[i] * (a[i] * lm[i] + fs), a = p fw.
//     boundary_attn_bwd_kernel (one block per snippet row) writes A and the
//     logit gradients dS; boundary_query_bwd_kernel turns them into dfbq[i] =
//     sum_j (dS[i, j] + dS[j, i]) fbq[j], the direct part of dfb, da, the
//     row's share of dfs and the word-logit gradients; boundary_proj_bwd_kernel
//     reduces dbq, dbk and the value-path share of dfw over rows / words;
//     then dfb += dbq Wbq, dfw += dbk Wbk.
//   Gate  fbar = sigmoid(fm * fs) * fm, dfbar[n] = A[i_n, j_n] G[i_n] +
//     sum_c dcut[n, c]. gate_bwd_kernel (a thread per 4 columns of an
//     element and a split of its pairs) writes dfm and its split's share of
//     dfs; gate_dfs_kernel adds the splits in order.
//   The ContentUnit's kernels and their sequence are in content_bwd.cuh,
//   shared with the content-unit backward of content_train.cu.
//   Weight gradients dW = dY^T X (gemm_tn) reduce over up to B * N * C rows
//     in split blocks whose partial sums a second kernel adds in a fixed
//     order; bias gradients are the column sums of dY that the same gemm_tn
//     pass adds up (its blocks of the first column tile).
//
// The bf16 variants (K2-bf16, K3-bf16, K9-bf16: the training path at bf16,
// the JAX layer kernels at their production dtype) run the same sequences
// on bf16 activations and cotangents: K2-bf16 is `layer_forward<bf16>`,
// K4-bf16's layer, and K9-bf16 runs it per layer as K9 runs K2's; K3-bf16
// recomputes the layer as K2-bf16 does, then the kernels above, templated
// on the element type (fp32 arithmetic inside), with the products on
// gemm.cuh's bf16 path (its nn and tn layouts: bf16 operands, fp32 sums,
// the weight gradients fp32). Its plain version is autograd
// through models/smin.py::smi_layer_bf16, and it rounds where that rounds:
// the gradient of each stored bf16 value is the fp32 sum over its uses,
// rounded once to bf16 where it is stored or before it is used (dx1 and dx2,
// dcut, dfcc, dq, dkhat and dfsh, dfbq, dbq and dbk, dfbar); a sum that later
// terms add to stays fp32 until its last product rounds it (dh, dfwh and
// the inputs' dfb, dfw, dfs); for cu and bu, which are outputs as well,
// the outer cotangent is added to the rounded inner gradient and the sum
// rounded again, as autograd adds them. The dtype does not change what
// bounds them: operations, now of bf16 products at 989 TFLOP/s.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "content_bwd.cuh"
#include "smin_units.cuh"

namespace {

using vml::bf16;
using vml::from_f;
using vml::kNegInf;
using vml::pair_index;
using vml::to_f;
using vml::warp_sum;

// A gradient of a stored value rounded as it is stored: to bf16 and back for
// the bf16 variant, nothing at fp32.
template <typename T>
__device__ __forceinline__ float stored(float x) {
    return to_f(from_f<T>(x));
}

// grid B * L. G[i] = dbu[i] + sum_{j >= i} dx1[(i, j)] * bu[j]
//                          + sum_{k <= i} dx1[(k, i)] * bu[k].
// T: the type of dbu, dx1 and bu; G is fp32. At bf16 the sums over the
// pairs (bu's gradient inside the layer) are rounded to bf16 before dbu
// (its gradient from outside) is added, and G is rounded again: bu is a
// stored bf16 value that its layer also reads.
template <typename T>
__global__ void moment_bwd_kernel(int L, int D, const T* __restrict__ dbu,
                                  const T* __restrict__ dx1,
                                  const T* __restrict__ bu, float* __restrict__ G) {
    constexpr bool f32 = std::is_same<T, float>::value;
    const int N = L * (L + 1) / 2;
    const int row = blockIdx.x;   // b * L + i
    const int b = row / L;
    const int i = row % L;
    const T* bue = bu + (size_t)b * L * D;
    const T* dxe = dx1 + (size_t)b * N * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float acc = f32 ? to_f(dbu[(size_t)row * D + d]) : 0.f;
        for (int j = i; j < L; ++j)
            acc += to_f(dxe[(size_t)pair_index(i, j, L) * D + d]) * to_f(bue[(size_t)j * D + d]);
        for (int k = 0; k <= i; ++k)
            acc += to_f(dxe[(size_t)pair_index(k, i, L) * D + d]) * to_f(bue[(size_t)k * D + d]);
        if (!f32) acc = stored<T>(to_f(dbu[(size_t)row * D + d]) + stored<T>(acc));
        G[(size_t)row * D + d] = acc;
    }
}

// grid B * L, one block per snippet row i: recomputes the boundary attention
// row P[i] and writes A[i, j] = P[i, j] * lm[i] (B, L, L) and the logit
// gradients dS[i, j] (B, L, L; 0 at a masked key j), from
//   dA[i, j] = lm[i] * (G[i] . fb[j]) + [j >= i] G[i] . fbar[(i, j)].
// T: the type of fbq, fb and fbar.
template <typename T>
__global__ void boundary_attn_bwd_kernel(int L, int D, const T* __restrict__ fbq,
                                         const T* __restrict__ fb,
                                         const T* __restrict__ fbar,
                                         const float* __restrict__ lmask,
                                         const float* __restrict__ G, float* __restrict__ Ab,
                                         float* __restrict__ dSb) {
    extern __shared__ float smem[];
    float* P = smem;                  // (L,)
    float* dA = smem + L;             // (L,)
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int i = row % L;
    const int N = L * (L + 1) / 2;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int nwarps = blockDim.x / 32;
    const float inv_sd = 1.f / sqrtf((float)D);
    const float* lm = lmask + (size_t)b * L;
    const T* x = fbq + (size_t)row * D;
    const float* g = G + (size_t)row * D;

    for (int j = warp; j < L; j += nwarps) {
        const T* y = fbq + ((size_t)b * L + j) * D;
        const T* fbj = fb + ((size_t)b * L + j) * D;
        const T* fbar_ij = j >= i ? fbar + ((size_t)b * N + pair_index(i, j, L)) * D : nullptr;
        float s = 0.f, t = 0.f, u = 0.f;
        for (int d = lane; d < D; d += 32) {
            s += to_f(x[d]) * to_f(y[d]);
            t += g[d] * to_f(fbj[d]);
            if (fbar_ij) u += g[d] * to_f(fbar_ij[d]);
        }
        s = warp_sum(s);
        t = warp_sum(t);
        u = warp_sum(u);
        if (lane == 0) {
            P[j] = lm[j] > 0.f ? s * inv_sd : kNegInf;
            dA[j] = lm[i] * t + u;
        }
    }
    __syncthreads();
    if (tid == 0) {
        float mx = P[0];
        for (int j = 1; j < L; ++j) mx = fmaxf(mx, P[j]);
        float sum = 0.f;
        for (int j = 0; j < L; ++j) {
            P[j] = expf(P[j] - mx);
            sum += P[j];
        }
        float dot = 0.f;
        for (int j = 0; j < L; ++j) {
            P[j] /= sum;
            dA[j] *= lm[i];              // dP = dA * lm[i]
            dot += P[j] * dA[j];
        }
        for (int j = 0; j < L; ++j) {
            Ab[(size_t)row * L + j] = P[j] * lm[i];
            dSb[(size_t)row * L + j] = lm[j] > 0.f ? P[j] * (dA[j] - dot) * inv_sd : 0.f;
        }
    }
}

// grid B * L, one block per snippet row i: dfbq[i] = sum_j (dS[i, j] +
// dS[j, i]) fbq[j], then through fbq[i] = fb[i] * (a[i] * lm[i] + fs):
//   dfb[i]   = G[i] + sum_j A[j, i] lm[j] G[j] + dfbq[i] * (a[i] lm[i] + fs)
//              (the attn_q path is added by the caller's GEMM)
//   da[i]    = dfbq[i] * fb[i] * lm[i];   dfs_b[i] = dfbq[i] * fb[i]
// and through the word attention a[i] = p[i] fw: p (B, L, Nq) and the logit
// gradients ds (B, L, Nq; 0 at a masked word). T: the type of bq, bk, fw,
// fb, fs and fbq; at bf16 dfbq (the gradient of the stored fbq) is rounded
// to bf16 before it is used. dfb, da, dfs_b are fp32 at either type.
template <typename T>
__global__ void boundary_query_bwd_kernel(
    int L, int Nq, int D, const T* __restrict__ bq, const T* __restrict__ bk,
    const T* __restrict__ fw, const T* __restrict__ fb, const T* __restrict__ fs,
    const T* __restrict__ fbq, const float* __restrict__ qmask,
    const float* __restrict__ lmask, const float* __restrict__ G,
    const float* __restrict__ Ab, const float* __restrict__ dSb, float* __restrict__ dfb,
    float* __restrict__ dab, float* __restrict__ dfs_b, float* __restrict__ pb,
    float* __restrict__ dsb) {
    extern __shared__ float smem[];
    float* p = smem;                  // (Nq,)
    float* dp = p + Nq;               // (Nq,)
    float* coef = dp + Nq;            // (L,): dS[i, j] + dS[j, i]
    float* coefA = coef + L;          // (L,): A[j, i] * lm[j]
    float* darow = coefA + L;         // (D,)
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int i = row % L;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int nwarps = blockDim.x / 32;
    const float inv_sd = 1.f / sqrtf((float)D);
    const T* x = bq + (size_t)row * D;
    const T* fwe = fw + (size_t)b * Nq * D;
    const float lm = lmask[row];

    for (int m = warp; m < Nq; m += nwarps) {
        const T* y = bk + ((size_t)b * Nq + m) * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += to_f(x[d]) * to_f(y[d]);
        s = warp_sum(s);
        if (lane == 0) p[m] = qmask[(size_t)b * Nq + m] > 0.f ? s * inv_sd : kNegInf;
    }
    for (int j = tid; j < L; j += blockDim.x) {
        coef[j] = dSb[(size_t)row * L + j] + dSb[((size_t)b * L + j) * L + i];
        coefA[j] = Ab[((size_t)b * L + j) * L + i] * lmask[(size_t)b * L + j];
    }
    __syncthreads();
    if (tid == 0) {
        float mx = p[0];
        for (int m = 1; m < Nq; ++m) mx = fmaxf(mx, p[m]);
        float sum = 0.f;
        for (int m = 0; m < Nq; ++m) {
            p[m] = expf(p[m] - mx);
            sum += p[m];
        }
        for (int m = 0; m < Nq; ++m) p[m] /= sum;
    }
    __syncthreads();
    for (int d = tid; d < D; d += blockDim.x) {
        float dfbq = 0.f, gsum = G[(size_t)row * D + d];
        for (int j = 0; j < L; ++j) {
            dfbq += coef[j] * to_f(fbq[((size_t)b * L + j) * D + d]);
            gsum += coefA[j] * G[((size_t)b * L + j) * D + d];
        }
        dfbq = stored<T>(dfbq);
        float a = 0.f;
        for (int m = 0; m < Nq; ++m) a += p[m] * to_f(fwe[(size_t)m * D + d]);
        const float fbv = to_f(fb[(size_t)row * D + d]);
        const float dav = dfbq * fbv * lm;
        darow[d] = dav;
        dfb[(size_t)row * D + d] = gsum + dfbq * (a * lm + to_f(fs[(size_t)b * D + d]));
        dab[(size_t)row * D + d] = dav;
        dfs_b[(size_t)row * D + d] = dfbq * fbv;
    }
    __syncthreads();
    for (int m = warp; m < Nq; m += nwarps) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += darow[d] * to_f(fwe[(size_t)m * D + d]);
        s = warp_sum(s);
        if (lane == 0) dp[m] = s;
    }
    __syncthreads();
    if (tid == 0) {
        float dot = 0.f;
        for (int m = 0; m < Nq; ++m) dot += p[m] * dp[m];
        for (int m = 0; m < Nq; ++m) {
            pb[(size_t)row * Nq + m] = p[m];
            dsb[(size_t)row * Nq + m] =
                qmask[(size_t)b * Nq + m] > 0.f ? p[m] * (dp[m] - dot) * inv_sd : 0.f;
        }
    }
}

// grid B * (L + Nq): block (b, i < L) writes dbq[i] = sum_m ds[i, m] bk[m];
// block (b, L + m) writes dbk[m] = sum_i ds[i, m] bq[i] and the value-path
// share of dfw[m] = sum_i p[i, m] da[i]. T: the type of bq, bk, dbq and dbk
// (the operands of the next products; dfw is fp32).
template <typename T>
__global__ void boundary_proj_bwd_kernel(int L, int Nq, int D, const float* __restrict__ dsb,
                                         const float* __restrict__ pb,
                                         const float* __restrict__ dab,
                                         const T* __restrict__ bq,
                                         const T* __restrict__ bk,
                                         T* __restrict__ dbq, T* __restrict__ dbk,
                                         float* __restrict__ dfw) {
    const int b = blockIdx.x / (L + Nq);
    const int r = blockIdx.x % (L + Nq);
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        if (r < L) {
            float s = 0.f;
            for (int m = 0; m < Nq; ++m)
                s += dsb[((size_t)b * L + r) * Nq + m] * to_f(bk[((size_t)b * Nq + m) * D + d]);
            dbq[((size_t)b * L + r) * D + d] = from_f<T>(s);
        } else {
            const int m = r - L;
            float s1 = 0.f, s2 = 0.f;
            for (int i = 0; i < L; ++i) {
                const size_t row = (size_t)b * L + i;
                s1 += dsb[row * Nq + m] * to_f(bq[row * D + d]);
                s2 += pb[row * Nq + m] * dab[row * D + d];
            }
            dbk[((size_t)b * Nq + m) * D + d] = from_f<T>(s1);
            dfw[((size_t)b * Nq + m) * D + d] = s2;
        }
    }
}

// The gate's backward over an element's pairs, split along the pairs so
// that the card fills (`gate_bwd_splits`): block (column block, split) of
// element b gives a thread V consecutive columns d (16-byte loads when V is
// 4) and the pairs [n_begin, n_end) of its split, in order:
//   dfbar[n] = A[i_n, j_n] * G[i_n] + sum_c dcut[n, c]
//   dfm[n]   = dmu[n] + dfbar[n] * (s + z * s * (1 - s)),  z = fm * fs,
//                                                          s = sigmoid(z)
// and writes its split's share of dfs, sum_n dfbar[n] * fm[n]^2 * s * (1 -
// s), to part[split, b]; gate_dfs_kernel adds the splits in order. T: the
// type of fm, fs, dmu, dcut and dfm; at bf16 dfbar (the gradient of the
// stored fbar) is rounded to bf16 before it is used.
constexpr int kGateThreads = 128;
constexpr int kGateMaxSplits = 32;

template <int V, typename T>
__global__ void __launch_bounds__(kGateThreads) gate_bwd_kernel(
    int L, int C, int D, int splits, const T* __restrict__ fm, const T* __restrict__ fs,
    const T* __restrict__ dmu, const T* __restrict__ dcut, const float* __restrict__ Ab,
    const float* __restrict__ G, T* __restrict__ dfm, float* __restrict__ part) {
    const int N = L * (L + 1) / 2;
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
    vml::load_vec<V>(fs + (size_t)b * D + d, fsv);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    if (n_begin < n_end) {
        int i, j;
        vml::pair_of(n_begin, L, i, j);
        float g[V];
        vml::load_vec<V>(G + ((size_t)b * L + i) * D + d, g);
        for (int n = n_begin; n < n_end; ++n) {
            const size_t pn = (size_t)b * N + n;
            const float a = Ab[((size_t)b * L + i) * L + j];
            float dfbar[V], x[V], dm[V], out[V];
#pragma unroll
            for (int k = 0; k < V; ++k) dfbar[k] = a * g[k];
            for (int c = 0; c < C; ++c) {
                float t[V];
                vml::load_vec<V>(dcut + (pn * C + c) * D + d, t);
#pragma unroll
                for (int k = 0; k < V; ++k) dfbar[k] += t[k];
            }
            vml::load_vec<V>(fm + pn * D + d, x);
            vml::load_vec<V>(dmu + pn * D + d, dm);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                dfbar[k] = stored<T>(dfbar[k]);
                const float z = x[k] * fsv[k];
                const float sg = vml::sigmoidf_(z);
                const float t = sg * (1.f - sg);
                out[k] = dm[k] + dfbar[k] * (sg + z * t);
                acc[k] += dfbar[k] * x[k] * x[k] * t;
            }
            vml::store_vec<V>(dfm + pn * D + d, out);
            if (++j == L && n + 1 < n_end) {
                ++i;
                j = i;
                vml::load_vec<V>(G + ((size_t)b * L + i) * D + d, g);
            }
        }
    }
    vml::store_vec<V>(part + ((size_t)split * gridDim.y + b) * D + d, acc);
}

// dfs[b, d] = sum over the splits, in order, of part[split, b, d] + sum_i
// dfs_b[b, i, d] (the s_hat path of dfs is added by the caller's GEMM).
__global__ void gate_dfs_kernel(int B, int L, int D, int splits, const float* __restrict__ part,
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
// in all, at most kGateMaxSplits, at most N.
int gate_bwd_splits(int B, int N, int cols) {
    const long long col_blocks = (cols + kGateThreads - 1) / kGateThreads;
    long long splits = (4LL * 132 + B * col_blocks - 1) / (B * col_blocks);
    splits = splits < 1 ? 1 : (splits > kGateMaxSplits ? kGateMaxSplits : splits);
    return (int)(splits > N ? N : splits);
}

// The backward's buffers beyond the recomputed layer's own intermediates,
// in the layer's element type T where they are stored activations'
// gradients that the next products read (bu, dx1, dx2, dbq, dbk), fp32 where
// they are sums that later terms add to (G and the boundary unit's softmax
// terms). At bf16, dfb32, dfw32 and dfs32 hold dfb, dfw and dfs in fp32
// until their last product's epilogue rounds them once; at fp32 they are
// not carved (`vml::f32_sum`: the gradients sum in place).
template <typename T>
struct BackwardScratchT {
    vml::ContentBackwardScratchT<T> c;
    T *bu, *dx1, *dx2, *dbq, *dbk;
    float *G, *Ab, *dSb, *pb, *dsb, *dab, *dfs_b, *gate_part, *partial, *dfb32, *dfw32, *dfs32;
};
constexpr int kBackwardSlots = 17;

size_t max_partial_floats(int B, int L, int C, int Nq, int D, int dl) {
    const int N = L * (L + 1) / 2;
    const int shapes[][3] = {{D, D, B * N}, {D, D, B * L}, {D, D, B * Nq}};
    size_t most = vml::content_partial_floats(B, N, C, Nq, D, dl);
    for (const auto& s : shapes) {
        const size_t f = vml::gemm_tn_partial_floats(s[0], s[1], s[2]);
        if (f > most) most = f;
    }
    return most;
}

// Carves the layer's scratch and (backward) these buffers out of the byte
// workspace `ws` (null: only measure); returns its size in bytes.
template <typename T>
size_t carve(unsigned char* ws, int B, int L, int C, int Nq, int D, int dl, bool backward,
             vml::LayerScratchT<T>* s, BackwardScratchT<T>* w) {
    size_t off = vml::carve_layer_scratch<T>(ws, 0, B, L, C, Nq, D, dl, s);
    if (!backward) return off;
    constexpr bool f32 = std::is_same<T, float>::value;
    const size_t N = (size_t)L * (L + 1) / 2;
    const size_t BL = (size_t)B * L, BQ = (size_t)B * Nq;
    const size_t t = sizeof(T), f = sizeof(float);
    off = vml::carve_content_backward<T>(ws, off, B, (int)N, C, Nq, dl, &w->c);
    const size_t sizes[kBackwardSlots] = {
        t * BL * D, t * B * N * D, t * B * N * D, t * BL * D, t * BQ * D,   // bu dx1 dx2 dbq dbk
        f * BL * D, f * BL * L, f * BL * L, f * BL * Nq, f * BL * Nq,       // G Ab dSb pb dsb
        f * BL * D, f * BL * D,                                             // dab dfs_b
        f * kGateMaxSplits * B * D,                                         // gate_part
        f * max_partial_floats(B, L, C, Nq, D, dl),                         // partial
        f32 ? 0 : f * BL * D, f32 ? 0 : f * BQ * D, f32 ? 0 : f * B * D,    // dfb32 dfw32 dfs32
    };
    void* slots[kBackwardSlots];
    off = vml::carve_bytes(ws, off, sizes, slots, kBackwardSlots);
    T** typed[5] = {&w->bu, &w->dx1, &w->dx2, &w->dbq, &w->dbk};
    for (int k = 0; k < 5; ++k) *typed[k] = static_cast<T*>(slots[k]);
    float** full[12] = {&w->G, &w->Ab, &w->dSb, &w->pb, &w->dsb, &w->dab, &w->dfs_b,
                        &w->gate_part, &w->partial, &w->dfb32, &w->dfw32, &w->dfs32};
    for (int k = 0; k < 12; ++k) *full[k] = static_cast<float*>(slots[5 + k]);
    return off;
}

size_t boundary_query_bwd_smem_bytes(int L, int Nq, int D) {
    return sizeof(float) * ((size_t)2 * Nq + (size_t)2 * L + D);
}

// K3 in the layer's element type T (fp32, or bf16 for K3-bf16): recompute
// the layer as K2 computes it, then the backward sequence above with
// gemm.cuh's products of T (fp32 sums at either type); the gradient of
// every stored value of type T rounded to T once, as it is stored, before it
// is used; the 20 weight gradients fp32 (dw), reduced over the rows in a
// fixed order. dcu may be null (the zero cotangent of a top layer). p: the
// layer's 20 device pointers in vml::layer_forward's order (matrices of
// type T, biases fp32). dfc doubles as the recompute's cu buffer before it
// is written. Returns the first CUDA error of the launches, 0 if none.
template <typename T, typename P>
int layer_backward(cudaStream_t st, int B, int L, int C, int Nq, int D, int dl, const T* fc,
                   const T* fm, const T* fb, const T* fw, const T* fs, const float* qmask,
                   const float* lmask, const float* vmask, const P* const* p, const T* dcu,
                   const T* dmu, const T* dbu, unsigned char* ws, T* dfc, T* dfm, T* dfb,
                   T* dfw, T* dfs, float* const* dw) {
    const int N = L * (L + 1) / 2;
    const int NC = N * C;
    vml::LayerScratchT<T> s;
    BackwardScratchT<T> w;
    carve(ws, B, L, C, Nq, D, dl, true, &s, &w);
    auto W = [p](int k) { return static_cast<const T*>(p[k]); };
    float* dfb32 = vml::f32_sum(dfb, w.dfb32);
    float* dfw32 = vml::f32_sum(dfw, w.dfw32);
    float* dfs32 = vml::f32_sum(dfs, w.dfs32);
    cudaError_t err;
#define VML_CHECK()                                                     \
    do {                                                                \
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err; \
    } while (0)
    vml::EpilogueOf<T> ep;

    // Recompute the layer; cu goes to dfc (only x2 = mean_c cu is kept).
    err = vml::layer_forward(st, B, L, C, Nq, D, dl, fc, fm, fb, fw, fs, qmask, lmask, vmask, p,
                             s, dfc, static_cast<T*>(nullptr), w.bu);
    if (err != cudaSuccess) return (int)err;

    // MomentUnit: [dx1 | dx2] = (dmu [W_fb | W_fc]) * vm.
    ep.rmask = vmask;
    vml::product_nn2(st, B * N, D, D, dmu, D, W(16), W(18), D, w.dx1, w.dx2, D, ep);
    VML_CHECK();
    // x1 and x2 are the two halves of the forward's [x1 | x2] (B * N, 2D).
    vml::product_tn(st, D, D, B * N, dmu, D, vmask, 1, s.x12, 2 * D, w.partial, dw[16], dw[17]);
    VML_CHECK();
    vml::product_tn(st, D, D, B * N, dmu, D, vmask, 1, s.x12 + D, 2 * D, w.partial, dw[18]);
    VML_CHECK();
    if ((err = cudaMemcpyAsync(dw[19], dw[17], sizeof(float) * D, cudaMemcpyDeviceToDevice,
                               st)) != cudaSuccess)
        return (int)err;
    moment_bwd_kernel<T><<<B * L, 128, 0, st>>>(L, D, dbu, w.dx1, w.bu, w.G);
    VML_CHECK();
    const size_t ncd = (size_t)B * NC * D;
    const int dcu_blocks = (int)((ncd + 255) / 256 < 8192 ? (ncd + 255) / 256 : 8192);
    vml::dcu_total_kernel<T><<<dcu_blocks, 256, 0, st>>>(ncd, C, D, dcu, w.dx2, dfc);
    VML_CHECK();

    // ContentUnit. dfc holds dcut from here to the last product.
    err = vml::content_backward(st, B, N, C, Nq, D, dl, fc, fw, fs, qmask, vmask, p, s, w.c,
                                w.partial, dfc, dw);
    if (err != cudaSuccess) return (int)err;

    // BoundaryUnit: dfb32 and dfw32 gather their shares in fp32.
    boundary_attn_bwd_kernel<T><<<B * L, 128, 2 * L * sizeof(float), st>>>(
        L, D, s.fbq, fb, s.fbar, lmask, w.G, w.Ab, w.dSb);
    VML_CHECK();
    boundary_query_bwd_kernel<T><<<B * L, 128, boundary_query_bwd_smem_bytes(L, Nq, D), st>>>(
        L, Nq, D, s.bq, s.bk, fw, fb, fs, s.fbq, qmask, lmask, w.G, w.Ab, w.dSb, dfb32, w.dab,
        w.dfs_b, w.pb, w.dsb);
    VML_CHECK();
    boundary_proj_bwd_kernel<T><<<B * (L + Nq), 128, 0, st>>>(
        L, Nq, D, w.dsb, w.pb, w.dab, s.bq, s.bk, w.dbq, w.dbk, dfw32);
    VML_CHECK();
    ep = vml::EpilogueOf<T>();
    vml::add_f32(ep, dfb32, D);
    vml::product_nn(st, B * L, D, D, w.dbq, D, W(12), D, dfb, D, ep);
    VML_CHECK();
    vml::add_f32(ep, dfw32, D);
    vml::product_nn(st, B * Nq, D, D, w.dbk, D, W(14), D, dfw32, D, ep);
    VML_CHECK();
    vml::product_tn(st, D, D, B * L, w.dbq, D, nullptr, 1, fb, D, w.partial, dw[12], dw[13]);
    VML_CHECK();
    vml::product_tn(st, D, D, B * Nq, w.dbk, D, nullptr, 1, fw, D, w.partial, dw[14], dw[15]);
    VML_CHECK();

    // Gate (reads dcut from dfc), then the content unit's shares of dfw and
    // dfs, and dfc = dcut + dh_t Wch.
    {
        const bool vec = vml::rows_vec4(D, {fm, fs, dmu, dfc, dfm}, 4 * sizeof(T));
        const int cols = vec ? D / 4 : D;
        const int splits = gate_bwd_splits(B, N, cols);
        const dim3 grid(splits * ((cols + kGateThreads - 1) / kGateThreads), B);
        if (vec)
            gate_bwd_kernel<4, T><<<grid, kGateThreads, 0, st>>>(
                L, C, D, splits, fm, fs, dmu, dfc, w.Ab, w.G, dfm, w.gate_part);
        else
            gate_bwd_kernel<1, T><<<grid, kGateThreads, 0, st>>>(
                L, C, D, splits, fm, fs, dmu, dfc, w.Ab, w.G, dfm, w.gate_part);
        VML_CHECK();
        const size_t bd = (size_t)B * D;
        gate_dfs_kernel<<<(unsigned)((bd + 255) / 256), 256, 0, st>>>(B, L, D, splits,
                                                                       w.gate_part, w.dfs_b,
                                                                       dfs32);
        VML_CHECK();
    }
    err = vml::content_input_grads(st, B, N, C, Nq, D, dl, p, w.c, dfw32, dfs32, dfc, dfw, dfs);
#undef VML_CHECK
    return (int)err;
}

// K9's layer loop at either element type: layer k reads the carry that
// layer k - 1 wrote (into carry_* for the inner layers) and writes its own,
// all through one workspace carved once, exactly as one K2 launch per layer.
template <typename T, typename P>
int stack_forward(cudaStream_t st, int B, int L, int C, int Nq, int D, int dl, int n_layers,
                  const T* fc, const T* fm, const T* fb, const T* fw, const T* fs,
                  const float* qmask, const float* lmask, const float* vmask, const P* const* p,
                  unsigned char* ws, T* carry_fc, T* carry_fm, T* carry_fb, T* cu_last,
                  T* fm_out, T* fb_out) {
    const size_t N = (size_t)L * (L + 1) / 2;
    const size_t nc = (size_t)B * N * C * D, nm = (size_t)B * N * D, nb = (size_t)B * L * D;
    vml::LayerScratchT<T> s;
    BackwardScratchT<T> unused;
    carve(ws, B, L, C, Nq, D, dl, false, &s, &unused);
    for (int k = 0; k < n_layers; ++k) {
        const bool top = k == n_layers - 1;
        T* cu = top ? cu_last : carry_fc + k * nc;
        T* mu = top ? fm_out : carry_fm + k * nm;
        T* bu = top ? fb_out : carry_fb + k * nb;
        cudaError_t err = vml::layer_forward(st, B, L, C, Nq, D, dl, fc, fm, fb, fw, fs, qmask,
                                             lmask, vmask, p + (size_t)k * vml::kWeightsPerLayer,
                                             s, cu, mu, bu);
        if (err != cudaSuccess) return (int)err;
        fc = cu;
        fm = mu;
        fb = bu;
    }
    return 0;
}

}  // namespace

extern "C" {

size_t vml_smi_layer_workspace_floats(int B, int L, int C, int Nq, int D, int dl,
                                      int backward) {
    vml::LayerScratch s;
    BackwardScratchT<float> w;
    return carve<float>(nullptr, B, L, C, Nq, D, dl, backward != 0, &s, &w) / sizeof(float);
}

// Largest dynamic shared memory of the forward and backward kernels, for the
// wrapper's admission check against the 227 KB a block may have.
size_t vml_smi_layer_smem_bytes(int L, int C, int Nq, int D, int dl) {
    size_t most = vml::layer_forward_smem_bytes(L, C, Nq, dl);
    const size_t others[] = {vml::content_attn_smem_bytes(L * (L + 1) / 2, C, Nq, dl, true),
                             boundary_query_bwd_smem_bytes(L, Nq, D)};
    for (size_t o : others)
        if (o > most) most = o;
    return most;
}

// K2. layer_w: host array of the layer's 20 device pointers in the order of
// vml::layer_forward. Returns the first CUDA error of the launches, 0 if none.
int vml_smi_layer_fwd_f32(void* stream, int B, int L, int C, int Nq, int D, int dl,
                          const float* fc, const float* fm, const float* fb, const float* fw,
                          const float* fs, const float* qmask, const float* lmask,
                          const float* vmask, const float* const* layer_w, float* ws,
                          float* cu, float* mu, float* bu) {
    vml::LayerScratch s;
    BackwardScratchT<float> unused;
    carve(reinterpret_cast<unsigned char*>(ws), B, L, C, Nq, D, dl, false, &s, &unused);
    return (int)vml::layer_forward(static_cast<cudaStream_t>(stream), B, L, C, Nq, D, dl, fc,
                                   fm, fb, fw, fs, qmask, lmask, vmask, layer_w, s, cu, mu,
                                   bu);
}

// K9. p: host array of n_layers * 20 device pointers, each layer's in the
// order of vml::layer_forward. carry_fc (n_layers - 1, B, N, C, D),
// carry_fm (n_layers - 1, B, N, D), carry_fb (n_layers - 1, B, L, D) receive
// layers 1 .. n_layers - 1's input carries (null when n_layers is 1); cu_last
// (B, N, C, D) receives the top layer's unused cu; fm_out, fb_out its mu, bu.
// ws: vml_smi_layer_workspace_floats(..., 0) floats, shared by the layers.
// Each layer is exactly a K2 launch: the same kernels in the same order.
int vml_smi_stack_fwd_f32(void* stream, int B, int L, int C, int Nq, int D, int dl,
                          int n_layers, const float* fc, const float* fm, const float* fb,
                          const float* fw, const float* fs, const float* qmask,
                          const float* lmask, const float* vmask, const float* const* p,
                          float* ws, float* carry_fc, float* carry_fm, float* carry_fb,
                          float* cu_last, float* fm_out, float* fb_out) {
    return stack_forward(static_cast<cudaStream_t>(stream), B, L, C, Nq, D, dl, n_layers, fc,
                         fm, fb, fw, fs, qmask, lmask, vmask, p,
                         reinterpret_cast<unsigned char*>(ws), carry_fc, carry_fm, carry_fb,
                         cu_last, fm_out, fb_out);
}

// K3. dcu may be null (the zero cotangent of a top layer). dw: host array of
// 20 device pointers to the weight-gradient outputs, in layer_w's order.
// dfc doubles as the recompute's cu buffer before it is written.
int vml_smi_layer_bwd_f32(void* stream, int B, int L, int C, int Nq, int D, int dl,
                          const float* fc, const float* fm, const float* fb, const float* fw,
                          const float* fs, const float* qmask, const float* lmask,
                          const float* vmask, const float* const* p, const float* dcu,
                          const float* dmu, const float* dbu, float* ws, float* dfc,
                          float* dfm, float* dfb, float* dfw, float* dfs, float* const* dw) {
    return layer_backward(static_cast<cudaStream_t>(stream), B, L, C, Nq, D, dl, fc, fm, fb, fw,
                          fs, qmask, lmask, vmask, p, dcu, dmu, dbu,
                          reinterpret_cast<unsigned char*>(ws), dfc, dfm, dfb, dfw, dfs, dw);
}

// Bytes of the workspace of vml_smi_layer_fwd_bf16 (backward 0) or
// vml_smi_layer_bwd_bf16 (backward 1).
size_t vml_smi_layer_workspace_bytes_bf16(int B, int L, int C, int Nq, int D, int dl,
                                          int backward) {
    vml::LayerScratchT<bf16> s;
    BackwardScratchT<bf16> w;
    return carve<bf16>(nullptr, B, L, C, Nq, D, dl, backward != 0, &s, &w);
}

// K2-bf16: K2 on bf16 activations (fc, fm, fb, fw, fs and the outputs cu,
// mu, bu), the layer's matrices bf16 and its biases fp32 in layer_w, the
// masks fp32: `vml::layer_forward<bf16>`, the layer sequence of K4-bf16
// (bf16 products with fp32 sums on gemm.cuh's bf16 path, fp32 arithmetic
// inside every other kernel, one rounding per stored value). ws:
// vml_smi_layer_workspace_bytes_bf16(..., 0) bytes.
int vml_smi_layer_fwd_bf16(void* stream, int B, int L, int C, int Nq, int D, int dl,
                           const bf16* fc, const bf16* fm, const bf16* fb, const bf16* fw,
                           const bf16* fs, const float* qmask, const float* lmask,
                           const float* vmask, const void* const* layer_w, void* ws, bf16* cu,
                           bf16* mu, bf16* bu) {
    vml::LayerScratchT<bf16> s;
    BackwardScratchT<bf16> unused;
    carve(static_cast<unsigned char*>(ws), B, L, C, Nq, D, dl, false, &s, &unused);
    return (int)vml::layer_forward(static_cast<cudaStream_t>(stream), B, L, C, Nq, D, dl, fc,
                                   fm, fb, fw, fs, qmask, lmask, vmask, layer_w, s, cu, mu, bu);
}

// K9-bf16: K9 on bf16 carries and activations, the layers' matrices bf16
// and their biases fp32 in p, the masks fp32: each layer is exactly a
// K2-bf16 launch. ws: vml_smi_layer_workspace_bytes_bf16(..., 0) bytes.
int vml_smi_stack_fwd_bf16(void* stream, int B, int L, int C, int Nq, int D, int dl,
                           int n_layers, const bf16* fc, const bf16* fm, const bf16* fb,
                           const bf16* fw, const bf16* fs, const float* qmask,
                           const float* lmask, const float* vmask, const void* const* p,
                           void* ws, bf16* carry_fc, bf16* carry_fm, bf16* carry_fb,
                           bf16* cu_last, bf16* fm_out, bf16* fb_out) {
    return stack_forward(static_cast<cudaStream_t>(stream), B, L, C, Nq, D, dl, n_layers, fc,
                         fm, fb, fw, fs, qmask, lmask, vmask, p,
                         static_cast<unsigned char*>(ws), carry_fc, carry_fm, carry_fb,
                         cu_last, fm_out, fb_out);
}

// K3-bf16: recompute the layer exactly as K2-bf16 does, then K3's sequence
// on bf16 activations and cotangents (dcu may be null; dmu, dbu bf16) with
// gemm.cuh's bf16 products: dfc, dfm, dfb, dfw, dfs bf16, each rounded once
// from fp32 sums; the gradient of every stored bf16 value of the layer
// rounded to bf16 once, as it is stored, before it is used; the 20 weight
// gradients fp32 (dw), reduced over the rows in fp32 in a fixed order. ws:
// vml_smi_layer_workspace_bytes_bf16(..., 1) bytes. dfc doubles as the
// recompute's cu buffer before it is written.
int vml_smi_layer_bwd_bf16(void* stream, int B, int L, int C, int Nq, int D, int dl,
                           const bf16* fc, const bf16* fm, const bf16* fb, const bf16* fw,
                           const bf16* fs, const float* qmask, const float* lmask,
                           const float* vmask, const void* const* p, const bf16* dcu,
                           const bf16* dmu, const bf16* dbu, void* ws, bf16* dfc, bf16* dfm,
                           bf16* dfb, bf16* dfw, bf16* dfs, float* const* dw) {
    return layer_backward(static_cast<cudaStream_t>(stream), B, L, C, Nq, D, dl, fc, fm, fb, fw,
                          fs, qmask, lmask, vmask, p, dcu, dmu, dbu,
                          static_cast<unsigned char*>(ws), dfc, dfm, dfb, dfw, dfs, dw);
}

}  // extern "C"
