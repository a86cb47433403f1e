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
//     dx2 = dz Wfc (one nn product, the mask on its rows; dW_fb and dW_fc
//     one tn product over [x1 | x2]); G[i] = dbu[i] + sum_{n: i_n = i}
//     dx1[n] bu[j_n] + sum_{n: j_n = i} dx1[n] bu[i_n] (gathered per
//     snippet row by boundary_attn_bwd_kernel below; the pair (i, i) counts in
//     both sums); dcut[n, c] = dcu[n, c] + dx2[n] / C (dcut_kernel; a null
//     dcu is the top layer's zero cotangent); dfm = dmu.
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
//     boundary_attn_bwd_kernel (a block per snippet row) gathers G and
//     writes A and the logit gradients dS; boundary_query_bwd_kernel turns
//     them into dfbq[i] = sum_j (dS[i, j] + dS[j, i]) fbq[j], the direct
//     part of dfb, da, the row's share of dfs, the word-logit gradients and
//     dbq; boundary_proj_bwd_kernel reduces dbk and the value-path share of
//     dfw over rows (dot products a warp each, softmaxes across a warp's
//     lanes, four columns a thread); then dfb += dbq Wbq, dfw += dbk Wbk.
//   Gate  fbar = sigmoid(fm * fs) * fm, dfbar[n] = A[i_n, j_n] G[i_n] +
//     sum_c dcut[n, c]. gate_bwd_kernel (content_bwd.cuh, shared with K10; a
//     thread per 4 columns of an element and a split of its pairs) writes
//     dfm and its split's share of dfs; gate_dfs_kernel adds the splits in
//     order.
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
using vml::warp_max;
using vml::warp_sum;

// A gradient of a stored value rounded as it is stored: to bf16 and back for
// the bf16 variant, nothing at fp32.
template <typename T>
__device__ __forceinline__ float stored(float x) {
    return to_f(from_f<T>(x));
}

// The moment unit's scatter to the snippets and the boundary unit's
// backward, in three kernels of kBbThreads (4 warps): a thread takes V
// consecutive columns (16-byte loads of fp32 rows, 8-byte of bf16, when V is
// 4), a row's dot products run a warp each, and its softmaxes across warp
// 0's lanes. T: the type of dbu, dx1, bu, fbq, fb, fbar, bq, bk, fw and fs;
// at bf16 every stored value's gradient is rounded once where K3's plain
// version rounds it.
constexpr int kBbThreads = 128;

// The softmax of the n logits in p (shared), in place, across warp 0's
// lanes; the caller syncs before and after.
__device__ __forceinline__ void warp_softmax(float* p, int n) {
    if (threadIdx.x >= 32) return;
    float mx = -INFINITY;
    for (int k = threadIdx.x; k < n; k += 32) mx = fmaxf(mx, p[k]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = threadIdx.x; k < n; k += 32) sum += expf(p[k] - mx);
    sum = warp_sum(sum);
    for (int k = threadIdx.x; k < n; k += 32) p[k] = expf(p[k] - mx) / sum;
}

// boundary_attn_bwd_kernel, grid B * L, block (b, i):
//   G[i] = dbu[i] + sum_{j >= i} dx1[(i, j)] bu[j] + sum_{k <= i} dx1[(k, i)]
//   bu[k] (the pairs' sum rounded to bf16 before dbu is added, and G again,
//   at bf16: bu is a stored value its layer reads), kept in shared memory
//   and written to G; then the boundary attention row P[i] recomputed, A[i,
//   j] = P[i, j] lm[i] (to Ab, for the gate too) and the logit gradients
//   dS[i, j] (0 at a masked key) from dA[i, j] = lm[i] (G[i] . fb[j]) + [j >=
//   i] G[i] . fbar[(i, j)]. Shared memory: G's row (D floats), P and dA.
template <int V, typename T>
__global__ void __launch_bounds__(kBbThreads) boundary_attn_bwd_kernel(
    int L, int D, const T* __restrict__ dbu, const T* __restrict__ dx1,
    const T* __restrict__ bu, const T* __restrict__ fbq, const T* __restrict__ fb,
    const T* __restrict__ fbar, const float* __restrict__ lmask, float* __restrict__ G,
    float* __restrict__ Ab, float* __restrict__ dSb) {
    constexpr bool f32 = std::is_same<T, float>::value;
    extern __shared__ float smem[];
    float* gs = smem;                 // (D,): G[i]
    float* P = gs + D;                // (L,)
    float* dA = P + L;                // (L,)
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int i = row % L;
    const int N = L * (L + 1) / 2;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    constexpr int nwarps = kBbThreads / 32;
    const int cols = D / V;
    const float inv_sd = 1.f / sqrtf((float)D);
    const float* lm = lmask + (size_t)b * L;
    const T* bue = bu + (size_t)b * L * D;
    const T* dxe = dx1 + (size_t)b * N * D;

    for (int c = threadIdx.x; c < cols; c += kBbThreads) {
        const int d = c * V;
        float acc[V], db[V];
        vml::load_vec<V>(dbu + (size_t)row * D + d, db);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = f32 ? db[k] : 0.f;
#pragma unroll 4
        for (int j = i; j < L; ++j) {
            float x[V], u[V];
            vml::load_vec<V>(dxe + (size_t)pair_index(i, j, L) * D + d, x);
            vml::load_vec<V>(bue + (size_t)j * D + d, u);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] += x[k] * u[k];
        }
#pragma unroll 4
        for (int m = 0; m <= i; ++m) {
            float x[V], u[V];
            vml::load_vec<V>(dxe + (size_t)pair_index(m, i, L) * D + d, x);
            vml::load_vec<V>(bue + (size_t)m * D + d, u);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] += x[k] * u[k];
        }
        if (!f32) {
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] = stored<T>(db[k] + stored<T>(acc[k]));
        }
#pragma unroll
        for (int k = 0; k < V; ++k) gs[d + k] = acc[k];
        vml::store_vec<V>(G + (size_t)row * D + d, acc);
    }
    __syncthreads();

    const T* x = fbq + (size_t)row * D;
    for (int j = warp; j < L; j += nwarps) {
        const T* y = fbq + ((size_t)b * L + j) * D;
        const T* f = fb + ((size_t)b * L + j) * D;
        const T* h = j >= i ? fbar + ((size_t)b * N + pair_index(i, j, L)) * D : nullptr;
        float sdot = 0.f, tdot = 0.f, udot = 0.f;
        for (int c = lane; c < cols; c += 32) {
            const int d = c * V;
            float xv[V], yv[V], fv[V];
            vml::load_vec<V>(x + d, xv);
            vml::load_vec<V>(y + d, yv);
            vml::load_vec<V>(f + d, fv);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                sdot += xv[k] * yv[k];
                tdot += gs[d + k] * fv[k];
            }
            if (h) {
                float hv[V];
                vml::load_vec<V>(h + d, hv);
#pragma unroll
                for (int k = 0; k < V; ++k) udot += gs[d + k] * hv[k];
            }
        }
        sdot = warp_sum(sdot);
        tdot = warp_sum(tdot);
        udot = warp_sum(udot);
        if (lane == 0) {
            P[j] = lm[j] > 0.f ? sdot * inv_sd : kNegInf;
            dA[j] = lm[i] * tdot + udot;
        }
    }
    __syncthreads();
    // The row's softmax and its backward across warp 0's lanes: dP = dA
    // lm[i], dS = P (dP - sum_j P dP) / sqrt(D).
    if (warp == 0) {
        float mx = -INFINITY;
        for (int j = lane; j < L; j += 32) mx = fmaxf(mx, P[j]);
        mx = warp_max(mx);
        float sum = 0.f;
        for (int j = lane; j < L; j += 32) sum += expf(P[j] - mx);
        sum = warp_sum(sum);
        float dot = 0.f;
        for (int j = lane; j < L; j += 32) dot += expf(P[j] - mx) / sum * (dA[j] * lm[i]);
        dot = warp_sum(dot);
        for (int j = lane; j < L; j += 32) {
            const float pj = expf(P[j] - mx) / sum;
            Ab[(size_t)row * L + j] = pj * lm[i];
            dSb[(size_t)row * L + j] = lm[j] > 0.f ? pj * (dA[j] * lm[i] - dot) * inv_sd : 0.f;
        }
    }
}

// boundary_query_bwd_kernel, grid B * L, block (b, i): dfbq[i] = sum_j
// (dS[i, j] + dS[j, i]) fbq[j] (rounded at bf16), then through fbq[i] =
// fb[i] * (a[i] lm[i] + fs), a = p fw:
//   dfb[i] = G[i] + sum_j A[j, i] lm[j] G[j] + dfbq[i] (a[i] lm[i] + fs)
//   da[i]  = dfbq[i] fb[i] lm[i] (to dab),  dfs_b[i] = dfbq[i] fb[i]
// (the attn_q path of dfb is the caller's product), the word attention's
// p[i] and logit gradients ds[i] (0 at a masked word; both to pb / dsb) from
// dp = da fw^T, and dbq[i] = sum_m ds[i, m] bk[m]. Shared memory: the
// coefficients of row i and column i, p, dp and da's row.
template <int V, typename T>
__global__ void __launch_bounds__(kBbThreads) boundary_query_bwd_kernel(
    int L, int Nq, int D, const T* __restrict__ bq, const T* __restrict__ bk,
    const T* __restrict__ fw, const T* __restrict__ fb, const T* __restrict__ fs,
    const T* __restrict__ fbq, const float* __restrict__ qmask,
    const float* __restrict__ lmask, const float* __restrict__ G,
    const float* __restrict__ Ab, const float* __restrict__ dSb, float* __restrict__ dfb,
    float* __restrict__ dab, float* __restrict__ dfs_b, float* __restrict__ pb,
    float* __restrict__ dsb, T* __restrict__ dbq) {
    extern __shared__ float smem[];
    float* p = smem;                  // (Nq,)
    float* dp = p + Nq;               // (Nq,)
    float* coef = dp + Nq;            // (L,): dS[i, j] + dS[j, i]
    float* coefA = coef + L;          // (L,): A[j, i] * lm[j]
    float* darow = coefA + L;         // (D,)
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int i = row % L;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    constexpr int nwarps = kBbThreads / 32;
    const int cols = D / V;
    const float inv_sd = 1.f / sqrtf((float)D);
    const float lmi = lmask[row];
    const float* qm = qmask + (size_t)b * Nq;
    const T* x = bq + (size_t)row * D;
    const T* bke = bk + (size_t)b * Nq * D;
    const T* fwe = fw + (size_t)b * Nq * D;

    for (int m = warp; m < Nq; m += nwarps) {
        float sdot = 0.f;
        for (int c = lane; c < cols; c += 32) {
            float xv[V], yv[V];
            vml::load_vec<V>(x + c * V, xv);
            vml::load_vec<V>(bke + (size_t)m * D + c * V, yv);
#pragma unroll
            for (int k = 0; k < V; ++k) sdot += xv[k] * yv[k];
        }
        sdot = warp_sum(sdot);
        if (lane == 0) p[m] = qm[m] > 0.f ? sdot * inv_sd : kNegInf;
    }
    for (int j = threadIdx.x; j < L; j += kBbThreads) {
        coef[j] = dSb[(size_t)row * L + j] + dSb[((size_t)b * L + j) * L + i];
        coefA[j] = Ab[((size_t)b * L + j) * L + i] * lmask[(size_t)b * L + j];
    }
    __syncthreads();
    warp_softmax(p, Nq);
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += kBbThreads) {
        const int d = c * V;
        float dfbq[V], gsum[V], a[V], t[V];
        vml::load_vec<V>(G + (size_t)row * D + d, gsum);
#pragma unroll
        for (int k = 0; k < V; ++k) dfbq[k] = a[k] = 0.f;
#pragma unroll 4
        for (int j = 0; j < L; ++j) {
            float y[V], g[V];
            vml::load_vec<V>(fbq + ((size_t)b * L + j) * D + d, y);
            vml::load_vec<V>(G + ((size_t)b * L + j) * D + d, g);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                dfbq[k] += coef[j] * y[k];
                gsum[k] += coefA[j] * g[k];
            }
        }
#pragma unroll 4
        for (int m = 0; m < Nq; ++m) {
            vml::load_vec<V>(fwe + (size_t)m * D + d, t);
#pragma unroll
            for (int k = 0; k < V; ++k) a[k] += p[m] * t[k];
        }
        float fbv[V], fsv[V], out[V], da[V], dsv[V];
        vml::load_vec<V>(fb + (size_t)row * D + d, fbv);
        vml::load_vec<V>(fs + (size_t)b * D + d, fsv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const float q = stored<T>(dfbq[k]);
            da[k] = q * fbv[k] * lmi;
            out[k] = gsum[k] + q * (a[k] * lmi + fsv[k]);
            dsv[k] = q * fbv[k];
            darow[d + k] = da[k];
        }
        vml::store_vec<V>(dfb + (size_t)row * D + d, out);
        vml::store_vec<V>(dab + (size_t)row * D + d, da);
        vml::store_vec<V>(dfs_b + (size_t)row * D + d, dsv);
    }
    __syncthreads();
    for (int m = warp; m < Nq; m += nwarps) {
        float sdot = 0.f;
        for (int c = lane; c < cols; c += 32) {
            float yv[V];
            vml::load_vec<V>(fwe + (size_t)m * D + c * V, yv);
#pragma unroll
            for (int k = 0; k < V; ++k) sdot += darow[c * V + k] * yv[k];
        }
        sdot = warp_sum(sdot);
        if (lane == 0) dp[m] = sdot;
    }
    __syncthreads();
    if (warp == 0) {
        float dot = 0.f;
        for (int m = lane; m < Nq; m += 32) dot += p[m] * dp[m];
        dot = warp_sum(dot);
        for (int m = lane; m < Nq; m += 32) {
            const float ds = qm[m] > 0.f ? p[m] * (dp[m] - dot) * inv_sd : 0.f;
            dp[m] = ds;
            pb[(size_t)row * Nq + m] = p[m];
            dsb[(size_t)row * Nq + m] = ds;
        }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += kBbThreads) {
        float acc[V], y[V];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = 0.f;
#pragma unroll 4
        for (int m = 0; m < Nq; ++m) {
            vml::load_vec<V>(bke + (size_t)m * D + c * V, y);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[k] += dp[m] * y[k];
        }
        vml::store_vec<V>(dbq + (size_t)row * D + c * V, acc);
    }
}

// boundary_proj_bwd_kernel, grid B * Nq, block (b, m): dbk[m] = sum_i ds[i,
// m] bq[i] and the value path's dfw[m] = sum_i p[i, m] da[i] (fp32), rows in
// order.
template <int V, typename T>
__global__ void __launch_bounds__(kBbThreads) boundary_proj_bwd_kernel(
    int L, int Nq, int D, const float* __restrict__ dsb, const float* __restrict__ pb,
    const float* __restrict__ dab, const T* __restrict__ bq, T* __restrict__ dbk,
    float* __restrict__ dfw) {
    const int b = blockIdx.x / Nq;
    const int m = blockIdx.x % Nq;
    for (int c = threadIdx.x; c < D / V; c += kBbThreads) {
        const int d = c * V;
        float s1[V], s2[V];
#pragma unroll
        for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.f;
#pragma unroll 4
        for (int i = 0; i < L; ++i) {
            const size_t r = (size_t)b * L + i;
            const float w1 = dsb[r * Nq + m], w2 = pb[r * Nq + m];
            float x[V], y[V];
            vml::load_vec<V>(bq + r * D + d, x);
            vml::load_vec<V>(dab + r * D + d, y);
#pragma unroll
            for (int k = 0; k < V; ++k) {
                s1[k] += w1 * x[k];
                s2[k] += w2 * y[k];
            }
        }
        vml::store_vec<V>(dbk + ((size_t)b * Nq + m) * D + d, s1);
        vml::store_vec<V>(dfw + ((size_t)b * Nq + m) * D + d, s2);
    }
}

size_t boundary_attn_bwd_smem_bytes(int L, int D) {
    return sizeof(float) * ((size_t)D + 2 * L);
}
size_t boundary_query_bwd_smem_bytes(int L, int Nq, int D) {
    return sizeof(float) * ((size_t)2 * Nq + (size_t)2 * L + D);
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
    const int shapes[][3] = {{D, 2 * D, B * N}, {D, D, B * L}, {D, D, B * Nq}};
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
        f * vml::gate_part_floats(B, D),                                    // gate_part
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
    // x1 and x2 are the two halves of the forward's [x1 | x2] (B * N, 2D):
    // one product over both gives dW_fb and dW_fc, and the two biases'
    // gradients (both the column sums of dmu * vm).
    vml::product_tn2(st, D, 2 * D, B * N, dmu, D, vmask, 1, s.x12, 2 * D, D, w.partial, dw[16],
                     dw[18], dw[17], dw[19]);
    VML_CHECK();
    vml::launch_dcut<T>(st, B * N, C, D, dcu, w.dx2, dfc, nullptr);
    VML_CHECK();

    // ContentUnit. dfc holds dcut from here to the last product.
    err = vml::content_backward(st, B, N, C, Nq, D, dl, fc, fw, fs, qmask, vmask, p, s, w.c,
                                w.partial, dfc, dw);
    if (err != cudaSuccess) return (int)err;

    // The moment unit's G and the BoundaryUnit: dfb32 and dfw32 gather their
    // shares in fp32.
    {
        // Four columns a thread: a block's 128 threads then cover D = 512.
        constexpr int V = 4;
        const void* rows[] = {dbu,  w.dx1, w.bu,  s.fbq,   fb,      s.fbar, s.bq,  s.bk, fw,
                              fs,   w.G,   dfb32, w.dab,   w.dfs_b, w.dbq,  w.dbk, dfw32};
        bool vec = D % V == 0;
        for (const void* q : rows) vec = vec && vml::aligned16(q);
        const size_t a_smem = boundary_attn_bwd_smem_bytes(L, D);
        const size_t q_smem = boundary_query_bwd_smem_bytes(L, Nq, D);
        auto attn = vec ? boundary_attn_bwd_kernel<V, T> : boundary_attn_bwd_kernel<1, T>;
        auto query = vec ? boundary_query_bwd_kernel<V, T> : boundary_query_bwd_kernel<1, T>;
        auto proj = vec ? boundary_proj_bwd_kernel<V, T> : boundary_proj_bwd_kernel<1, T>;
        attn<<<B * L, kBbThreads, a_smem, st>>>(L, D, dbu, w.dx1, w.bu, s.fbq, fb, s.fbar, lmask,
                                                 w.G, w.Ab, w.dSb);
        VML_CHECK();
        query<<<B * L, kBbThreads, q_smem, st>>>(L, Nq, D, s.bq, s.bk, fw, fb, fs, s.fbq, qmask,
                                                  lmask, w.G, w.Ab, w.dSb, dfb32, w.dab, w.dfs_b,
                                                  w.pb, w.dsb, w.dbq);
        VML_CHECK();
        proj<<<B * Nq, kBbThreads, 0, st>>>(L, Nq, D, w.dsb, w.pb, w.dab, s.bq, w.dbk, dfw32);
        VML_CHECK();
    }
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
    err = vml::gate_backward<true>(st, B, N, L, C, D, fm, fs, dmu, dfc, w.Ab, w.G, w.dfs_b, dfm,
                                   w.gate_part, dfs32);
    if (err != cudaSuccess) return (int)err;
    err = vml::content_input_grads(st, B, N, C, Nq, D, dl, p, w.c, dfw32, dfs32, dfc, dfc, dfw,
                                   dfs);
#undef VML_CHECK
    return (int)err;
}

// K9's layer loop at either element type: layer k reads the carry that
// layer k - 1 wrote (into carry_* for the inner layers) and writes its own,
// all through one workspace carved once, exactly as one K2 launch per layer
// (the same kernels in the same order on each stream); the caller's stream
// joins the layers' second stream after the last (`layer_forward`'s join).
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
                                             s, cu, mu, bu, top);
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
                             boundary_attn_bwd_smem_bytes(L, D),
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
