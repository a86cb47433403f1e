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
//     dx2 = dz Wfc (gemm_nn, the mask as a row scale of A); G[i] = dbu[i] +
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
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "content_bwd.cuh"
#include "smin_units.cuh"

namespace {

using vml::kNegInf;
using vml::pair_index;
using vml::warp_sum;

// grid B * L. G[i] = dbu[i] + sum_{j >= i} dx1[(i, j)] * bu[j]
//                          + sum_{k <= i} dx1[(k, i)] * bu[k].
__global__ void moment_bwd_kernel(int L, int D, const float* __restrict__ dbu,
                                  const float* __restrict__ dx1,
                                  const float* __restrict__ bu, float* __restrict__ G) {
    const int N = L * (L + 1) / 2;
    const int row = blockIdx.x;   // b * L + i
    const int b = row / L;
    const int i = row % L;
    const float* bue = bu + (size_t)b * L * D;
    const float* dxe = dx1 + (size_t)b * N * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float acc = dbu[(size_t)row * D + d];
        for (int j = i; j < L; ++j)
            acc += dxe[(size_t)pair_index(i, j, L) * D + d] * bue[(size_t)j * D + d];
        for (int k = 0; k <= i; ++k)
            acc += dxe[(size_t)pair_index(k, i, L) * D + d] * bue[(size_t)k * D + d];
        G[(size_t)row * D + d] = acc;
    }
}

// grid B * L, one block per snippet row i: recomputes the boundary attention
// row P[i] and writes A[i, j] = P[i, j] * lm[i] (B, L, L) and the logit
// gradients dS[i, j] (B, L, L; 0 at a masked key j), from
//   dA[i, j] = lm[i] * (G[i] . fb[j]) + [j >= i] G[i] . fbar[(i, j)].
__global__ void boundary_attn_bwd_kernel(int L, int D, const float* __restrict__ fbq,
                                         const float* __restrict__ fb,
                                         const float* __restrict__ fbar,
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
    const float* x = fbq + (size_t)row * D;
    const float* g = G + (size_t)row * D;

    for (int j = warp; j < L; j += nwarps) {
        const float* y = fbq + ((size_t)b * L + j) * D;
        const float* fbj = fb + ((size_t)b * L + j) * D;
        const float* fbar_ij =
            j >= i ? fbar + ((size_t)b * N + pair_index(i, j, L)) * D : nullptr;
        float s = 0.f, t = 0.f, u = 0.f;
        for (int d = lane; d < D; d += 32) {
            s += x[d] * y[d];
            t += g[d] * fbj[d];
            if (fbar_ij) u += g[d] * fbar_ij[d];
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
// gradients ds (B, L, Nq; 0 at a masked word).
__global__ void boundary_query_bwd_kernel(
    int L, int Nq, int D, const float* __restrict__ bq, const float* __restrict__ bk,
    const float* __restrict__ fw, const float* __restrict__ fb, const float* __restrict__ fs,
    const float* __restrict__ fbq, const float* __restrict__ qmask,
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
    const float* x = bq + (size_t)row * D;
    const float* fwe = fw + (size_t)b * Nq * D;
    const float lm = lmask[row];

    for (int m = warp; m < Nq; m += nwarps) {
        const float* y = bk + ((size_t)b * Nq + m) * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += x[d] * y[d];
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
            dfbq += coef[j] * fbq[((size_t)b * L + j) * D + d];
            gsum += coefA[j] * G[((size_t)b * L + j) * D + d];
        }
        float a = 0.f;
        for (int m = 0; m < Nq; ++m) a += p[m] * fwe[(size_t)m * D + d];
        const float fbv = fb[(size_t)row * D + d];
        const float dav = dfbq * fbv * lm;
        darow[d] = dav;
        dfb[(size_t)row * D + d] = gsum + dfbq * (a * lm + fs[(size_t)b * D + d]);
        dab[(size_t)row * D + d] = dav;
        dfs_b[(size_t)row * D + d] = dfbq * fbv;
    }
    __syncthreads();
    for (int m = warp; m < Nq; m += nwarps) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += darow[d] * fwe[(size_t)m * D + d];
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
// share of dfw[m] = sum_i p[i, m] da[i].
__global__ void boundary_proj_bwd_kernel(int L, int Nq, int D, const float* __restrict__ dsb,
                                         const float* __restrict__ pb,
                                         const float* __restrict__ dab,
                                         const float* __restrict__ bq,
                                         const float* __restrict__ bk,
                                         float* __restrict__ dbq, float* __restrict__ dbk,
                                         float* __restrict__ dfw) {
    const int b = blockIdx.x / (L + Nq);
    const int r = blockIdx.x % (L + Nq);
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        if (r < L) {
            float s = 0.f;
            for (int m = 0; m < Nq; ++m)
                s += dsb[((size_t)b * L + r) * Nq + m] * bk[((size_t)b * Nq + m) * D + d];
            dbq[((size_t)b * L + r) * D + d] = s;
        } else {
            const int m = r - L;
            float s1 = 0.f, s2 = 0.f;
            for (int i = 0; i < L; ++i) {
                const size_t row = (size_t)b * L + i;
                s1 += dsb[row * Nq + m] * bq[row * D + d];
                s2 += pb[row * Nq + m] * dab[row * D + d];
            }
            dbk[((size_t)b * Nq + m) * D + d] = s1;
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
// s), to part[split, b]; gate_dfs_kernel adds the splits in order.
constexpr int kGateThreads = 128;
constexpr int kGateMaxSplits = 32;

template <int V>
__global__ void __launch_bounds__(kGateThreads) gate_bwd_kernel(
    int L, int C, int D, int splits, const float* __restrict__ fm, const float* __restrict__ fs,
    const float* __restrict__ dmu, const float* __restrict__ dcut, const float* __restrict__ Ab,
    const float* __restrict__ G, float* __restrict__ dfm, float* __restrict__ part) {
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

// The backward's buffers beyond the recomputed layer's own intermediates.
struct BackwardScratch {
    vml::ContentBackwardScratch c;
    float *bu, *dx1, *dx2, *G, *Ab, *dSb, *pb, *dsb, *dab, *dfs_b, *dbq, *dbk, *gate_part,
        *partial;
};
constexpr int kBackwardSlots = 14;

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

// Carves the workspace; returns its size in floats (ws may be null).
size_t carve(float* ws, int B, int L, int C, int Nq, int D, int dl, bool backward,
             vml::LayerScratch* s, BackwardScratch* w) {
    size_t off = vml::carve_layer_scratch(ws, 0, B, L, C, Nq, D, dl, s);
    if (!backward) return off;
    const size_t N = (size_t)L * (L + 1) / 2;
    const size_t BL = (size_t)B * L, BQ = (size_t)B * Nq;
    off = vml::carve_content_backward(ws, off, B, (int)N, C, Nq, dl, &w->c);
    const size_t sizes[kBackwardSlots] = {
        BL * D, B * N * D, B * N * D, BL * D,                       // bu, dx1, dx2, G
        BL * L, BL * L, BL * Nq, BL * Nq,                           // Ab, dSb, pb, dsb
        BL * D, BL * D, BL * D, BQ * D,                             // dab, dfs_b, dbq, dbk
        (size_t)kGateMaxSplits * B * D,                             // gate_part
        max_partial_floats(B, L, C, Nq, D, dl),                     // partial
    };
    float** slots[kBackwardSlots] = {
        &w->bu, &w->dx1, &w->dx2, &w->G, &w->Ab, &w->dSb, &w->pb, &w->dsb,
        &w->dab, &w->dfs_b, &w->dbq, &w->dbk, &w->gate_part, &w->partial};
    return vml::carve_slots(ws, off, sizes, slots, kBackwardSlots);
}

size_t boundary_query_bwd_smem_bytes(int L, int Nq, int D) {
    return sizeof(float) * ((size_t)2 * Nq + (size_t)2 * L + D);
}

}  // namespace

extern "C" {

size_t vml_smi_layer_workspace_floats(int B, int L, int C, int Nq, int D, int dl,
                                      int backward) {
    vml::LayerScratch s;
    BackwardScratch w;
    return carve(nullptr, B, L, C, Nq, D, dl, backward != 0, &s, &w);
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
    BackwardScratch unused;
    carve(ws, B, L, C, Nq, D, dl, false, &s, &unused);
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
    const size_t N = (size_t)L * (L + 1) / 2;
    const size_t nc = (size_t)B * N * C * D, nm = (size_t)B * N * D, nb = (size_t)B * L * D;
    vml::LayerScratch s;
    BackwardScratch unused;
    carve(ws, B, L, C, Nq, D, dl, false, &s, &unused);
    for (int k = 0; k < n_layers; ++k) {
        const bool top = k == n_layers - 1;
        float* cu = top ? cu_last : carry_fc + k * nc;
        float* mu = top ? fm_out : carry_fm + k * nm;
        float* bu = top ? fb_out : carry_fb + k * nb;
        cudaError_t err = vml::layer_forward(static_cast<cudaStream_t>(stream), B, L, C, Nq, D,
                                             dl, fc, fm, fb, fw, fs, qmask, lmask, vmask,
                                             p + (size_t)k * vml::kWeightsPerLayer, s, cu, mu,
                                             bu);
        if (err != cudaSuccess) return (int)err;
        fc = cu;
        fm = mu;
        fb = bu;
    }
    return 0;
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
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int N = L * (L + 1) / 2;
    const int NC = N * C;
    vml::LayerScratch s;
    BackwardScratch w;
    carve(ws, B, L, C, Nq, D, dl, true, &s, &w);
    cudaError_t err;
#define VML_CHECK()                                                     \
    do {                                                                \
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err; \
    } while (0)
    const vml::Epilogue none{};
    vml::Epilogue ep;

    // Recompute the layer; cu goes to dfc (only x2 = mean_c cu is kept).
    err = vml::layer_forward(st, B, L, C, Nq, D, dl, fc, fm, fb, fw, fs, qmask, lmask, vmask,
                             p, s, dfc, static_cast<float*>(nullptr), w.bu);
    if (err != cudaSuccess) return (int)err;

    // MomentUnit.
    vml::gemm_nn2(st, B * N, D, D, dmu, D, vmask, 1, p[16], p[18], D, w.dx1, w.dx2, D, none,
                  none);
    VML_CHECK();
    // x1 and x2 are the two halves of the forward's [x1 | x2] (B * N, 2D).
    vml::gemm_tn(st, D, D, B * N, dmu, D, vmask, 1, s.x12, 2 * D, w.partial, dw[16], dw[17]);
    VML_CHECK();
    vml::gemm_tn(st, D, D, B * N, dmu, D, vmask, 1, s.x12 + D, 2 * D, w.partial, dw[18]);
    VML_CHECK();
    if ((err = cudaMemcpyAsync(dw[19], dw[17], sizeof(float) * D, cudaMemcpyDeviceToDevice,
                               st)) != cudaSuccess)
        return (int)err;
    moment_bwd_kernel<<<B * L, 128, 0, st>>>(L, D, dbu, w.dx1, w.bu, w.G);
    VML_CHECK();
    const size_t ncd = (size_t)B * NC * D;
    const int dcu_blocks = (int)((ncd + 255) / 256 < 8192 ? (ncd + 255) / 256 : 8192);
    vml::dcu_total_kernel<<<dcu_blocks, 256, 0, st>>>(ncd, C, D, dcu, w.dx2, dfc);
    VML_CHECK();

    // ContentUnit. dfc holds dcut from here to the last GEMM.
    err = vml::content_backward(st, B, N, C, Nq, D, dl, fc, fw, fs, qmask, vmask, p, s, w.c,
                                w.partial, dfc, dw);
    if (err != cudaSuccess) return (int)err;

    // BoundaryUnit.
    boundary_attn_bwd_kernel<<<B * L, 128, 2 * L * sizeof(float), st>>>(
        L, D, s.fbq, fb, s.fbar, lmask, w.G, w.Ab, w.dSb);
    VML_CHECK();
    boundary_query_bwd_kernel<<<B * L, 128, boundary_query_bwd_smem_bytes(L, Nq, D), st>>>(
        L, Nq, D, s.bq, s.bk, fw, fb, fs, s.fbq, qmask, lmask, w.G, w.Ab, w.dSb, dfb, w.dab,
        w.dfs_b, w.pb, w.dsb);
    VML_CHECK();
    boundary_proj_bwd_kernel<<<B * (L + Nq), 128, 0, st>>>(L, Nq, D, w.dsb, w.pb, w.dab, s.bq,
                                                           s.bk, w.dbq, w.dbk, dfw);
    VML_CHECK();
    ep = vml::Epilogue();
    ep.post = dfb;
    ep.ldpost = D;
    vml::gemm_nn(st, B * L, D, D, w.dbq, D, nullptr, 1, p[12], D, dfb, D, ep);
    VML_CHECK();
    ep.post = dfw;
    vml::gemm_nn(st, B * Nq, D, D, w.dbk, D, nullptr, 1, p[14], D, dfw, D, ep);
    VML_CHECK();
    vml::gemm_tn(st, D, D, B * L, w.dbq, D, nullptr, 1, fb, D, w.partial, dw[12], dw[13]);
    VML_CHECK();
    vml::gemm_tn(st, D, D, B * Nq, w.dbk, D, nullptr, 1, fw, D, w.partial, dw[14], dw[15]);
    VML_CHECK();

    // Gate (reads dcut from dfc), then the content unit's shares of dfw and
    // dfs, and dfc = dcut + dh Wch.
    {
        const bool vec = D % 4 == 0 && vml::aligned16(fm) && vml::aligned16(fs) &&
                         vml::aligned16(dmu) && vml::aligned16(dfc) && vml::aligned16(dfm);
        const int cols = vec ? D / 4 : D;
        const int splits = gate_bwd_splits(B, N, cols);
        const dim3 grid(splits * ((cols + kGateThreads - 1) / kGateThreads), B);
        if (vec)
            gate_bwd_kernel<4><<<grid, kGateThreads, 0, st>>>(L, C, D, splits, fm, fs, dmu, dfc,
                                                              w.Ab, w.G, dfm, w.gate_part);
        else
            gate_bwd_kernel<1><<<grid, kGateThreads, 0, st>>>(L, C, D, splits, fm, fs, dmu, dfc,
                                                              w.Ab, w.G, dfm, w.gate_part);
        VML_CHECK();
        const size_t bd = (size_t)B * D;
        gate_dfs_kernel<<<(unsigned)((bd + 255) / 256), 256, 0, st>>>(B, L, D, splits,
                                                                       w.gate_part, w.dfs_b, dfs);
        VML_CHECK();
    }
    err = vml::content_input_grads(st, B, N, C, Nq, D, dl, p, w.c, true, dfc, dfw, dfs);
    if (err != cudaSuccess) return (int)err;
#undef VML_CHECK
    return 0;
}

}  // extern "C"
