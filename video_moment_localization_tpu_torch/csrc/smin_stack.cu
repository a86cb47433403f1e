// K4: the fused SMI stack of the serving path (proposal pooling, the SMI
// layers and the four sigmoid heads).
//
// Replaces ops/smin_pallas.py::smin_stack_fused (the Pallas `_kernel`, whose
// layer body is `smi_layer_rows`) of the JAX package. Inputs are the
// backbone outputs f (B, T, D), fw (B, Nq, D), fs (B, D) and the masks;
// outputs pm (B, N) in np.triu_indices pair order and ps/pe/pa (B, L), fp32.
//
// What bounds it on the H100: about 1.01 GFLOP of fp32 work per element at
// the Charades shapes, most of it in the c_hat / c_out projections over the
// N*C = 544 clip rows and the two moment convolutions over the N = 136
// pairs; against 67 TFLOP/s of fp32 outside the tensor cores the operations
// bound it, not the bytes (about 0.2 MB in and 0.6 KB out per element).
//
// Design: the TPU kernel keeps about 1.1 MB of fp32 state per element in
// VMEM; a block has 227 KB of shared memory, so the megakernel is split into
// a few kernels that this entry point sequences per layer on one stream,
// with the intermediates in a device workspace that the wrapper allocates:
//   pool_kernel            fc (B, N, C, D) segment means masked by vmask,
//                          fm = mean over C, fb = window means
//   gate_kernel            fbar = sigmoid(fm * fs) * fm
//   gemm_nt (gemm.cuh)     every projection, with bias / mask / residual
//                          epilogues
//   content_attn_kernel    word attention of each clip row (-1e9 key mask),
//                          f_cq, the C x C clip attention (softmax unmasked,
//                          mask after), one block per (element, pair)
//   boundary_query_kernel  word attention and f_bq of one snippet row
//   boundary_unit_kernel   A_b, f_bb and the moment message f_bm of one
//                          snippet row
//   moment_prologue_kernel outer[n] = bu[i_n] * bu[j_n] and mean_c(cu)
//   heads_kernel           the four sigmoid heads, one warp per output
// Rows are n-major: row (b, n, c) of fc/cu is ((b * N) + n) * C + c, the
// layout of the plain version in ops/smin_cuda.py.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "gemm.cuh"

namespace {

constexpr float kNegInf = -1e9f;   // the JAX units' mask fill, not -inf
constexpr int kWeightsPerLayer = 20;

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
__global__ void pool_kernel(int T, int L, int C, int D, const float* __restrict__ f,
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

// fbar = sigmoid(fm * fs) * fm over (B, N, D).
__global__ void gate_kernel(size_t total, int ND, int D, const float* __restrict__ fm,
                            const float* __restrict__ fs, float* __restrict__ fbar) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
         e += (size_t)gridDim.x * blockDim.x) {
        const int b = (int)(e / ND);
        const int d = (int)(e % D);
        const float x = fm[e];
        fbar[e] = vml::sigmoidf_(x * fs[(size_t)b * D + d]) * x;
    }
}

// One block per (element, pair): the content unit between its projections.
// h, q (B*N*C, dl) with h already masked by vmask; khat, fwh (B*Nq, dl) with
// fwh masked by the query mask; fsh (B, dl). Writes f_cc_hat (B*N*C, dl).
__global__ void content_attn_kernel(int N, int C, int Nq, int dl,
                                    const float* __restrict__ h,
                                    const float* __restrict__ q,
                                    const float* __restrict__ khat,
                                    const float* __restrict__ fwh,
                                    const float* __restrict__ fsh,
                                    const float* __restrict__ qmask,
                                    const float* __restrict__ vmask,
                                    float* __restrict__ out) {
    extern __shared__ float smem[];
    float* ks = smem;                 // (Nq, dl)
    float* vs = ks + Nq * dl;         // (Nq, dl)
    float* hs = vs + Nq * dl;         // (C, dl)
    float* qs = hs + C * dl;          // (C, dl)
    float* gs = qs + C * dl;          // (C, dl): f_cq
    float* ps = gs + C * dl;          // (C, Nq): word attention
    float* as = ps + C * Nq;          // (C, C): clip attention

    const int pair = blockIdx.x;      // b * N + n
    const int b = pair / N;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int nwarps = blockDim.x / 32;
    const float inv_sdl = 1.f / sqrtf((float)dl);
    const float vm = vmask[pair];
    const size_t row0 = (size_t)pair * C;

    for (int e = tid; e < Nq * dl; e += blockDim.x) {
        ks[e] = khat[(size_t)b * Nq * dl + e];
        vs[e] = fwh[(size_t)b * Nq * dl + e];
    }
    for (int e = tid; e < C * dl; e += blockDim.x) {
        hs[e] = h[row0 * dl + e];
        qs[e] = q[row0 * dl + e];
    }
    __syncthreads();

    for (int idx = warp; idx < C * Nq; idx += nwarps) {
        const int c = idx / Nq;
        const int m = idx % Nq;
        float s = 0.f;
        for (int d = lane; d < dl; d += 32) s += qs[c * dl + d] * ks[m * dl + d];
        s = vml::warp_sum(s);
        if (lane == 0) ps[idx] = qmask[(size_t)b * Nq + m] > 0.f ? s * inv_sdl : kNegInf;
    }
    __syncthreads();
    if (tid < C) {
        float* p = ps + tid * Nq;
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

    for (int e = tid; e < C * dl; e += blockDim.x) {
        const int c = e / dl;
        const int d = e % dl;
        float a = 0.f;
        for (int m = 0; m < Nq; ++m) a += ps[c * Nq + m] * vs[m * dl + d];
        gs[e] = hs[e] * (a * vm + fsh[(size_t)b * dl + d]);
    }
    __syncthreads();

    for (int idx = warp; idx < C * C; idx += nwarps) {
        const int c = idx / C;
        const int e2 = idx % C;
        float s = 0.f;
        for (int d = lane; d < dl; d += 32) s += gs[c * dl + d] * gs[e2 * dl + d];
        s = vml::warp_sum(s);
        if (lane == 0) as[idx] = s * inv_sdl;
    }
    __syncthreads();
    if (tid < C) {
        float* a = as + tid * C;
        float mx = a[0];
        for (int e2 = 1; e2 < C; ++e2) mx = fmaxf(mx, a[e2]);
        float sum = 0.f;
        for (int e2 = 0; e2 < C; ++e2) {
            a[e2] = expf(a[e2] - mx);
            sum += a[e2];
        }
        for (int e2 = 0; e2 < C; ++e2) a[e2] = a[e2] / sum * vm;
    }
    __syncthreads();

    for (int e = tid; e < C * dl; e += blockDim.x) {
        const int c = e / dl;
        const int d = e % dl;
        float a = 0.f;
        for (int e2 = 0; e2 < C; ++e2) a += as[c * C + e2] * hs[e2 * dl + d];
        out[row0 * dl + e] = a;
    }
}

// The boundary unit between its projections, in two kernels of one block
// per (element, snippet row i). bq (B*L, D) = attn_q(fb), bk (B*Nq, D) =
// attn_k(fw); fw (B, Nq, D), fb (B, L, D), fs (B, D), fbar (B, N, D).
//
// boundary_query_kernel: word attention of row i (-1e9 key mask), then
// f_bq[i] = fb[i] * (f_baq[i] * lmask[i] + fs).
__global__ void boundary_query_kernel(int L, int Nq, int D, const float* __restrict__ bq,
                                      const float* __restrict__ bk,
                                      const float* __restrict__ fw,
                                      const float* __restrict__ fb,
                                      const float* __restrict__ fs,
                                      const float* __restrict__ qmask,
                                      const float* __restrict__ lmask,
                                      float* __restrict__ fbq) {
    extern __shared__ float smem[];
    float* p = smem;                  // (Nq,): word attention of row i
    const int row = blockIdx.x;       // b * L + i
    const int b = row / L;
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int nwarps = blockDim.x / 32;
    const float inv_sd = 1.f / sqrtf((float)D);
    const float* x = bq + (size_t)row * D;

    for (int m = warp; m < Nq; m += nwarps) {
        const float* y = bk + ((size_t)b * Nq + m) * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += x[d] * y[d];
        s = vml::warp_sum(s);
        if (lane == 0) p[m] = qmask[(size_t)b * Nq + m] > 0.f ? s * inv_sd : kNegInf;
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
    const float lm = lmask[row];
    const float* fwe = fw + (size_t)b * Nq * D;
    for (int d = tid; d < D; d += blockDim.x) {
        float a = 0.f;
        for (int m = 0; m < Nq; ++m) a += p[m] * fwe[(size_t)m * D + d];
        fbq[(size_t)row * D + d] = fb[(size_t)row * D + d] * (a * lm + fs[(size_t)b * D + d]);
    }
}

// boundary_unit_kernel: A_b[i] = softmax_j(f_bq[i] . f_bq[j] / sqrt(D), -1e9
// on invalid j) * lmask[i], then bu[i] = f_bb[i] + fb[i] + f_bm[i] with
// f_bb[i] = (A_b[i] @ fb) * lmask[i] and f_bm[i] = sum over pairs n = (i, j)
// of A_b[i, j] * fbar[n].
__global__ void boundary_unit_kernel(int L, int D, const float* __restrict__ fbq,
                                     const float* __restrict__ fb,
                                     const float* __restrict__ fbar,
                                     const float* __restrict__ lmask,
                                     float* __restrict__ bu) {
    extern __shared__ float smem[];
    float* a = smem;                  // (L,): A_b row i
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

    for (int j = warp; j < L; j += nwarps) {
        const float* y = fbq + ((size_t)b * L + j) * D;
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += x[d] * y[d];
        s = vml::warp_sum(s);
        if (lane == 0) a[j] = lm[j] > 0.f ? s * inv_sd : kNegInf;
    }
    __syncthreads();
    if (tid == 0) {
        float mx = a[0];
        for (int j = 1; j < L; ++j) mx = fmaxf(mx, a[j]);
        float sum = 0.f;
        for (int j = 0; j < L; ++j) {
            a[j] = expf(a[j] - mx);
            sum += a[j];
        }
        for (int j = 0; j < L; ++j) a[j] = a[j] / sum * lm[i];
    }
    __syncthreads();
    const float* fbe = fb + (size_t)b * L * D;
    const float* fbar_i = fbar + ((size_t)b * N + pair_index(i, i, L)) * D;
    for (int d = tid; d < D; d += blockDim.x) {
        float bb = 0.f;
        for (int j = 0; j < L; ++j) bb += a[j] * fbe[(size_t)j * D + d];
        float bm = 0.f;
        for (int j = i; j < L; ++j) bm += a[j] * fbar_i[(size_t)(j - i) * D + d];
        bu[(size_t)row * D + d] = bb * lm[i] + fbe[(size_t)i * D + d] + bm;
    }
}

// One block per (element, pair): x1 = bu[i_n] * bu[j_n], x2 = mean_c(cu).
__global__ void moment_prologue_kernel(int L, int C, int D, const float* __restrict__ bu,
                                       const float* __restrict__ cu,
                                       float* __restrict__ x1, float* __restrict__ x2) {
    const int N = L * (L + 1) / 2;
    const int pair = blockIdx.x;
    const int b = pair / N;
    int i, j;
    pair_of(pair % N, L, i, j);
    const float* bi = bu + ((size_t)b * L + i) * D;
    const float* bj = bu + ((size_t)b * L + j) * D;
    const float* cp = cu + (size_t)pair * C * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
        x1[(size_t)pair * D + d] = bi[d] * bj[d];
        float s = 0.f;
        for (int c = 0; c < C; ++c) s += cp[(size_t)c * D + d];
        x2[(size_t)pair * D + d] = s / (float)C;
    }
}

// One warp per output: pm (B*N) from fm, then ps, pe, pa (3, B*L) from fb.
__global__ void heads_kernel(int BN, int BL, int D, const float* __restrict__ fm,
                             const float* __restrict__ fb,
                             const float* __restrict__ vmask,
                             const float* __restrict__ lmask,
                             const float* w_pm, const float* b_pm,
                             const float* w_ps, const float* b_ps,
                             const float* w_pe, const float* b_pe,
                             const float* w_pa, const float* b_pa,
                             float* __restrict__ pm, float* __restrict__ pb) {
    const int lane = threadIdx.x % 32;
    const int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    if (r >= BN + 3 * BL) return;
    const float* x;
    const float* w;
    float bias, mask;
    float* dst;
    if (r < BN) {
        x = fm + (size_t)r * D;
        w = w_pm;
        bias = b_pm[0];
        mask = vmask[r];
        dst = pm + r;
    } else {
        const int head = (r - BN) / BL;
        const int q = (r - BN) % BL;
        x = fb + (size_t)q * D;
        w = head == 0 ? w_ps : (head == 1 ? w_pe : w_pa);
        bias = (head == 0 ? b_ps : (head == 1 ? b_pe : b_pa))[0];
        mask = lmask[q];
        dst = pb + (size_t)head * BL + q;
    }
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += x[d] * w[d];
    s = vml::warp_sum(s);
    if (lane == 0) *dst = vml::sigmoidf_(s + bias) * mask;
}

struct Workspace {
    float *fc, *cu, *fm, *mu, *fb, *bu, *fbar, *h, *q, *fcc, *fwh, *khat, *fsh, *bq,
        *bk, *fbq, *x1, *x2, *tmp;
};

// Carves the workspace; returns its size in floats (ws may be null).
size_t carve(float* ws, int B, int L, int C, int Nq, int D, int dl, Workspace* w) {
    const size_t N = (size_t)L * (L + 1) / 2;
    const size_t NC = N * C;
    const size_t sizes[] = {
        B * NC * D, B * NC * D,                 // fc, cu
        B * N * D, B * N * D,                   // fm, mu
        (size_t)B * L * D, (size_t)B * L * D,   // fb, bu
        B * N * D,                              // fbar
        B * NC * dl, B * NC * dl, B * NC * dl,  // h, q, fcc
        (size_t)B * Nq * dl, (size_t)B * Nq * dl, (size_t)B * dl,  // fwh, khat, fsh
        (size_t)B * L * D, (size_t)B * Nq * D,  // bq, bk
        (size_t)B * L * D,                      // fbq
        B * N * D, B * N * D, B * N * D,        // x1, x2, tmp
    };
    float** slots[] = {&w->fc, &w->cu, &w->fm, &w->mu, &w->fb, &w->bu, &w->fbar,
                       &w->h, &w->q, &w->fcc, &w->fwh, &w->khat, &w->fsh, &w->bq,
                       &w->bk, &w->fbq, &w->x1, &w->x2, &w->tmp};
    size_t off = 0;
    for (int k = 0; k < 19; ++k) {
        *slots[k] = ws ? ws + off : nullptr;
        off += (sizes[k] + 3) / 4 * 4;   // keep every slot 16-byte aligned
    }
    return off;
}

size_t content_smem_bytes(int C, int Nq, int dl) {
    return sizeof(float) * ((size_t)2 * Nq * dl + (size_t)3 * C * dl + (size_t)C * Nq + C * C);
}



}  // namespace

extern "C" {

size_t vml_smin_workspace_floats(int B, int L, int C, int Nq, int D, int dl) {
    Workspace w;
    return carve(nullptr, B, L, C, Nq, D, dl, &w);
}

// Largest dynamic shared memory of the entry's kernels, for the wrapper's
// admission check against the 227 KB a block may have.
size_t vml_smin_smem_bytes(int L, int C, int Nq, int D, int dl) {
    const size_t a = content_smem_bytes(C, Nq, dl);
    const size_t b = sizeof(float) * (size_t)(Nq > L ? Nq : L);   // boundary kernels
    return a > b ? a : b;
}

// layer_w: host array of n_layers * 20 device pointers per layer, in order
//   c_hat.w, c_hat.b, w_hat.w, w_hat.b, s_hat.w, s_hat.b, c_out.w, c_out.b,
//   content attn W_q.w, .b, W_k.w, .b, boundary attn W_q.w, .b, W_k.w, .b,
//   conv_fb.w, .b, conv_fc.w, .b
// (torch layouts: Linear (out, in), 1x1 conv (out, in, 1, 1)).
// head_w: host array of 8 device pointers: pm.w, pm.b, ps.w, ps.b, pe.w,
// pe.b, pa.w, pa.b. Outputs pm (B, N) and pb (3, B, L) = ps, pe, pa.
// Returns the first CUDA error of the launches, 0 if none.
int vml_smin_stack_f32(void* stream, int B, int T, int L, int C, int Nq, int D, int dl,
                       int n_layers, const float* f, const float* fw, const float* fs,
                       const float* qmask, const float* lmask, const float* vmask,
                       const float* const* layer_w, const float* const* head_w,
                       float* ws, float* pm, float* pb) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int N = L * (L + 1) / 2;
    const int NC = N * C;
    Workspace w;
    carve(ws, B, L, C, Nq, D, dl, &w);
    cudaError_t err;
#define VML_CHECK()                                                  \
    do {                                                             \
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err; \
    } while (0)

    const size_t csmem = content_smem_bytes(C, Nq, dl);
    if ((err = cudaFuncSetAttribute(content_attn_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)csmem)) != cudaSuccess)
        return (int)err;

    pool_kernel<<<B * (N + L), 128, 0, st>>>(T, L, C, D, f, vmask, w.fc, w.fm, w.fb);
    VML_CHECK();

    const size_t nd = (size_t)B * N * D;
    const int gate_blocks = (int)((nd + 255) / 256 < 4096 ? (nd + 255) / 256 : 4096);
    for (int layer = 0; layer < n_layers; ++layer) {
        const float* const* p = layer_w + (size_t)layer * kWeightsPerLayer;
        gate_kernel<<<gate_blocks, 256, 0, st>>>(nd, N * D, D, w.fm, fs, w.fbar);
        VML_CHECK();

        // ContentUnit
        vml::Epilogue ep;
        ep.bias = p[1];
        ep.rmask = vmask;
        ep.mask_div = C;
        vml::gemm_nt(st, B * NC, dl, D, w.fc, D, p[0], D, w.h, dl, ep);   // c_hat * vmask
        VML_CHECK();
        vml::linear(st, B * NC, dl, dl, w.h, p[8], p[9], w.q);             // attn_q
        VML_CHECK();
        ep = vml::Epilogue();
        ep.bias = p[3];
        ep.rmask = qmask;
        vml::gemm_nt(st, B * Nq, dl, D, fw, D, p[2], D, w.fwh, dl, ep);   // w_hat * qmask
        VML_CHECK();
        vml::linear(st, B * Nq, dl, dl, w.fwh, p[10], p[11], w.khat);      // attn_k
        VML_CHECK();
        vml::linear(st, B, dl, D, fs, p[4], p[5], w.fsh);                  // s_hat
        VML_CHECK();
        content_attn_kernel<<<B * N, 128, csmem, st>>>(N, C, Nq, dl, w.h, w.q, w.khat,
                                                       w.fwh, w.fsh, qmask, vmask, w.fcc);
        VML_CHECK();
        ep = vml::Epilogue();     // cu = c_out(f_cc_hat) * vmask + fc + fbar
        ep.bias = p[7];
        ep.rmask = vmask;
        ep.mask_div = C;
        ep.post = w.fc;
        ep.ldpost = D;
        ep.post2 = w.fbar;
        ep.ldpost2 = D;
        ep.post2_div = C;
        vml::gemm_nt(st, B * NC, D, dl, w.fcc, dl, p[6], dl, w.cu, D, ep);
        VML_CHECK();

        // BoundaryUnit
        vml::linear(st, B * L, D, D, w.fb, p[12], p[13], w.bq);
        VML_CHECK();
        vml::linear(st, B * Nq, D, D, fw, p[14], p[15], w.bk);
        VML_CHECK();
        boundary_query_kernel<<<B * L, 128, Nq * sizeof(float), st>>>(
            L, Nq, D, w.bq, w.bk, fw, w.fb, fs, qmask, lmask, w.fbq);
        VML_CHECK();
        boundary_unit_kernel<<<B * L, 128, L * sizeof(float), st>>>(L, D, w.fbq, w.fb, w.fbar,
                                                                    lmask, w.bu);
        VML_CHECK();

        // MomentUnit: mu = (conv_fb(outer) + conv_fc(mean_c cu)) * vmask + fm
        moment_prologue_kernel<<<B * N, 128, 0, st>>>(L, C, D, w.bu, w.cu, w.x1, w.x2);
        VML_CHECK();
        vml::linear(st, B * N, D, D, w.x1, p[16], p[17], w.tmp);
        VML_CHECK();
        ep = vml::Epilogue();
        ep.bias = p[19];
        ep.pre = w.tmp;
        ep.ldpre = D;
        ep.rmask = vmask;
        ep.post = w.fm;
        ep.ldpost = D;
        vml::gemm_nt(st, B * N, D, D, w.x2, D, p[18], D, w.mu, D, ep);
        VML_CHECK();

        float* t;
        t = w.fc; w.fc = w.cu; w.cu = t;
        t = w.fm; w.fm = w.mu; w.mu = t;
        t = w.fb; w.fb = w.bu; w.bu = t;
    }

    const int outputs = B * N + 3 * B * L;
    heads_kernel<<<(outputs * 32 + 255) / 256, 256, 0, st>>>(
        B * N, B * L, D, w.fm, w.fb, vmask, lmask, head_w[0], head_w[1], head_w[2],
        head_w[3], head_w[4], head_w[5], head_w[6], head_w[7], pm, pb);
    VML_CHECK();
#undef VML_CHECK
    return 0;
}

}  // extern "C"
