// K1 and K8: proposal features of the training path, forward and backward,
// in the packed layout (K1, and K6 behind its own Python entry) and in the
// dense layout (K8).
//
// Replaces ops/proposal_pallas.py::proposal_features_rows of the JAX package
// (`_rows_kernel`) and its backward (`_rows_bwd` / `_rows_bwd_kernel`), and
// ::_fc_fm_pallas (`_row_kernel`, K8), whose backward is the XLA VJP of the
// prefix sums (ops/proposal.py::proposal_features).
// Forward: f (B, T, D) -> fc (B, P, C, D) clip means masked per moment, fm
// (B, P, D) their mean over C, fb (B, L, D) window means; P = N pairs masked
// by their validity (packed), or P = L * L cells masked by a given
// moment_mask (dense; zeros below the diagonal). Backward: the cotangents of
// the three -> df (B, T, D); none flows to the mask.
//
// The TPU kernels multiply f by the dense averaging matrix Wc on the MXU (K1
// emits c-major rows for its tiling; K8 one (L*C, T) @ (T, D) per map row).
// Every row of Wc is 1/len on one contiguous run of frames
// (ops/content_matrix.py), so here both directions work on those runs, and
// fc is n-major, the layout of the SMI kernels. Both layouts are one copy of
// each kernel, templated on the layout.
//
// Forward: vml::pool_kernel (proposal.cuh, shared with the serving stack),
// one block per (element, 32 columns) that stages f's tile once as fp64
// prefix sums and writes every output row from shared memory.
//
// Backward: the transpose of a mean over a run [s, e) adds g at s and
// subtracts it at e of a difference array whose prefix sum over t is the
// frame's gradient. One block owns (element, 32 columns) with W warps, each
// with a T x 32 fp32 difference array of its own in shared memory: two
// blocks of 8 warps per SM where they fit (Charades), else as many warps as
// fit, up to 16 (12 at the ActivityNet map). The block stages the element's
// pair masks and its dfb tile in shared memory. Warp w takes the pairs
// q = w (mod W) of the np.triu_indices order, finds the unmasked ones 32 at a
// time by one ballot, loads the cotangent rows of 4 of them (each row read
// once, as a 128-byte segment) and then scatters their clip boundaries. Then
// the block sums the W arrays in warp order, scans them over t in fp64 (a
// two-level scan in fixed order) and adds dfb. No atomics: the sums are taken
// in one fixed order, so two launches give the same bits. A moment whose mask
// is 0 costs no read of its rows; a dense cell below the diagonal is never
// visited.
//
// What bounds them on the H100: bytes. K1's forward reads 131 KB and writes
// 1.4 MB per element at the Charades shapes (T=64, L=16, C=4, D=512); K8
// writes 2.6 MB (the L * L cells); each backward reads the cotangents of the
// N = L(L+1)/2 cells i <= j once and writes 131 KB.
//
// K1-bf16 and K8-bf16 (the training paths at bf16) are the same two
// kernels on bf16 f, fc, fm, fb and cotangents: the prefix sums, difference
// arrays and scans stay fp32 / fp64, and each output is rounded once to bf16
// (the JAX kernels sum in fp32 and round their store; K1's backward
// accumulates df in fp32, K8's is the XLA VJP of the fp32 prefix sums). They
// move half the bytes of K1 and K8. At ActivityNet B=64 the dense fc of K8
// holds 2^29 elements (2.1 GB at fp32): every offset into it is 64-bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm.cuh"
#include "proposal.cuh"

namespace {

constexpr int kMaxWarps = 16;  // warps of a block, each with its own difference array
constexpr int kPairWarps = 8;  // warps of a block where two such blocks fit an SM
constexpr int kGroup = 4;      // moments of a warp whose rows load together
constexpr int kSlots = 5;      // clip boundaries of a moment scattered together (C + 1 at C = 4)
constexpr size_t kBlockSmem = 232448;   // shared memory one H100 block may have
constexpr size_t kSmSmem = 233472;      // shared memory of one H100 SM
constexpr size_t kReserved = 1024;      // of it reserved per block
constexpr size_t kStatic = (size_t)kMaxWarps * vml::kPropCols * sizeof(double);  // run_total

// Dynamic shared memory beside the difference arrays: the N pair masks and
// the L x 32 tile of dfb.
size_t scatter_extra_bytes(int L) {
    return ((size_t)L * (L + 1) / 2 + (size_t)L * vml::kPropCols) * sizeof(float);
}

// Warps of a backward block at T frames: two blocks of 8 per SM where they
// fit (one block's scan runs while the other's rows load), else one block
// with as many T x 32 fp32 difference arrays as fit, up to 16 (12 at the
// ActivityNet map); 0 if not even one fits.
int scatter_warps(int T, int L) {
    const size_t per_warp = (size_t)T * vml::kPropCols * sizeof(float);
    const size_t extra = scatter_extra_bytes(L) + kStatic;
    if (2 * (kPairWarps * per_warp + extra + kReserved) <= kSmSmem) return kPairWarps;
    if (extra + per_warp > kBlockSmem) return 0;
    const size_t w = (kBlockSmem - extra) / per_warp;
    return (int)(w < (size_t)kMaxWarps ? w : kMaxWarps);
}

// Dynamic shared memory of the backward.
size_t scatter_smem_bytes(int T, int L) {
    const int w = scatter_warps(T, L) > 0 ? scatter_warps(T, L) : 1;
    return (size_t)w * T * vml::kPropCols * sizeof(float) + scatter_extra_bytes(L);
}

// Sum over the W warps' difference arrays at frame t, in warp order, fp64.
__device__ __forceinline__ double frame_sum(const float* diff, int W, int T, int t, int lane) {
    double s = 0.0;
    for (int w = 0; w < W; ++w) s += diff[((size_t)w * T + t) * vml::kPropCols + lane];
    return s;
}

// grid B * ceil(D / 32), one block per (element, column tile), blockDim
// 32 * scatter_warps(T, L).
//   df[t] = sum over (n, c) with t in clip (n, c) of
//             g(n, c) = (dfc[n, c] + dfm[n] / C) * (mask[n] / clip_len(n))
//           + dfb[t / (T/L)] / (T/L)
// (fm is the mean over all C clips of the masked fc, so its cotangent
// spreads /C onto every existing clip.) Moment n's clips tile one run of
// frames, so its difference array gets g(n, 0) at the first clip's start,
// g(n, c) - g(n, c-1) at each later clip's start and -g(n, last) at the
// last clip's end (dropped where that end is T). Warp w of W walks the pairs
// q = w (mod W) of the np.triu_indices order, 32 at a time with one ballot
// over their staged masks, and fills each group with its next kGroup moments
// whose mask is not 0; a moment's boundaries are distinct frames, so its
// slots are read together and then written together.
// T_: the element type of the cotangents and df (fp32, or bf16 for K1-bf16
// and K8-bf16: read as fp32, the scatter and scan in fp32 / fp64 as at fp32,
// df rounded once to bf16).
template <bool Dense, typename T_ = float>
__global__ void __launch_bounds__(kMaxWarps * 32)
proposal_bwd_kernel(int T, int L, int C, int D, const float* __restrict__ mask,
                    const T_* __restrict__ dfc, const T_* __restrict__ dfm,
                    const T_* __restrict__ dfb, T_* __restrict__ df) {
    constexpr int COLS = vml::kPropCols;
    extern __shared__ float smem[];
    __shared__ double run_total[kMaxWarps][COLS];
    const int W = blockDim.x / 32;
    const int P = Dense ? L * L : L * (L + 1) / 2;
    const int N = L * (L + 1) / 2;
    float* diff = smem;                             // [W][T][COLS]
    float* pair_mask = smem + (size_t)W * T * COLS; // [N]
    float* dfb_s = pair_mask + N;                   // [L][COLS]
    const int tiles = (D + COLS - 1) / COLS;
    const int tile = blockIdx.x % tiles;
    const int b = blockIdx.x / tiles;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int d = tile * COLS + lane;
    const bool live = d < D;
    const int tl = T / L;
    const float inv_c = 1.f / (float)C;
    const T_* dfc_b = dfc + (size_t)b * P * C * D + d;
    const T_* dfm_b = dfm + (size_t)b * P * D + d;

    float* mine = diff + (size_t)warp * T * COLS;
    for (int t = 0; t < T; ++t) mine[t * COLS + lane] = 0.f;
    for (int l = warp; l < L; l += W)
        dfb_s[l * COLS + lane] = live ? vml::to_f(dfb[((size_t)b * L + l) * D + d]) : 0.f;
    {
        int q = threadIdx.x, i = 0, j = 0;
        if (q < N) vml::pair_of(q, L, i, j);
        while (q < N) {
            pair_mask[q] = vml::moment_mask<Dense>(mask, b, L, i, j);
            q += blockDim.x;
            if (q < N) vml::advance_moment<false>(blockDim.x, L, i, j);
        }
    }
    __syncthreads();

    // The window: the 32 pairs base + r * W, r < 32, of which `bits` marks
    // those not yet taken whose mask is not 0. (wq, wi, wj): a walker over
    // the warp's pairs.
    int base = warp;
    unsigned bits = __ballot_sync(0xffffffffu,
                                  base + lane * W < N && pair_mask[base + lane * W] != 0.f);
    int wq = warp, wi = 0, wj = 0;
    if (wq < N) vml::pair_of(wq, L, wi, wj);
    while (true) {
        int n[kGroup], start[kGroup], clip[kGroup], valid[kGroup];
        float wk[kGroup], gm[kGroup], prev[kGroup];
        bool any = false;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
            n[k] = start[k] = valid[k] = 0;
            clip[k] = 1;
            wk[k] = gm[k] = prev[k] = 0.f;
            while (bits == 0 && base + 32 * W < N) {
                base += 32 * W;
                bits = __ballot_sync(0xffffffffu, base + lane * W < N &&
                                                      pair_mask[base + lane * W] != 0.f);
            }
            if (bits == 0) continue;
            const int q = base + (__ffs(bits) - 1) * W;
            bits &= bits - 1;
            vml::advance_moment<false>(q - wq, L, wi, wj);
            wq = q;
            const int frames = (wj - wi + 1) * tl;
            n[k] = vml::moment_index<Dense>(wi, wj, L);
            start[k] = wi * tl;
            clip[k] = max(1, frames / C);
            valid[k] = min(C, frames);
            wk[k] = pair_mask[q] / (float)clip[k];
            any = true;
        }
        if (!any) break;
#pragma unroll
        for (int k = 0; k < kGroup; ++k)
            if (live && valid[k] > 0) gm[k] = vml::to_f(dfm_b[(size_t)n[k] * D]) * inv_c;
        for (int c0 = 0; c0 <= C; c0 += kSlots) {
            float v[kGroup][kSlots];
#pragma unroll
            for (int k = 0; k < kGroup; ++k)
#pragma unroll
                for (int s = 0; s < kSlots; ++s)
                    v[k][s] = (live && c0 + s < valid[k])
                                  ? vml::to_f(dfc_b[((size_t)n[k] * C + c0 + s) * D]) : 0.f;
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
                if (valid[k] == 0) continue;
                float old[kSlots], delta[kSlots];
                int pos[kSlots];
                bool on[kSlots];
#pragma unroll
                for (int s = 0; s < kSlots; ++s) {
                    const int c = c0 + s;
                    const float g = c < valid[k] ? (v[k][s] + gm[k]) * wk[k] : 0.f;
                    delta[s] = g - prev[k];
                    prev[k] = g;
                    pos[s] = start[k] + c * clip[k];
                    on[s] = c <= valid[k] && pos[s] < T;
                }
#pragma unroll
                for (int s = 0; s < kSlots; ++s)
                    if (on[s]) old[s] = mine[pos[s] * COLS + lane];
#pragma unroll
                for (int s = 0; s < kSlots; ++s)
                    if (on[s]) mine[pos[s] * COLS + lane] = old[s] + delta[s];
            }
        }
    }
    __syncthreads();

    // Sum the warps' arrays at each frame in warp order and scan over t, in
    // fp64: warp w takes a run of frames, adds the totals of the runs before
    // it in order, then recomputes its running sum (the same additions) for
    // the output.
    const int run = (T + W - 1) / W;
    const int t0 = min(T, warp * run), t1 = min(T, t0 + run);
    double acc = 0.0;
    for (int t = t0; t < t1; ++t) acc += frame_sum(diff, W, T, t, lane);
    run_total[warp][lane] = acc;
    __syncthreads();
    acc = 0.0;
    for (int w = 0; w < warp; ++w) acc += run_total[w][lane];
    for (int t = t0; t < t1; ++t) {
        acc += frame_sum(diff, W, T, t, lane);
        if (live)
            df[((size_t)b * T + t) * D + d] = vml::from_f<T_>(
                (float)(acc + (double)dfb_s[(t / tl) * COLS + lane] / (double)tl));
    }
}

template <bool Dense, typename T_ = float>
int forward(void* stream, int B, int T, int L, int C, int D, const T_* f, const float* mask,
            T_* fc, T_* fm, T_* fb) {
    return (int)vml::pool_forward<Dense, T_, T_>(static_cast<cudaStream_t>(stream), B, T, L, C,
                                                 D, f, mask, fc, fm, fb);
}

template <bool Dense, typename T_ = float>
int backward(void* stream, int B, int T, int L, int C, int D, const float* mask,
             const T_* dfc, const T_* dfm, const T_* dfb, T_* df) {
    const int warps = scatter_warps(T, L);
    if (warps == 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(proposal_bwd_kernel<Dense, T_>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)scatter_smem_bytes(T, L));
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)B * ((D + vml::kPropCols - 1) / vml::kPropCols);
    proposal_bwd_kernel<Dense, T_><<<(unsigned)blocks, warps * 32, scatter_smem_bytes(T, L),
                                     static_cast<cudaStream_t>(stream)>>>(T, L, C, D, mask, dfc,
                                                                          dfm, dfb, df);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory per block, dynamic and static, of the forward and of the
// backward, for the wrapper's admission check against the 227 KB a block
// may have (the backward needs at least one warp's difference array).
size_t vml_proposal_smem_bytes(int T, int L, int backward_pass) {
    if (backward_pass) return scatter_smem_bytes(T, L) + kStatic;
    return vml::pool_smem_bytes(T) + vml::kRunTotalBytes;
}

// K1. f (B, T, D), length_mask (B, L) -> fc (B, N, C, D) masked by the pair
// validity, fm (B, N, D), fb (B, L, D). Returns the launch's CUDA error, 0 if
// none.
int vml_proposal_rows_fwd_f32(void* stream, int B, int T, int L, int C, int D,
                              const float* f, const float* length_mask, float* fc, float* fm,
                              float* fb) {
    return forward<false>(stream, B, T, L, C, D, f, length_mask, fc, fm, fb);
}

// length_mask (B, L), dfc (B, N, C, D), dfm (B, N, D), dfb (B, L, D)
// -> df (B, T, D).
int vml_proposal_rows_bwd_f32(void* stream, int B, int T, int L, int C, int D,
                              const float* length_mask, const float* dfc, const float* dfm,
                              const float* dfb, float* df) {
    return backward<false>(stream, B, T, L, C, D, length_mask, dfc, dfm, dfb, df);
}

// K1-bf16: K1 on bf16 f, fc, fm and fb (fp64 prefix sums as at fp32, each
// output rounded once to bf16).
int vml_proposal_rows_fwd_bf16(void* stream, int B, int T, int L, int C, int D,
                               const vml::bf16* f, const float* length_mask, vml::bf16* fc,
                               vml::bf16* fm, vml::bf16* fb) {
    return forward<false>(stream, B, T, L, C, D, f, length_mask, fc, fm, fb);
}

// K1-bf16 backward: bf16 cotangents, df (B, T, D) rounded once to bf16.
int vml_proposal_rows_bwd_bf16(void* stream, int B, int T, int L, int C, int D,
                               const float* length_mask, const vml::bf16* dfc,
                               const vml::bf16* dfm, const vml::bf16* dfb, vml::bf16* df) {
    return backward<false>(stream, B, T, L, C, D, length_mask, dfc, dfm, dfb, df);
}

// K8. f (B, T, D), moment_mask (B, L, L) -> fc (B, L, L, C, D),
// fm (B, L, L, D), fb (B, L, D).
int vml_proposal_dense_fwd_f32(void* stream, int B, int T, int L, int C, int D,
                               const float* f, const float* moment_mask, float* fc, float* fm,
                               float* fb) {
    return forward<true>(stream, B, T, L, C, D, f, moment_mask, fc, fm, fb);
}

// moment_mask (B, L, L), dfc (B, L, L, C, D), dfm (B, L, L, D), dfb (B, L, D)
// -> df (B, T, D).
int vml_proposal_dense_bwd_f32(void* stream, int B, int T, int L, int C, int D,
                               const float* moment_mask, const float* dfc, const float* dfm,
                               const float* dfb, float* df) {
    return backward<true>(stream, B, T, L, C, D, moment_mask, dfc, dfm, dfb, df);
}

// K8-bf16: K8 on bf16 f, fc, fm and fb (fp64 prefix sums as at fp32, each
// output rounded once to bf16); the moment_mask stays fp32.
int vml_proposal_dense_fwd_bf16(void* stream, int B, int T, int L, int C, int D,
                                const vml::bf16* f, const float* moment_mask, vml::bf16* fc,
                                vml::bf16* fm, vml::bf16* fb) {
    return forward<true>(stream, B, T, L, C, D, f, moment_mask, fc, fm, fb);
}

// K8-bf16 backward: bf16 cotangents, df (B, T, D) rounded once to bf16.
int vml_proposal_dense_bwd_bf16(void* stream, int B, int T, int L, int C, int D,
                                const float* moment_mask, const vml::bf16* dfc,
                                const vml::bf16* dfm, const vml::bf16* dfb, vml::bf16* df) {
    return backward<true>(stream, B, T, L, C, D, moment_mask, dfc, dfm, dfb, df);
}

}  // extern "C"
