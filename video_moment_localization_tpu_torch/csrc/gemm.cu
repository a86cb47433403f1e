// The shared GEMM of gemm.cuh on its own, for the card tests and the GEMM
// phase of chip_smoke.py (ops/gemm_cuda.py): each fp32 layout with every
// epilogue term, `ascale`, a forced block tile and path (CUDA cores or
// 3xTF32 tensor cores) and gemm_tn's fused column sums; the bf16 path's
// three layouts and two-problem launches with their epilogues, on either of
// its kernels; plus the host-side plans (path, tile, split-K, shared memory,
// the wgmma kernel's tiles and blocks) that the Python mirror in
// ops/gemm_cuda.py is held against. It replaces no TPU kernel: the JAX
// package's kernels run their products inside each Pallas body, and the
// port's kernels run them through this header.
#include <cuda_runtime.h>

#include "gemm.cuh"

extern "C" {

// layout 0: C = ep(A @ W^T), A (M, K), W (N, K); 1: C = ep((A * ascale) @ W),
// W (K, N); 2: C (M, N) = (A * ascale)^T @ W, A (K, M), W (K, N), through
// `partial` (vml_gemm_tn_partial_floats floats), bias_out (M,) the column
// sums of the scaled A when not null; no epilogue. tile: -1 by shape, else a
// vml::GemmTile (layouts 0 and 1); path: -1 by shape, else a vml::GemmPath.
// Returns the launch's CUDA error, 0 if none.
int vml_gemm_f32(void* stream, int layout, int M, int N, int K, const float* A, int lda,
                 const float* ascale, int adiv, const float* W, int ldw, float* C, int ldc,
                 const float* bias, const float* pre, int ldpre, const float* rmask,
                 int mask_div, const float* post, int ldpost, const float* post2, int ldpost2,
                 int post2_div, int tile, float* partial, float* bias_out, int path) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    vml::Epilogue ep;
    ep.bias = bias;
    ep.pre = pre;
    ep.ldpre = ldpre;
    ep.rmask = rmask;
    ep.mask_div = mask_div;
    ep.post = post;
    ep.ldpost = ldpost;
    ep.post2 = post2;
    ep.ldpost2 = ldpost2;
    ep.post2_div = post2_div;
    if (layout == 0)
        vml::gemm_nt(st, M, N, K, A, lda, W, ldw, C, ldc, ep, tile, path);
    else if (layout == 1)
        vml::gemm_nn(st, M, N, K, A, lda, ascale, adiv, W, ldw, C, ldc, ep, tile, path);
    else
        vml::gemm_tn(st, M, N, K, A, lda, ascale, adiv, W, ldw, partial, C, bias_out, path);
    return (int)cudaGetLastError();
}

// The block tile gemm_nt / gemm_nn pick for `groups` products of (M, N).
int vml_gemm_tile_for(int M, int N, int groups) { return vml::gemm_tile_for(M, N, groups); }

// The path (vml::GemmPath) a launch of a layout (0 nt, 1 nn, 2 tn) takes for
// `groups` products of (M, N, K) (gemm_tn: K the rows it reduces).
int vml_gemm_path_for(int layout, int M, int N, int K, int groups) {
    return vml::gemm_path_for(layout, M, N, K, groups);
}

// The path the moment unit's product takes at every shape (the one call
// site that fixes its path).
int vml_gemm_moment_path() { return vml::kMomentProductPath; }

// gemm_tn's split of its R rows: *splits blocks along z of *kchunk rows.
void vml_gemm_splitk(int M, int N, int R, int* splits, int* kchunk) {
    const vml::SplitK s = vml::splitk_for(M, N, R);
    *splits = s.splits;
    *kchunk = s.kchunk;
}

// Dynamic shared memory of one block of a path, layout (0 nt, 1 nn, 2 tn)
// and tile.
size_t vml_gemm_smem_bytes(int path, int layout, int tile) {
    using vml::gemm_smem_bytes;
    if (path == vml::kPathBf16) return vml::gemm_bf16_smem_bytes_for(layout, tile);
    if (path == vml::kPathBf16Wg) return vml::gemm_bf16_wg_smem_bytes(layout);
    const size_t bytes[3][3] = {
        {gemm_smem_bytes<128, 128, false, false>(path), gemm_smem_bytes<128, 64, false, false>(path),
         gemm_smem_bytes<64, 64, false, false>(path)},
        {gemm_smem_bytes<128, 128, false, true>(path), gemm_smem_bytes<128, 64, false, true>(path),
         gemm_smem_bytes<64, 64, false, true>(path)},
        {gemm_smem_bytes<128, 128, true, true>(path), gemm_smem_bytes<128, 64, true, true>(path),
         gemm_smem_bytes<64, 64, true, true>(path)}};
    return bytes[layout][tile];
}

// The path of a bf16 product of a layout (0 nt, 1 nn, 2 tn) whose operands
// TMA can read (tma_ok) or cannot.
int vml_gemm_path_for_bf16(int layout, int tma_ok) {
    return vml::gemm_path_for_bf16(layout, tma_ok != 0);
}

// The wgmma kernel's plan for one launch of a layout (0 nt, 1 nn, 2 tn)
// over `groups` products of (M, N, K) split `splits` ways of `kchunk` rows:
// out[0] its dynamic shared memory, out[1] its tiles, out[2] its blocks,
// out[3] the slices of a tile's K (of the first split), out[4] the stages
// of its ring, out[5] its threads, out[6] the rows of a tile.
void vml_gemm_bf16_wg_plan(int layout, int M, int N, int K, int groups, int splits, int kchunk,
                           long long* out) {
    const bool tn = layout == 2;
    const int bk = tn ? vml::WgBf<true>::kBK : vml::WgBf<false>::kBK;
    out[0] = (long long)vml::gemm_bf16_wg_smem_bytes(layout);
    out[1] = vml::gemm_bf16_wg_tiles(layout, M, N, groups, splits);
    out[2] = vml::gemm_bf16_wg_blocks(out[1]);
    out[3] = ((kchunk < K ? kchunk : K) + bk - 1) / bk;
    out[4] = tn ? vml::WgBf<true>::kStages : vml::WgBf<false>::kStages;
    out[5] = vml::kWgBfThreads;
    out[6] = tn ? vml::WgBf<true>::kRows : vml::WgBf<false>::kRows;
}

// The bf16 path in every form: layout 0 (nt: C = ep(A @ W0^T), A (M, K), W
// (N, K)) or 1 (nn: W (K, N)) over one problem, or two sharing A when W1 is
// given (C1 its output; nt2 writes bf16; the second problem takes the
// first's epilogue terms but bias1 for its bias), with every epilogue term
// (bias, rmask fp32; pre and post32 fp32, post and post2 bf16; round_each),
// out_f32 choosing the output type; layout 2 (tn): C0 (M, N) fp32 = (A *
// ascale)^T @ W0, A (K, M), W0 (K, N), through `partial`
// (vml_gemm_tn_partial_floats floats), bias_out (M,) the column sums of the
// scaled A when not null; with C1 the product's columns split at ldc
// (`vml::product_tn2`): C0 (M, ldc) and C1 (M, N - ldc). path: -1 by the
// plan, else vml::kPathBf16 (mma.sync) or vml::kPathBf16Wg (wgmma). Returns
// the launch's CUDA error, 0 if none.
int vml_gemm_bf16_general(void* stream, int layout, int M, int N, int K, const vml::bf16* A,
                          int lda, const float* ascale, int adiv, const vml::bf16* W0,
                          const vml::bf16* W1, int ldw, void* C0, void* C1, int ldc, int out_f32,
                          const float* bias0, const float* bias1, const float* pre, int ldpre,
                          const float* rmask, int mask_div, const vml::bf16* post, int ldpost,
                          const float* post32, int ldpost32, const vml::bf16* post2,
                          int ldpost2, int post2_div, int round_each, float* partial,
                          float* bias_out, int path) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (layout == 2) {
        vml::gemm_tn_bf16(st, M, N, K, A, lda, ascale, adiv, W0, ldw, partial,
                          static_cast<float*>(C0), bias_out, path, C1 ? ldc : 0,
                          static_cast<float*>(C1));
        return (int)cudaGetLastError();
    }
    vml::EpilogueBf16 ep;
    ep.bias = bias0;
    ep.pre = pre;
    ep.ldpre = ldpre;
    ep.rmask = rmask;
    ep.mask_div = mask_div;
    ep.post = post;
    ep.ldpost = ldpost;
    ep.post32 = post32;
    ep.ldpost32 = ldpost32;
    ep.post2 = post2;
    ep.ldpost2 = ldpost2;
    ep.post2_div = post2_div;
    ep.round_each = round_each != 0;
    vml::EpilogueBf16 ep1 = ep;
    ep1.bias = bias1;
    if (W1 == nullptr && layout == 0)
        vml::gemm_nt_bf16(st, M, N, K, A, lda, W0, ldw, C0, ldc, out_f32 != 0, ep, -1, path);
    else if (W1 == nullptr)
        vml::gemm_nn_bf16(st, M, N, K, A, lda, W0, ldw, C0, ldc, out_f32 != 0, ep, -1, path);
    else if (layout == 0)
        vml::gemm_nt2_bf16(st, M, N, K, A, lda, W0, W1, ldw, static_cast<vml::bf16*>(C0),
                           static_cast<vml::bf16*>(C1), ldc, ep, ep1, path);
    else
        vml::gemm_nn2_bf16(st, M, N, K, A, lda, W0, W1, ldw, C0, C1, ldc, out_f32 != 0, ep, ep1,
                           path);
    return (int)cudaGetLastError();
}

size_t vml_gemm_tn_partial_floats(int M, int N, int R) {
    return vml::gemm_tn_partial_floats(M, N, R);
}

}  // extern "C"
