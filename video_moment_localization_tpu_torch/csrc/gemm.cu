// The shared GEMM of gemm.cuh on its own, for the card tests and the GEMM
// phase of chip_smoke.py (ops/gemm_cuda.py): each fp32 layout with every
// epilogue term, `ascale`, a forced block tile and path (CUDA cores or
// 3xTF32 tensor cores) and gemm_tn's fused column sums; the bf16 path's
// three layouts with their epilogues; plus the host-side plans (path, tile, split-K,
// shared memory) that the Python mirror in ops/gemm_cuda.py is held
// against. It replaces no TPU kernel: the JAX
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
    const size_t bytes[3][3] = {
        {gemm_smem_bytes<128, 128, false, false>(path), gemm_smem_bytes<128, 64, false, false>(path),
         gemm_smem_bytes<64, 64, false, false>(path)},
        {gemm_smem_bytes<128, 128, false, true>(path), gemm_smem_bytes<128, 64, false, true>(path),
         gemm_smem_bytes<64, 64, false, true>(path)},
        {gemm_smem_bytes<128, 128, true, true>(path), gemm_smem_bytes<128, 64, true, true>(path),
         gemm_smem_bytes<64, 64, true, true>(path)}};
    return bytes[layout][tile];
}

// The path of a bf16 product of a layout (0 nt, 1 nn, 2 tn).
int vml_gemm_path_for_bf16(int layout) { return vml::gemm_path_for_bf16(layout); }

// C = ep(A @ W^T) with A (M, K), W (N, K) bf16, bias and rmask fp32, post
// and post2 bf16; C bf16, or fp32 when out_f32. tile: -1 by shape, else a
// vml::GemmTile. Returns the launch's CUDA error, 0 if none.
int vml_gemm_bf16(void* stream, int M, int N, int K, const vml::bf16* A, int lda,
                  const vml::bf16* W, int ldw, void* C, int ldc, int out_f32, const float* bias,
                  const float* rmask, int mask_div, const vml::bf16* post, int ldpost,
                  const vml::bf16* post2, int ldpost2, int post2_div, int tile) {
    vml::EpilogueBf16 ep;
    ep.bias = bias;
    ep.rmask = rmask;
    ep.mask_div = mask_div;
    ep.post = post;
    ep.ldpost = ldpost;
    ep.post2 = post2;
    ep.ldpost2 = ldpost2;
    ep.post2_div = post2_div;
    vml::gemm_nt_bf16(static_cast<cudaStream_t>(stream), M, N, K, A, lda, W, ldw, C, ldc,
                      out_f32 != 0, ep, tile);
    return (int)cudaGetLastError();
}

// The bf16 path's nn and tn layouts: layout 1: C = ep(A @ W), A (M, K), W
// (K, N), with the bias, pre (fp32), rmask and post32 (fp32) terms of the
// epilogue, C bf16 or fp32 (out_f32); layout 2: C (M, N) fp32 = (A *
// ascale)^T @ W, A (K, M), W (K, N), through `partial`
// (vml_gemm_tn_partial_floats floats), bias_out (M,) the column sums of the
// scaled A when not null. Returns the launch's CUDA error, 0 if none.
int vml_gemm_bf16_layout(void* stream, int layout, int M, int N, int K, const vml::bf16* A,
                         int lda, const float* ascale, int adiv, const vml::bf16* W, int ldw,
                         void* C, int ldc, int out_f32, const float* bias, const float* pre,
                         int ldpre, const float* rmask, int mask_div, const float* post32,
                         int ldpost32, float* partial, float* bias_out) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (layout == 1) {
        vml::EpilogueBf16 ep;
        ep.bias = bias;
        ep.pre = pre;
        ep.ldpre = ldpre;
        ep.rmask = rmask;
        ep.mask_div = mask_div;
        ep.post32 = post32;
        ep.ldpost32 = ldpost32;
        vml::gemm_nn_bf16(st, M, N, K, A, lda, W, ldw, C, ldc, out_f32 != 0, ep);
    } else {
        vml::gemm_tn_bf16(st, M, N, K, A, lda, ascale, adiv, W, ldw, partial,
                          static_cast<float*>(C), bias_out);
    }
    return (int)cudaGetLastError();
}

size_t vml_gemm_tn_partial_floats(int M, int N, int R) {
    return vml::gemm_tn_partial_floats(M, N, R);
}

}  // extern "C"
