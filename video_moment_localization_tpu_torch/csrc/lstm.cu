// K5: the fused 2-layer bidirectional masked LSTM of the serving path.
//
// Replaces ops/lstm_pallas.py::bilstm_fused (the Pallas `_kernel`) of the
// JAX package: the recurrence of both layers and both directions, and the
// layer-2 input projection that the TPU kernel computes in its body. The
// layer-1 input projection x @ W_ih^T + b_ih stays outside, as it does there
// (ops/lstm_cuda.py computes it).
//
// Semantics (models/lstm.py of either package): torch gate order i, f, g, o;
// a carry advances only where the step is valid and the output at a padded
// step is 0; the backward direction walks time S-1 .. 0, so its zero carry
// stays zero through the right padding.
//
// What bounds it on the H100: the recurrence is sequential in time, so each
// step is a small (rows x H) @ (H x 4H) product that must finish before the
// next one starts; at serving batch the steps' latency bounds it, not its
// 54.5 MFLOP per element. One direction's W_hh is (4H, H) = 1 MiB in fp32,
// over the 227 KB of shared memory of one block: a single block would have
// to stream it from L2 at every step.
//
// Design: a thread-block cluster of 8 CTAs runs one (batch block of RB
// rows, direction). CTA r owns hidden units [r*H/8, (r+1)*H/8) and keeps
// their 4 gate rows of W_hh (129 KB at H=256) in its shared memory for the
// whole layer, k-major and padded against bank conflicts; W_hh is read from
// device memory once per launch. One CTA fits an SM, and a cluster needs 8
// SMs of one GPC, so the card holds about 15 clusters at once: RB is the
// smallest multiple of 16 rows whose clusters, two directions each, all fit
// at once (`cudaOccupancyMaxActiveClusters`), up to the 96 rows whose h fits
// beside W_hh, so B=16 and B=64 run 16 rows per cluster and B=512 runs 80
// rows in one wave instead of four. Each thread owns one unit and RB*U/256
// rows and computes all four gates of them in registers (no gate buffer),
// updates c and h (registers), and stores the new h into every CTA's copy
// of h through distributed shared memory. Where two copies of h fit (RB <=
// 48 at H=256) h is double-buffered and one cluster barrier per step orders
// it; else it is single-buffered and a second barrier separates the step's
// reads from its writes. Gates are fp32. The layer-2 input
// projections, forward and backward, are one launch of the hand-written GEMM
// of gemm.cuh (`gemm_nt2`, the two weights as two problems of one A).
//
// The bf16 variant (`vml_bilstm2_bf16`; the JAX kernel at bf16): the same
// kernel at TE = bf16. xp, W_hh, the copies of h in shared memory (the
// recurrent product's operand) and the outputs are bf16; each product of
// two bf16 values is exact in fp32 and the sums, gates, c and the carried h
// are fp32 (so are b_hh and the mask). One direction's W_hh is 512 KiB:
// its slice of 64 KiB and the copies of h leave room for two CTAs an SM at
// the smaller row choices, so `cudaOccupancyMaxActiveClusters` answers
// differently and the plan's rows per cluster change with it. The layer-2
// projections take gemm.cuh's bf16 path (`gemm_nt2_bf16`, fp32 b_ih).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // CTAs per (batch block, direction)
constexpr int kThreads = 256;
constexpr int kRowStep = 16;       // batch rows per cluster: a multiple of this
constexpr int kMaxRows = 96;
constexpr size_t kMaxSmem = 232448;   // dynamic shared memory of one block

// Shared-memory row stride of the W_hh slice, in elements of `esize` bytes
// (4 fp32, 2 bf16): R = 4H / kCluster gate rows padded by one fp32 or two
// bf16.
__host__ __device__ inline size_t wslice_ld(int H, int esize) {
    return 4 * (size_t)H / kCluster + (esize == 4 ? 1 : 2);
}

size_t wslice_bytes(int H, int esize) {   // ws (H, ld)
    return (size_t)esize * H * wslice_ld(H, esize);
}

// Whether two copies of h (RB, H) fit beside the W_hh slice.
bool double_buffered(int H, int RB, int esize) {
    return wslice_bytes(H, esize) + 2 * (size_t)esize * RB * H <= kMaxSmem;
}

// Bytes of one CTA's shared memory: ws, and hbuf (nbuf, RB, H).
size_t layer_smem_bytes(int H, int RB, int esize) {
    return wslice_bytes(H, esize) +
           (double_buffered(H, RB, esize) ? 2 : 1) * (size_t)esize * RB * H;
}

// The most rows per cluster: one copy of h beside W_hh, at most kMaxRows.
int max_rows(int H, int esize) {
    int rb = kMaxRows;
    while (rb > kRowStep && layer_smem_bytes(H, rb, esize) > kMaxSmem) rb -= kRowStep;
    return rb;
}

// Four consecutive h values of a row in shared memory, as fp32.
__device__ __forceinline__ float4 load_h4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load_h4(const vml::bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

// Rows of one thread, rounded up to the kernel's template choices.
int rows_per_thread(int H, int RB) {
    const int U = H / kCluster;
    const int G = kThreads / U;                  // row groups
    const int r = (RB + G - 1) / G;
    return r <= 2 ? (r <= 1 ? 1 : 2) : r <= 4 ? 4 : r <= 6 ? 6 : r <= 8 ? 8 : r <= 10 ? 10 : 12;
}

// One layer: xp{f,b} (B, S, 4H) input projections (b_ih included), mask
// (B, S), w_hh{f,b} (4H, H), b_hh{f,b} (4H,) -> out (B, S, 2H), forward
// hidden states in [0, H) and backward ones in [H, 2H).
// grid (kCluster, ceil(B / RB), 2 directions); H % 32 == 0, H <= 256.
// Thread tid owns unit u = tid % U of this CTA and rows g + G * i (g = tid /
// U, G = 256 / U, i < RPT) of the batch block. nbuf: copies of h (1 or 2).
// TE: the element type of xp, W_hh, the shared copies of h and out (float
// or bf16); b_hh, the mask and all arithmetic are fp32.
template <int RPT, typename TE>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
lstm_layer_kernel(int B, int S, int H, int RB, int nbuf, const TE* __restrict__ xpf,
                  const TE* __restrict__ xpb, const float* __restrict__ mask,
                  const TE* __restrict__ whhf, const TE* __restrict__ whhb,
                  const float* __restrict__ bhhf, const float* __restrict__ bhhb,
                  TE* __restrict__ out) {
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ __align__(16) unsigned char lstm_smem[];
    const int rank = (int)cluster.block_rank();
    const int U = H / kCluster;       // hidden units of this CTA
    const int R = 4 * U;              // local row g*U + u = W_hh row g*H + rank*U + u
    const int ldw = (int)wslice_ld(H, (int)sizeof(TE));
    const bool single = nbuf == 1;
    TE* ws = reinterpret_cast<TE*>(lstm_smem);     // (H, ldw)
    TE* hbuf = ws + (size_t)H * ldw;               // (nbuf, RB, H)
    const int dir = blockIdx.z;
    const int b0 = blockIdx.y * RB;
    const TE* xp = dir ? xpb : xpf;
    const TE* whh = dir ? whhb : whhf;
    const float* bhh = dir ? bhhb : bhhf;
    const int tid = threadIdx.x;
    const int G = kThreads / U;
    const int u = tid % U;
    const int grp = tid / U;
    const bool active = grp < G;
    const int j = rank * U + u;       // this thread's hidden unit

    for (int e = tid; e < R * H; e += kThreads) {
        const int lr = e / H;
        const int k = e % H;
        ws[(size_t)k * ldw + lr] = whh[(size_t)((lr / U) * H + rank * U + lr % U) * H + k];
    }
    for (int e = tid; e < nbuf * RB * H; e += kThreads) hbuf[e] = vml::from_f<TE>(0.f);
    float bias[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) bias[g] = bhh[g * H + j];
    int row[RPT];                     // batch row of each of this thread's rows, or -1
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = grp + G * i;
        row[i] = (active && r < RB && b0 + r < B) ? r : -1;
    }
    float c[RPT], hp[RPT];            // cell and hidden state of this thread's rows
#pragma unroll
    for (int i = 0; i < RPT; ++i) c[i] = hp[i] = 0.f;
    cluster.sync();                   // the cluster's CTAs have started and staged

    for (int t = 0; t < S; ++t) {
        const int tt = dir ? S - 1 - t : t;
        const TE* hc = hbuf + (single ? 0 : (t & 1) * RB * H);
        TE* hn = hbuf + (single ? 0 : ((t + 1) & 1) * RB * H);

        // This step's inputs, loaded while the gates are summed.
        float xg[4][RPT], m[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            m[i] = 0.f;
#pragma unroll
            for (int g = 0; g < 4; ++g) xg[g][i] = 0.f;
            if (row[i] < 0) continue;
            const size_t at = (size_t)(b0 + row[i]) * S + tt;
            m[i] = mask[at];
#pragma unroll
            for (int g = 0; g < 4; ++g) xg[g][i] = vml::to_f(xp[at * (4 * H) + g * H + j]);
        }

        float acc[4][RPT];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int i = 0; i < RPT; ++i) acc[g][i] = 0.f;
        if (active) {
            const TE* hrow[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) hrow[i] = hc + min(grp + G * i, RB - 1) * H;
            for (int k = 0; k < H; k += 4) {
                float w[4][4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
#pragma unroll
                    for (int g = 0; g < 4; ++g)
                        w[g][q] = vml::to_f(ws[(size_t)(k + q) * ldw + g * U + u]);
#pragma unroll
                for (int i = 0; i < RPT; ++i) {
                    const float4 h4 = load_h4(hrow[i] + k);
#pragma unroll
                    for (int g = 0; g < 4; ++g) {
                        float a = acc[g][i];
                        a = fmaf(h4.x, w[g][0], a);
                        a = fmaf(h4.y, w[g][1], a);
                        a = fmaf(h4.z, w[g][2], a);
                        a = fmaf(h4.w, w[g][3], a);
                        acc[g][i] = a;
                    }
                }
            }
        }
        // Single buffer: every CTA has read h before any CTA overwrites it.
        if (single) cluster.sync();

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            if (row[i] < 0) continue;     // rows past B keep h = 0
            const float gi = vml::sigmoidf_(acc[0][i] + xg[0][i] + bias[0]);
            const float gf = vml::sigmoidf_(acc[1][i] + xg[1][i] + bias[1]);
            const float gg = tanhf(acc[2][i] + xg[2][i] + bias[2]);
            const float go = vml::sigmoidf_(acc[3][i] + xg[3][i] + bias[3]);
            const float c_new = gf * c[i] + gi * gg;
            const float h_new = go * tanhf(c_new);
            const float h = m[i] * h_new + (1.f - m[i]) * hp[i];
            c[i] = m[i] * c_new + (1.f - m[i]) * c[i];
            hp[i] = h;
            out[((size_t)(b0 + row[i]) * S + tt) * (2 * H) + dir * H + j] =
                vml::from_f<TE>(h * m[i]);
            const TE hq = vml::from_f<TE>(h);
#pragma unroll
            for (int r = 0; r < kCluster; ++r) cluster.map_shared_rank(hn, r)[row[i] * H + j] = hq;
        }
        // Orders this step's h stores before the next step's reads (and, when
        // double-buffered, the next step's stores after this step's reads).
        cluster.sync();
    }
}

template <typename TE>
using LayerKernel = void (*)(int, int, int, int, int, const TE*, const TE*, const float*,
                             const TE*, const TE*, const float*, const float*, TE*);

template <typename TE>
LayerKernel<TE> layer_kernel(int H, int RB) {
    switch (rows_per_thread(H, RB)) {
        case 1: return lstm_layer_kernel<1, TE>;
        case 2: return lstm_layer_kernel<2, TE>;
        case 4: return lstm_layer_kernel<4, TE>;
        case 6: return lstm_layer_kernel<6, TE>;
        case 8: return lstm_layer_kernel<8, TE>;
        case 10: return lstm_layer_kernel<10, TE>;
        default: return lstm_layer_kernel<12, TE>;
    }
}

// Clusters of the layer kernel at RB rows that the card holds at once.
// Answers are kept per (device, element type, H / 32, RB / 16): a host-side
// query of this file's own kernels, so this library is the only one that
// reads them.
int g_active[16][2][9][kMaxRows / kRowStep + 1];

template <typename TE>
cudaError_t max_active_clusters(int H, int RB, int* n) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    constexpr int esize = (int)sizeof(TE);
    int* cached = dev < 16 ? &g_active[dev][esize == 2][H / 32][RB / kRowStep] : nullptr;
    if (cached && *cached > 0) {
        *n = *cached;
        return cudaSuccess;
    }
    const LayerKernel<TE> fn = layer_kernel<TE>(H, RB);
    const size_t smem = layer_smem_bytes(H, RB, esize);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, 1, 2);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(n, (const void*)fn, &cfg);
    if (err == cudaSuccess && cached) *cached = *n;
    return err;
}

struct Plan {
    int rows, clusters, max_active;
};

// The smallest RB (a multiple of kRowStep) whose 2 * ceil(B / RB) clusters
// the card holds at once; max_rows(H) when none does. The chosen RB's kernel
// has its shared-memory limit raised: max_active_clusters did so when it
// first asked about that RB in this process.
template <typename TE>
cudaError_t plan_for(int B, int H, Plan* plan) {
    for (int rb = kRowStep; rb <= max_rows(H, (int)sizeof(TE)); rb += kRowStep) {
        int n = 0;
        cudaError_t err = max_active_clusters<TE>(H, rb, &n);
        if (err != cudaSuccess) return err;
        *plan = {rb, 2 * ((B + rb - 1) / rb), n};
        if (plan->clusters <= n) break;
    }
    return cudaSuccess;
}

}  // namespace

extern "C" {

// The layer kernel's plan at batch B and element size esize (4 fp32, 2
// bf16): rows per cluster, clusters (both directions), clusters the card
// holds at once at that size, and the shared memory of one CTA, for the
// wrapper's admission check and its Python mirror (ops/lstm_cuda.py::
// lstm_plan). Returns a CUDA error, 0 if none.
int vml_lstm_plan(int B, int H, int esize, int* rows, int* clusters, int* max_active,
                  size_t* smem) {
    Plan plan{};
    cudaError_t err = esize == 2 ? plan_for<vml::bf16>(B, H, &plan) : plan_for<float>(B, H, &plan);
    *rows = plan.rows;
    *clusters = plan.clusters;
    *max_active = plan.max_active;
    *smem = layer_smem_bytes(H, plan.rows, esize);
    return (int)err;
}

// Clusters of the layer kernel at `rows` rows per cluster and element size
// esize that the card holds at once (*n). Returns a CUDA error, 0 if none.
int vml_lstm_max_active_clusters(int H, int rows, int esize, int* n) {
    return (int)(esize == 2 ? max_active_clusters<vml::bf16>(H, rows, n)
                            : max_active_clusters<float>(H, rows, n));
}

// Both layers: xp1{f,b} (B, S, 4H) layer-1 input projections with b_ih,
// mask (B, S) in {0, 1}, per-direction weights in torch's layout. Scratch
// h1 (B, S, 2H) and xp2{f,b} (B, S, 4H); result out (B, S, 2H). Returns the
// first CUDA error of the launches, 0 if none.
int vml_bilstm2_f32(void* stream, int B, int S, int H,
                    const float* xp1f, const float* xp1b, const float* mask,
                    const float* whh1f, const float* whh1b,
                    const float* bhh1f, const float* bhh1b,
                    const float* wih2f, const float* wih2b,
                    const float* bih2f, const float* bih2b,
                    const float* whh2f, const float* whh2b,
                    const float* bhh2f, const float* bhh2b,
                    float* h1, float* xp2f, float* xp2b, float* out) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Plan plan{};
    cudaError_t err = plan_for<float>(B, H, &plan);
    if (err != cudaSuccess) return (int)err;
    const int RB = plan.rows;
    const LayerKernel<float> fn = layer_kernel<float>(H, RB);
    const size_t smem = layer_smem_bytes(H, RB, 4);
    const dim3 grid(kCluster, (B + RB - 1) / RB, 2);

    const int nbuf = double_buffered(H, RB, 4) ? 2 : 1;
    fn<<<grid, kThreads, smem, st>>>(B, S, H, RB, nbuf, xp1f, xp1b, mask, whh1f, whh1b, bhh1f,
                                     bhh1b, h1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    vml::Epilogue epf, epb;
    epf.bias = bih2f;
    epb.bias = bih2b;
    vml::gemm_nt2(st, B * S, 4 * H, 2 * H, h1, 2 * H, wih2f, wih2b, 2 * H, xp2f, xp2b, 4 * H,
                  epf, epb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fn<<<grid, kThreads, smem, st>>>(B, S, H, RB, nbuf, xp2f, xp2b, mask, whh2f, whh2b, bhh2f,
                                     bhh2b, out);
    return (int)cudaGetLastError();
}

// The bf16 variant: xp1{f,b} (B, S, 4H) bf16 layer-1 input projections with
// b_ih, mask (B, S) fp32, W_ih / W_hh bf16, b_ih / b_hh fp32; scratch h1
// (B, S, 2H) and xp2{f,b} bf16; result out (B, S, 2H) bf16.
int vml_bilstm2_bf16(void* stream, int B, int S, int H,
                     const vml::bf16* xp1f, const vml::bf16* xp1b, const float* mask,
                     const vml::bf16* whh1f, const vml::bf16* whh1b,
                     const float* bhh1f, const float* bhh1b,
                     const vml::bf16* wih2f, const vml::bf16* wih2b,
                     const float* bih2f, const float* bih2b,
                     const vml::bf16* whh2f, const vml::bf16* whh2b,
                     const float* bhh2f, const float* bhh2b,
                     vml::bf16* h1, vml::bf16* xp2f, vml::bf16* xp2b, vml::bf16* out) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Plan plan{};
    cudaError_t err = plan_for<vml::bf16>(B, H, &plan);
    if (err != cudaSuccess) return (int)err;
    const int RB = plan.rows;
    const LayerKernel<vml::bf16> fn = layer_kernel<vml::bf16>(H, RB);
    const size_t smem = layer_smem_bytes(H, RB, 2);
    const dim3 grid(kCluster, (B + RB - 1) / RB, 2);

    const int nbuf = double_buffered(H, RB, 2) ? 2 : 1;
    fn<<<grid, kThreads, smem, st>>>(B, S, H, RB, nbuf, xp1f, xp1b, mask, whh1f, whh1b, bhh1f,
                                     bhh1b, h1);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    vml::EpilogueBf16 epf, epb;
    epf.bias = bih2f;
    epb.bias = bih2b;
    vml::gemm_nt2_bf16(st, B * S, 4 * H, 2 * H, h1, 2 * H, wih2f, wih2b, 2 * H, xp2f, xp2b,
                       4 * H, epf, epb);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fn<<<grid, kThreads, smem, st>>>(B, S, H, RB, nbuf, xp2f, xp2b, mask, whh2f, whh2b, bhh2f,
                                     bhh2b, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
