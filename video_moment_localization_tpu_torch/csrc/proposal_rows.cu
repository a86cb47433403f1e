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
// What bounds the fp32 kernels on the H100: bytes. K1's forward reads 131 KB
// and writes 1.4 MB per element at the Charades shapes (T=64, L=16, C=4,
// D=512); K8 writes 2.6 MB (the L * L cells); each backward reads the
// cotangents of the N = L(L+1)/2 cells i <= j once and writes 131 KB.
//
// K1-bf16, K6-bf16 and K8-bf16 (the training paths at bf16) have kernels of
// their own, designed for 2-byte elements: vml::pool_kernel_bf16 and
// proposal_bwd_bf16_kernel below. Their sums stay fp32 / fp64 and each
// output is rounded once to bf16 (the JAX kernels sum in fp32 and round
// their store; K1's backward accumulates df in fp32, K8's is the XLA VJP of
// the fp32 prefix sums). At ActivityNet B=64 the dense fc of K8 holds 2^29
// elements (2.1 GB at fp32): every offset into it is 64-bit.
#include <cuda.h>
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
template <bool Dense>
__global__ void __launch_bounds__(kMaxWarps * 32)
proposal_bwd_kernel(int T, int L, int C, int D, const float* __restrict__ mask,
                    const float* __restrict__ dfc, const float* __restrict__ dfm,
                    const float* __restrict__ dfb, float* __restrict__ df) {
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
    const float* dfc_b = dfc + (size_t)b * P * C * D + d;
    const float* dfm_b = dfm + (size_t)b * P * D + d;

    float* mine = diff + (size_t)warp * T * COLS;
    for (int t = 0; t < T; ++t) mine[t * COLS + lane] = 0.f;
    for (int l = warp; l < L; l += W)
        dfb_s[l * COLS + lane] = live ? dfb[((size_t)b * L + l) * D + d] : 0.f;
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
            if (live && valid[k] > 0) gm[k] = dfm_b[(size_t)n[k] * D] * inv_c;
        for (int c0 = 0; c0 <= C; c0 += kSlots) {
            float v[kGroup][kSlots];
#pragma unroll
            for (int k = 0; k < kGroup; ++k)
#pragma unroll
                for (int s = 0; s < kSlots; ++s)
                    v[k][s] = (live && c0 + s < valid[k])
                                  ? dfc_b[((size_t)n[k] * C + c0 + s) * D] : 0.f;
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
            df[((size_t)b * T + t) * D + d] =
                (float)(acc + (double)dfb_s[(t / tl) * COLS + lane] / (double)tl);
    }
}

// ---------------------------------------------------------------------------
// The bf16 backward (K1-bf16, K6-bf16, K8-bf16): the same transpose, its
// cotangent rows streamed through a ring in shared memory by TMA.
//
// A block owns (element, 64 columns), so each row segment it reads is 128
// bytes (two columns a lane). Its warps are `PairPlan::consumers` consumer
// warps, each with its own T x 64 fp32 difference array, and one producer
// warp.
//
// Before the walk the block compacts the element's unmasked moments, in pair
// order, into `list` ((i << 16) | j) and `wks` (mask / clip length), and
// cuts the list into chunks: a chunk is at most kBoxMoments unmasked moments
// with consecutive moment indices (adjacent rows), cut where such a run
// starts and at every moment index that is a multiple of kBoxMoments. Chunk
// c goes to ring slot c mod S and to consumer c mod consumers.
//
// The producer fills a slot with two boxes from the chunk's box start on:
// kBoxMoments * C dfc rows and kBoxMoments dfm rows, 64 columns each. One
// lane per chunk, up to 32 chunks a round, waits on the slot's `empty`
// mbarrier and issues both boxes as TMA copies (cp.async.bulk.tensor)
// completed on its `full` mbarrier. A chunk that ends its run but does not
// start it has its box end at its last moment, so that the box covers rows
// of its run's previous chunk (just read, in L2) rather than masked rows
// after the run. A consumer waits on `full`, scatters the chunk's moments
// in order as the fp32 kernel does (g(c) - g(c-1) at each clip boundary,
// kSlots boundaries of a moment at a time), kScatterGroup moments at a time:
// their deltas and frames side by side, then their read-modify-writes of
// the difference array moment by moment; then it arrives on `empty`.
//
// Then the block sums the consumers' arrays at each frame in consumer order,
// scans them over t in fp64 (a two-level scan over all its warps) and adds
// dfb / (T/L), each df rounded once to bf16. No atomics, one fixed order: two
// launches give the same bits. A masked moment or a dense cell below the
// diagonal is never scattered; its rows are read only where the box of a run
// shorter than kBoxMoments reaches past that run.
//
// What bounds it on the H100 is not known (PERF.md §6, §7): the ring alone,
// without the scatter, takes about half its time.
//
// The TMA path needs D % 8 == 0 and every pointer 16-byte aligned
// (vml::pair_vector), fewer than 2^31 dfc rows and kBoxMoments * C <= 256
// (a box's rows). Anything else takes the scalar path of the same kernel:
// the producer warp copies each chunk's rows itself (one 2-byte access a
// column where D % 8 != 0 or a pointer is not aligned) and arrives on
// `full`.
constexpr int kMaxPairWarps = 8;   // warps of a block: consumers and the producer
constexpr int kPairConsumers = 4;  // consumer warps a plan aims at
constexpr int kBoxMoments = 8;     // moments of a chunk and of a box
constexpr int kScatterGroup = 4;   // moments of a consumer worked on side by side
constexpr int kMaxSlots = 32;      // slots of the ring
constexpr int kMinSlots = 2;       // slots a plan needs a consumer
constexpr int kStage = 16;         // chunks of pair masks loaded together
constexpr int kStageRows16 = 16;   // dfb rows of a warp loaded together
constexpr size_t kRunTotalPairBytes = (size_t)kMaxPairWarps * 32 * sizeof(double2);
constexpr size_t kRowBytes = vml::kPairCols * sizeof(vml::bf16);   // a box row: 128 bytes

// A bf16 backward launch: consumer warps (0 where no plan fits), ring
// slots, blocks an SM the plan leaves room for, and dynamic shared memory.
struct PairPlan {
    int consumers, slots, blocks_per_sm;
    size_t smem;
};

// Bytes of one ring slot: the dfc and dfm boxes of kBoxMoments moments.
__host__ __device__ inline size_t slot_bytes(int C) {
    return (size_t)kBoxMoments * (C + 1) * kRowBytes;
}

// Dynamic shared memory beside the ring and the difference arrays: the
// ring's alignment to 128 bytes, the moment list (a word and mask / clip
// length each of the N pairs at most), the clip geometry by moment length
// (L int2), the L x 64 bf16 dfb tile and the chunk starts (N + 1 16-bit).
size_t pair_fixed_bytes(int L) {
    const size_t N = (size_t)L * (L + 1) / 2;
    return 128 + N * (sizeof(uint32_t) + sizeof(float)) + (size_t)L * sizeof(int2) +
           (size_t)L * kRowBytes + (N + 1) * sizeof(uint16_t);
}

// Two blocks an SM where half of it holds kPairConsumers T x 64 arrays and
// kMinSlots slots for each, else one block with as many consumers as fit so,
// up to kPairConsumers; the ring takes what is left, up to kMaxSlots, a
// multiple of the consumers (so that each slot has one consumer, which
// keeps its phases in step).
PairPlan pair_plan(int T, int L, int C) {
    const size_t per_warp = (size_t)T * vml::kPairCols * sizeof(float);
    const size_t per_slot = slot_bytes(C) + 2 * sizeof(uint64_t);
    const size_t fixed = pair_fixed_bytes(L);
    const size_t half = kSmSmem / 2 - kReserved - kRunTotalPairBytes;
    const size_t whole = kBlockSmem - kRunTotalPairBytes;
    for (int blocks = 2; blocks >= 1; --blocks) {
        const size_t room = blocks == 2 ? half : whole;
        if (room < fixed) continue;
        size_t w = (room - fixed) / (per_warp + kMinSlots * per_slot);
        w = w < (size_t)kPairConsumers ? w : (size_t)kPairConsumers;
        if (w == 0 || (blocks == 2 && w < (size_t)kPairConsumers)) continue;
        size_t s = (room - fixed - w * per_warp) / per_slot;
        s = s < (size_t)kMaxSlots ? s : (size_t)kMaxSlots;
        s -= s % w;
        return {(int)w, (int)s, blocks, fixed + w * per_warp + s * per_slot};
    }
    return {0, 0, 0, 0};
}

// Sum over the W warps' difference arrays at frame t, in warp order, fp64,
// of the lane's two columns.
__device__ __forceinline__ double2 frame_sum2(const float* diff, int W, int T, int t, int lane) {
    double2 s = make_double2(0.0, 0.0);
    for (int w = 0; w < W; ++w) {
        const float2 x =
            reinterpret_cast<const float2*>(diff + ((size_t)w * T + t) * vml::kPairCols)[lane];
        s.x += x.x;
        s.y += x.y;
    }
    return s;
}

// The mbarrier and TMA operations of the ring (tma.cuh, shared with the
// bf16 GEMM's wgmma path).
using vml::mbar_arrive;
using vml::mbar_expect;
using vml::mbar_init;
using vml::mbar_wait;
using vml::tma_box;

// The moment index of a list word.
template <bool Dense>
__device__ __forceinline__ int moment_of_word(uint32_t word, int L) {
    return vml::moment_index<Dense>((int)(word >> 16), (int)(word & 0xffffu), L);
}

// Chunk c: its moments [ka, kb) of the list and the moment its boxes start
// at.
template <bool Dense>
__device__ __forceinline__ void chunk_of(int c, const uint16_t* chunk, const uint32_t* list,
                                         int K, int L, int& ka, int& kb, int& box) {
    ka = chunk[c];
    kb = chunk[c + 1];
    const int na = moment_of_word<Dense>(list[ka], L);
    const int nl = moment_of_word<Dense>(list[kb - 1], L);
    const bool first = ka == 0 || moment_of_word<Dense>(list[ka - 1], L) + 1 != na;
    const bool last = kb == K || moment_of_word<Dense>(list[kb], L) != nl + 1;
    box = last && !first ? nl + 1 - kBoxMoments : na;
}

// grid B * ceil(D / 64), one block per (element, 64 columns), blockDim
// 32 * (consumers + 1), dynamic shared memory PairPlan::smem. ``tma``: the
// TMA path (then ``map_c`` / ``map_m`` are dfc as (B * P * C, D) and dfm as
// (B * P, D), boxes of kBoxMoments * C and kBoxMoments rows by 64 columns);
// ``vec``: vml::pair_vector of D and the four cotangent / gradient pointers.
template <bool Dense>
__global__ void __launch_bounds__(kMaxPairWarps * 32)
proposal_bwd_bf16_kernel(int T, int L, int C, int D, int slots, int tma, int vec,
                         const __grid_constant__ CUtensorMap map_c,
                         const __grid_constant__ CUtensorMap map_m,
                         const float* __restrict__ mask, const vml::bf16* __restrict__ dfc,
                         const vml::bf16* __restrict__ dfm, const vml::bf16* __restrict__ dfb,
                         vml::bf16* __restrict__ df) {
    using vml::bf16;
    constexpr int COLS = vml::kPairCols;
    constexpr int R = kBoxMoments;
    extern __shared__ __align__(16) unsigned char pair_raw[];
    __shared__ double2 run_total[kMaxPairWarps][32];       // kRunTotalPairBytes
    int* warp_count = reinterpret_cast<int*>(run_total);   // the compaction's, before the scan
    const int W = blockDim.x / 32, Wc = W - 1;             // warps, consumers
    const int N = L * (L + 1) / 2;
    const int P = Dense ? L * L : N;
    const int S = slots;
    const size_t slot = slot_bytes(C);
    unsigned char* ring = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(pair_raw) + 127) & ~(uintptr_t)127);   // [S][slot]
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)S * slot);  // [S]
    uint64_t* empty = full + S;                                             // [S]
    float* diff = reinterpret_cast<float*>(empty + S);                      // [Wc][T][COLS]
    uint32_t* list = reinterpret_cast<uint32_t*>(diff + (size_t)Wc * T * COLS);   // [N]
    float* wks = reinterpret_cast<float*>(list + N);                       // [N]: mask / clip
    int2* span = reinterpret_cast<int2*>(wks + N);                         // [L]: (clip, clips) by length
    bf16* dfb_s = reinterpret_cast<bf16*>(span + L);                       // [L][COLS]
    uint16_t* chunk = reinterpret_cast<uint16_t*>(dfb_s + (size_t)L * COLS);   // [N + 1]
    const int tiles = (D + COLS - 1) / COLS;
    const int tile = blockIdx.x % tiles;
    const int b = blockIdx.x / tiles;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int d = tile * COLS + 2 * lane;
    const bool live0 = d < D, live1 = d + 1 < D;
    const int live = live0 + live1;
    const int tl = T / L;

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // The dfb tile (each warp's rows in one round trip), the clip geometry
    // by moment length (frames = len T/L), the difference arrays zeroed.
    for (int l0 = warp; l0 < L; l0 += kStageRows16 * W) {
        uint32_t raw[kStageRows16];
#pragma unroll
        for (int u = 0; u < kStageRows16; ++u)
            raw[u] = vml::load_raw2(dfb + ((size_t)b * L + min(l0 + u * W, L - 1)) * D +
                                        (live0 ? d : tile * COLS),
                                    vec, live);
#pragma unroll
        for (int u = 0; u < kStageRows16; ++u)
            if (l0 + u * W < L) reinterpret_cast<uint32_t*>(dfb_s + (l0 + u * W) * COLS)[lane] = raw[u];
    }
    for (int len = threadIdx.x; len < L; len += blockDim.x) {
        const int frames = (len + 1) * tl;
        span[len] = make_int2(max(1, frames / C), min(C, frames));
    }
    for (size_t k = threadIdx.x; k < (size_t)Wc * T * COLS / 2; k += blockDim.x)
        reinterpret_cast<float2*>(diff)[k] = make_float2(0.f, 0.f);

    // The unmasked moments in pair order and the chunk starts among them:
    // blockDim.x pairs at a time, kStage such batches' masks loaded
    // together, each batch compacted by two ballots and the warps' counts. A
    // moment starts a run unless the pair before it is unmasked and its
    // moment index is one less (always in the packed layout, in the same
    // row in the dense one).
    int K = 0, Q = 0;
    {
        int i = 0, j = 0;
        if ((int)threadIdx.x < N) vml::pair_of(threadIdx.x, L, i, j);
        for (int q0 = 0; q0 < N; q0 += kStage * blockDim.x) {
            float m[kStage];
            uint32_t word[kStage];
            bool cut[kStage];
#pragma unroll
            for (int u = 0; u < kStage; ++u) {
                const int q = q0 + u * blockDim.x + threadIdx.x;
                m[u] = 0.f;
                word[u] = 0u;
                cut[u] = false;
                if (q < N) {
                    m[u] = vml::moment_mask<Dense>(mask, b, L, i, j);
                    float before = 0.f;
                    if (j > i)
                        before = vml::moment_mask<Dense>(mask, b, L, i, j - 1);
                    else if (!Dense && i > 0)
                        before = vml::moment_mask<false>(mask, b, L, i - 1, L - 1);
                    word[u] = ((uint32_t)i << 16) | (uint32_t)j;
                    cut[u] = before == 0.f || vml::moment_index<Dense>(i, j, L) % R == 0;
                    if (q + (int)blockDim.x < N) vml::advance_moment<false>(blockDim.x, L, i, j);
                }
            }
#pragma unroll
            for (int u = 0; u < kStage; ++u) {
                const bool on = m[u] != 0.f;
                const unsigned bits = __ballot_sync(0xffffffffu, on);
                const unsigned cuts = __ballot_sync(0xffffffffu, on && cut[u]);
                if (lane == 0) warp_count[warp] = __popc(bits) | (__popc(cuts) << 16);
                __syncthreads();
                const unsigned below = (1u << lane) - 1u;
                int at = K + __popc(bits & below), cat = Q + __popc(cuts & below);
                for (int w = 0; w < W; ++w) {
                    const int n = warp_count[w];
                    if (w < warp) {
                        at += n & 0xffff;
                        cat += n >> 16;
                    }
                    K += n & 0xffff;
                    Q += n >> 16;
                }
                if (on) {
                    const int frames = ((int)(word[u] & 0xffffu) - (int)(word[u] >> 16) + 1) * tl;
                    list[at] = word[u];
                    wks[at] = m[u] / (float)max(1, frames / C);
                    if (cut[u]) chunk[cat] = (uint16_t)at;
                }
                __syncthreads();
            }
        }
        if (threadIdx.x == 0) chunk[Q] = (uint16_t)K;
        __syncthreads();
    }

    const size_t row0 = (size_t)b * P;
    const bf16* dfc_t = dfc + (live0 ? d : tile * COLS);   // a dead lane reads its tile's first
    const bf16* dfm_t = dfm + (live0 ? d : tile * COLS);   // column, never stored
    const uint32_t box_c = (uint32_t)(R * C * kRowBytes);   // bytes of a slot's dfc box
    if (warp == Wc) {
        // The producer.
        if (tma) {
            // Up to 32 chunks a round, a lane each; a round's chunks are all
            // issued before the next round's lanes wait.
            const int issue = S < 32 ? S : 32;
            for (int c0 = 0; c0 < Q; c0 += issue) {
                const int c = c0 + lane;
                if (lane < issue && c < Q) {
                    int ka, kb, box;
                    chunk_of<Dense>(c, chunk, list, K, L, ka, kb, box);
                    const int s = c % S, use = c / S;
                    if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
                    unsigned char* dst = ring + (size_t)s * slot;
                    mbar_expect(&full[s], (uint32_t)slot);
                    tma_box(dst, &map_c, tile * COLS, (int)((row0 + box) * C), &full[s]);
                    tma_box(dst + box_c, &map_m, tile * COLS, (int)(row0 + box), &full[s]);
                }
                __syncwarp();
            }
        } else {
            for (int c = 0; c < Q; ++c) {
                int ka, kb, box;
                chunk_of<Dense>(c, chunk, list, K, L, ka, kb, box);
                const int s = c % S, use = c / S;
                if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
                uint32_t* dst = reinterpret_cast<uint32_t*>(ring + (size_t)s * slot);
                for (int k = ka; k < kb; ++k) {
                    const int n = moment_of_word<Dense>(list[k], L);
                    const int off = n - box;
                    for (int cc = 0; cc < C; ++cc)
                        dst[(off * C + cc) * 32 + lane] =
                            vml::load_raw2(dfc_t + ((row0 + n) * C + cc) * D, vec, live);
                    dst[(R * C + off) * 32 + lane] = vml::load_raw2(dfm_t + (row0 + n) * D, vec, live);
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(&full[s]);
            }
        }
    } else {
        // Consumer `warp`: chunks c = warp (mod Wc), in order, kScatterGroup
        // moments at a time: their boundaries' deltas and frames first (a
        // chain of dependent work each, run side by side), then their
        // read-modify-writes of the difference array, moment by moment.
        float* mine = diff + (size_t)warp * T * COLS + 2 * lane;
        const float inv_c = 1.f / (float)C;
        constexpr int G = kScatterGroup;
        for (int c = warp; c < Q; c += Wc) {
            int ka, kb, box;
            chunk_of<Dense>(c, chunk, list, K, L, ka, kb, box);
            const int s = c % S, use = c / S;
            mbar_wait(&full[s], use & 1);
            const uint32_t* rc = reinterpret_cast<const uint32_t*>(ring + (size_t)s * slot);
            const uint32_t* rm = rc + R * C * 32;
            for (int k0 = ka; k0 < kb; k0 += G) {
                int off[G], start[G], clip[G], valid[G];
                float wk[G];
                float2 gm[G], prev[G];
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const bool have = k0 + g < kb;
                    const uint32_t word = list[have ? k0 + g : k0];
                    const int i = (int)(word >> 16), j = (int)(word & 0xffffu);
                    const int2 cv = span[j - i];
                    off[g] = moment_of_word<Dense>(word, L) - box;
                    start[g] = i * tl;
                    clip[g] = cv.x;
                    valid[g] = have ? cv.y : -1;   // a void member has no boundary
                    wk[g] = wks[have ? k0 + g : k0];
                    const float2 x = vml::unpack2(rm[off[g] * 32 + lane]);
                    gm[g] = make_float2(x.x * inv_c, x.y * inv_c);
                    prev[g] = make_float2(0.f, 0.f);
                }
                for (int c0 = 0; c0 <= C; c0 += kSlots) {
                    float2 delta[G][kSlots];
                    int pos[G][kSlots];   // -1: no boundary
#pragma unroll
                    for (int g = 0; g < G; ++g)
#pragma unroll
                        for (int r = 0; r < kSlots; ++r) {
                            const int cc = c0 + r;
                            float2 gv = make_float2(0.f, 0.f);
                            if (cc < valid[g]) {
                                const float2 v = vml::unpack2(rc[(off[g] * C + cc) * 32 + lane]);
                                gv = make_float2((v.x + gm[g].x) * wk[g], (v.y + gm[g].y) * wk[g]);
                            }
                            delta[g][r] = make_float2(gv.x - prev[g].x, gv.y - prev[g].y);
                            prev[g] = gv;
                            const int p = start[g] + cc * clip[g];
                            pos[g][r] = cc <= valid[g] && p < T ? p : -1;
                        }
#pragma unroll
                    for (int g = 0; g < G; ++g) {
                        float2 old[kSlots];
#pragma unroll
                        for (int r = 0; r < kSlots; ++r)
                            if (pos[g][r] >= 0)
                                old[r] = *reinterpret_cast<const float2*>(mine + (size_t)pos[g][r] * COLS);
#pragma unroll
                        for (int r = 0; r < kSlots; ++r)
                            if (pos[g][r] >= 0)
                                *reinterpret_cast<float2*>(mine + (size_t)pos[g][r] * COLS) =
                                    make_float2(old[r].x + delta[g][r].x, old[r].y + delta[g][r].y);
                    }
                }
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[s]);
        }
    }
    __syncthreads();

    // Sum the consumers' arrays at each frame in consumer order and scan
    // over t in fp64, as the fp32 kernel does, over all W warps' runs.
    const int run = (T + W - 1) / W;
    const int t0 = min(T, warp * run), t1 = min(T, t0 + run);
    double2 acc = make_double2(0.0, 0.0);
    for (int t = t0; t < t1; ++t) {
        const double2 x = frame_sum2(diff, Wc, T, t, lane);
        acc.x += x.x;
        acc.y += x.y;
    }
    run_total[warp][lane] = acc;
    __syncthreads();
    acc = make_double2(0.0, 0.0);
    for (int w = 0; w < warp; ++w) {
        acc.x += run_total[w][lane].x;
        acc.y += run_total[w][lane].y;
    }
    for (int t = t0; t < t1; ++t) {
        const double2 x = frame_sum2(diff, Wc, T, t, lane);
        acc.x += x.x;
        acc.y += x.y;
        const float2 gb =
            __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(dfb_s + (t / tl) * COLS)[lane]);
        vml::store_pair(df + ((size_t)b * T + t) * D + d,
                        make_float2((float)(acc.x + (double)gb.x / (double)tl),
                                    (float)(acc.y + (double)gb.y / (double)tl)),
                        vec, live0, live1);
    }
}

// The tensor map of a bf16 (rows, D) matrix read in boxes of ``box_rows``
// rows by 64 columns (columns past D read as 0).
cudaError_t row_map(CUtensorMap* map, const vml::bf16* base, long long rows, int D,
                    int box_rows) {
    const uint64_t dims[2] = {(uint64_t)D, (uint64_t)rows};
    const uint64_t strides[1] = {(uint64_t)D * sizeof(vml::bf16)};
    const uint32_t box[2] = {(uint32_t)vml::kPairCols, (uint32_t)box_rows};
    return vml::bf16_map(map, base, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <bool Dense, typename E>
int forward(void* stream, int B, int T, int L, int C, int D, const E* f, const float* mask,
            E* fc, E* fm, E* fb) {
    return (int)vml::pool_forward<Dense, E>(static_cast<cudaStream_t>(stream), B, T, L, C, D, f,
                                            mask, fc, fm, fb);
}

template <bool Dense>
int backward(void* stream, int B, int T, int L, int C, int D, const float* mask,
             const float* dfc, const float* dfm, const float* dfb, float* df) {
    const int warps = scatter_warps(T, L);
    if (warps == 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(proposal_bwd_kernel<Dense>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)scatter_smem_bytes(T, L));
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)B * ((D + vml::kPropCols - 1) / vml::kPropCols);
    proposal_bwd_kernel<Dense><<<(unsigned)blocks, warps * 32, scatter_smem_bytes(T, L),
                                 static_cast<cudaStream_t>(stream)>>>(T, L, C, D, mask, dfc, dfm,
                                                                      dfb, df);
    return (int)cudaGetLastError();
}

template <bool Dense>
int backward(void* stream, int B, int T, int L, int C, int D, const float* mask,
             const vml::bf16* dfc, const vml::bf16* dfm, const vml::bf16* dfb, vml::bf16* df) {
    const PairPlan plan = pair_plan(T, L, C);
    if (plan.consumers == 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(proposal_bwd_bf16_kernel<Dense>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    const void* ptrs[] = {dfc, dfm, dfb, df};
    const bool vec = vml::pair_vector(D, ptrs, 4);
    const long long P = Dense ? (long long)L * L : (long long)L * (L + 1) / 2;
    const long long rows = (long long)B * P * C;
    const bool tma = vec && rows < (1LL << 31) && kBoxMoments * C <= 256;
    CUtensorMap map_c{}, map_m{};
    if (tma) {
        err = row_map(&map_c, dfc, rows, D, kBoxMoments * C);
        if (err == cudaSuccess) err = row_map(&map_m, dfm, (long long)B * P, D, kBoxMoments);
        if (err != cudaSuccess) return (int)err;
    }
    const long long blocks = (long long)B * ((D + vml::kPairCols - 1) / vml::kPairCols);
    proposal_bwd_bf16_kernel<Dense><<<(unsigned)blocks, (plan.consumers + 1) * 32, plan.smem,
                                      static_cast<cudaStream_t>(stream)>>>(
        T, L, C, D, plan.slots, tma ? 1 : 0, vec ? 1 : 0, map_c, map_m, mask, dfc, dfm, dfb, df);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory per block, dynamic and static, of the fp32 forward and of
// the fp32 backward, for the wrapper's admission check against the 227 KB a
// block may have (the backward needs at least one warp's difference array).
size_t vml_proposal_smem_bytes(int T, int L, int backward_pass) {
    if (backward_pass) return scatter_smem_bytes(T, L) + kStatic;
    return vml::pool_smem_bytes(T) + vml::kRunTotalBytes;
}

// The launch plan of a forward or backward at either type (bf16 != 0: the
// bf16 kernels), for the wrapper's mirror (ops/proposal_cuda.py::plan):
// out[0] warps a block, out[1] columns a block, out[2] blocks an SM the plan
// leaves room for and out[4] ring slots (the bf16 backward; 0 else), out[3]
// shared memory a block, dynamic and static (0 where no plan fits).
void vml_proposal_plan(int T, int L, int C, int backward_pass, int bf16, long long* out) {
    out[2] = out[4] = 0;
    if (!bf16) {
        out[0] = backward_pass ? scatter_warps(T, L) : vml::kPoolWarps;
        out[1] = vml::kPropCols;
        out[3] = (long long)vml_proposal_smem_bytes(T, L, backward_pass);
        if (backward_pass && out[0] == 0) out[3] = 0;
        return;
    }
    if (!backward_pass) {
        out[0] = vml::kPool16Warps;
        out[1] = 32 * vml::kPoolCPL;
        out[3] = (long long)(vml::pool16_smem_bytes(T) + vml::kPool16StaticBytes);
        return;
    }
    const PairPlan plan = pair_plan(T, L, C);
    out[0] = plan.consumers > 0 ? plan.consumers + 1 : 0;
    out[1] = vml::kPairCols;
    out[2] = plan.blocks_per_sm;
    out[3] = plan.consumers > 0 ? (long long)(plan.smem + kRunTotalPairBytes) : 0;
    out[4] = plan.slots;
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

// K1-bf16: K1 on bf16 f, fc, fm and fb (vml::pool_kernel_bf16: fp32 prefix
// sums, each output rounded once to bf16).
int vml_proposal_rows_fwd_bf16(void* stream, int B, int T, int L, int C, int D,
                               const vml::bf16* f, const float* length_mask, vml::bf16* fc,
                               vml::bf16* fm, vml::bf16* fb) {
    return forward<false>(stream, B, T, L, C, D, f, length_mask, fc, fm, fb);
}

// K1-bf16 backward (proposal_bwd_bf16_kernel): bf16 cotangents, df (B, T, D)
// rounded once to bf16.
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

// K8-bf16: K8 on bf16 f, fc, fm and fb (K1-bf16's kernels on the dense
// layout); the moment_mask stays fp32.
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
