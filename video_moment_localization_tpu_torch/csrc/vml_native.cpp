// Native host-side data-pipeline kernels.
//
// The per-sample Python/NumPy label generation (IoU target map, boundary
// Gaussians, snippet labels, masks — see data/labels.py, which mirrors the
// reference's semantics from dataset.py:95-149) runs hot in the input
// pipeline: one call per (video, query) sample per epoch, on small arrays
// where NumPy's per-op overhead dominates. These C implementations compute
// a sample's full label set in one call.
//
// Semantics are kept bit-compatible with the float32 NumPy path:
// * snippet times are computed as float(i) * duration / L in fp32;
// * IoU uses the hull union max(0, max(ends) - min(starts));
// * frame-index rounding uses round-half-to-even (numpy np.round).
//
// The PyTorch port's copy of the JAX package's csrc/vml_native.cpp, kept
// equal to it. Build: g++ -O3 -fPIC -shared (driven by
// video_moment_localization_tpu_torch/data/native.py, into the package's
// _build/; the Python layer falls back to NumPy when the shared object is
// unavailable).

#include <cfenv>
#include <cmath>
#include <cstdint>

namespace {

inline float snippet_start(int i, float duration, int L) {
  return static_cast<float>(i) * duration / static_cast<float>(L);
}

inline float snippet_end(int j, float duration, int L) {
  return static_cast<float>(j + 1) * duration / static_cast<float>(L);
}

}  // namespace

extern "C" {

// Full label set for one sample. Output buffers: sm, ym (L*L); ss, ys, se,
// ye, ya (L). Matches data/labels.py::{iou_target_map, boundary_penalties,
// snippet_labels}.
void vml_generate_labels(double spos_d, double epos_d, double duration_d,
                         int32_t L, float* sm, float* ym, float* ss,
                         float* ys, float* se, float* ye, float* ya) {
  const float spos = static_cast<float>(spos_d);
  const float epos = static_cast<float>(epos_d);
  const float duration = static_cast<float>(duration_d);
  const float sigma = (epos - spos) / 5.0f;
  const float denom = 2.0f * sigma * sigma;

  for (int i = 0; i < L; ++i) {
    const float ps = snippet_start(i, duration, L);
    // boundary + snippet labels share the same snippet times
    const float pe_i = snippet_end(i, duration, L);
    const float s_s = std::exp(-((ps - spos) * (ps - spos)) / denom);
    const float s_e = std::exp(-((pe_i - epos) * (pe_i - epos)) / denom);
    ss[i] = s_s;
    ys[i] = s_s > 0.5f ? 1.0f : 0.0f;
    se[i] = s_e;
    ye[i] = s_e > 0.5f ? 1.0f : 0.0f;
    ya[i] = (ps >= spos && pe_i <= epos) ? 1.0f : 0.0f;

    for (int j = 0; j < L; ++j) {
      const float pe = snippet_end(j, duration, L);
      const float inter =
          std::fmax(0.0f, std::fmin(pe, epos) - std::fmax(ps, spos));
      const float hull =
          std::fmax(0.0f, std::fmax(pe, epos) - std::fmin(ps, spos));
      const float iou = hull > 0.0f ? inter / hull : 0.0f;
      sm[i * L + j] = iou;
      ym[i * L + j] = iou > 0.5f ? 1.0f : 0.0f;
    }
  }
}

// Masks for a video with `nfeats` valid sampled clips (nfeats <= T).
// video_mask (T), length_mask (L), moment_mask (L*L); matches
// data/labels.py::build_masks (moment mask = triu AND outer(length,length)).
void vml_build_masks(int32_t nfeats, int32_t T, int32_t L, float* video_mask,
                     float* length_mask, float* moment_mask) {
  for (int t = 0; t < T; ++t) video_mask[t] = t < nfeats ? 1.0f : 0.0f;
  const double per_snippet = static_cast<double>(T) / static_cast<double>(L);
  const int valid =
      static_cast<int>(std::ceil(static_cast<double>(nfeats) / per_snippet));
  for (int l = 0; l < L; ++l) length_mask[l] = l < valid ? 1.0f : 0.0f;
  for (int i = 0; i < L; ++i)
    for (int j = 0; j < L; ++j)
      moment_mask[i * L + j] =
          (j >= i && i < valid && j < valid) ? 1.0f : 0.0f;
}

// Packed-layout variant of vml_generate_labels: sm/ym hold only the
// N = L(L+1)/2 upper-triangular pairs in row-major (i, j >= i) order —
// the order of numpy.triu_indices (ops/packing.py). Written for the packed
// training pipeline where no (L, L) map ever exists.
void vml_generate_labels_packed(double spos_d, double epos_d,
                                double duration_d, int32_t L, float* sm,
                                float* ym, float* ss, float* ys, float* se,
                                float* ye, float* ya) {
  const float spos = static_cast<float>(spos_d);
  const float epos = static_cast<float>(epos_d);
  const float duration = static_cast<float>(duration_d);
  const float sigma = (epos - spos) / 5.0f;
  const float denom = 2.0f * sigma * sigma;

  int n = 0;
  for (int i = 0; i < L; ++i) {
    const float ps = snippet_start(i, duration, L);
    const float pe_i = snippet_end(i, duration, L);
    const float s_s = std::exp(-((ps - spos) * (ps - spos)) / denom);
    const float s_e = std::exp(-((pe_i - epos) * (pe_i - epos)) / denom);
    ss[i] = s_s;
    ys[i] = s_s > 0.5f ? 1.0f : 0.0f;
    se[i] = s_e;
    ye[i] = s_e > 0.5f ? 1.0f : 0.0f;
    ya[i] = (ps >= spos && pe_i <= epos) ? 1.0f : 0.0f;

    for (int j = i; j < L; ++j, ++n) {
      const float pe = snippet_end(j, duration, L);
      const float inter =
          std::fmax(0.0f, std::fmin(pe, epos) - std::fmax(ps, spos));
      const float hull =
          std::fmax(0.0f, std::fmax(pe, epos) - std::fmin(ps, spos));
      const float iou = hull > 0.0f ? inter / hull : 0.0f;
      sm[n] = iou;
      ym[n] = iou > 0.5f ? 1.0f : 0.0f;
    }
  }
}

// Packed-mode masks: no dense moment mask (pair validity is derived on
// device from length_mask).
void vml_build_masks_packed(int32_t nfeats, int32_t T, int32_t L,
                            float* video_mask, float* length_mask) {
  for (int t = 0; t < T; ++t) video_mask[t] = t < nfeats ? 1.0f : 0.0f;
  const double per_snippet = static_cast<double>(T) / static_cast<double>(L);
  const int valid =
      static_cast<int>(std::ceil(static_cast<double>(nfeats) / per_snippet));
  for (int l = 0; l < L; ++l) length_mask[l] = l < valid ? 1.0f : 0.0f;
}

// Whole-batch packed label + mask generation: ONE ctypes crossing per
// batch instead of ~11 per sample (the crossings alone were ~25% of
// per-sample assembly time — see data/pipeline.py). Inputs are per-sample
// scalars (B,); outputs are row-major batch arrays:
//   video_mask (B, T), length_mask (B, L), sm/ym (B, N), ss/ys/se/ye/ya
//   (B, L) with N = L(L+1)/2. Rows with nfeats[b] < 0 (batch padding) are
//   zero-filled.
void vml_assemble_batch_packed(const double* spos, const double* epos,
                               const double* duration, const int32_t* nfeats,
                               int32_t B, int32_t T, int32_t L,
                               float* video_mask, float* length_mask,
                               float* sm, float* ym, float* ss, float* ys,
                               float* se, float* ye, float* ya) {
  const int32_t N = L * (L + 1) / 2;
  for (int b = 0; b < B; ++b) {
    float* vm = video_mask + b * T;
    float* lm = length_mask + b * L;
    if (nfeats[b] < 0) {  // padded row
      for (int t = 0; t < T; ++t) vm[t] = 0.0f;
      for (int l = 0; l < L; ++l) lm[l] = 0.0f;
      for (int n = 0; n < N; ++n) { sm[b * N + n] = 0.0f; ym[b * N + n] = 0.0f; }
      for (int l = 0; l < L; ++l) {
        ss[b * L + l] = ys[b * L + l] = se[b * L + l] = ye[b * L + l] =
            ya[b * L + l] = 0.0f;
      }
      continue;
    }
    vml_build_masks_packed(nfeats[b], T, L, vm, lm);
    vml_generate_labels_packed(spos[b], epos[b], duration[b], L, sm + b * N,
                               ym + b * N, ss + b * L, ys + b * L, se + b * L,
                               ye + b * L, ya + b * L);
  }
}

// Fixed-length sampler index math (data/sampler.py): frame indices via
// round-half-to-even over arange(spos, nfeats-0.5, stride), truncated to T;
// start/end GT indices via the linear scan over consecutive index pairs.
// frame_idx must hold T entries; returns the number of valid indices.
int32_t vml_sample_indices(int32_t nfeats, int32_t T, int32_t spos,
                           double start_pos_n, double end_pos_n,
                           int32_t* frame_idx, int32_t* start_index,
                           int32_t* end_index) {
  const double stride =
      nfeats <= T ? 1.0
                  : static_cast<double>(nfeats) / static_cast<double>(T);
  // numpy arange semantics: count = ceil((stop - start) / step),
  // element k = start + k * step (no accumulation drift).
  const double stop = nfeats - 0.5;
  int n_total = static_cast<int>(std::ceil((stop - spos) / stride));
  if (n_total < 0) n_total = 0;
  const int expected = nfeats < T ? nfeats : T;
  const int n = n_total < expected ? n_total : expected;  // truncate overrun
  const int old_round = std::fegetround();
  std::fesetround(FE_TONEAREST);  // nearbyint == round-half-to-even
  for (int k = 0; k < n; ++k) {
    frame_idx[k] = static_cast<int32_t>(std::nearbyint(spos + k * stride));
  }
  std::fesetround(old_round);

  const double start_pos = (nfeats - 1.0) * start_pos_n;
  const double end_pos = (nfeats - 1.0) * end_pos_n;
  *start_index = 0;
  *end_index = T - 1;
  for (int i = 0; i + 1 < n; ++i) {
    if (frame_idx[i] <= end_pos && end_pos < frame_idx[i + 1]) *end_index = i;
    if (frame_idx[i] <= start_pos && start_pos < frame_idx[i + 1])
      *start_index = i;
  }
  return n;
}

}  // extern "C"
