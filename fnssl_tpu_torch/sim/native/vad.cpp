// Frame-energy voice-activity detector (C++) — native host data path.
//
// The reference's silence cleaning runs webrtcvad (C++ GMM VAD,
// FN-SSL/Dataset.py:221-233); this is the native implementation of our
// energy-ladder detector (same semantics as fnssl_tpu_torch/data/vad.py):
// 10 ms frame energies in dB, a frame is speech when it exceeds the
// 5th-percentile noise floor by an aggressiveness-dependent margin.
//
// C ABI:
//   frame_vad_native(signal, n, frame_len, margin_db, out_mask)
//   out_mask: (n,) float32 0/1 per sample, zero-filled by caller.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

void frame_vad_native(const float* signal, int64_t n, int32_t frame_len,
                      double margin_db, float* out_mask) {
    const int64_t nframes = n / frame_len;
    if (nframes == 0) return;
    std::vector<double> energy_db(nframes);
    for (int64_t i = 0; i < nframes; ++i) {
        double acc = 0.0;
        const float* f = signal + i * frame_len;
        for (int32_t j = 0; j < frame_len; ++j)
            acc += (double)f[j] * (double)f[j];
        energy_db[i] = 10.0 * std::log10(acc / frame_len + 1e-12);
    }
    // 5th percentile (numpy 'linear' interpolation) as the noise floor
    std::vector<double> sorted(energy_db);
    std::sort(sorted.begin(), sorted.end());
    const double pos = 0.05 * (double)(nframes - 1);
    const int64_t lo = (int64_t)pos;
    const int64_t hi = std::min(lo + 1, nframes - 1);
    const double frac = pos - (double)lo;
    const double floor_db = sorted[lo] * (1.0 - frac) + sorted[hi] * frac;
    const double th = floor_db + margin_db;
    for (int64_t i = 0; i < nframes; ++i) {
        if (energy_db[i] > th) {
            float* dst = out_mask + i * frame_len;
            for (int32_t j = 0; j < frame_len; ++j) dst[j] = 1.0f;
        }
    }
}

}  // extern "C"
