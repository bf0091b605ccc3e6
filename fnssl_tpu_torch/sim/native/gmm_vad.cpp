// GMM voice-activity detector (C++) — the webrtcvad-class native slot.
//
// The reference cleans LibriSpeech silences with webrtcvad
// (FN-SSL/Dataset.py:221-233), whose core is a 6-sub-band Gaussian
// mixture classifier with adaptive noise tracking (webrtc vad_core).
// This is a faithful float reimplementation of that architecture (not a
// code copy — webrtc is Q-format fixed point):
//
//   * 10 ms frames; features = log2 energies of the 6 webrtc sub-bands
//     80-250 / 250-500 / 500-1k / 1-2k / 2-3k / 3-4k Hz (computed here
//     via a per-frame Goertzel-style DFT instead of webrtc's split-band
//     allpass cascade — same feature, simpler float path);
//   * per band: 2-component noise GMM + 2-component speech GMM over the
//     feature; decision = weighted global log-likelihood-ratio test OR
//     any single-band LLR above a local threshold;
//   * adaptation: minimum-statistics noise tracking (per-band feature
//     minima over a sliding ~100-frame window pull the noise means),
//     decision-gated mean/variance updates, and a speech/noise mean
//     separation constraint;
//   * hangover smoothing and 4 aggressiveness modes (0 = quality ...
//     3 = very aggressive), matching webrtcvad's set_mode contract.
//
// C ABI:
//   gmm_vad_native(signal, n, fs, mode, out_mask)
//     signal: float32 mono; fs: 8000/16000/32000/48000; mode: 0..3
//     out_mask: (n,) float32 0/1 per sample (caller zero-fills).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBands = 6;
constexpr int kGauss = 2;  // components per model per band
// band edges in Hz (webrtc sub-bands)
const double kBandLo[kBands] = {80, 250, 500, 1000, 2000, 3000};
const double kBandHi[kBands] = {250, 500, 1000, 2000, 3000, 4000};
// relative spectral weights of the bands in the global LLR
// (shape follows webrtc kSpectrumWeight {6,8,10,12,14,16})
const double kSpecW[kBands] = {6, 8, 10, 12, 14, 16};
// mode → (local single-band threshold, global threshold, hangover
// frames); higher mode = stricter = fewer frames kept
struct Mode { double local, global_; int overhang; };
const Mode kModes[4] = {
    {1.0, 3.0, 8},
    {1.5, 4.5, 6},
    {2.0, 6.5, 5},
    {2.6, 9.0, 4},
};

constexpr double kMinVar = 0.20, kMaxVar = 30.0;
constexpr double kMeanSep = 1.6;       // min speech-noise mean gap (log2)
constexpr double kNoiseRate = 0.10;    // decision-gated noise mean rate
constexpr double kSpeechRate = 0.04;
constexpr double kVarRate = 0.02;
constexpr double kMinTrackRate = 0.06; // pull toward running minimum
constexpr int kMinWindow = 100;        // frames in the minimum window

double gauss(double x, double m, double v) {
    const double d = x - m;
    return std::exp(-0.5 * d * d / v) / std::sqrt(2.0 * M_PI * v);
}

struct Model {
    double nm[kBands][kGauss], nv[kBands][kGauss];   // noise mean/var
    double sm[kBands][kGauss], sv[kBands][kGauss];   // speech mean/var
};

void init_model(Model& mdl) {
    // generic priors; the minimum tracker re-anchors the noise means to
    // the observed floor within ~0.5 s
    for (int k = 0; k < kBands; ++k) {
        mdl.nm[k][0] = -24.0; mdl.nm[k][1] = -20.0;
        mdl.nv[k][0] = 6.0;   mdl.nv[k][1] = 10.0;
        mdl.sm[k][0] = -12.0; mdl.sm[k][1] = -6.0;
        mdl.sv[k][0] = 8.0;   mdl.sv[k][1] = 12.0;
    }
}

// log2 band energies of one frame via direct DFT on the 16 kHz grid
void band_features(const float* frame, int flen, double fs,
                   double feat[kBands]) {
    const int nbin = flen / 2 + 1;
    const double df = fs / flen;
    std::vector<double> power(nbin, 0.0);
    // Goertzel per bin over the needed range only (up to 4 kHz)
    const int kmax = std::min(nbin - 1, (int)(4000.0 / df));
    for (int k = 1; k <= kmax; ++k) {
        const double w = 2.0 * M_PI * k / flen;
        const double coeff = 2.0 * std::cos(w);
        double s0 = 0.0, s1 = 0.0, s2 = 0.0;
        for (int i = 0; i < flen; ++i) {
            s0 = frame[i] + coeff * s1 - s2;
            s2 = s1;
            s1 = s0;
        }
        power[k] = s1 * s1 + s2 * s2 - coeff * s1 * s2;
    }
    for (int b = 0; b < kBands; ++b) {
        double acc = 1e-10;
        const int lo = std::max(1, (int)std::ceil(kBandLo[b] / df));
        const int hi = std::min(kmax, (int)(kBandHi[b] / df));
        for (int k = lo; k <= hi; ++k) acc += power[k];
        feat[b] = std::log2(acc / flen);
    }
}

}  // namespace

extern "C" {

// Returns the number of frames processed; fills out_mask per sample.
int64_t gmm_vad_native(const float* signal, int64_t n, int32_t fs,
                       int32_t mode, float* out_mask) {
    if (fs % 8000 != 0 || mode < 0 || mode > 3) return -1;
    // decimate to 16 kHz by simple averaging when needed (32k/48k)
    std::vector<float> ds;
    const float* x = signal;
    int64_t nx = n;
    int64_t dec = 1;
    if (fs > 16000) {
        dec = fs / 16000;
        nx = n / dec;
        ds.resize(nx);
        for (int64_t i = 0; i < nx; ++i) {
            float acc = 0.f;
            for (int64_t j = 0; j < dec; ++j) acc += signal[i * dec + j];
            ds[i] = acc / dec;
        }
        x = ds.data();
        fs = 16000;
    }
    const int flen = fs / 100;                 // 10 ms
    const int64_t nframes = nx / flen;
    if (nframes == 0) return 0;

    Model mdl;
    init_model(mdl);
    const Mode& m = kModes[mode];

    // sliding minimum tracker (simple windowed minimum over history)
    std::vector<std::vector<double>> hist(kBands);
    int hang = 0;
    int speech_run = 0;

    for (int64_t t = 0; t < nframes; ++t) {
        double feat[kBands];
        band_features(x + t * flen, flen, fs, feat);

        // ---- classification ----
        double global_llr = 0.0;
        bool local_hit = false;
        double llr[kBands];
        for (int k = 0; k < kBands; ++k) {
            double pn = 1e-12, ps = 1e-12;
            for (int g = 0; g < kGauss; ++g) {
                pn += 0.5 * gauss(feat[k], mdl.nm[k][g], mdl.nv[k][g]);
                ps += 0.5 * gauss(feat[k], mdl.sm[k][g], mdl.sv[k][g]);
            }
            llr[k] = std::log(ps) - std::log(pn);
            // a feature quieter than the noise model is never speech
            // (guards the wider speech Gaussian's low-energy tail)
            if (feat[k] <= std::max(mdl.nm[k][0], mdl.nm[k][1]))
                llr[k] = std::min(llr[k], 0.0);
            global_llr += kSpecW[k] / 16.0 * llr[k];
            if (llr[k] * kSpecW[k] / 16.0 > m.local) local_hit = true;
        }
        bool raw_speech = local_hit || global_llr > m.global_;

        // ---- hangover smoothing (webrtc overhang semantics) ----
        bool speech = raw_speech;
        if (raw_speech) {
            ++speech_run;
            if (speech_run >= 2) hang = m.overhang;
        } else if (hang > 0) {
            speech = true;
            --hang;
            speech_run = 0;
        } else {
            speech_run = 0;
        }

        // ---- adaptation ----
        for (int k = 0; k < kBands; ++k) {
            // minimum statistics: window minimum anchors the noise model
            auto& h = hist[k];
            h.push_back(feat[k]);
            if ((int64_t)h.size() > kMinWindow)
                h.erase(h.begin());
            const double fmin = *std::min_element(h.begin(), h.end());
            for (int g = 0; g < kGauss; ++g)
                mdl.nm[k][g] += kMinTrackRate
                    * ((fmin + 1.0 * g) - mdl.nm[k][g]);

            if (!raw_speech) {
                // decision-gated noise update (responsibility-weighted)
                double p0 = gauss(feat[k], mdl.nm[k][0], mdl.nv[k][0]);
                double p1 = gauss(feat[k], mdl.nm[k][1], mdl.nv[k][1]);
                const double r1 = p1 / (p0 + p1 + 1e-12);
                mdl.nm[k][0] += kNoiseRate * (1 - r1)
                    * (feat[k] - mdl.nm[k][0]);
                mdl.nm[k][1] += kNoiseRate * r1
                    * (feat[k] - mdl.nm[k][1]);
                for (int g = 0; g < kGauss; ++g) {
                    const double d = feat[k] - mdl.nm[k][g];
                    mdl.nv[k][g] += kVarRate * (d * d - mdl.nv[k][g]);
                    mdl.nv[k][g] = std::min(std::max(mdl.nv[k][g],
                                                     kMinVar), kMaxVar);
                }
            } else {
                double p0 = gauss(feat[k], mdl.sm[k][0], mdl.sv[k][0]);
                double p1 = gauss(feat[k], mdl.sm[k][1], mdl.sv[k][1]);
                const double r1 = p1 / (p0 + p1 + 1e-12);
                mdl.sm[k][0] += kSpeechRate * (1 - r1)
                    * (feat[k] - mdl.sm[k][0]);
                mdl.sm[k][1] += kSpeechRate * r1
                    * (feat[k] - mdl.sm[k][1]);
                for (int g = 0; g < kGauss; ++g) {
                    const double d = feat[k] - mdl.sm[k][g];
                    mdl.sv[k][g] += kVarRate * (d * d - mdl.sv[k][g]);
                    mdl.sv[k][g] = std::min(std::max(mdl.sv[k][g],
                                                     kMinVar), kMaxVar);
                }
            }
            // separation constraint: speech stays above noise
            for (int g = 0; g < kGauss; ++g) {
                const double nmax = std::max(mdl.nm[k][0], mdl.nm[k][1]);
                if (mdl.sm[k][g] < nmax + kMeanSep)
                    mdl.sm[k][g] = nmax + kMeanSep;
            }
        }

        if (speech) {
            float* dst = out_mask + t * flen * dec;
            const int64_t len = std::min<int64_t>(flen * dec,
                                                  n - t * flen * dec);
            for (int64_t j = 0; j < len; ++j) dst[j] = 1.0f;
        }
    }
    return nframes;
}

}  // extern "C"
