// Image-source RIR engine (C++/OpenMP) — production-scale data generation.
//
// Native equivalent of gpuRIR's CUDA simulateRIR for the host data path
// (reference: FN-SSL/Dataset.py:141-201 calls gpuRIR). Same math as the
// numpy engine in fnssl_tpu_torch/sim/ism.py: Allen & Berkley images with
// per-dimension reflection orders, amplitude beta products / (4*pi*d),
// linear fractional-delay interpolation. Parallel over trajectory points.
//
// C ABI for ctypes:
//   simulate_rir_native(room(3), beta(6), src(npts*3), mic(nch*3),
//                       nb_img(3), npts, nch, nsamp, fs, c, out)
//   out: (npts, nch, nsamp) float32, zero-initialised by the caller.
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

void simulate_rir_native(const double* room, const double* beta,
                         const double* src, const double* mic,
                         const int32_t* nb_img, int32_t npts, int32_t nch,
                         int32_t nsamp, double fs, double c, float* out) {
    const double inv_4pi = 1.0 / (4.0 * M_PI);
    const double fs_c = fs / c;

    // Pre-compute per-dimension image offsets and amplitudes:
    // image coordinate = (1-2p)*s + 2qL with amplitude
    // beta_lo^|q-p| * beta_hi^|q|, p in {0,1}, q in [-O..O].
    struct DimImages {
        std::vector<double> coef;   // (1-2p)
        std::vector<double> off;    // 2qL
        std::vector<double> amp;
    };
    DimImages dims[3];
    for (int d = 0; d < 3; ++d) {
        const int order = nb_img[d];
        for (int p = 0; p <= 1; ++p) {
            for (int q = -order; q <= order; ++q) {
                dims[d].coef.push_back(1.0 - 2.0 * p);
                dims[d].off.push_back(2.0 * q * room[d]);
                dims[d].amp.push_back(std::pow(beta[2 * d],
                                               std::abs(q - p)) *
                                      std::pow(beta[2 * d + 1],
                                               std::abs(q)));
            }
        }
    }

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int32_t pt = 0; pt < npts; ++pt) {
        const double sx = src[pt * 3 + 0];
        const double sy = src[pt * 3 + 1];
        const double sz = src[pt * 3 + 2];
        // double-precision accumulation buffer per (point, mic)
        std::vector<double> acc((size_t)nch * (nsamp + 1), 0.0);
        for (size_t ix = 0; ix < dims[0].amp.size(); ++ix) {
            const double ax = dims[0].amp[ix];
            if (ax == 0.0) continue;
            const double px = dims[0].coef[ix] * sx + dims[0].off[ix];
            for (size_t iy = 0; iy < dims[1].amp.size(); ++iy) {
                const double axy = ax * dims[1].amp[iy];
                if (axy == 0.0) continue;
                const double py = dims[1].coef[iy] * sy + dims[1].off[iy];
                for (size_t iz = 0; iz < dims[2].amp.size(); ++iz) {
                    const double a = axy * dims[2].amp[iz];
                    if (a == 0.0) continue;
                    const double pz =
                        dims[2].coef[iz] * sz + dims[2].off[iz];
                    for (int32_t m = 0; m < nch; ++m) {
                        const double dx = px - mic[m * 3 + 0];
                        const double dy = py - mic[m * 3 + 1];
                        const double dz = pz - mic[m * 3 + 2];
                        const double dist =
                            std::sqrt(dx * dx + dy * dy + dz * dz);
                        const double tsamp = dist * fs_c;
                        const int64_t i0 = (int64_t)std::floor(tsamp);
                        if (i0 >= nsamp) continue;
                        const double w = tsamp - (double)i0;
                        const double amp = a * inv_4pi / dist;
                        double* row = acc.data() + (size_t)m * (nsamp + 1);
                        row[i0] += amp * (1.0 - w);
                        row[i0 + 1] += amp * w;
                    }
                }
            }
        }
        for (int32_t m = 0; m < nch; ++m) {
            const double* row = acc.data() + (size_t)m * (nsamp + 1);
            float* dst = out + ((size_t)pt * nch + m) * nsamp;
            for (int32_t i = 0; i < nsamp; ++i)
                dst[i] = (float)row[i];
        }
    }
}

int32_t ism_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
