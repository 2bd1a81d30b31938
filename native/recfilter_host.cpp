// recfilter_host — native host-side math for recfilter.
//
// C++ rebuild of the reference's host-side numeric kit: the closure-matrix
// builders (lib/coefficients.cpp:8-128), the tail-weight/carry-chain algebra
// (lib/split.cpp:152-203), and the IIR coefficient derivation
// (lib/iir_coeff.cpp:38-177). The Python package loads this through ctypes
// (recfilter/utils/native.py) as the fast path for trace-time
// precomputation; numpy remains the fallback and the source of truth for
// tests. All math is double precision; the semantics match
// recfilter/coeffs.py exactly (including the updated-value clamp model —
// see the note in coeffs.impulse_matrix).
//
// Build: make -C native   →  librecfilter_host.so

#include <cmath>
#include <complex>
#include <cstring>
#include <vector>

extern "C" {

// B ∈ R^{T×T} (row-major): zero-state scan is y = B x.
// coeffs.impulse_matrix.
void rf_impulse_matrix(double feedfwd, const double* feedback, int order,
                       int T, int clamp_border, double* B) {
    std::memset(B, 0, sizeof(double) * T * T);
    for (int i = 0; i < T; i++) B[i * T + i] = feedfwd;
    for (int y = 0; y < T; y++) {
        for (int j = 0; j < order; j++) {
            const int src = y - j - 1;
            if (src >= 0) {
                const double a = feedback[j];
                double* row = B + y * T;
                const double* prev = B + src * T;
                for (int x = 0; x < T; x++) row[x] += a * prev[x];
            } else if (clamp_border) {
                if (y == 0) {
                    B[0] += feedback[j];  // pre-update site: raw input x[0]
                } else {
                    const double a = feedback[j];
                    double* row = B + y * T;
                    const double* r0 = B;  // updated output y[0]
                    for (int x = 0; x < T; x++) row[x] += a * r0[x];
                }
            }
        }
    }
}

// R ∈ R^{T×k} (row-major): response to incoming state, y += R s.
// coeffs.state_matrix.
void rf_state_matrix(const double* feedback, int order, int T, double* R) {
    std::memset(R, 0, sizeof(double) * T * order);
    for (int y = 0; y < T; y++) {
        if (y < order) {
            for (int x = 0; x < order; x++) {
                if (x + y < order) R[y * order + x] = feedback[x + y];
            }
        }
        for (int j = 0; j < order; j++) {
            const int src = y - j - 1;
            if (src >= 0) {
                const double a = feedback[j];
                for (int x = 0; x < order; x++)
                    R[y * order + x] += a * R[src * order + x];
            }
        }
    }
}

// W = P R ∈ R^{k×k}: carry propagation across one tile.
// coeffs.tail_weight_matrix.
void rf_tail_weight_matrix(const double* feedback, int order, int T,
                           double* W) {
    std::vector<double> R(static_cast<size_t>(T) * order);
    rf_state_matrix(feedback, order, T, R.data());
    for (int j = 0; j < order; j++)
        for (int i = 0; i < order; i++)
            W[j * order + i] = R[(T - 1 - j) * order + i];
}

// M ∈ R^{(n·k)×(n·k)} block lower-triangular carry-chain solve matrix.
// prev != 0 → M[t,i] = W^{t-1-i} for i < t (incoming state), else
// M[t,i] = W^{t-i} for i <= t (completed state). coeffs.carry_chain_matrix.
void rf_carry_chain_matrix(const double* feedback, int order, int T, int n,
                           int prev, double* M) {
    const int k = order;
    std::vector<double> W(static_cast<size_t>(k) * k);
    rf_tail_weight_matrix(feedback, k, T, W.data());

    // powers[d] = W^d, d = 0..n
    std::vector<std::vector<double>> powers(n + 1,
        std::vector<double>(static_cast<size_t>(k) * k, 0.0));
    for (int i = 0; i < k; i++) powers[0][i * k + i] = 1.0;
    for (int d = 1; d <= n; d++) {
        for (int i = 0; i < k; i++)
            for (int j = 0; j < k; j++) {
                double acc = 0.0;
                for (int m = 0; m < k; m++)
                    acc += W[i * k + m] * powers[d - 1][m * k + j];
                powers[d][i * k + j] = acc;
            }
    }

    const int N = n * k;
    std::memset(M, 0, sizeof(double) * N * N);
    for (int t = 0; t < n; t++) {
        for (int i = 0; i <= t; i++) {
            const int d = t - i;
            const double* P;
            if (prev) {
                if (i >= t) continue;
                P = powers[d - 1].data();
            } else {
                P = powers[d].data();
            }
            for (int a = 0; a < k; a++)
                for (int b = 0; b < k; b++)
                    M[(t * k + a) * N + (i * k + b)] = P[a * k + b];
        }
    }
}

// ---- IIR coefficient derivation (lib/iir_coeff.cpp:38-177) ----

static double rf_qs(double s) { return 0.00399341 + 0.4715161 * s; }

void rf_weights1(double s, double* out /* b0, a1 */) {
    const double d3 = 1.86543;
    const double d = std::pow(d3, 1.0 / rf_qs(s));
    out[0] = -(1.0 - d) / d;
    out[1] = -1.0 / d;
}

void rf_weights2(double s, double* out /* b0, a1, a2 */) {
    const std::complex<double> d1(1.41650, 1.00829);
    const double q = rf_qs(s);
    const std::complex<double> d =
        std::polar(std::pow(std::abs(d1), 1.0 / q), std::arg(d1) / q);
    const double n2 = std::norm(d);
    const double re = d.real();
    out[0] = (1.0 - 2.0 * re + n2) / n2;
    out[1] = -2.0 * re / n2;
    out[2] = 1.0 / n2;
}

// [b0, a1..a_order] with the add_filter sign convention (negated a_i).
void rf_gaussian_weights(double sigma, int order, double* out) {
    if (order == 1) {
        double w[2];
        rf_weights1(sigma, w);
        out[0] = w[0];
        out[1] = -w[1];
    } else if (order == 2) {
        double w[3];
        rf_weights2(sigma, w);
        out[0] = w[0];
        out[1] = -w[1];
        out[2] = -w[2];
    } else {
        double w1[2], w2[3];
        rf_weights1(sigma, w1);
        rf_weights2(sigma, w2);
        out[0] = w1[0] * w2[0];
        out[1] = -(w1[1] + w2[1]);
        out[2] = -(w1[1] * w2[1] + w2[2]);
        out[3] = -(w1[1] * w2[2]);
    }
}

// Convolution of two feedback polynomials (lib/iir_coeff.cpp:236-263).
void rf_overlap_feedback(const double* a, int na, const double* b, int nb,
                         double* c /* size na+nb */) {
    std::vector<double> pa(na + 1), pb(nb + 1);
    pa[0] = 1.0;
    for (int i = 0; i < na; i++) pa[i + 1] = -a[i];
    pb[0] = 1.0;
    for (int i = 0; i < nb; i++) pb[i + 1] = -b[i];
    std::vector<double> full(na + nb + 1, 0.0);
    for (size_t i = 0; i < full.size(); i++)
        for (size_t j = 0; j <= i; j++)
            if (j < pa.size() && i - j < pb.size())
                full[i] += pa[j] * pb[i - j];
    for (int i = 0; i < na + nb; i++) c[i] = -full[i + 1];
}

}  // extern "C"

// ---- Image IO (demo/image_io.h analog): binary PPM/PGM ----
//
// Minimal, fast native readers/writers used by the Python package through
// ctypes when present (utils/native.py); the pure-Python codec remains the
// fallback and handles PNG.

#include <cstdio>
#include <cstdint>

extern "C" {

// Returns 0 on success. Reads header into w/h/channels; data must be
// pre-sized to w*h*channels bytes by a first call with data == nullptr.
int rf_ppm_read(const char* path, int* w, int* h, int* channels,
                unsigned char* data) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    char magic[3] = {0};
    int maxval = 0;
    if (std::fscanf(f, "%2s", magic) != 1) { std::fclose(f); return 2; }
    int nc;
    if (magic[0] == 'P' && magic[1] == '6') nc = 3;
    else if (magic[0] == 'P' && magic[1] == '5') nc = 1;
    else { std::fclose(f); return 3; }
    if (std::fscanf(f, "%d %d %d", w, h, &maxval) != 3) {
        std::fclose(f); return 4;
    }
    std::fgetc(f);  // single whitespace after maxval
    *channels = nc;
    if (data) {
        size_t need = static_cast<size_t>(*w) * *h * nc;
        if (std::fread(data, 1, need, f) != need) { std::fclose(f); return 5; }
    }
    std::fclose(f);
    return 0;
}

int rf_ppm_write(const char* path, int w, int h, int channels,
                 const unsigned char* data) {
    if (channels != 1 && channels != 3) return 3;
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    std::fprintf(f, "P%c\n%d %d\n255\n", channels == 3 ? '6' : '5', w, h);
    size_t n = static_cast<size_t>(w) * h * channels;
    size_t written = std::fwrite(data, 1, n, f);
    std::fclose(f);
    return written == n ? 0 : 2;
}

}  // extern "C"
