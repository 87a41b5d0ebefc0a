// Native lossless candidate search: the host-side encoder hot path.
//
// The bulk pipelines amortize device dispatch and transfer over thousands
// of lanes; a streaming encoder emitting one 1 s frame at a time cannot
// (each frame would pay a device round trip), so single-frame encodes run
// entirely on the host: this is the native equivalent of the reference's
// per-channel search loop (lossless/encoder.rs:173-217 + lpc.rs), the
// encode-side sibling of rice.cpp's reconstruction kernels.
//
// Semantics mirrored exactly:
//   * candidate order raw -> fixed 0..min(4,max) -> LPC 5..max, strict-<
//     byte-size tie-break (encoder.rs:173-217)
//   * fixed predictors ramp through orders 0..i for the first samples
//     (lpc.rs:301-359); LPC warm-up emits samples verbatim (lpc.rs:283-285)
//   * integer autocorrelation (exact, lpc.rs:213-221), f64 Levinson-Durbin
//     for every order in one recursion with instability rejection and
//     fixed-point quantization shift = clamp(floor(log2(2^30/max|c|)),0,15)
//     (lpc.rs:225-276) — same operation order as ops/lpc.py's host mirror
//   * LPC candidates with any wrapping-abs residual > 1e6 are rejected
//     (encoder.rs:269-271)
//   * Rice k = clamp(max(min_k, mean_k), 0, 15) on unsigned_abs residuals
//     (rice.rs:29-69); size = sum(min(u>>k,255)+1+k) bits
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC encode.cpp -o libencode.so

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int MAX_ORDER = 12;

const int32_t FIXED_COEFFS[5][4] = {
    {0, 0, 0, 0},
    {1, 0, 0, 0},
    {2, -1, 0, 0},
    {3, -3, 1, 0},
    {4, -6, 4, -1},
};

inline int32_t wrap_i32(int64_t v) {
    return static_cast<int32_t>(static_cast<uint32_t>(static_cast<uint64_t>(v)));
}

inline int bit_length_u64(uint64_t v) {
    return v == 0 ? 0 : 64 - __builtin_clzll(v);
}

// Rice parameter estimate (rice.rs:29-69 / core/rice_host.estimate_parameter).
inline int estimate_k(const int32_t* r, int64_t n) {
    if (n == 0) return 4;
    uint64_t max_abs = 0, sum_abs = 0;
    for (int64_t i = 0; i < n; ++i) {
        // unsigned_abs: i32::MIN -> 2^31
        uint64_t a = r[i] < 0 ? (uint64_t)(-(int64_t)r[i]) : (uint64_t)r[i];
        if (a > max_abs) max_abs = a;
        sum_abs += a;
    }
    if (max_abs == 0) return 0;
    uint64_t max_unsigned = 2 * max_abs;
    int min_k = max_unsigned > 255 ? bit_length_u64(max_unsigned) - 8 : 0;
    if (min_k < 0) min_k = 0;
    uint64_t mean = sum_abs / (uint64_t)n;
    int mean_k = bit_length_u64(mean);
    int k = min_k > mean_k ? min_k : mean_k;
    return k < 0 ? 0 : (k > 15 ? 15 : k);
}

// Exact encoded byte size at parameter k.
inline int64_t rice_size_bytes(const int32_t* r, int64_t n, int k) {
    int64_t bits = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t u = ((uint32_t)r[i] << 1) ^ (uint32_t)(r[i] >> 31);
        uint32_t q = u >> k;
        bits += (q > 255 ? 255 : q);
    }
    bits += n * (int64_t)(1 + k);
    return (bits + 7) >> 3;
}

// Fixed predictor residuals with ramp-up (lpc.rs:301-359).
void fixed_residuals(const int32_t* s, int64_t n, int order, int32_t* r) {
    for (int64_t i = 0; i < n; ++i) {
        int ord = i < order ? (int)i : order;  // ramp: predictor order min(i, o)
        if (ord > 4) ord = 4;
        int64_t pred = 0;
        const int32_t* c = FIXED_COEFFS[ord];
        for (int j = 0; j < ord; ++j) pred += (int64_t)c[j] * s[i - 1 - j];
        r[i] = wrap_i32((int64_t)s[i] - (int64_t)wrap_i32(pred));
    }
}

// LPC residuals; returns max over signed wrapping-abs values — EXACTLY the
// reference's `residuals.iter().map(|&r| r.abs()).max()` (encoder.rs:269):
// in release Rust i32::MIN.abs() wraps to i32::MIN, which loses a signed
// max against any non-negative value, so a pathological i32::MIN residual
// does NOT mark the candidate unstable unless every entry is i32::MIN.
// (The device path's exact candidate_size uses the same wrapping max;
// only its f32 selection stats differ — ops/select.py "Unreachable
// pathology" note.)
int32_t lpc_residuals(const int32_t* s, int64_t n, const int32_t* c, int order,
                      int shift, int32_t* r) {
    int32_t max_wa = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (i < order) {
            r[i] = s[i];
            continue;
        }
        int64_t pred = 0;
        for (int j = 0; j < order; ++j) pred += (int64_t)c[j] * s[i - 1 - j];
        int32_t pw = wrap_i32(pred >> shift);
        int32_t v = wrap_i32((int64_t)s[i] - (int64_t)pw);
        r[i] = v;
        int32_t wa = v < 0 ? wrap_i32(-(int64_t)v) : v;  // Rust wrapping abs
        if (wa > max_wa) max_wa = wa;
    }
    return max_wa;
}

}  // namespace

extern "C" {

// Per-lane best-of-N candidate search. lanes [L, S] int32 (mid/side domain),
// nvalid [L]. Candidate plan: raw, fixed 0..min(4, max_order), and (when
// use_lpc) LPC 5..max_order. Outputs: sel_kind (0 raw / 1 fixed / 2 lpc),
// sel_order, k, coeffs [L, 12], shift, size_bytes, residuals [L, S]
// (raw winners: verbatim samples).
//
// prune_topk: 0 evaluates EVERY LPC order (the reference's full search,
// encoder.rs:173-217 — required for byte parity); K > 0 evaluates only the
// K orders with the best PREDICTED size. The predictor is the classic
// Levinson one (the recursion's prediction error eps_o is a byproduct):
//   predicted_bits(o) = n/2 * log2(eps_o) + 32*o
// (expected Rice payload ~ n*log2(E|r|) with E|r| ~ sqrt(eps_o/n); the
// n/2*log2(n) term is constant across orders and dropped; 32*o charges the
// stored i32 coefficients). Residuals, k, and the exact byte size are still
// computed for every SURVIVING candidate, and selection among survivors is
// unchanged (ascending order, strict-<) — pruning can only trade a
// near-tied candidate for its neighbor, never emit wrong bytes. The
// streaming encoder uses K=2: the o(n) residual+size passes are ~75% of
// its frame cost, and the r5 corpus A/B (tools/stream_enc_ab.py) measured
// ~210x -> ~295x realtime with byte-identical output (the predicted top-2
// contained the true winner on every frame).
void lossless_search_batch(
    const int32_t* lanes, int64_t L, int64_t S, const int64_t* nvalid,
    int32_t max_order, int32_t use_lpc, int32_t prune_topk,
    int32_t* sel_kind, int32_t* sel_order, int32_t* k_out,
    int32_t* coeffs_out, int32_t* shift_out, int64_t* size_out,
    int32_t* residuals_out) {
#pragma omp parallel for schedule(dynamic)
    for (int64_t l = 0; l < L; ++l) {
        const int32_t* s = lanes + l * S;
        int64_t n = nvalid[l];
        int32_t* win_r = residuals_out + l * S;
        std::memset(win_r, 0, sizeof(int32_t) * S);

        // Raw baseline.
        int64_t best_size = 2 * n;
        int best_kind = 0, best_order = 0, best_k = 0, best_shift = 0;
        int32_t best_coeffs[MAX_ORDER] = {0};
        std::memcpy(win_r, s, sizeof(int32_t) * (size_t)n);

        int32_t* tmp = new int32_t[(size_t)S];

        int fixed_max = max_order < 4 ? max_order : 4;
        for (int o = 0; o <= fixed_max; ++o) {
            fixed_residuals(s, n, o, tmp);
            int k = estimate_k(tmp, n);
            int64_t size = rice_size_bytes(tmp, n, k);
            if (size < best_size) {
                best_size = size;
                best_kind = 1;
                best_order = o;
                best_k = k;
                best_shift = 0;
                std::memset(best_coeffs, 0, sizeof(best_coeffs));
                std::memcpy(win_r, tmp, sizeof(int32_t) * (size_t)n);
                if (n < S) std::memset(win_r + n, 0, sizeof(int32_t) * (size_t)(S - n));
            }
        }

        if (use_lpc && max_order > 4 && n > 0) {
            // Exact integer autocorrelation, lags 0..max_order.
            double ac[MAX_ORDER + 1];
            for (int lag = 0; lag <= max_order; ++lag) {
                int64_t acc = 0;
                for (int64_t i = lag; i < n; ++i)
                    acc += (int64_t)s[i] * (int64_t)s[i - lag];
                ac[lag] = (double)acc;
            }
            // Levinson-Durbin, every order (ops/lpc.levinson_durbin_all_orders).
            // Pass 1 collects quantized candidates + predicted sizes — the
            // recursion itself is O(order^2), trivially cheap next to the
            // O(n*order) residual passes it lets prune_topk skip.
            struct Cand {
                int order, shift;
                int32_t cq[MAX_ORDER];
                double pred_bits;
            } cands[MAX_ORDER];
            int ncand = 0;
            double coeffs[MAX_ORDER] = {0};
            double error = ac[0];
            bool alive = ac[0] != 0.0;
            for (int i = 0; i < max_order; ++i) {
                double lam = ac[i + 1];
                for (int j = 0; j < i; ++j) lam -= coeffs[j] * ac[i - j];
                if (std::fabs(error) < 1e-10) alive = false;
                double gamma = alive ? lam / (error == 0.0 ? 1.0 : error) : 0.0;
                if (!(std::fabs(gamma) < 1.0)) alive = false;
                if (alive) {
                    double next[MAX_ORDER];
                    for (int j = 0; j < i; ++j)
                        next[j] = coeffs[j] - gamma * coeffs[i - 1 - j];
                    next[i] = gamma;
                    for (int j = 0; j <= i; ++j) coeffs[j] = next[j];
                }
                error *= (1.0 - gamma * gamma);

                int order = i + 1;
                if (order < 5 || order > max_order) continue;
                if (!(n > order)) continue;
                double max_c = 0.0;
                for (int j = 0; j < order; ++j) {
                    double a = std::fabs(coeffs[j]);
                    if (a > max_c) max_c = a;
                }
                bool ok = alive && max_c > 0.0 && std::isfinite(max_c);
                if (!ok) continue;
                double shf = std::floor(std::log2((double)(1 << 30) / max_c));
                int shift = shf < 0 ? 0 : (shf > 15 ? 15 : (int)shf);
                double scale = std::ldexp(1.0, shift);
                Cand& cd = cands[ncand++];
                cd.order = order;
                cd.shift = shift;
                std::memset(cd.cq, 0, sizeof(cd.cq));
                for (int j = 0; j < order; ++j) {
                    double sc = coeffs[j] * scale;
                    double q = (sc >= 0 ? std::floor(sc + 0.5) : -std::floor(-sc + 0.5));
                    if (q > 2147483647.0) q = 2147483647.0;
                    if (q < -2147483648.0) q = -2147483648.0;
                    cd.cq[j] = (int32_t)q;
                }
                double eps = error > 1e-30 ? error : 1e-30;
                cd.pred_bits = 0.5 * (double)n * std::log2(eps) + 32.0 * order;
            }

            // Optional prune: keep the prune_topk smallest predicted sizes
            // (ties break to the LOWER order — candidates are ascending, so
            // the stable scan below does that naturally).
            bool keep[MAX_ORDER];
            for (int c = 0; c < ncand; ++c) keep[c] = true;
            if (prune_topk > 0 && ncand > prune_topk) {
                for (int c = 0; c < ncand; ++c) keep[c] = false;
                for (int pick = 0; pick < prune_topk; ++pick) {
                    int bi = -1;
                    for (int c = 0; c < ncand; ++c)
                        if (!keep[c] && (bi < 0 || cands[c].pred_bits < cands[bi].pred_bits))
                            bi = c;
                    keep[bi] = true;
                }
            }

            // Pass 2: exact residuals + Rice size for survivors, in the
            // reference's ascending evaluation order with strict-<.
            for (int c = 0; c < ncand; ++c) {
                if (!keep[c]) continue;
                const Cand& cd = cands[c];
                int32_t max_wa = lpc_residuals(s, n, cd.cq, cd.order, cd.shift, tmp);
                // encoder.rs:269-271: reject unstable fits (> 1_000_000).
                // A residual of i32::MIN has wrapping-abs i32::MIN < 0 and
                // never raises max_wa — the candidate stays accepted, which
                // matches the reference (its wrapped max behaves the same).
                if (max_wa > 1000000) continue;
                int k = estimate_k(tmp, n);
                int64_t size = rice_size_bytes(tmp, n, k);
                if (size < best_size) {
                    best_size = size;
                    best_kind = 2;
                    best_order = cd.order;
                    best_k = k;
                    best_shift = cd.shift;
                    std::memcpy(best_coeffs, cd.cq, sizeof(best_coeffs));
                    std::memcpy(win_r, tmp, sizeof(int32_t) * (size_t)n);
                    if (n < S)
                        std::memset(win_r + n, 0, sizeof(int32_t) * (size_t)(S - n));
                }
            }
        }

        delete[] tmp;
        sel_kind[l] = best_kind;
        sel_order[l] = best_order;
        k_out[l] = best_k;
        shift_out[l] = best_shift;
        size_out[l] = best_size;
        for (int j = 0; j < MAX_ORDER; ++j) coeffs_out[l * MAX_ORDER + j] = best_coeffs[j];
    }
}

}  // extern "C"
