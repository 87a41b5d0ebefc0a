// Native Rice bitstream finalizer.
//
// The device produces residual tensors + exact Rice parameters; the serial
// bit-level pack/unpack is the host-side hot path (the native equivalent of
// the reference's rice.rs:94-159 bit loops). Streams are independent, so
// both directions parallelize over streams with OpenMP.
//
// Wire format (rice.rs:94-159):
//   zigzag u = (s << 1) ^ (s >> 31)
//   code    = min(u >> k, 255) unary '1' bits, '0' terminator, k low bits
//             of u MSB-first; final partial byte zero-padded.
//   decode  reads exactly target_len codes; past the end of the buffer every
//           bit reads as 0 (zero-fill semantics).
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC rice.cpp -o librice.so

#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
    uint8_t* out;
    int64_t byte_pos = 0;
    uint64_t acc = 0;   // bits accumulate in the high end
    int nbits = 0;

    explicit BitWriter(uint8_t* o) : out(o) {}

    inline void put(uint64_t value, int width) {
        // value's low `width` bits, MSB-first.
        acc |= value << (64 - nbits - width);
        nbits += width;
        while (nbits >= 8) {
            out[byte_pos++] = static_cast<uint8_t>(acc >> 56);
            acc <<= 8;
            nbits -= 8;
        }
    }

    inline void put_ones(int count) {
        while (count >= 32) {
            put(0xFFFFFFFFu, 32);
            count -= 32;
        }
        if (count > 0) put((1u << count) - 1u, count);
    }

    inline void flush() {
        if (nbits > 0) {
            out[byte_pos++] = static_cast<uint8_t>(acc >> 56);
            acc = 0;
            nbits = 0;
        }
    }
};

struct BitReader {
    const uint8_t* in;
    int64_t total_bits;
    int64_t pos = 0;

    BitReader(const uint8_t* i, int64_t nbytes) : in(i), total_bits(nbytes * 8) {}

    inline int read_bit() {
        if (pos >= total_bits) {
            ++pos;
            return 0;
        }
        int bit = (in[pos >> 3] >> (7 - (pos & 7))) & 1;
        ++pos;
        return bit;
    }

    inline uint32_t read_bits(int width) {
        uint32_t v = 0;
        for (int i = 0; i < width; ++i) v = (v << 1) | static_cast<uint32_t>(read_bit());
        return v;
    }
};

inline uint32_t zigzag(int32_t s) {
    return (static_cast<uint32_t>(s) << 1) ^ static_cast<uint32_t>(s >> 31);
}

}  // namespace

extern "C" {

// Phase 1: exact encoded byte size per stream.
void rice_sizes(const int32_t* rows, int64_t n_streams, int64_t row_stride,
                const int64_t* lengths, const int32_t* ks, int64_t* sizes_out) {
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t i = 0; i < n_streams; ++i) {
        const int32_t* r = rows + i * row_stride;
        const uint32_t k = static_cast<uint32_t>(ks[i]);
        int64_t bits = 0;
        const int64_t n = lengths[i];
        for (int64_t j = 0; j < n; ++j) {
            uint32_t q = zigzag(r[j]) >> k;
            bits += (q > 255 ? 255 : q) + 1 + k;
        }
        sizes_out[i] = (bits + 7) >> 3;
    }
}

// Phase 2: pack every stream at its byte offset.
void rice_encode_batch(const int32_t* rows, int64_t n_streams, int64_t row_stride,
                       const int64_t* lengths, const int32_t* ks,
                       const int64_t* byte_off, uint8_t* out) {
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t i = 0; i < n_streams; ++i) {
        const int32_t* r = rows + i * row_stride;
        const uint32_t k = static_cast<uint32_t>(ks[i]);
        const uint32_t mask = k ? ((1u << k) - 1u) : 0u;
        BitWriter w(out + byte_off[i]);
        const int64_t n = lengths[i];
        for (int64_t j = 0; j < n; ++j) {
            uint32_t u = zigzag(r[j]);
            uint32_t q = u >> k;
            if (q > 255) q = 255;
            w.put_ones(static_cast<int>(q));
            w.put(0, 1);
            if (k) w.put(u & mask, static_cast<int>(k));
        }
        w.flush();
    }
}

// Decode each stream's target_len codes into out rows (zero-filled past EOF).
void rice_decode_batch(const uint8_t* blob, const int64_t* offsets,
                       const int64_t* blob_lens, const int32_t* ks,
                       const int64_t* lengths, int64_t n_streams,
                       int64_t out_width, int32_t* out) {
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t i = 0; i < n_streams; ++i) {
        BitReader rd(blob + offsets[i], blob_lens[i]);
        const int k = static_cast<int>(ks[i]);
        int32_t* dst = out + i * out_width;
        const int64_t n = lengths[i];
        for (int64_t j = 0; j < n; ++j) {
            if (rd.pos >= rd.total_bits) break;  // rest stays zero
            uint32_t q = 0;
            while (rd.read_bit() == 1) ++q;
            uint32_t rem = k ? rd.read_bits(k) : 0u;
            uint32_t u = (q << k) | rem;
            dst[j] = static_cast<int32_t>(u >> 1) ^ -static_cast<int32_t>(u & 1u);
        }
    }
}

// LPC / fixed-predictor reconstruction, in place over residual rows
// (decoder.rs:92-273 semantics): s[i] = r[i] + ((Σ_j c_eff[j]·s[i-1-j]) >> shift)
// with int32 wrapping add; warm-up (i < order) uses the ramped fixed
// predictor FIXED[min(i,4)] on fixed lanes and zero coefficients (residual
// verbatim) on LPC lanes. Coefficient stride is 12 (ops/lpc.MAX_ORDER).
// This is the host half of the streaming / seeking single-frame decode path,
// where a per-frame device round trip would be pure latency.
void lpc_reconstruct_batch(int32_t* rows, int64_t n_lanes, int64_t stride,
                           const int32_t* coeffs, const int32_t* shifts,
                           const int32_t* orders, const uint8_t* is_fixed,
                           const int64_t* lengths) {
    static const int32_t FIXED[5][12] = {
        {0}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1},
    };
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t l = 0; l < n_lanes; ++l) {
        int32_t* r = rows + l * stride;
        const int32_t* c = coeffs + l * 12;
        const int shift = shifts[l];
        const int32_t order = orders[l];
        const bool fx = is_fixed[l] != 0;
        const int64_t n = lengths[l];
        int64_t carry[12] = {0};
        for (int64_t i = 0; i < n; ++i) {
            const int32_t* ce =
                (i < order) ? (fx ? FIXED[i < 4 ? i : 4] : nullptr) : c;
            int64_t acc = 0;
            if (ce)
                for (int j = 0; j < 12; ++j)
                    acc += static_cast<int64_t>(ce[j]) * carry[j];
            const int32_t s = static_cast<int32_t>(
                static_cast<uint32_t>(acc >> shift) +
                static_cast<uint32_t>(r[i]));
            r[i] = s;
            for (int j = 11; j > 0; --j) carry[j] = carry[j - 1];
            carry[0] = s;
        }
    }
}

}  // extern "C"
