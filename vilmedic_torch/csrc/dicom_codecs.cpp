// DICOM pixel-data codecs: JPEG Lossless (SOF3) and RLE Lossless.
//
// The port's own copy of native/dicom_codecs.cpp, built with g++ at first
// use by vilmedic_torch/data/dicom_codecs.py into vilmedic_torch/_build/.
// It is the host decode core of the DICOM input path. MIMIC-CXR
// ships JPEG Lossless (transfer syntax 1.2.840.10008.1.2.4.70, SOF3 with
// selection value 1); PACS exports also use RLE (1.2.840.10008.1.2.5).
//
// Exposed C ABI (ctypes, see vilmedic_torch/data/dicom_codecs.py):
//   decode_jpeg_lossless(data, n, out_u16, capacity, &w, &h, &precision, &ncomp)
//   decode_rle_segment(data, n, out_u8, out_capacity) -> decoded byte count
// Both return 0 on success / negative error codes.

#include <cstdint>
#include <cstring>

namespace {

struct HuffTable {
    // JPEG DC-style Huffman table: code lengths 1..16.
    int mincode[17];
    int maxcode[17];
    int valptr[17];
    uint8_t values[256];
    bool present = false;

    void build(const uint8_t* bits /*[16]*/, const uint8_t* vals, int nvals) {
        int code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
            valptr[l] = k;
            mincode[l] = code;
            code += bits[l - 1];
            maxcode[l] = bits[l - 1] ? code - 1 : -1;
            code <<= 1;
            k += bits[l - 1];
        }
        if (nvals > 256) nvals = 256;
        std::memcpy(values, vals, nvals);
        present = true;
    }
};

struct BitReader {
    const uint8_t* data;
    long n;
    long pos = 0;
    uint32_t buf = 0;
    int bits = 0;
    bool marker_hit = false;
    int pending_marker = 0;

    BitReader(const uint8_t* d, long len) : data(d), n(len) {}

    // returns next bit or -1 at end/marker
    int bit() {
        if (bits == 0) {
            if (pos >= n) return -1;
            uint8_t b = data[pos++];
            if (b == 0xFF) {
                if (pos >= n) return -1;
                uint8_t b2 = data[pos++];
                if (b2 == 0x00) {
                    // stuffed byte
                } else {
                    marker_hit = true;
                    pending_marker = b2;
                    pos -= 2;
                    return -1;
                }
            }
            buf = b;
            bits = 8;
        }
        bits--;
        return (buf >> bits) & 1;
    }

    int read(int count) {
        int v = 0;
        for (int i = 0; i < count; ++i) {
            int b = bit();
            if (b < 0) return -1;
            v = (v << 1) | b;
        }
        return v;
    }

    void align() { bits = 0; }
};

int huff_decode(BitReader& br, const HuffTable& t) {
    int code = br.bit();
    if (code < 0) return -1;
    for (int l = 1; l <= 16; ++l) {
        if (t.maxcode[l] >= 0 && code <= t.maxcode[l]) {
            return t.values[t.valptr[l] + (code - t.mincode[l])];
        }
        int b = br.bit();
        if (b < 0) return -1;
        code = (code << 1) | b;
    }
    return -1;
}

inline int extend(int v, int ssss) {
    // JPEG EXTEND: map magnitude bits to signed difference
    if (ssss == 0) return 0;
    if (ssss == 16) return -32768;  // special case: diff = -32768 (mod 2^16)
    if (v < (1 << (ssss - 1))) return v - (1 << ssss) + 1;
    return v;
}

}  // namespace

extern "C" {

// Decode a single-scan SOF3 lossless JPEG. Components are interleaved
// line-by-line per the JPEG spec when ncomp > 1 (medical images: ncomp == 1).
// out must hold width*height*ncomp uint16.
int decode_jpeg_lossless(const uint8_t* data, long n, uint16_t* out,
                         long capacity, int* out_w, int* out_h,
                         int* out_precision, int* out_ncomp) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;  // no SOI
    long p = 2;
    HuffTable tables[4];
    int precision = 0, height = 0, width = 0, ncomp = 0;
    int comp_table[4] = {0, 0, 0, 0};
    int predictor = 1, pt = 0;
    int restart_interval = 0;
    long scan_start = -1;

    while (p + 4 <= n) {
        if (data[p] != 0xFF) return -2;
        int marker = data[p + 1];
        p += 2;
        if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) continue;
        if (marker == 0xD9) break;  // EOI
        if (p + 2 > n) return -3;
        int seglen = (data[p] << 8) | data[p + 1];
        if (p + seglen > n) return -3;
        const uint8_t* seg = data + p + 2;
        int segn = seglen - 2;

        if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB) {  // SOF3/7/11
            precision = seg[0];
            height = (seg[1] << 8) | seg[2];
            width = (seg[3] << 8) | seg[4];
            ncomp = seg[5];
            if (ncomp < 1 || ncomp > 4) return -4;
        } else if (marker == 0xC4) {  // DHT
            int off = 0;
            while (off + 17 <= segn) {
                int tc_th = seg[off];
                int id = tc_th & 0x0F;
                const uint8_t* bits = seg + off + 1;
                int nvals = 0;
                for (int i = 0; i < 16; ++i) nvals += bits[i];
                if (off + 17 + nvals > segn || id > 3) return -5;
                tables[id].build(bits, seg + off + 17, nvals);
                off += 17 + nvals;
            }
        } else if (marker == 0xDD) {  // DRI
            restart_interval = (seg[0] << 8) | seg[1];
        } else if (marker == 0xDA) {  // SOS
            int ns = seg[0];
            if (ns != ncomp) ncomp = ns;
            for (int c = 0; c < ns && c < 4; ++c) {
                comp_table[c] = (seg[1 + 2 * c + 1] >> 4) & 0x0F;
            }
            predictor = seg[1 + 2 * ns];      // Ss = predictor selection
            pt = seg[3 + 2 * ns] & 0x0F;      // Al = point transform
            scan_start = p + seglen;
            break;
        }
        p += seglen;
    }

    if (scan_start < 0 || width <= 0 || height <= 0 || ncomp <= 0) return -6;
    long total = (long)width * height * ncomp;
    if (total > capacity) return -7;
    *out_w = width;
    *out_h = height;
    *out_precision = precision;
    *out_ncomp = ncomp;

    BitReader br(data + scan_start, n - scan_start);
    const int default_pred = 1 << (precision - pt - 1);
    long samples_done = 0;
    long since_restart = 0;
    bool restart_reset = true;  // first line after (re)start uses default pred

    // row-interleaved storage: out[(row*width + col)*ncomp + c]
    for (int row = 0; row < height; ++row) {
        for (int col = 0; col < width; ++col) {
            for (int c = 0; c < ncomp; ++c) {
                const HuffTable& t = tables[comp_table[c]];
                if (!t.present) return -8;
                int ssss = huff_decode(br, t);
                if (ssss < 0) return -9;
                int diff;
                if (ssss == 16) {
                    diff = -32768;
                } else {
                    int vbits = ssss ? br.read(ssss) : 0;
                    if (vbits < 0) return -9;
                    diff = extend(vbits, ssss);
                }
                long idx = ((long)row * width + col) * ncomp + c;
                int pred;
                if (restart_reset && col == 0) {
                    pred = default_pred;
                } else if (row == 0 || restart_reset) {
                    pred = out[idx - ncomp];  // Ra
                } else if (col == 0) {
                    pred = out[idx - (long)width * ncomp];  // Rb
                } else {
                    int ra = out[idx - ncomp];
                    int rb = out[idx - (long)width * ncomp];
                    int rc = out[idx - (long)width * ncomp - ncomp];
                    switch (predictor) {
                        case 1: pred = ra; break;
                        case 2: pred = rb; break;
                        case 3: pred = rc; break;
                        case 4: pred = ra + rb - rc; break;
                        case 5: pred = ra + ((rb - rc) >> 1); break;
                        case 6: pred = rb + ((ra - rc) >> 1); break;
                        case 7: pred = (ra + rb) >> 1; break;
                        default: pred = ra; break;
                    }
                }
                out[idx] = (uint16_t)((pred + diff) & 0xFFFF);
                samples_done++;
                since_restart++;
            }
        }
        restart_reset = false;
        if (restart_interval && since_restart >= (long)restart_interval * ncomp
            && samples_done < total) {
            // skip RSTn marker, realign, reset prediction
            br.align();
            long q = br.pos;
            while (q + 1 < br.n && !(br.data[q] == 0xFF && br.data[q + 1] >= 0xD0
                                     && br.data[q + 1] <= 0xD7)) {
                q++;
            }
            if (q + 1 < br.n) br.pos = q + 2;
            br.marker_hit = false;
            since_restart = 0;
            restart_reset = true;
        }
    }
    if (pt > 0) {
        for (long i = 0; i < total; ++i) out[i] = (uint16_t)(out[i] << pt);
    }
    return 0;
}

// PackBits decode of ONE RLE segment (DICOM PS3.5 G.3.1).
long decode_rle_segment(const uint8_t* data, long n, uint8_t* out,
                        long capacity) {
    long ip = 0, op = 0;
    while (ip < n) {
        int8_t h = (int8_t)data[ip++];
        if (h >= 0) {
            long count = (long)h + 1;
            if (ip + count > n || op + count > capacity) return -1;
            std::memcpy(out + op, data + ip, count);
            ip += count;
            op += count;
        } else if (h != -128) {
            long count = (long)(-h) + 1;
            if (ip >= n || op + count > capacity) return -1;
            std::memset(out + op, data[ip++], count);
            op += count;
        }
    }
    return op;
}

}  // extern "C"
