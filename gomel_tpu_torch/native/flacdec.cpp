// FLAC decoder — native audio-ingest component of gomel_tpu_torch.
//
// Copy of gomel_tpu/native/flacdec.cpp; everything below this header is
// byte-equal to the original (tests/test_torch_host.py pins it). Replaces the
// reference's mewkiz/flac Go decoder (mel/impl.go:266-296,
// phase/impl.go:351-381): full-spec stream decoding (CONSTANT/VERBATIM/FIXED/
// LPC subframes, Rice and Rice2 residual partitions, wasted bits, all stereo
// decorrelation modes). Exposed to Python via ctypes
// (gomel_tpu_torch/io/flac.py), which builds it into build/gomel_tpu_torch/.
//
// Build: g++ -O3 -shared -fPIC -o _flacdec.so flacdec.cpp
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t byte_pos = 0;
    int bit_pos = 0;  // bits consumed in current byte (0..7)
    bool error = false;

    uint64_t bits(int n) {
        uint64_t v = 0;
        while (n > 0) {
            if (byte_pos >= size) { error = true; return 0; }
            int avail = 8 - bit_pos;
            int take = n < avail ? n : avail;
            int shift = avail - take;
            uint32_t mask = (1u << take) - 1u;
            v = (v << take) | ((data[byte_pos] >> shift) & mask);
            bit_pos += take;
            n -= take;
            if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
        }
        return v;
    }

    int64_t sbits(int n) {
        uint64_t v = bits(n);
        if (n == 0) return 0;
        if (v & (1ull << (n - 1))) return (int64_t)(v - (1ull << n));
        return (int64_t)v;
    }

    uint32_t unary() {
        uint32_t q = 0;
        while (!error && bits(1) == 0) ++q;
        return q;
    }

    void align() {
        if (bit_pos != 0) { bit_pos = 0; ++byte_pos; }
    }
};

// Rice residual: zigzag decode
inline int64_t unrice(uint32_t q, uint64_t r, int param) {
    uint64_t v = ((uint64_t)q << param) | r;
    return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
}

struct StreamInfo {
    uint32_t min_block = 0, max_block = 0;
    uint32_t sample_rate = 0;
    uint32_t channels = 0;
    uint32_t bps = 0;
    uint64_t total_samples = 0;
};

bool decode_residual(BitReader& br, int blocksize, int pred_order,
                     int64_t* out /* residuals appended after warmup */) {
    uint32_t method = (uint32_t)br.bits(2);
    if (method > 1) return false;
    int param_bits = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 0xF : 0x1F;
    uint32_t po = (uint32_t)br.bits(4);
    uint32_t partitions = 1u << po;
    if ((blocksize >> po) == 0) return false;
    int idx = pred_order;
    for (uint32_t p = 0; p < partitions; ++p) {
        int count = blocksize >> po;
        if (p == 0) count -= pred_order;
        if (count < 0) return false;
        uint32_t param = (uint32_t)br.bits(param_bits);
        if (param == escape) {
            int raw = (int)br.bits(5);
            for (int i = 0; i < count; ++i) out[idx++] = br.sbits(raw);
        } else {
            for (int i = 0; i < count; ++i) {
                uint32_t q = br.unary();
                uint64_t r = br.bits((int)param);
                out[idx++] = unrice(q, r, (int)param);
            }
        }
        if (br.error) return false;
    }
    return true;
}

bool decode_subframe(BitReader& br, int blocksize, int bps,
                     std::vector<int64_t>& out) {
    out.assign((size_t)blocksize, 0);
    if (br.bits(1) != 0) return false;  // zero padding bit
    uint32_t type = (uint32_t)br.bits(6);
    int wasted = 0;
    if (br.bits(1)) wasted = (int)br.unary() + 1;
    bps -= wasted;
    if (bps <= 0 || br.error) return false;

    if (type == 0) {  // CONSTANT
        int64_t v = br.sbits(bps);
        for (int i = 0; i < blocksize; ++i) out[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < blocksize; ++i) out[i] = br.sbits(bps);
    } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
        int order = type & 0x07;
        if (order > blocksize) return false;
        for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
        if (!decode_residual(br, blocksize, order, out.data())) return false;
        switch (order) {
        case 0: break;
        case 1:
            for (int i = 1; i < blocksize; ++i) out[i] += out[i - 1];
            break;
        case 2:
            for (int i = 2; i < blocksize; ++i)
                out[i] += 2 * out[i - 1] - out[i - 2];
            break;
        case 3:
            for (int i = 3; i < blocksize; ++i)
                out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
            break;
        case 4:
            for (int i = 4; i < blocksize; ++i)
                out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3]
                          - out[i - 4];
            break;
        }
    } else if (type & 0x20) {  // LPC
        int order = (int)(type & 0x1F) + 1;
        if (order > blocksize) return false;
        for (int i = 0; i < order; ++i) out[i] = br.sbits(bps);
        int precision = (int)br.bits(4) + 1;
        if (precision == 16) return false;  // 1111 invalid
        int shift = (int)br.sbits(5);
        if (shift < 0) return false;
        int32_t coef[32];
        for (int i = 0; i < order; ++i) coef[i] = (int32_t)br.sbits(precision);
        if (!decode_residual(br, blocksize, order, out.data())) return false;
        for (int i = order; i < blocksize; ++i) {
            int64_t acc = 0;
            for (int j = 0; j < order; ++j) acc += (int64_t)coef[j] * out[i - 1 - j];
            out[i] += acc >> shift;
        }
    } else {
        return false;  // reserved
    }
    if (wasted > 0)
        for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
    return !br.error;
}

// returns decoded blocksize, -1 on a corrupt frame (caller may resync past
// *sync_pos), or -2 at end of stream (no further sync word)
int decode_frame(BitReader& br, const StreamInfo& si,
                 std::vector<std::vector<int64_t>>& chans,
                 size_t* sync_pos) {
    // find sync
    br.align();
    br.error = false;
    while (br.byte_pos + 1 < br.size) {
        if (br.data[br.byte_pos] == 0xFF &&
            (br.data[br.byte_pos + 1] & 0xFC) == 0xF8)
            break;
        ++br.byte_pos;
    }
    if (br.byte_pos + 4 >= br.size) return -2;
    *sync_pos = br.byte_pos;
    br.bits(14);            // sync
    br.bits(1);             // reserved
    br.bits(1);             // blocking strategy
    uint32_t bs_code = (uint32_t)br.bits(4);
    uint32_t sr_code = (uint32_t)br.bits(4);
    uint32_t ch_code = (uint32_t)br.bits(4);
    uint32_t ss_code = (uint32_t)br.bits(3);
    br.bits(1);             // reserved
    // UTF-8 coded frame/sample number
    uint32_t b0 = (uint32_t)br.bits(8);
    int follow = 0;
    if (b0 >= 0xFE) follow = 6;
    else if (b0 >= 0xFC) follow = 5;
    else if (b0 >= 0xF8) follow = 4;
    else if (b0 >= 0xF0) follow = 3;
    else if (b0 >= 0xE0) follow = 2;
    else if (b0 >= 0xC0) follow = 1;
    for (int i = 0; i < follow; ++i) br.bits(8);

    int blocksize;
    switch (bs_code) {
    case 0: return -1;
    case 1: blocksize = 192; break;
    case 6: blocksize = (int)br.bits(8) + 1; break;
    case 7: blocksize = (int)br.bits(16) + 1; break;
    default:
        blocksize = bs_code <= 5 ? (576 << (bs_code - 2))
                                 : (256 << (bs_code - 8));
    }
    switch (sr_code) {
    case 12: br.bits(8); break;
    case 13: case 14: br.bits(16); break;
    case 15: return -1;
    default: break;
    }
    int bps;
    switch (ss_code) {
    case 0: bps = (int)si.bps; break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
    }
    br.bits(8);  // header CRC-8 (not verified; tolerant decode)
    if (br.error) return -1;

    int nch;
    if (ch_code < 8) nch = (int)ch_code + 1;
    else if (ch_code <= 10) nch = 2;
    else return -1;
    if ((uint32_t)nch != si.channels && si.channels != 0) {
        // tolerate, use frame's channel count
    }

    chans.assign((size_t)nch, {});
    for (int c = 0; c < nch; ++c) {
        int ch_bps = bps;
        if ((ch_code == 8 && c == 1) ||   // left/side
            (ch_code == 9 && c == 0) ||   // right/side
            (ch_code == 10 && c == 1))    // mid/side
            ch_bps += 1;
        if (!decode_subframe(br, blocksize, ch_bps, chans[(size_t)c]))
            return -1;
    }
    br.align();
    br.bits(16);  // frame CRC-16 (not verified)
    if (br.error) return -1;

    // stereo decorrelation
    if (ch_code == 8) {        // left/side: right = left - side
        for (int i = 0; i < blocksize; ++i)
            chans[1][(size_t)i] = chans[0][(size_t)i] - chans[1][(size_t)i];
    } else if (ch_code == 9) { // right/side: left = right + side
        for (int i = 0; i < blocksize; ++i) {
            int64_t side = chans[0][(size_t)i];
            chans[0][(size_t)i] = chans[1][(size_t)i] + side;
        }
    } else if (ch_code == 10) { // mid/side
        for (int i = 0; i < blocksize; ++i) {
            int64_t mid = chans[0][(size_t)i];
            int64_t side = chans[1][(size_t)i];
            mid = (mid << 1) | (side & 1);
            chans[0][(size_t)i] = (mid + side) >> 1;
            chans[1][(size_t)i] = (mid - side) >> 1;
        }
    }
    return blocksize;
}

}  // namespace

extern "C" {

// Decode a whole FLAC stream from memory.
// layout 0: sample-interleaved [n][ch]. layout 1: Go mewkiz-iteration order —
// per frame, each channel's samples concatenated (reference loadflac loops
// subframes appending all samples, phase/impl.go:373-378 with the per-channel
// break commented out); *channels is reported as 1 and *n_samples is the
// total concatenated length.
// On success returns 0; caller frees *out with flac_free.
// max_total_samples: decompression-bomb ceiling (total samples across
// channels); <= 0 selects the default 2^31 (~6 h of 48 kHz stereo).
int flac_decode(const uint8_t* buf, long len, int layout,
                int32_t** out, long* n_samples,
                int* channels, int* sample_rate, int* bps,
                long max_total_samples) {
    if (len < 8 || memcmp(buf, "fLaC", 4) != 0) return -1;
    size_t pos = 4;
    StreamInfo si;
    bool last = false;
    while (!last) {
        if (pos + 4 > (size_t)len) return -2;
        uint8_t hdr = buf[pos];
        last = (hdr & 0x80) != 0;
        uint8_t type = hdr & 0x7F;
        uint32_t blen = ((uint32_t)buf[pos + 1] << 16) |
                        ((uint32_t)buf[pos + 2] << 8) | buf[pos + 3];
        pos += 4;
        if (pos + blen > (size_t)len) return -2;
        if (type == 0 && blen >= 34) {  // STREAMINFO
            const uint8_t* p = buf + pos;
            si.min_block = ((uint32_t)p[0] << 8) | p[1];
            si.max_block = ((uint32_t)p[2] << 8) | p[3];
            si.sample_rate = ((uint32_t)p[10] << 12) | ((uint32_t)p[11] << 4) |
                             (p[12] >> 4);
            si.channels = ((p[12] >> 1) & 0x7) + 1;
            si.bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
            si.total_samples = ((uint64_t)(p[13] & 0x0F) << 32) |
                               ((uint64_t)p[14] << 24) | ((uint64_t)p[15] << 16) |
                               ((uint64_t)p[16] << 8) | p[17];
        }
        pos += blen;
    }
    if (si.sample_rate == 0) return -3;

    BitReader br{buf, (size_t)len};
    br.byte_pos = pos;

    std::vector<int32_t> pcm;
    // reserve only when the declared size is plausible for the stream length
    // (attacker-controlled STREAMINFO must not drive a throwing allocation);
    // the reserve itself sits in a try so an allocation failure surfaces as
    // -6 instead of a bad_alloc escaping the extern "C" boundary, and is
    // capped at 2^28 samples (1 GiB) — it is only a growth optimization,
    // larger legitimate streams just reallocate as they decode.
    if (si.total_samples) {
        uint64_t want = si.total_samples * (uint64_t)si.channels;
        if (want <= (uint64_t)len * 8 && want < (1ull << 28)) {
            try {
                pcm.reserve((size_t)want);
            } catch (const std::bad_alloc&) {
                return -6;
            }
        }
    }
    // Decompression-bomb bound: actual growth (not just the reserve) must
    // stay plausible. When STREAMINFO declares a length, allow it plus one
    // max-size block of slack per channel; otherwise allow the extreme
    // legitimate expansion of an all-CONSTANT (silence) stream —
    // ~15 input bytes per 65536-sample mono frame, i.e. < 8192 samples per
    // input byte — with a small-file floor. A crafted stream exceeding the
    // bound fails with -7 instead of growing without limit, and any
    // allocation failure surfaces as -6 via the catch below rather than
    // std::terminate across the extern "C" boundary.
    uint64_t bomb_cap;
    if (si.total_samples)
        bomb_cap = (si.total_samples + 65536ull) * (uint64_t)(si.channels ? si.channels : 8);
    else
        bomb_cap = (uint64_t)len * 8192ull + (1ull << 20);
    // Hard cap: caller-configurable so multi-hour archives can raise it;
    // the 2^31 default (~6 h of 48 kHz stereo) keeps a crafted stream from
    // driving tens of GiB of growth on overcommit Linux.
    uint64_t hard_cap = max_total_samples > 0
        ? (uint64_t)max_total_samples : (1ull << 31);
    if (bomb_cap > hard_cap) bomb_cap = hard_cap;

    std::vector<std::vector<int64_t>> chans;
    int nch_out = 0;
    try {
        while (true) {
            size_t sync_pos = 0;
            int bs = decode_frame(br, si, chans, &sync_pos);
            if (bs == -2) break;          // end of stream
            if (bs <= 0) {                // corrupt frame: resync past this sync
                br.byte_pos = sync_pos + 1;
                br.bit_pos = 0;
                br.error = false;
                continue;
            }
            int nch = (int)chans.size();
            if (nch_out == 0) nch_out = nch;
            if (pcm.size() + (uint64_t)nch * (uint64_t)bs > bomb_cap)
                return -7;                // decompression bomb
            if (layout == 1) {
                for (int c = 0; c < nch; ++c)
                    for (int i = 0; i < bs; ++i)
                        pcm.push_back((int32_t)chans[(size_t)c][(size_t)i]);
            } else {
                for (int i = 0; i < bs; ++i)
                    for (int c = 0; c < nch; ++c)
                        pcm.push_back((int32_t)chans[(size_t)c][(size_t)i]);
            }
        }
    } catch (const std::exception&) {
        return -6;                        // allocation (or other) failure
    }
    if (pcm.empty()) return -4;

    int nch = nch_out ? nch_out : (int)si.channels;
    long total;
    if (layout == 1) {
        nch = 1;                       // Go treats the concat as one stream
        total = (long)pcm.size();
    } else {
        total = (long)(pcm.size() / (size_t)nch);
        // trim to declared total (last block may be short-padded)
        if (si.total_samples && (long)si.total_samples < total)
            total = (long)si.total_samples;
    }
    int32_t* res = (int32_t*)malloc(sizeof(int32_t) * (size_t)total * (size_t)nch);
    if (!res) return -5;
    memcpy(res, pcm.data(), sizeof(int32_t) * (size_t)total * (size_t)nch);
    *out = res;
    *n_samples = total;
    *channels = nch;
    *sample_rate = (int)si.sample_rate;
    *bps = (int)si.bps;
    return 0;
}

void flac_free(int32_t* p) { free(p); }

}  // extern "C"
