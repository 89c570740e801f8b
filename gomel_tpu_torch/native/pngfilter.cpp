// PNG scanline unfilter and Up filter — native host helper of gomel_tpu_torch.
//
// Copy of gomel_tpu/native/pngfilter.cpp; everything below this header is
// byte-equal to the original (tests/test_torch_host.py pins it). The port's
// PNG codec (gomel_tpu_torch/io/pngcodec.py) inflates and deflates with
// Python's zlib and runs the per-scanline loops here: the unfilter of all
// five filter types (None, Sub, Up, Average, Paeth) on read, the Up filter
// on write. Exposed to Python via ctypes (gomel_tpu_torch/io/_native.py),
// which builds it into build/gomel_tpu_torch/native/.
//
// Build: g++ -O3 -shared -fPIC -o _pngfilter.so pngfilter.cpp
#include <cstdint>
#include <cstring>

extern "C" {

// raw: height * (1 + rowbytes) bytes (filter byte + scanline data per row)
// out: height * rowbytes bytes (unfiltered)
// bpp: bytes per complete pixel (filter unit)
// returns 0 on success, -1 on invalid filter type
int png_unfilter(const uint8_t* raw, uint8_t* out,
                 long height, long rowbytes, int bpp) {
    for (long y = 0; y < height; ++y) {
        const uint8_t* src = raw + y * (rowbytes + 1);
        uint8_t ft = src[0];
        ++src;
        uint8_t* cur = out + y * rowbytes;
        const uint8_t* up = (y > 0) ? out + (y - 1) * rowbytes : nullptr;
        switch (ft) {
        case 0:  // None
            std::memcpy(cur, src, rowbytes);
            break;
        case 1:  // Sub
            for (long x = 0; x < bpp; ++x) cur[x] = src[x];
            for (long x = bpp; x < rowbytes; ++x)
                cur[x] = (uint8_t)(src[x] + cur[x - bpp]);
            break;
        case 2:  // Up
            if (up) {
                for (long x = 0; x < rowbytes; ++x)
                    cur[x] = (uint8_t)(src[x] + up[x]);
            } else {
                std::memcpy(cur, src, rowbytes);
            }
            break;
        case 3:  // Average
            for (long x = 0; x < rowbytes; ++x) {
                int a = (x >= bpp) ? cur[x - bpp] : 0;
                int b = up ? up[x] : 0;
                cur[x] = (uint8_t)(src[x] + ((a + b) >> 1));
            }
            break;
        case 4:  // Paeth
            for (long x = 0; x < rowbytes; ++x) {
                int a = (x >= bpp) ? cur[x - bpp] : 0;
                int b = up ? up[x] : 0;
                int c = (up && x >= bpp) ? up[x - bpp] : 0;
                int p = a + b - c;
                int pa = p > a ? p - a : a - p;
                int pb = p > b ? p - b : b - p;
                int pc = p > c ? p - c : c - p;
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                cur[x] = (uint8_t)(src[x] + pred);
            }
            break;
        default:
            return -1;
        }
    }
    return 0;
}

// Paeth/adaptive filtering for the encoder: apply filter type 2 (Up) to all
// rows — cheap and compresses well for spectrogram images (smooth in time).
// raw layout produced: height * (1 + rowbytes).
void png_filter_up(const uint8_t* img, uint8_t* raw,
                   long height, long rowbytes) {
    for (long y = 0; y < height; ++y) {
        uint8_t* dst = raw + y * (rowbytes + 1);
        const uint8_t* cur = img + y * rowbytes;
        if (y == 0) {
            dst[0] = 0;
            std::memcpy(dst + 1, cur, rowbytes);
        } else {
            const uint8_t* up = img + (y - 1) * rowbytes;
            dst[0] = 2;
            for (long x = 0; x < rowbytes; ++x)
                dst[1 + x] = (uint8_t)(cur[x] - up[x]);
        }
    }
}

}  // extern "C"
