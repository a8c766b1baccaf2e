// Native host codec for imagestitching: libjpeg-turbo + libpng/zlib
// (+ optional libdeflate fast paths and libwebp decode).
//
// Native replacement for the image decode/encode the reference delegates
// to the WeChat runtime's C++ engine (SURVEY.md §2b): decode fires on
// `img.src = path` (utils/canvas.js:110) and PNG export on
// `wx.canvasToTempFilePath` (utils/canvas.js:205-242).  Here the same work is
// an explicit C ABI consumed from Python via ctypes; calls release the GIL,
// so the decode thread pool gets real parallelism (the reference had to
// *serialize* decodes to survive, pages/index/index.js:1125-1157 — a real
// allocator and real threads make that unnecessary).
//
// Contract notes:
//  * all decoders output tightly-packed RGB8 (w*h*3);
//  * PNG alpha is pre-composited onto opaque white with round-half-up,
//    matching core/oracle.to_uint8 (the draw loop always targets the white
//    canvas, index.js:1423-1424);
//  * JPEG decode supports DCT-domain scale_denom in {1,2,4,8} — the
//    downscale-on-decode analog of the reference's bitmap pixel budgets
//    (index.js:6-7);
//  * buffers are malloc'd here and released with isx_free.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <zlib.h>

#ifdef ISX_HAVE_LIBDEFLATE
#include <libdeflate.h>
#endif

#ifdef ISX_HAVE_WEBP
#include <webp/decode.h>
#endif

extern "C" {

// ---------------------------------------------------------------- errors

static thread_local char g_err[256];

const char* isx_last_error() { return g_err; }

static void set_err(const char* msg) {
    std::snprintf(g_err, sizeof(g_err), "%s", msg);
}

void isx_free(void* p) { std::free(p); }

// ------------------------------------------------ decompression bombs
//
// A few-KB compressed file (JPEG/PNG/GIF/WEBP all allow it) can declare
// huge dimensions and expand to GBs of RGB.  Above Pillow's
// DecompressionBombError threshold (2x MAX_IMAGE_PIXELS = 178,956,970 px)
// every native decoder refuses, so the Pillow ladder's own bomb policy
// (warn/raise, user-configurable) governs — the pre-native behavior.
static bool exceeds_pixel_limit(uint64_t w, uint64_t h) {
    return w * h > 178956970ULL;
}

// ---------------------------------------------------------------- JPEG

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
    char buf[JMSG_LENGTH_MAX];
    (*cinfo->err->format_message)(cinfo, buf);
    set_err(buf);
    longjmp(e->jump, 1);
}

// Decode JPEG bytes to RGB8. scale_denom in {1,2,4,8}.
// Returns 0 on success; *out is malloc'd (w*h*3).
int isx_decode_jpeg(const uint8_t* data, size_t len, int scale_denom,
                    uint8_t** out, int* out_w, int* out_h) {
    *out = nullptr;
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    uint8_t* buf = nullptr;
    if (setjmp(jerr.jump)) {
        std::free(buf);
        jpeg_destroy_decompress(&cinfo);
        return 1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
                 static_cast<unsigned long>(len));
    jpeg_read_header(&cinfo, TRUE);
    if (exceeds_pixel_limit(cinfo.image_width, cinfo.image_height)) {
        set_err("jpeg: exceeds pixel limit");
        longjmp(jerr.jump, 1);
    }
    cinfo.out_color_space = JCS_RGB;
    if (scale_denom == 2 || scale_denom == 4 || scale_denom == 8) {
        cinfo.scale_num = 1;
        cinfo.scale_denom = static_cast<unsigned>(scale_denom);
    }
    jpeg_start_decompress(&cinfo);
    const int w = static_cast<int>(cinfo.output_width);
    const int h = static_cast<int>(cinfo.output_height);
    const size_t stride = static_cast<size_t>(w) * 3;
    buf = static_cast<uint8_t*>(std::malloc(stride * h));
    if (!buf) { set_err("oom"); longjmp(jerr.jump, 1); }
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* rows[8];
        int n = 0;
        for (; n < 8 && cinfo.output_scanline + n < cinfo.output_height; ++n)
            rows[n] = buf + (cinfo.output_scanline + n) * stride;
        jpeg_read_scanlines(&cinfo, rows, n);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    *out = buf;
    *out_w = w;
    *out_h = h;
    return 0;
}

// Encode RGB8 to JPEG bytes (quality 1..100).
int isx_encode_jpeg(const uint8_t* rgb, int w, int h, int quality,
                    uint8_t** out, size_t* out_len) {
    *out = nullptr;
    jpeg_compress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    unsigned char* mem = nullptr;
    unsigned long mem_len = 0;
    if (setjmp(jerr.jump)) {
        std::free(mem);
        jpeg_destroy_compress(&cinfo);
        return 1;
    }
    jpeg_create_compress(&cinfo);
    jpeg_mem_dest(&cinfo, &mem, &mem_len);
    cinfo.image_width = static_cast<JDIMENSION>(w);
    cinfo.image_height = static_cast<JDIMENSION>(h);
    cinfo.input_components = 3;
    cinfo.in_color_space = JCS_RGB;
    jpeg_set_defaults(&cinfo);
    jpeg_set_quality(&cinfo, quality, TRUE);
    jpeg_start_compress(&cinfo, TRUE);
    const size_t stride = static_cast<size_t>(w) * 3;
    while (cinfo.next_scanline < cinfo.image_height) {
        JSAMPROW row = const_cast<uint8_t*>(rgb)
                       + cinfo.next_scanline * stride;
        jpeg_write_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_compress(&cinfo);
    jpeg_destroy_compress(&cinfo);
    *out = mem;          // libjpeg mem dest uses malloc; freed by isx_free
    *out_len = mem_len;
    return 0;
}

// ---------------------------------------------------------------- PNG

struct PngReadCtx {
    const uint8_t* data;
    size_t len;
    size_t pos;
};

static void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
    PngReadCtx* ctx = static_cast<PngReadCtx*>(png_get_io_ptr(png));
    if (ctx->pos + n > ctx->len) {
        png_error(png, "png: truncated input");
        return;
    }
    std::memcpy(out, ctx->data + ctx->pos, n);
    ctx->pos += n;
}

// composite one pixel on opaque white with round-half-up — matches
// core/oracle.to_uint8 (the reference always draws onto the white canvas,
// index.js:1423-1424)
static inline void composite_white(const uint8_t* px, unsigned a,
                                   uint8_t* dst) {
    if (a == 255) {
        dst[0] = px[0]; dst[1] = px[1]; dst[2] = px[2];
    } else {
        const unsigned ia = 255 - a;
        for (int c = 0; c < 3; ++c) {
            const unsigned v = px[c] * a + 255u * ia;
            dst[c] = static_cast<uint8_t>((2 * v + 255) / (2 * 255));
        }
    }
}

#ifdef ISX_HAVE_LIBDEFLATE

// ------------------------------------------- PNG (fast decode path)
//
// libpng inflates row-by-row through a callback pipeline; for big images
// the per-row bookkeeping and the zlib inflate dominate.  This path parses
// the container directly, inflates ALL the IDAT bytes in one libdeflate
// call (SIMD match copy), defilters in place, and converts to
// white-composited RGB8.  Handles the common shapes (8-bit gray / gray+A /
// RGB / RGBA / palette, non-interlaced); anything else returns -1 and the
// caller falls back to libpng.  Output is pixel-identical to the libpng
// path (same expand + composite math).

static inline uint8_t paeth(int a, int b, int c) {
    // branchless: photographic rows make the classic if-chain mispredict
    // constantly (measured 120 -> 275 MB/s scalar on this host)
    const int p = a + b - c;
    const int pa = p > a ? p - a : a - p;
    const int pb = p > b ? p - b : b - p;
    const int pc = p > c ? p - c : c - p;
    const int use_a = (pa <= pb) & (pa <= pc);
    const int use_b = (!use_a) & (pb <= pc);
    return static_cast<uint8_t>(use_a * a + use_b * b
                                + (1 - use_a - use_b) * c);
}

#ifdef __SSE4_1__
#include <smmintrin.h>

// One pixel (bpp 3 or 4) loaded into the low i16 lanes of a vector.
static inline __m128i pixel_load_epi16(const uint8_t* p, size_t i, int bpp) {
    uint32_t raw;
    if (bpp == 4) {
        std::memcpy(&raw, p + i, 4);
    } else {
        raw = p[i] | (p[i + 1] << 8) | (p[i + 2] << 16);
    }
    return _mm_cvtepu8_epi16(_mm_cvtsi32_si128(static_cast<int>(raw)));
}

// Store the low i16 lanes (already masked to 0..255) back as bytes.
static inline void pixel_store_epi16(uint8_t* p, size_t i, int bpp,
                                     __m128i v) {
    const uint32_t packed = static_cast<uint32_t>(
        _mm_cvtsi128_si32(_mm_packus_epi16(v, v)));
    if (bpp == 4) {
        std::memcpy(p + i, &packed, 4);
    } else {
        p[i] = static_cast<uint8_t>(packed);
        p[i + 1] = static_cast<uint8_t>(packed >> 8);
        p[i + 2] = static_cast<uint8_t>(packed >> 16);
    }
}

// Per-pixel SIMD Paeth for bpp 3/4: the pixel's channels ride the vector
// lanes (widened to i16) while the left-neighbor dependency stays serial —
// measured 450 MB/s vs 120 branchy / 275 branchless scalar on this host.
// Bit-exact vs the scalar form (same integer math).
static void paeth_row_simd(uint8_t* p, const uint8_t* prev, size_t stride,
                           int bpp) {
    __m128i a = _mm_setzero_si128();       // left, reconstructed
    __m128i c = _mm_setzero_si128();       // upper-left
    const __m128i one = _mm_set1_epi16(1);
    const __m128i m255 = _mm_set1_epi16(255);
    for (size_t i = 0; i < stride; i += bpp) {
        const __m128i b = prev ? pixel_load_epi16(prev, i, bpp)
                               : _mm_setzero_si128();
        const __m128i x = pixel_load_epi16(p, i, bpp);
        const __m128i pv = _mm_sub_epi16(_mm_add_epi16(a, b), c);
        const __m128i pa = _mm_abs_epi16(_mm_sub_epi16(pv, a));
        const __m128i pb = _mm_abs_epi16(_mm_sub_epi16(pv, b));
        const __m128i pc = _mm_abs_epi16(_mm_sub_epi16(pv, c));
        const __m128i use_a = _mm_and_si128(
            _mm_cmplt_epi16(pa, _mm_add_epi16(pb, one)),
            _mm_cmplt_epi16(pa, _mm_add_epi16(pc, one)));
        const __m128i use_b = _mm_andnot_si128(
            use_a, _mm_cmplt_epi16(pb, _mm_add_epi16(pc, one)));
        const __m128i pred = _mm_blendv_epi8(
            _mm_blendv_epi8(c, b, use_b), a, use_a);
        const __m128i out = _mm_and_si128(_mm_add_epi16(x, pred), m255);
        pixel_store_epi16(p, i, bpp, out);
        c = b;
        a = out;
    }
}

// Per-pixel SIMD Average defilter, same lane layout as paeth_row_simd.
static void avg_row_simd(uint8_t* p, const uint8_t* prev, size_t stride,
                         int bpp) {
    __m128i a = _mm_setzero_si128();       // left, reconstructed
    const __m128i m255 = _mm_set1_epi16(255);
    for (size_t i = 0; i < stride; i += bpp) {
        const __m128i b = prev ? pixel_load_epi16(prev, i, bpp)
                               : _mm_setzero_si128();
        const __m128i x = pixel_load_epi16(p, i, bpp);
        const __m128i out = _mm_and_si128(
            _mm_add_epi16(x, _mm_srli_epi16(_mm_add_epi16(a, b), 1)), m255);
        pixel_store_epi16(p, i, bpp, out);
        a = out;
    }
}
#endif  // __SSE4_1__

// Reverse the per-row filters in place.  `buf` holds h rows of
// (1 filter byte + stride); returns false on an invalid filter id.
static bool png_defilter(uint8_t* buf, int h, size_t stride, int bpp) {
    const uint8_t* prev = nullptr;
    for (int y = 0; y < h; ++y) {
        uint8_t* row = buf + y * (stride + 1);
        const int f = row[0];
        uint8_t* p = row + 1;
        switch (f) {
        case 0:
            break;
        case 1:
            for (size_t i = bpp; i < stride; ++i)
                p[i] = static_cast<uint8_t>(p[i] + p[i - bpp]);
            break;
        case 2:
            if (prev)
                for (size_t i = 0; i < stride; ++i)
                    p[i] = static_cast<uint8_t>(p[i] + prev[i]);
            break;
        case 3:
#ifdef __SSE4_1__
            if (bpp == 3 || bpp == 4) {
                avg_row_simd(p, prev, stride, bpp);
                break;
            }
#endif
            for (size_t i = 0; i < stride; ++i) {
                const int left = i >= static_cast<size_t>(bpp) ? p[i - bpp]
                                                               : 0;
                const int up = prev ? prev[i] : 0;
                p[i] = static_cast<uint8_t>(p[i] + ((left + up) >> 1));
            }
            break;
        case 4:
#ifdef __SSE4_1__
            if (bpp == 3 || bpp == 4) {
                paeth_row_simd(p, prev, stride, bpp);
                break;
            }
#endif
            for (size_t i = 0; i < stride; ++i) {
                const int left = i >= static_cast<size_t>(bpp) ? p[i - bpp]
                                                               : 0;
                const int up = prev ? prev[i] : 0;
                const int ul = (prev && i >= static_cast<size_t>(bpp))
                               ? prev[i - bpp] : 0;
                p[i] = static_cast<uint8_t>(p[i] + paeth(left, up, ul));
            }
            break;
        default:
            return false;
        }
        prev = p;
    }
    return true;
}

static uint32_t get_be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

// Returns 0 on success, -1 when the file shape needs the libpng path
// (caller falls back silently), 1 on hard error (isx_last_error set).
static int decode_png_fast(const uint8_t* data, size_t len,
                           uint8_t** out, int* out_w, int* out_h) {
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (len < 45 || std::memcmp(data, sig, 8) != 0) return -1;
    // IHDR must be first
    if (get_be32(data + 8) != 13 || std::memcmp(data + 12, "IHDR", 4) != 0)
        return -1;
    const uint32_t w = get_be32(data + 16);
    const uint32_t h = get_be32(data + 20);
    const int depth = data[24], ctype = data[25], interlace = data[28];
    // IHDR CRC: a corrupt header must fall to libpng's hard error, not
    // silently decode garbage geometry
    if (libdeflate_crc32(0, data + 12, 17) != get_be32(data + 29)) return -1;
    if (depth != 8 || interlace != 0) return -1;
    int channels;
    switch (ctype) {
    case 0: channels = 1; break;       // gray
    case 2: channels = 3; break;       // rgb
    case 3: channels = 1; break;       // palette index
    case 4: channels = 2; break;       // gray+alpha
    case 6: channels = 4; break;       // rgba
    default: return -1;
    }
    if (w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24)) return -1;
    if (exceeds_pixel_limit(w, h)) {
        set_err("png: exceeds pixel limit");
        return 1;
    }

    // walk chunks: total IDAT size, palette, transparency
    uint8_t pal[256][3];
    uint8_t pal_a[256];
    int pal_n = 0;
    bool have_trns = false;
    bool saw_iend = false;
    bool saw_idat = false;
    std::memset(pal_a, 0xFF, sizeof(pal_a));
    size_t idat_total = 0;
    size_t pos = 33;
    while (pos + 12 <= len) {
        const uint32_t clen = get_be32(data + pos);
        const uint8_t* ctag = data + pos + 4;
        if (pos + 12 + clen > len) return -1;
        const uint8_t* cdat = data + pos + 8;
        // validate the CRC of every chunk this path consumes — libpng
        // treats a bad CRC as fatal, and "pixel-identical to the libpng
        // path" includes failing on the same corrupt inputs
        if ((std::memcmp(ctag, "IDAT", 4) == 0
             || std::memcmp(ctag, "PLTE", 4) == 0
             || std::memcmp(ctag, "tRNS", 4) == 0)
            && libdeflate_crc32(libdeflate_crc32(0, ctag, 4), cdat, clen)
               != get_be32(data + pos + 8 + clen))
            return -1;
        if (std::memcmp(ctag, "IDAT", 4) == 0) {
            saw_idat = true;
            idat_total += clen;
        } else if (std::memcmp(ctag, "PLTE", 4) == 0) {
            if (saw_idat) {
                // libpng: benign "out of place" — skipped with a warning.
                // Ignoring it here keeps pal_n unset when no valid PLTE
                // came first, so the pal_n==0 check below falls back to
                // libpng's fatal missing-PLTE error.
            } else if (pal_n > 0) {
                return -1;             // libpng: fatal "duplicate" PLTE
            } else {
                if (clen % 3 || clen > 768 || clen == 0) return -1;
                pal_n = static_cast<int>(clen / 3);
                for (int i = 0; i < pal_n; ++i) {
                    pal[i][0] = cdat[3 * i];
                    pal[i][1] = cdat[3 * i + 1];
                    pal[i][2] = cdat[3 * i + 2];
                }
            }
        } else if (std::memcmp(ctag, "tRNS", 4) == 0) {
            if (ctype != 3)
                return -1;             // color-key transparency: libpng path
            // Mirror libpng's benign-skip cases exactly (each is a warning
            // + ignored chunk there, so it must be ignored — not honored —
            // here): tRNS after IDAT, duplicate tRNS, tRNS before PLTE,
            // and tRNS longer than the palette.  Fuzz repros 532163 (tRNS
            // after IDAT) and 534911 (two tRNS before PLTE) caught the
            // fast path compositing alpha libpng had discarded.
            if (!saw_idat && !have_trns && pal_n > 0
                && clen <= static_cast<uint32_t>(pal_n)) {
                std::memcpy(pal_a, cdat, clen);
                have_trns = true;
            }
        } else if (std::memcmp(ctag, "IEND", 4) == 0) {
            saw_iend = true;
            break;
        }
        pos += 12 + clen;
    }
    if (idat_total == 0) return -1;
    if (ctype == 3 && pal_n == 0) return -1;
    // a truncated file missing IEND must fail like libpng does, not
    // silently decode (part of the "identical including failures" contract)
    if (!saw_iend) return -1;

    // gather IDAT payloads into one contiguous zlib stream
    uint8_t* zdat = static_cast<uint8_t*>(std::malloc(idat_total));
    if (!zdat) { set_err("oom"); return 1; }
    size_t zpos = 0;
    pos = 33;
    while (pos + 12 <= len) {
        const uint32_t clen = get_be32(data + pos);
        if (std::memcmp(data + pos + 4, "IDAT", 4) == 0) {
            std::memcpy(zdat + zpos, data + pos + 8, clen);
            zpos += clen;
        } else if (std::memcmp(data + pos + 4, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + clen;
    }

    const size_t stride = static_cast<size_t>(w) * channels;
    const size_t rlen = (stride + 1) * h;
    uint8_t* raw = static_cast<uint8_t*>(std::malloc(rlen));
    if (!raw) { std::free(zdat); set_err("oom"); return 1; }
    libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) { std::free(zdat); std::free(raw); set_err("oom"); return 1; }
    size_t got = 0;
    const libdeflate_result zrc =
        libdeflate_zlib_decompress(d, zdat, zpos, raw, rlen, &got);
    libdeflate_free_decompressor(d);
    std::free(zdat);
    if (zrc != LIBDEFLATE_SUCCESS || got != rlen) {
        std::free(raw);
        return -1;                     // odd stream: let libpng diagnose
    }
    if (!png_defilter(raw, static_cast<int>(h), stride, channels)) {
        std::free(raw);
        return -1;
    }
    // out-of-range palette indices hard-error in libpng; scanning them
    // here (cheap: one pass over index bytes, rare ctype in this workload)
    // keeps the fast path from decoding them as opaque black instead
    if (ctype == 3 && pal_n < 256) {
        for (uint32_t y = 0; y < h; ++y) {
            const uint8_t* src = raw + y * (stride + 1) + 1;
            for (uint32_t x = 0; x < w; ++x) {
                if (src[x] >= pal_n) {
                    std::free(raw);
                    return -1;         // let libpng raise its own error
                }
            }
        }
    }

    // convert to white-composited RGB8
    const size_t stride3 = static_cast<size_t>(w) * 3;
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(stride3 * h));
    if (!buf) { std::free(raw); set_err("oom"); return 1; }
    // palette: pre-composite the LUT once
    uint8_t lut[256][3];
    if (ctype == 3) {
        for (int i = 0; i < pal_n; ++i)
            composite_white(pal[i], have_trns ? pal_a[i] : 255, lut[i]);
        for (int i = pal_n; i < 256; ++i)
            lut[i][0] = lut[i][1] = lut[i][2] = 0;
    }
    for (uint32_t y = 0; y < h; ++y) {
        const uint8_t* src = raw + y * (stride + 1) + 1;
        uint8_t* dst = buf + y * stride3;
        switch (ctype) {
        case 0:
            for (uint32_t x = 0; x < w; ++x) {
                const uint8_t g = src[x];
                dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = g;
            }
            break;
        case 2:
            std::memcpy(dst, src, stride3);
            break;
        case 3:
            for (uint32_t x = 0; x < w; ++x) {
                const uint8_t* c = lut[src[x]];
                dst[3 * x] = c[0]; dst[3 * x + 1] = c[1];
                dst[3 * x + 2] = c[2];
            }
            break;
        case 4:
            for (uint32_t x = 0; x < w; ++x) {
                const uint8_t g3[3] = {src[2 * x], src[2 * x],
                                       src[2 * x]};
                composite_white(g3, src[2 * x + 1], dst + 3 * x);
            }
            break;
        case 6:
            for (uint32_t x = 0; x < w; ++x)
                composite_white(src + 4 * x, src[4 * x + 3], dst + 3 * x);
            break;
        }
    }
    std::free(raw);
    *out = buf;
    *out_w = static_cast<int>(w);
    *out_h = static_cast<int>(h);
    return 0;
}

#endif  // ISX_HAVE_LIBDEFLATE

// Decode PNG bytes to RGB8 (alpha composited on white, round-half-up).
int isx_decode_png(const uint8_t* data, size_t len,
                   uint8_t** out, int* out_w, int* out_h) {
    *out = nullptr;
#ifdef ISX_HAVE_LIBDEFLATE
    {
        const char* e = std::getenv("ISX_PNG_FAST");
        if (!(e && e[0] == '0')) {
            const int rc = decode_png_fast(data, len, out, out_w, out_h);
            if (rc >= 0) return rc;    // handled (ok or hard error)
        }
    }
#endif
    if (len < 8 || png_sig_cmp(data, 0, 8)) {
        set_err("png: bad signature");
        return 1;
    }
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING,
                                             nullptr, nullptr, nullptr);
    if (!png) { set_err("png: alloc"); return 1; }
    png_infop info = png_create_info_struct(png);
    uint8_t* rgba = nullptr;
    uint8_t* buf = nullptr;
    png_bytep* rows = nullptr;
    if (setjmp(png_jmpbuf(png))) {
        std::free(rgba);
        std::free(buf);
        std::free(rows);
        png_destroy_read_struct(&png, &info, nullptr);
        if (!g_err[0]) set_err("png: decode error");
        return 1;
    }
    PngReadCtx ctx{data, len, 0};
    png_set_read_fn(png, &ctx, png_read_fn);
    png_read_info(png, info);
    if (exceeds_pixel_limit(png_get_image_width(png, info),
                            png_get_image_height(png, info))) {
        set_err("png: exceeds pixel limit");
        longjmp(png_jmpbuf(png), 1);
    }
    png_set_expand(png);                    // palette/gray/tRNS -> 8-bit
    png_set_strip_16(png);
    png_set_gray_to_rgb(png);
    png_set_add_alpha(png, 0xFF, PNG_FILLER_AFTER);   // uniform RGBA
    png_read_update_info(png, info);
    const int w = static_cast<int>(png_get_image_width(png, info));
    const int h = static_cast<int>(png_get_image_height(png, info));
    const size_t stride4 = static_cast<size_t>(w) * 4;
    rgba = static_cast<uint8_t*>(std::malloc(stride4 * h));
    rows = static_cast<png_bytep*>(std::malloc(sizeof(png_bytep) * h));
    if (!rgba || !rows) { set_err("oom"); longjmp(png_jmpbuf(png), 1); }
    for (int y = 0; y < h; ++y) rows[y] = rgba + y * stride4;
    png_read_image(png, rows);
    png_read_end(png, nullptr);
    png_destroy_read_struct(&png, &info, nullptr);
    std::free(rows);
    rows = nullptr;

    // composite on white: out = a*px + (1-a)*255, round-half-up
    const size_t stride3 = static_cast<size_t>(w) * 3;
    buf = static_cast<uint8_t*>(std::malloc(stride3 * h));
    if (!buf) { std::free(rgba); set_err("oom"); return 1; }
    const size_t n = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < n; ++i) {
        const uint8_t* px = rgba + i * 4;
        composite_white(px, px[3], buf + i * 3);
    }
    std::free(rgba);
    *out = buf;
    *out_w = w;
    *out_h = h;
    return 0;
}

// ---------------------------------------------------------------- WEBP
//
// Native WEBP decode (the reference's runtime whitelists webp,
// pages/index/index.js:4).  Static images only: animated files return an
// error so the caller's Pillow fallback ladder handles them (first frame),
// mirroring the GIF behavior.  Alpha is composited onto opaque white with
// the same round-half-up as the PNG path and imgio.codec._img_to_rgb, so
// the answer does not depend on which decoder fired.

int isx_webp_available(void) {
#ifdef ISX_HAVE_WEBP
    return 1;
#else
    return 0;
#endif
}

int isx_decode_webp(const uint8_t* data, size_t len,
                    uint8_t** out, int* out_w, int* out_h) {
    *out = nullptr;
#ifndef ISX_HAVE_WEBP
    (void)data; (void)len; (void)out_w; (void)out_h;
    set_err("webp: not compiled in");
    return 1;
#else
    WebPBitstreamFeatures feat;
    if (WebPGetFeatures(data, len, &feat) != VP8_STATUS_OK) {
        set_err("webp: bad header");
        return 1;
    }
    if (feat.has_animation) {
        set_err("webp: animated (caller takes the Pillow ladder)");
        return 1;
    }
    const int w = feat.width;
    const int h = feat.height;
    if (w <= 0 || h <= 0) { set_err("webp: bad dimensions"); return 1; }
    if (exceeds_pixel_limit(w, h)) {
        set_err("webp: exceeds pixel limit");
        return 1;
    }
    const size_t n = static_cast<size_t>(w) * static_cast<size_t>(h);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(n * 3));
    if (!buf) { set_err("oom"); return 1; }
    if (!feat.has_alpha) {
        if (!WebPDecodeRGBInto(data, len, buf, n * 3,
                               w * 3)) {
            std::free(buf);
            set_err("webp: decode error");
            return 1;
        }
    } else {
        uint8_t* rgba = static_cast<uint8_t*>(std::malloc(n * 4));
        if (!rgba) { std::free(buf); set_err("oom"); return 1; }
        if (!WebPDecodeRGBAInto(data, len, rgba, n * 4, w * 4)) {
            std::free(rgba);
            std::free(buf);
            set_err("webp: decode error");
            return 1;
        }
        for (size_t i = 0; i < n; ++i) {
            const uint8_t* px = rgba + i * 4;
            composite_white(px, px[3], buf + i * 3);
        }
        std::free(rgba);
    }
    *out = buf;
    *out_w = w;
    *out_h = h;
    return 0;
#endif
}

// ---------------------------------------------------------------- BMP
//
// Native BMP decode (the reference's runtime whitelists bmp,
// pages/index/index.js:4).  Handles the shapes Pillow maps to plain RGB —
// BITMAPINFOHEADER (40-byte), BI_RGB, 8-bit palette / 24-bit / 32-bit,
// bottom-up or top-down — and errors out on everything else (OS/2 or V4/V5
// headers, RLE, bitfields, 1/4/16-bit) so the caller's Pillow ladder takes
// those.  32-bit BI_RGB ignores the 4th byte (Pillow raw mode "BGRX");
// BMP has no alpha here, so no compositing is involved.

static uint32_t rd_u32(const uint8_t* p) {
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8)
         | (static_cast<uint32_t>(p[2]) << 16)
         | (static_cast<uint32_t>(p[3]) << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
    return static_cast<uint16_t>(p[0] | (p[1] << 8));
}

int isx_decode_bmp(const uint8_t* data, size_t len,
                   uint8_t** out, int* out_w, int* out_h) {
    *out = nullptr;
    if (len < 54 || data[0] != 'B' || data[1] != 'M') {
        set_err("bmp: bad signature");
        return 1;
    }
    const uint32_t pix_off = rd_u32(data + 10);
    const uint32_t hdr = rd_u32(data + 14);
    if (hdr != 40) { set_err("bmp: unsupported DIB header"); return 1; }
    const int32_t w = static_cast<int32_t>(rd_u32(data + 18));
    const int32_t h_raw = static_cast<int32_t>(rd_u32(data + 22));
    const uint16_t bpp = rd_u16(data + 28);
    const uint32_t comp = rd_u32(data + 30);
    uint32_t colors = rd_u32(data + 46);
    const bool top_down = h_raw < 0;
    const int64_t h64 = top_down ? -static_cast<int64_t>(h_raw) : h_raw;
    if (comp != 0) { set_err("bmp: compressed (not BI_RGB)"); return 1; }
    if (bpp != 8 && bpp != 24 && bpp != 32) {
        set_err("bmp: unsupported bit depth");
        return 1;
    }
    if (w <= 0 || h64 <= 0 || w > (1 << 24) || h64 > (1 << 24)) {
        set_err("bmp: bad dimensions");
        return 1;
    }
    // BMP can't truly bomb (uncompressed pixels must be present, so the
    // amplification is <=3x for 8-bit palette files), but Pillow refuses
    // these sizes — keep the whole native surface on one policy.
    if (exceeds_pixel_limit(static_cast<uint64_t>(w),
                            static_cast<uint64_t>(h64))) {
        set_err("bmp: exceeds pixel limit");
        return 1;
    }
    const int h = static_cast<int>(h64);
    // palette: BGRX quads right after the 54-byte headers
    uint8_t pal[256][3];
    if (bpp == 8) {
        if (colors == 0 || colors > 256) colors = 256;
        if (54 + 4 * static_cast<size_t>(colors) > len) {
            set_err("bmp: truncated palette");
            return 1;
        }
        std::memset(pal, 0, sizeof(pal));   // oob indices -> black (Pillow
        for (uint32_t i = 0; i < colors; ++i) {  // zero-pads its palette)
            const uint8_t* q = data + 54 + 4 * i;
            pal[i][0] = q[2]; pal[i][1] = q[1]; pal[i][2] = q[0];
        }
    }
    const size_t stride =
        ((static_cast<size_t>(w) * bpp + 31) / 32) * 4;   // 4-byte row pad
    if (pix_off > len || stride * h > len - pix_off) {
        set_err("bmp: truncated pixel data");
        return 1;
    }
    uint8_t* buf = static_cast<uint8_t*>(
        std::malloc(static_cast<size_t>(w) * h * 3));
    if (!buf) { set_err("oom"); return 1; }
    for (int y = 0; y < h; ++y) {
        const uint8_t* src = data + pix_off
                             + stride * (top_down ? y : (h - 1 - y));
        uint8_t* dst = buf + static_cast<size_t>(y) * w * 3;
        if (bpp == 8) {
            for (int x = 0; x < w; ++x) {
                const uint8_t* c = pal[src[x]];
                dst[3 * x] = c[0]; dst[3 * x + 1] = c[1];
                dst[3 * x + 2] = c[2];
            }
        } else if (bpp == 24) {
            for (int x = 0; x < w; ++x) {           // BGR -> RGB
                dst[3 * x] = src[3 * x + 2];
                dst[3 * x + 1] = src[3 * x + 1];
                dst[3 * x + 2] = src[3 * x];
            }
        } else {                                    // 32-bit BGRX
            for (int x = 0; x < w; ++x) {
                dst[3 * x] = src[4 * x + 2];
                dst[3 * x + 1] = src[4 * x + 1];
                dst[3 * x + 2] = src[4 * x];
            }
        }
    }
    *out = buf;
    *out_w = w;
    *out_h = h;
    return 0;
}

// ---------------------------------------------------------------- GIF
//
// Native GIF decode, first frame only (the reference's runtime whitelists
// gif, pages/index/index.js:4; Pillow's no-seek open also yields frame 0,
// so parity holds for animated files too).  Supported: 87a/89a, global or
// local color table, interlace, GCE transparency (composited to the white
// canvas like every other alpha path).  The first image descriptor must
// cover the full logical screen at (0,0) — offset first frames depend on
// Pillow's background/disposal semantics, so those error out and take the
// Pillow ladder.  Out-of-range palette indices map to black, matching
// Pillow's zero-padded 256-entry palette.

// GIF-variant LZW: codes start at min_code_size+1 bits, dictionary capped
// at 4096 entries, CLEAR resets, code width grows at dictionary fill.
// Decodes exactly n_pixels indices; surplus compressed data is ignored
// (encoders may pad), missing data is an error (strict, like Pillow with
// LOAD_TRUNCATED_IMAGES=False).
static bool gif_lzw(const uint8_t* data, size_t len, size_t* pos_io,
                    int min_code, uint8_t* idx_out, size_t n_pixels) {
    if (min_code < 1 || min_code > 11) return false;
    const int clear = 1 << min_code;
    const int eoi = clear + 1;
    // dictionary as (prefix link, last byte): entry i < clear is literal i
    static thread_local int16_t prefix[4096];
    static thread_local uint8_t last[4096];
    static thread_local uint8_t tail[4096];   // expansion scratch (depth
    int next_code = eoi + 1;                  // <= 4096 by construction)
    int code_bits = min_code + 1;
    int prev = -1;
    uint32_t acc = 0;
    int acc_bits = 0;
    size_t pos = *pos_io;
    size_t produced = 0;
    int sub_left = 0;        // bytes remaining in the current sub-block
    while (produced < n_pixels) {
        while (acc_bits < code_bits) {
            if (sub_left == 0) {
                if (pos >= len) return false;
                sub_left = data[pos++];
                if (sub_left == 0) return false;    // terminator, data short
            }
            if (pos >= len) return false;
            acc |= static_cast<uint32_t>(data[pos++]) << acc_bits;
            acc_bits += 8;
            --sub_left;
        }
        const int code = static_cast<int>(acc & ((1u << code_bits) - 1));
        acc >>= code_bits;
        acc_bits -= code_bits;
        if (code == clear) {
            next_code = eoi + 1;
            code_bits = min_code + 1;
            prev = -1;
            continue;
        }
        if (code == eoi) return false;              // EOI before all pixels
        if (code >= next_code + (prev >= 0 ? 1 : 0) || code >= 4096)
            return false;                           // corrupt stream
        // expand `code` (or prev+first(code) for the KwKwK case)
        int expand = code;
        if (code == next_code) expand = prev;       // KwKwK: prev + first
        int depth = 0;
        int c = expand;
        while (c >= clear) { tail[depth++] = last[c]; c = prefix[c]; }
        tail[depth++] = static_cast<uint8_t>(c);
        const uint8_t first = static_cast<uint8_t>(c);
        // emit in source order (tail[] holds it reversed)
        for (int k = depth - 1; k >= 0 && produced < n_pixels; --k)
            idx_out[produced++] = tail[k];
        if (code == next_code && produced < n_pixels)
            idx_out[produced++] = first;
        if (prev >= 0 && next_code < 4096) {
            prefix[next_code] = static_cast<int16_t>(prev);
            last[next_code] = first;
            ++next_code;
            if (next_code == (1 << code_bits) && code_bits < 12)
                ++code_bits;
        }
        prev = code;
    }
    *pos_io = pos;
    return true;
}

int isx_decode_gif(const uint8_t* data, size_t len,
                   uint8_t** out, int* out_w, int* out_h) {
    *out = nullptr;
    if (len < 13 || std::memcmp(data, "GIF8", 4) != 0
            || (data[4] != '7' && data[4] != '9') || data[5] != 'a') {
        set_err("gif: bad signature");
        return 1;
    }
    const int lsw = rd_u16(data + 6);
    const int lsh = rd_u16(data + 8);
    if (lsw <= 0 || lsh <= 0) { set_err("gif: bad dimensions"); return 1; }
    if (exceeds_pixel_limit(lsw, lsh)) {
        set_err("gif: exceeds pixel limit");
        return 1;
    }
    uint8_t pal[256][3];
    std::memset(pal, 0, sizeof(pal));   // oob indices -> black (Pillow
    bool have_pal = false;              // zero-pads its palette)
    size_t pos = 13;
    if (data[10] & 0x80) {              // global color table
        const int n = 2 << (data[10] & 7);
        if (pos + 3 * static_cast<size_t>(n) > len) {
            set_err("gif: truncated color table");
            return 1;
        }
        for (int i = 0; i < n; ++i) {
            pal[i][0] = data[pos + 3 * i];
            pal[i][1] = data[pos + 3 * i + 1];
            pal[i][2] = data[pos + 3 * i + 2];
        }
        pos += 3 * static_cast<size_t>(n);
        have_pal = true;
    }
    int transparent = -1;               // from the GCE preceding the image
    while (true) {
        if (pos >= len) { set_err("gif: truncated"); return 1; }
        const uint8_t block = data[pos++];
        if (block == 0x3B) { set_err("gif: no image data"); return 1; }
        if (block == 0x21) {            // extension
            if (pos >= len) { set_err("gif: truncated"); return 1; }
            const uint8_t label = data[pos++];
            if (label == 0xF9 && pos + 6 <= len && data[pos] == 4) {
                if (data[pos + 1] & 1)          // transparent-color flag
                    transparent = data[pos + 4];
            }
            while (true) {              // skip sub-blocks
                if (pos >= len) { set_err("gif: truncated"); return 1; }
                const uint8_t n = data[pos++];
                if (n == 0) break;
                pos += n;
                if (pos > len) { set_err("gif: truncated"); return 1; }
            }
            continue;
        }
        if (block != 0x2C) { set_err("gif: unknown block"); return 1; }
        break;                          // image descriptor
    }
    if (pos + 9 > len) { set_err("gif: truncated"); return 1; }
    const int left = rd_u16(data + pos);
    const int top = rd_u16(data + pos + 2);
    const int iw = rd_u16(data + pos + 4);
    const int ih = rd_u16(data + pos + 6);
    const uint8_t iflags = data[pos + 8];
    pos += 9;
    if (left != 0 || top != 0 || iw != lsw || ih != lsh) {
        // partial first frame: Pillow composes it onto background/disposal
        // state — rare, and exactly what the Pillow ladder is for
        set_err("gif: first frame does not cover the screen");
        return 1;
    }
    if (iflags & 0x80) {                // local color table overrides
        const int n = 2 << (iflags & 7);
        if (pos + 3 * static_cast<size_t>(n) > len) {
            set_err("gif: truncated color table");
            return 1;
        }
        std::memset(pal, 0, sizeof(pal));
        for (int i = 0; i < n; ++i) {
            pal[i][0] = data[pos + 3 * i];
            pal[i][1] = data[pos + 3 * i + 1];
            pal[i][2] = data[pos + 3 * i + 2];
        }
        pos += 3 * static_cast<size_t>(n);
        have_pal = true;
    }
    if (!have_pal) { set_err("gif: no color table"); return 1; }
    if (pos >= len) { set_err("gif: truncated"); return 1; }
    const int min_code = data[pos++];
    const size_t n_px = static_cast<size_t>(iw) * ih;
    uint8_t* idx = static_cast<uint8_t*>(std::malloc(n_px));
    if (!idx) { set_err("oom"); return 1; }
    if (!gif_lzw(data, len, &pos, min_code, idx, n_px)) {
        std::free(idx);
        set_err("gif: corrupt LZW stream");
        return 1;
    }
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(n_px * 3));
    if (!buf) { std::free(idx); set_err("oom"); return 1; }
    // interlace passes: rows 0,8,16.. then 4,12.. then 2,6.. then 1,3..
    static const int i0[4] = {0, 4, 2, 1};
    static const int istep[4] = {8, 8, 4, 2};
    size_t src_row = 0;
    for (int pass = 0; pass < ((iflags & 0x40) ? 4 : 1); ++pass) {
        const int y0 = (iflags & 0x40) ? i0[pass] : 0;
        const int step = (iflags & 0x40) ? istep[pass] : 1;
        for (int y = y0; y < ih; y += step, ++src_row) {
            const uint8_t* s = idx + src_row * iw;
            uint8_t* dst = buf + static_cast<size_t>(y) * iw * 3;
            for (int x = 0; x < iw; ++x) {
                if (s[x] == transparent) {      // alpha 0 -> white canvas
                    dst[3 * x] = 255; dst[3 * x + 1] = 255;
                    dst[3 * x + 2] = 255;
                } else {
                    const uint8_t* c = pal[s[x]];
                    dst[3 * x] = c[0]; dst[3 * x + 1] = c[1];
                    dst[3 * x + 2] = c[2];
                }
            }
        }
    }
    std::free(idx);
    *out = buf;
    *out_w = iw;
    *out_h = ih;
    return 0;
}

// ------------------------------------------------- PNG (fast encode path)
//
// libdeflate-backed encoder: hand-rolled fixed Up filter (Sub on the first
// canvas row) + one whole-buffer SIMD deflate + hand-assembled container.
// Measured ~10-20x zlib's single-core deflate throughput on AVX2+ hosts,
// byte-compatible output (any spec-compliant PNG reader).  Falls back to
// the libpng/zlib path when built without libdeflate or when
// ISX_PNG_FAST=0.  The filter choice matches isx_encode_png/encode_png_mt.

static void put_be32(uint8_t* p, uint32_t v) {
    p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}

// The adaptive streaming encoder needs only zlib; ISX_PNG_FAST=0 is the
// shared kill switch for all the fast paths.
static bool adaptive_png_enabled() {
    const char* e = std::getenv("ISX_PNG_FAST");
    return !(e && e[0] == '0');
}

static bool fast_png_enabled() {
#ifdef ISX_HAVE_LIBDEFLATE
    return adaptive_png_enabled();
#else
    return false;
#endif
}

int isx_png_fast_available() { return fast_png_enabled() ? 1 : 0; }

// Filter `nrows` packed RGB8 rows into dst ((1 filter byte + w*3) per row):
// Up against the previous raw row; Sub when there is none (first canvas
// row).  `prev` is the raw row preceding rgb[0] (nullptr at canvas top).
static void png_filter_rows(const uint8_t* rgb, const uint8_t* prev,
                            size_t stride, int nrows, uint8_t* dst) {
    for (int y = 0; y < nrows; ++y) {
        const uint8_t* cur = rgb + y * stride;
        const uint8_t* up = y > 0 ? rgb + (y - 1) * stride : prev;
        if (up) {
            *dst++ = 2;                              // Up
            for (size_t i = 0; i < stride; ++i)
                dst[i] = static_cast<uint8_t>(cur[i] - up[i]);
        } else {
            *dst++ = 1;                              // Sub
            for (size_t i = 0; i < stride; ++i)
                dst[i] = static_cast<uint8_t>(cur[i] - (i >= 3 ? cur[i - 3]
                                                               : 0));
        }
        dst += stride;
    }
}

#ifdef ISX_HAVE_LIBDEFLATE

// Byte sink: file or growable memory buffer.
struct ByteSink {
    FILE* f;
    uint8_t* mem;
    size_t len, cap;
};

static bool sink_put(ByteSink* s, const void* p, size_t n) {
    if (s->f) return std::fwrite(p, 1, n, s->f) == n;
    if (s->len + n > s->cap) {
        size_t cap = s->cap ? s->cap : (size_t{1} << 16);
        while (cap < s->len + n) cap *= 2;
        uint8_t* m = static_cast<uint8_t*>(std::realloc(s->mem, cap));
        if (!m) return false;
        s->mem = m;
        s->cap = cap;
    }
    std::memcpy(s->mem + s->len, p, n);
    s->len += n;
    return true;
}

// Emit sig + IHDR + IDAT chunks (over a finished zlib stream) + IEND.
static bool write_png_container(ByteSink* s, int w, int h,
                                const uint8_t* z, size_t zlen) {
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (!sink_put(s, sig, 8)) return false;
    uint8_t hdr[8 + 13 + 4];
    put_be32(hdr, 13);
    std::memcpy(hdr + 4, "IHDR", 4);
    put_be32(hdr + 8, static_cast<uint32_t>(w));
    put_be32(hdr + 12, static_cast<uint32_t>(h));
    hdr[16] = 8; hdr[17] = 2; hdr[18] = 0; hdr[19] = 0; hdr[20] = 0;
    put_be32(hdr + 21, static_cast<uint32_t>(
        libdeflate_crc32(0, hdr + 4, 17)));
    if (!sink_put(s, hdr, sizeof(hdr))) return false;
    // <=32 MB IDAT chunks: any boundary inside the zlib stream is legal,
    // and bounded chunks keep conservative readers happy
    const size_t kChunk = size_t{32} << 20;
    size_t off = 0;
    do {
        const size_t n = zlen - off < kChunk ? zlen - off : kChunk;
        uint8_t ch[8];
        put_be32(ch, static_cast<uint32_t>(n));
        std::memcpy(ch + 4, "IDAT", 4);
        uint32_t crc = libdeflate_crc32(0, ch + 4, 4);
        crc = libdeflate_crc32(crc, z + off, n);
        uint8_t tail[4];
        put_be32(tail, crc);
        if (!sink_put(s, ch, 8) || !sink_put(s, z + off, n) ||
            !sink_put(s, tail, 4))
            return false;
        off += n;
    } while (off < zlen);
    uint8_t iend[12];
    put_be32(iend, 0);
    std::memcpy(iend + 4, "IEND", 4);
    put_be32(iend + 8, static_cast<uint32_t>(
        libdeflate_crc32(0, iend + 4, 4)));
    return sink_put(s, iend, 12);
}

// Probe verdict for a filtered buffer: sample up to 8 spread 32 KB spots.
// 0 = every sample incompressible (stored blocks lose nothing),
// 1 = every sample compressible (one whole-buffer SIMD pass at `level`),
// 2 = mixed content (per-band adaptation needed to not bloat the file).
static int probe_filtered(const uint8_t* filt, size_t flen) {
    const size_t plen = size_t{32} << 10;
    if (flen < 2 * plen) return 1;
    libdeflate_compressor* pc = libdeflate_alloc_compressor(1);
    if (!pc) return 1;
    const int k = flen >= (size_t{2} << 20) ? 8 : 3;
    static thread_local uint8_t pbuf[40 << 10];
    int n_inc = 0, n_done = 0;
    size_t prev_off = static_cast<size_t>(-1);
    for (int i = 0; i < k; ++i) {
        const size_t off = (flen - plen) * i / (k - 1);
        if (off == prev_off) continue;
        prev_off = off;
        const size_t zn = libdeflate_deflate_compress(
            pc, filt + off, plen, pbuf, sizeof(pbuf));
        ++n_done;
        if (zn == 0 || zn + (zn >> 6) >= plen) ++n_inc;
    }
    libdeflate_free_compressor(pc);
    if (n_inc == 0) return 1;
    if (n_inc == n_done) return 0;
    return 2;
}

// Compress pre-filtered scanlines at the decided `level` and emit the
// container into `s` (probing is the caller's job).
static int fast_png_finish(ByteSink* s, int w, int h, int level,
                           const uint8_t* filt, size_t flen) {
    if (level < 0) level = 0;
    if (level > 12) level = 12;
    libdeflate_compressor* c = libdeflate_alloc_compressor(level);
    if (!c) { set_err("png-fast: compressor alloc"); return 1; }
    const size_t bound = libdeflate_zlib_compress_bound(c, flen);
    uint8_t* z = static_cast<uint8_t*>(std::malloc(bound));
    if (!z) { libdeflate_free_compressor(c); set_err("oom"); return 1; }
    const size_t zlen = libdeflate_zlib_compress(c, filt, flen, z, bound);
    libdeflate_free_compressor(c);
    if (zlen == 0) {
        std::free(z);
        set_err("png-fast: compress failed");
        return 1;
    }
    const bool ok = write_png_container(s, w, h, z, zlen);
    std::free(z);
    if (!ok) {
        set_err(s->f ? "png-fast: write failed" : "oom");
        return 1;
    }
    return 0;
}

static int encode_png_adaptive_mem(const uint8_t* rgb, int w, int h,
                                   int level, uint8_t** out,
                                   size_t* out_len);   // fwd (below)

static int encode_png_fast(const uint8_t* rgb, int w, int h, int level,
                           uint8_t** out, size_t* out_len) {
    const size_t stride = static_cast<size_t>(w) * 3;
    const size_t flen = (stride + 1) * h;
    uint8_t* filt = static_cast<uint8_t*>(std::malloc(flen));
    if (!filt) { set_err("oom"); return 1; }
    png_filter_rows(rgb, nullptr, stride, h, filt);
    int use_level = level;
    if (level > 0) {
        switch (probe_filtered(filt, flen)) {
        case 0: use_level = 0; break;     // stored: identical size, ~30x
        case 2:                            // mixed: band-adaptive zlib path
            std::free(filt);
            return encode_png_adaptive_mem(rgb, w, h, level, out, out_len);
        default: break;                    // compressible: one SIMD pass
        }
    }
    ByteSink s{nullptr, nullptr, 0, 0};
    const int rc = fast_png_finish(&s, w, h, use_level, filt, flen);
    std::free(filt);
    if (rc != 0) { std::free(s.mem); return rc; }
    *out = s.mem;
    *out_len = s.len;
    return 0;
}

#endif  // ISX_HAVE_LIBDEFLATE

struct PngWriteCtx {
    uint8_t* data;
    size_t len;
    size_t cap;
};

static void png_write_fn(png_structp png, png_bytep src, png_size_t n) {
    PngWriteCtx* ctx = static_cast<PngWriteCtx*>(png_get_io_ptr(png));
    if (ctx->len + n > ctx->cap) {
        size_t cap = ctx->cap ? ctx->cap * 2 : 1 << 16;
        while (cap < ctx->len + n) cap *= 2;
        uint8_t* p = static_cast<uint8_t*>(std::realloc(ctx->data, cap));
        if (!p) { png_error(png, "oom"); return; }
        ctx->data = p;
        ctx->cap = cap;
    }
    std::memcpy(ctx->data + ctx->len, src, n);
    ctx->len += n;
}

static void png_flush_fn(png_structp) {}

// Encode RGB8 to PNG bytes. compression: zlib level 0..9 (reference exports
// PNG at quality 1.0, i.e. max fidelity — PNG is lossless, the level only
// trades CPU for size).
int isx_encode_png(const uint8_t* rgb, int w, int h, int compression,
                   uint8_t** out, size_t* out_len) {
    *out = nullptr;
#ifdef ISX_HAVE_LIBDEFLATE
    if (fast_png_enabled())
        return encode_png_fast(rgb, w, h, compression, out, out_len);
#endif
    png_structp png = png_create_write_struct(PNG_LIBPNG_VER_STRING,
                                              nullptr, nullptr, nullptr);
    if (!png) { set_err("png: alloc"); return 1; }
    png_infop info = png_create_info_struct(png);
    PngWriteCtx ctx{nullptr, 0, 0};
    if (setjmp(png_jmpbuf(png))) {
        std::free(ctx.data);
        png_destroy_write_struct(&png, &info);
        if (!g_err[0]) set_err("png: encode error");
        return 1;
    }
    png_set_write_fn(png, &ctx, png_write_fn, png_flush_fn);
    png_set_compression_level(png, compression);
    // fixed Up filter: libpng's default per-row 5-filter heuristic costs
    // ~40% of encode time (measured) for a few percent of size on photo
    // content; the MT encoder uses the same fixed choice
    png_set_filter(png, 0, PNG_FILTER_UP);
    png_set_IHDR(png, info, w, h, 8, PNG_COLOR_TYPE_RGB,
                 PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
                 PNG_FILTER_TYPE_DEFAULT);
    png_write_info(png, info);
    const size_t stride = static_cast<size_t>(w) * 3;
    for (int y = 0; y < h; ++y)
        png_write_row(png, const_cast<uint8_t*>(rgb) + y * stride);
    png_write_end(png, nullptr);
    png_destroy_write_struct(&png, &info);
    *out = ctx.data;
    *out_len = ctx.len;
    return 0;
}

}  // extern "C"

// --------------------------------------------------- PNG (streaming writer)
//
// Band-incremental PNG encoder: open once, feed row bands as they arrive
// (e.g. straight off device readback), close to finalize.  The whole canvas
// never needs to exist in host RAM, and the caller can overlap the next
// band's device->host transfer with this band's filter+deflate — on the
// stitch export path those two phases are IO-bound and CPU-bound
// respectively, so they hide under each other (the reference's export is one
// opaque native call, utils/canvas.js:205-242; a framework canvas can be
// 100+ MP, which makes the monolithic form a peak-RSS and latency problem).
//
// Default mode is a hand-rolled zlib stream with *content-adaptive
// compression*: each band's filtered bytes are probed with a fast trial
// deflate, and bands that cannot compress (photographic noise is common on
// stitch canvases) are emitted as deflate stored blocks via
// deflateParams(level 0) — ~20-30x the match-finder's throughput at
// identical output size, while compressible content keeps the requested
// level.  The level switch is legal mid-stream (all prior input is consumed
// between bands) and invisible to readers: the file stays one ordinary
// zlib stream inside IDAT.  ISX_PNG_FAST=0 restores the plain libpng path.

extern "C" {

struct PngStream {
    FILE* f;
    png_structp png;
    png_infop info;
    int w, h, written;
    // adaptive mode state
    int fast, level, cur_level, has_prev;
    uint8_t* prevrow;                // last raw row of the previous band
    uint8_t* filt;                   // one band's filtered bytes
    size_t filt_cap;
    z_stream zs;                     // the IDAT zlib stream
    z_stream ps;                     // trial stream for the per-band probe
    uint8_t* chunk;                  // pending-IDAT accumulation buffer
    size_t chunk_cap, chunk_len;
};

// Flush the accumulated deflate output as one IDAT chunk.
static bool emit_idat(PngStream* s) {
    if (s->chunk_len == 0) return true;
    uint8_t hdr[8], tail[4];
    put_be32(hdr, static_cast<uint32_t>(s->chunk_len));
    std::memcpy(hdr + 4, "IDAT", 4);
    uLong crc = crc32(0L, hdr + 4, 4);
    crc = crc32(crc, s->chunk, static_cast<uInt>(s->chunk_len));
    put_be32(tail, static_cast<uint32_t>(crc));
    if (std::fwrite(hdr, 1, 8, s->f) != 8 ||
        std::fwrite(s->chunk, 1, s->chunk_len, s->f) != s->chunk_len ||
        std::fwrite(tail, 1, 4, s->f) != 4) {
        set_err("png-stream: write failed");
        return false;
    }
    s->chunk_len = 0;
    return true;
}

// Point zs at the free space of the chunk buffer (emitting it when full).
static bool arm_chunk(PngStream* s) {
    if (s->chunk_len == s->chunk_cap && !emit_idat(s)) return false;
    s->zs.next_out = s->chunk + s->chunk_len;
    s->zs.avail_out = static_cast<uInt>(s->chunk_cap - s->chunk_len);
    return true;
}

// Switch the stream's compression level between bands.
static bool set_stream_level(PngStream* s, int want) {
    for (;;) {
        if (!arm_chunk(s)) return false;
        const int rc = deflateParams(&s->zs, want, Z_DEFAULT_STRATEGY);
        s->chunk_len = s->chunk_cap - s->zs.avail_out;
        if (rc == Z_OK) break;
        if (rc != Z_BUF_ERROR) {
            set_err("png-stream: deflateParams failed");
            return false;
        }
    }
    s->cur_level = want;
    return true;
}

// Open an adaptive stream over an already-open FILE* (file or memstream).
// Returns nullptr on failure with isx_last_error set; the FILE* is left
// open for the caller either way (on success the stream owns it).
static PngStream* png_stream_open_f(FILE* f, int w, int h, int compression) {
    PngStream* s =
        static_cast<PngStream*>(std::calloc(1, sizeof(PngStream)));
    if (!s) { set_err("oom"); return nullptr; }
    s->f = f;
    const size_t stride = static_cast<size_t>(w) * 3;
    const int lvl = compression < 0 ? 0 : (compression > 9 ? 9
                                                           : compression);
    s->prevrow = static_cast<uint8_t*>(std::malloc(stride));
    s->chunk_cap = size_t{4} << 20;
    s->chunk = static_cast<uint8_t*>(std::malloc(s->chunk_cap));
    bool ok = s->prevrow && s->chunk &&
              deflateInit2(&s->zs, lvl, Z_DEFLATED, 15, 8,
                           Z_DEFAULT_STRATEGY) == Z_OK;
    if (ok && deflateInit2(&s->ps, 1, Z_DEFLATED, -15, 8,
                           Z_DEFAULT_STRATEGY) != Z_OK) {
        deflateEnd(&s->zs);
        ok = false;
    }
    if (ok) {
        uint8_t hdr[33];
        static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
        std::memcpy(hdr, sig, 8);
        put_be32(hdr + 8, 13);
        std::memcpy(hdr + 12, "IHDR", 4);
        put_be32(hdr + 16, static_cast<uint32_t>(w));
        put_be32(hdr + 20, static_cast<uint32_t>(h));
        hdr[24] = 8; hdr[25] = 2; hdr[26] = 0; hdr[27] = 0; hdr[28] = 0;
        put_be32(hdr + 29, static_cast<uint32_t>(
            crc32(0L, hdr + 12, 17)));
        if (std::fwrite(hdr, 1, 33, s->f) == 33) {
            s->fast = 1;
            s->level = s->cur_level = lvl;
            s->w = w; s->h = h;
            return s;
        }
        deflateEnd(&s->zs);
        deflateEnd(&s->ps);
    }
    std::free(s->prevrow);
    std::free(s->chunk);
    if (!g_err[0]) set_err("png-stream: adaptive init failed");
    std::free(s);
    return nullptr;
}

// Returns an opaque handle, or nullptr (isx_last_error set).
void* isx_png_stream_open(const char* path, int w, int h, int compression) {
    if (adaptive_png_enabled()) {
        FILE* f = std::fopen(path, "wb");
        if (!f) { set_err("png-stream: fopen failed"); return nullptr; }
        PngStream* s = png_stream_open_f(f, w, h, compression);
        if (!s) std::fclose(f);
        return s;
    }
    // volatile: `s` must survive the longjmp back to the setjmp below
    PngStream* volatile s =
        static_cast<PngStream*>(std::calloc(1, sizeof(PngStream)));
    if (!s) { set_err("oom"); return nullptr; }
    s->f = std::fopen(path, "wb");
    if (!s->f) { set_err("png-stream: fopen failed"); std::free(s);
                 return nullptr; }
    s->png = png_create_write_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                                     nullptr);
    s->info = s->png ? png_create_info_struct(s->png) : nullptr;
    if (!s->png || !s->info || setjmp(png_jmpbuf(s->png))) {
        if (!g_err[0]) set_err("png-stream: init failed");
        if (s->png) png_destroy_write_struct(&s->png, &s->info);
        std::fclose(s->f);
        std::free(s);
        return nullptr;
    }
    png_init_io(s->png, s->f);
    png_set_compression_level(s->png, compression);
    png_set_filter(s->png, 0, PNG_FILTER_UP);   // see isx_encode_png
    png_set_IHDR(s->png, s->info, w, h, 8, PNG_COLOR_TYPE_RGB,
                 PNG_INTERLACE_NONE, PNG_COMPRESSION_TYPE_DEFAULT,
                 PNG_FILTER_TYPE_DEFAULT);
    png_write_info(s->png, s->info);
    s->w = w;
    s->h = h;
    s->written = 0;
    return s;
}

// Append `nrows` packed RGB8 rows.  0 on success.
int isx_png_stream_write(void* handle, const uint8_t* rgb, int nrows) {
    PngStream* s = static_cast<PngStream*>(handle);
    if (!s || (!s->png && !s->fast)) {
        set_err("png-stream: bad handle");
        return 1;
    }
    if (nrows < 0 || s->written + nrows > s->h) {
        set_err("png-stream: row overflow");
        return 1;
    }
    if (s->fast) {
        if (nrows == 0) return 0;
        const size_t stride = static_cast<size_t>(s->w) * 3;
        const size_t flen = (stride + 1) * static_cast<size_t>(nrows);
        if (flen > s->filt_cap) {
            uint8_t* p = static_cast<uint8_t*>(std::realloc(s->filt, flen));
            if (!p) { set_err("oom"); return 1; }
            s->filt = p;
            s->filt_cap = flen;
        }
        png_filter_rows(rgb, s->has_prev ? s->prevrow : nullptr, stride,
                        nrows, s->filt);
        std::memcpy(s->prevrow, rgb + stride * (nrows - 1), stride);
        s->has_prev = 1;
        // probe this band's compressibility: trial-deflate 32 KB samples at
        // the band's start, middle and end; only when ALL of them stay
        // >=64/65 of their size (matching cannot pay anywhere) is the band
        // emitted as stored blocks (level 0) — a single sample would let
        // one flat region misclassify a mixed band (or vice versa)
        int want = s->level;
        if (s->level > 0) {
            const size_t plen = flen < (size_t{32} << 10) ? flen
                                                          : (size_t{32} << 10);
            static thread_local uint8_t pbuf[40 << 10];
            const size_t offs[3] = {0, (flen - plen) / 2, flen - plen};
            bool all_incompressible = true;
            for (int k = 0; k < 3 && all_incompressible; ++k) {
                if (k > 0 && offs[k] == offs[k - 1]) continue;
                deflateReset(&s->ps);
                s->ps.next_in = s->filt + offs[k];
                s->ps.avail_in = static_cast<uInt>(plen);
                s->ps.next_out = pbuf;
                s->ps.avail_out = sizeof(pbuf);
                if (deflate(&s->ps, Z_FINISH) != Z_STREAM_END) break;
                const size_t zn = sizeof(pbuf) - s->ps.avail_out;
                if (zn + (zn >> 6) < plen) all_incompressible = false;
            }
            if (all_incompressible) want = 0;
        }
        if (want != s->cur_level && !set_stream_level(s, want)) return 1;
        // feed avail_in in <UINT_MAX slices: a single write call covering
        // >=4 GB of rows (public C API; the Python bander never does this)
        // must not silently truncate the band into a corrupt PNG
        size_t fed = 0;
        while (fed < flen) {
            const size_t take = std::min(flen - fed,
                                         size_t{1} << 30);
            s->zs.next_in = s->filt + fed;
            s->zs.avail_in = static_cast<uInt>(take);
            while (s->zs.avail_in) {
                if (!arm_chunk(s)) return 1;
                if (deflate(&s->zs, Z_NO_FLUSH) == Z_STREAM_ERROR) {
                    set_err("png-stream: deflate failed");
                    return 1;
                }
                s->chunk_len = s->chunk_cap - s->zs.avail_out;
            }
            fed += take;
        }
        s->written += nrows;
        return 0;
    }
    // the jmp_buf captured at open died with open's stack frame — rearm it
    // in every call that enters libpng
    if (setjmp(png_jmpbuf(s->png))) {
        if (!g_err[0]) set_err("png-stream: write error");
        return 1;
    }
    const size_t stride = static_cast<size_t>(s->w) * 3;
    for (int y = 0; y < nrows; ++y)
        png_write_row(s->png, const_cast<uint8_t*>(rgb) + y * stride);
    s->written += nrows;
    return 0;
}

// Finalize and free.  0 on success (all h rows were written and the file
// closed cleanly).  Always releases the handle — also the error/abort path.
int isx_png_stream_close(void* handle) {
    PngStream* s = static_cast<PngStream*>(handle);
    if (!s) { set_err("png-stream: bad handle"); return 1; }
    int rc = 0;
    if (s->fast) {
        if (s->written == s->h) {
            for (;;) {                       // drain Z_FINISH into chunks
                if (!arm_chunk(s)) { rc = 1; break; }
                const int drc = deflate(&s->zs, Z_FINISH);
                s->chunk_len = s->chunk_cap - s->zs.avail_out;
                if (drc == Z_STREAM_END) break;
                if (drc != Z_OK && drc != Z_BUF_ERROR) {
                    set_err("png-stream: finalize deflate failed");
                    rc = 1;
                    break;
                }
            }
            if (rc == 0 && !emit_idat(s)) rc = 1;
            if (rc == 0) {
                uint8_t iend[12];
                put_be32(iend, 0);
                std::memcpy(iend + 4, "IEND", 4);
                put_be32(iend + 8, static_cast<uint32_t>(crc32(
                    0L, iend + 4, 4)));
                if (std::fwrite(iend, 1, 12, s->f) != 12) {
                    set_err("png-stream: write failed");
                    rc = 1;
                }
            }
        } else {
            set_err("png-stream: closed before all rows were written");
            rc = 1;
        }
        deflateEnd(&s->zs);
        deflateEnd(&s->ps);
        std::free(s->filt);
        std::free(s->prevrow);
        std::free(s->chunk);
        if (s->f && std::fclose(s->f) != 0 && rc == 0) {
            set_err("png-stream: fclose failed");
            rc = 1;
        }
        std::free(s);
        return rc;
    }
    if (s->png) {
        if (setjmp(png_jmpbuf(s->png))) {
            if (!g_err[0]) set_err("png-stream: finalize error");
            rc = 1;
        } else if (s->written == s->h) {
            png_write_end(s->png, nullptr);
        } else {
            set_err("png-stream: closed before all rows were written");
            rc = 1;
        }
        png_destroy_write_struct(&s->png, &s->info);
    }
    if (s->f && std::fclose(s->f) != 0 && rc == 0) {
        set_err("png-stream: fclose failed");
        rc = 1;
    }
    std::free(s);
    return rc;
}

#ifdef ISX_HAVE_LIBDEFLATE

// Monolithic encode via the band-adaptive stream writer into a memstream:
// the mixed-content case (flat margins + photographic regions) where one
// whole-buffer level choice would either bloat the file (stored) or waste
// the speed win (full match-finding everywhere).
static int encode_png_adaptive_mem(const uint8_t* rgb, int w, int h,
                                   int level, uint8_t** out,
                                   size_t* out_len) {
    char* mem = nullptr;
    size_t mlen = 0;
    FILE* f = open_memstream(&mem, &mlen);
    if (!f) { set_err("oom"); return 1; }
    PngStream* s = png_stream_open_f(f, w, h, level);
    if (!s) {
        std::fclose(f);
        std::free(mem);
        return 1;
    }
    const size_t stride = static_cast<size_t>(w) * 3;
    int band = static_cast<int>((size_t{4} << 20) / (stride ? stride : 1));
    if (band < 1) band = 1;
    int rc = 0;
    for (int r = 0; r < h && rc == 0; r += band) {
        const int n = r + band < h ? band : h - r;
        rc = isx_png_stream_write(s, rgb + stride * r, n);
    }
    // close always finalizes and fcloses the memstream (flushing mem/mlen);
    // a write failure is the root cause — keep its message over close's
    char saved[sizeof(g_err)];
    if (rc != 0) std::memcpy(saved, g_err, sizeof(saved));
    if (isx_png_stream_close(s) != 0 || rc != 0) {
        if (rc != 0) std::memcpy(g_err, saved, sizeof(g_err));
        std::free(mem);
        return 1;
    }
    *out = reinterpret_cast<uint8_t*>(mem);
    *out_len = mlen;
    return 0;
}

#endif  // ISX_HAVE_LIBDEFLATE

// -------------------------------------------------- JPEG (streaming writer)
//
// Scanline-incremental twin of the PNG stream writer: same open/write/close
// contract, same overlap story (device readback hides under the DCT+huffman
// CPU work).  Output bytes are identical to isx_encode_jpeg at equal quality.

struct JpegStream {
    FILE* f;
    jpeg_compress_struct cinfo;
    JpegErr jerr;
    int w, h, written;
};

void* isx_jpeg_stream_open(const char* path, int w, int h, int quality) {
    // volatile: must survive the longjmp back to the setjmp below
    JpegStream* volatile s =
        static_cast<JpegStream*>(std::calloc(1, sizeof(JpegStream)));
    if (!s) { set_err("oom"); return nullptr; }
    s->f = std::fopen(path, "wb");
    if (!s->f) { set_err("jpeg-stream: fopen failed"); std::free(s);
                 return nullptr; }
    s->cinfo.err = jpeg_std_error(&s->jerr.mgr);
    s->jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(s->jerr.jump)) {
        if (!g_err[0]) set_err("jpeg-stream: init failed");
        jpeg_destroy_compress(&s->cinfo);
        std::fclose(s->f);
        std::free(const_cast<JpegStream*>(s));
        return nullptr;
    }
    jpeg_create_compress(&s->cinfo);
    jpeg_stdio_dest(&s->cinfo, s->f);
    s->cinfo.image_width = static_cast<JDIMENSION>(w);
    s->cinfo.image_height = static_cast<JDIMENSION>(h);
    s->cinfo.input_components = 3;
    s->cinfo.in_color_space = JCS_RGB;
    jpeg_set_defaults(&s->cinfo);
    jpeg_set_quality(&s->cinfo, quality, TRUE);
    jpeg_start_compress(&s->cinfo, TRUE);
    s->w = w;
    s->h = h;
    s->written = 0;
    return const_cast<JpegStream*>(s);
}

int isx_jpeg_stream_write(void* handle, const uint8_t* rgb, int nrows) {
    JpegStream* s = static_cast<JpegStream*>(handle);
    if (!s) { set_err("jpeg-stream: bad handle"); return 1; }
    if (nrows < 0 || s->written + nrows > s->h) {
        set_err("jpeg-stream: row overflow");
        return 1;
    }
    if (setjmp(s->jerr.jump)) {
        if (!g_err[0]) set_err("jpeg-stream: write error");
        return 1;
    }
    const size_t stride = static_cast<size_t>(s->w) * 3;
    int y = 0;
    while (y < nrows) {
        JSAMPROW rows[8];
        int n = 0;
        for (; n < 8 && y + n < nrows; ++n)
            rows[n] = const_cast<uint8_t*>(rgb) + (y + n) * stride;
        jpeg_write_scanlines(&s->cinfo, rows, static_cast<JDIMENSION>(n));
        y += n;
    }
    s->written += nrows;
    return 0;
}

int isx_jpeg_stream_close(void* handle) {
    JpegStream* s = static_cast<JpegStream*>(handle);
    if (!s) { set_err("jpeg-stream: bad handle"); return 1; }
    int rc = 0;
    if (setjmp(s->jerr.jump)) {
        if (!g_err[0]) set_err("jpeg-stream: finalize error");
        rc = 1;
    } else if (s->written == s->h) {
        jpeg_finish_compress(&s->cinfo);
    } else {
        set_err("jpeg-stream: closed before all rows were written");
        rc = 1;
    }
    jpeg_destroy_compress(&s->cinfo);
    if (s->f && std::fclose(s->f) != 0 && rc == 0) {
        set_err("jpeg-stream: fclose failed");
        rc = 1;
    }
    std::free(s);
    return rc;
}

}  // extern "C"

// ---------------------------------------------------------------- PNG (MT)
//
// Multi-threaded PNG encoder (pigz-style): row strips are filtered and
// deflated independently as raw streams joined by full flushes; the zlib
// wrapper (header + combined adler32) and the PNG container are assembled by
// hand.  Filters may reference the previous RAW row across strip boundaries
// (reconstruction is lossless), only the deflate window resets per strip —
// costing ~1% size for near-linear thread scaling.

extern "C" {

struct PngStrip {
    std::vector<uint8_t> filtered;   // (1 filter byte + w*3) per row
    std::vector<uint8_t> deflated;   // raw deflate, Z_FULL_FLUSH-terminated
    uLong adler = 1;
    int rc = 0;
};

static void filter_and_deflate(const uint8_t* rgb, int w,
                               int row_lo, int row_hi, int level,
                               PngStrip* out) {
    const size_t stride = static_cast<size_t>(w) * 3;
    out->filtered.resize((stride + 1) * (row_hi - row_lo));
    // Up against the previous raw row (crossing strip boundaries), Sub for
    // the first canvas row — same fixed choice as the fast/libpng paths
    png_filter_rows(rgb + row_lo * stride,
                    row_lo > 0 ? rgb + (row_lo - 1) * stride : nullptr,
                    stride, row_hi - row_lo, out->filtered.data());
    out->adler = adler32(1L, out->filtered.data(),
                         static_cast<uInt>(out->filtered.size()));

    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    // raw deflate (windowBits -15): strips join into one zlib stream
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK) {
        out->rc = 1;
        return;
    }
    out->deflated.resize(deflateBound(&zs, out->filtered.size()) + 16);
    zs.next_in = out->filtered.data();
    zs.avail_in = static_cast<uInt>(out->filtered.size());
    zs.next_out = out->deflated.data();
    zs.avail_out = static_cast<uInt>(out->deflated.size());
    int rc = deflate(&zs, Z_FULL_FLUSH);   // ends at a byte boundary
    if (rc != Z_OK && rc != Z_BUF_ERROR) out->rc = 2;
    out->deflated.resize(zs.total_out);
    deflateEnd(&zs);
    out->filtered.clear();
    out->filtered.shrink_to_fit();
}

// Encode RGB8 to PNG using `threads` parallel deflate strips.
int isx_encode_png_mt(const uint8_t* rgb, int w, int h, int level,
                      int threads, uint8_t** out, size_t* out_len) {
    *out = nullptr;
    if (threads < 1) threads = 1;
    if (threads > h) threads = h;
    const int per = (h + threads - 1) / threads;
    std::vector<PngStrip> strips(threads);
    {
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t) {
            int lo = t * per, hi = lo + per < h ? lo + per : h;
            if (lo >= hi) { strips[t].rc = -1; continue; }
            pool.emplace_back(filter_and_deflate, rgb, w, lo, hi, level,
                              &strips[t]);
        }
        for (auto& th : pool) th.join();
    }
    size_t zlen = 2;                      // zlib header
    uLong adler = 1;                      // running adler over filtered bytes
    const size_t stride1 = static_cast<size_t>(w) * 3 + 1;
    for (int t = 0; t < threads; ++t) {
        if (strips[t].rc > 0) { set_err("png-mt: deflate failed"); return 1; }
        if (strips[t].rc < 0) continue;
        zlen += strips[t].deflated.size();
        int lo = t * per, hi = lo + per < h ? lo + per : h;
        adler = adler32_combine(adler, strips[t].adler,
                                static_cast<z_off_t>(stride1 * (hi - lo)));
    }
    zlen += 2 /* final empty block */ + 4 /* adler */;

    // PNG container: sig + IHDR + one IDAT + IEND
    const size_t total = 8 + (12 + 13) + (12 + zlen) + 12;
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(total));
    if (!buf) { set_err("oom"); return 1; }
    uint8_t* p = buf;
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    std::memcpy(p, sig, 8); p += 8;
    // IHDR
    put_be32(p, 13); p += 4;
    uint8_t* ihdr = p;
    std::memcpy(p, "IHDR", 4); p += 4;
    put_be32(p, static_cast<uint32_t>(w)); p += 4;
    put_be32(p, static_cast<uint32_t>(h)); p += 4;
    *p++ = 8; *p++ = 2; *p++ = 0; *p++ = 0; *p++ = 0;  // 8-bit RGB
    put_be32(p, static_cast<uint32_t>(
        crc32(0L, ihdr, static_cast<uInt>(p - ihdr)))); p += 4;
    // IDAT
    put_be32(p, static_cast<uint32_t>(zlen)); p += 4;
    uint8_t* idat = p;
    std::memcpy(p, "IDAT", 4); p += 4;
    *p++ = 0x78; *p++ = 0xDA;             // zlib header (32K window, best)
    for (int t = 0; t < threads; ++t) {
        if (strips[t].rc < 0) continue;
        std::memcpy(p, strips[t].deflated.data(), strips[t].deflated.size());
        p += strips[t].deflated.size();
    }
    *p++ = 0x03; *p++ = 0x00;             // final empty fixed block (BFINAL)
    put_be32(p, static_cast<uint32_t>(adler)); p += 4;
    put_be32(p, static_cast<uint32_t>(
        crc32(0L, idat, static_cast<uInt>(p - idat)))); p += 4;
    // IEND
    put_be32(p, 0); p += 4;
    std::memcpy(p, "IEND", 4);
    put_be32(p + 4, static_cast<uint32_t>(crc32(0L,
        reinterpret_cast<const uint8_t*>("IEND"), 4)));
    p += 8;
    *out = buf;
    *out_len = static_cast<size_t>(p - buf);
    return 0;
}

}  // extern "C"
