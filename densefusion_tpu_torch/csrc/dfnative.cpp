// dfnative — native host-side data-plane kernels for densefusion_tpu_torch.
//
// The device path is PyTorch with hand-written CUDA kernels (csrc/*.cu);
// this library owns the host-side per-sample hot loop (the role CUDA/C
// served in the reference's data+kernel plane): mask pixel selection, depth
// back-projection, fused image normalize+resize, choose-index remapping,
// PNG decode, color jitter, pixel noise and the label scans. Called from
// Python via ctypes on raw numpy buffers (zero-copy); the loader's workers
// scale on few-core hosts where the pure-numpy path would starve the card.
// The arithmetic is that of the JAX package's runtime/dfnative.cpp, so the
// two libraries give the same bytes.
//
// Build: ops/build.py build_host (g++ -O3 -fPIC -shared -std=c++17 ... -lz).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// splitmix64 — deterministic, seedable RNG for subsampling
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t* s) {
    uint64_t z = (*s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

// Collect flat indices of nonzero mask pixels; uniformly subsample without
// replacement to num_points (sorted), or wrap-pad when fewer. Returns the
// number of true mask pixels found (0 => caller emits an invalid sample).
int64_t df_choose_pixels(const uint8_t* mask, int64_t n, int64_t num_points,
                         uint64_t seed, int64_t* out) {
    // first pass: count
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) count += (mask[i] != 0);
    if (count == 0) return 0;

    if (count <= num_points) {
        int64_t k = 0;
        for (int64_t i = 0; i < n && k < count; ++i)
            if (mask[i]) out[k++] = i;
        for (int64_t i = count; i < num_points; ++i)
            out[i] = out[i % count];  // wrap-pad (datasets/ycb/dataset.py:184)
        return count;
    }
    // reservoir sample num_points of count indices, then sort
    uint64_t s = seed ? seed : 0x1234567ULL;
    int64_t seen = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (!mask[i]) continue;
        if (seen < num_points) {
            out[seen] = i;
        } else {
            uint64_t j = splitmix64(&s) % (uint64_t)(seen + 1);
            if ((int64_t)j < num_points) out[j] = i;
        }
        ++seen;
    }
    std::sort(out, out + num_points);
    return count;
}

// Pinhole back-projection of selected pixels. depth is float32 raw units;
// rows/cols absolute pixel coords; out (n, 3) xyz in meters.
void df_backproject(const float* depth, const int64_t* rows,
                    const int64_t* cols, int64_t n, float fx, float fy,
                    float cx, float cy, float depth_scale, float unit_scale,
                    float* out) {
    const float inv_fx = 1.0f / fx, inv_fy = 1.0f / fy;
    const float inv_ds = 1.0f / depth_scale;
    for (int64_t i = 0; i < n; ++i) {
        float z = depth[i] * inv_ds;
        out[3 * i + 0] = ((float)cols[i] - cx) * z * inv_fx * unit_scale;
        out[3 * i + 1] = ((float)rows[i] - cy) * z * inv_fy * unit_scale;
        out[3 * i + 2] = z * unit_scale;
    }
}

// Fused uint8 crop -> ImageNet-normalized, bilinearly-resized float32.
// src: (h, w, 3) uint8; dst: (oh, ow, 3) f32. Half-pixel convention matching
// data/augment.py:resize_bilinear_np. mean/std are the RAW-0-255 reference
// normalization constants (SURVEY.md §2.4).
// Shared resize core: the per-output-column source offsets and lerp weights
// are invariant over rows, so they are computed once into a small LUT
// (recomputing them per pixel was ~1/3 of the kernel time).
extern "C++" template <typename T>
void normalize_resize_impl(const T* src, int64_t h, int64_t w,
                                  float* dst, int64_t oh, int64_t ow,
                                  const float* mean, const float* stdv) {
    const float inv_std[3] = {1.0f / stdv[0], 1.0f / stdv[1], 1.0f / stdv[2]};
    std::vector<int64_t> x0(ow), x1(ow);
    std::vector<float> wx(ow);
    for (int64_t ox = 0; ox < ow; ++ox) {
        float fx = ((float)ox + 0.5f) * (float)w / (float)ow - 0.5f;
        fx = std::min(std::max(fx, 0.0f), (float)(w - 1));
        x0[ox] = (int64_t)fx;
        x1[ox] = std::min(x0[ox] + 1, w - 1);
        wx[ox] = fx - (float)x0[ox];
    }
    for (int64_t oy = 0; oy < oh; ++oy) {
        float fy = ((float)oy + 0.5f) * (float)h / (float)oh - 0.5f;
        fy = std::min(std::max(fy, 0.0f), (float)(h - 1));
        const int64_t y0 = (int64_t)fy;
        const int64_t y1 = std::min(y0 + 1, h - 1);
        const float wy = fy - (float)y0;
        const float omy = 1.0f - wy;
        const T* row0 = src + 3 * y0 * w;
        const T* row1 = src + 3 * y1 * w;
        float* orow = dst + 3 * oy * ow;
        for (int64_t ox = 0; ox < ow; ++ox) {
            const float wxx = wx[ox], omx = 1.0f - wxx;
            const float waa = omy * omx, wab = omy * wxx;
            const float wca = wy * omx, wcd = wy * wxx;
            const T* a = row0 + 3 * x0[ox];
            const T* b = row0 + 3 * x1[ox];
            const T* c = row1 + 3 * x0[ox];
            const T* d = row1 + 3 * x1[ox];
            float* o = orow + 3 * ox;
            for (int ch = 0; ch < 3; ++ch) {
                float v = (float)a[ch] * waa + (float)b[ch] * wab
                        + (float)c[ch] * wca + (float)d[ch] * wcd;
                o[ch] = (v - mean[ch]) * inv_std[ch];
            }
        }
    }
}

void df_normalize_resize(const uint8_t* src, int64_t h, int64_t w,
                         float* dst, int64_t oh, int64_t ow,
                         const float* mean, const float* stdv) {
    normalize_resize_impl(src, h, w, dst, oh, ow, mean, stdv);
}

// float32 variant (post-augmentation images are float)
void df_normalize_resize_f32(const float* src, int64_t h, int64_t w,
                             float* dst, int64_t oh, int64_t ow,
                             const float* mean, const float* stdv) {
    normalize_resize_impl(src, h, w, dst, oh, ow, mean, stdv);
}

// Remap flat choose indices from a (crop_h, crop_w) grid to the nearest
// pixels of the (out_h, out_w) resized grid (geometry/bbox.py semantics).
void df_remap_choose(const int64_t* choose, int64_t n, int64_t crop_h,
                     int64_t crop_w, int64_t out_h, int64_t out_w,
                     int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t r = choose[i] / crop_w;
        int64_t c = choose[i] % crop_w;
        float nr = ((float)r + 0.5f) * (float)out_h / (float)crop_h - 0.5f;
        float nc = ((float)c + 0.5f) * (float)out_w / (float)crop_w - 0.5f;
        int64_t rr = (int64_t)std::lround(std::min(
            std::max(nr, 0.0f), (float)(out_h - 1)));
        int64_t cc = (int64_t)std::lround(std::min(
            std::max(nc, 0.0f), (float)(out_w - 1)));
        out[i] = rr * out_w + cc;
    }
}

// ---------------------------------------------------------------------------
// PNG decoder (zlib inflate + scanline unfilter). Covers the dataset formats:
// 8-bit gray / RGB / RGBA / palette and 16-bit gray (depth maps), not
// interlaced. Replaces PIL in the loader hot path (the reference loads every
// frame with PIL, datasets/ycb/dataset.py:94-101); returns <0 so Python can
// fall back to PIL on anything unsupported.
// ---------------------------------------------------------------------------

static inline uint32_t be32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// Parse IHDR only: fills w, h, bit_depth, color_type. Returns 0 or <0.
int df_png_info(const uint8_t* data, int64_t size, int64_t* w, int64_t* h,
                int64_t* bit_depth, int64_t* color_type) {
    static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    if (size < 33 || std::memcmp(data, sig, 8) != 0) return -1;
    if (std::memcmp(data + 12, "IHDR", 4) != 0) return -2;
    *w = be32(data + 16);
    *h = be32(data + 20);
    *bit_depth = data[24];
    *color_type = data[25];
    if (data[28] != 0) return -3;  // interlaced: unsupported
    return 0;
}

static inline int paeth(int a, int b, int c) {
    int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
        pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return (pb <= pc) ? b : c;
}

// Decode into out (row-major, native byte order for 16-bit). out must hold
// h*w*channels samples where channels = 3 for palette (expanded), else the
// color type's channel count. Returns 0 on success.
int df_png_decode(const uint8_t* data, int64_t size, uint8_t* out) {
    int64_t w, h, depth, ctype;
    int rc = df_png_info(data, size, &w, &h, &depth, &ctype);
    if (rc != 0) return rc;
    int channels;
    switch (ctype) {
        case 0: channels = 1; break;   // gray
        case 2: channels = 3; break;   // rgb
        case 3: channels = 1; break;   // palette: raw indices (PIL P-mode
                                       // np.array parity — no expansion)
        case 4: channels = 2; break;   // gray + alpha
        case 6: channels = 4; break;   // rgba
        default: return -4;
    }
    if (depth != 8 && !(depth == 16 && ctype == 0)) return -5;
    const int bpp = channels * (depth / 8);      // filter byte distance
    const int64_t stride = (int64_t)w * bpp;     // bytes per scanline

    // gather IDAT
    std::vector<const uint8_t*> idat;
    std::vector<int64_t> idat_len;
    int64_t pos = 8;
    while (pos + 12 <= size) {
        uint32_t len = be32(data + pos);
        const uint8_t* type = data + pos + 4;
        const uint8_t* body = data + pos + 8;
        if ((int64_t)(pos + 12 + len) > size) return -6;
        if (!std::memcmp(type, "IDAT", 4)) {
            idat.push_back(body);
            idat_len.push_back(len);
        } else if (!std::memcmp(type, "IEND", 4)) {
            break;
        }
        pos += 12 + len;
    }
    if (idat.empty()) return -7;

    // inflate the filtered image
    std::vector<uint8_t> raw((size_t)h * (stride + 1));
    z_stream zs{};
    if (inflateInit(&zs) != Z_OK) return -9;
    zs.next_out = raw.data();
    zs.avail_out = (uInt)raw.size();
    int zrc = Z_OK;
    for (size_t i = 0; i < idat.size() && zrc != Z_STREAM_END; ++i) {
        zs.next_in = const_cast<uint8_t*>(idat[i]);
        zs.avail_in = (uInt)idat_len[i];
        zrc = inflate(&zs, Z_NO_FLUSH);
        if (zrc != Z_OK && zrc != Z_STREAM_END) { inflateEnd(&zs); return -10; }
    }
    bool complete = (zs.total_out == raw.size());
    inflateEnd(&zs);
    if (!complete) return -11;

    // unfilter scanlines in place (into a defiltered buffer)
    std::vector<uint8_t> img((size_t)h * stride);
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = raw.data() + (size_t)y * (stride + 1);
        uint8_t* dst = img.data() + (size_t)y * stride;
        const uint8_t filter = src[0];
        ++src;
        switch (filter) {
            case 0:
                std::memcpy(dst, src, stride);
                break;
            case 1:  // Sub
                for (int64_t i = 0; i < stride; ++i)
                    dst[i] = src[i] + (i >= bpp ? dst[i - bpp] : 0);
                break;
            case 2:  // Up
                for (int64_t i = 0; i < stride; ++i)
                    dst[i] = src[i] + (prev ? prev[i] : 0);
                break;
            case 3:  // Average
                for (int64_t i = 0; i < stride; ++i) {
                    int a = i >= bpp ? dst[i - bpp] : 0;
                    int b = prev ? prev[i] : 0;
                    dst[i] = src[i] + (uint8_t)((a + b) >> 1);
                }
                break;
            case 4:  // Paeth
                for (int64_t i = 0; i < stride; ++i) {
                    int a = i >= bpp ? dst[i - bpp] : 0;
                    int b = prev ? prev[i] : 0;
                    int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    dst[i] = src[i] + (uint8_t)paeth(a, b, c);
                }
                break;
            default:
                return -12;
        }
        prev = dst;
    }

    if (depth == 16) {  // big-endian -> native u16
        uint16_t* o16 = reinterpret_cast<uint16_t*>(out);
        for (int64_t i = 0; i < (int64_t)w * h; ++i)
            o16[i] = (uint16_t)((img[2 * i] << 8) | img[2 * i + 1]);
    } else {
        std::memcpy(out, img.data(), img.size());
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Fused ColorJitter (torchvision semantics; data/augment.py:color_jitter).
// ops: sequence of {0: brightness, 1: contrast, 2: saturation, 3: hue};
// factors indexed by op id (hue factor is the shift in [-0.05, 0.05]).
// src uint8 (h, w, 3) -> dst float32 (h, w, 3), clipped to [0, 255].
// ---------------------------------------------------------------------------
// One pixel's hue shift (HSV round trip) in 0-255 space with no
// normalization multiply, a single division, no fmod and a permutation
// table instead of the sector switch. Uses v·s = delta, so
// p = v−delta, q = v−delta·fr, t = v−delta·(1−fr) — algebraically equal to
// the textbook v(1−s), v(1−s·fr), v(1−s(1−fr)).
static const uint8_t HUE_PERM[6][3] = {   // indices into {v, p, q, t}
    {0, 3, 1}, {2, 0, 1}, {1, 0, 3}, {1, 2, 0}, {3, 1, 0}, {0, 1, 2}};

static inline void jitter_hue_px(float& r, float& g, float& b,
                                 float shift6) {
    const float maxc = std::max(r, std::max(g, b));
    const float minc = std::min(r, std::min(g, b));
    const float delta = maxc - minc;
    const float inv_d = 1.0f / std::max(delta, 255.0f * 1e-12f);
    float hh;                            // raw hue in [0, 6)
    if (maxc == r) {
        hh = (g - b) * inv_d;            // in [-1, 1]
        if (hh < 0.0f) hh += 6.0f;
    } else if (maxc == g) {
        hh = (b - r) * inv_d + 2.0f;
    } else {
        hh = (r - g) * inv_d + 4.0f;
    }
    hh += shift6;                        // shift6 = 6 * hue shift, |.| < 6
    if (hh >= 6.0f) hh -= 6.0f;
    if (hh < 0.0f) hh += 6.0f;
    const int i = std::min((int)hh, 5);
    const float fr = hh - (float)i;
    const float arr[4] = {maxc, maxc - delta, maxc - delta * fr,
                          maxc - delta * (1.0f - fr)};
    r = arr[HUE_PERM[i][0]];
    g = arr[HUE_PERM[i][1]];
    b = arr[HUE_PERM[i][2]];
}

// Fused ColorJitter, register-resident: ops are applied sequentially to each
// pixel in ONE pass (two when contrast follows hue) instead of one
// whole-image pass per op. The contrast op's mean-gray term is derived
// analytically: brightness scales luminance by its factor and saturation
// preserves it exactly (the 0.299/0.587/0.114 blend weights sum to 1), so
// mean_before_contrast = mean_gray(src) * prod(brightness factors applied
// earlier). Hue does NOT preserve luminance — when contrast follows hue the
// post-hue mean is accumulated during pass 1 and contrast+rest run as a
// cheap second pass using the measured mean.
// Brightness/contrast/saturation are all channel-symmetric affine maps of
// (pixel, per-pixel gray, 1): px' = a·px + b·gray0 + c where gray0 is the
// luminance of the PHASE INPUT pixel. They compose into a single (a, b, c):
//   brightness f:  (a, b, c) -> (fa, fb, fc)
//   saturation f:  px' = f·px + (1−f)·gray(state); gray(state) = (a+b)·gray0
//                  + c (the 0.299/0.587/0.114 weights sum to 1), so
//                  (a, b, c) -> (fa, fb + (1−f)(a+b), c)
//   contrast f:    px' = f·px + (1−f)·mean(gray(state)) with
//                  mean(gray(state)) = (a+b)·mean_gray0 + c, so
//                  (a, b, c) -> (fa, fb, fc + (1−f)((a+b)·mean_gray0 + c))
struct JitterAffine {
    float a = 1.0f, b = 0.0f, c = 0.0f;
    bool needs_mean = false;    // a contrast op referenced mean_gray0

    void fold(const int32_t* ops, int64_t k0, int64_t k1,
              const float* factors, float mean_g0) {
        for (int64_t k = k0; k < k1; ++k) {
            const float f = factors[ops[k]];
            switch (ops[k]) {
                case 0: a *= f; b *= f; c *= f; break;
                case 1:
                    needs_mean = true;
                    c = f * c + (1.0f - f) * ((a + b) * mean_g0 + c);
                    a *= f; b *= f;
                    break;
                case 2: {
                    const float nb = f * b + (1.0f - f) * (a + b);
                    a *= f; b = nb;
                    break;
                }
                default: break;   // hue handled by the caller's phase split
            }
        }
    }
};

static inline float gray_of(float r, float g, float b) {
    return 0.299f * r + 0.587f * g + 0.114f * b;
}

// Fused ColorJitter: the linear ops around the (at most one) hue op are
// composed into per-phase affine maps, so the whole jitter is ONE tight
// pass when there is no hue, and a hue pass plus (only if linear ops follow
// the hue) one affine pass otherwise — versus one whole-image pass per op.
// The contrast op's mean-gray term is exact for the pre-hue phase
// (mean_gray scales with earlier brightness, is preserved by saturation);
// hue does NOT preserve luminance, so a contrast after hue uses the mean
// accumulated during the hue pass.
void df_color_jitter(const uint8_t* src, int64_t h, int64_t w,
                     const int32_t* ops, int64_t n_ops,
                     const float* factors, float* dst) {
    const int64_t n = h * w;
    int64_t hue_pos = -1;
    for (int64_t k = 0; k < n_ops; ++k)
        if (ops[k] == 3) hue_pos = k;

    // phase-1 affine (ops before hue, or all ops when no hue)
    const int64_t split = hue_pos < 0 ? n_ops : hue_pos;
    JitterAffine af1;
    {   // probe whether phase 1 needs the source gray mean
        JitterAffine probe;
        probe.fold(ops, 0, split, factors, 0.0f);
        float mean_g = 0.0f;
        if (probe.needs_mean) {
            double acc = 0.0;
            for (int64_t i = 0; i < n; ++i)
                acc += gray_of((float)src[3 * i], (float)src[3 * i + 1],
                               (float)src[3 * i + 2]);
            mean_g = (float)(acc / (double)n);
        }
        af1.fold(ops, 0, split, factors, mean_g);
    }

    if (hue_pos < 0) {   // single affine pass, vectorizes
        const float a = af1.a, b = af1.b, c = af1.c;
        for (int64_t i = 0; i < n; ++i) {
            const float r = (float)src[3 * i];
            const float g = (float)src[3 * i + 1];
            const float bl = (float)src[3 * i + 2];
            const float gr = gray_of(r, g, bl) * b + c;
            dst[3 * i] = std::min(std::max(a * r + gr, 0.0f), 255.0f);
            dst[3 * i + 1] = std::min(std::max(a * g + gr, 0.0f), 255.0f);
            dst[3 * i + 2] = std::min(std::max(a * bl + gr, 0.0f), 255.0f);
        }
        return;
    }

    // hue present: pass 1 = affine1 + hue (+ gray accumulation for a later
    // contrast); pass 2 = affine over the hue output, skipped if identity
    const float shift6 = 6.0f * factors[3];
    const bool tail = hue_pos + 1 < n_ops;
    double acc2 = 0.0;
    {
        const float a = af1.a, b = af1.b, c = af1.c;
        for (int64_t i = 0; i < n; ++i) {
            float r = (float)src[3 * i];
            float g = (float)src[3 * i + 1];
            float bl = (float)src[3 * i + 2];
            const float gr = gray_of(r, g, bl) * b + c;
            r = a * r + gr; g = a * g + gr; bl = a * bl + gr;
            jitter_hue_px(r, g, bl, shift6);
            if (tail) {
                acc2 += gray_of(r, g, bl);
            } else {
                r = std::min(std::max(r, 0.0f), 255.0f);
                g = std::min(std::max(g, 0.0f), 255.0f);
                bl = std::min(std::max(bl, 0.0f), 255.0f);
            }
            dst[3 * i] = r; dst[3 * i + 1] = g; dst[3 * i + 2] = bl;
        }
    }
    if (!tail) return;

    JitterAffine af2;
    af2.fold(ops, hue_pos + 1, n_ops, factors, (float)(acc2 / (double)n));
    const float a = af2.a, b = af2.b, c = af2.c;
    for (int64_t i = 0; i < n; ++i) {
        const float r = dst[3 * i];
        const float g = dst[3 * i + 1];
        const float bl = dst[3 * i + 2];
        const float gr = gray_of(r, g, bl) * b + c;
        dst[3 * i] = std::min(std::max(a * r + gr, 0.0f), 255.0f);
        dst[3 * i + 1] = std::min(std::max(a * g + gr, 0.0f), 255.0f);
        dst[3 * i + 2] = std::min(std::max(a * bl + gr, 0.0f), 255.0f);
    }
}

// Additive gaussian pixel noise via Box-Muller on splitmix64 — the synthetic-
// frame augmentation (datasets/ycb/dataset.py:166-167) applied crop-only.
void df_gaussian_noise(float* img, int64_t n, float scale, uint64_t seed) {
    uint64_t s = seed ? seed : 0xdeadbeefULL;
    const float TWO_PI = 6.28318530717958647692f;
    for (int64_t i = 0; i < n; i += 2) {
        float u1 = (float)((splitmix64(&s) >> 11) * (1.0 / 9007199254740992.0));
        float u2 = (float)((splitmix64(&s) >> 11) * (1.0 / 9007199254740992.0));
        u1 = std::max(u1, 1e-12f);
        float r = std::sqrt(-2.0f * std::log(u1)) * scale;
        img[i] += r * std::cos(TWO_PI * u2);
        if (i + 1 < n) img[i + 1] += r * std::sin(TWO_PI * u2);
    }
}

// ---------------------------------------------------------------------------
// YCB loader hot-path kernels: everything below runs one C pass over the
// frame so the Python thread pool parallelizes for real (numpy held the GIL
// for most of the per-sample time; docs/PERF.md round 2).
// ---------------------------------------------------------------------------

// Histogram of label values over pixels with nonzero depth (the "enough
// valid pixels" object pick, datasets/ycb/dataset.py:141-147, in one pass).
void df_label_depth_hist(const uint8_t* label, const uint16_t* depth,
                         int64_t n, int64_t* counts /*256*/) {
    std::memset(counts, 0, 256 * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i)
        if (depth[i] != 0) ++counts[label[i]];
}

// Apply two front-occluder object masks from another frame's label image:
// out_label = label where the occluders are absent, else 0; front_mask = 1
// where NOT occluded. Returns the surviving nonzero-label pixel count
// (datasets/ycb/dataset.py:116-137 semantics).
int64_t df_apply_front(const uint8_t* label, const uint8_t* f_label,
                       int64_t n, int64_t id0, int64_t id1,
                       uint8_t* out_label, uint8_t* front_mask) {
    int64_t count = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t fl = f_label[i];
        const bool occluded = (fl == id0) | (fl == id1);
        front_mask[i] = !occluded;
        const uint8_t v = occluded ? 0 : label[i];
        out_label[i] = v;
        count += (v != 0);
    }
    return count;
}

// (label == id) object mask, its depth-valid AND, and the tight bbox of the
// label mask. Returns the depth-valid pixel count; bbox (rmin, rmax_excl,
// cmin, cmax_excl) is -1s when the label never appears.
int64_t df_object_mask(const uint8_t* label, const uint16_t* depth,
                       int64_t h, int64_t w, int64_t obj_id,
                       uint8_t* mask_label, uint8_t* mask_valid,
                       int64_t* bbox) {
    int64_t count = 0;
    int64_t rmin = h, rmax = -1, cmin = w, cmax = -1;
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* lrow = label + r * w;
        const uint16_t* drow = depth + r * w;
        uint8_t* ml = mask_label + r * w;
        uint8_t* mv = mask_valid + r * w;
        for (int64_t c = 0; c < w; ++c) {
            const bool is_obj = lrow[c] == (uint8_t)obj_id;
            ml[c] = is_obj;
            const bool valid = is_obj & (drow[c] != 0);
            mv[c] = valid;
            count += valid;
            if (is_obj) {
                rmin = std::min(rmin, r);
                rmax = std::max(rmax, r);
                cmin = std::min(cmin, c);
                cmax = std::max(cmax, c);
            }
        }
    }
    if (rmax < 0) {
        bbox[0] = bbox[1] = bbox[2] = bbox[3] = -1;
    } else {
        bbox[0] = rmin; bbox[1] = rmax + 1;
        bbox[2] = cmin; bbox[3] = cmax + 1;
    }
    return count;
}

// Fused crop compositing (datasets/ycb/dataset.py:155-164 restricted to the
// consumed window): out = rgb, with `back` behind label==0 pixels and
// `front` where front_mask==0. Null pointers skip a layer.
void df_compose_crop(const uint8_t* rgb, const uint8_t* back,
                     const uint8_t* label, const uint8_t* front,
                     const uint8_t* front_mask, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* src = rgb;
        if (back != nullptr && label[i] == 0) src = back;
        if (front != nullptr && front_mask[i] == 0) src = front;
        out[3 * i] = src[3 * i];
        out[3 * i + 1] = src[3 * i + 1];
        out[3 * i + 2] = src[3 * i + 2];
    }
}

// ---------------------------------------------------------------------------
// v4: fused single-pass frame scans. The v3 kernels still took 2-3 full
// 480x640 passes per sample (hist, occluders, object mask); these fold the
// per-id statistics into ONE pass and shrink the mask kernel to the consumed
// bbox window, which is what the sample actually reads (data/common.py:92).
// ---------------------------------------------------------------------------

// Per-id depth-valid pixel counts AND per-id tight bboxes of `label` in one
// pass. counts: (256,) int64; bbox: (256, 4) int64 (rmin, rmax_excl, cmin,
// cmax_excl), -1s for ids that never appear. id 0 (background) is skipped:
// counts[0] and bbox[0] are 0/-1s regardless of background pixels.
struct HistBBox {
    int64_t counts[256];
    int64_t rmin[256], rmax[256], cmin[256], cmax[256];
    int64_t nonzero = 0;

    HistBBox(int64_t h, int64_t w) {
        std::memset(counts, 0, sizeof(counts));
        for (int i = 0; i < 256; ++i) { rmin[i] = h; rmax[i] = -1;
                                        cmin[i] = w; cmax[i] = -1; }
    }

    // Scan one label row; frames are mostly background, so 8-byte
    // zero-words are skipped with a single compare.
    inline void row(const uint8_t* lrow, const uint16_t* drow, int64_t r,
                    int64_t w) {
        int64_t c = 0;
        for (; c + 8 <= w; c += 8) {
            uint64_t word;
            std::memcpy(&word, lrow + c, 8);
            if (word == 0) continue;
            for (int64_t j = c; j < c + 8; ++j) px(lrow[j], drow[j], r, j);
        }
        for (; c < w; ++c) px(lrow[c], drow[c], r, c);
    }

    inline void px(uint8_t v, uint16_t d, int64_t r, int64_t c) {
        if (!v) return;
        ++nonzero;
        counts[v] += (d != 0);
        if (r < rmin[v]) rmin[v] = r;
        rmax[v] = r;                          // rows scan in order
        if (c < cmin[v]) cmin[v] = c;
        if (c > cmax[v]) cmax[v] = c;
    }

    void finish(int64_t* out_counts, int64_t* out_bbox) const {
        std::memcpy(out_counts, counts, sizeof(counts));
        for (int i = 0; i < 256; ++i) {
            if (rmax[i] < 0) {
                out_bbox[4 * i] = out_bbox[4 * i + 1] = out_bbox[4 * i + 2] =
                    out_bbox[4 * i + 3] = -1;
            } else {
                out_bbox[4 * i] = rmin[i]; out_bbox[4 * i + 1] = rmax[i] + 1;
                out_bbox[4 * i + 2] = cmin[i];
                out_bbox[4 * i + 3] = cmax[i] + 1;
            }
        }
    }
};

void df_label_hist_bbox(const uint8_t* label, const uint16_t* depth,
                        int64_t h, int64_t w, int64_t* counts,
                        int64_t* bbox) {
    HistBBox hb(h, w);
    for (int64_t r = 0; r < h; ++r)
        hb.row(label + r * w, depth + r * w, r, w);
    hb.finish(counts, bbox);
}

// df_apply_front fused with df_label_hist_bbox over the occluded label:
// one pass produces the occluded label, the front mask, the per-id
// depth-valid counts and the per-id bboxes. Returns the surviving
// nonzero-label pixel count (the accept test of dataset.py:116-137).
int64_t df_apply_front_hist_bbox(const uint8_t* label, const uint8_t* f_label,
                                 const uint16_t* depth, int64_t h, int64_t w,
                                 int64_t id0, int64_t id1,
                                 uint8_t* out_label, uint8_t* front_mask,
                                 int64_t* counts, int64_t* bbox) {
    const int64_t n = h * w;
    const uint8_t u0 = (uint8_t)id0, u1 = (uint8_t)id1;
    // pass A: occlusion select (branchless, auto-vectorizes)
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t fl = f_label[i];
        const uint8_t not_occ = (fl != u0) & (fl != u1);
        front_mask[i] = not_occ;
        out_label[i] = not_occ ? label[i] : 0;
    }
    // pass B: hist+bbox scan of the (cache-hot) occluded label
    HistBBox hb(h, w);
    for (int64_t r = 0; r < h; ++r)
        hb.row(out_label + r * w, depth + r * w, r, w);
    hb.finish(counts, bbox);
    return hb.nonzero;
}

// Depth-valid object mask of the window rows [r0, r1) x cols [c0, c1) only;
// out is the (r1-r0, c1-c0) window buffer. The full-frame mask of
// df_object_mask is never read outside the snapped crop window.
void df_object_mask_window(const uint8_t* label, const uint16_t* depth,
                           int64_t w, int64_t r0, int64_t r1, int64_t c0,
                           int64_t c1, int64_t obj_id, uint8_t* out) {
    const int64_t ww = c1 - c0;
    for (int64_t r = r0; r < r1; ++r) {
        const uint8_t* lrow = label + r * w + c0;
        const uint16_t* drow = depth + r * w + c0;
        uint8_t* orow = out + (r - r0) * ww;
        for (int64_t c = 0; c < ww; ++c)
            orow[c] = (lrow[c] == (uint8_t)obj_id) & (drow[c] != 0);
    }
}

// img[i] += scale * pool[i] — the noise-pool fast path for the synthetic
// gaussian pixel noise (pool pre-filled with N(0,1); Box-Muller per pixel
// was ~1 ms/sample). Plain stride-1 FMA, auto-vectorizes.
void df_add_scaled(float* img, int64_t n, const float* pool, float scale) {
    for (int64_t i = 0; i < n; ++i) img[i] += scale * pool[i];
}

int df_version() { return 4; }

}  // extern "C"
