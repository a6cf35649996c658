// Host-side DCT ingest codec — native C++ equivalent of the reference's
// libjpeg-turbo / jpeg2dct / OpenCV preprocessing stack (reference
// data/cvfunctional.py:21-74, cvtransforms.py:56-208).
//
// The framework normally runs the codec on-device (data/codec.py); this
// native path exists for the reference's deployment shape — CPU-side
// preprocessing pipelines that overlap with device compute — and for hosts
// feeding multiple accelerators.  Numerics mirror data/codec.py exactly
// (cv2-convention YCrCb with the reference's Cr/Cb swap, bilinear
// half-pixel resize, orthonormal blockwise DCT; the fs-8 JPEG path is the
// bit-exact libjpeg quality-100 integer pipeline of ops/jpegdct.py:
// fixed-point jccolor conversion with the TJPF_BGR-on-RGB channel swap,
// biased h2v2 downsample, islow FDCT, round-half-away quantization by 8).
//
// Build:  make -C native        (produces libdctcodec.so)
// Python binding: dct_cryptonets/data/native.py (ctypes).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// bilinear resize with half-pixel centers (cv2 INTER_LINEAR semantics)
void resize_bilinear(const float* src, int sh, int sw, int c,
                     float* dst, int dh, int dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    int y0 = static_cast<int>(std::floor(fy));
    double wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= sh ? sh - 1 : y0 + 1);
    for (int x = 0; x < dw; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      int x0 = static_cast<int>(std::floor(fx));
      double wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= sw ? sw - 1 : x0 + 1);
      for (int ch = 0; ch < c; ++ch) {
        double v00 = src[(y0c * sw + x0c) * c + ch];
        double v01 = src[(y0c * sw + x1c) * c + ch];
        double v10 = src[(y1c * sw + x0c) * c + ch];
        double v11 = src[(y1c * sw + x1c) * c + ch];
        dst[(y * dw + x) * c + ch] = static_cast<float>(
            (1 - wy) * ((1 - wx) * v00 + wx * v01) +
            wy * ((1 - wx) * v10 + wx * v11));
      }
    }
  }
}

// cv2 INTER_LINEAR on 8U planes, bit-exact (see data/codec.py
// resize_linear_u8_cv): 2^11 fixed-point weights quantized with
// round-half-to-even, int32 horizontal pass, and the 8U-specialized
// vertical combine (((b0*(r0>>4))>>16) + ((b1*(r1>>4))>>16) + 2) >> 2.
void cv2_linear_plan(int src, int dst, std::vector<int>& i0,
                     std::vector<int>& i1, std::vector<int>& a0,
                     std::vector<int>& a1) {
  i0.resize(dst);
  i1.resize(dst);
  a0.resize(dst);
  a1.resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int d = 0; d < dst; ++d) {
    double fx = (d + 0.5) * scale - 0.5;
    int sx = static_cast<int>(std::floor(fx));
    fx -= sx;
    if (sx < 0) { fx = 0.0; sx = 0; }
    if (sx >= src - 1) { fx = 0.0; sx = src - 1; }
    i0[d] = sx;
    i1[d] = sx + 1 < src ? sx + 1 : src - 1;
    a1[d] = static_cast<int>(std::nearbyint(fx * 2048.0));
    a0[d] = static_cast<int>(std::nearbyint((1.0 - fx) * 2048.0));
  }
}

void resize_linear_u8_cv(const float* src, int sh, int sw, float* dst,
                         int dh, int dw) {
  std::vector<int> j0, j1, c0, c1, i0, i1, b0, b1;
  cv2_linear_plan(sw, dw, j0, j1, c0, c1);
  cv2_linear_plan(sh, dh, i0, i1, b0, b1);
  std::vector<int32_t> rows(static_cast<size_t>(sh) * dw);
  for (int y = 0; y < sh; ++y)
    for (int x = 0; x < dw; ++x) {
      int p0 = static_cast<int>(src[y * sw + j0[x]]);
      int p1 = static_cast<int>(src[y * sw + j1[x]]);
      rows[y * dw + x] = (p0 * c0[x] + p1 * c1[x]) >> 4;
    }
  for (int y = 0; y < dh; ++y)
    for (int x = 0; x < dw; ++x) {
      int32_t t0 = (b0[y] * rows[i0[y] * dw + x]) >> 16;
      int32_t t1 = (b1[y] * rows[i1[y] * dw + x]) >> 16;
      int v = (t0 + t1 + 2) >> 2;
      dst[y * dw + x] = static_cast<float>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
}

// ---- libjpeg quality-100 integer forward path (fs == 8) -------------------
// Mirrors ops/jpegdct.py (see its docstring for the spec: jccolor.c
// fixed-point color conversion, jcsample.c h2v2 alternating-bias
// downsample, jfdctint.c islow FDCT, jcdctmgr.c round-half-away /8).

inline int32_t descale_j(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t{1} << (n - 1))) >> n);
}

// one islow butterfly pass over 8 values; first pass leaves PASS1_BITS
// scaling, second removes it (CONST_BITS = 13, PASS1_BITS = 2)
void fdct_islow_pass(int32_t* d, int stride, bool first) {
  constexpr int CB = 13, PB = 2;
  const int32_t c0298 = 2446, c0390 = 3196, c0541 = 4433, c0765 = 6270,
                c0899 = 7373, c1175 = 9633, c1501 = 12299, c1847 = 15137,
                c1961 = 16069, c2053 = 16819, c2562 = 20995, c3072 = 25172;
  auto at = [&](int i) -> int32_t& { return d[i * stride]; };
  int64_t tmp0 = at(0) + at(7), tmp7 = at(0) - at(7);
  int64_t tmp1 = at(1) + at(6), tmp6 = at(1) - at(6);
  int64_t tmp2 = at(2) + at(5), tmp5 = at(2) - at(5);
  int64_t tmp3 = at(3) + at(4), tmp4 = at(3) - at(4);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int ds = first ? CB - PB : CB + PB;
  if (first) {
    at(0) = static_cast<int32_t>((tmp10 + tmp11) << PB);
    at(4) = static_cast<int32_t>((tmp10 - tmp11) << PB);
  } else {
    at(0) = descale_j(tmp10 + tmp11, PB);
    at(4) = descale_j(tmp10 - tmp11, PB);
  }
  int64_t z1e = (tmp12 + tmp13) * c0541;
  at(2) = descale_j(z1e + tmp13 * c0765, ds);
  at(6) = descale_j(z1e - tmp12 * c1847, ds);
  int64_t z1 = tmp4 + tmp7, z2 = tmp5 + tmp6;
  int64_t z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  int64_t z5 = (z3 + z4) * c1175;
  int64_t t4 = tmp4 * c0298, t5 = tmp5 * c2053;
  int64_t t6 = tmp6 * c3072, t7 = tmp7 * c1501;
  z1 *= -c0899;
  z2 *= -c2562;
  z3 = z3 * -c1961 + z5;
  z4 = z4 * -c0390 + z5;
  at(7) = descale_j(t4 + z1 + z3, ds);
  at(5) = descale_j(t5 + z2 + z4, ds);
  at(3) = descale_j(t6 + z2 + z3, ds);
  at(1) = descale_j(t7 + z1 + z4, ds);
}

// plane (h, w) int pixel values -> (h/8, w/8, 64) q100 coefficients
void fdct_islow_q100(const float* plane, int h, int w, float* out) {
  int nh = h / 8, nw = w / 8;
  int32_t blk[64];
  for (int bi = 0; bi < nh; ++bi)
    for (int bj = 0; bj < nw; ++bj) {
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j)
          blk[i * 8 + j] = static_cast<int32_t>(
                               plane[(bi * 8 + i) * w + bj * 8 + j]) - 128;
      for (int i = 0; i < 8; ++i) fdct_islow_pass(blk + i * 8, 1, true);
      for (int j = 0; j < 8; ++j) fdct_islow_pass(blk + j, 8, false);
      float* dst = out + (bi * nw + bj) * 64;
      for (int t = 0; t < 64; ++t) {
        int32_t v = blk[t];
        int32_t m = (std::abs(v) + 4) >> 3;   // round half away, /8
        dst[t] = static_cast<float>(v < 0 ? -m : m);
      }
    }
}

// orthonormal DCT basis T (fs x fs), row-major
void dct_basis(int fs, double* T) {
  for (int i = 0; i < fs; ++i)
    for (int j = 0; j < fs; ++j)
      T[i * fs + j] = i == 0 ? 1.0 / std::sqrt(static_cast<double>(fs))
                             : std::sqrt(2.0 / fs) *
                                   std::cos((2 * j + 1) * i * kPi / (2 * fs));
}

// blockwise 2-D DCT of one plane (h, w) -> (h/fs, w/fs, fs*fs)
void blockwise_dct(const float* plane, int h, int w, int fs, bool round_int,
                   const double* T, float* out) {
  int nh = h / fs, nw = w / fs;
  std::vector<double> tmp(fs * fs), tmp2(fs * fs);
  for (int bi = 0; bi < nh; ++bi) {
    for (int bj = 0; bj < nw; ++bj) {
      // T * X
      for (int i = 0; i < fs; ++i)
        for (int j = 0; j < fs; ++j) {
          double acc = 0;
          for (int t = 0; t < fs; ++t)
            acc += T[i * fs + t] *
                   (plane[(bi * fs + t) * w + bj * fs + j] - 128.0);
          tmp[i * fs + j] = acc;
        }
      // (T*X) * T^T
      for (int i = 0; i < fs; ++i)
        for (int j = 0; j < fs; ++j) {
          double acc = 0;
          for (int t = 0; t < fs; ++t) acc += tmp[i * fs + t] * T[j * fs + t];
          tmp2[i * fs + j] = acc;
        }
      float* dst = out + (bi * nw + bj) * fs * fs;
      for (int t = 0; t < fs * fs; ++t)
        dst[t] = round_int ? static_cast<float>(std::nearbyint(tmp2[t]))
                           : static_cast<float>(tmp2[t]);
    }
  }
}

struct Plan {
  int fs, S;                    // filter size, output spatial size
  int n_y, n_cb, n_cr;          // subset sizes
  const int* idx_y;
  const int* idx_cb;
  const int* idx_cr;
  const float* mean;            // (n_y+n_cb+n_cr)
  const float* std;
};

// one image: uint8 RGB (P, P, 3) with P = fs * S -> out (S, S, C)
void ingest_one(const uint8_t* img, const Plan& p, float* out) {
  const int P = p.fs * p.S;
  const int half = P / 2;
  std::vector<float> y(P * P), cb(half * half), cr(half * half);

  if (p.fs == 8) {
    // JPEG path: libjpeg jccolor fixed point (16-bit FIX tables, floor
    // shift) with the reference's TJPF_BGR-on-RGB channel swap — the "R"
    // weight applies to the array's B channel and vice versa — then the
    // jcsample h2v2 downsample with the 1,2,1,2 alternating bias.
    std::vector<float> cbf(P * P), crf(P * P);
    for (int i = 0; i < P * P; ++i) {
      // swapped read: libjpeg's r := array B, b := array R
      int64_t r = img[i * 3 + 2], g = img[i * 3 + 1], b = img[i * 3];
      constexpr int64_t ONE_HALF = int64_t{1} << 15;
      constexpr int64_t CBCR = int64_t{128} << 16;
      int64_t yy = (19595 * r + 38470 * g + 7471 * b + ONE_HALF) >> 16;
      int64_t cbv = (-11059 * r - 21709 * g + 32768 * b + CBCR +
                     ONE_HALF - 1) >> 16;
      int64_t crv = (32768 * r - 27439 * g - 5329 * b + CBCR +
                     ONE_HALF - 1) >> 16;
      y[i] = static_cast<float>(yy);
      cbf[i] = static_cast<float>(cbv);
      crf[i] = static_cast<float>(crv);
    }
    for (int i = 0; i < half; ++i) {
      int bias = 1;                         // restarts at 1 each row
      for (int j = 0; j < half; ++j) {
        auto h2v2 = [&](const std::vector<float>& v) {
          int s = static_cast<int>(v[(2 * i) * P + 2 * j]) +
                  static_cast<int>(v[(2 * i) * P + 2 * j + 1]) +
                  static_cast<int>(v[(2 * i + 1) * P + 2 * j]) +
                  static_cast<int>(v[(2 * i + 1) * P + 2 * j + 1]);
          return static_cast<float>((s + bias) >> 2);
        };
        cb[i * half + j] = h2v2(cbf);
        cr[i * half + j] = h2v2(crf);
        bias ^= 3;                          // 1 -> 2 -> 1 -> ...
      }
    }
  } else {
    // manual path: cv2 YCrCb via its 14-bit fixed-point arithmetic
    // (imgproc color_yuv; see data/codec.py rgb_to_ycrcb_cv); the
    // reference binds Cr to the "cb" slot (cvfunctional.py:66) — mirrored.
    std::vector<float> crf(P * P), cbf(P * P);
    auto descale = [](int v) { return (v + (1 << 13)) >> 14; };
    for (int i = 0; i < P * P; ++i) {
      int r = img[i * 3], g = img[i * 3 + 1], b = img[i * 3 + 2];
      int yy = descale(r * 4899 + g * 9617 + b * 1868);
      int crv = descale((r - yy) * 11682) + 128;
      int cbv = descale((b - yy) * 9241) + 128;
      auto clip = [](int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); };
      y[i] = static_cast<float>(clip(yy));
      crf[i] = static_cast<float>(clip(crv));
      cbf[i] = static_cast<float>(clip(cbv));
    }
    // chroma halving with cv2's exact fixed-point 8U INTER_LINEAR
    resize_linear_u8_cv(crf.data(), P, P, cb.data(), half, half);
    resize_linear_u8_cv(cbf.data(), P, P, cr.data(), half, half);
  }

  const int fs2 = p.fs * p.fs;
  const bool jpeg = p.fs == 8;
  std::vector<double> T(fs2);
  if (!jpeg) dct_basis(p.fs, T.data());

  const int nyb = P / p.fs;             // y blocks per side
  const int ncb = half / p.fs;          // chroma blocks per side
  std::vector<float> cy(nyb * nyb * fs2), ccb(ncb * ncb * fs2),
      ccr(ncb * ncb * fs2);
  if (jpeg) {
    fdct_islow_q100(y.data(), P, P, cy.data());
    fdct_islow_q100(cb.data(), half, half, ccb.data());
    fdct_islow_q100(cr.data(), half, half, ccr.data());
  } else {
    blockwise_dct(y.data(), P, P, p.fs, false, T.data(), cy.data());
    blockwise_dct(cb.data(), half, half, p.fs, false, T.data(), ccb.data());
    blockwise_dct(cr.data(), half, half, p.fs, false, T.data(), ccr.data());
  }

  // upscale coefficient maps to (S, S, fs2) where needed; the fs=8 path
  // resizes int16 coefficient maps, which cv2 routes through float
  // accumulation + saturate_cast<short> (round-half-even) — mirrored with
  // nearbyint after the float bilinear.
  std::vector<float> uy(p.S * p.S * fs2), ucb(p.S * p.S * fs2),
      ucr(p.S * p.S * fs2);
  auto upscale = [&](std::vector<float>& src, int nb, std::vector<float>& dst) {
    if (nb == p.S) {
      dst = src;
      return;
    }
    resize_bilinear(src.data(), nb, nb, fs2, dst.data(), p.S, p.S);
    if (jpeg)
      for (auto& v : dst) v = static_cast<float>(std::nearbyint(v));
  };
  upscale(cy, nyb, uy);
  upscale(ccb, ncb, ucb);
  upscale(ccr, ncb, ucr);

  // subset + aggregate + normalize -> (S, S, C) channel-last
  const int C = p.n_y + p.n_cb + p.n_cr;
  for (int s = 0; s < p.S * p.S; ++s) {
    float* dst = out + s * C;
    int c = 0;
    for (int i = 0; i < p.n_y; ++i, ++c)
      dst[c] = (uy[s * fs2 + p.idx_y[i]] - p.mean[c]) / p.std[c];
    for (int i = 0; i < p.n_cb; ++i, ++c)
      dst[c] = (ucb[s * fs2 + p.idx_cb[i]] - p.mean[c]) / p.std[c];
    for (int i = 0; i < p.n_cr; ++i, ++c)
      dst[c] = (ucr[s * fs2 + p.idx_cr[i]] - p.mean[c]) / p.std[c];
  }
}

}  // namespace

extern "C" {

// Batched ingest of center-cropped images.
//   images: uint8 (B, P, P, 3), P = fs * S
//   out:    float32 (B, S, S, n_y+n_cb+n_cr)
// Threads across the batch with std::thread.
void dct_ingest_batch(const uint8_t* images, int batch, int fs, int S,
                      const int* idx_y, int n_y, const int* idx_cb, int n_cb,
                      const int* idx_cr, int n_cr, const float* mean,
                      const float* stdv, float* out, int num_threads) {
  Plan plan{fs, S, n_y, n_cb, n_cr, idx_y, idx_cb, idx_cr, mean, stdv};
  const int P = fs * S;
  const int C = n_y + n_cb + n_cr;
  const size_t in_stride = static_cast<size_t>(P) * P * 3;
  const size_t out_stride = static_cast<size_t>(S) * S * C;
  if (num_threads <= 1) {
    for (int b = 0; b < batch; ++b)
      ingest_one(images + b * in_stride, plan, out + b * out_stride);
    return;
  }
  std::vector<std::thread> pool;
  int per = (batch + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int lo = t * per, hi = std::min(batch, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int b = lo; b < hi; ++b)
        ingest_one(images + b * in_stride, plan, out + b * out_stride);
    });
  }
  for (auto& th : pool) th.join();
}

// Standalone blockwise DCT for testing: plane (h, w) float -> coeffs
void blockwise_dct_plane(const float* plane, int h, int w, int fs,
                         int round_int, float* out) {
  std::vector<double> T(fs * fs);
  dct_basis(fs, T.data());
  blockwise_dct(plane, h, w, fs, round_int != 0, T.data(), out);
}

}  // extern "C"
