// Native batched image transform: flip + pad/crop + scale + normalize in one
// pass over the batch, writing NHWC float32.
//
// The whole per-image chain (the reference's torchvision Compose, which
// materializes an intermediate tensor per stage) is one loop per image with
// no intermediates, compiled -O3 and loaded through ctypes
// (data/native/__init__.py).
//
// Its results are bit for bit those of data/transforms.py's numpy executor:
// a pixel is (v / 255 - mean) / std in float32, each operation rounded once,
// in numpy's order (a division by 255, not a product with its reciprocal,
// and no contraction into a fused multiply-add: built -ffp-contract=off).
// The host supplies the random flip flags and crop offsets, so the draws
// stay in one place.

#include <cstdint>

extern "C" {

// in:  B x H x W x C uint8
// out: B x CS x CS x C float32 (CS = crop_size when cropping, else H/W)
// flip_flags: B ints (0/1) or null, crop_ys/crop_xs: B ints into the padded
// image; mean/std: C floats (mean 0, std 1 for no normalization)
void transform_batch(const uint8_t* in, float* out,
                     int64_t b, int64_t h, int64_t w, int64_t c,
                     const int32_t* flip_flags,
                     int32_t do_crop, int64_t pad, int64_t crop_size,
                     const int32_t* crop_ys, const int32_t* crop_xs,
                     const float* mean, const float* std) {
  const int64_t out_h = do_crop ? crop_size : h;
  const int64_t out_w = do_crop ? crop_size : w;
  const int64_t in_img = h * w * c;
  const int64_t out_img = out_h * out_w * c;

  for (int64_t i = 0; i < b; ++i) {
    const uint8_t* src = in + i * in_img;
    float* dst = out + i * out_img;
    const bool flip = flip_flags && flip_flags[i];
    const int64_t y0 = do_crop ? crop_ys[i] : 0;
    const int64_t x0 = do_crop ? crop_xs[i] : 0;

    for (int64_t oy = 0; oy < out_h; ++oy) {
      const int64_t sy = do_crop ? (y0 + oy - pad) : oy;  // source row
      for (int64_t ox = 0; ox < out_w; ++ox) {
        const int64_t sx = do_crop ? (x0 + ox - pad) : ox;  // source col
        float* px = dst + (oy * out_w + ox) * c;
        if (sy < 0 || sy >= h || sx < 0 || sx >= w) {
          // the zero padding (np.pad's constant mode)
          for (int64_t ch = 0; ch < c; ++ch) px[ch] = (0.0f - mean[ch]) / std[ch];
          continue;
        }
        const int64_t fx = flip ? (w - 1 - sx) : sx;  // the flip reads mirrored
        const uint8_t* spx = src + (sy * w + fx) * c;
        for (int64_t ch = 0; ch < c; ++ch)
          px[ch] = ((float)spx[ch] / 255.0f - mean[ch]) / std[ch];
      }
    }
  }
}

}  // extern "C"
