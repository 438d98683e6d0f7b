// Native WAV decoder and crop/normalise of a training pair, for the data
// pipeline of fdbm_tpu_torch: the port's own copy of the JAX package's
// fdbm_tpu/ops/native/wavio.cc, with the same C interface and arithmetic, so
// both loaders give the same bits. It decodes PCM WAV files and assembles
// normalised training crops without holding the GIL, so the loader's Python
// threads scale across cores.
//
// Exposed C ABI (ctypes):
//   wav_info(path, *sr, *channels, *frames, *bits)      -> 0 on success
//   wav_read_f32(path, out, max_frames, *sr, *channels) -> frames read (<0 err)
//   load_crop_pair(clean_path, noisy_path, target_len, start, normalize_mode,
//                  out_x, out_y)                        -> 0 on success
//     normalize_mode: 0=noisy-max, 1=clean-max, 2=none, 3=noisy-std
//     start: crop start sample, or -1 = centre crop; pads symmetrically when
//     the file is shorter than target_len (reference fdbm/data_module.py:57-87).
//   Formats: PCM 16/24/32-bit and IEEE float32; any other (PCM 8-bit,
//   float64, ...) makes wav_read_f32 return -2 and load_crop_pair -2.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct WavData {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  std::vector<uint8_t> data;
};

bool read_wav_file(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint8_t hdr[12];
  if (std::fread(hdr, 1, 12, f) != 12 || std::memcmp(hdr, "RIFF", 4) != 0 ||
      std::memcmp(hdr + 8, "WAVE", 4) != 0) {
    std::fclose(f);
    return false;
  }
  bool have_fmt = false, have_data = false;
  while (!std::feof(f)) {
    uint8_t chdr[8];
    if (std::fread(chdr, 1, 8, f) != 8) break;
    uint32_t size;
    std::memcpy(&size, chdr + 4, 4);
    if (std::memcmp(chdr, "fmt ", 4) == 0) {
      std::vector<uint8_t> fmt(size);
      if (std::fread(fmt.data(), 1, size, f) != size) break;
      std::memcpy(&out->format, fmt.data() + 0, 2);
      std::memcpy(&out->channels, fmt.data() + 2, 2);
      std::memcpy(&out->sample_rate, fmt.data() + 4, 4);
      std::memcpy(&out->bits, fmt.data() + 14, 2);
      if (out->format == 0xFFFE) out->format = (out->bits == 32) ? 1 : 1;
      have_fmt = true;
    } else if (std::memcmp(chdr, "data", 4) == 0) {
      out->data.resize(size);
      if (std::fread(out->data.data(), 1, size, f) != size) break;
      have_data = true;
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
    if (have_fmt && have_data) break;
  }
  std::fclose(f);
  return have_fmt && have_data;
}

// Decode channel 0 to float32 in [-1, 1]. Returns frame count or -1.
int64_t decode_mono(const WavData& w, std::vector<float>* out) {
  const int ch = w.channels ? w.channels : 1;
  if (w.format == 1) {  // PCM
    if (w.bits == 16) {
      const int16_t* p = reinterpret_cast<const int16_t*>(w.data.data());
      int64_t frames = static_cast<int64_t>(w.data.size()) / (2 * ch);
      out->resize(frames);
      for (int64_t i = 0; i < frames; ++i)
        (*out)[i] = static_cast<float>(p[i * ch]) / 32768.0f;
      return frames;
    }
    if (w.bits == 32) {
      const int32_t* p = reinterpret_cast<const int32_t*>(w.data.data());
      int64_t frames = static_cast<int64_t>(w.data.size()) / (4 * ch);
      out->resize(frames);
      for (int64_t i = 0; i < frames; ++i)
        (*out)[i] = static_cast<float>(p[i * ch]) / 2147483648.0f;
      return frames;
    }
    if (w.bits == 24) {
      const uint8_t* p = w.data.data();
      int64_t frames = static_cast<int64_t>(w.data.size()) / (3 * ch);
      out->resize(frames);
      for (int64_t i = 0; i < frames; ++i) {
        const uint8_t* s = p + i * ch * 3;
        int32_t v = (s[0] | (s[1] << 8) | (s[2] << 16)) << 8;
        (*out)[i] = static_cast<float>(v >> 8) / 8388608.0f;
      }
      return frames;
    }
    return -1;
  }
  if (w.format == 3 && w.bits == 32) {  // IEEE float
    const float* p = reinterpret_cast<const float*>(w.data.data());
    int64_t frames = static_cast<int64_t>(w.data.size()) / (4 * ch);
    out->resize(frames);
    for (int64_t i = 0; i < frames; ++i) (*out)[i] = p[i * ch];
    return frames;
  }
  return -1;
}

void crop_or_pad(const std::vector<float>& x, int64_t target_len, int64_t start,
                 std::vector<float>* out) {
  out->assign(target_len, 0.0f);
  const int64_t n = static_cast<int64_t>(x.size());
  if (n >= target_len) {
    int64_t s = (start < 0) ? (n - target_len) / 2 : start;
    if (s + target_len > n) s = n - target_len;
    std::memcpy(out->data(), x.data() + s, target_len * sizeof(float));
  } else {
    // pad symmetrically: pad//2 front, remainder back
    int64_t pad = target_len - n;
    std::memcpy(out->data() + pad / 2, x.data(), n * sizeof(float));
  }
}

}  // namespace

extern "C" {

int wav_info(const char* path, int* sr, int* channels, long long* frames,
             int* bits) {
  WavData w;
  if (!read_wav_file(path, &w)) return -1;
  *sr = static_cast<int>(w.sample_rate);
  *channels = static_cast<int>(w.channels);
  *bits = static_cast<int>(w.bits);
  const int bytes = (w.bits / 8) * (w.channels ? w.channels : 1);
  *frames = bytes ? static_cast<long long>(w.data.size()) / bytes : 0;
  return 0;
}

long long wav_read_f32(const char* path, float* out, long long max_frames,
                       int* sr, int* channels) {
  WavData w;
  if (!read_wav_file(path, &w)) return -1;
  std::vector<float> mono;
  int64_t frames = decode_mono(w, &mono);
  if (frames < 0) return -2;
  *sr = static_cast<int>(w.sample_rate);
  *channels = static_cast<int>(w.channels);
  int64_t n = frames < max_frames ? frames : max_frames;
  std::memcpy(out, mono.data(), n * sizeof(float));
  return n;
}

int load_crop_pair(const char* clean_path, const char* noisy_path,
                   long long target_len, long long start, int normalize_mode,
                   float* out_x, float* out_y) {
  WavData wx, wy;
  if (!read_wav_file(clean_path, &wx) || !read_wav_file(noisy_path, &wy))
    return -1;
  std::vector<float> x, y;
  if (decode_mono(wx, &x) < 0 || decode_mono(wy, &y) < 0) return -2;

  std::vector<float> xc, yc;
  crop_or_pad(x, target_len, start, &xc);
  crop_or_pad(y, target_len, start, &yc);

  float normfac = 1.0f;
  if (normalize_mode == 0) {  // noisy max
    normfac = 0.f;
    for (float v : yc) normfac = std::max(normfac, std::fabs(v));
  } else if (normalize_mode == 1) {  // clean max
    normfac = 0.f;
    for (float v : xc) normfac = std::max(normfac, std::fabs(v));
  } else if (normalize_mode == 3) {  // noisy std
    double mean = 0, sq = 0;
    for (float v : yc) mean += v;
    mean /= target_len;
    for (float v : yc) sq += (v - mean) * (v - mean);
    normfac = static_cast<float>(std::sqrt(sq / (target_len - 1)));
  }
  if (normfac == 0.0f) normfac = 1.0f;
  const float inv = 1.0f / normfac;
  for (long long i = 0; i < target_len; ++i) {
    out_x[i] = xc[i] * inv;
    out_y[i] = yc[i] * inv;
  }
  return 0;
}

}  // extern "C"
