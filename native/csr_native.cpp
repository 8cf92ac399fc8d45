// Native runtime components (SURVEY.md §2.9 note: the reference has no
// first-party native code — all of its native speed lived in Chainer/CuPy.
// Here the host-side hot paths that stay off the device get C++ equivalents:
// eval-time edit distance (O(T·U) per utterance, called for every dev
// utterance) and WAV PCM decoding for the data-loader thread.)
//
// Built by utils/native.py with `g++ -O3 -shared -fPIC`, loaded via ctypes;
// every entry point has a pure-Python fallback and a differential test.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Levenshtein distance between two int32 id sequences.
int64_t edit_distance_i32(const int32_t* a, int64_t la,
                          const int32_t* b, int64_t lb) {
  if (la == 0) return lb;
  if (lb == 0) return la;
  std::vector<int64_t> prev(lb + 1), cur(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    cur[0] = i;
    const int32_t ai = a[i - 1];
    for (int64_t j = 1; j <= lb; ++j) {
      const int64_t sub = prev[j - 1] + (ai != b[j - 1]);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// Batch edit distance over padded id matrices [n, stride].
void edit_distance_batch_i32(const int32_t* hyps, const int32_t* hyp_lens,
                             const int32_t* refs, const int32_t* ref_lens,
                             int64_t n, int64_t hyp_stride, int64_t ref_stride,
                             int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = edit_distance_i32(hyps + i * hyp_stride, hyp_lens[i],
                               refs + i * ref_stride, ref_lens[i]);
  }
}

// Parse a RIFF/WAVE buffer (16-bit PCM mono) into float32 in [-1, 1).
// Returns sample count, or -1 on malformed input / unsupported format.
// sample_rate_out receives the file's sample rate.
int64_t wav_pcm16_to_f32(const uint8_t* buf, int64_t nbytes,
                         float* out, int64_t out_cap,
                         int32_t* sample_rate_out) {
  if (nbytes < 44 || std::memcmp(buf, "RIFF", 4) || std::memcmp(buf + 8, "WAVE", 4))
    return -1;
  int64_t pos = 12;
  int32_t rate = 0;
  int16_t channels = 0, bits = 0;
  const uint8_t* data = nullptr;
  int64_t data_len = 0;
  while (pos + 8 <= nbytes) {
    const uint8_t* hdr = buf + pos;
    uint32_t chunk_len;
    std::memcpy(&chunk_len, hdr + 4, 4);
    const uint8_t* body = hdr + 8;
    if (!std::memcmp(hdr, "fmt ", 4) && chunk_len >= 16) {
      // the 16 bytes read below must lie INSIDE the buffer: a truncated
      // file whose fmt header sits at the tail would otherwise pass the
      // pos+8 loop guard and read past the mapped numpy buffer
      if (pos + 8 + 16 > nbytes) return -1;
      int16_t fmt;
      std::memcpy(&fmt, body, 2);
      std::memcpy(&channels, body + 2, 2);
      std::memcpy(&rate, body + 4, 4);
      std::memcpy(&bits, body + 14, 2);
      if (fmt != 1) return -1;  // PCM only
    } else if (!std::memcmp(hdr, "data", 4)) {
      data = body;
      data_len = std::min<int64_t>(chunk_len, nbytes - pos - 8);
    }
    pos += 8 + chunk_len + (chunk_len & 1);
  }
  if (!data || channels != 1 || bits != 16) return -1;
  const int64_t n = std::min<int64_t>(data_len / 2, out_cap);
  for (int64_t i = 0; i < n; ++i) {
    int16_t v;
    std::memcpy(&v, data + 2 * i, 2);
    out[i] = static_cast<float>(v) / 32768.0f;
  }
  if (sample_rate_out) *sample_rate_out = rate;
  return n;
}

}  // extern "C"
