// Minimal RIFF/WAVE reader (PCM16 or IEEE float32) and PCM16 writer
// (header-only). The port's copy of runtime/frontend/wav.h.
#ifndef WESEP_TPU_TORCH_RUNTIME_FRONTEND_WAV_H_
#define WESEP_TPU_TORCH_RUNTIME_FRONTEND_WAV_H_

#include <cstdint>
#include <cstring>
#include <fstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace wesep {

class WavReader {
 public:
  explicit WavReader(const std::string& path) { Load(path); }

  int sample_rate() const { return sample_rate_; }
  int num_channels() const { return num_channels_; }
  int num_samples() const {
    return num_channels_ ? static_cast<int>(data_.size()) / num_channels_ : 0;
  }
  // interleaved float samples in [-1, 1]
  const std::vector<float>& data() const { return data_; }

 private:
  void Load(const std::string& path) {
    std::ifstream in(path, std::ios::binary);
    if (!in) throw std::runtime_error("cannot open " + path);
    std::vector<char> buf((std::istreambuf_iterator<char>(in)),
                          std::istreambuf_iterator<char>());
    if (buf.size() < 44 || std::memcmp(buf.data(), "RIFF", 4) != 0 ||
        std::memcmp(buf.data() + 8, "WAVE", 4) != 0) {
      throw std::runtime_error("not a RIFF/WAVE file: " + path);
    }
    size_t pos = 12;
    uint16_t audio_fmt = 0, bits = 0;
    const char* data_ptr = nullptr;
    uint32_t data_size = 0;
    while (pos + 8 <= buf.size()) {
      uint32_t chunk_size;
      std::memcpy(&chunk_size, buf.data() + pos + 4, 4);
      const char* id = buf.data() + pos;
      const char* body = buf.data() + pos + 8;
      if (std::memcmp(id, "fmt ", 4) == 0 && chunk_size >= 16) {
        std::memcpy(&audio_fmt, body, 2);
        uint16_t nch;
        std::memcpy(&nch, body + 2, 2);
        num_channels_ = nch;
        uint32_t sr;
        std::memcpy(&sr, body + 4, 4);
        sample_rate_ = static_cast<int>(sr);
        std::memcpy(&bits, body + 14, 2);
      } else if (std::memcmp(id, "data", 4) == 0) {
        data_ptr = body;
        data_size = chunk_size;
      }
      pos += 8 + chunk_size + (chunk_size & 1);
    }
    if (!data_ptr) throw std::runtime_error("missing data chunk: " + path);
    if (audio_fmt == 1 && bits == 16) {
      size_t n = data_size / 2;
      data_.resize(n);
      const int16_t* raw = reinterpret_cast<const int16_t*>(data_ptr);
      for (size_t i = 0; i < n; ++i) data_[i] = raw[i] / 32768.0f;
    } else if (audio_fmt == 3 && bits == 32) {
      size_t n = data_size / 4;
      data_.resize(n);
      std::memcpy(data_.data(), data_ptr, data_size);
    } else {
      throw std::runtime_error("unsupported wav format in " + path);
    }
  }

  int sample_rate_ = 0;
  int num_channels_ = 0;
  std::vector<float> data_;
};

inline void WriteWavFile(const std::string& path, const float* data,
                         size_t num_samples, int sample_rate,
                         int num_channels = 1) {
  std::ofstream out(path, std::ios::binary);
  if (!out) throw std::runtime_error("cannot write " + path);
  uint32_t data_bytes = static_cast<uint32_t>(num_samples * 2);
  uint32_t riff_size = 36 + data_bytes;
  uint16_t fmt = 1, bits = 16;
  uint16_t nch = static_cast<uint16_t>(num_channels);
  uint32_t sr = static_cast<uint32_t>(sample_rate);
  uint32_t byte_rate = sr * nch * 2;
  uint16_t block_align = nch * 2;
  uint32_t fmt_size = 16;
  out.write("RIFF", 4);
  out.write(reinterpret_cast<char*>(&riff_size), 4);
  out.write("WAVE", 4);
  out.write("fmt ", 4);
  out.write(reinterpret_cast<char*>(&fmt_size), 4);
  out.write(reinterpret_cast<char*>(&fmt), 2);
  out.write(reinterpret_cast<char*>(&nch), 2);
  out.write(reinterpret_cast<char*>(&sr), 4);
  out.write(reinterpret_cast<char*>(&byte_rate), 4);
  out.write(reinterpret_cast<char*>(&block_align), 2);
  out.write(reinterpret_cast<char*>(&bits), 2);
  out.write("data", 4);
  out.write(reinterpret_cast<char*>(&data_bytes), 4);
  for (size_t i = 0; i < num_samples; ++i) {
    float v = data[i];
    if (v > 1.0f) v = 1.0f;
    if (v < -1.0f) v = -1.0f;
    int16_t s = static_cast<int16_t>(v * 32767.0f);
    out.write(reinterpret_cast<char*>(&s), 2);
  }
}

}  // namespace wesep

#endif  // WESEP_TPU_TORCH_RUNTIME_FRONTEND_WAV_H_
