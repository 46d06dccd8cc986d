// Kaldi-compatible log-mel fbank (header-only), the port's copy of
// runtime/frontend/fbank.h: per frame — dither, DC removal, pre-emphasis
// 0.97, hamming window, zero-pad to pow2 FFT, power spectrum, kaldi mel
// triangles (20 Hz .. Nyquist), log with float-eps floor. Input samples
// are expected in int16 scale (x * 32768) like kaldi/torchaudio fbank.
#ifndef WESEP_TPU_TORCH_RUNTIME_FRONTEND_FBANK_H_
#define WESEP_TPU_TORCH_RUNTIME_FRONTEND_FBANK_H_

#include <algorithm>
#include <cmath>
#include <limits>
#include <random>
#include <vector>

#include "frontend/fft.h"

namespace wesep {

class Fbank {
 public:
  Fbank(int num_bins, int sample_rate, int frame_length, int frame_shift,
        float dither = 0.0f)
      : num_bins_(num_bins),
        sample_rate_(sample_rate),
        frame_length_(frame_length),
        frame_shift_(frame_shift),
        dither_(dither),
        generator_(0) {
    fft_size_ = 1;
    while (fft_size_ < frame_length_) fft_size_ <<= 1;
    fft_ = new Fft(fft_size_);
    // hamming window (symmetric, denominator N-1 — kaldi 'hamming')
    window_.resize(frame_length_);
    const double pi = 3.14159265358979323846;
    for (int i = 0; i < frame_length_; ++i) {
      window_[i] = static_cast<float>(
          0.54 - 0.46 * std::cos(2.0 * pi * i / (frame_length_ - 1)));
    }
    InitMelBanks();
  }

  ~Fbank() { delete fft_; }
  Fbank(const Fbank&) = delete;
  Fbank& operator=(const Fbank&) = delete;

  int num_bins() const { return num_bins_; }
  int frame_shift() const { return frame_shift_; }
  int frame_length() const { return frame_length_; }

  // wave: int16-scaled float samples. Returns number of frames; feat is
  // [num_frames * num_bins] row-major.
  int Compute(const std::vector<float>& wave, std::vector<float>* feat) {
    int num_samples = static_cast<int>(wave.size());
    if (num_samples < frame_length_) return 0;
    int num_frames = 1 + (num_samples - frame_length_) / frame_shift_;
    feat->resize(static_cast<size_t>(num_frames) * num_bins_);
    std::vector<float> frame(fft_size_), imag(fft_size_);
    std::vector<float> power(fft_size_ / 2);
    for (int t = 0; t < num_frames; ++t) {
      std::fill(imag.begin(), imag.end(), 0.0f);
      std::fill(frame.begin() + frame_length_, frame.end(), 0.0f);
      const float* src = wave.data() + t * frame_shift_;
      std::copy(src, src + frame_length_, frame.begin());
      if (dither_ > 0.0f) {
        std::normal_distribution<float> dist(0.0f, 1.0f);
        for (int i = 0; i < frame_length_; ++i)
          frame[i] += dither_ * dist(generator_);
      }
      // DC removal
      float mean = 0.0f;
      for (int i = 0; i < frame_length_; ++i) mean += frame[i];
      mean /= frame_length_;
      for (int i = 0; i < frame_length_; ++i) frame[i] -= mean;
      // pre-emphasis (kaldi: x[0] -= coef * x[0])
      for (int i = frame_length_ - 1; i > 0; --i)
        frame[i] -= kPreEmph * frame[i - 1];
      frame[0] -= kPreEmph * frame[0];
      // window
      for (int i = 0; i < frame_length_; ++i) frame[i] *= window_[i];
      // FFT + power spectrum (nyquist bin excluded by kaldi banks)
      fft_->Forward(frame.data(), imag.data());
      for (int i = 0; i < fft_size_ / 2; ++i)
        power[i] = frame[i] * frame[i] + imag[i] * imag[i];
      // mel banks + log
      float* out = feat->data() + static_cast<size_t>(t) * num_bins_;
      for (int m = 0; m < num_bins_; ++m) {
        float sum = 0.0f;
        for (int i = bank_start_[m]; i < bank_end_[m]; ++i)
          sum += banks_[m][i - bank_start_[m]] * power[i];
        out[m] = std::log(std::max(sum, kLogFloor));
      }
    }
    return num_frames;
  }

 private:
  static constexpr float kPreEmph = 0.97f;
  static constexpr float kLogFloor = 1.1920928955078125e-07f;  // f32 eps

  static double MelScale(double freq) {
    return 1127.0 * std::log(1.0 + freq / 700.0);
  }

  void InitMelBanks() {
    int num_fft_bins = fft_size_ / 2;
    double fft_bin_width = static_cast<double>(sample_rate_) / fft_size_;
    double mel_low = MelScale(20.0);
    double mel_high = MelScale(0.5 * sample_rate_);
    double mel_delta = (mel_high - mel_low) / (num_bins_ + 1);
    banks_.resize(num_bins_);
    bank_start_.resize(num_bins_);
    bank_end_.resize(num_bins_);
    for (int m = 0; m < num_bins_; ++m) {
      double left = mel_low + m * mel_delta;
      double center = left + mel_delta;
      double right = center + mel_delta;
      int start = -1, end = num_fft_bins;
      std::vector<float> weights;
      for (int i = 0; i < num_fft_bins; ++i) {
        double mel = MelScale(fft_bin_width * i);
        double w = 0.0;
        if (mel > left && mel < right) {
          w = (mel <= center) ? (mel - left) / (center - left)
                              : (right - mel) / (right - center);
        }
        if (w > 0.0) {
          if (start < 0) start = i;
          end = i + 1;
          weights.push_back(static_cast<float>(w));
        } else if (start >= 0 && mel >= right) {
          break;
        }
      }
      if (start < 0) {
        start = 0;
        end = 0;
      }
      bank_start_[m] = start;
      bank_end_[m] = end;
      banks_[m] = std::move(weights);
    }
  }

  int num_bins_, sample_rate_, frame_length_, frame_shift_;
  float dither_;
  int fft_size_;
  Fft* fft_;
  std::vector<float> window_;
  std::vector<std::vector<float>> banks_;
  std::vector<int> bank_start_, bank_end_;
  std::mt19937 generator_;
};

}  // namespace wesep

#endif  // WESEP_TPU_TORCH_RUNTIME_FRONTEND_FBANK_H_
