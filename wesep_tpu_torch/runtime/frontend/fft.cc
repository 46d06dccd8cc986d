#include "frontend/fft.h"

#include <cmath>

namespace wesep {

Fft::Fft(int n) : n_(n), bitrev_(n), cos_tbl_(n / 2), sin_tbl_(n / 2) {
  // bit-reversal permutation table
  int bits = 0;
  while ((1 << bits) < n) ++bits;
  for (int i = 0; i < n; ++i) {
    int r = 0;
    for (int b = 0; b < bits; ++b) {
      if (i & (1 << b)) r |= 1 << (bits - 1 - b);
    }
    bitrev_[i] = r;
  }
  const double pi = 3.14159265358979323846;
  for (int k = 0; k < n / 2; ++k) {
    cos_tbl_[k] = static_cast<float>(std::cos(-2.0 * pi * k / n));
    sin_tbl_[k] = static_cast<float>(std::sin(-2.0 * pi * k / n));
  }
}

void Fft::Forward(float* real, float* imag) const {
  // permute
  for (int i = 0; i < n_; ++i) {
    int j = bitrev_[i];
    if (j > i) {
      float tr = real[i];
      real[i] = real[j];
      real[j] = tr;
      float ti = imag[i];
      imag[i] = imag[j];
      imag[j] = ti;
    }
  }
  // butterflies
  for (int len = 2; len <= n_; len <<= 1) {
    int half = len >> 1;
    int step = n_ / len;
    for (int start = 0; start < n_; start += len) {
      for (int k = 0; k < half; ++k) {
        int tw = k * step;
        float wr = cos_tbl_[tw];
        float wi = sin_tbl_[tw];
        int a = start + k;
        int b = a + half;
        float xr = real[b] * wr - imag[b] * wi;
        float xi = real[b] * wi + imag[b] * wr;
        real[b] = real[a] - xr;
        imag[b] = imag[a] - xi;
        real[a] += xr;
        imag[a] += xi;
      }
    }
  }
}

}  // namespace wesep
