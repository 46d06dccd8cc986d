// Iterative radix-2 FFT with precomputed twiddle/bit-reversal tables.
// The port's copy of runtime/frontend/fft.{h,cc} (standard Cooley-Tukey).
#ifndef WESEP_TPU_TORCH_RUNTIME_FRONTEND_FFT_H_
#define WESEP_TPU_TORCH_RUNTIME_FRONTEND_FFT_H_

#include <vector>

namespace wesep {

class Fft {
 public:
  // n must be a power of two.
  explicit Fft(int n);

  // In-place complex FFT of (real, imag), each length n.
  void Forward(float* real, float* imag) const;

  int size() const { return n_; }

 private:
  int n_;
  std::vector<int> bitrev_;
  std::vector<float> cos_tbl_;
  std::vector<float> sin_tbl_;
};

}  // namespace wesep

#endif  // WESEP_TPU_TORCH_RUNTIME_FRONTEND_FFT_H_
