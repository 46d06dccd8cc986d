// Steady-clock millisecond timer (RTF accounting); the port's copy of
// runtime/utils/timer.h.
#ifndef WESEP_TPU_TORCH_RUNTIME_UTILS_TIMER_H_
#define WESEP_TPU_TORCH_RUNTIME_UTILS_TIMER_H_

#include <chrono>

namespace wesep {

class Timer {
 public:
  Timer() : start_(std::chrono::steady_clock::now()) {}

  void Reset() { start_ = std::chrono::steady_clock::now(); }

  // elapsed milliseconds since construction/Reset
  long Elapsed() const {
    auto now = std::chrono::steady_clock::now();
    return std::chrono::duration_cast<std::chrono::milliseconds>(now - start_)
        .count();
  }

 private:
  std::chrono::steady_clock::time_point start_;
};

}  // namespace wesep

#endif  // WESEP_TPU_TORCH_RUNTIME_UTILS_TIMER_H_
