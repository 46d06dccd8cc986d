// Target-speaker-extraction serving engine of the PyTorch port.
// Counterpart of runtime/separate/separate_engine.{h,cc}: the C++ side owns
// wav decoding, the fbank frontend and the request's arrays; the model runs
// in an embedded CPython interpreter through wesep_tpu_torch.runtime_host,
// whose kernels launch on the card (device "cuda") or whose plain versions
// run on the host (device "cpu"). One engine a process: it starts the
// interpreter and finalizes it when it is destroyed.
#ifndef WESEP_TPU_TORCH_RUNTIME_SEPARATE_SEPARATE_ENGINE_H_
#define WESEP_TPU_TORCH_RUNTIME_SEPARATE_SEPARATE_ENGINE_H_

#include <string>
#include <vector>

namespace wesep {

class SeparateEngine {
 public:
  // model_path: an export dir of bin/export.py (model.pt2 + export.json) or
  // a model dir (config.yaml + avg_model.ckpt); device: "cuda" or "cpu".
  SeparateEngine(const std::string& model_path, const std::string& device,
                 int feat_dim, int sample_rate);
  ~SeparateEngine();
  SeparateEngine(const SeparateEngine&) = delete;
  SeparateEngine& operator=(const SeparateEngine&) = delete;

  // One enrollment's fbank with each bin's mean over time taken out:
  // frames x feat_dim row-major.
  std::vector<float> ExtractFeature(const std::vector<float>& wav,
                                    int* num_frames) const;

  // mix + two enrollment wavs -> two estimated wavs [2][T].
  void ForwardFunc(const std::vector<float>& mix,
                   const std::vector<float>& enroll1,
                   const std::vector<float>& enroll2,
                   std::vector<std::vector<float>>* outputs);

  // runtime_host.launches() as JSON: each of the port's kernel wrappers
  // launched since the model was loaded, with its count.
  std::string KernelLaunches();

  int sample_rate() const { return sample_rate_; }
  bool expects_fbank() const { return expects_fbank_; }

 private:
  bool expects_fbank_ = false;
  int feat_dim_;
  int sample_rate_;
  void* host_module_ = nullptr;  // PyObject*: wesep_tpu_torch.runtime_host
  void* numpy_ = nullptr;        // PyObject*: numpy
  void* main_thread_ = nullptr;  // PyThreadState* while the GIL is free
};

}  // namespace wesep

#endif  // WESEP_TPU_TORCH_RUNTIME_SEPARATE_SEPARATE_ENGINE_H_
