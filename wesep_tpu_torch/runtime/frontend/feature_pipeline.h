// Streaming fbank pipeline: AcceptWaveform chunks -> frames -> blocking
// queue -> Read. The port's copy of runtime/frontend/feature_pipeline.{h,cc}:
// 25 ms / 10 ms frames, residual-sample carryover,
// thread-safe handoff with an input-finished handshake.
#ifndef WESEP_TPU_TORCH_RUNTIME_FRONTEND_FEATURE_PIPELINE_H_
#define WESEP_TPU_TORCH_RUNTIME_FRONTEND_FEATURE_PIPELINE_H_

#include <memory>
#include <mutex>
#include <vector>

#include "frontend/fbank.h"
#include "utils/blocking_queue.h"

namespace wesep {

struct FeaturePipelineConfig {
  int num_bins = 80;
  int sample_rate = 16000;
  int frame_length_ms = 25;
  int frame_shift_ms = 10;
  float dither = 0.0f;

  int frame_length() const { return sample_rate / 1000 * frame_length_ms; }
  int frame_shift() const { return sample_rate / 1000 * frame_shift_ms; }
};

class FeaturePipeline {
 public:
  explicit FeaturePipeline(const FeaturePipelineConfig& config);

  // wav: float samples in [-1, 1]; scaled to int16 range internally
  // (kaldi convention: the engine's ExtractFeature scales by 32768).
  void AcceptWaveform(const float* wav, size_t size);
  void SetInputFinished();

  int NumQueuedFrames() const { return static_cast<int>(queue_.Size()); }
  int feature_dim() const { return config_.num_bins; }

  // Blocking read of one frame. Returns false when input is finished and
  // the queue has drained.
  bool ReadOne(std::vector<float>* frame);
  // Blocking read of up to `num_frames`; false on end-of-input.
  bool Read(int num_frames, std::vector<std::vector<float>>* frames);

  // Drain everything (after SetInputFinished) into a flat row-major
  // buffer; returns frame count.
  int ReadAll(std::vector<float>* feats);

 private:
  FeaturePipelineConfig config_;
  Fbank fbank_;
  std::vector<float> remained_wav_;
  BlockingQueue<std::vector<float>> queue_;
  bool input_finished_ = false;
  mutable std::mutex finish_mutex_;
};

// One enrollment's fbank through the pipeline (no dither), then each bin's
// mean over time taken out (the reference engine's ExtractFeature): frames
// x num_bins row-major; the frame count in *num_frames.
std::vector<float> FbankWithMeanNorm(const std::vector<float>& wav,
                                     int num_bins, int sample_rate,
                                     int* num_frames);

}  // namespace wesep

#endif  // WESEP_TPU_TORCH_RUNTIME_FRONTEND_FEATURE_PIPELINE_H_
