#include "frontend/feature_pipeline.h"

namespace wesep {

FeaturePipeline::FeaturePipeline(const FeaturePipelineConfig& config)
    : config_(config),
      fbank_(config.num_bins, config.sample_rate, config.frame_length(),
             config.frame_shift(), config.dither) {}

void FeaturePipeline::AcceptWaveform(const float* wav, size_t size) {
  std::vector<float> buf;
  buf.reserve(remained_wav_.size() + size);
  buf.insert(buf.end(), remained_wav_.begin(), remained_wav_.end());
  for (size_t i = 0; i < size; ++i) buf.push_back(wav[i] * 32768.0f);
  std::vector<float> feats;
  int num_frames = fbank_.Compute(buf, &feats);
  for (int t = 0; t < num_frames; ++t) {
    std::vector<float> frame(
        feats.begin() + static_cast<size_t>(t) * config_.num_bins,
        feats.begin() + static_cast<size_t>(t + 1) * config_.num_bins);
    queue_.Push(std::move(frame));
  }
  // keep the residual samples not yet covered by a full frame
  int consumed = num_frames * config_.frame_shift();
  if (consumed < static_cast<int>(buf.size())) {
    remained_wav_.assign(buf.begin() + consumed, buf.end());
    // undo the int16 scaling for the retained tail (AcceptWaveform
    // rescales on the next call)
    for (auto& v : remained_wav_) v /= 32768.0f;
  } else {
    remained_wav_.clear();
  }
}

void FeaturePipeline::SetInputFinished() {
  std::lock_guard<std::mutex> lock(finish_mutex_);
  input_finished_ = true;
  // sentinel so blocked readers wake up
  queue_.Push(std::vector<float>());
}

bool FeaturePipeline::ReadOne(std::vector<float>* frame) {
  *frame = queue_.Pop();
  if (frame->empty()) {
    // sentinel: re-push for other readers and report end
    queue_.Push(std::vector<float>());
    return false;
  }
  return true;
}

bool FeaturePipeline::Read(int num_frames,
                           std::vector<std::vector<float>>* frames) {
  frames->clear();
  for (int i = 0; i < num_frames; ++i) {
    std::vector<float> frame;
    if (!ReadOne(&frame)) return false;
    frames->push_back(std::move(frame));
  }
  return true;
}

int FeaturePipeline::ReadAll(std::vector<float>* feats) {
  feats->clear();
  int n = 0;
  std::vector<float> frame;
  while (ReadOne(&frame)) {
    feats->insert(feats->end(), frame.begin(), frame.end());
    ++n;
  }
  return n;
}

std::vector<float> FbankWithMeanNorm(const std::vector<float>& wav,
                                     int num_bins, int sample_rate,
                                     int* num_frames) {
  FeaturePipelineConfig config;
  config.num_bins = num_bins;
  config.sample_rate = sample_rate;
  FeaturePipeline pipeline(config);
  pipeline.AcceptWaveform(wav.data(), wav.size());
  pipeline.SetInputFinished();
  std::vector<float> feats;
  int frames = pipeline.ReadAll(&feats);
  if (frames > 0) {
    for (int d = 0; d < num_bins; ++d) {
      float mean = 0.0f;
      for (int t = 0; t < frames; ++t) mean += feats[t * num_bins + d];
      mean /= frames;
      for (int t = 0; t < frames; ++t) feats[t * num_bins + d] -= mean;
    }
  }
  *num_frames = frames;
  return feats;
}

}  // namespace wesep
