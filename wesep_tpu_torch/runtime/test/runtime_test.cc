// Unit tests for the port's native frontend (FFT, fbank, wav, queue,
// pipeline), as runtime/test/runtime_test.cc has them, plus the enrollment
// fbank's mean normalisation. Assert-based (built without NDEBUG);
// wesep_tpu_torch/runtime/build.py builds and runs it.
#include <unistd.h>

#include <cassert>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

#include "frontend/fbank.h"
#include "frontend/feature_pipeline.h"
#include "frontend/fft.h"
#include "frontend/wav.h"
#include "utils/blocking_queue.h"

namespace {

void TestFft() {
  const int n = 512;
  wesep::Fft fft(n);
  std::vector<float> re(n, 0.0f), im(n, 0.0f);
  // impulse -> flat spectrum
  re[0] = 1.0f;
  fft.Forward(re.data(), im.data());
  for (int i = 0; i < n; ++i) {
    assert(std::fabs(re[i] - 1.0f) < 1e-4f);
    assert(std::fabs(im[i]) < 1e-4f);
  }
  // single tone at bin k -> peaks at k and n-k
  std::fill(re.begin(), re.end(), 0.0f);
  std::fill(im.begin(), im.end(), 0.0f);
  const int k = 37;
  for (int i = 0; i < n; ++i)
    re[i] = std::cos(2.0 * M_PI * k * i / n);
  fft.Forward(re.data(), im.data());
  for (int i = 0; i <= n / 2; ++i) {
    float mag = std::sqrt(re[i] * re[i] + im[i] * im[i]);
    if (i == k) {
      assert(std::fabs(mag - n / 2.0f) < 1e-2f);
    } else {
      assert(mag < 1e-2f);
    }
  }
  std::printf("TestFft ok\n");
}

void TestFbank() {
  const int sr = 16000;
  wesep::Fbank fbank(80, sr, 400, 160, 0.0f);
  std::vector<float> wave(16000);
  for (size_t i = 0; i < wave.size(); ++i) {
    wave[i] = 32768.0f * 0.5f *
              std::sin(2.0 * M_PI * 440.0 * i / sr);
  }
  std::vector<float> feats;
  int frames = fbank.Compute(wave, &feats);
  assert(frames == 1 + (16000 - 400) / 160);
  assert(static_cast<int>(feats.size()) == frames * 80);
  // energy concentrated near the 440 Hz mel bin: the argmax bin must be
  // stable across frames and below the middle of the bank
  int argmax0 = 0;
  for (int d = 1; d < 80; ++d)
    if (feats[d] > feats[argmax0]) argmax0 = d;
  assert(argmax0 > 2 && argmax0 < 40);
  for (int t = 1; t < frames; ++t) {
    int am = 0;
    for (int d = 1; d < 80; ++d)
      if (feats[t * 80 + d] > feats[t * 80 + am]) am = d;
    assert(std::abs(am - argmax0) <= 1);
  }
  std::printf("TestFbank ok (peak bin %d)\n", argmax0);
}

std::string TempPath(const char* name) {
  const char* dir = std::getenv("TMPDIR");
  return std::string(dir != nullptr && *dir != '\0' ? dir : "/tmp") + "/" +
         name + "_" + std::to_string(getpid()) + ".wav";
}

void TestWavRoundtrip() {
  std::vector<float> wave(8000);
  for (size_t i = 0; i < wave.size(); ++i)
    wave[i] = 0.4f * std::sin(2.0 * M_PI * 220.0 * i / 16000.0);
  const std::string path = TempPath("wesep_runtime_test");
  wesep::WriteWavFile(path, wave.data(), wave.size(), 16000);
  wesep::WavReader reader(path);
  assert(reader.sample_rate() == 16000);
  assert(reader.num_channels() == 1);
  assert(reader.num_samples() == 8000);
  for (int i = 0; i < 8000; ++i) {
    assert(std::fabs(reader.data()[i] - wave[i]) < 1e-3f);
  }
  std::remove(path.c_str());
  std::printf("TestWavRoundtrip ok\n");
}

void TestBlockingQueue() {
  wesep::BlockingQueue<int> q(4);
  std::thread producer([&q] {
    for (int i = 0; i < 100; ++i) q.Push(int(i));
  });
  long sum = 0;
  for (int i = 0; i < 100; ++i) sum += q.Pop();
  producer.join();
  assert(sum == 4950);
  assert(q.Empty());
  std::printf("TestBlockingQueue ok\n");
}

void TestFeaturePipeline() {
  wesep::FeaturePipelineConfig config;
  config.num_bins = 40;
  wesep::FeaturePipeline pipeline(config);
  std::vector<float> wave(6400);
  for (size_t i = 0; i < wave.size(); ++i)
    wave[i] = 0.3f * std::sin(2.0 * M_PI * 300.0 * i / 16000.0);
  // stream in two chunks; residual samples must carry over
  pipeline.AcceptWaveform(wave.data(), 3000);
  pipeline.AcceptWaveform(wave.data() + 3000, wave.size() - 3000);
  pipeline.SetInputFinished();
  std::vector<float> feats;
  int frames = pipeline.ReadAll(&feats);
  int expected = 1 + (6400 - 400) / 160;
  assert(frames == expected);
  assert(static_cast<int>(feats.size()) == frames * 40);
  std::printf("TestFeaturePipeline ok (%d frames)\n", frames);
}

void TestFbankWithMeanNorm() {
  std::vector<float> wave(9600);
  for (size_t i = 0; i < wave.size(); ++i)
    wave[i] = 0.2f * std::sin(2.0 * M_PI * 500.0 * i / 16000.0) +
              0.05f * std::sin(2.0 * M_PI * 3100.0 * i / 16000.0);
  int frames = 0;
  std::vector<float> feats = wesep::FbankWithMeanNorm(wave, 80, 16000,
                                                      &frames);
  assert(frames == 1 + (9600 - 400) / 160);
  assert(static_cast<int>(feats.size()) == frames * 80);
  for (int d = 0; d < 80; ++d) {
    double mean = 0.0;
    for (int t = 0; t < frames; ++t) mean += feats[t * 80 + d];
    assert(std::fabs(mean / frames) < 1e-4);
  }
  std::printf("TestFbankWithMeanNorm ok (%d frames)\n", frames);
}

}  // namespace

int main() {
  TestFft();
  TestFbank();
  TestWavRoundtrip();
  TestBlockingQueue();
  TestFeaturePipeline();
  TestFbankWithMeanNorm();
  std::printf("ALL RUNTIME TESTS PASSED\n");
  return 0;
}
