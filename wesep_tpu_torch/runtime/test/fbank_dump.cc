// Test helper: writes the fbank that the engine computes for an enrollment
// wav (frontend/feature_pipeline.cc's FbankWithMeanNorm, the same sources
// separate_main is built from) as raw float32, frames x feat_dim
// row-major, and prints "<frames> <feat_dim>".
//
//   fbank_dump ENROLL.wav OUT.f32 [feat_dim] [sample_rate]
#include <cstdio>
#include <cstdlib>
#include <exception>
#include <fstream>
#include <string>
#include <vector>

#include "frontend/feature_pipeline.h"
#include "frontend/wav.h"

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr,
                 "usage: fbank_dump ENROLL.wav OUT.f32 [feat_dim] "
                 "[sample_rate]\n");
    return 1;
  }
  const int feat_dim = argc > 3 ? std::atoi(argv[3]) : 80;
  const int sample_rate = argc > 4 ? std::atoi(argv[4]) : 16000;
  try {
    wesep::WavReader reader(argv[1]);
    if (reader.num_channels() != 1) {
      std::fprintf(stderr, "fbank_dump: %s is not mono\n", argv[1]);
      return 1;
    }
    int frames = 0;
    std::vector<float> feats =
        wesep::FbankWithMeanNorm(reader.data(), feat_dim, sample_rate,
                                 &frames);
    std::ofstream out(argv[2], std::ios::binary);
    out.write(reinterpret_cast<const char*>(feats.data()),
              static_cast<std::streamsize>(feats.size() * sizeof(float)));
    if (!out) {
      std::fprintf(stderr, "fbank_dump: cannot write %s\n", argv[2]);
      return 1;
    }
    std::printf("%d %d\n", frames, feat_dim);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "fbank_dump: %s\n", e.what());
    return 1;
  }
  return 0;
}
