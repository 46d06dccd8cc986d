// Serving binary of the PyTorch port: target-speaker extraction with RTF
// reporting. Counterpart of runtime/bin/separate_main.cc with its CLI (one
// utterance, or a 4-column wav_scp; per-utterance and total RTF lines;
// <key>-spk{1,2}.wav outputs) and:
//   --device cuda|cpu   where runtime_host runs the model (default cuda);
//   a last line "kernel launches: {...}", the port's kernel wrappers that
//   the engine's requests launched, each with its count.
// A TF SavedModel dir has no counterpart in the port and is refused;
// --num_threads > 1 warns and runs one engine, as the JAX package's
// embedded engine does. Flags are parsed with a tiny built-in parser.
//
//   python -m wesep_tpu_torch.runtime.build   # prints the binary's path
//   separate_main --model_path DIR --wav_scp wav.scp --result_dir OUT
#include <sys/stat.h>

#include <algorithm>
#include <cstdio>
#include <exception>
#include <iostream>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "frontend/wav.h"
#include "separate/separate_engine.h"
#include "utils/timer.h"
#include "utils/utils.h"

namespace {

struct Flags {
  std::string model_path;
  std::string wav_path;
  std::string spk1_enroll;
  std::string spk2_enroll;
  std::string wav_scp;
  std::string result_dir = ".";
  std::string device = "cuda";
  int feat_dim = 80;
  int sample_rate = 16000;
  int num_threads = 1;
};

bool ParseFlags(int argc, char** argv, Flags* flags) {
  std::map<std::string, std::string*> str_flags = {
      {"--model_path", &flags->model_path},
      {"--wav_path", &flags->wav_path},
      {"--spk1_enroll", &flags->spk1_enroll},
      {"--spk2_enroll", &flags->spk2_enroll},
      {"--wav_scp", &flags->wav_scp},
      {"--result_dir", &flags->result_dir},
      {"--device", &flags->device},
  };
  std::map<std::string, int*> int_flags = {
      {"--feat_dim", &flags->feat_dim},
      {"--sample_rate", &flags->sample_rate},
      {"--num_threads", &flags->num_threads},
  };
  for (int i = 1; i < argc; ++i) {
    std::string arg = argv[i];
    auto eq = arg.find('=');
    std::string key = eq == std::string::npos ? arg : arg.substr(0, eq);
    std::string value;
    if (eq != std::string::npos) {
      value = arg.substr(eq + 1);
    } else if (i + 1 < argc) {
      value = argv[++i];
    } else {
      std::cerr << "missing value for " << key << "\n";
      return false;
    }
    if (str_flags.count(key)) {
      *str_flags[key] = value;
    } else if (int_flags.count(key)) {
      *int_flags[key] = std::stoi(value);
    } else {
      std::cerr << "unknown flag " << key << "\n";
      return false;
    }
  }
  if (flags->model_path.empty()) {
    std::cerr << "usage: separate_main --model_path DIR "
              << "(--wav_path MIX --spk1_enroll E1 --spk2_enroll E2 | "
              << "--wav_scp SCP) [--result_dir DIR] [--device cuda|cpu]\n";
    return false;
  }
  return true;
}

bool FileExists(const std::string& path) {
  struct stat st;
  return stat(path.c_str(), &st) == 0;
}

std::vector<float> Mono(const wesep::WavReader& reader) {
  const auto& data = reader.data();
  int nch = reader.num_channels();
  if (nch == 1) return data;
  std::vector<float> mono(reader.num_samples());
  for (int i = 0; i < reader.num_samples(); ++i) {
    float acc = 0.0f;
    for (int c = 0; c < nch; ++c) acc += data[i * nch + c];
    mono[i] = acc / nch;
  }
  return mono;
}

int Run(const Flags& flags) {
  if (FileExists(flags.model_path + "/saved_model.pb") ||
      FileExists(flags.model_path + "/saved_model/saved_model.pb")) {
    std::cerr << "separate_main: " << flags.model_path
              << " is a TensorFlow SavedModel, which the PyTorch port does "
              << "not serve (bin/export.py writes model.pt2 and refuses "
              << "--format savedmodel); a Python-free engine is ROADMAP.md "
              << "A.3, not yet built\n";
    return 1;
  }

  // utterances: key, mix, enroll1, enroll2
  std::vector<std::vector<std::string>> utts;
  if (!flags.wav_scp.empty()) {
    for (auto& row : wesep::ReadScp(flags.wav_scp)) {
      if (row.size() == 4) utts.push_back(row);
    }
  } else {
    utts.push_back(
        {"utt", flags.wav_path, flags.spk1_enroll, flags.spk2_enroll});
  }
  if (flags.num_threads > 1) {
    std::printf(
        "embedded-python engine is single-threaded; --num_threads "
        "ignored\n");
  }

  wesep::SeparateEngine engine(flags.model_path, flags.device,
                               flags.feat_dim, flags.sample_rate);
  const int engine_sr = engine.sample_rate();
  std::printf("engine: embedded python (wesep_tpu_torch.runtime_host), "
              "device %s, %s cues\n", flags.device.c_str(),
              engine.expects_fbank() ? "fbank" : "wav or embedding");

  long total_decode_ms = 0;
  double total_audio_sec = 0.0;
  for (const auto& utt : utts) {
    const std::string& key = utt[0];
    wesep::WavReader mix_reader(utt[1]);
    wesep::WavReader e1_reader(utt[2]);
    wesep::WavReader e2_reader(utt[3]);
    std::vector<float> mix = Mono(mix_reader);
    std::vector<float> e1 = Mono(e1_reader);
    std::vector<float> e2 = Mono(e2_reader);
    double audio_sec =
        static_cast<double>(mix.size()) / mix_reader.sample_rate();

    wesep::Timer timer;
    std::vector<std::vector<float>> outputs;
    engine.ForwardFunc(mix, e1, e2, &outputs);
    long ms = timer.Elapsed();
    total_decode_ms += ms;
    total_audio_sec += audio_sec;
    std::printf("%s: decode %ld ms, audio %.2f s, RTF %.4f\n", key.c_str(),
                ms, audio_sec, (ms / 1000.0) / audio_sec);
    for (size_t i = 0; i < outputs.size(); ++i) {
      std::string out_path = flags.result_dir + "/" + key + "-spk" +
                             std::to_string(i + 1) + ".wav";
      wesep::WriteWavFile(out_path, outputs[i].data(), outputs[i].size(),
                          engine_sr);
    }
  }
  if (total_audio_sec > 0) {
    std::printf("TOTAL: decode %ld ms, audio %.2f s, RTF %.4f\n",
                total_decode_ms, total_audio_sec,
                (total_decode_ms / 1000.0) / total_audio_sec);
  }
  std::printf("kernel launches: %s\n", engine.KernelLaunches().c_str());
  std::fflush(stdout);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  Flags flags;
  if (!ParseFlags(argc, argv, &flags)) return 1;
  try {
    return Run(flags);
  } catch (const std::exception& e) {
    std::fflush(stdout);
    std::cerr << "separate_main: " << e.what() << "\n";
    return 1;
  }
}
