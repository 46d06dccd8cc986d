// Small string/file helpers for the runtime binaries.
#ifndef WESEP_TPU_TORCH_RUNTIME_UTILS_UTILS_H_
#define WESEP_TPU_TORCH_RUNTIME_UTILS_UTILS_H_

#include <string>
#include <vector>

namespace wesep {

// Split `input` on any char in `delim`, dropping empty tokens.
void SplitString(const std::string& input, const std::string& delim,
                 std::vector<std::string>* output);

// Read a kaldi-style scp: each non-empty line split on whitespace.
// Returns rows of tokens.
std::vector<std::vector<std::string>> ReadScp(const std::string& path);

}  // namespace wesep

#endif  // WESEP_TPU_TORCH_RUNTIME_UTILS_UTILS_H_
