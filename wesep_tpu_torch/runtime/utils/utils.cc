#include "utils/utils.h"

#include <fstream>
#include <sstream>

namespace wesep {

void SplitString(const std::string& input, const std::string& delim,
                 std::vector<std::string>* output) {
  output->clear();
  std::string token;
  for (char c : input) {
    if (delim.find(c) != std::string::npos) {
      if (!token.empty()) output->push_back(token);
      token.clear();
    } else {
      token.push_back(c);
    }
  }
  if (!token.empty()) output->push_back(token);
}

std::vector<std::vector<std::string>> ReadScp(const std::string& path) {
  std::vector<std::vector<std::string>> rows;
  std::ifstream in(path);
  std::string line;
  while (std::getline(in, line)) {
    std::vector<std::string> tokens;
    SplitString(line, " \t\r\n", &tokens);
    if (!tokens.empty()) rows.push_back(tokens);
  }
  return rows;
}

}  // namespace wesep
