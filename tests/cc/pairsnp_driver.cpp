// Differential-test driver: compiles the READ-ONLY reference pairsnp kernel
// (including filter_recomb) against boost stand-ins and prints its sparse
// COO output, so tests can byte-compare the device kernels with the actual
// reference C++ (reference src/pairsnp.hpp:320-458, 223-318).
//
//   g++ -O2 -std=c++17 -I tests/cc/boost_stub -I /root/reference/src \
//       -DREFERENCE_PAIRSNP_HPP='"/root/reference/src/pairsnp.hpp"' \
//       tests/cc/pairsnp_driver.cpp -lz -o pairsnp_driver
//
//   ./pairsnp_driver <dist> <filter:0|1> <fasta1> [fasta2]
//
// Output: first line = comma-joined sequence names; then one line per pair
// "row col dist filt nn".

#include <cstdio>
#include <string>
#include <vector>

// the reference header calls PyErr_CheckSignals (provided by Python.h in
// its pybind build); a no-op suffices for a standalone driver
static inline int PyErr_CheckSignals() { return 0; }

#include REFERENCE_PAIRSNP_HPP

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s dist filter fasta1 [fasta2]\n", argv[0]);
    return 2;
  }
  int dist = std::atoi(argv[1]);
  bool filt = std::atoi(argv[2]) != 0;
  std::vector<std::string> fastas;
  for (int i = 3; i < argc; ++i) fastas.emplace_back(argv[i]);

  auto result = pairsnp(fastas, 1, dist, filt);
  const auto& rows = std::get<0>(result);
  const auto& cols = std::get<1>(result);
  const auto& dists = std::get<2>(result);
  const auto& names = std::get<3>(result);
  const auto& filts = std::get<4>(result);
  const auto& nns = std::get<5>(result);

  for (size_t i = 0; i < names.size(); ++i)
    std::printf("%s%s", i ? "," : "", names[i].c_str());
  std::printf("\n");
  for (size_t k = 0; k < rows.size(); ++k)
    std::printf("%llu %llu %llu %llu %llu\n",
                (unsigned long long)rows[k], (unsigned long long)cols[k],
                (unsigned long long)dists[k], (unsigned long long)filts[k],
                (unsigned long long)nns[k]);
  return 0;
}
