// tracs_tpu native host-ingest library.
//
// The accelerator does the all-pairs math; this library keeps the *host* side fast:
//   * FASTA parsing + IUPAC bit-plane packing (the reference spends its
//     ingest time in kseq + per-character bitset stores, src/pairsnp.hpp:62-220).
//     Plain (uncompressed) files take an mmap + OpenMP-over-records path
//     with a branchless 256-entry nibble LUT pack, in place of a branchy
//     single-stream loop; gzip streams keep the single-pass reader
//     (decompression serialises anyway) with the same branchless inner loop
//   * htsbox pileup text parsing into [L, 4] count matrices (the reference
//     parses per-line in Python, tracs/align.py:449-474 — its slowest host loop)
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in image).

#include <algorithm>
#include <cctype>
#ifdef _OPENMP
#include <omp.h>
#else
static inline int omp_get_max_threads() { return 1; }
static inline int omp_get_thread_num() { return 0; }
#endif
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// gzip-capable line/byte reader with an internal buffer
class GzReader {
 public:
  explicit GzReader(const char* path) : f_(gzopen(path, "rb")) {}
  ~GzReader() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // read one line (without trailing newline); returns false at EOF
  bool getline(std::string& out) {
    out.clear();
    while (true) {
      if (pos_ >= len_) {
        len_ = gzread(f_, buf_, sizeof(buf_));
        pos_ = 0;
        if (len_ <= 0) return !out.empty();
      }
      char* nl = static_cast<char*>(memchr(buf_ + pos_, '\n', len_ - pos_));
      if (nl) {
        out.append(buf_ + pos_, nl - (buf_ + pos_));
        pos_ = (nl - buf_) + 1;
        return true;
      }
      out.append(buf_ + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  gzFile f_;
  char buf_[1 << 20];
  int len_ = 0;
  int pos_ = 0;
};

// IUPAC nibble LUT: bit0=A bit1=C bit2=G bit3=T, default N (=15) — matches
// tracs_tpu.ops.packing.NIBBLE_LUT and the reference loader's switch default
// (reference src/pairsnp.hpp:107-198)
struct NibbleLut {
  uint8_t t[256];
  NibbleLut() {
    for (int i = 0; i < 256; i++) t[i] = 15;
    auto set = [&](char c, uint8_t v) {
      t[static_cast<unsigned char>(c)] = v;
      t[static_cast<unsigned char>(std::tolower(c))] = v;
    };
    set('A', 1); set('C', 2); set('G', 4); set('T', 8);
    set('M', 3); set('R', 5); set('W', 9); set('S', 6); set('Y', 10);
    set('K', 12); set('V', 7); set('H', 11); set('D', 13); set('B', 14);
    set('N', 15);
  }
};
const NibbleLut kLut;

// Read-only mmap of a PLAIN (non-gzip) file; data()==nullptr when the file
// is missing, empty, or carries the gzip magic (callers then take the
// streaming gz path).
class PlainMap {
 public:
  explicit PlainMap(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 2) { close(fd); return; }
    unsigned char magic[2];
    if (pread(fd, magic, 2, 0) != 2 || (magic[0] == 0x1f && magic[1] == 0x8b)) {
      close(fd);
      return;
    }
    void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (p == MAP_FAILED) return;
    data_ = static_cast<const char*>(p);
    size_ = st.st_size;
  }
  ~PlainMap() {
    if (data_) munmap(const_cast<char*>(data_), size_);
  }
  const char* data() const { return data_; }
  int64_t size() const { return size_; }

 private:
  const char* data_ = nullptr;
  int64_t size_ = 0;
};

// Header offsets ('>' at line start) of a mapped FASTA.
std::vector<int64_t> fasta_headers(const char* d, int64_t n) {
  std::vector<int64_t> h;
  if (n > 0 && d[0] == '>') h.push_back(0);
  const char* p = d;
  const char* end = d + n;
  while ((p = static_cast<const char*>(memchr(p, '\n', end - p))) != nullptr) {
    ++p;
    if (p < end && *p == '>') h.push_back(p - d);
  }
  return h;
}

// Sequence length of record r (bytes minus line terminators).
int64_t record_seq_len(const char* d, int64_t seq_begin, int64_t seq_end) {
  int64_t len = seq_end - seq_begin;
  const char* p = d + seq_begin;
  const char* end = d + seq_end;
  while ((p = static_cast<const char*>(memchr(p, '\n', end - p))) != nullptr) {
    len--;
    if (p > d + seq_begin && p[-1] == '\r') len--;
    ++p;
  }
  return len;
}

// Branchless pack of one line span into 4 bit-plane accumulators flushed
// per 32-site word.  `site` advances by the span's char count.
inline void pack_span(const char* s, const char* e, uint32_t* base, int64_t W,
                      int64_t& site, uint32_t acc[4]) {
  for (const char* p = s; p < e; ++p) {
    const uint8_t nib = kLut.t[static_cast<unsigned char>(*p)];
    const uint32_t bit = 1u << (site & 31);
    acc[0] |= (0u - static_cast<uint32_t>(nib & 1)) & bit;
    acc[1] |= (0u - static_cast<uint32_t>((nib >> 1) & 1)) & bit;
    acc[2] |= (0u - static_cast<uint32_t>((nib >> 2) & 1)) & bit;
    acc[3] |= (0u - static_cast<uint32_t>((nib >> 3) & 1)) & bit;
    ++site;
    if (!(site & 31)) {
      const int64_t w = (site >> 5) - 1;
      base[w] = acc[0];
      base[W + w] = acc[1];
      base[2 * W + w] = acc[2];
      base[3 * W + w] = acc[3];
      acc[0] = acc[1] = acc[2] = acc[3] = 0;
    }
  }
}

inline void pack_flush_tail(uint32_t* base, int64_t W, int64_t site,
                            const uint32_t acc[4]) {
  if (site & 31) {
    const int64_t w = site >> 5;
    base[w] = acc[0];
    base[W + w] = acc[1];
    base[2 * W + w] = acc[2];
    base[3 * W + w] = acc[3];
  }
}

}  // namespace

extern "C" {

// First pass: count records and validate equal lengths.
// Returns n_seqs (>=0) or a negative error code; *seq_len receives L.
// Plain files go through mmap + memchr header scan with the per-record
// length validation parallelised; gzip streams keep the line reader.
int64_t tn_fasta_scan(const char* path, int64_t* seq_len) {
  {
    PlainMap m(path);
    if (m.data() != nullptr) {
      const char* d = m.data();
      const int64_t size = m.size();
      std::vector<int64_t> heads = fasta_headers(d, size);
      const int64_t n = static_cast<int64_t>(heads.size());
      if (n == 0) { *seq_len = 0; return 0; }
      std::vector<int64_t> bounds(n + 1);
      for (int64_t i = 0; i < n; ++i) bounds[i] = heads[i];
      bounds[n] = size;
      int64_t L = -1;
      int bad = 0;
#pragma omp parallel for schedule(dynamic, 16)
      for (int64_t i = 0; i < n; ++i) {
        const char* nl = static_cast<const char*>(
            memchr(d + bounds[i], '\n', bounds[i + 1] - bounds[i]));
        const int64_t seq_begin = nl ? (nl - d) + 1 : bounds[i + 1];
        const int64_t li = record_seq_len(d, seq_begin, bounds[i + 1]);
#pragma omp critical
        {
          if (L < 0) L = li;
          else if (li != L) bad = 1;
        }
      }
      if (bad) return -2;  // variable sequence lengths
      *seq_len = (L < 0 ? 0 : L);
      return n;
    }
  }
  GzReader r(path);
  if (!r.ok()) return -1;
  std::string line;
  int64_t n = 0, L = -1, cur = 0;
  bool in_seq = false;
  while (r.getline(line)) {
    if (!line.empty() && line[0] == '>') {
      if (in_seq) {
        if (L < 0) L = cur;
        else if (cur != L) return -2;  // variable sequence lengths
      }
      n++;
      cur = 0;
      in_seq = true;
    } else if (in_seq) {
      cur += static_cast<int64_t>(line.size());
      while (!line.empty() && (line.back() == '\r')) { cur--; line.pop_back(); }
    }
  }
  if (in_seq) {
    if (L < 0) L = cur;
    else if (cur != L) return -2;
  }
  *seq_len = (L < 0 ? 0 : L);
  return n;
}

// Second pass: pack into [n, 4, W] uint32 planes (W = ceil(L/32)) and copy
// names (first whitespace token) into fixed-width slots.  Plain files:
// mmap + OpenMP over records (each record owns its plane rows — no
// sharing), branchless LUT pack flushed per 32-site word.  Gzip streams:
// single pass with the same branchless span pack.
int64_t tn_fasta_pack(const char* path, uint32_t* planes, int64_t n_seqs,
                      int64_t L, char* names, int64_t name_cap) {
  const int64_t W = (L + 31) / 32;
  {
    PlainMap m(path);
    if (m.data() != nullptr) {
      const char* d = m.data();
      const int64_t size = m.size();
      std::vector<int64_t> heads = fasta_headers(d, size);
      const int64_t n = static_cast<int64_t>(heads.size());
      if (n > n_seqs) return -3;
      int overflow = 0;
#pragma omp parallel for schedule(dynamic, 4)
      for (int64_t rec = 0; rec < n; ++rec) {
        const int64_t rec_end = (rec + 1 < n) ? heads[rec + 1] : size;
        const char* nl = static_cast<const char*>(
            memchr(d + heads[rec], '\n', rec_end - heads[rec]));
        int64_t hdr_end = nl ? (nl - d) : rec_end;  // exclusive of '\n'
        // name = first whitespace token after '>'
        int64_t e = heads[rec] + 1;
        while (e < hdr_end && !std::isspace(static_cast<unsigned char>(d[e]))) e++;
        const int64_t len =
            std::min<int64_t>(e - heads[rec] - 1, name_cap - 1);
        memcpy(names + rec * name_cap, d + heads[rec] + 1, len);
        names[rec * name_cap + len] = '\0';

        uint32_t* base = planes + rec * 4 * W;
        uint32_t acc[4] = {0, 0, 0, 0};
        int64_t site = 0;
        const char* p = nl ? nl + 1 : d + rec_end;
        const char* end = d + rec_end;
        bool bad = false;
        while (p < end) {
          const char* le = static_cast<const char*>(memchr(p, '\n', end - p));
          const char* stop = le ? le : end;
          if (stop > p && stop[-1] == '\r') --stop;
          if (site + (stop - p) > L) { bad = true; break; }
          pack_span(p, stop, base, W, site, acc);
          p = le ? le + 1 : end;
        }
        if (bad) {
#pragma omp atomic write
          overflow = 1;
        } else {
          pack_flush_tail(base, W, site, acc);
        }
      }
      if (overflow) return -4;
      return n;
    }
  }
  GzReader r(path);
  if (!r.ok()) return -1;
  std::string line;
  int64_t rec = -1, site = 0;
  uint32_t acc[4] = {0, 0, 0, 0};
  uint32_t* base = nullptr;
  while (r.getline(line)) {
    if (!line.empty() && line[0] == '>') {
      if (base != nullptr) pack_flush_tail(base, W, site, acc);
      rec++;
      if (rec >= n_seqs) return -3;
      site = 0;
      acc[0] = acc[1] = acc[2] = acc[3] = 0;
      base = planes + rec * 4 * W;
      // name = first whitespace token
      size_t e = 1;
      while (e < line.size() && !std::isspace(static_cast<unsigned char>(line[e]))) e++;
      int64_t len = std::min<int64_t>(e - 1, name_cap - 1);
      memcpy(names + rec * name_cap, line.data() + 1, len);
      names[rec * name_cap + len] = '\0';
    } else if (rec >= 0) {
      const char* s = line.data();
      const char* e = s + line.size();
      if (e > s && e[-1] == '\r') --e;
      if (site + (e - s) > L) return -4;
      pack_span(s, e, base, W, site, acc);
    }
  }
  if (base != nullptr) pack_flush_tail(base, W, site, acc);
  return rec + 1;
}

// Parse an htsbox pileup text file (possibly gzipped) into a [L_total, 4]
// float32 count matrix laid out per-contig, with per-contig offsets supplied
// by the caller.
//
//   counts        : float32 [L_total, 4], zero-initialised by caller
//   contig_offs   : int64 [n_contigs] start row of each contig
//   contig_names  : concatenated NUL-separated names, in offset order
//   both_strands  : if nonzero, zero out alleles seen on only one strand
//                   (reference tracs/align.py:469-471)
//
// Line format (reference align.py:455-473):
//   contig  pos  ref  ...  nucs(,)  x:fwd,fwd,..:rev,rev,..
// Returns number of parsed lines, or negative on error.
int64_t tn_parse_pileup(const char* path, float* counts, int64_t l_total,
                        int64_t* contig_offs, int64_t n_contigs,
                        uint8_t* contig_names, int64_t names_len,
                        int both_strands) {
  GzReader r(path);
  if (!r.ok()) return -1;

  // build contig name -> offset lookup
  std::vector<std::string> names;
  std::vector<int64_t> offs;
  {
    const char* p = reinterpret_cast<const char*>(contig_names);
    const char* end = p + names_len;
    int64_t i = 0;
    while (p < end && i < n_contigs) {
      std::string nm(p);
      p += nm.size() + 1;
      names.push_back(std::move(nm));
      offs.push_back(contig_offs[i]);
      i++;
    }
    if (static_cast<int64_t>(names.size()) != n_contigs) return -2;
  }

  std::string line;
  int64_t parsed = 0;
  std::string cur_contig;
  int64_t cur_off = -1;

  std::vector<char*> fields;
  std::vector<char> buf;
  while (r.getline(line)) {
    if (line.empty()) continue;
    buf.assign(line.begin(), line.end());
    buf.push_back('\0');
    fields.clear();
    char* save = nullptr;
    for (char* tok = strtok_r(buf.data(), " \t", &save); tok;
         tok = strtok_r(nullptr, " \t", &save)) {
      fields.push_back(tok);
    }
    if (fields.size() < 4) continue;

    if (cur_contig != fields[0]) {
      cur_contig = fields[0];
      cur_off = -1;
      for (size_t i = 0; i < names.size(); i++) {
        if (names[i] == cur_contig) { cur_off = offs[i]; break; }
      }
    }
    if (cur_off < 0) continue;  // contig not requested

    const int64_t pos = strtoll(fields[1], nullptr, 10) - 1;
    // case-sensitive on purpose: the reference's npos lookup only has
    // upper-case keys (tracs/align.py:444,467)
    const char refc = fields[2][1] ? '\0' : fields[2][0];
    int ref_idx;
    switch (refc) {
      case 'A': ref_idx = 0; break;
      case 'C': ref_idx = 1; break;
      case 'G': ref_idx = 2; break;
      case 'T': ref_idx = 3; break;
      default: ref_idx = -1;
    }
    // skip lines whose reference base is not ACGT (align.py:467 checks
    // line[2]; allele loop writes nothing)
    char* nucs = fields[fields.size() - 2];
    char* countf = fields[fields.size() - 1];

    // countf = "x:fwd1,fwd2,..:rev1,rev2,.."
    char* c1 = strchr(countf, ':');
    if (!c1) continue;
    c1++;
    char* c2 = strchr(c1, ':');
    if (!c2) continue;
    *c2 = '\0';
    c2++;

    float row[4] = {0, 0, 0, 0};
    char *sn = nullptr, *s1 = nullptr, *s2 = nullptr;
    char* tn = strtok_r(nucs, ",", &sn);
    char* t1 = strtok_r(c1, ",", &s1);
    char* t2 = strtok_r(c2, ",", &s2);
    while (tn && t1 && t2) {
      int idx;
      switch (tn[0]) {
        case 'A': idx = tn[1] ? -1 : 0; break;
        case 'C': idx = tn[1] ? -1 : 1; break;
        case 'G': idx = tn[1] ? -1 : 2; break;
        case 'T': idx = tn[1] ? -1 : 3; break;
        default: idx = -1;
      }
      long f = strtol(t1, nullptr, 10);
      long b = strtol(t2, nullptr, 10);
      if (both_strands && (f == 0 || b == 0)) { f = 0; b = 0; }
      if (idx >= 0 && ref_idx >= 0) row[idx] = static_cast<float>(f + b);
      tn = strtok_r(nullptr, ",", &sn);
      t1 = strtok_r(nullptr, ",", &s1);
      t2 = strtok_r(nullptr, ",", &s2);
    }
    const int64_t out = cur_off + pos;
    if (out < 0 || out >= l_total) return -3;
    float* dst = counts + out * 4;
    dst[0] = row[0];
    dst[1] = row[1];
    dst[2] = row[2];
    dst[3] = row[3];
    parsed++;
  }
  return parsed;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FracMinHash sketching (sourmash-style scaled minhash, own hash/format)
// ---------------------------------------------------------------------------
//
// Rolling ntHash-style canonical k-mer hashing for arbitrary k:
//   fh_{i+1} = rol1(fh_i) ^ rol_k(H[s_i]) ^ H[s_{i+k}]
//   rh_{i+1} = ror1(rh_i ^ H[rc(s_i)] ^ rol_k(H[rc(s_{i+k})]))
//   canonical = min(fh, rh); kept when canonical <= 2^64 / scaled
// K-mers containing non-ACGT characters are skipped (window resets), the
// same convention sourmash uses.

namespace {

inline uint64_t rol(uint64_t x, int r) {
  r &= 63;
  return r ? (x << r) | (x >> (64 - r)) : x;
}
inline uint64_t ror1(uint64_t x) { return (x >> 1) | (x << 63); }

// fixed random 64-bit constants per base (A, C, G, T)
const uint64_t kBaseH[4] = {
    0x3c8bfbb395c60474ULL, 0x3193c18562a02b4cULL,
    0x20323ed082572324ULL, 0x295549f54be24456ULL,
};

inline int base_code(char c) {
  switch (c) {
    case 'A': case 'a': return 0;
    case 'C': case 'c': return 1;
    case 'G': case 'g': return 2;
    case 'T': case 't': return 3;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Sketch a FASTA/FASTQ(.gz) file.  Hashes with value <= 2^64/scaled are
// collected (deduplicated, sorted ascending) into out[0..capacity).
// Returns the number of hashes written, or negative on error
// (-5: more distinct hashes than capacity).
int64_t tn_sketch_file(const char* path, int64_t k, int64_t scaled,
                       uint64_t* out, int64_t capacity) {
  GzReader r(path);
  if (!r.ok()) return -1;
  if (k < 4 || k > 10000 || scaled < 1) return -2;
  const uint64_t max_hash = (uint64_t)(0xFFFFFFFFFFFFFFFFULL / (uint64_t)scaled);

  std::vector<uint64_t> hashes;
  std::string line;
  bool fastq = false, first = true;
  int fq_line = 0;  // 4-line cycle position for FASTQ

  // rolling window state
  uint64_t fh = 0, rh = 0;
  size_t filled = 0;
  std::vector<int> ring(k, 0);
  size_t ring_pos = 0;

  auto reset = [&]() { filled = 0; fh = rh = 0; ring_pos = 0; };

  auto feed = [&](char ch) {
    int b = base_code(ch);
    if (b < 0) { reset(); return; }
    if (filled < (size_t)k) {
      // build initial window hashes incrementally
      fh = rol(fh, 1) ^ kBaseH[b];               // fh accumulates rol^{k-1-t}
      rh = rh ^ rol(kBaseH[3 - b], (int)filled); // rh accumulates rol^{t}
      ring[ring_pos] = b;
      ring_pos = (ring_pos + 1) % k;
      filled++;
      if (filled < (size_t)k) return;
    } else {
      const int old_b = ring[ring_pos];
      fh = rol(fh, 1) ^ rol(kBaseH[old_b], (int)k) ^ kBaseH[b];
      rh = ror1(rh ^ kBaseH[3 - old_b] ^ rol(kBaseH[3 - b], (int)k));
      ring[ring_pos] = b;
      ring_pos = (ring_pos + 1) % k;
    }
    const uint64_t ch64 = fh < rh ? fh : rh;
    if (ch64 <= max_hash) hashes.push_back(ch64);
  };

  while (r.getline(line)) {
    if (first) {
      if (line.empty()) continue;
      fastq = (line[0] == '@');
      first = false;
    }
    if (!fastq) {
      if (!line.empty() && line[0] == '>') { reset(); continue; }
      for (char ch : line) { if (ch != '\r') feed(ch); }
    } else {
      // strict 4-line cycling (quality lines may begin with '@' or '+')
      const int which = fq_line & 3;
      fq_line++;
      if (which == 1) {
        reset();
        for (char ch : line) { if (ch != '\r') feed(ch); }
      }
    }
  }

  std::sort(hashes.begin(), hashes.end());
  hashes.erase(std::unique(hashes.begin(), hashes.end()), hashes.end());
  if ((int64_t)hashes.size() > capacity) return -5;
  memcpy(out, hashes.data(), hashes.size() * sizeof(uint64_t));
  return (int64_t)hashes.size();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// distance-CSV row formatter
// ---------------------------------------------------------------------------
//
// The distance stage emits up to O(n^2) CSV rows; Python float repr is the
// bottleneck there (~100k rows/s).  This formatter reproduces CPython's
// float repr exactly — std::to_chars shortest-round-trip digits, then
// CPython's fixed/scientific presentation rule (fixed iff -4 <= exp10 < 16,
// integral values get a trailing ".0", scientific exponents are sign+2
// digits) — so native and fallback writers are byte-identical.

#include <charconv>
#include <cmath>

namespace {

// Python-repr a double into out (no NUL); returns length.
inline int py_repr_double(double v, char* out) {
  if (std::isnan(v)) { memcpy(out, "nan", 3); return 3; }
  if (std::isinf(v)) {
    if (v < 0) { memcpy(out, "-inf", 4); return 4; }
    memcpy(out, "inf", 3); return 3;
  }
  char sci[48];
  auto res = std::to_chars(sci, sci + sizeof(sci), v, std::chars_format::scientific);
  // sci is [-]d[.ddd]e[-+]XX : extract sign, digit string, exponent
  const char* p = sci;
  char* o = out;
  if (*p == '-') { *o++ = '-'; ++p; }
  char digits[24];
  int nd = 0;
  digits[nd++] = *p++;          // leading digit
  if (*p == '.') {
    ++p;
    while (*p != 'e') digits[nd++] = *p++;
  }
  ++p;                          // 'e'
  int exp10 = 0;
  bool eneg = (*p == '-');
  ++p;                          // sign (to_chars always emits one)
  while (p < res.ptr) exp10 = exp10 * 10 + (*p++ - '0');
  if (eneg) exp10 = -exp10;

  if (-4 <= exp10 && exp10 < 16) {         // fixed notation
    if (exp10 >= nd - 1) {                 // integral: digits, zeros, ".0"
      memcpy(o, digits, nd); o += nd;
      for (int i = 0; i < exp10 - (nd - 1); ++i) *o++ = '0';
      *o++ = '.'; *o++ = '0';
    } else if (exp10 >= 0) {               // point inside the digits
      memcpy(o, digits, exp10 + 1); o += exp10 + 1;
      *o++ = '.';
      memcpy(o, digits + exp10 + 1, nd - exp10 - 1); o += nd - exp10 - 1;
    } else {                               // 0.00ddd
      *o++ = '0'; *o++ = '.';
      for (int i = 0; i < -exp10 - 1; ++i) *o++ = '0';
      memcpy(o, digits, nd); o += nd;
    }
  } else {                                 // scientific, CPython style
    *o++ = digits[0];
    if (nd > 1) {
      *o++ = '.';
      memcpy(o, digits + 1, nd - 1); o += nd - 1;
    }
    *o++ = 'e';
    *o++ = exp10 < 0 ? '-' : '+';
    int ae = exp10 < 0 ? -exp10 : exp10;
    char eb[8]; int ne = 0;
    do { eb[ne++] = char('0' + ae % 10); ae /= 10; } while (ae);
    while (ne < 2) eb[ne++] = '0';         // at least two exponent digits
    while (ne) *o++ = eb[--ne];
  }
  return (int)(o - out);
}

inline char* put_i64(int64_t v, char* o) {
  auto r = std::to_chars(o, o + 24, (long long)v);
  return r.ptr;
}

}  // namespace

extern "C" {

// Debug/testing hook: Python-repr one double into out (cap >= 32). Returns len.
int64_t tn_repr_double(double v, char* out) { return py_repr_double(v, out); }

// Format n distance-CSV rows:
//   nameA,nameB,<datediff|NA>,<d>,<p0|NA>,<eK|NA>,<filt|NA>,<nn>,<ref>\n
// names_blob/name_off: concatenated sample names with n_names+1 offsets.
// datediff/p0/eK may be NULL (-> "NA"); filt may be NULL (-> "NA").
// Returns bytes written, or -1 when out_cap could be exceeded.
int64_t tn_format_dist_rows(
    const char* names_blob, const int64_t* name_off,
    const int64_t* rows, const int64_t* cols, int64_t n,
    const double* datediff, const int64_t* dvals,
    const double* p0, const double* eK, const int64_t* filt,
    const int64_t* nn, const char* ref, int64_t ref_len,
    char* out, int64_t out_cap) {
  char* o = out;
  char* const end = out + out_cap;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t a = rows[i], b = cols[i];
    const int64_t la = name_off[a + 1] - name_off[a];
    const int64_t lb = name_off[b + 1] - name_off[b];
    // worst case: names + 3 doubles (<=32) + 2 ints (<=21) + filt + ref + 9
    if (o + la + lb + ref_len + 3 * 32 + 3 * 21 + 16 > end) return -1;
    memcpy(o, names_blob + name_off[a], la); o += la; *o++ = ',';
    memcpy(o, names_blob + name_off[b], lb); o += lb; *o++ = ',';
    if (datediff) { o += py_repr_double(datediff[i], o); } else { memcpy(o, "NA", 2); o += 2; }
    *o++ = ',';
    o = put_i64(dvals[i], o); *o++ = ',';
    if (p0) { o += py_repr_double(p0[i], o); } else { memcpy(o, "NA", 2); o += 2; }
    *o++ = ',';
    if (eK) { o += py_repr_double(eK[i], o); } else { memcpy(o, "NA", 2); o += 2; }
    *o++ = ',';
    if (filt) { o = put_i64(filt[i], o); } else { memcpy(o, "NA", 2); o += 2; }
    *o++ = ',';
    o = put_i64(nn[i], o); *o++ = ',';
    memcpy(o, ref, ref_len); o += ref_len;
    *o++ = '\n';
  }
  return (int64_t)(o - out);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// distance-CSV reader (cluster stage ingest)
// ---------------------------------------------------------------------------
//
// The cluster stage streams the (up to O(n^2)-row) distance CSV back in;
// the reference parses it line-by-line in Python (tracs/cluster.py:90-113).
// Semantics preserved: header skipped blindly, sample ids assigned in
// first-appearance order scanning (sampleA, sampleB) row by row, edges kept
// when float(field[col]) <= threshold, a non-numeric metric field is an
// error (the reference's float("NA") ValueError).

#include <string_view>
#include <unordered_map>

extern "C" {

// Count data rows (lines after the header).  Returns >= 0 or -1 on open error.
int64_t tn_dist_csv_scan(const char* path) {
  GzReader r(path);
  if (!r.ok()) return -1;
  std::string line;
  int64_t n = -1;  // header
  while (r.getline(line)) ++n;
  return n < 0 ? 0 : n;
}

// Parse the CSV.  I/J receive first-appearance sample ids of rows whose
// metric value <= threshold (cap_edges >= n_rows from tn_dist_csv_scan).
// names_blob receives NUL-terminated names in id order.  Outputs:
// n_out[0]=n_edges, n_out[1]=n_names, n_out[2]=n_rows, n_out[3]=blob bytes.
// Returns 0, or: -1 open, -2 blob overflow, -3 short row, -4 bad float.
int64_t tn_read_dist_csv(const char* path, int64_t col_index, double threshold,
                         int64_t* I, int64_t* J, int64_t cap_edges,
                         char* names_blob, int64_t names_cap,
                         int64_t* n_out) {
  GzReader r(path);
  if (!r.ok()) return -1;
  std::string line;
  if (!r.getline(line)) {  // empty file: zero rows
    n_out[0] = n_out[1] = n_out[2] = n_out[3] = 0;
    return 0;
  }
  std::unordered_map<std::string, int64_t> ids;
  int64_t blob_len = 0, n_edges = 0, n_rows = 0;

  auto intern = [&](const char* s, size_t len) -> int64_t {
    auto it = ids.find(std::string(s, len));
    if (it != ids.end()) return it->second;
    int64_t id = (int64_t)ids.size();
    ids.emplace(std::string(s, len), id);
    if (blob_len + (int64_t)len + 1 > names_cap) return -1;
    memcpy(names_blob + blob_len, s, len);
    blob_len += len;
    names_blob[blob_len++] = '\0';
    return id;
  };

  while (r.getline(line)) {
    // strip (reference .strip())
    const char* b = line.c_str();
    const char* e = b + line.size();
    while (b < e && (unsigned char)*b <= ' ') ++b;
    while (e > b && (unsigned char)e[-1] <= ' ') --e;
    // split fields on ','
    const char* f[16];
    size_t fl[16];
    int nf = 0;
    const char* p = b;
    while (nf < 16) {
      const char* c = (const char*)memchr(p, ',', e - p);
      f[nf] = p;
      fl[nf] = (c ? c : e) - p;
      ++nf;
      if (!c) break;
      p = c + 1;
    }
    if (nf < 2 || col_index >= nf) return -3;
    int64_t ia = intern(f[0], fl[0]);
    if (ia < 0) return -2;
    int64_t ib = intern(f[1], fl[1]);
    if (ib < 0) return -2;
    // float(field) semantics: full-field numeric parse (ws tolerated)
    char tmp[64];
    size_t vl = fl[col_index] < 63 ? fl[col_index] : 63;
    memcpy(tmp, f[col_index], vl);
    tmp[vl] = '\0';
    char* endp = nullptr;
    double v = strtod(tmp, &endp);
    while (endp && *endp && (unsigned char)*endp <= ' ') ++endp;
    if (endp == tmp || (endp && *endp)) return -4;
    if (v <= threshold) {
      if (n_edges >= cap_edges) return -3;
      I[n_edges] = ia;
      J[n_edges] = ib;
      ++n_edges;
    }
    ++n_rows;
  }
  n_out[0] = n_edges;
  n_out[1] = (int64_t)ids.size();
  n_out[2] = n_rows;
  n_out[3] = blob_len;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// recombination-filter window statistics (ops/recomb.py::_filter_flat)
// ---------------------------------------------------------------------------
//
// Per-SNP windowed counts and spans over flat (segment, position) vectors.
// Positions are sorted within each pair's segment, so both window edges
// advance monotonically: a two-pointer sweep is O(n_snps) total, replacing
// the numpy path's two global binary-search passes (O(n log n) with
// cache-hostile probes).  Semantics identical to the searchsorted
// formulation (reference: src/pairsnp.hpp:223-248 range_count, whose span
// runs from the first to the last in-window SNP).

extern "C" {

// pos        : int64 [n_snps], sorted within each segment
// seg_bounds : int64 [n_pairs + 1], segment s = [seg_bounds[s], seg_bounds[s+1])
// w          : int64 [n_pairs] window half-width per pair
// count/span : int32/int64 [n_snps] outputs
void tn_window_stats(const int64_t* pos, int64_t n_snps,
                     const int64_t* seg_bounds, int64_t n_pairs,
                     const int64_t* w, int32_t* count, int64_t* span) {
  (void)n_snps;
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < n_pairs; ++s) {
    const int64_t b = seg_bounds[s], e = seg_bounds[s + 1];
    const int64_t ws = w[s];
    int64_t lo = b, hi = b;
    for (int64_t i = b; i < e; ++i) {
      const int64_t p = pos[i];
      while (pos[lo] < p - ws) ++lo;
      if (hi <= i) hi = i + 1;
      while (hi < e && pos[hi] <= p + ws) ++hi;
      count[i] = (int32_t)(hi - lo);
      span[i] = pos[hi - 1] - pos[lo] + 1;
    }
  }
}

}  // extern "C"

extern "C" {

// Full filter pass: windowed (count, span) via the same two-pointer sweep,
// keep decision resolved inline from per-pair boolean tables
// (ops/recomb.py::_keep_table — keep[count-2][span] for 2 <= count <= cap),
// kept-SNP counts accumulated per pair.  SNPs whose window holds more than
// ``cap`` neighbours are marked in ovf_mark (caller resolves those rare
// cases in Python and subtracts the rejects); they are counted as kept here.
// Replaces ~10 full-array numpy passes over the flat SNP vectors, which
// dominated the filter at 10^8 SNPs.
void tn_filter_windows(const int64_t* pos, int64_t n_snps,
                       const int64_t* seg_bounds, int64_t n_pairs,
                       const int64_t* w,
                       const uint8_t* tables, const int64_t* tab_off,
                       const int64_t* tab_width, int64_t cap,
                       int64_t* kept, uint8_t* ovf_mark) {
  (void)n_snps;
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < n_pairs; ++s) {
    const int64_t b = seg_bounds[s], e = seg_bounds[s + 1];
    const int64_t ws = w[s];
    const uint8_t* tab = tables + tab_off[s];
    const int64_t width = tab_width[s];
    int64_t lo = b, hi = b, nk = 0;
    for (int64_t i = b; i < e; ++i) {
      const int64_t p = pos[i];
      while (pos[lo] < p - ws) ++lo;
      if (hi <= i) hi = i + 1;
      while (hi < e && pos[hi] <= p + ws) ++hi;
      const int64_t count = hi - lo;
      if (count <= 1) {
        ++nk;  // singleton windows always kept (pairsnp.hpp:310-312)
      } else if (count <= cap) {
        nk += tab[(count - 2) * width + (pos[hi - 1] - pos[lo] + 1)];
      } else {
        ovf_mark[i] = 1;
        ++nk;  // provisional; caller subtracts resolved rejects
      }
    }
    kept[s] = nk;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// split-layout statistics (ops/packing.py::split_alignment)
// ---------------------------------------------------------------------------
//
// One streaming pass over the packed [n, 4, W] planes producing every
// derived tensor the split layout and the compact 2-bit upload path need.
// The former numpy build ran ~10 separate broadcasted passes (~40 GB of
// memory traffic at 10k x 1 Mb); here each plane word is read once and all outputs fall out of the same
// registers.  Semantics mirror ops/packing.py exactly:
//   all4   = A & C & G & T                       (N mask)
//   excl   = plane & ~all4                       (N-exclusive singletons)
//   cnt_n  = sum(popcount(all4))                 (per sample)
//   ge2    = any-two-planes overlap (incl. N)    (exception-site mask for
//                                                 the 2-bit upload)
//   b0     = (C | T) & ~ge2                      (2-bit code bit 0)
//   b1     = (G | T) & ~ge2                      (2-bit code bit 1)
//   partial_or = OR over samples of (ge2 & ~all4)  (partial_site_positions)

extern "C" {

void tn_split_stats(const uint32_t* planes, int64_t n, int64_t W,
                    uint32_t* excl, uint32_t* nmask, int64_t* cnt_n,
                    uint32_t* ge2, uint32_t* b0, uint32_t* b1,
                    uint32_t* partial_or) {
  const int nthreads = omp_get_max_threads();
  std::vector<uint32_t> por_local((size_t)nthreads * W, 0u);
#pragma omp parallel
  {
    uint32_t* por = por_local.data() + (size_t)omp_get_thread_num() * W;
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t* pa = planes + i * 4 * W;
      const uint32_t* pc = pa + W;
      const uint32_t* pg = pa + 2 * W;
      const uint32_t* pt = pa + 3 * W;
      uint32_t* ea = excl + i * 4 * W;
      uint32_t* ec = ea + W;
      uint32_t* eg = ea + 2 * W;
      uint32_t* et = ea + 3 * W;
      uint32_t* nm = nmask + i * W;
      uint32_t* g2 = ge2 + i * W;
      uint32_t* c0 = b0 + i * W;
      uint32_t* c1 = b1 + i * W;
      int64_t cn = 0;
      for (int64_t w = 0; w < W; ++w) {
        const uint32_t a = pa[w], c = pc[w], g = pg[w], t = pt[w];
        const uint32_t all4 = a & c & g & t;
        const uint32_t two =
            (a & c) | (a & g) | (a & t) | (c & g) | (c & t) | (g & t);
        ea[w] = a & ~all4;
        ec[w] = c & ~all4;
        eg[w] = g & ~all4;
        et[w] = t & ~all4;
        nm[w] = all4;
        g2[w] = two;
        c0[w] = (c | t) & ~two;
        c1[w] = (g | t) & ~two;
        por[w] |= two & ~all4;
        cn += __builtin_popcount(all4);
      }
      cnt_n[i] = cn;
    }
  }
  for (int64_t w = 0; w < W; ++w) {
    uint32_t acc = 0;
    for (int th = 0; th < nthreads; ++th) acc |= por_local[(size_t)th * W + w];
    partial_or[w] = acc;
  }
}

}  // extern "C"
