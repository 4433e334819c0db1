// Host-side fast IO for the PyTorch port's TREC runs.
//
// Formatting and parsing multi-million-line TREC runs in Python costs
// noticeable host time (k=500 x thousands of queries per band set). This
// shared library provides:
//   - fastio_field_offsets:    the offsets of a blob's newline-ended fields
//   - fastio_write_run_ids:    a TREC run from row ids into a docid table
//   - fastio_write_run:        a TREC run from string rows
//   - fastio_collapse_run_max: the bilingual docid#lang max-score collapse
// The two writers share one formatting core: lines are assembled with
// memcpy in a large buffer flushed by write(2), scores are printed from an
// exact fixed-point integer, and no printf runs per line.
// Built with g++ at first use and loaded via ctypes by
// codemix_dense_retrieval_torch/io/_fastio.py; io/trec.py keeps a
// pure-Python path with identical output.

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// The largest precision the core takes: the writers return -1 above it, and
// io/trec.py writes such a run on its Python path.
constexpr int kMaxPrecision = 64;

// An output file: a buffer flushed with write(2) whenever a line does not
// fit in what is left of it.
class Out {
 public:
  explicit Out(int fd) : fd_(fd) { grow(size_t{8} << 20); }

  // A cursor with at least n free bytes behind it; commit() moves past
  // what was written there.
  char* room(size_t n) {
    if (static_cast<size_t>(end_ - cur_) < n) {
      flush();
      if (static_cast<size_t>(end_ - buf_.get()) < n) grow(n);
    }
    return cur_;
  }
  void commit(char* p) { cur_ = p; }

  // Writes out the buffer; false once any write has failed.
  bool flush() {
    const char* p = buf_.get();
    while (ok_ && p < cur_) {
      ssize_t w = ::write(fd_, p, static_cast<size_t>(cur_ - p));
      if (w < 0 && errno == EINTR) continue;
      if (w <= 0) ok_ = false;
      else p += w;
    }
    cur_ = buf_.get();
    return ok_;
  }

 private:
  void grow(size_t n) {
    buf_.reset(new char[n]);
    cur_ = buf_.get();
    end_ = cur_ + n;
  }

  int fd_;
  bool ok_ = true;
  std::unique_ptr<char[]> buf_;
  char* cur_ = nullptr;
  char* end_ = nullptr;
};

// Field i of a blob of newline-ended fields: [off[i], off[i + 1] - 1).
struct Fields {
  const char* blob;
  const int64_t* off;
  const char* at(int64_t i) const { return blob + off[i]; }
  size_t len(int64_t i) const { return static_cast<size_t>(off[i + 1] - off[i] - 1); }
};

char* put_bytes(char* o, const char* s, size_t n) {
  std::memcpy(o, s, n);
  return o + n;
}

char* put_uint(char* o, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *o++ = tmp[--n];
  return o;
}

constexpr double kPow10[13] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11, 1e12};
constexpr uint64_t kPow10Int[13] = {1ull, 10ull, 100ull, 1000ull, 10000ull, 100000ull, 1000000ull,
                                    10000000ull, 100000000ull, 1000000000ull, 10000000000ull,
                                    100000000000ull, 1000000000000ull};

// The bytes printf("%.*f", p, (double)x) writes, at most cap (room for the
// NUL too). |x| * 10^p is exact in a double for p <= 12 (24 mantissa bits
// times 5^p < 2^28; the 2^p is exponent only), and nearbyint rounds that
// exact value half to even in the default rounding mode, as glibc does; a
// set sign bit prints '-' (so -0.0000). Values that are not finite, that
// reach 2^53 once scaled, or a p above 12 take snprintf.
char* put_score(char* o, float xf, int p, size_t cap) {
  const double x = xf;
  if (p <= 12 && std::isfinite(x)) {
    const double a = std::fabs(x) * kPow10[p];
    if (a < 9007199254740992.0) {
      const uint64_t v = static_cast<uint64_t>(std::nearbyint(a));
      if (std::signbit(x)) *o++ = '-';
      o = put_uint(o, v / kPow10Int[p]);
      if (p > 0) {
        *o++ = '.';
        uint64_t frac = v % kPow10Int[p];
        for (int i = p - 1; i >= 0; --i) {
          o[i] = static_cast<char>('0' + frac % 10);
          frac /= 10;
        }
        o += p;
      }
      return o;
    }
  }
  return o + std::snprintf(o, cap, "%.*f", p, x);
}

// The formatting core: nq * k lines "qid\tQ0\tdocid\trank\tscore\ttag\n",
// the docid of line t = i * k + j given by doc(t) as a (pointer, length)
// pair. Row ids land anywhere in a docid table of millions of rows, so the
// lines go in blocks: one pass gathers each line's docid field (independent
// loads the core can overlap), the next formats them with the fields a few
// lines ahead prefetched. Returns the number of lines written, or -1 on
// error.
template <class Doc>
long write_lines(const char* path, Fields qids, long nq, long k, Doc doc, const float* scores,
                 const char* tag, int precision) {
  if (precision < 0 || precision > kMaxPrecision) return -1;
  const int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC | O_CLOEXEC, 0666);
  if (fd < 0) return -1;
  constexpr long kBlock = 4096, kAhead = 16;
  const size_t tag_n = std::strlen(tag);
  // the score's longest print: sign, 39 integer digits of FLT_MAX, '.',
  // the fraction and the NUL
  const size_t score_cap = 42 + static_cast<size_t>(precision);
  std::vector<std::pair<const char*, size_t>> docs(kBlock);
  Out out(fd);
  const long total = nq * k;
  long i = 0, j = 0;
  for (long t0 = 0; t0 < total; t0 += kBlock) {
    const long n = std::min(kBlock, total - t0);
    for (long b = 0; b < n; ++b) docs[b] = doc(t0 + b);
    for (long b = 0; b < n; ++b) {
      if (b + kAhead < n) __builtin_prefetch(docs[b + kAhead].first);
      const char* q = qids.at(i);
      const size_t q_n = qids.len(i);
      const std::pair<const char*, size_t> d = docs[b];
      // fixed bytes: "\tQ0\t", three '\t', '\n'; the rank's 20 digits
      char* o = out.room(q_n + d.second + tag_n + 28 + score_cap);
      o = put_bytes(o, q, q_n);
      o = put_bytes(o, "\tQ0\t", 4);
      o = put_bytes(o, d.first, d.second);
      *o++ = '\t';
      o = put_uint(o, static_cast<uint64_t>(j + 1));
      *o++ = '\t';
      o = put_score(o, scores[t0 + b], precision, score_cap);
      *o++ = '\t';
      o = put_bytes(o, tag, tag_n);
      *o++ = '\n';
      out.commit(o);
      if (++j == k) {
        j = 0;
        ++i;
      }
    }
  }
  const bool flushed = out.flush();
  const bool closed = ::close(fd) == 0;
  return flushed && closed ? total : -1;
}

}  // namespace

extern "C" {

// Offsets of the n newline-ended fields of blob (len bytes) into off
// (n + 1 entries): field i is [off[i], off[i + 1] - 1). Returns n, or -1
// when blob holds another number of fields or does not end with '\n'.
long fastio_field_offsets(const char* blob, long len, long n, int64_t* off) {
  off[0] = 0;
  long i = 0;
  const char* p = blob;
  const char* end = blob + len;
  while (p < end) {
    const void* nl = std::memchr(p, '\n', static_cast<size_t>(end - p));
    if (nl == nullptr || i == n) return -1;
    p = static_cast<const char*>(nl) + 1;
    off[++i] = p - blob;
  }
  return i == n ? n : -1;
}

// Write a TREC run from row ids: hit (i, j) is the docid field ids[i*k+j]
// of the docid table (doc_blob, doc_off); qid i the field i of (qid_blob,
// qid_off); scores nq*k floats. The ids are checked by the caller.
// Returns the number of lines written, or -1 on error.
long fastio_write_run_ids(const char* path, const char* qid_blob, const int64_t* qid_off, long nq,
                          const char* doc_blob, const int64_t* doc_off, const int64_t* ids, long k,
                          const float* scores, const char* tag, int precision) {
  const Fields docs{doc_blob, doc_off};
  return write_lines(path, Fields{qid_blob, qid_off}, nq, k,
                     [&](long t) { return std::make_pair(docs.at(ids[t]), docs.len(ids[t])); },
                     scores, tag, precision);
}

// Write a TREC run from string rows: qids nq '\n'-terminated fields;
// docids nq*k '\n'-terminated fields (row major); scores nq*k floats. One
// buffer per column, not one Python string object per field: building
// nq*k ctypes pointers costs more than the write. Returns the number of
// lines written, or -1 on error (a blob with another number of fields).
long fastio_write_run(const char* path, const char* qid_blob, long nq, const char* docid_blob,
                      const float* scores, long k, const char* tag, int precision) {
  std::vector<int64_t> qid_off(static_cast<size_t>(nq) + 1), doc_off(static_cast<size_t>(nq * k) + 1);
  if (fastio_field_offsets(qid_blob, static_cast<long>(std::strlen(qid_blob)), nq, qid_off.data()) != nq ||
      fastio_field_offsets(docid_blob, static_cast<long>(std::strlen(docid_blob)), nq * k,
                           doc_off.data()) != nq * k)
    return -1;
  const Fields docs{docid_blob, doc_off.data()};
  return write_lines(path, Fields{qid_blob, qid_off.data()}, nq, k,
                     [&](long t) { return std::make_pair(docs.at(t), docs.len(t)); },
                     scores, tag, precision);
}

namespace {

struct QidGroup {
  std::vector<std::string> order;                    // first-seen base ids
  std::unordered_map<std::string, double> max_score; // base -> max score
};

}  // namespace

// Collapse docid#lang duplicates by max score: per qid (first-seen order), per base
// docid keep the max score, stable-sort by score descending, re-rank from 1.
// Returns 1 on success, 0 on error.
int fastio_collapse_run_max(const char* in_path, const char* out_path,
                            const char* tag) {
  FILE* in = std::fopen(in_path, "rb");
  if (!in) return 0;
  std::vector<std::string> qid_order;
  std::unordered_map<std::string, QidGroup> by_q;

  char line[1 << 16];
  while (std::fgets(line, sizeof line, in)) {
    // fields: qid _ docid rank score tag   (whitespace separated)
    char qid[4096], docid[8192], score_s[128];
    // skip blank lines
    char* p = line;
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
    if (!*p) continue;
    if (std::sscanf(p, "%4095s %*s %8191s %*s %127s", qid, docid, score_s) != 3)
      { std::fclose(in); return 0; }
    char* hash = std::strchr(docid, '#');
    if (hash) *hash = '\0';
    double score = std::strtod(score_s, nullptr);
    auto it = by_q.find(qid);
    if (it == by_q.end()) {
      qid_order.emplace_back(qid);
      it = by_q.emplace(qid, QidGroup{}).first;
    }
    QidGroup& g = it->second;
    auto sit = g.max_score.find(docid);
    if (sit == g.max_score.end()) {
      g.order.emplace_back(docid);
      g.max_score.emplace(docid, score);
    } else if (score > sit->second) {
      sit->second = score;
    }
  }
  std::fclose(in);

  FILE* out = std::fopen(out_path, "wb");
  if (!out) return 0;
  std::vector<char> buf(1 << 22);
  std::setvbuf(out, buf.data(), _IOFBF, buf.size());
  for (const std::string& qid : qid_order) {
    QidGroup& g = by_q[qid];
    // indices into g.order, stable sort by score desc (ties keep first-seen)
    std::vector<uint32_t> idx(g.order.size());
    for (uint32_t i = 0; i < idx.size(); ++i) idx[i] = i;
    std::stable_sort(idx.begin(), idx.end(), [&](uint32_t a, uint32_t b) {
      return g.max_score[g.order[a]] > g.max_score[g.order[b]];
    });
    long rank = 1;
    for (uint32_t i : idx) {
      const std::string& base = g.order[i];
      std::fprintf(out, "%s Q0 %s %ld %.6f %s\n", qid.c_str(), base.c_str(),
                   rank++, g.max_score[base], tag);
    }
  }
  if (std::fclose(out) != 0) return 0;
  return 1;
}

}  // extern "C"
