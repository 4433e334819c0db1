// Host-side fast IO for the PyTorch port's TREC runs.
//
// Formatting and parsing multi-million-line TREC runs in Python costs
// noticeable host time (k=500 x thousands of queries per band set). This
// shared library provides:
//   - fastio_write_run:        bulk TREC run formatting + buffered write
//   - fastio_collapse_run_max: the bilingual docid#lang max-score collapse
// Built with g++ at first use and loaded via ctypes by
// codemix_dense_retrieval_torch/io/_fastio.py; io/trec.py keeps a
// pure-Python path with identical output.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

namespace {

// Split the first n '\n'-terminated fields of blob into C strings, in a
// copy held by store. Returns false when blob holds fewer than n fields.
bool split_fields(const char* blob, long n, std::vector<char>& store,
                  std::vector<const char*>& fields) {
  store.assign(blob, blob + std::strlen(blob) + 1);
  fields.clear();
  fields.reserve(n);
  char* p = store.data();
  for (long i = 0; i < n; ++i) {
    char* end = std::strchr(p, '\n');
    if (!end) return false;
    *end = '\0';
    fields.push_back(p);
    p = end + 1;
  }
  return true;
}

}  // namespace

// Write a TREC run: one line per (query, hit):  qid\tQ0\tdocid\trank\tscore\ttag
// qids: nq '\n'-terminated fields; docids: nq*k '\n'-terminated fields (row
// major); scores: nq*k floats. One buffer per column, not one Python string
// object per field: building nq*k ctypes pointers costs more than the write.
// Returns the number of lines written, or -1 on error.
long fastio_write_run(const char* path, const char* qid_blob, long nq,
                      const char* docid_blob, const float* scores, long k,
                      const char* tag, int precision) {
  std::vector<char> qid_store, doc_store;
  std::vector<const char*> qids, docids;
  if (!split_fields(qid_blob, nq, qid_store, qids) ||
      !split_fields(docid_blob, nq * k, doc_store, docids))
    return -1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  std::setvbuf(f, buf.data(), _IOFBF, buf.size());
  char fmt[64];
  std::snprintf(fmt, sizeof fmt, "%%s\tQ0\t%%s\t%%ld\t%%.%df\t%%s\n", precision);
  long lines = 0;
  for (long i = 0; i < nq; ++i) {
    for (long j = 0; j < k; ++j) {
      std::fprintf(f, fmt, qids[i], docids[i * k + j], j + 1,
                   static_cast<double>(scores[i * k + j]), tag);
      ++lines;
    }
  }
  if (std::fclose(f) != 0) return -1;
  return lines;
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
