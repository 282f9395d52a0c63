// dftpu native runtime: host-side hot paths of the query engine.
//
// Copy of native/dftpu_native.cpp for the torch port (built by
// datafusion_tpu_torch/native_lib.py with g++ into _build/).  The
// reference engine's runtime is native end to end (Rust: CSV reader
// csv.rs, shuffle repartitioner repartition.rs:240 / shuffle_writer.rs:184,
// Arrow IPC spill utils core/src/utils.rs:69).  The engine keeps the
// compute path on the device and implements these host runtime pieces in
// C++:
//
//   1. columnar CSV/TBL loader  -> typed buffers + null masks + sorted
//      string dictionaries (the data-loader the device ingests from)
//   2. shuffle hash partitioner -> counting-sort permutation used by
//      host-side bucketing
//   3. bulk gather helpers for spill writing
//
// Exposed as a C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// 1. CSV / TBL loader
// ---------------------------------------------------------------------------
// kinds: 0=int64  1=float64  2=date32(YYYY-MM-DD)  3=decimal->int64 scaled
//        4=bool   5=string (dictionary-encoded)    6=timestamp_us

enum ColKind {
  K_INT64 = 0,
  K_FLOAT64 = 1,
  K_DATE32 = 2,
  K_DECIMAL = 3,
  K_BOOL = 4,
  K_STRING = 5,
  K_TIMESTAMP = 6,
};

struct ColumnData {
  int kind = K_INT64;
  int scale = 0;
  std::vector<int64_t> i64;       // int64 / decimal / timestamp
  std::vector<double> f64;        // float64
  std::vector<int32_t> i32;       // date32 / string codes
  std::vector<uint8_t> valid;
  // string dictionary build state
  std::unordered_map<std::string, int32_t> dict_map;
  std::vector<std::string> dict_values;  // insertion order; sorted at finish
};

struct DftpuCsv {
  long nrows = 0;
  std::vector<ColumnData> cols;
};

// days_from_civil (Howard Hinnant's algorithm, public domain)
static int32_t days_from_civil(int y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + static_cast<int>(doe) - 719468;
}

static bool parse_date32(const char* s, size_t len, int32_t* out) {
  // YYYY-MM-DD
  if (len < 10 || s[4] != '-' || s[7] != '-') return false;
  int y = 0;
  for (int i = 0; i < 4; i++) {
    if (s[i] < '0' || s[i] > '9') return false;
    y = y * 10 + (s[i] - '0');
  }
  int m = (s[5] - '0') * 10 + (s[6] - '0');
  int d = (s[8] - '0') * 10 + (s[9] - '0');
  if (m < 1 || m > 12 || d < 1 || d > 31) return false;
  *out = days_from_civil(y, (unsigned)m, (unsigned)d);
  return true;
}

static bool parse_timestamp_us(const char* s, size_t len, int64_t* out) {
  // YYYY-MM-DD[ T]HH:MM:SS[.ffffff]
  int32_t days;
  if (!parse_date32(s, len, &days)) return false;
  int64_t us = (int64_t)days * 86400000000LL;
  if (len >= 19 && (s[10] == ' ' || s[10] == 'T')) {
    int hh = (s[11] - '0') * 10 + (s[12] - '0');
    int mi = (s[14] - '0') * 10 + (s[15] - '0');
    int ss = (s[17] - '0') * 10 + (s[18] - '0');
    us += ((int64_t)hh * 3600 + mi * 60 + ss) * 1000000LL;
    if (len > 20 && s[19] == '.') {
      int64_t frac = 0, mult = 100000;
      for (size_t i = 20; i < len && s[i] >= '0' && s[i] <= '9' && mult > 0; i++) {
        frac += (s[i] - '0') * mult;
        mult /= 10;
      }
      us += frac;
    }
  }
  *out = us;
  return true;
}

static bool parse_i64(const char* s, size_t len, int64_t* out) {
  if (len == 0) return false;
  size_t i = 0;
  bool neg = false;
  if (s[0] == '-' || s[0] == '+') { neg = s[0] == '-'; i = 1; }
  if (i >= len) return false;
  int64_t v = 0;
  for (; i < len; i++) {
    if (s[i] < '0' || s[i] > '9') return false;
    v = v * 10 + (s[i] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

static bool parse_decimal(const char* s, size_t len, int scale, int64_t* out) {
  // fixed-point: sign, integer part, optional .fraction; half-away rounding
  if (len == 0) return false;
  size_t i = 0;
  bool neg = false;
  if (s[0] == '-' || s[0] == '+') { neg = s[0] == '-'; i = 1; }
  int64_t ip = 0;
  bool any = false;
  for (; i < len && s[i] != '.'; i++) {
    if (s[i] < '0' || s[i] > '9') return false;
    ip = ip * 10 + (s[i] - '0');
    any = true;
  }
  int64_t frac = 0;
  int fdigits = 0;
  bool round_up = false;
  if (i < len && s[i] == '.') {
    i++;
    for (; i < len; i++) {
      if (s[i] < '0' || s[i] > '9') return false;
      if (fdigits < scale) {
        frac = frac * 10 + (s[i] - '0');
        fdigits++;
      } else if (fdigits == scale) {
        round_up = s[i] >= '5';
        fdigits++;  // ignore further digits
      }
      any = true;
    }
  }
  if (!any) return false;
  while (fdigits < scale) { frac *= 10; fdigits++; }
  int64_t pow10 = 1;
  for (int k = 0; k < scale; k++) pow10 *= 10;
  int64_t v = ip * pow10 + frac + (round_up ? 1 : 0);
  *out = neg ? -v : v;
  return true;
}

static bool parse_f64(const char* s, size_t len, double* out) {
  char buf[64];
  if (len == 0 || len >= sizeof(buf)) return false;
  memcpy(buf, s, len);
  buf[len] = 0;
  char* end = nullptr;
  double v = strtod(buf, &end);
  if (end != buf + len) return false;
  *out = v;
  return true;
}

static bool parse_bool(const char* s, size_t len, int64_t* out) {
  if (len == 1) {
    if (s[0] == '1' || s[0] == 't' || s[0] == 'T') { *out = 1; return true; }
    if (s[0] == '0' || s[0] == 'f' || s[0] == 'F') { *out = 0; return true; }
  }
  if (len == 4 && strncasecmp(s, "true", 4) == 0) { *out = 1; return true; }
  if (len == 5 && strncasecmp(s, "false", 5) == 0) { *out = 0; return true; }
  return false;
}

static void append_field(ColumnData& c, const char* s, size_t len) {
  // unquote "..." with doubled-quote escapes
  std::string unq;
  if (len >= 2 && s[0] == '"' && s[len - 1] == '"') {
    unq.reserve(len);
    for (size_t i = 1; i + 1 < len; i++) {
      if (s[i] == '"' && i + 2 < len && s[i + 1] == '"') { unq.push_back('"'); i++; }
      else unq.push_back(s[i]);
    }
    s = unq.data();
    len = unq.size();
  }
  bool is_null = (len == 0);
  switch (c.kind) {
    case K_INT64: {
      int64_t v = 0;
      bool ok = !is_null && parse_i64(s, len, &v);
      c.i64.push_back(ok ? v : 0);
      c.valid.push_back(ok);
      break;
    }
    case K_FLOAT64: {
      double v = 0;
      bool ok = !is_null && parse_f64(s, len, &v);
      c.f64.push_back(ok ? v : 0);
      c.valid.push_back(ok);
      break;
    }
    case K_DATE32: {
      int32_t v = 0;
      bool ok = !is_null && parse_date32(s, len, &v);
      c.i32.push_back(ok ? v : 0);
      c.valid.push_back(ok);
      break;
    }
    case K_DECIMAL: {
      int64_t v = 0;
      bool ok = !is_null && parse_decimal(s, len, c.scale, &v);
      c.i64.push_back(ok ? v : 0);
      c.valid.push_back(ok);
      break;
    }
    case K_BOOL: {
      int64_t v = 0;
      bool ok = !is_null && parse_bool(s, len, &v);
      c.i64.push_back(ok ? v : 0);
      c.valid.push_back(ok);
      break;
    }
    case K_TIMESTAMP: {
      int64_t v = 0;
      bool ok = !is_null && parse_timestamp_us(s, len, &v);
      c.i64.push_back(ok ? v : 0);
      c.valid.push_back(ok);
      break;
    }
    case K_STRING: {
      if (is_null) {
        c.i32.push_back(0);
        c.valid.push_back(0);
      } else {
        std::string key(s, len);
        auto it = c.dict_map.find(key);
        int32_t code;
        if (it == c.dict_map.end()) {
          code = (int32_t)c.dict_values.size();
          c.dict_map.emplace(std::move(key), code);
          c.dict_values.emplace_back(s, len);
        } else {
          code = it->second;
        }
        c.i32.push_back(code);
        c.valid.push_back(1);
      }
      break;
    }
  }
}

DftpuCsv* dftpu_csv_open(const char* path, char delim, int has_header,
                         int ncols, const int* kinds, const int* scales) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)size + 1);
  if (size > 0 && fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[(size_t)size] = '\n';

  auto* h = new DftpuCsv();
  h->cols.resize(ncols);
  for (int j = 0; j < ncols; j++) {
    h->cols[j].kind = kinds[j];
    h->cols[j].scale = scales ? scales[j] : 0;
  }

  const char* p = buf.data();
  const char* end = buf.data() + size;
  bool skip = has_header != 0;
  while (p < end) {
    // one record (handles quoted fields containing delim/newline)
    const char* field_start = p;
    int col = 0;
    bool in_quotes = false;
    bool blank = false;
    const char* q = p;
    for (;; q++) {
      char ch;
      if (q <= end) {
        ch = *q;
      } else {
        // unterminated quoted field: drop quote state so the synthetic
        // newline terminates the record instead of looping forever
        ch = '\n';
        in_quotes = false;
      }
      if (in_quotes) {
        if (ch == '"') {
          if (q + 1 <= end && q[1] == '"') q++;  // escaped quote
          else in_quotes = false;
        }
        continue;
      }
      if (ch == '"' && q == field_start) { in_quotes = true; continue; }
      if (ch == delim || ch == '\n' || ch == '\r') {
        // a record whose FIRST field ends empty at a newline is a blank
        // line (incl. CRLF): skip it before appending anything, so column
        // 0 never gains a spurious entry that desyncs later rows
        if (ch != delim && col == 0 && q == field_start) {
          blank = true;
          if (ch == '\r' && q + 1 <= end && q[1] == '\n') q++;
          p = q + 1;
          break;
        }
        const char* fe = q < end ? q : end;
        size_t flen = fe > field_start ? (size_t)(fe - field_start) : 0;
        if (!skip) {
          // TBL files have a trailing delimiter: ignore extra empty column
          if (col < ncols) append_field(h->cols[col], field_start, flen);
          else if (flen > 0) { /* excess data: ignore */ }
        }
        col++;
        if (ch == delim) {
          field_start = q + 1;
          continue;
        }
        // end of record
        if (ch == '\r' && q + 1 <= end && q[1] == '\n') q++;
        p = q + 1;
        break;
      }
    }
    if (blank) continue;
    if (skip) { skip = false; continue; }
    // rows with fewer columns: pad with nulls
    for (int j = col; j < ncols; j++) append_field(h->cols[j], "", 0);
    h->nrows++;
  }

  // finalize string dictionaries: sort values, remap codes
  for (auto& c : h->cols) {
    if (c.kind != K_STRING) continue;
    size_t nv = c.dict_values.size();
    std::vector<int32_t> perm(nv);
    for (size_t i = 0; i < nv; i++) perm[i] = (int32_t)i;
    std::sort(perm.begin(), perm.end(), [&](int32_t a, int32_t b) {
      return c.dict_values[a] < c.dict_values[b];
    });
    std::vector<int32_t> remap(nv);
    std::vector<std::string> sorted_vals(nv);
    for (size_t i = 0; i < nv; i++) {
      remap[perm[i]] = (int32_t)i;
      sorted_vals[i] = std::move(c.dict_values[perm[i]]);
    }
    c.dict_values = std::move(sorted_vals);
    for (auto& code : c.i32) code = nv ? remap[code] : 0;
    c.dict_map.clear();
  }
  return h;
}

long dftpu_csv_nrows(DftpuCsv* h) { return h ? h->nrows : -1; }

// copy the column's data into caller-allocated buffers
// (int64/decimal/bool/timestamp -> int64; float64 -> double;
//  date32/string-codes -> int32)
void dftpu_csv_column(DftpuCsv* h, int col, void* out_data,
                      uint8_t* out_valid) {
  ColumnData& c = h->cols[col];
  long n = h->nrows;
  switch (c.kind) {
    case K_INT64:
    case K_DECIMAL:
    case K_TIMESTAMP:
      memcpy(out_data, c.i64.data(), n * sizeof(int64_t));
      break;
    case K_BOOL: {
      uint8_t* o = (uint8_t*)out_data;
      for (long i = 0; i < n; i++) o[i] = (uint8_t)c.i64[i];
      break;
    }
    case K_FLOAT64:
      memcpy(out_data, c.f64.data(), n * sizeof(double));
      break;
    case K_DATE32:
    case K_STRING:
      memcpy(out_data, c.i32.data(), n * sizeof(int32_t));
      break;
  }
  memcpy(out_valid, c.valid.data(), n);
}

long dftpu_csv_dict_size(DftpuCsv* h, int col) {
  return (long)h->cols[col].dict_values.size();
}

long dftpu_csv_dict_bytes(DftpuCsv* h, int col) {
  long total = 0;
  for (auto& s : h->cols[col].dict_values) total += (long)s.size() + 1;
  return total;
}

// '\n'-joined sorted distinct values (strings must not contain '\n'; if one
// does, the Python side falls back — see dict_has_newline)
int dftpu_csv_dict_has_newline(DftpuCsv* h, int col) {
  for (auto& s : h->cols[col].dict_values)
    if (s.find('\n') != std::string::npos) return 1;
  return 0;
}

void dftpu_csv_dict_values(DftpuCsv* h, int col, char* out) {
  for (auto& s : h->cols[col].dict_values) {
    memcpy(out, s.data(), s.size());
    out += s.size();
    *out++ = '\n';
  }
}

void dftpu_csv_free(DftpuCsv* h) { delete h; }

// ---------------------------------------------------------------------------
// 2. shuffle hash partitioner (counting sort; stable within bucket)
// ---------------------------------------------------------------------------
// Replaces the np.argsort bucketing in ShuffleWriterExec (the reference's
// per-batch `take` repartition hot loop, repartition.rs:285-330).

void dftpu_partition(const uint64_t* hashes, long n, int m,
                     int64_t* out_order, int64_t* out_starts /* m+1 */) {
  std::vector<int64_t> counts(m, 0);
  std::vector<uint32_t> bucket(n);
  for (long i = 0; i < n; i++) {
    uint32_t b = (uint32_t)(hashes[i] % (uint64_t)m);
    bucket[i] = b;
    counts[b]++;
  }
  int64_t acc = 0;
  for (int b = 0; b < m; b++) {
    out_starts[b] = acc;
    acc += counts[b];
  }
  out_starts[m] = acc;
  std::vector<int64_t> cursor(out_starts, out_starts + m);
  for (long i = 0; i < n; i++) out_order[cursor[bucket[i]]++] = i;
}

// ---------------------------------------------------------------------------
// 3. bulk gather helpers (host-side `take` for spill writing)
// ---------------------------------------------------------------------------

void dftpu_gather_i64(const int64_t* src, const int64_t* idx, long n, int64_t* dst) {
  for (long i = 0; i < n; i++) dst[i] = src[idx[i]];
}
void dftpu_gather_i32(const int32_t* src, const int64_t* idx, long n, int32_t* dst) {
  for (long i = 0; i < n; i++) dst[i] = src[idx[i]];
}
void dftpu_gather_f64(const double* src, const int64_t* idx, long n, double* dst) {
  for (long i = 0; i < n; i++) dst[i] = src[idx[i]];
}
void dftpu_gather_u8(const uint8_t* src, const int64_t* idx, long n, uint8_t* dst) {
  for (long i = 0; i < n; i++) dst[i] = src[idx[i]];
}

}  // extern "C"
