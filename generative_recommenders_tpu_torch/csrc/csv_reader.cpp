// Native sharded-CSV corpus reader for the ML-3B MultiFile path (a copy of
// the root `csrc/csv_reader.cpp`; `data/native_reader.py` builds it with g++
// on first use and binds it with ctypes).
//
// The reference feeds its trainer with torch DataLoader worker processes
// over linecache'd CSV shards (`research/data/dataset.py:194-249`,
// `research/trainer/data_loader.py:25-57`). This reader mmaps each shard,
// builds the line index natively, and parses the
//   user_id,"i1,i2,...","r1,r2,..."
// rows straight into int64 buffers without the GIL, giving the python
// prefetcher true thread parallelism.
//
// C API (ctypes):
//   csv_open(prefix, n_shards)          -> corpus handle (>=0) or -1
//   csv_num_rows(h)                     -> total rows
//   csv_read_row(h, row, items, ratings, cap) -> n events (or -cap needed)
//   csv_user_id(h, row)                 -> user id of the row
//   csv_close(h)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libcsvreader.so csv_reader.cpp

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

namespace {

struct Shard {
  const char* data = nullptr;
  size_t size = 0;
  std::vector<size_t> line_offsets;  // start of each row (built lazily)
  std::unique_ptr<std::once_flag> indexed{new std::once_flag};
};

struct Corpus {
  std::vector<Shard> shards;
  std::vector<int64_t> cumsum;  // rows up to and including shard i
};

std::mutex g_mu;
std::vector<Corpus*> g_corpora;

bool map_shard(const std::string& path, Shard* out) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return false;
  }
  void* p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (p == MAP_FAILED) return false;
  out->data = static_cast<const char*>(p);
  out->size = static_cast<size_t>(st.st_size);
  return true;
}

// built lazily per shard (an ML-3B corpus is hundreds of GB — eagerly
// newline-scanning every shard would turn csv_open into a full read)
void build_index(Shard* s) {
  std::call_once(*s->indexed, [s] {
    s->line_offsets.clear();
    s->line_offsets.push_back(0);
    const char* d = s->data;
    for (size_t i = 0; i < s->size; ++i) {
      if (d[i] == '\n' && i + 1 < s->size) s->line_offsets.push_back(i + 1);
    }
  });
}

// parses a comma-separated int list terminated by `stop` ('"' for quoted
// fields, ',' for unquoted single-value fields — csv.QUOTE_MINIMAL only
// quotes fields containing a comma); returns count written (or negative
// required size)
int64_t parse_list(const char* p, const char* end, int64_t* out,
                   int64_t cap, char stop) {
  int64_t n = 0;
  int64_t val = 0;
  bool neg = false, have = false;
  for (; p < end && *p != stop; ++p) {
    char c = *p;
    if (c == '-') {
      neg = true;
    } else if (c >= '0' && c <= '9') {
      val = val * 10 + (c - '0');
      have = true;
    } else if (c == ',') {
      if (have) {
        if (n < cap) out[n] = neg ? -val : val;
        n++;
      }
      val = 0;
      neg = false;
      have = false;
    } else if (c == '.') {
      // ratings may be written as floats ("3.0"); truncate at the dot
      for (; p + 1 < end && p[1] != ',' && p[1] != '"'; ++p) {
      }
    }
  }
  if (have) {
    if (n < cap) out[n] = neg ? -val : val;
    n++;
  }
  return n;
}

}  // namespace

extern "C" {

// row_counts: per-shard row counts from the corpus index (_users.csv);
// verified lazily against the real newline count on first shard access
int64_t csv_open(const char* prefix, int32_t n_shards,
                 const int64_t* row_counts) {
  auto* c = new Corpus();
  int64_t total = 0;
  for (int32_t i = 0; i < n_shards; ++i) {
    Shard s;
    std::string path = std::string(prefix) + "_" + std::to_string(i) + ".csv";
    if (!map_shard(path, &s)) {
      for (auto& m : c->shards) {
        if (m.data) munmap(const_cast<char*>(m.data), m.size);
      }
      delete c;
      return -1;
    }
    total += row_counts[i];
    c->shards.push_back(std::move(s));
    c->cumsum.push_back(total);
  }
  std::lock_guard<std::mutex> lock(g_mu);
  g_corpora.push_back(c);
  return static_cast<int64_t>(g_corpora.size()) - 1;
}

int64_t csv_num_rows(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (h < 0 || h >= static_cast<int64_t>(g_corpora.size()) || !g_corpora[h])
    return -1;
  if (g_corpora[h]->cumsum.empty()) return -1;  // n_shards == 0
  return g_corpora[h]->cumsum.back();
}

// locates row `idx`; returns pointers to the row text
static bool locate(Corpus* c, int64_t idx, const char** row,
                   const char** row_end) {  // NOLINT
  size_t shard = 0;
  while (shard < c->cumsum.size() && c->cumsum[shard] <= idx) shard++;
  if (shard >= c->shards.size()) return false;
  int64_t local = idx - (shard == 0 ? 0 : c->cumsum[shard - 1]);
  Shard& s = c->shards[shard];
  build_index(&s);
  if (local >= static_cast<int64_t>(s.line_offsets.size())) return false;
  *row = s.data + s.line_offsets[local];
  const char* end = s.data + s.size;
  const char* e = static_cast<const char*>(
      memchr(*row, '\n', end - *row));
  *row_end = e ? e : end;
  return true;
}

int64_t csv_user_id(int64_t h, int64_t idx) {
  Corpus* c;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (h < 0 || h >= static_cast<int64_t>(g_corpora.size())) return -1;
    c = g_corpora[h];
  }
  const char *row, *end;
  if (!c || !locate(c, idx, &row, &end)) return -1;
  int64_t uid = 0;
  for (; row < end && *row != ','; ++row) {
    if (*row >= '0' && *row <= '9') uid = uid * 10 + (*row - '0');
  }
  return uid;
}

// fills items + ratings (each cap slots); returns n events, or -need if the
// row has more than cap events (caller re-calls with a bigger buffer)
int64_t csv_read_row(int64_t h, int64_t idx, int64_t* items,
                     int64_t* ratings, int64_t cap) {
  Corpus* c;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    if (h < 0 || h >= static_cast<int64_t>(g_corpora.size())) return -1;
    c = g_corpora[h];
  }
  const char *row, *end;
  if (!c || !locate(c, idx, &row, &end)) return -1;
  // skip user_id,
  const char* p = static_cast<const char*>(memchr(row, ',', end - row));
  if (!p) return -1;
  p++;
  // items field: quoted iff multi-valued (csv.QUOTE_MINIMAL)
  bool quoted = (p < end && *p == '"');
  if (quoted) p++;
  char stop = quoted ? '"' : ',';
  int64_t n_items = parse_list(p, end, items, cap, stop);
  const char* q =
      static_cast<const char*>(memchr(p, stop, end - p));
  if (quoted) {
    if (!q) return -1;
    p = q + 1;
    if (p < end && *p == ',') p++;
  } else {
    // unquoted single value: q is the comma before ratings (a row with no
    // ratings field at all is malformed)
    if (!q) return -1;
    p = q + 1;
  }
  quoted = (p < end && *p == '"');
  if (quoted) p++;
  stop = quoted ? '"' : '\n';
  int64_t n_ratings = parse_list(p, end, ratings, cap, stop);
  if (n_items > cap || n_ratings > cap) return -(n_items > n_ratings ? n_items : n_ratings);
  // item/rating list lengths must agree — fail loudly (the python reader
  // surfaces the same mismatch downstream; the two paths must not diverge)
  if (n_items != n_ratings) return -1;
  return n_items;
}

void csv_close(int64_t h) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (h < 0 || h >= static_cast<int64_t>(g_corpora.size())) return;
  Corpus* c = g_corpora[h];
  if (!c) return;
  for (auto& s : c->shards) {
    if (s.data) munmap(const_cast<char*>(s.data), s.size);
  }
  delete c;
  g_corpora[h] = nullptr;
}

}  // extern "C"
