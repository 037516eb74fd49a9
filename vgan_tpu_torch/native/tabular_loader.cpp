// Native tabular ingest engine (vgan_tpu_torch's copy of the JAX package's
// native/tabular_loader.cpp).
//
// Role: the host-side data-loading tier. For the ADBench-style sweeps and
// d>=10k stress configs the ingest bottleneck is CSV parsing;
// numpy.loadtxt is single-threaded Python. This engine mmaps the file,
// splits it into row-aligned chunks, and parses chunks in parallel with C
// strtof/strtod.
//
// C ABI (ctypes-friendly):
//   vgan_csv_dims(path, &rows, &cols, &header)     -> 0 on success
//   vgan_csv_read_f32(path, out, rows, cols, skip_header, nthreads) -> 0
//   vgan_csv_read_f64(...)                          -> 0
//   vgan_csv_read_range_f32 / _f64(path, out, start_row, rows, cols,
//                                   skip_header, nthreads) -> 0
//
// Build: vgan_tpu_torch/io_native.py compiles it with g++ at first use.

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;      // file size (bytes of real content)
  size_t map_len = 0;   // mapped length = size + 1 guard byte
  int fd = -1;

  // Maps the file with a guaranteed NUL guard byte at data[size], so the
  // strtod/strtof token parsers can never read past the mapping even when
  // the file lacks a trailing newline and its size is an exact multiple of
  // the page size. Technique: reserve size+1 anonymous zero bytes, then
  // MAP_FIXED the file over the front. Whichever way the page boundaries
  // fall, byte [size] reads as 0 (either the file mapping's zero-filled
  // partial last page, or the surviving anonymous page).
  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      data = nullptr;
      return true;
    }
    map_len = size + 1;
    void* reserve =
        mmap(nullptr, map_len, PROT_READ, MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (reserve == MAP_FAILED) return false;
    void* p = mmap(reserve, size, PROT_READ, MAP_PRIVATE | MAP_FIXED, fd, 0);
    if (p == MAP_FAILED) {
      munmap(reserve, map_len);
      map_len = 0;
      return false;
    }
    madvise(p, size, MADV_SEQUENTIAL);
    data = static_cast<const char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), map_len);
    if (fd >= 0) close(fd);
  }
};

// Count the columns of one line (comma-separated).
long count_cols(const char* p, const char* end) {
  long cols = 1;
  for (; p < end && *p != '\n'; ++p)
    if (*p == ',') ++cols;
  return cols;
}

// Does this line parse as all-numeric? (header detection)
bool line_is_numeric(const char* p, const char* end) {
  while (p < end && *p != '\n') {
    char* parse_end = nullptr;
    errno = 0;
    strtod(p, &parse_end);
    if (parse_end == p) return false;
    p = parse_end;
    while (p < end && (*p == ' ' || *p == '\r')) ++p;
    if (p < end && *p == ',') {
      ++p;
    } else if (p < end && *p != '\n') {
      // trailing garbage after the numeric prefix (e.g. a header named
      // "1st_percentile"): not a numeric line
      return false;
    } else {
      break;
    }
  }
  return true;
}

const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Advance past `count` content lines (blank lines skipped, not counted).
const char* skip_content_lines(const char* p, const char* end, long count) {
  long done = 0;
  while (p < end && done < count) {
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t'))
      ++p;
    if (p >= end) break;
    p = next_line(p, end);
    ++done;
  }
  return p;
}

// Count lines with non-whitespace content in [p, end). Blank/whitespace-only
// lines (interior or trailing) are not data rows.
long count_content_lines(const char* p, const char* end) {
  long lines = 0;
  bool content = false;
  for (; p < end; ++p) {
    if (*p == '\n') {
      if (content) ++lines;
      content = false;
    } else if (!isspace(static_cast<unsigned char>(*p))) {
      content = true;
    }
  }
  if (content) ++lines;  // last line without trailing newline
  return lines;
}

template <typename T>
int parse_rows(const char* p, const char* end, T* out, long cols,
               long row_begin, long row_end_idx) {
  for (long r = row_begin; r < row_end_idx && p < end; ++r) {
    // skip blank/whitespace-only lines (they are not counted as rows)
    while (p < end &&
           (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t')) ++p;
    if (p >= end) break;
    T* row_out = out + r * cols;
    for (long c = 0; c < cols; ++c) {
      // strtof/strtod skip ALL leading whitespace including newlines, so a
      // short row (e.g. a trailing comma making an empty last field) would
      // silently consume the next line's first value and shift every
      // subsequent row. Skip intra-line whitespace ourselves and require
      // the cell to start on THIS line.
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      if (p >= end || *p == '\n' || *p == '\r') return 2;  // missing field
      char* parse_end = nullptr;
      if constexpr (sizeof(T) == 4) row_out[c] = strtof(p, &parse_end);
      else row_out[c] = strtod(p, &parse_end);
      if (parse_end == p) return 2;  // malformed cell
      p = parse_end;
      while (p < end && (*p == ' ' || *p == '\r')) ++p;
      if (c + 1 < cols) {
        if (p < end && *p == ',') ++p;
        else return 2;
      }
    }
    // the row must END here (modulo whitespace): extra fields beyond the
    // first content line's column count are an error, not silently dropped
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p < end && *p != '\n') return 2;  // ragged row (extra fields)
    p = next_line(p, end);
  }
  return 0;
}

template <typename T>
int csv_read(const char* path, T* out, long rows, long cols, int skip_header,
             int nthreads, long start_row) {
  MappedFile mf;
  if (!mf.open(path)) return 1;
  const char* p = mf.data;
  const char* end = mf.data + mf.size;
  if (skip_header) {
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t'))
      ++p;  // match dims(): leading blank lines precede the header
    p = next_line(p, end);
  }
  if (start_row > 0) p = skip_content_lines(p, end, start_row);
  // bound the parse span to the requested rows so range reads are O(rows),
  // not O(remaining file) (multi-host ingest: each host reads its slice)
  end = skip_content_lines(p, end, rows);

  // Row-aligned chunk boundaries: stride through the data by byte-size,
  // snapping each boundary to the next newline; record the row index at
  // each boundary by counting newlines per chunk first.
  if (nthreads < 1) nthreads = 1;
  long hw = static_cast<long>(std::thread::hardware_concurrency());
  if (hw > 0 && nthreads > hw) nthreads = static_cast<int>(hw);
  if (rows < nthreads * 4) nthreads = 1;

  std::vector<const char*> starts;
  std::vector<long> start_rows;
  starts.push_back(p);
  start_rows.push_back(0);
  size_t span = static_cast<size_t>(end - p);
  for (int t = 1; t < nthreads; ++t) {
    const char* cand = p + span * t / nthreads;
    if (cand >= end) break;
    cand = next_line(cand, end);
    if (cand > starts.back()) {
      starts.push_back(cand);
      start_rows.push_back(-1);  // filled below
    }
  }
  // count data rows (content lines) per chunk to fix start_rows; chunk
  // boundaries snap to just-after-newline so no line spans two chunks
  for (size_t i = 1; i < starts.size(); ++i) {
    start_rows[i] =
        start_rows[i - 1] + count_content_lines(starts[i - 1], starts[i]);
  }

  std::vector<int> rcs(starts.size(), 0);
  std::vector<std::thread> threads;
  for (size_t i = 0; i < starts.size(); ++i) {
    const char* cb = starts[i];
    const char* ce = (i + 1 < starts.size()) ? starts[i + 1] : end;
    // clamp to the requested row count: with a row-range read the file
    // holds more content lines than the output buffer
    long rb = std::min(start_rows[i], rows);
    long re = std::min(
        (i + 1 < starts.size()) ? start_rows[i + 1] : rows, rows);
    threads.emplace_back([=, &rcs] {
      rcs[i] = parse_rows<T>(cb, ce, out, cols, rb, re);
    });
  }
  for (auto& th : threads) th.join();
  for (int rc : rcs)
    if (rc) return rc;
  return 0;
}

}  // namespace

extern "C" {

int vgan_csv_dims(const char* path, long* rows, long* cols, int* has_header) {
  MappedFile mf;
  if (!mf.open(path)) return 1;
  if (mf.size == 0) {
    *rows = 0;
    *cols = 0;
    *has_header = 0;
    return 0;
  }
  const char* p = mf.data;
  const char* end = mf.data + mf.size;
  while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t'))
    ++p;  // leading blank lines are not the header
  const char* first_end = p;
  while (first_end < end && *first_end != '\n') ++first_end;
  *has_header = line_is_numeric(p, first_end) ? 0 : 1;
  *cols = count_cols(p, first_end);

  long lines = count_content_lines(p, end);
  *rows = lines - (*has_header ? 1 : 0);
  return 0;
}

int vgan_csv_read_f32(const char* path, float* out, long rows, long cols,
                      int skip_header, int nthreads) {
  return csv_read<float>(path, out, rows, cols, skip_header, nthreads, 0);
}

int vgan_csv_read_f64(const char* path, double* out, long rows, long cols,
                      int skip_header, int nthreads) {
  return csv_read<double>(path, out, rows, cols, skip_header, nthreads, 0);
}

// Row-range variants for multi-host ingest: parse `rows` content lines
// starting at content line `start_row` (after the header).
int vgan_csv_read_range_f32(const char* path, float* out, long start_row,
                            long rows, long cols, int skip_header,
                            int nthreads) {
  return csv_read<float>(path, out, rows, cols, skip_header, nthreads,
                         start_row);
}

int vgan_csv_read_range_f64(const char* path, double* out, long start_row,
                            long rows, long cols, int skip_header,
                            int nthreads) {
  return csv_read<double>(path, out, rows, cols, skip_header, nthreads,
                          start_row);
}

}  // extern "C"
