// Native host kernels of garlic_tpu_torch: a copy of
// garlic_tpu/native/garlic_native.cpp holding only the entry points the
// port calls (the TPU link's repacking is left out); the code of each is
// unchanged.
//
// 1. Streaming gzip TPED parser with the reference's exact allele-coding
//    semantics (first non-missing character becomes the '1' allele; a
//    half-missing genotype still contributes its observed allele to the
//    frequency) — reference behavior: szpiech/garlic src/garlic-data.cpp:10-177.
// 2. Exact float64 rolling-window LOD recurrence matching the reference's
//    summation order (fresh left-to-right sum at the start of each
//    non-missing run, then win[l] = (win[l-1] - a[l-1]) + a[l+W-1]) —
//    reference behavior: src/garlic-roh.cpp:46-126.
//
// 3. Gzip .freq writer with C "%g" formatting (identical to the reference's
//    ostream defaults) — reference behavior: src/garlic-data.cpp:1311-1343.
// 4. ROH run extraction from bit-packed coverage masks: a verbatim
//    transliteration of the assembleROHWindows state machine
//    (src/garlic-roh.cpp:462-532), including its edge quirks (a run opening
//    at the last SNP is lost; a run whose start position is 0 only closes
//    at a gap split).
//
// Exposed as a C ABI for ctypes.  Build: see build.py.

#include <atomic>
#include <cctype>
#include <cmath>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct ChromBlock {
  std::string name;
  std::vector<int64_t> positions;
  std::vector<double> gpos;
  std::vector<double> freq;
  // Column-range mode only: partial '1'-allele numerator / allele
  // denominator over THIS range's individuals (integers stored as f64 so
  // a cross-host psum reproduces the full-panel freq exactly).
  std::vector<double> freq_num;
  std::vector<double> freq_den;
  std::vector<char> allele;
  std::string names;       // '\n'-joined locus names
  int64_t row_offset = 0;  // first locus row in the handle's arenas
};

struct TpedHandle {
  std::vector<ChromBlock> chroms;
  // Locus-major [total_rows][nind] genotype arena shared by all
  // chromosomes: ONE reservation sized from the gzip ISIZE footer instead
  // of per-chromosome growing vectors (repeated 100MB reallocations cost
  // ~10s of page-fault churn under this VM).
  std::vector<int8_t> geno;
  std::vector<uint8_t> first_copy;  // empty when want_fc == 0
  bool has_fc = true;
  int64_t nind = 0;    // individuals in the FILE (full panel)
  // Column-range mode (per-host sharded input): only genotype columns
  // [col0, col1) are stored in the arenas; allele coding still scans from
  // column 0 (the '1' allele is the first non-missing allele in the FULL
  // row, src/garlic-data.cpp:109-131) and per-locus partial freq counts
  // over the stored range land in ChromBlock::freq_num/freq_den.
  int64_t col0 = 0;
  int64_t col1 = -1;   // -1: full panel (resolved to nind at first line)
  int64_t nstore = 0;  // col1 - col0 once resolved
  std::string error;
};

// Uncompressed-size estimate: gzip stores ISIZE (mod 2^32) in the last 4
// footer bytes; plain files use their size directly.
int64_t uncompressed_size_hint(const char *path) {
  FILE *fp = fopen(path, "rb");
  if (!fp) return 0;
  unsigned char head[2] = {0, 0};
  size_t got_h = fread(head, 1, 2, fp);
  if (got_h == 2 && head[0] == 0x1f && head[1] == 0x8b) {
    if (fseek(fp, -4, SEEK_END) == 0) {
      unsigned char b[4];
      if (fread(b, 1, 4, fp) == 4) {
        fclose(fp);
        return (int64_t)b[0] | ((int64_t)b[1] << 8) | ((int64_t)b[2] << 16)
               | ((int64_t)b[3] << 24);
      }
    }
    fclose(fp);
    return 0;
  }
  fseek(fp, 0, SEEK_END);
  long sz = ftell(fp);
  fclose(fp);
  return sz > 0 ? (int64_t)sz : 0;
}

int count_fields(const std::string &s) {
  int n = 0;
  bool in_tok = false;
  for (char c : s) {
    if (!isspace((unsigned char)c)) {
      if (!in_tok) { n++; in_tok = true; }
    } else {
      in_tok = false;
    }
  }
  return n;
}

}  // namespace

extern "C" {

// Honor the CLI's --threads N exactly like the reference's fixed pthread
// fan-out (src/garlic-roh.cpp:184-194): caps every OpenMP parallel region
// in this library. n <= 0 leaves the OpenMP default untouched.
void gt_set_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

int gt_get_max_threads(void) {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// gsl_stats_sd, bit-for-bit (used by the reference's nrd0 bandwidth,
// src/garlic-kde.cpp:130-140).  GSL accumulates BOTH running-mean
// recurrences in x87 80-bit extended precision (verified by
// disassembling the oracle binary's gsl_stats_mean / variance_m: fld /
// fsubrl / fildll / fdivrp / faddp chains), with the mean truncated to
// f64 between the two passes and delta formed by an SSE f64 subtract.
// The KDE grid origin is min - 3h, so any sd difference shifts every
// .kde x value — this must match to the last bit for .kde x-column
// parity.  long double on x86-64 g++ is the same 80-bit x87 format.
double gt_gsl_sd(const double *x, int64_t n) {
  long double mean = 0.0L;
  for (int64_t i = 0; i < n; i++)
    mean += ((long double)x[i] - mean) / (long double)(i + 1);
  const double mean_d = (double)mean;
  long double variance = 0.0L;
  for (int64_t i = 0; i < n; i++) {
    const double delta = x[i] - mean_d;  // f64 subtract, like the oracle
    variance +=
        ((long double)delta * (long double)delta - variance) /
        (long double)(i + 1);
  }
  const double var_d = (double)variance;
  return sqrt(((double)n / (double)(n - 1)) * var_d);
}

// Column compaction of a 2-bit-packed genotype matrix: keep[l] selects
// columns; output rows are ceil(nkeep/4) bytes with tail codes 3
// (missing).  Lets the fast engine run filter -> pad -> H2D entirely in
// packed form (the 4x larger int8 matrix never exists on the cache-hit
// path).  Returns nkeep.
namespace {

inline uint8_t get_code2(const uint8_t *p, int64_t l) {
  return (uint8_t)((p[l >> 2] >> ((l & 3) * 2)) & 3);
}

inline void set_code2(uint8_t *p, int64_t l, uint8_t c) {
  int s = (int)((l & 3) * 2);
  p[l >> 2] = (uint8_t)((p[l >> 2] & ~(3u << s)) | ((uint32_t)c << s));
}

// Copy n 2-bit codes src[a..a+n) -> dst[o..o+n).  Span-wise: aligned
// phases memcpy whole bytes; misaligned phases shift 16-bit windows —
// O(n/4) byte ops either way (the per-code loop was 10x slower than the
// int8 memmove filter it replaced).  dst must be pre-filled 0xFF so
// read-modify-write boundaries keep missing tails.
inline void copy_codes2(const uint8_t *src, int64_t a, uint8_t *dst,
                        int64_t o, int64_t n) {
  while (n > 0 && (o & 3)) { set_code2(dst, o++, get_code2(src, a++)); n--; }
  if (((a ^ o) & 3) == 0) {
    int64_t nb = n >> 2;
    if (nb) {
      memcpy(dst + (o >> 2), src + (a >> 2), (size_t)nb);
      o += nb * 4; a += nb * 4; n -= nb * 4;
    }
  } else {
    int64_t nb = (n >> 2) - 1;  // last byte scalar: avoids reading past
    if (nb > 0) {               // the source row's final byte
      int shift = (int)((a & 3) * 2);
      const uint8_t *p = src + (a >> 2);
      uint8_t *q = dst + (o >> 2);
      for (int64_t k = 0; k < nb; k++) {
        uint16_t w = (uint16_t)((uint16_t)p[k] | ((uint16_t)p[k + 1] << 8));
        q[k] = (uint8_t)(w >> shift);
      }
      o += nb * 4; a += nb * 4; n -= nb * 4;
    }
  }
  while (n > 0) { set_code2(dst, o++, get_code2(src, a++)); n--; }
}

}  // namespace

int64_t gt_filter_pack_2bit(const uint8_t *in, int64_t I, int64_t L,
                            int64_t rb_in, const uint8_t *keep,
                            uint8_t *out, int64_t rb_out) {
  // kept spans (few in practice: monomorphic drops are sparse)
  std::vector<int64_t> span_a, span_n;
  int64_t nkeep = 0;
  int64_t l = 0;
  while (l < L) {
    if (!keep[l]) { l++; continue; }
    int64_t a = l;
    while (l < L && keep[l]) l++;
    span_a.push_back(a);
    span_n.push_back(l - a);
    nkeep += l - a;
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < I; i++) {
    const uint8_t *src = in + i * rb_in;
    uint8_t *dst = out + i * rb_out;
    memset(dst, 0xFF, (size_t)rb_out);
    int64_t o = 0;
    for (size_t s = 0; s < span_a.size(); s++) {
      copy_codes2(src, span_a[s], dst, o, span_n[s]);
      o += span_n[s];
    }
  }
  return nkeep;
}

// One-pass 2-bit -> int8 genotype unpack (code 3 -> -9).  The numpy
// shift/stack/where chain allocates several 100s-of-MB temporaries whose
// fresh-page faults dominate panel-cache loads under this VM.
// packed: [I][row_bytes]; out: [I][L] int8.
void gt_unpack_2bit(const uint8_t *packed, int64_t I, int64_t L,
                    int64_t row_bytes, int8_t *out) {
  static const int8_t lut[4] = {0, 1, 2, -9};
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < I; i++) {
    const uint8_t *p = packed + i * row_bytes;
    int8_t *o = out + i * L;
    int64_t l = 0;
    for (; l + 4 <= L; l += 4) {
      uint8_t b = p[l >> 2];
      o[l] = lut[b & 3];
      o[l + 1] = lut[(b >> 2) & 3];
      o[l + 2] = lut[(b >> 4) & 3];
      o[l + 3] = lut[(b >> 6) & 3];
    }
    for (; l < L; l++) o[l] = lut[(p[l >> 2] >> ((l & 3) * 2)) & 3];
  }
}

namespace {

// Per-line parse results for the parallel tokenizer.
struct LineRec {
  const char *chrom_b;
  int chrom_len;
  const char *name_b;
  int name_len;
  double gpos;
  int64_t ppos;
  char allele;
  double freq;
  double num_part;  // range mode: '1'-allele count over [col0, col1)
  double den_part;  // range mode: observed-allele count over [col0, col1)
  bool skip;  // blank line
  bool bad;
};

// Parse one TPED line. geno/fc point at this line's [nind] output slots.
// Allele semantics match the reference (src/garlic-data.cpp:109-160): the
// first non-missing allele character observed becomes the '1' allele; a
// half-missing genotype still contributes its observed allele to the
// frequency; any missing half makes the genotype -9.
// C-locale isspace without the locale-aware libc call: the per-allele
// token loop below runs ~400M iterations on a 200x1M panel and the
// function-call isspace() was ~40% of parse time.
inline bool ws_c(unsigned char c) {
  return c == ' ' || (c >= '\t' && c <= '\r');
}

extern "C++" template <bool RANGE>
void parse_line_t(const char *p, const char *end, char missing, int64_t nind,
                  int64_t c0, int64_t c1, LineRec &r, int8_t *geno,
                  uint8_t *fc) {
  r.skip = r.bad = false;
  while (p < end && (*p == ' ' || *p == '\t')) p++;
  if (p >= end) { r.skip = true; return; }
  r.chrom_b = p;
  while (p < end && !ws_c((unsigned char)*p)) p++;
  r.chrom_len = (int)(p - r.chrom_b);
  while (p < end && ws_c((unsigned char)*p)) p++;
  r.name_b = p;
  while (p < end && !ws_c((unsigned char)*p)) p++;
  r.name_len = (int)(p - r.name_b);
  char *endp;
  r.gpos = strtod(p, &endp);
  p = endp;
  r.ppos = (int64_t)strtod(p, &endp);
  p = endp;
  char one_allele = missing;
  int64_t nalleles = 0, total = 0;
  int64_t n_part = 0, d_part = 0;
  for (int64_t i = 0; i < nind; i++) {
    while (p < end && ws_c((unsigned char)*p)) p++;
    char a1 = p < end ? *p++ : missing;
    while (p < end && ws_c((unsigned char)*p)) p++;
    char a2 = p < end ? *p++ : missing;
    if (one_allele == missing && a1 != missing) one_allele = a1;
    if (one_allele == missing && a2 != missing) one_allele = a2;
    const bool in_r = !RANGE || (i >= c0 && i < c1);
    int d = 0;
    if (a1 == missing) d += -9;
    else if (a1 == one_allele) {
      d += 1; nalleles++; total++;
      if (RANGE && in_r) { n_part++; d_part++; }
    } else {
      total++;
      if (RANGE && in_r) d_part++;
    }
    if (a2 == missing) d += -9;
    else if (a2 == one_allele) {
      d += 1; nalleles++; total++;
      if (RANGE && in_r) { n_part++; d_part++; }
    } else {
      total++;
      if (RANGE && in_r) d_part++;
    }
    if (d < 0) d = -9;
    if (in_r) {
      geno[i - c0] = (int8_t)d;
      fc[i - c0] = (a1 == one_allele);
    }
  }
  r.allele = one_allele;
  r.freq = total == 0 ? 0.0 : (double)nalleles / (double)total;
  r.num_part = (double)n_part;
  r.den_part = (double)d_part;
}

inline void parse_line(const char *p, const char *end, char missing,
                       int64_t nind, int64_t c0, int64_t c1, LineRec &r,
                       int8_t *geno, uint8_t *fc) {
  if (c0 == 0 && c1 >= nind)
    parse_line_t<false>(p, end, missing, nind, 0, nind, r, geno, fc);
  else
    parse_line_t<true>(p, end, missing, nind, c0, c1, r, geno, fc);
}

}  // namespace

// Chunked-streaming parallel TPED parser: gz decompression is sequential
// (zlib), tokenization of each decompressed chunk's lines fans out over
// OpenMP threads (the reference parses single-threaded via `>>`,
// byte-identical results, ~NCPU x faster).  col0/col1 select a genotype
// COLUMN range to store (per-host sharded input; col1 < 0 = full panel):
// every line is still scanned end-to-end so the '1'-allele coding and the
// full-row freq stay exact (src/garlic-data.cpp:109-131), but the arenas
// only hold [col0, col1) — host RAM scales 1/num_hosts.
void *gt_tped_open_range(const char *path, char missing, int want_fc,
                         int64_t col0, int64_t col1) {
  const bool timing = getenv("GT_PARSE_TIMING") != nullptr;
  double t_read = 0, t_split = 0, t_parse = 0, t_append = 0;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  int64_t size_hint = uncompressed_size_hint(path);
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, 1 << 20);
  auto *h = new TpedHandle;
  h->has_fc = want_fc != 0;
  const size_t CHUNK = 64u << 20;

  // Producer thread: sequential gz inflation into a depth-2 chunk queue,
  // overlapping with tokenization/appends on the consumer side.
  struct Q {
    std::mutex m;
    std::condition_variable cv;
    std::deque<std::pair<std::string, bool>> chunks;  // (data, is_last)
    bool failed = false;
    bool abort = false;
  } q;
  std::thread reader([&] {
    for (;;) {
      std::string c(CHUNK, '\0');
      int got = gzread(f, &c[0], (unsigned)CHUNK);
      if (got < 0) {
        std::lock_guard<std::mutex> lk(q.m);
        q.failed = true;
        q.chunks.emplace_back(std::string(), true);
        q.cv.notify_all();
        return;
      }
      c.resize((size_t)got);
      bool last = (size_t)got < CHUNK;
      {
        std::unique_lock<std::mutex> lk(q.m);
        q.cv.wait(lk, [&] { return q.chunks.size() < 2 || q.abort; });
        if (q.abort) return;
        q.chunks.emplace_back(std::move(c), last);
        q.cv.notify_all();
      }
      if (last) return;
    }
  });
  auto abort_reader = [&] {
    std::lock_guard<std::mutex> lk(q.m);
    q.abort = true;
    q.cv.notify_all();
  };

  std::string buf;
  buf.reserve(CHUNK + (1u << 20));
  std::string carry;
  ChromBlock *blk = nullptr;
  std::string prev_chr;
  std::vector<const char *> starts;
  std::vector<size_t> lens;
  std::vector<LineRec> recs;
  std::vector<int8_t> geno_chunk;
  std::vector<uint8_t> fc_chunk;
  int64_t nind = -1;
  bool done = false;
  while (!done) {
    auto t0 = now();
    std::string chunk;
    {
      std::unique_lock<std::mutex> lk(q.m);
      q.cv.wait(lk, [&] { return !q.chunks.empty(); });
      chunk = std::move(q.chunks.front().first);
      done = q.chunks.front().second;
      q.chunks.pop_front();
      q.cv.notify_all();
      if (q.failed) { h->error = "gzread failed"; break; }
    }
    buf.assign(carry);
    carry.clear();
    buf += chunk;
    t_read += secs(t0, now());
    // hold back the trailing partial line
    if (!done) {
      size_t last_nl = buf.rfind('\n');
      if (last_nl == std::string::npos) { carry.swap(buf); continue; }
      carry.assign(buf, last_nl + 1, std::string::npos);
      buf.resize(last_nl + 1);
    }
    if (buf.empty()) continue;
    auto t1 = now();
    // split lines
    starts.clear();
    lens.clear();
    const char *p = buf.data();
    const char *bend = p + buf.size();
    while (p < bend) {
      const char *nl = (const char *)memchr(p, '\n', bend - p);
      const char *e = nl ? nl : bend;
      size_t len = e - p;
      if (len && e[-1] == '\r') len--;
      starts.push_back(p);
      lens.push_back(len);
      p = nl ? nl + 1 : bend;
    }
    size_t n = starts.size();
    if (n == 0) continue;
    if (nind < 0) {
      // establish individual count from the first line
      std::string first(starts[0], lens[0]);
      int nf = count_fields(first);
      nind = (nf - 4) / 2;
      if (nind <= 0) { h->error = "bad tped line"; abort_reader(); break; }
      h->nind = nind;
      h->col0 = col0 < 0 ? 0 : (col0 > nind ? nind : col0);
      h->col1 = col1 < 0 ? nind : (col1 > nind ? nind : col1);
      if (h->col1 < h->col0) h->col1 = h->col0;
      h->nstore = h->col1 - h->col0;
      if (size_hint > 0 && h->nstore > 0) {
        // one arena reservation for the whole file (+3% slack)
        int64_t est_rows = size_hint / (int64_t)(lens[0] + 1) + 16;
        est_rows += est_rows / 32;
        h->geno.reserve((size_t)(est_rows * h->nstore));
        if (h->has_fc) h->first_copy.reserve((size_t)(est_rows * h->nstore));
      }
    }
    t_split += secs(t1, now());
    auto t2 = now();
    recs.assign(n, LineRec());
    const size_t nst = (size_t)h->nstore;
    geno_chunk.resize(n * nst);
    fc_chunk.resize(n * nst);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t i = 0; i < n; i++) {
      parse_line(starts[i], starts[i] + lens[i], missing, nind, h->col0,
                 h->col1, recs[i], geno_chunk.data() + i * nst,
                 fc_chunk.data() + i * nst);
    }
    t_parse += secs(t2, now());
    auto t3 = now();
    // serial: chromosome boundaries + span-wise bulk appends (per-line
    // vector inserts cost ~5s/GB; whole same-chromosome spans are one
    // memcpy each)
    size_t span_start = (size_t)-1;
    auto flush_span = [&](size_t begin, size_t end_excl) {
      if (begin == (size_t)-1 || begin >= end_excl) return;
      h->geno.insert(h->geno.end(),
                     geno_chunk.begin() + begin * nst,
                     geno_chunk.begin() + end_excl * nst);
      if (h->has_fc) {
        h->first_copy.insert(h->first_copy.end(),
                             fc_chunk.begin() + begin * nst,
                             fc_chunk.begin() + end_excl * nst);
      }
    };
    const bool range_mode = (h->col0 != 0 || h->col1 != nind);
    for (size_t i = 0; i < n; i++) {
      LineRec &r = recs[i];
      if (r.skip || r.bad) {
        flush_span(span_start, i);
        span_start = (size_t)-1;
        if (r.bad) { h->error = "bad tped line"; break; }
        continue;
      }
      if (blk == nullptr || prev_chr.compare(0, std::string::npos, r.chrom_b,
                                             r.chrom_len) != 0) {
        flush_span(span_start, i);
        span_start = (size_t)-1;
        h->chroms.emplace_back();
        blk = &h->chroms.back();
        blk->name.assign(r.chrom_b, r.chrom_len);
        blk->row_offset = nst == 0 ? 0 : (int64_t)(h->geno.size() / nst);
        prev_chr = blk->name;
      }
      if (span_start == (size_t)-1) span_start = i;
      blk->positions.push_back(r.ppos);
      blk->gpos.push_back(r.gpos);
      if (!blk->names.empty()) blk->names += '\n';
      blk->names.append(r.name_b, r.name_len);
      blk->allele.push_back(r.allele);
      blk->freq.push_back(r.freq);
      if (range_mode) {
        blk->freq_num.push_back(r.num_part);
        blk->freq_den.push_back(r.den_part);
      }
    }
    if (h->error.empty()) flush_span(span_start, n);
    t_append += secs(t3, now());
    if (!h->error.empty()) {
      abort_reader();
      break;
    }
  }
  if (timing) {
    fprintf(stderr,
            "[gt_parse] wait=%.2fs split=%.2fs parse=%.2fs append=%.2fs\n",
            t_read, t_split, t_parse, t_append);
  }
  reader.join();
  gzclose(f);
  if (!h->error.empty() || h->chroms.empty()) {
    delete h;
    return nullptr;
  }
  return h;
}

void *gt_tped_open(const char *path, char missing, int want_fc) {
  return gt_tped_open_range(path, missing, want_fc, 0, -1);
}

int gt_tped_nchrom(void *hv) { return (int)((TpedHandle *)hv)->chroms.size(); }
// STORED genotype columns (== the full panel except in column-range mode).
int64_t gt_tped_nind(void *hv) { return ((TpedHandle *)hv)->nstore; }
// Individuals in the FILE (the full panel width).
int64_t gt_tped_nind_total(void *hv) { return ((TpedHandle *)hv)->nind; }
int64_t gt_tped_col0(void *hv) { return ((TpedHandle *)hv)->col0; }

// Column-range mode only: per-locus partial '1'-allele numerators and
// observed-allele denominators over the stored range (integers as f64; a
// psum over hosts reproduces loadTPEDData's full freq exactly,
// src/garlic-data.cpp:109-160).  Returns 0 when unavailable (full parse).
int gt_tped_copy_counts(void *hv, int c, double *num, double *den) {
  TpedHandle *h = (TpedHandle *)hv;
  ChromBlock &b = h->chroms[c];
  if (b.freq_num.size() != b.positions.size()) return 0;
  memcpy(num, b.freq_num.data(), b.freq_num.size() * sizeof(double));
  memcpy(den, b.freq_den.data(), b.freq_den.size() * sizeof(double));
  return 1;
}

int64_t gt_tped_nloci(void *hv, int c) {
  return (int64_t)((TpedHandle *)hv)->chroms[c].positions.size();
}

const char *gt_tped_chrom_name(void *hv, int c) {
  return ((TpedHandle *)hv)->chroms[c].name.c_str();
}

int64_t gt_tped_names_size(void *hv, int c) {
  return (int64_t)((TpedHandle *)hv)->chroms[c].names.size();
}

namespace {

// Cache-blocked [L][I] -> [I][L] byte transpose (the naive loop's
// stride-L writes cost ~10s on a 500k x 200 chromosome; 128x128 tiles
// keep both sides in L1).
extern "C++" template <typename T>
void transpose_blocked(const T *src, T *dst, int64_t L, int64_t I) {
  const int64_t B = 128;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t l0 = 0; l0 < L; l0 += B) {
    int64_t l1 = l0 + B < L ? l0 + B : L;
    for (int64_t i0 = 0; i0 < I; i0 += B) {
      int64_t i1 = i0 + B < I ? i0 + B : I;
      for (int64_t l = l0; l < l1; l++) {
        for (int64_t i = i0; i < i1; i++) {
          dst[i * L + l] = src[l * I + i];
        }
      }
    }
  }
}

}  // namespace

// Copy chromosome c into caller buffers. geno/first_copy become
// individual-major [I][L].  first_copy may be null (skip — unphased runs
// never read it; also absent when opened with want_fc=0).  The phased
// parse's entry point (garlic_tpu/native/garlic_native.cpp:721).
void gt_tped_copy(void *hv, int c, int64_t *positions, double *gpos,
                  char *alleles, int8_t *geno, uint8_t *first_copy,
                  double *freq, char *names_buf) {
  TpedHandle *h = (TpedHandle *)hv;
  ChromBlock &b = h->chroms[c];
  int64_t L = (int64_t)b.positions.size();
  int64_t I = h->nstore;
  memcpy(positions, b.positions.data(), L * sizeof(int64_t));
  memcpy(gpos, b.gpos.data(), L * sizeof(double));
  memcpy(alleles, b.allele.data(), L * sizeof(char));
  memcpy(freq, b.freq.data(), L * sizeof(double));
  memcpy(names_buf, b.names.data(), b.names.size());
  transpose_blocked(h->geno.data() + b.row_offset * I, geno, L, I);
  if (first_copy != nullptr && h->has_fc) {
    transpose_blocked(h->first_copy.data() + b.row_offset * I, first_copy,
                      L, I);
  }
}

// Copy chromosome c with genotypes emitted DIRECTLY as 2-bit codes
// [I][rb] (rb = ceil(L/4); tail codes 3 = missing): a fused blocked
// transpose+pack that writes 4x fewer bytes than the int8 copy — the
// fast engine ships these to the device verbatim, so the int8 matrix
// never exists.  first_copy is NOT produced (phased runs use the int8
// entry point).
void gt_tped_copy_2bit(void *hv, int c, int64_t *positions, double *gpos,
                       char *alleles, uint8_t *geno2b, int64_t rb,
                       double *freq, char *names_buf) {
  TpedHandle *h = (TpedHandle *)hv;
  ChromBlock &b = h->chroms[c];
  int64_t L = (int64_t)b.positions.size();
  int64_t I = h->nstore;
  memcpy(positions, b.positions.data(), L * sizeof(int64_t));
  memcpy(gpos, b.gpos.data(), L * sizeof(double));
  memcpy(alleles, b.allele.data(), L * sizeof(char));
  memcpy(freq, b.freq.data(), L * sizeof(double));
  memcpy(names_buf, b.names.data(), b.names.size());
  const int8_t *src = h->geno.data() + b.row_offset * I;
  static const uint8_t lut_miss = 3;
  const int64_t BI = 32, BL = 128;  // BL multiple of 4: bytes don't straddle
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i0 = 0; i0 < I; i0 += BI) {
    int64_t i1 = i0 + BI < I ? i0 + BI : I;
    int8_t tmp[BI * BL];
    for (int64_t l0 = 0; l0 < L; l0 += BL) {
      int64_t l1 = l0 + BL < L ? l0 + BL : L;
      for (int64_t l = l0; l < l1; l++) {
        const int8_t *row = src + l * I;
        for (int64_t i = i0; i < i1; i++)
          tmp[(i - i0) * BL + (l - l0)] = row[i];
      }
      int64_t nb_full = (l1 - l0) / 4;
      for (int64_t i = i0; i < i1; i++) {
        const int8_t *t = tmp + (i - i0) * BL;
        uint8_t *dst = geno2b + i * rb + (l0 >> 2);
        for (int64_t k = 0; k < nb_full; k++) {
          uint8_t c0 = t[4 * k] < 0 ? lut_miss : (uint8_t)t[4 * k];
          uint8_t c1 = t[4 * k + 1] < 0 ? lut_miss : (uint8_t)t[4 * k + 1];
          uint8_t c2 = t[4 * k + 2] < 0 ? lut_miss : (uint8_t)t[4 * k + 2];
          uint8_t c3 = t[4 * k + 3] < 0 ? lut_miss : (uint8_t)t[4 * k + 3];
          dst[k] = (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
        }
        int64_t rem = (l1 - l0) - nb_full * 4;  // only at l1 == L
        if (rem) {
          uint8_t acc = 0xFF;
          for (int64_t j = 0; j < rem; j++) {
            int8_t v = t[nb_full * 4 + j];
            uint8_t cc = v < 0 ? lut_miss : (uint8_t)v;
            acc = (uint8_t)((acc & ~(3u << (j * 2))) | (cc << (j * 2)));
          }
          dst[nb_full] = acc;
        }
      }
    }
  }
}

void gt_tped_close(void *hv) { delete (TpedHandle *)hv; }

}  // extern "C" (reopened below — helpers between need C++ linkage)

// ---------------------------------------------------------------------------
// TGLS genotype-likelihood reader.  Reference behavior: readTGLSData
// (src/garlic-data.cpp:1516-1586) — one row per TPED locus, 4 leading
// columns then one raw value per individual; a row whose column count
// differs from nind+4 aborts the load.
//
// Values are stored by TOKEN DICTIONARY when the file holds <= 255
// distinct tokens of <= 8 characters (GQ/PL phred columns in practice:
// a handful of small integers repeated hundreds of millions of times):
// a [rows][nind] u8 code matrix plus a parsed-once lut of raw doubles —
// 8x smaller than the double matrix, and the codes ship to the TPU
// verbatim where a K-way select rebuilds the error plane.  Equal tokens
// parse to equal doubles, so mapping via tokens is bit-identical to
// parsing every token.  Files that exceed the dictionary (arbitrary GL
// floats) fall back to a full double matrix, converted mid-parse.

namespace {

struct TglsHandle {
  int64_t nind = 0;
  int64_t nrows = 0;        // complete rows stored
  bool dict_mode = true;
  std::vector<uint8_t> codes;  // [nrows][nind] (dict mode)
  std::vector<double> vals;    // [nrows][nind] (fallback mode)
  std::vector<double> lut;     // raw token values, code -> value
  int64_t est_rows = 0;        // arena reservation estimate
  int64_t bad_row = -1;        // first row with a wrong column count
  int64_t bad_cols = -1;       // its observed column count
};

// Open-addressing 128-bit-token -> u8 map for the token dictionary
// (<= 255 live entries in 4096 slots: ~6% load, every probe an L1 hit).
// Keys are the token's raw bytes zero-padded into two u64 lanes, so
// tokens up to 16 chars (GQ/PL phred ints AND typical GL log10 floats)
// dictionary-compress; longer tokens fall back to the double matrix.
struct TokDict {
  static const int64_t SLOTS = 4096;
  uint64_t klo[SLOTS];
  uint64_t khi[SLOTS];
  uint8_t codes[SLOTS];
  int n = 0;
  TokDict() {
    memset(klo, 0, sizeof(klo));
    memset(khi, 0, sizeof(khi));
  }
  static inline int64_t slot0(uint64_t lo, uint64_t hi) {
    return (int64_t)(((lo ^ (hi * 0xC2B2AE3D27D4EB4Full))
                      * 0x9E3779B97F4A7C15ull) >> 52);
  }
  // read-only probe: code or -1 (empty slot = both lanes 0; a real
  // token's first byte is non-NUL, so lo != 0 for every live key)
  inline int find(uint64_t lo, uint64_t hi) const {
    for (int64_t s = slot0(lo, hi);; s = (s + 1) & (SLOTS - 1)) {
      if (klo[s] == lo && khi[s] == hi) return codes[s];
      if (klo[s] == 0 && khi[s] == 0) return -1;
    }
  }
  // insert (caller guarantees absent); false when the dictionary is full
  inline bool insert(uint64_t lo, uint64_t hi, std::vector<double> &lut) {
    if (n >= 255) return false;
    for (int64_t s = slot0(lo, hi);; s = (s + 1) & (SLOTS - 1)) {
      if (klo[s] == 0 && khi[s] == 0) {
        klo[s] = lo;
        khi[s] = hi;
        codes[s] = (uint8_t)n;
        char buf[17];
        memcpy(buf, &lo, 8);
        memcpy(buf + 8, &hi, 8);
        buf[16] = '\0';
        lut.push_back(strtod(buf, nullptr));
        n++;
        return true;
      }
    }
  }
};

// Tokenize one TGLS line: total field count, (lo, hi) u64 key pairs for
// fields 4..4+nind (token bytes zero-padded; tokens > 16 chars set
// *has_long).
inline void tgls_line_keys(const char *p, const char *end, int64_t nind,
                           uint64_t *keys, int64_t *nfields,
                           bool *has_long) {
  int64_t nf = 0;
  bool lng = false;
  while (p < end) {
    while (p < end && ws_c((unsigned char)*p)) p++;
    if (p >= end) break;
    const char *tb = p;
    while (p < end && !ws_c((unsigned char)*p)) p++;
    int64_t idx = nf - 4;
    if (idx >= 0 && idx < nind) {
      int64_t len = p - tb;
      if (len <= 16) {
        uint64_t lo = 0, hi = 0;
        if (len > 8) {
          memcpy(&lo, tb, 8);
          memcpy(&hi, tb + 8, (size_t)(len - 8));
        } else {
          memcpy(&lo, tb, (size_t)len);
        }
        keys[2 * idx] = lo;
        keys[2 * idx + 1] = hi;
      } else {
        lng = true;
      }
    }
    nf++;
  }
  *nfields = nf;
  *has_long = lng;
}

// Fallback tokenizer: parse fields 4..4+nind as doubles.
inline void tgls_line_vals(const char *p, const char *end, int64_t nind,
                           double *vals, int64_t *nfields) {
  int64_t nf = 0;
  while (p < end) {
    while (p < end && ws_c((unsigned char)*p)) p++;
    if (p >= end) break;
    const char *tb = p;
    while (p < end && !ws_c((unsigned char)*p)) p++;
    int64_t idx = nf - 4;
    if (idx >= 0 && idx < nind) {
      // chunk buffers are std::string-backed: data() is NUL-terminated
      // and tokens never touch the terminator, so strtod stops at the
      // following whitespace
      vals[idx] = strtod(tb, nullptr);
    }
    nf++;
  }
  *nfields = nf;
}

// Dictionary overflow / long-token fallback: expand the codes stored so
// far into doubles via the lut and drop the code arena.
void tgls_to_vals(TglsHandle *h) {
  // one arena reservation (growing-vector realloc churn costs seconds of
  // page faults under this VM — same hazard the TPED parser avoids)
  if (h->est_rows > 0)
    h->vals.reserve((size_t)(h->est_rows * h->nind));
  h->vals.resize(h->codes.size());
  const double *lut = h->lut.data();
  const uint8_t *c = h->codes.data();
  double *v = h->vals.data();
  int64_t n = (int64_t)h->codes.size();
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t t = 0; t < n; t++) v[t] = lut[c[t]];
  h->codes.clear();
  h->codes.shrink_to_fit();
  h->dict_mode = false;
}

inline double tgls_key_to_double(uint64_t lo, uint64_t hi) {
  char buf[17];
  memcpy(buf, &lo, 8);
  memcpy(buf + 8, &hi, 8);
  buf[16] = '\0';
  return strtod(buf, nullptr);
}

}  // namespace

extern "C" {

void *gt_tgls_open(const char *path, int64_t nind) {
  const bool timing = getenv("GT_PARSE_TIMING") != nullptr;
  double t_read = 0, t_tok = 0, t_dict = 0;
  auto now = [] { return std::chrono::steady_clock::now(); };
  auto secs = [](auto a, auto b) {
    return std::chrono::duration<double>(b - a).count();
  };
  int64_t size_hint = uncompressed_size_hint(path);
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, 1 << 20);
  auto *h = new TglsHandle;
  h->nind = nind;
  const size_t CHUNK = 64u << 20;

  // producer thread: sequential gz inflation into a depth-2 queue (same
  // overlap structure as gt_tped_open)
  struct Q {
    std::mutex m;
    std::condition_variable cv;
    std::deque<std::pair<std::string, bool>> chunks;
    bool failed = false;
    bool abort = false;
  } q;
  std::thread reader([&] {
    for (;;) {
      std::string c(CHUNK, '\0');
      int got = gzread(f, &c[0], (unsigned)CHUNK);
      if (got < 0) {
        std::lock_guard<std::mutex> lk(q.m);
        q.failed = true;
        q.chunks.emplace_back(std::string(), true);
        q.cv.notify_all();
        return;
      }
      c.resize((size_t)got);
      bool last = (size_t)got < CHUNK;
      {
        std::unique_lock<std::mutex> lk(q.m);
        q.cv.wait(lk, [&] { return q.chunks.size() < 2 || q.abort; });
        if (q.abort) return;
        q.chunks.emplace_back(std::move(c), last);
        q.cv.notify_all();
      }
      if (last) return;
    }
  });
  auto abort_reader = [&] {
    std::lock_guard<std::mutex> lk(q.m);
    q.abort = true;
    q.cv.notify_all();
  };

  TokDict dict;
  std::string buf;
  buf.reserve(CHUNK + (1u << 20));
  std::string carry;
  std::vector<const char *> starts;
  std::vector<size_t> lens;
  std::vector<uint64_t> keys_chunk;
  std::vector<double> vals_chunk;
  std::vector<uint8_t> codes_chunk;
  std::vector<int64_t> nfields_chunk;
  std::vector<uint8_t> miss_chunk;  // dict mode: line had unseen tokens
  bool reserved = false;
  bool failed = false;
  bool done = false;
  while (!done && h->bad_row < 0 && !failed) {
    auto t0 = now();
    std::string chunk;
    {
      std::unique_lock<std::mutex> lk(q.m);
      q.cv.wait(lk, [&] { return !q.chunks.empty(); });
      chunk = std::move(q.chunks.front().first);
      done = q.chunks.front().second;
      q.chunks.pop_front();
      q.cv.notify_all();
      if (q.failed) failed = true;
    }
    if (failed) break;
    buf.assign(carry);
    carry.clear();
    buf += chunk;
    t_read += secs(t0, now());
    if (!done) {
      size_t last_nl = buf.rfind('\n');
      if (last_nl == std::string::npos) { carry.swap(buf); continue; }
      carry.assign(buf, last_nl + 1, std::string::npos);
      buf.resize(last_nl + 1);
    }
    if (buf.empty()) continue;
    auto t1 = now();
    starts.clear();
    lens.clear();
    const char *p = buf.data();
    const char *bend = p + buf.size();
    while (p < bend) {
      const char *nl = (const char *)memchr(p, '\n', bend - p);
      const char *e = nl ? nl : bend;
      size_t len = e - p;
      if (len && e[-1] == '\r') len--;
      starts.push_back(p);
      lens.push_back(len);
      p = nl ? nl + 1 : bend;
    }
    int64_t n = (int64_t)starts.size();
    if (n == 0) continue;
    if (!reserved && size_hint > 0 && lens[0] > 0) {
      int64_t est_rows = size_hint / (int64_t)(lens[0] + 1) + 16;
      est_rows += est_rows / 32;
      h->est_rows = est_rows;
      if (h->dict_mode) h->codes.reserve((size_t)(est_rows * nind));
      reserved = true;
    }
    nfields_chunk.assign((size_t)n, 0);
    bool chunk_dict = h->dict_mode;
    if (chunk_dict) {
      keys_chunk.assign((size_t)(2 * n * nind), 0);
      codes_chunk.assign((size_t)(n * nind), 0);
      miss_chunk.assign((size_t)n, 0);
      std::atomic<bool> any_long(false);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (int64_t i = 0; i < n; i++) {
        bool lng = false;
        tgls_line_keys(starts[i], starts[i] + lens[i], nind,
                       keys_chunk.data() + 2 * i * nind,
                       &nfields_chunk[i], &lng);
        if (lng) any_long.store(true, std::memory_order_relaxed);
      }
      if (any_long.load()) {
        // > 16-char tokens: dictionary off for the whole file
        tgls_to_vals(h);
        chunk_dict = false;
      }
    }
    if (chunk_dict) {
      t_tok += secs(t1, now());
      auto t2 = now();
      // phase 1 (parallel): probe the FROZEN dictionary; unseen tokens
      // only flag their line.  After the first chunk this is ~all hits.
      const TokDict &dref = dict;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (int64_t i = 0; i < n; i++) {
        if (nfields_chunk[i] != nind + 4) continue;  // serial pass stops
        const uint64_t *k = keys_chunk.data() + 2 * i * nind;
        uint8_t *c = codes_chunk.data() + i * nind;
        uint8_t miss = 0;
        for (int64_t j = 0; j < nind; j++) {
          int code = dref.find(k[2 * j], k[2 * j + 1]);
          if (code < 0) {
            miss = 1;
          } else {
            c[j] = (uint8_t)code;
          }
        }
        miss_chunk[i] = miss;
      }
      // phase 2 (serial, first-seen order): rows in order; flagged rows
      // re-probe and insert.  Deterministic code assignment -> the code
      // matrix bytes (and their content digest) are stable across runs.
      int64_t stop = n;
      for (int64_t i = 0; i < n; i++) {
        if (nfields_chunk[i] != nind + 4) {
          h->bad_row = h->nrows + i;
          h->bad_cols = nfields_chunk[i];
          stop = i;
          break;
        }
        if (!miss_chunk[i]) continue;
        const uint64_t *k = keys_chunk.data() + 2 * i * nind;
        uint8_t *c = codes_chunk.data() + i * nind;
        bool overflow = false;
        for (int64_t j = 0; j < nind; j++) {
          int code = dict.find(k[2 * j], k[2 * j + 1]);
          if (code < 0) {
            if (!dict.insert(k[2 * j], k[2 * j + 1], h->lut)) {
              overflow = true;
              break;
            }
            code = dict.find(k[2 * j], k[2 * j + 1]);
          }
          c[j] = (uint8_t)code;
        }
        if (overflow) {
          // > 255 distinct tokens: convert history + the rows of this
          // chunk processed so far, then finish the chunk from keys
          h->codes.insert(h->codes.end(), codes_chunk.begin(),
                          codes_chunk.begin() + i * nind);
          h->nrows += i;
          tgls_to_vals(h);
          int64_t old = (int64_t)h->vals.size();
          h->vals.resize((size_t)(old + (n - i) * nind));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
          for (int64_t r = i; r < n; r++) {
            double *v = h->vals.data() + old + (r - i) * nind;
            const uint64_t *kk = keys_chunk.data() + 2 * r * nind;
            for (int64_t j = 0; j < nind; j++)
              v[j] = tgls_key_to_double(kk[2 * j], kk[2 * j + 1]);
          }
          // bad rows within the remainder still abort at the right row
          for (int64_t r = i; r < n; r++) {
            if (nfields_chunk[r] != nind + 4) {
              h->vals.resize((size_t)(old + (r - i) * nind));
              // nrows was already advanced once per good row above, so
              // it equals the failing global row index here — adding
              // (r - i) again would double-count (round-3 advisor)
              h->bad_row = h->nrows;
              h->bad_cols = nfields_chunk[r];
              break;
            }
            h->nrows++;
          }
          stop = -1;  // rows already appended
          break;
        }
      }
      if (stop >= 0) {
        h->codes.insert(h->codes.end(), codes_chunk.begin(),
                        codes_chunk.begin() + stop * nind);
        h->nrows += stop;
      }
      t_dict += secs(t2, now());
    } else {
      // fallback: parallel strtod of every value
      vals_chunk.assign((size_t)(n * nind), 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
      for (int64_t i = 0; i < n; i++) {
        tgls_line_vals(starts[i], starts[i] + lens[i], nind,
                       vals_chunk.data() + i * nind, &nfields_chunk[i]);
      }
      t_tok += secs(t1, now());
      int64_t stop = n;
      for (int64_t i = 0; i < n; i++) {
        if (nfields_chunk[i] != nind + 4) {
          h->bad_row = h->nrows + i;
          h->bad_cols = nfields_chunk[i];
          stop = i;
          break;
        }
      }
      h->vals.insert(h->vals.end(), vals_chunk.begin(),
                     vals_chunk.begin() + stop * nind);
      h->nrows += stop;
    }
    if (h->bad_row >= 0) abort_reader();
  }
  if (failed) abort_reader();
  if (timing) {
    fprintf(stderr,
            "[gt_tgls] wait=%.2fs tok=%.2fs dict=%.2fs rows=%lld lut=%d\n",
            t_read, t_tok, t_dict, (long long)h->nrows,
            (int)h->lut.size());
  }
  reader.join();
  gzclose(f);
  if (failed) {
    delete h;
    return nullptr;
  }
  return h;
}

int gt_tgls_dict(void *hv) { return ((TglsHandle *)hv)->dict_mode ? 1 : 0; }
int64_t gt_tgls_nrows(void *hv) { return ((TglsHandle *)hv)->nrows; }
int64_t gt_tgls_nlut(void *hv) {
  return (int64_t)((TglsHandle *)hv)->lut.size();
}
int64_t gt_tgls_bad_row(void *hv) { return ((TglsHandle *)hv)->bad_row; }
int64_t gt_tgls_bad_cols(void *hv) { return ((TglsHandle *)hv)->bad_cols; }

void gt_tgls_get_lut(void *hv, double *out) {
  TglsHandle *h = (TglsHandle *)hv;
  memcpy(out, h->lut.data(), h->lut.size() * sizeof(double));
}

// Copy rows [row0, row0+L) transposed to [nind][L].
void gt_tgls_copy_codes(void *hv, int64_t row0, int64_t L, uint8_t *out) {
  TglsHandle *h = (TglsHandle *)hv;
  transpose_blocked(h->codes.data() + row0 * h->nind, out, L, h->nind);
}

void gt_tgls_copy_vals(void *hv, int64_t row0, int64_t L, double *out) {
  TglsHandle *h = (TglsHandle *)hv;
  transpose_blocked(h->vals.data() + row0 * h->nind, out, L, h->nind);
}

void gt_tgls_close(void *hv) { delete (TglsHandle *)hv; }

// Exact rolling-window LOD: terms [I][L] f64, missing [nwin] u8 (1=missing),
// out win [I][L] f64 pre-filled by caller or filled here with MISSING.
void gt_lod_windows_exact(const double *terms, const uint8_t *missing,
                          int64_t I, int64_t L, int64_t W, double miss_val,
                          double *win) {
  int64_t nwin = L - W + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t ind = 0; ind < I; ind++) {
    const double *a = terms + ind * L;
    double *w = win + ind * L;
    for (int64_t l = 0; l < L; l++) w[l] = miss_val;
    if (nwin <= 0) continue;
    int64_t l = 0;
    bool have_acc = false;
    double acc = 0.0;
    while (l < nwin) {
      if (missing[l]) {
        have_acc = false;
        l++;
        continue;
      }
      if (!have_acc) {
        acc = 0.0;
        for (int64_t k = 0; k < W; k++) acc += a[l + k];
        have_acc = true;
      } else {
        acc = (acc - a[l - 1]) + a[l + W - 1];
      }
      w[l] = acc;
      l++;
    }
  }
}

// Append one chromosome's rows to <path> (gzip level 1; the decompressed
// bytes are the comparison artifact, not the container). append=0 truncates
// and writes the header line first. names: '\n'-joined locus names.
int gt_write_freq_chrom(const char *path, int append, const char *chrom,
                        const char *names, int64_t names_len,
                        const int64_t *pos, const char *alleles,
                        const double *freq, int64_t L) {
  gzFile f = gzopen(path, append ? "ab1" : "wb1");
  if (!f) return -1;
  std::string buf;
  buf.reserve(1 << 20);
  if (!append) buf += "CHR\tSNP\tPOS\tALLELE\tFREQ\n";
  const char *np = names;
  const char *nend = names + names_len;
  // chrom and locus names are arbitrary-length: append them via std::string
  // (no fixed buffer); snprintf only the bounded numeric tail.
  char tmp[96];
  for (int64_t l = 0; l < L; l++) {
    const char *ne = np;
    while (ne < nend && *ne != '\n') ne++;
    buf += chrom;
    buf += '\t';
    buf.append(np, (size_t)(ne - np));
    int n = snprintf(tmp, sizeof(tmp), "\t%lld\t%c\t%g\n",
                     (long long)pos[l], alleles[l], freq[l]);
    buf.append(tmp, (size_t)n);
    np = ne < nend ? ne + 1 : nend;
    if (buf.size() > (1 << 20) - 256) {
      if (gzwrite(f, buf.data(), (unsigned)buf.size()) <= 0) {
        gzclose(f);
        return -1;
      }
      buf.clear();
    }
  }
  if (!buf.empty() && gzwrite(f, buf.data(), (unsigned)buf.size()) <= 0) {
    gzclose(f);
    return -1;
  }
  return gzclose(f) == Z_OK ? 0 : -1;
}

namespace {

struct Run {
  int32_t ind;
  int64_t start_idx, stop_idx;
};

// Verbatim transliteration of the reference run scan
// (src/garlic-roh.cpp:462-532) over one individual's covered bits
// (little-endian bit packing, numpy packbits bitorder="little").
void scan_runs(const uint8_t *bits, const uint8_t *br, const int64_t *pos,
               int64_t L, double threshold, int32_t ind,
               std::vector<Run> &out) {
  int64_t win_start = -1, win_start_idx = -1;
  for (int64_t w = 0; w < L; w++) {
    if (win_start < 0) {
      // With no active run (-1; the position-0 quirk keeps win_start==0
      // runs on the slow path) only a covered window changes state, so
      // leap over zero bytes/words of the bitmap — coverage is sparse
      // (most of the genome is not in ROH), which turns this scan from
      // per-window branches into a memchr-style sweep.
      uint8_t b = (uint8_t)(bits[w >> 3] >> (w & 7));
      if (b == 0) {
        w += 8 - (w & 7);
        while (w + 64 <= L) {
          uint64_t x;
          memcpy(&x, bits + (w >> 3), 8);
          if (x) break;
          w += 64;
        }
        while (w + 8 <= L && bits[w >> 3] == 0) w += 8;
        if (w >= L) break;
        b = (uint8_t)(bits[w >> 3] >> (w & 7));
        if (b == 0) break;  // only zero padding bits remain past L
      }
      w += __builtin_ctz((unsigned)b);
      if (w >= L) break;  // defensive: set padding bit past L
      win_start = pos[w];
      win_start_idx = w;
      continue;
    }
    bool cov = (bits[w >> 3] >> (w & 7)) & 1;
    if (win_start < 0 && cov) {
      win_start = pos[w];
      win_start_idx = w;
    } else if (cov && br[w]) {
      int64_t stop_idx = w - 1;
      if ((double)(stop_idx - win_start_idx + 1) >= threshold)
        out.push_back({ind, win_start_idx, stop_idx});
      win_start = pos[w];
      win_start_idx = w;
    } else if (win_start > 0 && !cov) {
      int64_t stop_idx = w - 1;
      if ((double)(stop_idx - win_start_idx + 1) >= threshold)
        out.push_back({ind, win_start_idx, stop_idx});
      win_start = -1;
      win_start_idx = -1;
    } else if (win_start > 0 && w + 1 >= L) {
      if ((double)(w - win_start_idx + 1) >= threshold)
        out.push_back({ind, win_start_idx, w});
      win_start = -1;
      win_start_idx = -1;
    }
  }
}

}  // namespace

// Extract ROH runs for all individuals of one chromosome.
// covered_packed: [I][row_bytes] little-endian bit-packed coverage flags.
// br: [L] pair-break flags; pos/gpos: [L]. Returns the run count, or
// -(needed) when cap is too small (caller retries with a larger buffer).
// Output order is individual-major then position — the reference's pooled
// (ind, chr, position) ordering per chromosome.
int64_t gt_assemble_runs(const uint8_t *covered_packed, int64_t row_bytes,
                         const uint8_t *br, const int64_t *pos,
                         const double *gpos, int64_t I, int64_t L,
                         double threshold, int use_cm, int32_t *out_ind,
                         int64_t *out_start, int64_t *out_stop,
                         double *out_size, int64_t cap) {
  std::vector<std::vector<Run>> per_ind((size_t)I);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < I; i++) {
    scan_runs(covered_packed + i * row_bytes, br, pos, L, threshold,
              (int32_t)i, per_ind[(size_t)i]);
  }
  int64_t total = 0;
  for (auto &v : per_ind) total += (int64_t)v.size();
  if (total > cap) return -total;
  int64_t n = 0;
  for (auto &v : per_ind) {
    for (const Run &r : v) {
      out_ind[n] = r.ind;
      out_start[n] = pos[r.start_idx];
      out_stop[n] = pos[r.stop_idx];
      out_size[n] = use_cm ? (gpos[r.stop_idx] - gpos[r.start_idx])
                           : (double)(pos[r.stop_idx] - pos[r.start_idx] + 1);
      n++;
    }
  }
  return n;
}

// Table-driven exact rolling LOD: identical to gt_lod_windows_exact but
// reads per-locus f64 lod values from a [4][L] table indexed by genotype
// class (0/1/2, -9 -> row 3 == 0.0) instead of a materialized [I][L]
// terms matrix — per-(genotype, locus) values are exactly the scalar
// lod() results, so the f64 summation stays bit-identical to the
// reference (src/garlic-roh.cpp:46-126,355-386).
void gt_lod_windows_exact_tbl(const int8_t *geno, const double *table,
                              const uint8_t *missing, int64_t I, int64_t L,
                              int64_t W, double miss_val, double *win) {
  int64_t nwin = L - W + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t ind = 0; ind < I; ind++) {
    const int8_t *g = geno + ind * L;
    double *w = win + ind * L;
    for (int64_t l = 0; l < L; l++) w[l] = miss_val;
    if (nwin <= 0) continue;
    auto term = [&](int64_t l) -> double {
      int8_t v = g[l];
      int row = v < 0 ? 3 : (int)v;
      return table[(size_t)row * L + l];
    };
    int64_t l = 0;
    bool have_acc = false;
    double acc = 0.0;
    while (l < nwin) {
      if (missing[l]) {
        have_acc = false;
        l++;
        continue;
      }
      if (!have_acc) {
        acc = 0.0;
        for (int64_t k = 0; k < W; k++) acc += term(l + k);
        have_acc = true;
      } else {
        acc = (acc - term(l - 1)) + term(l + W - 1);
      }
      w[l] = acc;
      l++;
    }
  }
}

// Thinned exact rolling windows: the SAME sequential subtract/add
// recurrence as gt_lod_windows_exact_tbl (the thinned Phase-II sample
// values depend on the full rolling history), but only every step-th
// window is WRITTEN — out is [I][ceil(L/step)] instead of [I][L], so a
// 1000x1M exact sampling pass writes 1/step of the bytes and never
// allocates the 512 MB per-chunk window matrices the thin-after-compute
// route did (measured ~10 s of the auto-everything wall at that scale).
void gt_lod_windows_exact_thin(const int8_t *geno, const double *table,
                               const uint8_t *missing, int64_t I, int64_t L,
                               int64_t W, int64_t step, double miss_val,
                               double *out) {
  int64_t nwin = L - W + 1;
  int64_t nthin = (L + step - 1) / step;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t ind = 0; ind < I; ind++) {
    const int8_t *g = geno + ind * L;
    double *w = out + ind * nthin;
    for (int64_t t = 0; t < nthin; t++) w[t] = miss_val;
    if (nwin <= 0) continue;
    auto term = [&](int64_t l) -> double {
      int8_t v = g[l];
      int row = v < 0 ? 3 : (int)v;
      return table[(size_t)row * L + l];
    };
    int64_t l = 0;
    bool have_acc = false;
    double acc = 0.0;
    while (l < nwin) {
      if (missing[l]) {
        have_acc = false;
        l++;
        continue;
      }
      if (!have_acc) {
        acc = 0.0;
        for (int64_t k = 0; k < W; k++) acc += term(l + k);
        have_acc = true;
      } else {
        acc = (acc - term(l - 1)) + term(l + W - 1);
      }
      if (l % step == 0) w[l / step] = acc;
      l++;
    }
  }
}

// In-place column compaction of an [I][row_stride] matrix (elem_size
// bytes per element): keeps columns where keep[l] != 0, moving kept spans
// left with memmove (kept columns are usually >99% contiguous runs, so
// this is a handful of big moves per row and allocates NOTHING — a fresh
// compacted copy costs seconds of page faults under virtualization).
// Returns the number of kept columns.
int64_t gt_filter_columns(void *data, int64_t I, int64_t L,
                          int64_t elem_size, const uint8_t *keep) {
  // build kept spans once
  std::vector<std::pair<int64_t, int64_t>> spans;  // (start, len)
  int64_t l = 0;
  int64_t nkeep = 0;
  while (l < L) {
    if (keep[l]) {
      int64_t s = l;
      while (l < L && keep[l]) l++;
      spans.emplace_back(s, l - s);
      nkeep += l - s;
    } else {
      l++;
    }
  }
  char *base = (char *)data;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < I; i++) {
    char *row = base + i * L * elem_size;
    int64_t dst = 0;
    for (const auto &sp : spans) {
      if (sp.first != dst) {
        memmove(row + dst * elem_size, row + sp.first * elem_size,
                (size_t)(sp.second * elem_size));
      }
      dst += sp.second;
    }
  }
  return nkeep;
}

// Coverage counting + threshold + bit packing in one pass per row:
// covered[s] = (#window-starts in [s-W+1, s] with win >= cutoff) >=
// threshold, little-endian bit packing (row_bytes per row).  Replaces a
// numpy cumsum/compare/packbits chain whose [I][L] temporaries fault
// hundreds of MB (assembleROHWindows' inWin accumulation,
// src/garlic-roh.cpp:446-454).
void gt_covered_pack(const double *win, int64_t I, int64_t L, int64_t W,
                     double cutoff, double threshold, uint8_t *packed,
                     int64_t row_bytes) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < I; i++) {
    const double *w = win + i * L;
    uint8_t *row = packed + i * row_bytes;
    memset(row, 0, (size_t)row_bytes);
    int64_t cnt = 0;
    for (int64_t s = 0; s < L; s++) {
      if (w[s] >= cutoff) cnt++;
      if (s >= W && w[s - W] >= cutoff) cnt--;
      if ((double)cnt >= threshold) row[s >> 3] |= (uint8_t)(1u << (s & 7));
    }
  }
}

// Fused pad+pack: read an [I][L] int8 genotype matrix (row stride in
// elements, so filtered [:, :nkeep] views work) and emit the padded
// [I2][Lq] 2-bit matrix directly (rows >= I and columns >= L become the
// missing code 3).  Replaces a 115MB staging buffer fill + copy + pack.
void gt_pack_2bit_padded(const int8_t *src, int64_t I, int64_t L,
                         int64_t row_stride, uint8_t *dst, int64_t I2,
                         int64_t Lq) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < I2; i++) {
    uint8_t *row = dst + i * Lq;
    if (i >= I) {
      memset(row, 0xFF, (size_t)Lq);  // all-missing padding rows
      continue;
    }
    const int8_t *s = src + i * row_stride;
    int64_t full = L / 4;
    for (int64_t q = 0; q < full; q++) {
      uint8_t b = 0;
      for (int k = 0; k < 4; k++) {
        int8_t v = s[q * 4 + k];
        b |= (uint8_t)((v < 0 ? 3u : (uint8_t)v) << (2 * k));
      }
      row[q] = b;
    }
    if (full < Lq) {
      // partial quad at the L boundary, then missing padding
      uint8_t b = 0;
      for (int k = 0; k < 4; k++) {
        int64_t l = full * 4 + k;
        uint8_t c = l < L ? (s[l] < 0 ? 3u : (uint8_t)s[l]) : 3u;
        b |= (uint8_t)(c << (2 * k));
      }
      row[full] = b;
      if (full + 1 < Lq) memset(row + full + 1, 0xFF, (size_t)(Lq - full - 1));
    }
  }
}

// 128-bit content hash for the device panel cache keys.  Chunked
// multiply-xor mixing (splitmix64 finalizer per 8-byte lane), chunks
// hashed in parallel and combined in order, so the digest is
// deterministic regardless of thread count.  Collision-resistance here
// only needs to beat accidental aliasing of genotype panels (the cache
// is process-local, no adversary); the win over blake2b is ~20x
// throughput on this host (memory-bound, OpenMP over chunks).
static inline uint64_t gt_mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

static uint64_t gt_hash_chunk(const uint8_t *p, int64_t n, uint64_t seed) {
  uint64_t h = gt_mix64(seed ^ (uint64_t)n);
  int64_t nw = n / 8;
  uint64_t buf;
  for (int64_t i = 0; i < nw; i++) {
    memcpy(&buf, p + i * 8, 8);
    h = gt_mix64(h ^ buf);
  }
  uint64_t tail = 0;
  for (int64_t i = nw * 8; i < n; i++) tail = (tail << 8) | p[i];
  return gt_mix64(h ^ tail);
}

void gt_hash128(const uint8_t *buf, int64_t n, uint64_t *out) {
  const int64_t CHUNK = 4 << 20;
  int64_t nchunk = n > 0 ? (n + CHUNK - 1) / CHUNK : 1;
  std::vector<uint64_t> ch((size_t)nchunk * 2);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t c = 0; c < nchunk; c++) {
    int64_t lo = c * CHUNK;
    int64_t len = n - lo < CHUNK ? n - lo : CHUNK;
    if (len < 0) len = 0;
    ch[(size_t)c * 2] = gt_hash_chunk(buf + lo, len, 0x67617200ULL + (uint64_t)c);
    ch[(size_t)c * 2 + 1] = gt_hash_chunk(buf + lo, len, 0x6c696300ULL + (uint64_t)c);
  }
  uint64_t h0 = gt_mix64((uint64_t)n);
  uint64_t h1 = gt_mix64(~(uint64_t)n);
  for (int64_t c = 0; c < nchunk; c++) {
    h0 = gt_mix64(h0 ^ ch[(size_t)c * 2]);
    h1 = gt_mix64(h1 ^ ch[(size_t)c * 2 + 1]);
  }
  out[0] = h0;
  out[1] = h1;
}


// Happy-path freq-file reader (gz or plain; zlib transparently reads
// both).  Parses the reference's 5-column table (garlic-data.cpp
// readFreqData semantics: skip header, whitespace-tokenized rows,
// row/column-count and locus-name validation, allele flip on mismatch)
// and fills out_freq[nloci].  ANY anomaly returns nonzero WITHOUT
// localizing it: the caller re-parses with the Python reader, which
// reproduces the reference's exact error text — so this path stays a
// pure fast path.  names: '\n'-joined locus names across all
// chromosomes in file order; alleles: one char per locus.
int gt_read_freq(const char *path, const char *names, int64_t names_len,
                 const char *alleles, int64_t nloci, double *out_freq) {
  gzFile f = gzopen(path, "rb");
  if (!f) return 6;
  gzbuffer(f, 1 << 20);
  std::string data;
  data.reserve(16u << 20);
  std::vector<char> chunk(4u << 20);
  for (;;) {
    int got = gzread(f, chunk.data(), (unsigned)chunk.size());
    if (got < 0) { gzclose(f); return 6; }
    data.append(chunk.data(), (size_t)got);
    if ((size_t)got < chunk.size()) break;
  }
  gzclose(f);
  const char *p = data.data();
  const char *end = p + data.size();
  const char *nl = (const char *)memchr(p, '\n', (size_t)(end - p));
  if (!nl) return 1;  // header only / empty
  p = nl + 1;
  // row boundaries for exactly nloci data rows (extra trailing lines are
  // ignored, like the Python reader)
  std::vector<const char *> rb((size_t)nloci), re((size_t)nloci);
  for (int64_t r = 0; r < nloci; r++) {
    if (p >= end) return 1;  // short file
    const char *q = (const char *)memchr(p, '\n', (size_t)(end - p));
    if (!q) q = end;
    rb[(size_t)r] = p;
    re[(size_t)r] = q;
    p = q + 1;
  }
  // name offsets from the '\n'-joined blob
  std::vector<const char *> nb((size_t)nloci), ne((size_t)nloci);
  {
    const char *np = names;
    const char *nend = names + names_len;
    for (int64_t r = 0; r < nloci; r++) {
      const char *q = (const char *)memchr(np, '\n', (size_t)(nend - np));
      if (!q) q = nend;
      nb[(size_t)r] = np;
      ne[(size_t)r] = q;
      np = q < nend ? q + 1 : nend;
    }
  }
  auto is_ws = [](char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
  };
  // parse row r into out_freq[r]; returns false on any anomaly
  int ncols0 = -1;
  auto parse_row = [&](int64_t r, int *ncols_out) -> bool {
    const char *s = rb[(size_t)r];
    const char *e = re[(size_t)r];
    const char *tb[5];
    const char *te[5];
    int ncols = 0;
    while (s < e) {
      while (s < e && is_ws(*s)) s++;
      if (s >= e) break;
      const char *t0 = s;
      while (s < e && !is_ws(*s)) s++;
      if (ncols < 5) { tb[ncols] = t0; te[ncols] = s; }
      ncols++;
    }
    *ncols_out = ncols;
    if (ncols < 5) return false;
    // locus name match (field 1)
    size_t nlen = (size_t)(ne[(size_t)r] - nb[(size_t)r]);
    if ((size_t)(te[1] - tb[1]) != nlen ||
        memcmp(tb[1], nb[(size_t)r], nlen) != 0)
      return false;
    // freq (field 4): full-token strtod, same accepted forms as float()
    char buf[64];
    size_t flen = (size_t)(te[4] - tb[4]);
    if (flen == 0 || flen >= sizeof(buf)) return false;
    memcpy(buf, tb[4], flen);
    buf[flen] = '\0';
    char *endp = nullptr;
    double fr = strtod(buf, &endp);
    if (endp != buf + flen) return false;
    // allele flip (field 3 vs the panel's '1' allele)
    if (!((te[3] - tb[3]) == 1 && tb[3][0] == alleles[r])) fr = 1.0 - fr;
    out_freq[r] = fr;
    return true;
  };
  if (nloci == 0) return 0;
  if (!parse_row(0, &ncols0)) return 2;
  std::atomic<int> bad{0};
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 1; r < nloci; r++) {
    if (bad.load(std::memory_order_relaxed)) continue;
    int nc = 0;
    if (!parse_row(r, &nc) || nc != ncols0)
      bad.store(1, std::memory_order_relaxed);
  }
  return bad.load() ? 2 : 0;
}

}  // extern "C"
