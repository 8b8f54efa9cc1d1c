// FASTA/FASTQ parser of the port's counting, on the host: raw (decompressed)
// file bytes in, base codes out (A=0 C=1 G=2 T=3, N=4, anything else 5), one
// N between records, FASTQ bases whose quality byte is below min_qual masked
// to 5. Byte for byte the output of native/jt_fastx.cc's jt_parser_feed, for
// every input and every split of it into blocks, feed by feed.
//
// The work is done a line at a time. A FASTQ record that sits whole in the
// input (a header line, one sequence line with no '+' or '\r' inside, a '+'
// line, then as many quality bytes as bases, with no line end among them) has
// its line ends found with memchr, its sequence encoded in one loop
// straight into the output and masked against its quality line. FASTA
// sequence lines go the same way a line at a time, headers and the rest of a
// quality line are skipped with memchr. Anything else (wrapped FASTQ, a '+'
// or '\r' inside a sequence line, leading junk) goes through jt_fastx.cc's
// byte-at-a-time state machine, copied here, from the record's start to its
// end. A FASTQ record cut by the end of a block is kept as raw bytes and
// completed from the next block: the state machine emits nothing for such a
// prefix either, so the output of every feed is the same.
//
// Built by jasper_tpu_torch/io/native.py with the host compiler into
// jasper_tpu_torch/build/ and loaded with ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint8_t CODE_N = 4;
constexpr uint8_t CODE_INVALID = 5;
// a carried FASTQ prefix longer than this goes through the state machine,
// so a file with no line ends cannot grow the carry without bound
constexpr int64_t CARRY_MAX = int64_t(1) << 24;

struct CodeTable {
  uint8_t t[256];
  CodeTable() {
    memset(t, CODE_INVALID, sizeof(t));
    t[(unsigned)'A'] = t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = t[(unsigned)'c'] = 1;
    t[(unsigned)'G'] = t[(unsigned)'g'] = 2;
    t[(unsigned)'T'] = t[(unsigned)'t'] = 3;
    t[(unsigned)'N'] = t[(unsigned)'n'] = CODE_N;
  }
};
const CodeTable kCodes;

// dst[j] = the code of seq[j], or CODE_INVALID where qual (when given) has a
// byte below mq. With AVX2, 32 bytes at a time (the tail through a padded
// copy): ACGTN and acgtn differ in their low nibble, so one shuffle on it
// gives the code and another the letter (case folded) that must be there
// for the code to hold. Without AVX2, a table loop: on an H100 host it
// parses 733 MB/s in the HiFi count where the shuffles parse 1,040 MB/s.
// tests/test_torch_fastx_native.py builds and checks both (-mno-avx2).
#if defined(__AVX2__)
inline void encode32(const uint8_t* seq, const uint8_t* qual, __m256i floor, uint8_t* dst) {
  const __m256i codes = _mm256_setr_epi8(5, 0, 5, 1, 3, 5, 5, 2, 5, 5, 5, 5, 5, 5, 4, 5,
                                         5, 0, 5, 1, 3, 5, 5, 2, 5, 5, 5, 5, 5, 5, 4, 5);
  const char X = -1;  // no letter: (c & 0xDF) never reads 0xFF
  const __m256i letters = _mm256_setr_epi8(X, 'A', X, 'C', 'T', X, X, 'G', X, X, X, X, X, X, 'N', X,
                                           X, 'A', X, 'C', 'T', X, X, 'G', X, X, X, X, X, X, 'N', X);
  const __m256i c = _mm256_loadu_si256((const __m256i*)seq);
  const __m256i lo = _mm256_and_si256(c, _mm256_set1_epi8(0x0F));
  __m256i ok = _mm256_cmpeq_epi8(_mm256_and_si256(c, _mm256_set1_epi8((char)0xDF)),
                                 _mm256_shuffle_epi8(letters, lo));
  if (qual) {  // qual >= mq, unsigned
    const __m256i q = _mm256_loadu_si256((const __m256i*)qual);
    ok = _mm256_and_si256(ok, _mm256_cmpeq_epi8(_mm256_max_epu8(q, floor), q));
  }
  _mm256_storeu_si256((__m256i*)dst, _mm256_blendv_epi8(_mm256_set1_epi8(CODE_INVALID),
                                                        _mm256_shuffle_epi8(codes, lo), ok));
}
#endif

void encode(const uint8_t* seq, const uint8_t* qual, uint8_t mq, int64_t L, uint8_t* dst) {
#if defined(__AVX2__)
  const __m256i floor = _mm256_set1_epi8((char)mq);
  int64_t j = 0;
  for (; j + 32 <= L; j += 32) encode32(seq + j, qual ? qual + j : nullptr, floor, dst + j);
  if (j < L) {
    uint8_t s[32] = {0}, q[32] = {0}, d[32];
    memcpy(s, seq + j, L - j);
    if (qual) memcpy(q, qual + j, L - j);
    encode32(s, qual ? q : nullptr, floor, d);
    memcpy(dst + j, d, L - j);
  }
#else
  if (qual) {
    for (int64_t j = 0; j < L; ++j) {
      const uint8_t low = -uint8_t(qual[j] < mq);  // 0xFF below mq, else 0
      dst[j] = (kCodes.t[seq[j]] & ~low) | (CODE_INVALID & low);
    }
  } else {
    for (int64_t j = 0; j < L; ++j) dst[j] = kCodes.t[seq[j]];
  }
#endif
}

enum State : uint8_t {
  S_START,      // expecting '>' or '@' (format auto-detect)
  S_FA_HEADER,  // FASTA: inside a header line
  S_FA_SEQ,     // FASTA: sequence lines until next '>'
  S_FQ_HEADER,  // FASTQ: inside '@' header line
  S_FQ_SEQ,     // FASTQ: sequence line(s) until '+'
  S_FQ_PLUS,    // FASTQ: inside '+' line
  S_FQ_QUAL,    // FASTQ: quality bytes (counted against seq length)
  S_FQ_EOL,     // FASTQ: skip to end of quality line, then header follows
};

// What the line-at-a-time FASTQ path makes of the bytes at a record's start.
enum Fq { FQ_DONE, FQ_SHORT, FQ_OTHER };

}  // namespace

extern "C" {

struct JtHostParser {
  // the state machine's own fields (jt_fastx.cc's JtParser)
  State state;
  uint8_t min_qual;  // 0 = no quality masking
  int emitted_any;
  int need_sep;
  int64_t seq_len;
  int64_t qual_seen;
  uint8_t* rec;  // codes of the FASTQ record the state machine is inside
  int64_t rec_len;
  int64_t rec_cap;
  // raw bytes of a FASTQ record that began in S_FQ_HEADER and is not yet
  // whole; non-empty only in S_FQ_HEADER
  uint8_t* carry;
  int64_t carry_len;
  int64_t carry_cap;
  int64_t general_bytes;  // bytes the state machine has read, in all
};

JtHostParser* jt_host_parser_new(uint8_t min_qual) {
  JtHostParser* p = (JtHostParser*)calloc(1, sizeof(JtHostParser));
  p->state = S_START;
  p->min_qual = min_qual;
  return p;
}

void jt_host_parser_free(JtHostParser* p) {
  if (p) {
    free(p->rec);
    free(p->carry);
    free(p);
  }
}

// Upper bound of the codes held back from earlier feeds (the caller adds it
// to its output capacity).
int64_t jt_host_parser_pending(JtHostParser* p) { return p->rec_len + p->carry_len; }

int64_t jt_host_parser_general_bytes(JtHostParser* p) { return p->general_bytes; }

}  // extern "C"

namespace {

void rec_push(JtHostParser* p, uint8_t code) {
  if (p->rec_len == p->rec_cap) {
    p->rec_cap = p->rec_cap ? p->rec_cap * 2 : 4096;
    p->rec = (uint8_t*)realloc(p->rec, p->rec_cap);
  }
  p->rec[p->rec_len++] = code;
}

// jt_fastx.cc's state machine over one byte -> codes written.
inline int64_t step(JtHostParser* p, uint8_t c, uint8_t* out, int64_t w) {
  switch (p->state) {
    case S_START:
      if (c == '>') {
        p->state = S_FA_HEADER;
      } else if (c == '@') {
        p->state = S_FQ_HEADER;
      }
      break;
    case S_FA_HEADER:
      if (c == '\n') p->state = S_FA_SEQ;
      break;
    case S_FA_SEQ:
      if (c == '>') {
        p->state = S_FA_HEADER;
        p->need_sep = 1;
      } else if (c != '\n' && c != '\r') {
        if (p->need_sep && p->emitted_any) out[w++] = CODE_N;
        p->need_sep = 0;
        out[w++] = kCodes.t[c];
        p->emitted_any = 1;
      }
      break;
    case S_FQ_HEADER:
      if (c == '\n') {
        p->state = S_FQ_SEQ;
        p->seq_len = 0;
        p->qual_seen = 0;
        p->rec_len = 0;
      }
      break;
    case S_FQ_SEQ:
      if (c == '+' && p->seq_len > 0) {
        p->state = S_FQ_PLUS;
      } else if (c != '\n' && c != '\r') {
        rec_push(p, kCodes.t[c]);
        p->seq_len++;
      }
      break;
    case S_FQ_PLUS:
      if (c == '\n') p->state = S_FQ_QUAL;
      break;
    case S_FQ_QUAL:
      if (c != '\n' && c != '\r') {
        if (p->min_qual && c < p->min_qual && p->qual_seen < p->rec_len)
          p->rec[p->qual_seen] = CODE_INVALID;
        p->qual_seen++;
        if (p->qual_seen == p->seq_len) {
          if (p->emitted_any) out[w++] = CODE_N;
          memcpy(out + w, p->rec, p->rec_len);
          w += p->rec_len;
          p->emitted_any = 1;
          p->rec_len = 0;
          p->state = S_FQ_EOL;
        }
      }
      break;
    case S_FQ_EOL:
      if (c == '\n') p->state = S_FQ_HEADER;
      break;
  }
  return w;
}

// The state machine over b[i, end) -> codes written.
int64_t general(JtHostParser* p, const uint8_t* b, int64_t i, int64_t end, uint8_t* out,
                int64_t w) {
  p->general_bytes += end - i;
  for (; i < end; ++i) w = step(p, b[i], out, w);
  return w;
}

// The state machine from b[i] until it reaches a state the line-at-a-time
// path takes up (a FASTQ record's end, or the format found) -> new i.
int64_t general_to_line(JtHostParser* p, const uint8_t* b, int64_t i, int64_t n,
                        uint8_t* out, int64_t* w) {
  const int64_t i0 = i;
  const bool from_header = p->state == S_FQ_HEADER;
  while (i < n) {
    *w = step(p, b[i++], out, *w);
    const State s = p->state;
    if (s == S_FQ_EOL || s == S_FA_HEADER || s == S_FA_SEQ ||
        (s == S_FQ_HEADER && !from_header))
      break;
  }
  p->general_bytes += i - i0;
  return i;
}

const uint8_t* find(const uint8_t* b, int64_t from, int64_t to, int c) {
  return from < to ? (const uint8_t*)memchr(b + from, c, to - from) : nullptr;
}

// Whether b[from, from + len) holds c or d.
bool holds(const uint8_t* b, int64_t from, int64_t len, int c, int d) {
  return find(b, from, from + len, c) || find(b, from, from + len, d);
}

// One FASTQ record at b[0, len), in S_FQ_HEADER. FQ_DONE: the record is
// emitted into out at *w and *used bytes are consumed (through its quality
// line's end, or all of b with the state S_FQ_EOL). FQ_SHORT: b is a prefix
// of such a record, nothing emitted; *need is the least count of further
// bytes it takes, or 0 for "through the next line end". FQ_OTHER: the state
// machine must read the record.
Fq fq_record(JtHostParser* p, const uint8_t* b, int64_t len, uint8_t* out, int64_t* w,
             int64_t* used, int64_t* need) {
  *need = 0;
  const uint8_t* h = find(b, 0, len, '\n');
  if (!h) return FQ_SHORT;
  const int64_t s = h - b + 1;
  const uint8_t* e1 = find(b, s, len, '\n');
  if (!e1) return FQ_SHORT;
  int64_t L = e1 - b - s;
  if (L > 0 && b[s + L - 1] == '\r') --L;
  if (L == 0 || holds(b, s, L, '+', '\r')) return FQ_OTHER;
  const int64_t pl = e1 - b + 1;
  if (pl == len) return FQ_SHORT;
  if (b[pl] != '+') return FQ_OTHER;
  const uint8_t* e2 = find(b, pl, len, '\n');
  if (!e2) return FQ_SHORT;
  const int64_t q = e2 - b + 1;
  const int64_t avail = L < len - q ? L : len - q;
  if (holds(b, q, avail, '\n', '\r')) return FQ_OTHER;
  if (avail < L) {
    *need = L - avail;
    return FQ_SHORT;
  }
  int64_t o = *w;
  if (p->emitted_any) out[o++] = CODE_N;
  encode(b + s, p->min_qual ? b + q : nullptr, p->min_qual, L, out + o);
  *w = o + L;
  p->emitted_any = 1;
  const uint8_t* e3 = find(b, q + L, len, '\n');
  if (e3) {
    *used = e3 - b + 1;
    p->state = S_FQ_HEADER;
  } else {
    *used = len;
    p->state = S_FQ_EOL;
  }
  return FQ_DONE;
}

void carry_append(JtHostParser* p, const uint8_t* b, int64_t n) {
  if (p->carry_len + n > p->carry_cap) {
    int64_t cap = p->carry_cap ? p->carry_cap : 4096;
    while (cap < p->carry_len + n) cap *= 2;
    p->carry = (uint8_t*)realloc(p->carry, cap);
    p->carry_cap = cap;
  }
  memcpy(p->carry + p->carry_len, b, n);
  p->carry_len += n;
}

// The carried record, completed from data: the bytes it needs are taken from
// data until it is whole or is known to be no line-at-a-time record -> the
// bytes of data taken (n with the carry kept when data runs out first).
int64_t finish_carry(JtHostParser* p, const uint8_t* data, int64_t n, uint8_t* out,
                     int64_t* w) {
  int64_t i = 0;
  for (;;) {
    int64_t used, need;
    const Fq r = fq_record(p, p->carry, p->carry_len, out, w, &used, &need);
    if (r == FQ_DONE) {
      p->carry_len = 0;  // whole: taken through its last quality byte
      return i;
    }
    if (r == FQ_OTHER || p->carry_len > CARRY_MAX) {
      // the state machine emitted nothing for the carried prefix in the
      // feeds it came in; it reads it now, from S_FQ_HEADER
      const int64_t len = p->carry_len;
      p->carry_len = 0;
      *w = general(p, p->carry, 0, len, out, *w);
      return i;
    }
    if (i == n) return n;
    int64_t take;
    if (need > 0) {
      take = need < n - i ? need : n - i;
    } else {
      const uint8_t* nl = find(data, i, n, '\n');
      take = nl ? nl - data - i + 1 : n - i;
    }
    carry_append(p, data + i, take);
    i += take;
  }
}

// One FASTA sequence line (or its part up to the block's end) from b[i]
// -> new i.
int64_t fa_line(JtHostParser* p, const uint8_t* b, int64_t i, int64_t n, uint8_t* out,
                int64_t* w) {
  if (b[i] == '>') {
    p->state = S_FA_HEADER;
    p->need_sep = 1;
    return i + 1;
  }
  const uint8_t* e = find(b, i, n, '\n');
  const int64_t end = e ? e - b : n;
  int64_t L = end - i;
  if (L > 0 && b[i + L - 1] == '\r') --L;
  if (holds(b, i, L, '>', '\r')) {
    *w = general(p, b, i, e ? end + 1 : n, out, *w);
    return e ? end + 1 : n;
  }
  if (L > 0) {
    int64_t o = *w;
    if (p->need_sep && p->emitted_any) out[o++] = CODE_N;
    p->need_sep = 0;
    encode(b + i, nullptr, 0, L, out + o);
    *w = o + L;
    p->emitted_any = 1;
  }
  return e ? end + 1 : n;
}

// Skip to the end of the line from b[i], then enter ``next`` -> new i.
int64_t skip_line(JtHostParser* p, const uint8_t* b, int64_t i, int64_t n, State next) {
  const uint8_t* e = find(b, i, n, '\n');
  if (!e) return n;
  p->state = next;
  return e - b + 1;
}

}  // namespace

extern "C" {

// Feed n input bytes; emit codes into out, whose capacity out_cap must be at
// least n + 1 + jt_host_parser_pending(p). Returns the number of codes
// written, or -1 if out_cap is too small.
int64_t jt_host_parser_feed(JtHostParser* p, const uint8_t* data, int64_t n, uint8_t* out,
                            int64_t out_cap) {
  if (out_cap < n + 1 + jt_host_parser_pending(p)) return -1;
  int64_t w = 0;
  int64_t i = p->carry_len ? finish_carry(p, data, n, out, &w) : 0;
  while (i < n) {
    switch (p->state) {
      case S_FQ_HEADER: {
        int64_t used, need;
        const Fq r = fq_record(p, data + i, n - i, out, &w, &used, &need);
        if (r == FQ_DONE) {
          i += used;
        } else if (r == FQ_SHORT) {
          carry_append(p, data + i, n - i);
          i = n;
        } else {
          i = general_to_line(p, data, i, n, out, &w);
        }
        break;
      }
      case S_FQ_EOL:
        i = skip_line(p, data, i, n, S_FQ_HEADER);
        break;
      case S_FA_HEADER:
        i = skip_line(p, data, i, n, S_FA_SEQ);
        break;
      case S_FA_SEQ:
        i = fa_line(p, data, i, n, out, &w);
        break;
      case S_START:
        if (data[i] == '@' || data[i] == '>') {  // a file's first byte, as it should be
          p->state = data[i++] == '@' ? S_FQ_HEADER : S_FA_HEADER;
        } else {
          i = general_to_line(p, data, i, n, out, &w);
        }
        break;
      default:  // inside a record the state machine reads
        i = general_to_line(p, data, i, n, out, &w);
        break;
    }
  }
  return w;
}

}  // extern "C"
