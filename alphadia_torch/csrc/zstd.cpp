// Decoder of zstd frames (RFC 8878), for the frames of Bruker TDF files.
//
// Host C++17 with a plain C interface (loaded with ctypes by
// rawdata/zstd.py). It decodes what the format allows: raw, RLE and
// compressed blocks; literals raw, RLE, Huffman-coded (one or four streams,
// weights direct or FSE-coded) and treeless; sequences with predefined, RLE,
// FSE-coded and repeated tables; the three repeat offsets; skippable frames;
// several frames one after another; the xxh64 content checksum. A frame with
// a dictionary ID other than 0 is refused.
//
// Every read of the input and every write of the output is checked against
// its bounds: malformed input gives an error code and a message, never a
// read or a write outside the caller's buffers.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <memory>
#include <new>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* what) { throw Corrupt(what); }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

inline uint64_t le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

// ---------------------------------------------------------------------------
// xxh64
// ---------------------------------------------------------------------------
constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL, P3 = 0x165667B19E3779F9ULL,
                   P4 = 0x85EBCA77C2B2AE63ULL, P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }  // little-endian host
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---------------------------------------------------------------------------
// bit readers
// ---------------------------------------------------------------------------
// Forward, little-endian bit order (FSE table descriptions). Bits past the
// end read as zero; ``bytes()`` is checked against the size by the caller.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  FwdBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int k) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ULL << k) - 1));
  }
  uint32_t read(int k) { uint32_t v = peek(k); pos += k; return v; }
  size_t bytes() const { return (pos + 7) >> 3; }
};

// Backward (the FSE and Huffman streams): the last byte's highest set bit
// ends the stream; values are read from the end toward the start, first
// bits read most significant. ``pos`` counts the bits left; bits before the
// start read as zero and drive ``pos`` below 0 (an overflow).
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t n = 0;
  int64_t pos = 0;
  void init(const uint8_t* p_, size_t n_) {
    p = p_;
    n = int64_t(n_);
    if (n_ == 0) fail("empty bitstream");
    uint8_t last = p[n_ - 1];
    if (last == 0) fail("bitstream has no end mark");
    pos = (n - 1) * 8 + highbit(last);
  }
  inline uint64_t load(int64_t byte) const {  // 8 bytes from ``byte``, zero past the end
    if (byte + 8 <= n) return rd64(p + byte);
    uint64_t v = 0;
    for (int64_t i = byte; i < n; ++i) v |= uint64_t(p[i]) << (8 * (i - byte));
    return v;
  }
  inline uint64_t bits(int64_t start, int k) const {  // bits [start, start + k), k <= 56
    if (start >= 0) return (load(start >> 3) >> (start & 7)) & ((1ULL << k) - 1);
    int64_t valid = start + k;
    if (valid <= 0) return 0;
    return (load(0) & ((1ULL << valid) - 1)) << (-start);
  }
  inline uint64_t read(int k) {
    if (k == 0) return 0;
    pos -= k;
    return bits(pos, k);
  }
  inline uint64_t peek(int k) const { return bits(pos - k, k); }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------
struct FseCell {
  uint16_t sym;
  uint8_t nb;
  uint16_t base;
};

struct FseTable {
  int al = -1;  // accuracy log; -1: no table yet
  FseCell cell[512];
};

// Reads a normalised distribution (RFC 8878 4.1.1); returns the bytes used.
size_t read_ncount(const uint8_t* p, size_t n, int16_t* norm, int max_sym, int max_al, int* al_out, int* nsym_out) {
  FwdBits br(p, n);
  int al = int(br.read(4)) + 5;
  if (al > max_al) fail("FSE accuracy log too large");
  int remaining = (1 << al) + 1, threshold = 1 << al, nb = al + 1, sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = br.read(2);
        n0 += int(r);
        if (r != 3) break;
        if (n0 > max_sym) fail("FSE distribution has too many symbols");
      }
      if (n0 > max_sym) fail("FSE distribution has too many symbols");
      while (sym < n0) norm[sym++] = 0;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nb - 1);
    if (int(low) < max) {
      count = int(low);
      br.pos += nb - 1;
    } else {
      count = int(br.peek(nb));
      if (count >= threshold) count -= max;
      br.pos += nb;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    if (remaining < 1) fail("FSE distribution overflows its table");
    while (remaining < threshold) {
      nb--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail("FSE distribution does not fill its table");
  if (br.bytes() > n) fail("FSE table description overruns its section");
  *al_out = al;
  *nsym_out = sym;
  return br.bytes();
}

void build_fse(const int16_t* norm, int nsym, int al, FseTable& t) {
  const int size = 1 << al;
  int high = size - 1;
  uint32_t next[256];
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.cell[high--].sym = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cell[pos].sym = uint16_t(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table spread does not close");
  for (int u = 0; u < size; ++u) {
    uint32_t x = next[t.cell[u].sym]++;
    int nbits = al - highbit(x);
    t.cell[u].nb = uint8_t(nbits);
    t.cell[u].base = uint16_t((x << nbits) - uint32_t(size));
  }
  t.al = al;
}

void rle_fse(uint8_t sym, FseTable& t) {
  t.cell[0] = FseCell{sym, 0, 0};
  t.al = 0;
}

// the predefined distributions of the sequence codes (RFC 8878 3.1.1.3.2.2)
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,    15,    16,    18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr int MAX_LL = 35, MAX_ML = 52, MAX_OF = 31;
constexpr size_t BLOCK_MAX = 128 * 1024;

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------
struct HufCell {
  uint8_t sym;
  uint8_t nb;
};

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  HufCell cell[1 << 11];
};

// the Huffman tree description (RFC 8878 4.2.1); returns the bytes used
size_t read_huffman(const uint8_t* p, size_t n, HufTable& t) {
  if (n < 1) fail("Huffman tree description truncated");
  uint8_t weight[256];
  int nw = 0;
  const uint8_t header = p[0];
  size_t used;
  if (header >= 128) {
    nw = header - 127;
    used = 1 + size_t((nw + 1) / 2);
    if (used > n) fail("Huffman weights truncated");
    for (int i = 0; i < nw; ++i) weight[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
  } else {
    used = 1 + size_t(header);
    if (used > n || header == 0) fail("Huffman weights truncated");
    int16_t norm[256] = {0};
    int al, nsym;
    size_t k = read_ncount(p + 1, header, norm, 12, 6, &al, &nsym);
    FseTable fse;
    build_fse(norm, nsym, al, fse);
    if (k >= header) fail("Huffman weights stream is empty");
    BackBits bs;
    bs.init(p + 1 + k, header - k);
    uint32_t s1 = uint32_t(bs.read(al)), s2 = uint32_t(bs.read(al));
    if (bs.pos < 0) fail("Huffman weights stream truncated");
    auto put = [&](uint32_t state) {
      if (nw >= 255) fail("too many Huffman weights");
      weight[nw++] = uint8_t(fse.cell[state].sym);
    };
    // two states take turns; the stream ends when an update reads past its start
    for (;;) {
      put(s1);
      s1 = fse.cell[s1].base + uint32_t(bs.read(fse.cell[s1].nb));
      if (bs.pos < 0) {
        put(s2);
        break;
      }
      put(s2);
      s2 = fse.cell[s2].base + uint32_t(bs.read(fse.cell[s2].nb));
      if (bs.pos < 0) {
        put(s1);
        break;
      }
    }
  }
  if (nw > 255) fail("too many Huffman weights");
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weight[i] > 11) fail("Huffman weight too large");
    if (weight[i]) total += 1u << (weight[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  const int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("Huffman code too long");
  const uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights do not close the tree");
  weight[nw++] = uint8_t(highbit(rest) + 1);
  int pos = 0;
  for (int w = 1; w <= max_bits; ++w) {
    for (int s = 0; s < nw; ++s) {
      if (weight[s] != w) continue;
      const int len = 1 << (w - 1), nb = max_bits + 1 - w;
      for (int i = 0; i < len; ++i) t.cell[pos + i] = HufCell{uint8_t(s), uint8_t(nb)};
      pos += len;
    }
  }
  t.max_bits = max_bits;
  return used;
}

void huffman_stream(const HufTable& t, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackBits bs;
  bs.init(p, n);
  const int mb = t.max_bits;
  for (size_t i = 0; i < count; ++i) {
    const HufCell c = t.cell[bs.peek(mb)];
    out[i] = c.sym;
    bs.pos -= c.nb;
  }
  if (bs.pos != 0) fail("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------------------
// frames
// ---------------------------------------------------------------------------
// Output of one input item: a fixed buffer, or a growing one.
struct Out {
  uint8_t* base = nullptr;
  size_t pos = 0, cap = 0;
  std::vector<uint8_t>* grow = nullptr;
  void need(size_t k) {
    if (k <= cap - pos) return;
    if (!grow) fail("decoded content larger than expected");
    size_t want = std::max(pos + k, 2 * cap + 4096);
    grow->resize(want);
    base = grow->data();
    cap = want;
  }
};

struct Decoder {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3];
  uint64_t window = 0;
  std::vector<uint8_t> lit = std::vector<uint8_t>(BLOCK_MAX + 8);

  // the FSE table of one sequence code by its mode; returns the bytes used
  size_t seq_table(int mode, const uint8_t* p, size_t n, FseTable& t, const int16_t* dflt, int ndflt, int max_sym,
                   int max_al) {
    switch (mode) {
      case 0:
        build_fse(dflt, ndflt, max_sym == MAX_OF ? 5 : 6, t);
        return 0;
      case 1:
        if (n < 1) fail("sequence table truncated");
        if (p[0] > max_sym) fail("RLE sequence code out of range");
        rle_fse(p[0], t);
        return 1;
      case 2: {
        int16_t norm[64] = {0};
        int al, nsym;
        size_t k = read_ncount(p, n, norm, max_sym, max_al, &al, &nsym);
        build_fse(norm, nsym, al, t);
        return k;
      }
      default:
        if (t.al < 0) fail("repeated sequence table without a previous one");
        return 0;
    }
  }

  size_t literals(const uint8_t* p, size_t n, size_t* lit_size) {
    if (n < 1) fail("literals section truncated");
    const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {  // raw, RLE
      size_t hs, size;
      if ((sf & 1) == 0) {
        hs = 1;
        size = p[0] >> 3;
      } else if (sf == 1) {
        hs = 2;
        if (n < 2) fail("literals header truncated");
        size = (p[0] >> 4) + (size_t(p[1]) << 4);
      } else {
        hs = 3;
        if (n < 3) fail("literals header truncated");
        size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      }
      if (size > BLOCK_MAX) fail("literals larger than a block");
      if (type == 0) {
        if (hs + size > n) fail("raw literals truncated");
        std::memcpy(lit.data(), p + hs, size);
        *lit_size = size;
        return hs + size;
      }
      if (hs + 1 > n) fail("RLE literals truncated");
      std::memset(lit.data(), p[hs], size);
      *lit_size = size;
      return hs + 1;
    }
    size_t hs, regen, comp;
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      hs = 3;
      if (n < 3) fail("literals header truncated");
      uint64_t v = le(p, 3);
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
    } else if (sf == 2) {
      hs = 4;
      if (n < 4) fail("literals header truncated");
      uint64_t v = le(p, 4);
      regen = (v >> 4) & 0x3FFF;
      comp = (v >> 18) & 0x3FFF;
    } else {
      hs = 5;
      if (n < 5) fail("literals header truncated");
      uint64_t v = le(p, 5);
      regen = (v >> 4) & 0x3FFFF;
      comp = (v >> 22) & 0x3FFFF;
    }
    if (regen > BLOCK_MAX) fail("literals larger than a block");
    if (hs + comp > n) fail("compressed literals truncated");
    const uint8_t* q = p + hs;
    size_t qn = comp;
    if (type == 2) {
      size_t k = read_huffman(q, qn, huf);
      q += k;
      qn -= k;
    } else if (huf.max_bits == 0) {
      fail("treeless literals without a previous Huffman table");
    }
    if (streams == 1) {
      huffman_stream(huf, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("Huffman jump table truncated");
      size_t s1 = le(q, 2), s2 = le(q + 2, 2), s3 = le(q + 4, 2);
      if (6 + s1 + s2 + s3 > qn) fail("Huffman streams overrun the literals");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("too few literals for four streams");
      const uint8_t* r = q + 6;
      huffman_stream(huf, r, s1, lit.data(), seg);
      huffman_stream(huf, r + s1, s2, lit.data() + seg, seg);
      huffman_stream(huf, r + s1 + s2, s3, lit.data() + 2 * seg, seg);
      huffman_stream(huf, r + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
    }
    *lit_size = regen;
    return hs + comp;
  }

  void compressed_block(const uint8_t* p, size_t n, Out& out, size_t frame_start) {
    size_t lit_size = 0;
    size_t k = literals(p, n, &lit_size);
    p += k;
    n -= k;
    if (n < 1) fail("sequences section truncated");
    size_t nseq = p[0], hs = 1;
    if (nseq >= 128) {
      if (nseq < 255) {
        if (n < 2) fail("sequences header truncated");
        nseq = ((nseq - 128) << 8) + p[1];
        hs = 2;
      } else {
        if (n < 3) fail("sequences header truncated");
        nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
        hs = 3;
      }
    }
    const size_t block_start = out.pos;
    if (nseq == 0) {
      if (hs != n) fail("bytes after an empty sequences section");
      out.need(lit_size);
      std::memcpy(out.base + out.pos, lit.data(), lit_size);
      out.pos += lit_size;
      return;
    }
    if (hs >= n) fail("sequences header truncated");
    const uint8_t modes = p[hs];
    if (modes & 3) fail("reserved bits of the sequence modes are set");
    p += hs + 1;
    n -= hs + 1;
    k = seq_table(modes >> 6, p, n, ll, LL_DEFAULT, 36, MAX_LL, 9);
    p += k;
    n -= k;
    k = seq_table((modes >> 4) & 3, p, n, of, OF_DEFAULT, 29, MAX_OF, 8);
    p += k;
    n -= k;
    k = seq_table((modes >> 2) & 3, p, n, ml, ML_DEFAULT, 53, MAX_ML, 9);
    p += k;
    n -= k;

    BackBits bs;
    bs.init(p, n);
    uint32_t sl = uint32_t(bs.read(ll.al)), so = uint32_t(bs.read(of.al)), sm = uint32_t(bs.read(ml.al));
    size_t lit_pos = 0;
    for (size_t i = 0; i < nseq; ++i) {
      const int oc = of.cell[so].sym, mc = ml.cell[sm].sym, lc = ll.cell[sl].sym;
      if (oc > MAX_OF || mc > MAX_ML || lc > MAX_LL) fail("sequence code out of range");
      const uint64_t ofv = (uint64_t(1) << oc) + bs.read(oc);
      const size_t mlen = ML_BASE[mc] + bs.read(ML_BITS[mc]);
      const size_t llen = LL_BASE[lc] + bs.read(LL_BITS[lc]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = uint32_t(offset);
      } else {
        const int idx = int(ofv) - 1 + (llen == 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? uint64_t(rep[0]) - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = uint32_t(offset);
        }
      }
      if (i + 1 < nseq) {
        sl = ll.cell[sl].base + uint32_t(bs.read(ll.cell[sl].nb));
        sm = ml.cell[sm].base + uint32_t(bs.read(ml.cell[sm].nb));
        so = of.cell[so].base + uint32_t(bs.read(of.cell[so].nb));
      }
      if (bs.pos < 0) fail("sequences bitstream overrun");
      // execute: literals, then the match
      if (llen > lit_size - lit_pos) fail("sequence takes more literals than the block has");
      if (out.pos - block_start + llen + mlen > BLOCK_MAX) fail("block decodes to more than 128 KiB");
      out.need(llen + mlen);
      std::memcpy(out.base + out.pos, lit.data() + lit_pos, llen);
      out.pos += llen;
      lit_pos += llen;
      if (offset == 0 || offset > out.pos - frame_start) fail("match offset before the start of the output");
      if (offset > window) fail("match offset beyond the window");
      uint8_t* dst = out.base + out.pos;
      const uint8_t* src = dst - offset;
      if (offset >= mlen) {
        std::memcpy(dst, src, mlen);
      } else {
        for (size_t j = 0; j < mlen; ++j) dst[j] = src[j];
      }
      out.pos += mlen;
    }
    if (bs.pos != 0) fail("sequences bitstream not consumed exactly");
    const size_t rest = lit_size - lit_pos;
    if (out.pos - block_start + rest > BLOCK_MAX) fail("block decodes to more than 128 KiB");
    out.need(rest);
    std::memcpy(out.base + out.pos, lit.data() + lit_pos, rest);
    out.pos += rest;
  }

  // one frame at ``p`` (zstd or skippable); returns the bytes used
  size_t frame(const uint8_t* p, size_t n, Out& out) {
    if (n < 4) fail("frame truncated before its magic number");
    const uint32_t magic = rd32(p);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n < 8) fail("skippable frame truncated");
      const uint64_t size = rd32(p + 4);
      if (size > n - 8) fail("skippable frame truncated");
      return 8 + size_t(size);
    }
    if (magic != 0xFD2FB528u) fail("not a zstd frame (wrong magic number)");
    if (n < 5) fail("frame header truncated");
    const uint8_t fhd = p[4];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit of the frame header is set");
    const int did_size = did_flag == 3 ? 4 : did_flag;
    const int fcs_size = fcs_flag == 0 ? single : (1 << fcs_flag);
    const size_t hs = 5 + (single ? 0 : 1) + did_size + fcs_size;
    if (hs > n) fail("frame header truncated");
    size_t q = 5;
    if (!single) {
      const uint8_t wd = p[q++];
      const int exponent = wd >> 3, mantissa = wd & 7;
      const uint64_t base = uint64_t(1) << (10 + exponent);
      window = base + (base / 8) * mantissa;
    }
    if (did_size && le(p + q, did_size) != 0) fail("frames with a dictionary are not supported");
    q += did_size;
    int64_t fcs = -1;
    if (fcs_size) {
      fcs = int64_t(le(p + q, fcs_size)) + (fcs_size == 2 ? 256 : 0);
      if (fcs < 0) fail("frame content size out of range");
    }
    q += fcs_size;
    if (single) window = uint64_t(fcs);
    const size_t frame_start = out.pos;
    if (fcs >= 0) out.need(size_t(std::min<int64_t>(fcs, int64_t(1) << 20)));  // grows past 1 MiB as it decodes
    const size_t block_max = size_t(std::min<uint64_t>(window, BLOCK_MAX));
    // a new frame starts with fresh tables and repeat offsets
    huf.max_bits = 0;
    ll.al = of.al = ml.al = -1;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
    for (;;) {
      if (q + 3 > n) fail("block header truncated");
      const uint32_t bh = uint32_t(le(p + q, 3));
      q += 3;
      const int last = bh & 1, type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) fail("reserved block type");
      if (size > block_max) fail("block larger than the frame allows");
      if (type == 0) {
        if (size > n - q) fail("raw block truncated");
        out.need(size);
        std::memcpy(out.base + out.pos, p + q, size);
        out.pos += size;
        q += size;
      } else if (type == 1) {
        if (q + 1 > n) fail("RLE block truncated");
        out.need(size);
        std::memset(out.base + out.pos, p[q], size);
        out.pos += size;
        q += 1;
      } else {
        if (size > n - q) fail("compressed block truncated");
        if (size == 0) fail("empty compressed block");
        compressed_block(p + q, size, out, frame_start);
        q += size;
      }
      if (fcs >= 0 && out.pos - frame_start > size_t(fcs)) fail("frame decodes to more than its content size");
      if (last) break;
    }
    if (fcs >= 0 && out.pos - frame_start != size_t(fcs)) fail("frame decodes to less than its content size");
    if (checksum) {
      if (q + 4 > n) fail("content checksum truncated");
      const uint32_t want = rd32(p + q);
      const uint32_t got = uint32_t(xxh64(out.base + frame_start, out.pos - frame_start, 0));
      if (want != got) fail("content checksum mismatch");
      q += 4;
    }
    return q;
  }

  // every frame of one input, one after another
  void item(const uint8_t* p, size_t n, Out& out) {
    if (n == 0) fail("empty input");
    size_t q = 0;
    while (q < n) q += frame(p + q, n - q, out);
  }
};

void set_error(char* err, int64_t cap, const char* msg) {
  if (err && cap > 0) std::snprintf(err, size_t(cap), "%s", msg);
}

}  // namespace

extern "C" {

// Decodes ``n`` items: item i is the frames at ``src[src_off[i], +src_len[i])``,
// decoded to exactly ``dst_len[i]`` bytes at ``dst + dst_off[i]``, on
// ``threads`` threads (the output does not depend on their count). Returns 0,
// or 1 with the message of the first item that failed in ``err`` and its index
// in ``err_item``.
int zstd_decode_batch(const uint8_t* src, int64_t src_size, const int64_t* src_off, const int64_t* src_len,
                      uint8_t* dst, int64_t dst_size, const int64_t* dst_off, const int64_t* dst_len, int64_t n,
                      int threads, char* err, int64_t err_cap, int64_t* err_item) {
  std::vector<std::string> errors;
  std::atomic<int64_t> first_bad{n};
  try {
    for (int64_t i = 0; i < n; ++i) {
      if (src_off[i] < 0 || src_len[i] < 0 || src_off[i] > src_size || src_len[i] > src_size - src_off[i] ||
          dst_off[i] < 0 || dst_len[i] < 0 || dst_off[i] > dst_size || dst_len[i] > dst_size - dst_off[i]) {
        set_error(err, err_cap, "item outside its buffers");
        *err_item = i;
        return 1;
      }
    }
    errors.resize(size_t(n));
    const int nt = std::max(1, std::min<int>(threads, int(std::min<int64_t>(n, 256))));
    std::vector<std::unique_ptr<Decoder>> decoders;
    for (int t = 0; t < nt; ++t) decoders.emplace_back(new Decoder());
    std::atomic<int64_t> next{0};
    auto work = [&](Decoder* d) {
      for (int64_t i; (i = next.fetch_add(1)) < n;) {
        if (i > first_bad.load()) break;
        Out out;
        out.base = dst + dst_off[i];
        out.cap = size_t(dst_len[i]);
        try {
          d->item(src + src_off[i], size_t(src_len[i]), out);
          if (out.pos != out.cap) {
            char msg[160];
            std::snprintf(msg, sizeof msg, "decoded %zu bytes, expected %zu", out.pos, out.cap);
            throw Corrupt(msg);
          }
        } catch (const std::exception& e) {
          try {
            errors[size_t(i)] = e.what();
          } catch (...) {  // no memory for the message: the item still fails
          }
          int64_t cur = first_bad.load();
          while (i < cur && !first_bad.compare_exchange_weak(cur, i)) {}
        }
      }
    };
    // a thread that cannot be started leaves its share to the others: the
    // calling thread takes every item that is left, so the pool is always
    // joined and the output does not change
    std::vector<std::thread> pool;
    pool.reserve(size_t(nt - 1));
    for (int t = 1; t < nt; ++t) {
      try {
        pool.emplace_back(work, decoders[size_t(t)].get());
      } catch (const std::exception&) {
        break;
      }
    }
    work(decoders[0].get());
    for (auto& t : pool) t.join();
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    *err_item = -1;
    return 1;
  }
  const int64_t bad = first_bad.load();
  if (bad < n) {
    set_error(err, err_cap, errors[size_t(bad)].c_str());
    *err_item = bad;
    return 1;
  }
  return 0;
}

// Decodes every frame of ``src`` into a buffer this library allocates (free
// it with ``zstd_free``); returns it, or null with the message in ``err``.
uint8_t* zstd_decode_alloc(const uint8_t* src, int64_t n, int64_t* out_size, char* err, int64_t err_cap) {
  try {
    Decoder d;
    std::vector<uint8_t> buf;
    Out out;
    out.grow = &buf;
    d.item(src, size_t(n), out);
    uint8_t* res = static_cast<uint8_t*>(std::malloc(out.pos ? out.pos : 1));
    if (!res) throw std::bad_alloc();
    if (out.pos) std::memcpy(res, out.base, out.pos);
    *out_size = int64_t(out.pos);
    return res;
  } catch (const std::exception& e) {
    set_error(err, err_cap, e.what());
    return nullptr;
  }
}

void zstd_free(uint8_t* p) { std::free(p); }
}
