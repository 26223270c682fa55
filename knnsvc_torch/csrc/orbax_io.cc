// The byte-level codecs of orbax checkpoints, with a plain C interface bound
// by knnsvc_torch/io/zarr2.py and knnsvc_torch/io/ocdbt.py through ctypes:
//
//   - a Zstandard frame decoder written from RFC 8878: raw, RLE and
//     compressed blocks; literals raw, RLE, Huffman-coded in 1 or 4 streams
//     and treeless; Huffman weights given directly or FSE-coded; sequences
//     with predefined, RLE, FSE-coded and repeated tables; the three repeat
//     offsets; the XXH64 content checksum; skippable frames. A frame that
//     names a dictionary is refused. Every read and write is bounds-checked:
//     malformed input gives an error message, never an access out of range.
//   - a Zstandard frame writer that emits raw blocks only (any decoder takes
//     them, and no entropy coder is needed),
//   - CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), which OCDBT puts
//     at the end of every manifest and B-tree node.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& what) : std::runtime_error(what) {}
};

[[noreturn]] void fail(const std::string& what) { throw Corrupt(what); }

// floor(log2(v)) for v > 0, -1 for 0.
int highest_bit(u64 v) {
  int r = -1;
  while (v) {
    v >>= 1;
    ++r;
  }
  return r;
}

u32 le32(const u8* p) { return p[0] | (u32(p[1]) << 8) | (u32(p[2]) << 16) | (u32(p[3]) << 24); }
u64 le64(const u8* p) { return le32(p) | (u64(le32(p + 4)) << 32); }

// ---------------------------------------------------------------------------
// XXH64 (seed 0 for zstd's checksum).

constexpr u64 kP1 = 11400714785074694791ULL, kP2 = 14029467366897019727ULL,
              kP3 = 1609587929392839161ULL, kP4 = 9650029242287828579ULL,
              kP5 = 2870177450012600261ULL;

u64 rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }
u64 xx_round(u64 acc, u64 input) { return rotl(acc + input * kP2, 31) * kP1; }
u64 xx_merge(u64 acc, u64 val) { return (acc ^ xx_round(0, val)) * kP1 + kP4; }

u64 xxh64(const u8* p, i64 n, u64 seed) {
  const u8* end = p + n;
  u64 h;
  if (n >= 32) {
    u64 v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed, v4 = seed - kP1;
    for (; end - p >= 32; p += 32) {
      v1 = xx_round(v1, le64(p));
      v2 = xx_round(v2, le64(p + 8));
      v3 = xx_round(v3, le64(p + 16));
      v4 = xx_round(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xx_merge(h, v1);
    h = xx_merge(h, v2);
    h = xx_merge(h, v3);
    h = xx_merge(h, v4);
  } else {
    h = seed + kP5;
  }
  h += u64(n);
  for (; end - p >= 8; p += 8) h = rotl(h ^ xx_round(0, le64(p)), 27) * kP1 + kP4;
  if (end - p >= 4) {
    h = rotl(h ^ (u64(le32(p)) * kP1), 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * kP5), 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// CRC-32C, eight tables (slicing by 8).

struct Crc32cTables {
  u32 t[8][256];
  Crc32cTables() {
    for (u32 i = 0; i < 256; ++i) {
      u32 c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (u32 i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables kCrc;

u32 crc32c(const u8* p, i64 n) {
  u32 c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    u32 lo = le32(p) ^ c, hi = le32(p + 4);
    c = kCrc.t[7][lo & 0xFF] ^ kCrc.t[6][(lo >> 8) & 0xFF] ^ kCrc.t[5][(lo >> 16) & 0xFF] ^
        kCrc.t[4][lo >> 24] ^ kCrc.t[3][hi & 0xFF] ^ kCrc.t[2][(hi >> 8) & 0xFF] ^
        kCrc.t[1][(hi >> 16) & 0xFF] ^ kCrc.t[0][hi >> 24];
  }
  for (; n > 0; --n, ++p) c = (c >> 8) ^ kCrc.t[0][(c ^ *p) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Input cursor (forward) and backward bit stream.

struct Input {
  const u8* p;
  i64 n;
  i64 pos = 0;
  Input(const u8* data, i64 size) : p(data), n(size) {}
  i64 left() const { return n - pos; }
  const u8* take(i64 k, const char* what) {
    if (k < 0 || k > left()) fail(std::string("truncated input: ") + what);
    const u8* r = p + pos;
    pos += k;
    return r;
  }
  u8 byte(const char* what) { return *take(1, what); }
};

// `nbits` (<= 57) bits of the little-endian stream src[0:len] from bit `at`.
u64 bits_at(const u8* src, i64 len, i64 at, int nbits) {
  if (nbits <= 0) return 0;
  i64 byte = at >> 3;
  int shift = int(at & 7);
  u64 v = 0;
  if (byte + 8 <= len) {
    std::memcpy(&v, src + byte, 8);  // the hosts we build for are little-endian
  } else {
    for (i64 i = 0; byte + i < len && i < 8; ++i) v |= u64(src[byte + i]) << (8 * i);
  }
  v >>= shift;
  return nbits >= 64 ? v : (v & ((u64(1) << nbits) - 1));
}

// A stream read from its end toward its start: its last byte's highest set
// bit marks where the data ends. Reads before the start give zero bits, and
// `off` goes negative, so a caller can check that it consumed the stream
// exactly.
struct BackBits {
  const u8* src;
  i64 len;
  i64 off;
  BackBits(const u8* s, i64 n, const char* what) : src(s), len(n) {
    if (n <= 0) fail(std::string("empty bit stream: ") + what);
    int top = highest_bit(s[n - 1]);
    if (top < 0) fail(std::string("bit stream without its end marker: ") + what);
    off = n * 8 - (8 - top);
  }
  u64 read(int nbits) {
    if (nbits == 0) return 0;
    off -= nbits;
    if (off >= 0) return bits_at(src, len, off, nbits);
    int avail = nbits + int(off > -64 ? off : -64);
    if (avail <= 0) return 0;
    return bits_at(src, len, 0, avail) << (-off);
  }
};

// ---------------------------------------------------------------------------
// FSE tables.

struct FseTable {
  int accuracy = 0;
  std::vector<u8> symbol;
  std::vector<u8> nbits;
  std::vector<u16> base;
};

void fse_build(FseTable* t, const int16_t* norm, int nsym, int accuracy) {
  const u32 size = u32(1) << accuracy;
  t->accuracy = accuracy;
  t->symbol.assign(size, 0);
  t->nbits.assign(size, 0);
  t->base.assign(size, 0);
  std::vector<u16> next(nsym, 0);
  u32 high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {          // "less than 1": one cell at the table's end
      if (high == 0) fail("FSE table: too many low-probability symbols");
      t->symbol[--high] = u8(s);
      next[s] = 1;
    }
  }
  const u32 step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  u32 pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = u16(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t->symbol[pos] = u8(s);
      do pos = (pos + step) & mask; while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE table: probabilities do not fill the table");
  for (u32 i = 0; i < size; ++i) {
    u16 x = next[t->symbol[i]]++;
    int nb = accuracy - highest_bit(x);
    t->nbits[i] = u8(nb);
    t->base[i] = u16((u32(x) << nb) - size);
  }
}

void fse_rle(FseTable* t, u8 sym) {
  t->accuracy = 0;
  t->symbol.assign(1, sym);
  t->nbits.assign(1, 0);
  t->base.assign(1, 0);
}

// Read an FSE table description (RFC 8878 4.1.1) at in.pos; advances past it.
void fse_read(FseTable* t, Input& in, int max_accuracy, int max_symbols) {
  const u8* src = in.p + in.pos;
  const i64 len = in.left();
  if (len < 1) fail("truncated FSE table description");
  i64 off = 0;
  int accuracy = 5 + int(bits_at(src, len, 0, 4));
  off = 4;
  if (accuracy > max_accuracy) fail("FSE accuracy log too large");
  int remaining = 1 << accuracy;
  std::vector<int16_t> norm;
  while (remaining > 0) {
    if (int(norm.size()) >= max_symbols) fail("FSE table: too many symbols");
    int nb = highest_bit(u64(remaining + 1)) + 1;
    u32 val = u32(bits_at(src, len, off, nb));
    const u32 lower_mask = (u32(1) << (nb - 1)) - 1;
    const u32 threshold = (u32(1) << nb) - 1 - u32(remaining + 1);
    if ((val & lower_mask) < threshold) {
      off += nb - 1;
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
      off += nb;
    } else {
      off += nb;
    }
    if ((off + 7) / 8 > len) fail("truncated FSE table description");
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm.push_back(int16_t(proba));
    if (proba == 0) {
      for (;;) {
        int repeat = int(bits_at(src, len, off, 2));
        off += 2;
        if ((off + 7) / 8 > len) fail("truncated FSE table description");
        for (int i = 0; i < repeat; ++i) {
          if (int(norm.size()) >= max_symbols) fail("FSE table: too many symbols");
          norm.push_back(0);
        }
        if (repeat != 3) break;
      }
    }
  }
  if (remaining != 0) fail("FSE table: probabilities overshoot the table");
  in.take((off + 7) / 8, "FSE table description");
  fse_build(t, norm.data(), int(norm.size()), accuracy);
}

struct FseState {
  const FseTable* t;
  u32 state;
  void init(const FseTable* table, BackBits& bits) {
    t = table;
    state = u32(bits.read(table->accuracy));
  }
  u8 peek() const { return t->symbol[state]; }
  void update(BackBits& bits) { state = t->base[state] + u32(bits.read(t->nbits[state])); }
};

// ---------------------------------------------------------------------------
// Huffman tables for literals.

constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<u8> symbol;
  std::vector<u8> nbits;
  bool valid() const { return max_bits > 0; }
};

void huf_build(HufTable* t, const u8* weights, int n) {
  if (n + 1 > 256) fail("Huffman table: too many symbols");
  u64 sum = 0;
  for (int i = 0; i < n; ++i) {
    if (weights[i] > kHufMaxBits) fail("Huffman weight too large");
    sum += weights[i] ? u64(1) << (weights[i] - 1) : 0;
  }
  if (sum == 0) fail("Huffman table: all weights zero");
  const int max_bits = highest_bit(sum) + 1;
  if (max_bits > kHufMaxBits) fail("Huffman table deeper than 11 bits");
  const u64 left = (u64(1) << max_bits) - sum;
  if (left == 0 || (left & (left - 1))) fail("Huffman weights do not complete a tree");
  std::vector<u8> bits(n + 1);
  for (int i = 0; i < n; ++i) bits[i] = weights[i] ? u8(max_bits + 1 - weights[i]) : 0;
  bits[n] = u8(max_bits + 1 - (highest_bit(left) + 1));
  u32 rank_count[kHufMaxBits + 2] = {0};
  for (int i = 0; i <= n; ++i) rank_count[bits[i]]++;
  const u32 size = u32(1) << max_bits;
  t->max_bits = max_bits;
  t->symbol.assign(size, 0);
  t->nbits.assign(size, 0);
  u32 rank_idx[kHufMaxBits + 2];
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (u32(1) << (max_bits - i));
    if (rank_idx[i - 1] > size) fail("Huffman table overflows");
    std::memset(&t->nbits[rank_idx[i]], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != size) fail("Huffman table does not fill its range");
  for (int s = 0; s <= n; ++s) {
    if (!bits[s]) continue;
    u32 code = rank_idx[bits[s]];
    u32 len = u32(1) << (max_bits - bits[s]);
    std::memset(&t->symbol[code], s, len);
    rank_idx[bits[s]] += len;
  }
}

// Huffman tree description (RFC 8878 4.2.1); advances `in` past it.
void huf_read(HufTable* t, Input& in) {
  u8 header = in.byte("Huffman tree description");
  u8 weights[256] = {0};
  int n = 0;
  if (header >= 128) {
    n = header - 127;
    const u8* w = in.take((n + 1) / 2, "Huffman weights");
    for (int i = 0; i < n; ++i) weights[i] = (i % 2 == 0) ? (w[i / 2] >> 4) : (w[i / 2] & 0xF);
  } else {
    Input sub(in.take(header, "FSE-coded Huffman weights"), header);
    FseTable table;
    fse_read(&table, sub, 6, 256);
    BackBits bits(sub.p + sub.pos, sub.left(), "Huffman weights");
    FseState s1, s2;
    s1.init(&table, bits);
    s2.init(&table, bits);
    for (;;) {
      if (n >= 255) fail("too many Huffman weights");
      weights[n++] = s1.peek();
      s1.update(bits);
      if (bits.off < 0) {
        if (n >= 255) fail("too many Huffman weights");
        weights[n++] = s2.peek();
        break;
      }
      if (n >= 255) fail("too many Huffman weights");
      weights[n++] = s2.peek();
      s2.update(bits);
      if (bits.off < 0) {
        if (n >= 255) fail("too many Huffman weights");
        weights[n++] = s1.peek();
        break;
      }
    }
  }
  huf_build(t, weights, n);
}

// Decode one Huffman stream into out[0:count]; the stream must end exactly.
void huf_stream(const HufTable& t, const u8* src, i64 len, u8* out, i64 count) {
  BackBits bits(src, len, "Huffman literals");
  const u32 mask = (u32(1) << t.max_bits) - 1;
  u32 state = u32(bits.read(t.max_bits));
  for (i64 i = 0; i < count; ++i) {
    out[i] = t.symbol[state];
    int nb = t.nbits[state];
    state = ((state << nb) + u32(bits.read(nb))) & mask;
  }
  if (bits.off != -t.max_bits) fail("Huffman stream not consumed exactly");
}

// ---------------------------------------------------------------------------
// Sequence codes (RFC 8878 3.1.1.3.2.1.1).

const u32 kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                         12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                         48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const u8 kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                        1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const u32 kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,
                         17, 18, 19, 20, 21, 22, 23, 24,  25,  26,   27,   28,   29,   30,
                         31, 32, 33, 34, 35, 37, 39, 41,  43,  47,   51,   59,   67,   83,
                         99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const u8 kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                        2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

enum SeqKind { kLL = 0, kOF = 1, kML = 2 };

// ---------------------------------------------------------------------------
// Frame decoder.

struct FrameDecoder {
  u8* dst;
  i64 dst_len;
  i64 frame_start = 0;   // where this frame's output begins in dst
  i64 out = 0;           // bytes written to dst so far
  HufTable huf;
  FseTable seq_tables[3];
  bool seq_valid[3] = {false, false, false};
  u64 rep[3] = {1, 4, 8};
  std::vector<u8> literals;

  bool grow = false;      // dst is malloc'd here and grows up to `limit`
  i64 limit = 0;

  void need_out(i64 k) {
    if (k < 0) fail("negative length");
    if (k <= dst_len - out) return;
    if (!grow || k > limit - out) fail("decoded data larger than the output buffer");
    i64 want = dst_len * 2 > out + k ? dst_len * 2 : out + k;
    if (want > limit) want = limit;
    u8* p = static_cast<u8*>(std::realloc(dst, size_t(want)));
    if (!p) fail("out of memory");
    dst = p;
    dst_len = want;
  }

  void reset_frame() {
    frame_start = out;
    huf = HufTable();
    seq_valid[0] = seq_valid[1] = seq_valid[2] = false;
    rep[0] = 1;
    rep[1] = 4;
    rep[2] = 8;
  }

  // Literals section (RFC 8878 3.1.1.3.1) -> `literals`; advances `in`.
  void read_literals(Input& in) {
    const u8 b0 = in.byte("literals header");
    const int type = b0 & 3, size_format = (b0 >> 2) & 3;
    if (type == 0 || type == 1) {
      i64 regen;
      if ((size_format & 1) == 0) {
        regen = b0 >> 3;
      } else if (size_format == 1) {
        regen = (b0 >> 4) + (i64(in.byte("literals header")) << 4);
      } else {
        const u8* h = in.take(2, "literals header");
        regen = (b0 >> 4) + (i64(h[0]) << 4) + (i64(h[1]) << 12);
      }
      if (regen > (1 << 17)) fail("literals larger than a block");
      if (type == 0) {
        const u8* src = in.take(regen, "raw literals");
        literals.assign(src, src + regen);
      } else {
        literals.assign(size_t(regen), in.byte("RLE literal"));
      }
      return;
    }
    // Huffman-coded (2) or treeless (3)
    i64 regen, comp;
    int streams = size_format == 0 ? 1 : 4;
    if (size_format <= 1) {
      const u8* h = in.take(2, "literals header");
      u32 v = b0 | (u32(h[0]) << 8) | (u32(h[1]) << 16);
      regen = (v >> 4) & 0x3FF;
      comp = (v >> 14) & 0x3FF;
    } else if (size_format == 2) {
      const u8* h = in.take(3, "literals header");
      u32 v = b0 | (u32(h[0]) << 8) | (u32(h[1]) << 16) | (u32(h[2]) << 24);
      regen = (v >> 4) & 0x3FFF;
      comp = (v >> 18) & 0x3FFF;
    } else {
      const u8* h = in.take(4, "literals header");
      u64 v = b0 | (u64(h[0]) << 8) | (u64(h[1]) << 16) | (u64(h[2]) << 24) | (u64(h[3]) << 32);
      regen = i64((v >> 4) & 0x3FFFF);
      comp = i64((v >> 22) & 0x3FFFF);
    }
    if (regen > (1 << 17)) fail("literals larger than a block");
    Input sub(in.take(comp, "compressed literals"), comp);
    if (type == 2) {
      huf_read(&huf, sub);
    } else if (!huf.valid()) {
      fail("treeless literals without an earlier Huffman table");
    }
    literals.assign(size_t(regen), 0);
    if (streams == 1) {
      huf_stream(huf, sub.p + sub.pos, sub.left(), literals.data(), regen);
      return;
    }
    const u8* jump = sub.take(6, "literals jump table");
    i64 s1 = jump[0] | (jump[1] << 8), s2 = jump[2] | (jump[3] << 8), s3 = jump[4] | (jump[5] << 8);
    i64 s4 = sub.left() - s1 - s2 - s3;
    if (s4 < 1) fail("literals jump table exceeds the literals");
    const i64 seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("too few literals for four streams");
    const i64 sizes[4] = {s1, s2, s3, s4};
    const i64 counts[4] = {seg, seg, seg, regen - 3 * seg};
    i64 at = 0;
    for (int k = 0; k < 4; ++k) {
      const u8* s = sub.take(sizes[k], "literals stream");
      huf_stream(huf, s, sizes[k], literals.data() + at, counts[k]);
      at += counts[k];
    }
  }

  void read_seq_table(Input& in, int kind, int mode) {
    static const int kMaxAcc[3] = {9, 8, 9};
    static const int kMaxSym[3] = {36, 32, 53};
    FseTable& t = seq_tables[kind];
    if (mode == 0) {
      if (kind == kLL) fse_build(&t, kLLDefault, 36, 6);
      if (kind == kOF) fse_build(&t, kOFDefault, 29, 5);
      if (kind == kML) fse_build(&t, kMLDefault, 53, 6);
    } else if (mode == 1) {
      u8 s = in.byte("RLE sequence code");
      if (s >= kMaxSym[kind]) fail("RLE sequence code out of range");
      fse_rle(&t, s);
    } else if (mode == 2) {
      fse_read(&t, in, kMaxAcc[kind], kMaxSym[kind]);
    } else if (!seq_valid[kind]) {
      fail("repeated sequence table without an earlier one");
    }
    seq_valid[kind] = true;
  }

  void copy_literals(const u8* src, i64 n) {
    if (n == 0) return;
    need_out(n);
    std::memcpy(dst + out, src, size_t(n));
    out += n;
  }

  void copy_match(u64 offset, i64 len) {
    if (offset == 0 || offset > u64(out - frame_start))
      fail("match offset beyond the decoded data");
    need_out(len);
    u8* d = dst + out;
    const u8* s = d - offset;
    if (offset >= u64(len)) {
      std::memcpy(d, s, size_t(len));
    } else {
      for (i64 i = 0; i < len; ++i) d[i] = s[i];  // the match overlaps its own output
    }
    out += len;
  }

  void compressed_block(const u8* src, i64 n) {
    Input in(src, n);
    read_literals(in);
    if (in.left() < 1) fail("truncated sequences section");
    const u8 b0 = in.byte("sequences header");
    i64 nseq;
    if (b0 == 0) {
      nseq = 0;
    } else if (b0 < 128) {
      nseq = b0;
    } else if (b0 < 255) {
      nseq = (i64(b0 - 128) << 8) + in.byte("sequences header");
    } else {
      const u8* h = in.take(2, "sequences header");
      nseq = h[0] + (i64(h[1]) << 8) + 0x7F00;
    }
    i64 lit_pos = 0;
    const i64 lit_n = i64(literals.size());
    if (nseq > 0) {
      const u8 modes = in.byte("sequence modes");
      if (modes & 3) fail("reserved bits set in the sequence modes");
      read_seq_table(in, kLL, (modes >> 6) & 3);
      read_seq_table(in, kOF, (modes >> 4) & 3);
      read_seq_table(in, kML, (modes >> 2) & 3);
      BackBits bits(in.p + in.pos, in.left(), "sequences");
      FseState ll, of, ml;
      ll.init(&seq_tables[kLL], bits);
      of.init(&seq_tables[kOF], bits);
      ml.init(&seq_tables[kML], bits);
      for (i64 k = 0; k < nseq; ++k) {
        const u8 of_code = of.peek(), ll_code = ll.peek(), ml_code = ml.peek();
        if (ll_code > 35 || ml_code > 52 || of_code > 31) fail("sequence code out of range");
        const u64 of_value = (u64(1) << of_code) + bits.read(of_code);
        const i64 ml_len = kMLBase[ml_code] + i64(bits.read(kMLBits[ml_code]));
        const i64 ll_len = kLLBase[ll_code] + i64(bits.read(kLLBits[ll_code]));
        if (k + 1 < nseq) {
          ll.update(bits);
          ml.update(bits);
          of.update(bits);
        }
        if (bits.off < 0) fail("sequences bit stream overrun");
        u64 offset;
        if (of_value > 3) {
          offset = of_value - 3;
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        } else {
          u32 idx = u32(of_value - 1) + (ll_len == 0 ? 1 : 0);
          if (idx == 0) {
            offset = rep[0];
          } else {
            offset = idx < 3 ? rep[idx] : rep[0] - 1;
            if (idx > 1) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = offset;
          }
        }
        if (ll_len > lit_n - lit_pos) fail("sequence takes more literals than the block holds");
        copy_literals(literals.data() + lit_pos, ll_len);
        lit_pos += ll_len;
        copy_match(offset, ml_len);
      }
      if (bits.off != 0) fail("sequences bit stream not consumed exactly");
    } else if (in.left() != 0) {
      fail("bytes after a block without sequences");
    }
    copy_literals(literals.data() + lit_pos, lit_n - lit_pos);
  }

  // Decode one frame at in.pos (magic already consumed).
  void frame(Input& in) {
    reset_frame();
    const u8 fhd = in.byte("frame header");
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
              did_flag = fhd & 3;
    if (fhd & 0x08) fail("reserved bit set in the frame header");
    if (!single) in.byte("window descriptor");
    static const int kDidBytes[4] = {0, 1, 2, 4};
    const u8* did = in.take(kDidBytes[did_flag], "dictionary id");
    u32 dict_id = 0;
    for (int i = 0; i < kDidBytes[did_flag]; ++i) dict_id |= u32(did[i]) << (8 * i);
    if (dict_id != 0) fail("frame needs a dictionary (id " + std::to_string(dict_id) + ")");
    static const int kFcsBytes[4] = {0, 2, 4, 8};
    int fcs_bytes = kFcsBytes[fcs_flag];
    if (fcs_flag == 0 && single) fcs_bytes = 1;
    i64 content_size = -1;
    if (fcs_bytes) {
      const u8* f = in.take(fcs_bytes, "frame content size");
      u64 v = 0;
      for (int i = 0; i < fcs_bytes; ++i) v |= u64(f[i]) << (8 * i);
      if (fcs_bytes == 2) v += 256;
      if (v > u64(grow ? limit : dst_len) - u64(out))
        fail("frame content size larger than the output buffer");
      content_size = i64(v);
    }
    for (;;) {
      const u8* h = in.take(3, "block header");
      const u32 bh = h[0] | (u32(h[1]) << 8) | (u32(h[2]) << 16);
      const int last = bh & 1, type = (bh >> 1) & 3;
      const i64 size = bh >> 3;
      if (type == 0) {
        if (size > (1 << 17)) fail("raw block larger than 128 KiB");
        copy_literals(in.take(size, "raw block"), size);
      } else if (type == 1) {
        if (size > (1 << 17)) fail("RLE block larger than 128 KiB");
        const u8 b = in.byte("RLE block");
        if (size > 0) {
          need_out(size);
          std::memset(dst + out, b, size_t(size));
          out += size;
        }
      } else if (type == 2) {
        if (size > (1 << 17)) fail("compressed block larger than 128 KiB");
        const i64 before = out;
        compressed_block(in.take(size, "compressed block"), size);
        if (out - before > (1 << 17)) fail("block decodes to more than 128 KiB");
      } else {
        fail("reserved block type");
      }
      if (last) break;
    }
    if (content_size >= 0 && out - frame_start != content_size)
      fail("frame content size does not match the decoded data");
    if (checksum) {
      const u8* c = in.take(4, "content checksum");
      const u32 want = le32(c);
      const u32 got = u32(xxh64(dst + frame_start, out - frame_start, 0));
      if (want != got) fail("content checksum mismatch");
    }
  }
};

void decode_frames(FrameDecoder& dec, const u8* src, i64 n) {
  Input in(src, n);
  if (n == 0) fail("no zstd frame");
  while (in.left() > 0) {
    const u32 magic = le32(in.take(4, "frame magic"));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      in.take(le32(in.take(4, "skippable frame size")), "skippable frame");
      continue;
    }
    if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)");
    dec.frame(in);
  }
}

// Decode every frame of src[0:n] into dst[0:dst_len], which it must fill.
void zstd_decode(const u8* src, i64 n, u8* dst, i64 dst_len) {
  FrameDecoder dec;
  dec.dst = dst;
  dec.dst_len = dst_len;
  decode_frames(dec, src, n);
  if (dec.out != dst_len) fail("decoded " + std::to_string(dec.out) + " bytes, expected " +
                               std::to_string(dst_len));
}

constexpr i64 kBlock = 1 << 17;

// Bytes of the raw-block frame of n bytes: magic, header descriptor, window
// descriptor, 8-byte content size, 3-byte block headers, checksum.
i64 raw_frame_size(i64 n) {
  return 4 + 1 + 1 + 8 + 3 * (n == 0 ? 1 : (n + kBlock - 1) / kBlock) + n + 4;
}

void put_le(u8* p, u64 v, int bytes) {
  for (int i = 0; i < bytes; ++i) p[i] = u8(v >> (8 * i));
}

void write_error(const std::string& msg, char* err, int64_t err_len) {
  if (err && err_len > 0) {
    size_t k = msg.size() < size_t(err_len - 1) ? msg.size() : size_t(err_len - 1);
    std::memcpy(err, msg.data(), k);
    err[k] = 0;
  }
}

}  // namespace

extern "C" {

// Decode the zstd frames of src[0:n] into dst[0:dst_len]. Returns 0 when the
// frames decode to exactly dst_len bytes, else -1 with a message in err.
int knnsvc_zstd_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t dst_len, char* err,
                       int64_t err_len) {
  try {
    zstd_decode(src, n, dst, dst_len);
    return 0;
  } catch (const std::exception& e) {
    write_error(e.what(), err, err_len);
    return -1;
  }
}

// Decode the zstd frames of src[0:n], whose decoded size is not known, into
// a malloc'd buffer of at most `limit` bytes: *out (free it with
// knnsvc_orbax_free) and *out_len. Returns 0, or -1 with a message in err.
int knnsvc_zstd_decode_alloc(const uint8_t* src, int64_t n, int64_t limit, uint8_t** out,
                             int64_t* out_len, char* err, int64_t err_len) {
  FrameDecoder dec;
  dec.grow = true;
  dec.limit = limit;
  dec.dst_len = 0;
  dec.dst = nullptr;
  *out = nullptr;
  *out_len = 0;
  try {
    decode_frames(dec, src, n);
    *out = dec.dst;
    *out_len = dec.out;
    return 0;
  } catch (const std::exception& e) {
    std::free(dec.dst);
    write_error(e.what(), err, err_len);
    return -1;
  }
}

void knnsvc_orbax_free(void* p) { std::free(p); }

// Size of knnsvc_zstd_write_raw's frame for n bytes of content.
int64_t knnsvc_zstd_raw_size(int64_t n) { return raw_frame_size(n); }

// One zstd frame of raw blocks holding src[0:n], with its content size and
// XXH64 checksum, written to dst (knnsvc_zstd_raw_size(n) bytes). The window
// is 128 KiB, one block, so a decoder needs no more memory than that. Returns
// the bytes written, or -1 when cap is too small.
int64_t knnsvc_zstd_write_raw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  if (cap < raw_frame_size(n)) return -1;
  u8* p = dst;
  put_le(p, 0xFD2FB528u, 4);
  p[4] = u8((3 << 6) | (1 << 2));   // 8-byte content size, checksum, no dictionary
  p[5] = u8((17 - 10) << 3);        // window 2^17
  put_le(p + 6, u64(n), 8);
  p += 14;
  i64 at = 0;
  do {
    const i64 k = n - at < kBlock ? n - at : kBlock;
    const int last = at + k == n;
    put_le(p, (u64(k) << 3) | u64(last), 3);
    std::memcpy(p + 3, src + at, size_t(k));
    p += 3 + k;
    at += k;
  } while (at < n);
  put_le(p, u32(xxh64(src, n, 0)), 4);
  p += 4;
  return p - dst;
}

uint32_t knnsvc_crc32c(const uint8_t* p, int64_t n) { return crc32c(p, n); }

}  // extern "C"
