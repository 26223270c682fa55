// MPEG-1/2/2.5 audio Layer III decoder (ISO/IEC 11172-3 and 13818-3) with a
// plain C interface, bound by knnsvc_torch/io/mp3.py through ctypes.
//
// One call decodes a whole file held in memory to 16-bit PCM at the file's own
// rate and channel count:
//   frame sync and header checks, ID3v2 / ID3v1 / APE tags kept out of the
//   audio, the Xing/Info tag frame read for its LAME encoder delay and padding
//   (the gapless trim: delay + 529 samples at the start, padding - 529 at the
//   end), side information, the bit reservoir, scalefactors (MPEG-1 with scfsi,
//   the LSF layouts of 13818-3 with the intensity-stereo variants), the 32
//   Huffman tables with linbits and the count1 tables A and B, requantization,
//   short-block reordering, M/S and intensity stereo, alias reduction, the
//   IMDCT with the four block types, frequency inversion and the 32-band
//   polyphase synthesis through a fast 32-point DCT.
//
// Arithmetic is IEEE double throughout. Every table is computed here with
// +, -, *, / and sqrt only (no libm transcendental), and the library is built
// with -ffp-contract=off, so two hosts with different C libraries produce the
// same samples bit for bit.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Deterministic elementary functions.

constexpr double kPi = 3.14159265358979323846264338327950288;

// sin(t) and cos(t) by their Taylor series, for |t| <= pi/4.
double sin_series(double t) {
  double term = t, sum = t, t2 = t * t;
  for (int k = 1; k < 14; ++k) {
    term *= -t2 / ((2 * k) * (2 * k + 1));
    sum += term;
  }
  return sum;
}

double cos_series(double t) {
  double term = 1.0, sum = 1.0, t2 = t * t;
  for (int k = 1; k < 14; ++k) {
    term *= -t2 / ((2 * k - 1) * (2 * k));
    sum += term;
  }
  return sum;
}

// cos(pi * p / q) for integers, reduced by symmetry to an angle of at most pi/4.
double cos_pi(int64_t p, int64_t q) {
  if (q < 0) { p = -p; q = -q; }
  p %= 2 * q;
  if (p < 0) p += 2 * q;              // angle in [0, 2pi)
  if (p > q) p = 2 * q - p;           // cos(2pi - a) = cos(a): angle in [0, pi]
  double sign = 1.0;
  if (2 * p > q) { p = q - p; sign = -1.0; }   // cos(pi - a) = -cos(a): [0, pi/2]
  if (4 * p > q)                               // cos(a) = sin(pi/2 - a)
    return sign * sin_series(kPi * static_cast<double>(q - 2 * p) / static_cast<double>(2 * q));
  return sign * cos_series(kPi * static_cast<double>(p) / static_cast<double>(q));
}

double sin_pi(int64_t p, int64_t q) { return cos_pi(q - 2 * p, 2 * q); }  // sin a = cos(pi/2 - a)

// Cube root of a non-negative integer below 2^53 by Newton's method, to
// within an ulp (n^(4/3) is taken as the cube root of the exact n^4).
double cbrt_int(int64_t v) {
  if (v == 0) return 0.0;
  double x = static_cast<double>(v);
  double y = 1.0;
  while (y * y * y < x) y *= 2.0;
  for (int i = 0; i < 200; ++i) {
    double next = y - (y * y * y - x) / (3.0 * y * y);
    if (next == y) break;
    y = next;
  }
  return y;
}

double ldexp_int(double x, int e) {  // x * 2^e, exact for the ranges used here
  while (e > 0) { x *= 2.0; --e; }
  while (e < 0) { x *= 0.5; ++e; }
  return x;
}

// ---------------------------------------------------------------------------
// Stream tables (ISO 11172-3 2.4.2.3, 13818-3 2.4.2.3).

// sampling frequency index used below: MPEG-1 0..2, MPEG-2 3..5, MPEG-2.5 6..8
const int kSampleRate[9] = {44100, 48000, 32000, 22050, 24000, 16000, 11025, 12000, 8000};
const int kBitrateKbps[2][15] = {
    {0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320},
    {0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160},
};

// scalefactor band boundaries, long blocks (23) and short blocks (14), per rate
const int16_t kLongBand[9][23] = {
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134, 162, 196, 238, 288, 342, 418, 576},
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128, 156, 190, 230, 276, 330, 384, 576},
    {0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156, 194, 240, 296, 364, 448, 550, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238, 284, 336, 396, 464, 522, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194, 232, 278, 332, 394, 464, 540, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238, 284, 336, 396, 464, 522, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238, 284, 336, 396, 464, 522, 576},
    {0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200, 238, 284, 336, 396, 464, 522, 576},
    {0, 12, 24, 36, 48, 60, 72, 88, 108, 132, 160, 192, 232, 280, 336, 400, 476, 566, 568, 570, 572, 574, 576},
};
const int16_t kShortBand[9][14] = {
    {0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192},
    {0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192},
    {0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192},
    {0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192},
    {0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192},
    {0, 8, 16, 24, 36, 52, 72, 96, 124, 160, 162, 164, 166, 192},
};

const uint8_t kPretab[22] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0};
const uint8_t kSlen[2][16] = {
    {0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4},
    {0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3},
};
// LSF: scalefactors per partition [layout][long, short, mixed][partition]
const uint8_t kLsfSfbCount[6][3][4] = {
    {{6, 5, 5, 5}, {9, 9, 9, 9}, {6, 9, 9, 9}},
    {{6, 5, 7, 3}, {9, 9, 12, 6}, {6, 9, 12, 6}},
    {{11, 10, 0, 0}, {18, 18, 0, 0}, {15, 18, 0, 0}},
    {{7, 7, 7, 0}, {12, 12, 12, 0}, {6, 15, 12, 0}},
    {{6, 6, 6, 3}, {12, 9, 9, 6}, {6, 12, 9, 6}},
    {{8, 8, 5, 0}, {15, 12, 9, 0}, {6, 18, 9, 0}},
};

// ---------------------------------------------------------------------------
// Huffman code tables (ISO 11172-3 Annex B, Table B.7): codeword value and
// length for each (x, y), x major. Tables 16-23 share table 16's codes and
// 24-31 share table 24's; they differ in linbits.

const uint16_t kCode1[4] = {
    1, 1,
    1, 0,
};
const uint8_t kLen1[4] = {
    1, 3,
    2, 3,
};
const uint16_t kCode2[9] = {
    1, 2, 1,
    3, 1, 1,
    3, 2, 0,
};
const uint8_t kLen2[9] = {
    1, 3, 6,
    3, 3, 5,
    5, 5, 6,
};
const uint16_t kCode3[9] = {
    3, 2, 1,
    1, 1, 1,
    3, 2, 0,
};
const uint8_t kLen3[9] = {
    2, 2, 6,
    3, 2, 5,
    5, 5, 6,
};
const uint16_t kCode5[16] = {
    1, 2, 6, 5,
    3, 1, 4, 4,
    7, 5, 7, 1,
    6, 1, 1, 0,
};
const uint8_t kLen5[16] = {
    1, 3, 6, 7,
    3, 3, 6, 7,
    6, 6, 7, 8,
    7, 6, 7, 8,
};
const uint16_t kCode6[16] = {
    7, 3, 5, 1,
    6, 2, 3, 2,
    5, 4, 4, 1,
    3, 3, 2, 0,
};
const uint8_t kLen6[16] = {
    3, 3, 5, 7,
    3, 2, 4, 5,
    4, 4, 5, 6,
    6, 5, 6, 7,
};
const uint16_t kCode7[36] = {
    1, 2, 10, 19, 16, 10,
    3, 3, 7, 10, 5, 3,
    11, 4, 13, 17, 8, 4,
    12, 11, 18, 15, 11, 2,
    7, 6, 9, 14, 3, 1,
    6, 4, 5, 3, 2, 0,
};
const uint8_t kLen7[36] = {
    1, 3, 6, 8, 8, 9,
    3, 4, 6, 7, 7, 8,
    6, 5, 7, 8, 8, 9,
    7, 7, 8, 9, 9, 9,
    7, 7, 8, 9, 9, 10,
    8, 8, 9, 10, 10, 10,
};
const uint16_t kCode8[36] = {
    3, 4, 6, 18, 12, 5,
    5, 1, 2, 16, 9, 3,
    7, 3, 5, 14, 7, 3,
    19, 17, 15, 13, 10, 4,
    13, 5, 8, 11, 5, 1,
    12, 4, 4, 1, 1, 0,
};
const uint8_t kLen8[36] = {
    2, 3, 6, 8, 8, 9,
    3, 2, 4, 8, 8, 8,
    6, 4, 6, 8, 8, 9,
    8, 8, 8, 9, 9, 10,
    8, 7, 8, 9, 10, 10,
    9, 8, 9, 9, 11, 11,
};
const uint16_t kCode9[36] = {
    7, 5, 9, 14, 15, 7,
    6, 4, 5, 5, 6, 7,
    7, 6, 8, 8, 8, 5,
    15, 6, 9, 10, 5, 1,
    11, 7, 9, 6, 4, 1,
    14, 4, 6, 2, 6, 0,
};
const uint8_t kLen9[36] = {
    3, 3, 5, 6, 8, 9,
    3, 3, 4, 5, 6, 8,
    4, 4, 5, 6, 7, 8,
    6, 5, 6, 7, 7, 8,
    7, 6, 7, 7, 8, 9,
    8, 7, 8, 8, 9, 9,
};
const uint16_t kCode10[64] = {
    1, 2, 10, 23, 35, 30, 12, 17,
    3, 3, 8, 12, 18, 21, 12, 7,
    11, 9, 15, 21, 32, 40, 19, 6,
    14, 13, 22, 34, 46, 23, 18, 7,
    20, 19, 33, 47, 27, 22, 9, 3,
    31, 22, 41, 26, 21, 20, 5, 3,
    14, 13, 10, 11, 16, 6, 5, 1,
    9, 8, 7, 8, 4, 4, 2, 0,
};
const uint8_t kLen10[64] = {
    1, 3, 6, 8, 9, 9, 9, 10,
    3, 4, 6, 7, 8, 9, 8, 8,
    6, 6, 7, 8, 9, 10, 9, 9,
    7, 7, 8, 9, 10, 10, 9, 10,
    8, 8, 9, 10, 10, 10, 10, 10,
    9, 9, 10, 10, 11, 11, 10, 11,
    8, 8, 9, 10, 10, 10, 11, 11,
    9, 8, 9, 10, 10, 11, 11, 11,
};
const uint16_t kCode11[64] = {
    3, 4, 10, 24, 34, 33, 21, 15,
    5, 3, 4, 10, 32, 17, 11, 10,
    11, 7, 13, 18, 30, 31, 20, 5,
    25, 11, 19, 59, 27, 18, 12, 5,
    35, 33, 31, 58, 30, 16, 7, 5,
    28, 26, 32, 19, 17, 15, 8, 14,
    14, 12, 9, 13, 14, 9, 4, 1,
    11, 4, 6, 6, 6, 3, 2, 0,
};
const uint8_t kLen11[64] = {
    2, 3, 5, 7, 8, 9, 8, 9,
    3, 3, 4, 6, 8, 8, 7, 8,
    5, 5, 6, 7, 8, 9, 8, 8,
    7, 6, 7, 9, 8, 10, 8, 9,
    8, 8, 8, 9, 9, 10, 9, 10,
    8, 8, 9, 10, 10, 11, 10, 11,
    8, 7, 7, 8, 9, 10, 10, 10,
    8, 7, 8, 9, 10, 10, 10, 10,
};
const uint16_t kCode12[64] = {
    9, 6, 16, 33, 41, 39, 38, 26,
    7, 5, 6, 9, 23, 16, 26, 11,
    17, 7, 11, 14, 21, 30, 10, 7,
    17, 10, 15, 12, 18, 28, 14, 5,
    32, 13, 22, 19, 18, 16, 9, 5,
    40, 17, 31, 29, 17, 13, 4, 2,
    27, 12, 11, 15, 10, 7, 4, 1,
    27, 12, 8, 12, 6, 3, 1, 0,
};
const uint8_t kLen12[64] = {
    4, 3, 5, 7, 8, 9, 9, 9,
    3, 3, 4, 5, 7, 7, 8, 8,
    5, 4, 5, 6, 7, 8, 7, 8,
    6, 5, 6, 6, 7, 8, 8, 8,
    7, 6, 7, 7, 8, 8, 8, 9,
    8, 7, 8, 8, 8, 9, 8, 9,
    8, 7, 7, 8, 8, 9, 9, 10,
    9, 8, 8, 9, 9, 9, 9, 10,
};
const uint16_t kCode13[256] = {
    1, 5, 14, 21, 34, 51, 46, 71, 42, 52, 68, 52, 67, 44, 43, 19,
    3, 4, 12, 19, 31, 26, 44, 33, 31, 24, 32, 24, 31, 35, 22, 14,
    15, 13, 23, 36, 59, 49, 77, 65, 29, 40, 30, 40, 27, 33, 42, 16,
    22, 20, 37, 61, 56, 79, 73, 64, 43, 76, 56, 37, 26, 31, 25, 14,
    35, 16, 60, 57, 97, 75, 114, 91, 54, 73, 55, 41, 48, 53, 23, 24,
    58, 27, 50, 96, 76, 70, 93, 84, 77, 58, 79, 29, 74, 49, 41, 17,
    47, 45, 78, 74, 115, 94, 90, 79, 69, 83, 71, 50, 59, 38, 36, 15,
    72, 34, 56, 95, 92, 85, 91, 90, 86, 73, 77, 65, 51, 44, 43, 42,
    43, 20, 30, 44, 55, 78, 72, 87, 78, 61, 46, 54, 37, 30, 20, 16,
    53, 25, 41, 37, 44, 59, 54, 81, 66, 76, 57, 54, 37, 18, 39, 11,
    35, 33, 31, 57, 42, 82, 72, 80, 47, 58, 55, 21, 22, 26, 38, 22,
    53, 25, 23, 38, 70, 60, 51, 36, 55, 26, 34, 23, 27, 14, 9, 7,
    34, 32, 28, 39, 49, 75, 30, 52, 48, 40, 52, 28, 18, 17, 9, 5,
    45, 21, 34, 64, 56, 50, 49, 45, 31, 19, 12, 15, 10, 7, 6, 3,
    48, 23, 20, 39, 36, 35, 53, 21, 16, 23, 13, 10, 6, 1, 4, 2,
    16, 15, 17, 27, 25, 20, 29, 11, 17, 12, 16, 8, 1, 1, 0, 1,
};
const uint8_t kLen13[256] = {
    1, 4, 6, 7, 8, 9, 9, 10, 9, 10, 11, 11, 12, 12, 13, 13,
    3, 4, 6, 7, 8, 8, 9, 9, 9, 9, 10, 10, 11, 12, 12, 12,
    6, 6, 7, 8, 9, 9, 10, 10, 9, 10, 10, 11, 11, 12, 13, 13,
    7, 7, 8, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11, 12, 13, 13,
    8, 7, 9, 9, 10, 10, 11, 11, 10, 11, 11, 12, 12, 13, 13, 14,
    9, 8, 9, 10, 10, 10, 11, 11, 11, 11, 12, 11, 13, 13, 14, 14,
    9, 9, 10, 10, 11, 11, 11, 11, 11, 12, 12, 12, 13, 13, 14, 14,
    10, 9, 10, 11, 11, 11, 12, 12, 12, 12, 13, 13, 13, 14, 16, 16,
    9, 8, 9, 10, 10, 11, 11, 12, 12, 12, 12, 13, 13, 14, 15, 15,
    10, 9, 10, 10, 11, 11, 11, 13, 12, 13, 13, 14, 14, 14, 16, 15,
    10, 10, 10, 11, 11, 12, 12, 13, 12, 13, 14, 13, 14, 15, 16, 17,
    11, 10, 10, 11, 12, 12, 12, 12, 13, 13, 13, 14, 15, 15, 15, 16,
    11, 11, 11, 12, 12, 13, 12, 13, 14, 14, 15, 15, 15, 16, 16, 16,
    12, 11, 12, 13, 13, 13, 14, 14, 14, 14, 14, 15, 16, 15, 16, 16,
    13, 12, 12, 13, 13, 13, 15, 14, 14, 17, 15, 15, 15, 17, 16, 16,
    12, 12, 13, 14, 14, 14, 15, 14, 15, 15, 16, 16, 19, 18, 19, 16,
};
const uint16_t kCode15[256] = {
    7, 12, 18, 53, 47, 76, 124, 108, 89, 123, 108, 119, 107, 81, 122, 63,
    13, 5, 16, 27, 46, 36, 61, 51, 42, 70, 52, 83, 65, 41, 59, 36,
    19, 17, 15, 24, 41, 34, 59, 48, 40, 64, 50, 78, 62, 80, 56, 33,
    29, 28, 25, 43, 39, 63, 55, 93, 76, 59, 93, 72, 54, 75, 50, 29,
    52, 22, 42, 40, 67, 57, 95, 79, 72, 57, 89, 69, 49, 66, 46, 27,
    77, 37, 35, 66, 58, 52, 91, 74, 62, 48, 79, 63, 90, 62, 40, 38,
    125, 32, 60, 56, 50, 92, 78, 65, 55, 87, 71, 51, 73, 51, 70, 30,
    109, 53, 49, 94, 88, 75, 66, 122, 91, 73, 56, 42, 64, 44, 21, 25,
    90, 43, 41, 77, 73, 63, 56, 92, 77, 66, 47, 67, 48, 53, 36, 20,
    71, 34, 67, 60, 58, 49, 88, 76, 67, 106, 71, 54, 38, 39, 23, 15,
    109, 53, 51, 47, 90, 82, 58, 57, 48, 72, 57, 41, 23, 27, 62, 9,
    86, 42, 40, 37, 70, 64, 52, 43, 70, 55, 42, 25, 29, 18, 11, 11,
    118, 68, 30, 55, 50, 46, 74, 65, 49, 39, 24, 16, 22, 13, 14, 7,
    91, 44, 39, 38, 34, 63, 52, 45, 31, 52, 28, 19, 14, 8, 9, 3,
    123, 60, 58, 53, 47, 43, 32, 22, 37, 24, 17, 12, 15, 10, 2, 1,
    71, 37, 34, 30, 28, 20, 17, 26, 21, 16, 10, 6, 8, 6, 2, 0,
};
const uint8_t kLen15[256] = {
    3, 4, 5, 7, 7, 8, 9, 9, 9, 10, 10, 11, 11, 11, 12, 13,
    4, 3, 5, 6, 7, 7, 8, 8, 8, 9, 9, 10, 10, 10, 11, 11,
    5, 5, 5, 6, 7, 7, 8, 8, 8, 9, 9, 10, 10, 11, 11, 11,
    6, 6, 6, 7, 7, 8, 8, 9, 9, 9, 10, 10, 10, 11, 11, 11,
    7, 6, 7, 7, 8, 8, 9, 9, 9, 9, 10, 10, 10, 11, 11, 11,
    8, 7, 7, 8, 8, 8, 9, 9, 9, 9, 10, 10, 11, 11, 11, 12,
    9, 7, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 11, 11, 12, 12,
    9, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 11, 11, 11, 12,
    9, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 12, 12, 12,
    9, 8, 9, 9, 9, 9, 10, 10, 10, 11, 11, 11, 11, 12, 12, 12,
    10, 9, 9, 9, 10, 10, 10, 10, 10, 11, 11, 11, 11, 12, 13, 12,
    10, 9, 9, 9, 10, 10, 10, 10, 11, 11, 11, 11, 12, 12, 12, 13,
    11, 10, 9, 10, 10, 10, 11, 11, 11, 11, 11, 11, 12, 12, 13, 13,
    11, 10, 10, 10, 10, 11, 11, 11, 11, 12, 12, 12, 12, 12, 13, 13,
    12, 11, 11, 11, 11, 11, 11, 11, 12, 12, 12, 12, 13, 13, 12, 13,
    12, 11, 11, 11, 11, 11, 11, 12, 12, 12, 12, 12, 13, 13, 13, 13,
};
const uint16_t kCode16[256] = {
    1, 5, 14, 44, 74, 63, 110, 93, 172, 149, 138, 242, 225, 195, 376, 17,
    3, 4, 12, 20, 35, 62, 53, 47, 83, 75, 68, 119, 201, 107, 207, 9,
    15, 13, 23, 38, 67, 58, 103, 90, 161, 72, 127, 117, 110, 209, 206, 16,
    45, 21, 39, 69, 64, 114, 99, 87, 158, 140, 252, 212, 199, 387, 365, 26,
    75, 36, 68, 65, 115, 101, 179, 164, 155, 264, 246, 226, 395, 382, 362, 9,
    66, 30, 59, 56, 102, 185, 173, 265, 142, 253, 232, 400, 388, 378, 445, 16,
    111, 54, 52, 100, 184, 178, 160, 133, 257, 244, 228, 217, 385, 366, 715, 10,
    98, 48, 91, 88, 165, 157, 148, 261, 248, 407, 397, 372, 380, 889, 884, 8,
    85, 84, 81, 159, 156, 143, 260, 249, 427, 401, 392, 383, 727, 713, 708, 7,
    154, 76, 73, 141, 131, 256, 245, 426, 406, 394, 384, 735, 359, 710, 352, 11,
    139, 129, 67, 125, 247, 233, 229, 219, 393, 743, 737, 720, 885, 882, 439, 4,
    243, 120, 118, 115, 227, 223, 396, 746, 742, 736, 721, 712, 706, 223, 436, 6,
    202, 224, 222, 218, 216, 389, 386, 381, 364, 888, 443, 707, 440, 437, 1728, 4,
    747, 211, 210, 208, 370, 379, 734, 723, 714, 1735, 883, 877, 876, 3459, 865, 2,
    377, 369, 102, 187, 726, 722, 358, 711, 709, 866, 1734, 871, 3458, 870, 434, 0,
    12, 10, 7, 11, 10, 17, 11, 9, 13, 12, 10, 7, 5, 3, 1, 3,
};
const uint8_t kLen16[256] = {
    1, 4, 6, 8, 9, 9, 10, 10, 11, 11, 11, 12, 12, 12, 13, 9,
    3, 4, 6, 7, 8, 9, 9, 9, 10, 10, 10, 11, 12, 11, 12, 8,
    6, 6, 7, 8, 9, 9, 10, 10, 11, 10, 11, 11, 11, 12, 12, 9,
    8, 7, 8, 9, 9, 10, 10, 10, 11, 11, 12, 12, 12, 13, 13, 10,
    9, 8, 9, 9, 10, 10, 11, 11, 11, 12, 12, 12, 13, 13, 13, 9,
    9, 8, 9, 9, 10, 11, 11, 12, 11, 12, 12, 13, 13, 13, 14, 10,
    10, 9, 9, 10, 11, 11, 11, 11, 12, 12, 12, 12, 13, 13, 14, 10,
    10, 9, 10, 10, 11, 11, 11, 12, 12, 13, 13, 13, 13, 15, 15, 10,
    10, 10, 10, 11, 11, 11, 12, 12, 13, 13, 13, 13, 14, 14, 14, 10,
    11, 10, 10, 11, 11, 12, 12, 13, 13, 13, 13, 14, 13, 14, 13, 11,
    11, 11, 10, 11, 12, 12, 12, 12, 13, 14, 14, 14, 15, 15, 14, 10,
    12, 11, 11, 11, 12, 12, 13, 14, 14, 14, 14, 14, 14, 13, 14, 11,
    12, 12, 12, 12, 12, 13, 13, 13, 13, 15, 14, 14, 14, 14, 16, 11,
    14, 12, 12, 12, 13, 13, 14, 14, 14, 16, 15, 15, 15, 17, 15, 11,
    13, 13, 11, 12, 14, 14, 13, 14, 14, 15, 16, 15, 17, 15, 14, 11,
    9, 8, 8, 9, 9, 10, 10, 10, 11, 11, 11, 11, 11, 11, 11, 8,
};
const uint16_t kCode24[256] = {
    15, 13, 46, 80, 146, 262, 248, 434, 426, 669, 653, 649, 621, 517, 1032, 88,
    14, 12, 21, 38, 71, 130, 122, 216, 209, 198, 327, 345, 319, 297, 279, 42,
    47, 22, 41, 74, 68, 128, 120, 221, 207, 194, 182, 340, 315, 295, 541, 18,
    81, 39, 75, 70, 134, 125, 116, 220, 204, 190, 178, 325, 311, 293, 271, 16,
    147, 72, 69, 135, 127, 118, 112, 210, 200, 188, 352, 323, 306, 285, 540, 14,
    263, 66, 129, 126, 119, 114, 214, 202, 192, 180, 341, 317, 301, 281, 262, 12,
    249, 123, 121, 117, 113, 215, 206, 195, 185, 347, 330, 308, 291, 272, 520, 10,
    435, 115, 111, 109, 211, 203, 196, 187, 353, 332, 313, 298, 283, 531, 381, 17,
    427, 212, 208, 205, 201, 193, 186, 177, 169, 320, 303, 286, 268, 514, 377, 16,
    335, 199, 197, 191, 189, 181, 174, 333, 321, 305, 289, 275, 521, 379, 371, 11,
    668, 184, 183, 179, 175, 344, 331, 314, 304, 290, 277, 530, 383, 373, 366, 10,
    652, 346, 171, 168, 164, 318, 309, 299, 287, 276, 263, 513, 375, 368, 362, 6,
    648, 322, 316, 312, 307, 302, 292, 284, 269, 261, 512, 376, 370, 364, 359, 4,
    620, 300, 296, 294, 288, 282, 273, 266, 515, 380, 374, 369, 365, 361, 357, 2,
    1033, 280, 278, 274, 267, 264, 259, 382, 378, 372, 367, 363, 360, 358, 356, 0,
    43, 20, 19, 17, 15, 13, 11, 9, 7, 6, 4, 7, 5, 3, 1, 3,
};
const uint8_t kLen24[256] = {
    4, 4, 6, 7, 8, 9, 9, 10, 10, 11, 11, 11, 11, 11, 12, 9,
    4, 4, 5, 6, 7, 8, 8, 9, 9, 9, 10, 10, 10, 10, 10, 8,
    6, 5, 6, 7, 7, 8, 8, 9, 9, 9, 9, 10, 10, 10, 11, 7,
    7, 6, 7, 7, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 7,
    8, 7, 7, 8, 8, 8, 8, 9, 9, 9, 10, 10, 10, 10, 11, 7,
    9, 7, 8, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 7,
    9, 8, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 11, 7,
    10, 8, 8, 8, 9, 9, 9, 9, 10, 10, 10, 10, 10, 11, 11, 8,
    10, 9, 9, 9, 9, 9, 9, 9, 9, 10, 10, 10, 10, 11, 11, 8,
    10, 9, 9, 9, 9, 9, 9, 10, 10, 10, 10, 10, 11, 11, 11, 8,
    11, 9, 9, 9, 9, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 8,
    11, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 8,
    11, 10, 10, 10, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 11, 8,
    11, 10, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 11, 11, 11, 8,
    12, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 11, 11, 11, 11, 8,
    8, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8, 4,
};

// count1 table A, index v*8 + w*4 + x*2 + y (table B is the 4-bit complement)
const uint16_t kCode32[16] = {1, 5, 4, 5, 6, 5, 4, 4, 7, 3, 6, 0, 7, 2, 3, 1};
const uint8_t kLen32[16] = {1, 4, 4, 5, 4, 6, 5, 6, 4, 5, 5, 6, 5, 6, 6, 6};

const uint8_t kLinbits[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                              1, 2, 3, 4, 6, 8, 10, 13, 4, 5, 6, 7, 8, 9, 11, 13};

// The synthesis window's prototype: D[i] * 65536 of ISO 11172-3 Table 3-B.3
// for i = 0..256 with the sign of every other block of 64 turned, so that it
// is one symmetric low-pass (h[512 - i] = h[i]).
const int32_t kWindowHalf[257] = {
    0, -1, -1, -1, -1, -1, -1, -2, -2, -2, -2, -3, -3, -4, -4, -5,
    -5, -6, -7, -7, -8, -9, -10, -11, -13, -14, -16, -17, -19, -21, -24, -26,
    -29, -31, -35, -38, -41, -45, -49, -53, -58, -63, -68, -73, -79, -85, -91, -97,
    -104, -111, -117, -125, -132, -139, -147, -154, -161, -169, -176, -183, -190, -196, -202, -208,
    -213, -218, -222, -225, -227, -228, -228, -227, -224, -221, -215, -208, -200, -189, -177, -163,
    -146, -127, -106, -83, -57, -29, 2, 36, 72, 111, 153, 197, 244, 294, 347, 401,
    459, 519, 581, 645, 711, 779, 848, 919, 991, 1064, 1137, 1210, 1283, 1356, 1428, 1498,
    1567, 1634, 1698, 1759, 1817, 1870, 1919, 1962, 2001, 2032, 2057, 2075, 2085, 2087, 2080, 2063,
    2037, 2000, 1952, 1893, 1822, 1739, 1644, 1535, 1414, 1280, 1131, 970, 794, 605, 402, 185,
    -45, -288, -545, -814, -1095, -1388, -1692, -2006, -2330, -2663, -3004, -3351, -3705, -4063, -4425, -4788,
    -5153, -5517, -5879, -6237, -6589, -6935, -7271, -7597, -7910, -8209, -8491, -8755, -8998, -9219, -9416, -9585,
    -9727, -9838, -9916, -9959, -9966, -9935, -9863, -9750, -9592, -9389, -9139, -8840, -8492, -8092, -7640, -7134,
    -6574, -5959, -5288, -4561, -3776, -2935, -2037, -1082, -70, 998, 2122, 3300, 4533, 5818, 7154, 8540,
    9975, 11455, 12980, 14548, 16155, 17799, 19478, 21189, 22929, 24694, 26482, 28289, 30112, 31947, 33791, 35640,
    37489, 39336, 41176, 43006, 44821, 46617, 48390, 50137, 51853, 53534, 55178, 56778, 58333, 59838, 61289, 62684,
    64019, 65290, 66494, 67629, 68692, 69679, 70590, 71420, 72169, 72835, 73415, 73908, 74313, 74630, 74856, 74992,
    75038,
};

// ---------------------------------------------------------------------------
// Huffman decoding through a two-level lookup: the first kRootBits bits index
// the root; a longer code's root entry points at a sub-table indexed by the
// bits that follow. An entry holds the symbol and the code's whole length.

constexpr int kRootBits = 8;
constexpr uint32_t kSubFlag = 0x80000000u;

struct Lut {
  std::vector<uint32_t> e;
};

Lut build_lut(const uint16_t* code, const uint8_t* len, int count, int dim) {
  Lut t;
  t.e.assign(1u << kRootBits, 0);
  // codes longer than the root: group by their root prefix
  std::vector<int> sub_bits(1u << kRootBits, 0);
  for (int s = 0; s < count; ++s)
    if (len[s] > kRootBits) {
      uint32_t p = code[s] >> (len[s] - kRootBits);
      if (len[s] - kRootBits > sub_bits[p]) sub_bits[p] = len[s] - kRootBits;
    }
  for (uint32_t p = 0; p < (1u << kRootBits); ++p)
    if (sub_bits[p]) {
      uint32_t off = static_cast<uint32_t>(t.e.size());
      t.e.resize(off + (1u << sub_bits[p]), 0);
      t.e[p] = kSubFlag | (static_cast<uint32_t>(sub_bits[p]) << 24) | off;
    }
  for (int s = 0; s < count; ++s) {
    uint32_t sym = dim == 0 ? s : ((s / dim) << 4) | (s % dim);
    int l = len[s];
    uint32_t leaf = (static_cast<uint32_t>(l) << 16) | sym;
    if (l <= kRootBits) {
      uint32_t first = static_cast<uint32_t>(code[s]) << (kRootBits - l);
      for (uint32_t k = 0; k < (1u << (kRootBits - l)); ++k) t.e[first + k] = leaf;
    } else {
      uint32_t p = code[s] >> (l - kRootBits);
      int sb = (t.e[p] >> 24) & 0x1F;
      uint32_t off = t.e[p] & 0xFFFFFF;
      int rest = l - kRootBits;
      uint32_t first = (code[s] & ((1u << rest) - 1)) << (sb - rest);
      for (uint32_t k = 0; k < (1u << (sb - rest)); ++k) t.e[off + first + k] = leaf;
    }
  }
  return t;
}

struct Tables {
  Lut pair[32];          // by table_select; 0, 4 and 14 are empty
  Lut quad_a;
  double pow43[8207];    // |is|^(4/3)
  double gain[600];      // 2^(q/4) for q = index - 500
  double long_cos[18][20];    // IMDCT 36 by input k: outputs 0..8, 18..26 (+1 pad each)
  double win36[4][36];        // block types 0, 1, 3 (2 unused)
  double short_cos[12][6];    // IMDCT 12, window folded in
  double alias_cs[8], alias_ca[8];
  double dct_coef[6][16];     // 1 / (2 cos(pi (2k+1) / (2n))) for n = 2, 4, .., 32
  double window[512];         // synthesis window D[i]
  double is_ratio[7][2];      // MPEG-1 intensity: kl, kr by is_pos
  double inv_sqrt2, sqrt2;

  Tables() {
    struct Src { int id; const uint16_t* c; const uint8_t* l; int dim; };
    const Src src[] = {
        {1, kCode1, kLen1, 2},     {2, kCode2, kLen2, 3},     {3, kCode3, kLen3, 3},
        {5, kCode5, kLen5, 4},     {6, kCode6, kLen6, 4},     {7, kCode7, kLen7, 6},
        {8, kCode8, kLen8, 6},     {9, kCode9, kLen9, 6},     {10, kCode10, kLen10, 8},
        {11, kCode11, kLen11, 8},  {12, kCode12, kLen12, 8},  {13, kCode13, kLen13, 16},
        {15, kCode15, kLen15, 16}, {16, kCode16, kLen16, 16}, {24, kCode24, kLen24, 16},
    };
    for (const Src& s : src) pair[s.id] = build_lut(s.c, s.l, s.dim * s.dim, s.dim);
    for (int t = 17; t < 24; ++t) pair[t] = pair[16];
    for (int t = 25; t < 32; ++t) pair[t] = pair[24];
    quad_a = build_lut(kCode32, kLen32, 16, 0);

    for (int64_t n = 0; n < 8207; ++n) pow43[n] = cbrt_int(n * n * n * n);
    const double quarter[4] = {1.0, sqrt_d(sqrt_d(2.0)), sqrt_d(2.0), sqrt_d(sqrt_d(8.0))};
    for (int i = 0; i < 600; ++i) {
      int q = i - 500;
      gain[i] = ldexp_int(quarter[q & 3], q >> 2);
    }
    for (int k = 0; k < 18; ++k) {
      for (int i = 0; i < 9; ++i) {
        long_cos[k][i] = cos_pi((2 * i + 19) * (2 * k + 1), 72);
        long_cos[k][10 + i] = cos_pi((2 * (i + 18) + 19) * (2 * k + 1), 72);
      }
      long_cos[k][9] = long_cos[k][19] = 0.0;
    }
    for (int i = 0; i < 36; ++i) {
      double w = sin_pi(2 * i + 1, 72);
      win36[0][i] = w;
      win36[1][i] = i < 18 ? w : i < 24 ? 1.0 : i < 30 ? sin_pi(2 * (i - 18) + 1, 24) : 0.0;
      win36[3][i] = i < 6 ? 0.0 : i < 12 ? sin_pi(2 * (i - 6) + 1, 24) : i < 18 ? 1.0 : w;
      win36[2][i] = 0.0;
    }
    for (int i = 0; i < 12; ++i)
      for (int k = 0; k < 6; ++k)
        short_cos[i][k] = sin_pi(2 * i + 1, 24) * cos_pi((2 * i + 7) * (2 * k + 1), 24);
    const double c[8] = {-0.6, -0.535, -0.33, -0.185, -0.095, -0.041, -0.0142, -0.0037};
    for (int i = 0; i < 8; ++i) {
      double sq = sqrt_d(1.0 + c[i] * c[i]);
      alias_cs[i] = 1.0 / sq;
      alias_ca[i] = c[i] / sq;
    }
    for (int lvl = 0, n = 32; n >= 2; ++lvl, n /= 2)
      for (int k = 0; k < n / 2; ++k) dct_coef[lvl][k] = 1.0 / (2.0 * cos_pi(2 * k + 1, 2 * n));
    for (int i = 0; i < 512; ++i) {
      int h = kWindowHalf[i <= 256 ? i : 512 - i];
      window[i] = ((i >> 6) & 1 ? -h : h) / 65536.0;
    }
    for (int p = 0; p < 7; ++p) {
      if (p == 6) {
        is_ratio[p][0] = 1.0;
        is_ratio[p][1] = 0.0;
        continue;
      }
      double t = sin_pi(p, 12) / cos_pi(p, 12);  // tan(p pi / 12)
      is_ratio[p][0] = t / (1.0 + t);
      is_ratio[p][1] = 1.0 / (1.0 + t);
    }
    sqrt2 = sqrt_d(2.0);
    inv_sqrt2 = 1.0 / sqrt2;
  }

  static double sqrt_d(double x) {  // IEEE square root (correctly rounded)
    return __builtin_sqrt(x);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---------------------------------------------------------------------------
// Bit reading. Buffers handed to a reader carry 8 zero bytes past their end.

struct BitReader {
  const uint8_t* p;
  int64_t pos = 0;  // in bits

  uint32_t peek32() const {
    const uint8_t* q = p + (pos >> 3);
    uint64_t v = (static_cast<uint64_t>(q[0]) << 56) | (static_cast<uint64_t>(q[1]) << 48) |
                 (static_cast<uint64_t>(q[2]) << 40) | (static_cast<uint64_t>(q[3]) << 32) |
                 (static_cast<uint64_t>(q[4]) << 24) | (static_cast<uint64_t>(q[5]) << 16) |
                 (static_cast<uint64_t>(q[6]) << 8) | static_cast<uint64_t>(q[7]);
    return static_cast<uint32_t>((v << (pos & 7)) >> 32);
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek32() >> (32 - n);
    pos += n;
    return v;
  }
  uint32_t huff(const Lut& t) {
    uint32_t w = peek32();
    uint32_t e = t.e[w >> (32 - kRootBits)];
    if (e & kSubFlag) {
      int sb = (e >> 24) & 0x1F;
      e = t.e[(e & 0xFFFFFF) + ((w << kRootBits) >> (32 - sb))];
    }
    pos += (e >> 16) & 0x1F;
    return e & 0xFFFF;
  }
};

// ---------------------------------------------------------------------------
// Frame header.

struct Header {
  int lsf;        // 0: MPEG-1, 1: MPEG-2 or 2.5
  int sfreq;      // 0..8, see kSampleRate
  int crc;        // 1 when a 16-bit CRC follows the header
  int bitrate;    // kbit/s
  int padding;
  int mode;       // 0 stereo, 1 joint stereo, 2 dual channel, 3 mono
  int mode_ext;
  int channels;
  int frame_bytes;
  int side_bytes;
};

bool parse_header(const uint8_t* d, int64_t avail, Header* h) {
  if (avail < 4 || d[0] != 0xFF || (d[1] & 0xE0) != 0xE0) return false;
  int version = (d[1] >> 3) & 3;  // 3 MPEG-1, 2 MPEG-2, 0 MPEG-2.5
  int layer = (d[1] >> 1) & 3;    // 1 Layer III
  int br = (d[2] >> 4) & 15, sr = (d[2] >> 2) & 3;
  if (version == 1 || layer != 1 || br == 0 || br == 15 || sr == 3) return false;
  h->lsf = version != 3;
  h->sfreq = (version == 3 ? 0 : version == 2 ? 3 : 6) + sr;
  h->crc = !(d[1] & 1);
  h->bitrate = kBitrateKbps[h->lsf][br];
  h->padding = (d[2] >> 1) & 1;
  h->mode = (d[3] >> 6) & 3;
  h->mode_ext = (d[3] >> 4) & 3;
  h->channels = h->mode == 3 ? 1 : 2;
  h->frame_bytes = (h->lsf ? 72 : 144) * h->bitrate * 1000 / kSampleRate[h->sfreq] + h->padding;
  h->side_bytes = h->lsf ? (h->channels == 1 ? 9 : 17) : (h->channels == 1 ? 17 : 32);
  return true;
}

bool same_stream(const Header& a, const Header& b) {
  return a.lsf == b.lsf && a.sfreq == b.sfreq && a.channels == b.channels;
}

// ---------------------------------------------------------------------------
// Side information.

struct Granule {
  int part23;
  int big_values;
  int global_gain;
  int sf_compress;
  int block_type;  // 0 normal, 1 start, 2 short, 3 stop
  int mixed;
  int table[3];
  int subblock_gain[3];
  int region1;     // first line of region 1 and of region 2
  int region2;
  int preflag;
  int sf_scale;
  int count1_b;
};

struct SideInfo {
  int main_data_begin;
  int scfsi[2][4];
  Granule gr[2][2];
};

void read_side_info(const uint8_t* p, const Header& h, SideInfo* si) {
  uint8_t buf[40] = {0};
  std::memcpy(buf, p, h.side_bytes);
  BitReader br{buf};
  int nch = h.channels;
  if (!h.lsf) {
    si->main_data_begin = br.get(9);
    br.get(nch == 1 ? 5 : 3);
    for (int ch = 0; ch < nch; ++ch)
      for (int b = 0; b < 4; ++b) si->scfsi[ch][b] = br.get(1);
  } else {
    si->main_data_begin = br.get(8);
    br.get(nch == 1 ? 1 : 2);
    std::memset(si->scfsi, 0, sizeof(si->scfsi));
  }
  const int16_t* lb = kLongBand[h.sfreq];
  const int16_t* sb = kShortBand[h.sfreq];
  for (int g = 0; g < (h.lsf ? 1 : 2); ++g)
    for (int ch = 0; ch < nch; ++ch) {
      Granule& gi = si->gr[g][ch];
      gi.part23 = br.get(12);
      gi.big_values = br.get(9);
      if (gi.big_values > 288) gi.big_values = 288;
      gi.global_gain = br.get(8);
      gi.sf_compress = br.get(h.lsf ? 9 : 4);
      if (br.get(1)) {  // window switching
        gi.block_type = br.get(2);
        gi.mixed = br.get(1);
        gi.table[0] = br.get(5);
        gi.table[1] = br.get(5);
        gi.table[2] = 0;
        for (int w = 0; w < 3; ++w) gi.subblock_gain[w] = br.get(3);
        gi.region1 = gi.block_type == 2 && !gi.mixed ? 3 * sb[3] : lb[8];
        gi.region2 = 576;
      } else {
        gi.block_type = 0;
        gi.mixed = 0;
        for (int r = 0; r < 3; ++r) gi.table[r] = br.get(5);
        for (int w = 0; w < 3; ++w) gi.subblock_gain[w] = 0;
        int r0 = br.get(4), r1 = br.get(3);
        gi.region1 = lb[r0 + 1];
        gi.region2 = r0 + r1 + 2 < 22 ? lb[r0 + r1 + 2] : 576;
      }
      gi.preflag = h.lsf ? 0 : br.get(1);
      gi.sf_scale = br.get(1);
      gi.count1_b = br.get(1);
    }
}

// ---------------------------------------------------------------------------
// Per-channel decoder state.

struct Channel {
  int sfl[22];        // long-block scalefactors (kept for scfsi)
  int sfs[13][3];     // short-block scalefactors [sfb][window]
  int lsf_slots[40];  // LSF scalefactors in the order read, zero after
  double overlap[32][18];
  double v[16][64];   // synthesis FIFO, one 64-vector per slot
  int v_pos;
};

// zero bytes past the data a reader may run over on a corrupt granule
// (big_values pairs are read without a bound check)
constexpr int kReadSlack = 4096;
constexpr int kReservoirKeep = 1024;  // > the largest main_data_begin (511)
constexpr int kMaxFrame = 2048;       // > the largest Layer III frame (1441)

struct Decoder {
  const Tables& T = tables();
  Header h{};
  Channel chan[2];
  // bit reservoir: main data of the frames read so far, newest last, with
  // kReadSlack zero bytes after the last one
  std::vector<uint8_t> reservoir = std::vector<uint8_t>(kReservoirKeep + kMaxFrame + kReadSlack, 0);
  int reservoir_len = 0;
  int xr_end[2];              // one past the last line that may be non-zero
  double xr[2][576];
  double subband[18][32];     // hybrid output of one channel, time-major

  Decoder() {
    std::memset(chan, 0, sizeof(chan));
  }

  // after bytes that are no frame: the reservoir is gone and the synthesis
  // filter starts empty; the IMDCT overlap is kept (as the reference decode
  // does)
  void resync() {
    std::memset(reservoir.data(), 0, reservoir_len);
    reservoir_len = 0;
    for (Channel& c : chan) std::memset(c.v, 0, sizeof(c.v));
  }

  // MPEG-1 scalefactors (11172-3 2.4.2.7)
  void read_sf_mpeg1(BitReader& br, const Granule& gi, int ch, int g, const int scfsi[4]) {
    Channel& c = chan[ch];
    int s1 = kSlen[0][gi.sf_compress], s2 = kSlen[1][gi.sf_compress];
    if (gi.block_type == 2) {
      int sfb = 0;
      if (gi.mixed) {
        for (; sfb < 8; ++sfb) c.sfl[sfb] = br.get(s1);
        sfb = 3;
      }
      for (; sfb < 6; ++sfb)
        for (int w = 0; w < 3; ++w) c.sfs[sfb][w] = br.get(s1);
      for (; sfb < 12; ++sfb)
        for (int w = 0; w < 3; ++w) c.sfs[sfb][w] = br.get(s2);
      for (int w = 0; w < 3; ++w) c.sfs[12][w] = 0;
      return;
    }
    static const int group[5] = {0, 6, 11, 16, 21};
    for (int k = 0; k < 4; ++k) {
      if (g == 1 && scfsi[k]) continue;  // reused from granule 0
      for (int sfb = group[k]; sfb < group[k + 1]; ++sfb) c.sfl[sfb] = br.get(k < 2 ? s1 : s2);
    }
    c.sfl[21] = 0;
  }

  // LSF scalefactors (13818-3 2.4.3.2); the right channel of an
  // intensity-stereo frame has its own layouts
  void read_sf_lsf(BitReader& br, Granule& gi, int ch) {
    Channel& c = chan[ch];
    int sfc = gi.sf_compress, slen[4], layout;
    bool intensity_right = ch == 1 && (h.mode == 1) && (h.mode_ext & 1);
    if (!intensity_right) {
      if (sfc < 400) {
        slen[0] = (sfc >> 4) / 5; slen[1] = (sfc >> 4) % 5; slen[2] = (sfc & 15) >> 2; slen[3] = sfc & 3;
        layout = 0;
      } else if (sfc < 500) {
        sfc -= 400;
        slen[0] = (sfc >> 2) / 5; slen[1] = (sfc >> 2) % 5; slen[2] = sfc & 3; slen[3] = 0;
        layout = 1;
      } else {
        sfc -= 500;
        slen[0] = sfc / 3; slen[1] = sfc % 3; slen[2] = 0; slen[3] = 0;
        layout = 2;
        gi.preflag = 1;
      }
    } else {
      int isc = sfc >> 1;
      if (isc < 180) {
        slen[0] = isc / 36; slen[1] = (isc % 36) / 6; slen[2] = (isc % 36) % 6; slen[3] = 0;
        layout = 3;
      } else if (isc < 244) {
        isc -= 180;
        slen[0] = (isc & 63) >> 4; slen[1] = (isc & 15) >> 2; slen[2] = isc & 3; slen[3] = 0;
        layout = 4;
      } else {
        isc -= 244;
        slen[0] = isc / 3; slen[1] = isc % 3; slen[2] = 0; slen[3] = 0;
        layout = 5;
      }
    }
    int kind = gi.block_type == 2 ? (gi.mixed ? 2 : 1) : 0;
    int* vals = c.lsf_slots;
    int n = 0;
    std::memset(c.lsf_slots, 0, sizeof(c.lsf_slots));
    for (int p = 0; p < 4; ++p)
      for (int k = 0; k < kLsfSfbCount[layout][kind][p]; ++k) vals[n++] = br.get(slen[p]);
    if (kind == 0) {
      for (int sfb = 0; sfb < 21; ++sfb) c.sfl[sfb] = vals[sfb];
      c.sfl[21] = 0;
    } else {
      int k = 0, sfb = 0;
      if (kind == 2) {
        for (; k < 6; ++k) c.sfl[k] = vals[k];
        sfb = 3;
      }
      for (; sfb < 12; ++sfb)
        for (int w = 0; w < 3; ++w) c.sfs[sfb][w] = vals[k++];
      for (int w = 0; w < 3; ++w) c.sfs[12][w] = 0;
    }
  }

  // Huffman-coded spectrum of one granule/channel into is[], returns the
  // count of lines that may be non-zero
  int read_spectrum(BitReader& br, const Granule& gi, int64_t end, int* is) {
    int bv_end = gi.big_values * 2;
    int bounds[3] = {gi.region1 < bv_end ? gi.region1 : bv_end,
                     gi.region2 < bv_end ? gi.region2 : bv_end, bv_end};
    int i = 0;
    for (int r = 0; r < 3; ++r) {
      int t = gi.table[r];
      int stop = bounds[r];
      if (t == 0 || t == 4 || t == 14) {
        for (; i < stop; ++i) is[i] = 0;
        continue;
      }
      const Lut& lut = T.pair[t];
      int linbits = kLinbits[t];
      for (; i < stop; i += 2) {
        uint32_t s = br.huff(lut);
        int x = s >> 4, y = s & 15;
        if (x == 15 && linbits) x += br.get(linbits);
        if (x && br.get(1)) x = -x;
        if (y == 15 && linbits) y += br.get(linbits);
        if (y && br.get(1)) y = -y;
        is[i] = x;
        is[i + 1] = y;
      }
    }
    // count1 region: quadruples until the granule's bits are spent
    while (i + 4 <= 576 && br.pos < end) {
      uint32_t s = gi.count1_b ? 15 - br.get(4) : br.huff(T.quad_a);
      int q[4] = {static_cast<int>(s >> 3) & 1, static_cast<int>(s >> 2) & 1,
                  static_cast<int>(s >> 1) & 1, static_cast<int>(s) & 1};
      for (int k = 0; k < 4; ++k)
        if (q[k] && br.get(1)) q[k] = -1;
      if (br.pos > end) break;  // the last quadruple ran past the granule
      for (int k = 0; k < 4; ++k) is[i + k] = q[k];
      i += 4;
    }
    for (int k = i; k < 576; ++k) is[k] = 0;
    return i;
  }

  // requantize (11172-3 2.4.3.4.7) into xr, short blocks reordered window-
  // interleaved (line 3f + w holds frequency f of window w)
  int requantize(const Granule& gi, const Channel& c, const int* is, int nz, double* out) {
    std::memset(out, 0, 576 * sizeof(double));
    const int16_t* lb = kLongBand[h.sfreq];
    const int16_t* sb = kShortBand[h.sfreq];
    int shift = gi.sf_scale ? 2 : 1;
    int end = 0;
    auto line = [&](int v, double g) -> double {
      return v >= 0 ? T.pow43[v] * g : -T.pow43[-v] * g;
    };
    // a mixed block's long part: 8 long bands in MPEG-1, 6 in LSF (36 lines
    // but at 8 kHz, where they reach line 72, as its short part's 3 * sb[3])
    int long_end = gi.block_type != 2 ? 576 : gi.mixed ? (h.lsf ? lb[6] : lb[8]) : 0;
    for (int sfb = 0; sfb < 22 && lb[sfb] < long_end && lb[sfb] < nz; ++sfb) {
      int q = gi.global_gain - 210 - ((c.sfl[sfb] + (gi.preflag ? kPretab[sfb] : 0)) << shift);
      double g = T.gain[q + 500];
      int stop = lb[sfb + 1] < nz ? lb[sfb + 1] : nz;
      for (int i = lb[sfb]; i < stop; ++i) out[i] = line(is[i], g);
      end = stop;
    }
    if (gi.block_type == 2) {
      int sfb = gi.mixed ? 3 : 0;
      int pos = 3 * sb[sfb];
      for (; sfb < 13 && pos < nz; ++sfb) {
        int width = sb[sfb + 1] - sb[sfb];
        for (int w = 0; w < 3; ++w) {
          int q = gi.global_gain - 210 - 8 * gi.subblock_gain[w] - (c.sfs[sfb][w] << shift);
          double g = T.gain[q + 500];
          for (int k = 0; k < width && pos < nz; ++k, ++pos) {
            if (!is[pos]) continue;
            int dst = 3 * (sb[sfb] + k) + w;
            out[dst] = line(is[pos], g);
          }
        }
        end = 3 * sb[sfb + 1];
      }
    }
    return end;
  }

  // ----- stereo (11172-3 2.4.3.4.9, 13818-3 2.4.3.2) -----
  void ms_lines(int a, int b) {
    for (int i = a; i < b; ++i) {
      double m = xr[0][i], s = xr[1][i];
      xr[0][i] = (m + s) * T.inv_sqrt2;
      xr[1][i] = (m - s) * T.inv_sqrt2;
    }
  }

  // intensity position p of a band, applied to lines first, first+stride, ...
  // with both ratios times `scale`
  void intensity(int p, bool lsf_scale, int first, int count, int stride, double scale = 1.0) {
    double kl, kr;
    if (!h.lsf) {
      kl = T.is_ratio[p][0];
      kr = T.is_ratio[p][1];
    } else {
      int unit = lsf_scale ? 2 : 1;  // quarter-steps of 2^(1/4)
      kl = kr = 1.0;
      if (p & 1) kl = T.gain[500 - unit * ((p + 1) >> 1)];
      else if (p) kr = T.gain[500 - unit * (p >> 1)];
    }
    kl *= scale;
    kr *= scale;
    for (int k = 0, i = first; k < count; ++k, i += stride) {
      double v = xr[0][i];
      xr[0][i] = v * kl;
      xr[1][i] = v * kr;
    }
  }

  void plain_or_ms(bool ms, int first, int count, int stride) {
    if (!ms) return;
    for (int k = 0, i = first; k < count; ++k, i += stride) {
      double m = xr[0][i], s = xr[1][i];
      xr[0][i] = (m + s) * T.inv_sqrt2;
      xr[1][i] = (m - s) * T.inv_sqrt2;
    }
  }

  void stereo(const Granule& g1) {
    bool ms = h.mode_ext & 2, is = h.mode_ext & 1;
    int end = xr_end[0] > xr_end[1] ? xr_end[0] : xr_end[1];
    xr_end[0] = xr_end[1] = end;
    if (!is) {
      if (ms) ms_lines(0, end);
      return;
    }
    const Channel& r = chan[1];
    const int16_t* lb = kLongBand[h.sfreq];
    const int16_t* sb = kShortBand[h.sfreq];
    bool lsf_scale = g1.sf_compress & 1;
    // illegal intensity positions, whose lines are coded as M/S or L/R: 7 and
    // up in MPEG-1, 7 in LSF too, as the reference decoder reads LSF streams
    // (13818-3 marks each scalefactor's largest value instead)
    auto legal = [&](int p) { return h.lsf ? p != 7 : p < 7; };
    bool short_nonzero = false;
    if (g1.block_type != 2 || g1.mixed) {
      // long bands (all of a long block, the long part of a mixed block)
      int long_bands = g1.block_type == 2 ? (h.lsf ? 6 : 8) : 22;
      int last = -1;
      for (int i = (g1.block_type == 2 ? lb[long_bands] : 576) - 1; i >= 0; --i)
        if (xr[1][i] != 0.0) { last = i; break; }
      if (g1.block_type == 2)
        for (int i = lb[long_bands]; i < 576; ++i)
          if (xr[1][i] != 0.0) { short_nonzero = true; break; }
      int bound = 0;
      while (bound < long_bands && lb[bound] <= last) ++bound;
      if (short_nonzero) bound = long_bands;
      plain_or_ms(ms, 0, lb[bound], 1);
      for (int sfb = bound; sfb < long_bands; ++sfb) {
        int src = sfb < 21 ? sfb : 20;
        int p = r.sfl[src];
        int width = lb[sfb + 1] - lb[sfb];
        if (legal(p)) intensity(p, lsf_scale, lb[sfb], width, 1);
        else plain_or_ms(ms, lb[sfb], width, 1);
      }
      if (g1.block_type != 2) {
        xr_end[0] = xr_end[1] = 576;
        return;
      }
    }
    // short bands, each window on its own
    int first_sfb = g1.mixed ? 3 : 0;
    for (int w = 0; w < 3; ++w) {
      int bound = first_sfb;
      for (int sfb = 12; sfb >= first_sfb; --sfb) {
        bool nz = false;
        for (int f = sb[sfb]; f < sb[sfb + 1]; ++f)
          if (xr[1][3 * f + w] != 0.0) { nz = true; break; }
        if (nz) { bound = sfb + 1; break; }
      }
      for (int sfb = first_sfb; sfb < 13; ++sfb) {
        int width = sb[sfb + 1] - sb[sfb];
        if (sfb < bound) { plain_or_ms(ms, 3 * sb[sfb] + w, width, 3); continue; }
        int src = sfb < 12 ? sfb : 11;
        // an LSF mixed block's positions are read at MPEG-1's mixed layout
        // (8 long scalefactors ahead of the short ones, where LSF has 6), as
        // the reference decoder reads them
        int p = h.lsf && g1.mixed ? r.lsf_slots[3 * src + w - 1] : r.sfs[src][w];
        if (legal(p)) intensity(p, lsf_scale, 3 * sb[sfb] + w, width, 3);
        else plain_or_ms(ms, 3 * sb[sfb] + w, width, 3);
      }
    }
    if (h.lsf && g1.mixed && !short_nonzero)
      // and, as the reference decoder does, long bands 6 and 7 of MPEG-1's
      // layout once more, on the lines they would span (with M/S, its ratios
      // there carry the sqrt(2) that undoes M/S's scale)
      for (int sfb = 6; sfb < 8; ++sfb)
        if (legal(r.lsf_slots[sfb]))
          intensity(r.lsf_slots[sfb], lsf_scale, lb[sfb], lb[sfb + 1] - lb[sfb], 1,
                    ms ? T.sqrt2 : 1.0);
    xr_end[0] = xr_end[1] = 576;
  }

  // ----- alias reduction, IMDCT, overlap-add, frequency inversion -----
  void hybrid(const Granule& gi, int ch) {
    double* x = xr[ch];
    Channel& c = chan[ch];
    int sblimit = (xr_end[ch] + 17) / 18;  // sub-bands that may hold data
    if (sblimit > 32) sblimit = 32;
    // alias reduction between long-block sub-bands
    int alias_bands = gi.block_type != 2 ? sblimit : gi.mixed ? 1 : 0;
    if (alias_bands > 31) alias_bands = 31;
    for (int sb = 1; sb <= alias_bands; ++sb)
      for (int i = 0; i < 8; ++i) {
        double a = x[18 * sb - 1 - i], b = x[18 * sb + i];
        x[18 * sb - 1 - i] = a * T.alias_cs[i] - b * T.alias_ca[i];
        x[18 * sb + i] = b * T.alias_cs[i] + a * T.alias_ca[i];
      }
    if (alias_bands >= sblimit && sblimit < 32 && gi.block_type != 2) ++sblimit;
    for (int sb = 0; sb < 32; ++sb) {
      double z[36];
      double* prev = c.overlap[sb];
      if (sb >= sblimit) {
        for (int i = 0; i < 18; ++i) { subband[i][sb] = prev[i]; prev[i] = 0.0; }
      } else {
        const double* in = x + 18 * sb;
        int bt = gi.block_type;
        if (bt == 2 && gi.mixed && sb < 2) bt = 0;
        if (bt != 2) {
          // the 36 outputs are 18 values and their mirror images:
          // z[17 - i] = -z[i], z[35 - i] = z[18 + i]
          double uv[20] = {0};
          for (int k = 0; k < 18; ++k)
            for (int i = 0; i < 20; ++i) uv[i] += in[k] * T.long_cos[k][i];
          for (int i = 0; i < 9; ++i) {
            z[i] = uv[i];
            z[17 - i] = -uv[i];
            z[18 + i] = uv[10 + i];
            z[35 - i] = uv[10 + i];
          }
          for (int i = 0; i < 36; ++i) z[i] *= T.win36[bt][i];
        } else {
          for (int i = 0; i < 36; ++i) z[i] = 0.0;
          for (int w = 0; w < 3; ++w)
            for (int i = 0; i < 12; ++i) {
              double s = 0.0;
              for (int k = 0; k < 6; ++k) s += in[3 * k + w] * T.short_cos[i][k];
              z[6 + 6 * w + i] += s;
            }
        }
        for (int i = 0; i < 18; ++i) {
          subband[i][sb] = z[i] + prev[i];
          prev[i] = z[18 + i];
        }
      }
      if (sb & 1)
        for (int i = 1; i < 18; i += 2) subband[i][sb] = -subband[i][sb];
    }
  }

  // ----- polyphase synthesis (11172-3 Annex A, Figure A.2) -----
  // DCT-II of size N by the even/odd split (Lee): even outputs are the DCT of
  // x[k] + x[N-1-k], odd ones adjacent sums of the DCT of the scaled
  // differences
  template <int N, int Lvl>
  void dct(double* x) const {
    if constexpr (N == 1) {
      (void)x;
    } else {
      constexpr int half = N / 2;
      double a[half], b[half];
      for (int k = 0; k < half; ++k) {
        a[k] = x[k] + x[N - 1 - k];
        b[k] = (x[k] - x[N - 1 - k]) * T.dct_coef[Lvl][k];
      }
      dct<half, Lvl + 1>(a);
      dct<half, Lvl + 1>(b);
      for (int m = 0; m < half; ++m) x[2 * m] = a[m];
      for (int m = 0; m < half - 1; ++m) x[2 * m + 1] = b[m] + b[m + 1];
      x[N - 1] = b[half - 1];
    }
  }

  void synthesize(int ch, int16_t* out, int stride) {
    Channel& c = chan[ch];
    for (int t = 0; t < 18; ++t) {
      double s[32];
      for (int k = 0; k < 32; ++k) s[k] = subband[t][k];
      dct<32, 0>(s);
      c.v_pos = (c.v_pos + 15) & 15;
      double* v = c.v[c.v_pos];
      for (int i = 0; i < 16; ++i) v[i] = s[16 + i];
      v[16] = 0.0;
      for (int i = 17; i < 48; ++i) v[i] = -s[48 - i];
      for (int i = 48; i < 64; ++i) v[i] = -s[i - 48];
      double acc[32] = {0};
      for (int i = 0; i < 8; ++i) {
        const double* ve = c.v[(c.v_pos + 2 * i) & 15];
        const double* vo = c.v[(c.v_pos + 2 * i + 1) & 15] + 32;
        const double* de = T.window + 64 * i;
        const double* dod = T.window + 64 * i + 32;
        for (int j = 0; j < 32; ++j) acc[j] += ve[j] * de[j] + vo[j] * dod[j];
      }
      for (int j = 0; j < 32; ++j) {
        double y = acc[j] * 32768.0;
        long r;
        if (y >= 32767.0) r = 32767;
        else if (y <= -32768.0) r = -32768;
        else r = __builtin_lrint(y);
        out[(32 * t + j) * stride] = static_cast<int16_t>(r);
      }
    }
  }

  // decode one frame's audio; frame points at the header. When the bit
  // reservoir lacks the data the frame refers to, its samples are synthesized
  // from an empty spectrum.
  void decode_frame(const uint8_t* frame, int16_t* out) {
    int nch = h.channels;
    SideInfo si;
    const uint8_t* side = frame + 4 + (h.crc ? 2 : 0);
    read_side_info(side, h, &si);
    const uint8_t* main = side + h.side_bytes;
    int main_bytes = h.frame_bytes - static_cast<int>(main - frame);
    if (main_bytes < 0) main_bytes = 0;
    if (reservoir_len > kReservoirKeep) {  // keep the newest bytes only
      std::memmove(reservoir.data(), reservoir.data() + reservoir_len - kReservoirKeep, kReservoirKeep);
      std::memset(reservoir.data() + kReservoirKeep, 0, reservoir_len - kReservoirKeep);
      reservoir_len = kReservoirKeep;
    }
    int have = reservoir_len;
    bool ok = si.main_data_begin <= have;
    int start = have - si.main_data_begin;
    std::memcpy(reservoir.data() + reservoir_len, main, main_bytes);
    reservoir_len += main_bytes;
    BitReader br{reservoir.data()};
    br.pos = static_cast<int64_t>(start < 0 ? 0 : start) * 8;
    int ngr = h.lsf ? 1 : 2;
    for (int g = 0; g < ngr; ++g) {
      for (int ch = 0; ch < nch; ++ch) {
        Granule& gi = si.gr[g][ch];
        if (!ok) {
          std::memset(xr[ch], 0, sizeof(xr[ch]));
          xr_end[ch] = 0;
          continue;
        }
        int64_t part2_start = br.pos;
        if (h.lsf) read_sf_lsf(br, gi, ch);
        else read_sf_mpeg1(br, gi, ch, g, si.scfsi[ch]);
        int64_t end = part2_start + gi.part23;
        int is[576];
        int nz = read_spectrum(br, gi, end, is);
        br.pos = end;
        xr_end[ch] = requantize(gi, chan[ch], is, nz, xr[ch]);
      }
      if (nch == 2 && h.mode == 1 && ok) stereo(si.gr[g][1]);
      for (int ch = 0; ch < nch; ++ch) {
        hybrid(si.gr[g][ch], ch);
        synthesize(ch, out + 576 * g * nch + ch, nch);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Container: tags and frame scanning.

int64_t id3v2_size(const uint8_t* d, int64_t n) {
  if (n < 10 || d[0] != 'I' || d[1] != 'D' || d[2] != '3') return 0;
  int64_t size = ((d[6] & 0x7F) << 21) | ((d[7] & 0x7F) << 14) | ((d[8] & 0x7F) << 7) | (d[9] & 0x7F);
  return 10 + size + ((d[5] & 0x10) ? 10 : 0);
}

// end of the audio: ID3v1 and APEv2 tags at the end of a file are not frames
int64_t audio_end(const uint8_t* d, int64_t n) {
  if (n >= 128 && d[n - 128] == 'T' && d[n - 127] == 'A' && d[n - 126] == 'G') n -= 128;
  if (n >= 32 && std::memcmp(d + n - 32, "APETAGEX", 8) == 0) {
    const uint8_t* f = d + n - 32;
    int64_t size = f[12] | (f[13] << 8) | (f[14] << 16) | (static_cast<int64_t>(f[15]) << 24);
    uint32_t flags = f[20] | (f[21] << 8) | (f[22] << 16) | (static_cast<uint32_t>(f[23]) << 24);
    size += (flags & 0x80000000u) ? 32 : 0;
    if (size <= n) n -= size;
  }
  return n;
}

// a header at i that the next frame confirms, or that ends the data exactly
bool confirmed_header(const uint8_t* d, int64_t i, int64_t end, Header* h) {
  if (!parse_header(d + i, end - i, h)) return false;
  int64_t j = i + h->frame_bytes;
  Header next;
  if (j + 4 <= end) return parse_header(d + j, end - j, &next) && same_stream(*h, next);
  return j <= end;
}

struct TagInfo {
  bool present = false;
  int64_t frames = -1;
  int delay = -1, padding = -1;
};

// Xing/Info tag (and the LAME extension) in the first frame
TagInfo read_tag(const uint8_t* f, const Header& h) {
  TagInfo t;
  const uint8_t* p = f + 4 + (h.crc ? 2 : 0) + h.side_bytes;
  if (std::memcmp(p, "Xing", 4) != 0 && std::memcmp(p, "Info", 4) != 0) return t;
  t.present = true;
  uint32_t flags = (p[4] << 24) | (p[5] << 16) | (p[6] << 8) | p[7];
  const uint8_t* q = p + 8;
  if (flags & 1) {
    t.frames = (static_cast<int64_t>(q[0]) << 24) | (q[1] << 16) | (q[2] << 8) | q[3];
    q += 4;
  }
  if (flags & 2) q += 4;
  if (flags & 4) q += 100;
  if (flags & 8) q += 4;
  if (q + 24 <= f + h.frame_bytes &&
      (std::memcmp(q, "LAME", 4) == 0 || std::memcmp(q, "Lavc", 4) == 0 ||
       std::memcmp(q, "Lavf", 4) == 0)) {
    uint32_t dp = (q[21] << 16) | (q[22] << 8) | q[23];
    t.delay = dp >> 12;
    t.padding = dp & 0xFFF;
  }
  return t;
}

}  // namespace

extern "C" {

// Decode the mp3 file held in data[0:n]. On success returns 0 and sets
// *out to a malloc'd buffer of *n_samples frames of *channels interleaved
// int16 samples (free it with knnsvc_mp3_free), *sample_rate to the file's
// rate. Returns -1 when no Layer III frame is found.
int knnsvc_mp3_decode(const uint8_t* data, int64_t n, int16_t** out, int64_t* n_samples,
                      int* sample_rate, int* channels) {
  *out = nullptr;
  *n_samples = 0;
  int64_t end = audio_end(data, n);
  int64_t pos = id3v2_size(data, end);
  Header h;
  while (pos + 4 <= end && !confirmed_header(data, pos, end, &h)) ++pos;
  if (pos + 4 > end) return -1;
  int nch = h.channels;
  int spf = h.lsf ? 576 : 1152;
  *sample_rate = kSampleRate[h.sfreq];
  *channels = nch;
  TagInfo tag;
  {
    std::vector<uint8_t> first(data + pos, data + pos + (h.frame_bytes < end - pos ? h.frame_bytes : end - pos));
    first.resize(h.frame_bytes + 200, 0);
    tag = read_tag(first.data(), h);
  }
  Decoder dec;
  dec.h = h;
  std::vector<int16_t> pcm;
  pcm.reserve(static_cast<size_t>((end - pos) / (h.frame_bytes > 0 ? h.frame_bytes : 1) + 2) * spf * nch);
  if (tag.present) pos += h.frame_bytes;
  const Header first_h = h;
  std::vector<uint8_t> frame_buf;
  while (pos + 4 <= end) {
    Header fh;
    if (!parse_header(data + pos, end - pos, &fh) || !same_stream(fh, first_h)) {
      // lost sync: the next header that the following frame confirms
      ++pos;
      while (pos + 4 <= end && !(confirmed_header(data, pos, end, &fh) && same_stream(fh, first_h))) ++pos;
      dec.resync();
      continue;
    }
    if (pos + fh.frame_bytes > end) break;  // a truncated last frame
    dec.h = fh;
    frame_buf.assign(data + pos, data + pos + fh.frame_bytes);
    frame_buf.resize(fh.frame_bytes + 64, 0);
    size_t at = pcm.size();
    pcm.resize(at + static_cast<size_t>(spf) * nch);
    dec.decode_frame(frame_buf.data(), pcm.data() + at);
    pos += fh.frame_bytes;
  }
  int64_t total = static_cast<int64_t>(pcm.size()) / nch;
  int64_t begin = 0, stop = total;
  if (tag.present && tag.delay >= 0) {
    constexpr int kDecoderDelay = 529;
    int64_t declared = tag.frames >= 0 ? tag.frames * spf : total;
    begin = tag.delay + kDecoderDelay;
    stop = declared - tag.padding + kDecoderDelay;
    if (stop > total) stop = total;
    if (begin > stop) begin = stop;
  }
  int64_t count = stop - begin;
  int16_t* buf = static_cast<int16_t*>(std::malloc(static_cast<size_t>(count > 0 ? count : 1) * nch * sizeof(int16_t)));
  if (!buf) return -2;
  if (count > 0) std::memcpy(buf, pcm.data() + begin * nch, static_cast<size_t>(count) * nch * sizeof(int16_t));
  *out = buf;
  *n_samples = count;
  return 0;
}

void knnsvc_mp3_free(void* p) { std::free(p); }

}  // extern "C"
