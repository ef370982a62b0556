// Native host-side IO for kiss-tpu.
//
// Host counterpart of the reference's C++ ingest/serialization
// layer (reference: include/utils/io.hpp:6-18 read_sequence,
// include/biovoltron/file_io/fasta.hpp FastaRecord parsing,
// include/biovoltron/utility/archive/serializer.hpp raw blob IO,
// include/biovoltron/container/xbit_vector.hpp bit packing). The JAX
// compute path stays on device; this library keeps the host-side hot
// paths (multi-GB FASTA parsing, 2-bit packing) at native memory
// bandwidth instead of Python object churn. Exposed as a C ABI for
// ctypes.
//
// Build: make -C csrc   (produces build/libkiss_io.so)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// ASCII -> code table: A/a=0 C/c=1 G/g=2 T/t=3, everything else 4
// (reference: include/biovoltron/utility/istring.hpp:28-36)
struct CodeTable {
  int8_t t[256];
  CodeTable() {
    memset(t, 4, sizeof(t));
    t[(unsigned)'A'] = t[(unsigned)'a'] = 0;
    t[(unsigned)'C'] = t[(unsigned)'c'] = 1;
    t[(unsigned)'G'] = t[(unsigned)'g'] = 2;
    t[(unsigned)'T'] = t[(unsigned)'t'] = 3;
  }
};
const CodeTable kCodes;

}  // namespace

extern "C" {

// Parse a FASTA ('>' first byte), FASTQ ('@' first byte) or plain-text
// buffer into int8 codes, concatenating all records' sequence
// characters (reference read_sequence semantics: io.hpp:6-18). Returns
// the number of code bytes written to `out` (caller allocates >= n).
int64_t ki_parse_sequence(const char* data, int64_t n, int8_t* out) {
  int64_t w = 0;
  if (n <= 0) return 0;
  if (data[0] == '>') {  // FASTA
    int64_t i = 0;
    while (i < n) {
      if (data[i] == '>') {  // skip header line
        const char* nl = (const char*)memchr(data + i, '\n', n - i);
        if (!nl) break;
        i = nl - data + 1;
        continue;
      }
      const char* nl = (const char*)memchr(data + i, '\n', n - i);
      int64_t end = nl ? nl - data : n;
      for (int64_t j = i; j < end; j++) {
        unsigned char c = data[j];
        if (c != '\r') out[w++] = kCodes.t[c];
      }
      i = end + 1;
    }
  } else if (data[0] == '@') {  // FASTQ: 4-line records, line 2 is seq
    int64_t i = 0;
    int line = 0;
    while (i < n) {
      const char* nl = (const char*)memchr(data + i, '\n', n - i);
      int64_t end = nl ? nl - data : n;
      if (line % 4 == 1) {
        for (int64_t j = i; j < end; j++) {
          unsigned char c = data[j];
          if (c != '\r') out[w++] = kCodes.t[c];
        }
      }
      line++;
      i = end + 1;
    }
  } else {  // text mode: every line is sequence
    for (int64_t j = 0; j < n; j++) {
      unsigned char c = data[j];
      if (c != '\n' && c != '\r') out[w++] = kCodes.t[c];
    }
  }
  return w;
}

// In-place c % 4 alphabet fold (N -> A), the transform every reference
// command applies (reference: include/command/suffix_sort.hpp:33).
void ki_fold_acgt(int8_t* buf, int64_t n) {
  for (int64_t i = 0; i < n; i++) buf[i] &= 3;  // codes are 0..4; 4&3==0
}

// 2-bit pack, 4 values/byte LSB-first (reference DibitVector layout,
// xbit_vector.hpp:11-66). out must hold (n+3)/4 bytes.
void ki_pack_dibits(const int8_t* vals, int64_t n, uint8_t* out) {
  int64_t nb = n / 4;
  for (int64_t b = 0; b < nb; b++) {
    const int8_t* v = vals + b * 4;
    out[b] = (uint8_t)((v[0] & 3) | ((v[1] & 3) << 2) | ((v[2] & 3) << 4) |
                       ((v[3] & 3) << 6));
  }
  if (n % 4) {
    uint8_t acc = 0;
    for (int64_t j = nb * 4; j < n; j++)
      acc |= (uint8_t)((vals[j] & 3) << (2 * (j % 4)));
    out[nb] = acc;
  }
}

void ki_unpack_dibits(const uint8_t* blocks, int64_t n, int8_t* out) {
  for (int64_t i = 0; i < n; i++)
    out[i] = (int8_t)((blocks[i / 4] >> (2 * (i % 4))) & 3);
}

// 1-bit pack LSB-first into little-endian u64 blocks (reference
// XbitVector<1, uint64_t> layout). out must hold (n+63)/64 u64s, zeroed
// by this function.
void ki_pack_bits(const uint8_t* vals, int64_t n, uint64_t* out) {
  int64_t nb = (n + 63) / 64;
  memset(out, 0, (size_t)nb * 8);
  for (int64_t i = 0; i < n; i++)
    if (vals[i]) out[i / 64] |= 1ull << (i % 64);
}

}  // extern "C"
