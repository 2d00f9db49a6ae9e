// The equi-join's combined key hash of one row, shared by K6 (key_hash.cu,
// which writes it) and K4 (join_probe.cu, which probes with it and never
// writes it).
//
// Bit for bit the reference's ops/join_kernels.py combined_key_hash (and
// the port's plain version, ops/join_kernels.py combined_key_hash_plain):
// per key column a 64-bit value word (an integer sign-extended to 64 bits
// with its sign bit flipped; a double with -0.0 taken as 0.0, every NaN
// as the canonical one, then the order-preserving transform of
// ops/segmented.py encode_float_ordered; a string the word
// h1 ^ (h2 * MIX) of its two rolling hashes, which K14
// (csrc/string_hashes.cu) writes and the key reads as it is), mixed by
// splitmix64's
// finaliser and folded into the row's hash; a row with a null key gets
// the side's sentinel plus row * 2654435761 (wrapping) unless nulls
// match.  The reference's words are uint64, so unsigned arithmetic here
// needs no masked shifts.

#pragma once

namespace srt {

// Key column kinds (ops/join_kernels.py _KEY_KINDS).
constexpr int kKeyBool = 0;    // 1 B, 0 or 1
constexpr int kKeyInt = 1;     // 4 B signed
constexpr int kKeyLong = 2;    // 8 B signed
constexpr int kKeyDouble = 3;  // 8 B IEEE double
constexpr int kKeyString = 4;  // 8 B: the string's join word from K14

constexpr unsigned long long kHashSeed = 0x12345678DEADBEEFull;
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long kNullBuild = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long kNullProbe = 0xC2B2AE3D27D4EB4Full;
constexpr unsigned long long kNullStep = 2654435761ull;
constexpr unsigned long long kSignBit = 0x8000000000000000ull;

// The key columns of one side: a device array of 3 * count int64s, the
// data pointers, then the validity pointers (bool lanes), then the kinds.
struct KeyCols {
  const long long* desc;
  int count;
};

__device__ __forceinline__ unsigned long long mix64(unsigned long long h) {
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  return h ^ (h >> 31);
}

// The reference's uint64 value word of row i of a key column.
__device__ __forceinline__ unsigned long long key_word(const void* data,
                                                       int kind,
                                                       long long i) {
  if (kind == kKeyDouble) {
    long long bits = static_cast<const long long*>(data)[i];
    if ((bits & 0x7FFFFFFFFFFFFFFFll) == 0) {
      bits = 0;                                  // -0.0 -> 0.0
    } else if ((bits & 0x7FF0000000000000ll) == 0x7FF0000000000000ll &&
               (bits & 0x000FFFFFFFFFFFFFll) != 0) {
      bits = 0x7FF8000000000000ll;               // canonical NaN
    }
    const unsigned long long u = static_cast<unsigned long long>(bits);
    return bits < 0 ? ~u : (u | kSignBit);
  }
  if (kind == kKeyString)
    return static_cast<const unsigned long long*>(data)[i];
  long long v;
  if (kind == kKeyBool) {
    v = static_cast<const unsigned char*>(data)[i] != 0;
  } else if (kind == kKeyInt) {
    v = static_cast<const int*>(data)[i];
  } else {
    v = static_cast<const long long*>(data)[i];
  }
  return static_cast<unsigned long long>(v) ^ kSignBit;
}

// The combined hash of row i; sentinel is kNullBuild or kNullProbe, or 0
// when nulls match (null_matches: a null key hashes like any value).
__device__ __forceinline__ unsigned long long row_hash(const KeyCols& keys,
                                                       long long i,
                                                       bool null_matches,
                                                       unsigned long long
                                                           sentinel) {
  unsigned long long h = kHashSeed;
  bool any_null = false;
  for (int k = 0; k < keys.count; ++k) {
    const void* data =
        reinterpret_cast<const void*>(__ldg(keys.desc + k));
    const unsigned char* valid = reinterpret_cast<const unsigned char*>(
        __ldg(keys.desc + keys.count + k));
    const int kind = static_cast<int>(__ldg(keys.desc + 2 * keys.count + k));
    const unsigned long long w = mix64(key_word(data, kind, i));
    h = mix64(h ^ (w + kGolden + (h << 6) + (h >> 2)));
    any_null |= valid[i] == 0;
  }
  if (any_null && !null_matches)
    h = sentinel + static_cast<unsigned long long>(i) * kNullStep;
  return h;
}

}  // namespace srt
