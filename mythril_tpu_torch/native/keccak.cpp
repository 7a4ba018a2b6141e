// Keccak-256 (pre-NIST padding 0x01) — the EVM hash.
// Role parity: the reference delegates concrete keccak to the eth-hash wheel
// (reference mythril/support/support_utils.py:94-101); this build carries its
// own native implementation since no hashing wheel is available.
#include <cstdint>
#include <cstring>

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline uint64_t rol(uint64_t x, int s) {
  return s ? (x << s) | (x >> (64 - s)) : x;
}

static void keccak_permute(uint64_t st[25]) {
  static const int PI[24] = {10, 7,  11, 17, 18, 3,  5,  16, 8,  21, 24, 4,
                             15, 23, 19, 13, 12, 2,  20, 14, 22, 9,  6,  1};
  static const int RHO[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                              27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
  uint64_t bc[5], t;
  for (int round = 0; round < 24; ++round) {
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; ++i) {
      t = bc[(i + 4) % 5] ^ rol(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    t = st[1];
    for (int i = 0; i < 24; ++i) {
      int j = PI[i];
      bc[0] = st[j];
      st[j] = rol(t, RHO[i]);
      t = bc[0];
    }
    for (int j = 0; j < 25; j += 5) {
      for (int i = 0; i < 5; ++i) bc[i] = st[j + i];
      for (int i = 0; i < 5; ++i)
        st[j + i] = bc[i] ^ ((~bc[(i + 1) % 5]) & bc[(i + 2) % 5]);
    }
    st[0] ^= RC[round];
  }
}

extern "C" void mtpu_keccak256(const uint8_t* data, uint64_t len,
                               uint8_t out[32]) {
  uint64_t st[25];
  std::memset(st, 0, sizeof(st));
  const uint64_t rate = 136;  // 1088-bit rate for keccak-256
  uint64_t i = 0;
  uint8_t block[136];
  while (len - i >= rate) {
    for (uint64_t w = 0; w < rate / 8; ++w) {
      uint64_t lane;
      std::memcpy(&lane, data + i + 8 * w, 8);
      st[w] ^= lane;  // little-endian host assumed
    }
    keccak_permute(st);
    i += rate;
  }
  // final partial block with multi-rate padding 0x01 ... 0x80
  std::memset(block, 0, rate);
  std::memcpy(block, data + i, len - i);
  block[len - i] = 0x01;
  block[rate - 1] |= 0x80;
  for (uint64_t w = 0; w < rate / 8; ++w) {
    uint64_t lane;
    std::memcpy(&lane, block + 8 * w, 8);
    st[w] ^= lane;
  }
  keccak_permute(st);
  std::memcpy(out, st, 32);
}
