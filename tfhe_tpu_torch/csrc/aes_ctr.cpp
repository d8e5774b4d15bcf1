// AES-128-CTR keystream kernels (AES-NI), the native core of the CSPRNG.
//
// Mirrors the role of tfhe-csprng's aesni backend: batched ECB encryption of
// little-endian counter blocks.  Exposed as a tiny C ABI for ctypes.
//
// Built at first use by tfhe_tpu_torch/utils/csprng.py (g++ -O3 -maes -msse4.1).

#include <cstdint>
#include <cstring>
#include <wmmintrin.h>
#include <emmintrin.h>

namespace {

struct AesKeySchedule {
    __m128i rk[11];
};

__m128i expand_step(__m128i key, __m128i keygened) {
    keygened = _mm_shuffle_epi32(keygened, _MM_SHUFFLE(3, 3, 3, 3));
    key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
    key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
    key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
    return _mm_xor_si128(key, keygened);
}

void key_expand(const uint8_t* key_bytes, AesKeySchedule& ks) {
    ks.rk[0] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(key_bytes));
#define EXPAND(i, rcon) \
    ks.rk[i] = expand_step(ks.rk[i - 1], _mm_aeskeygenassist_si128(ks.rk[i - 1], rcon));
    EXPAND(1, 0x01) EXPAND(2, 0x02) EXPAND(3, 0x04) EXPAND(4, 0x08)
    EXPAND(5, 0x10) EXPAND(6, 0x20) EXPAND(7, 0x40) EXPAND(8, 0x80)
    EXPAND(9, 0x1b) EXPAND(10, 0x36)
#undef EXPAND
}

inline __m128i encrypt_block(const AesKeySchedule& ks, __m128i m) {
    m = _mm_xor_si128(m, ks.rk[0]);
    for (int r = 1; r < 10; ++r) m = _mm_aesenc_si128(m, ks.rk[r]);
    return _mm_aesenclast_si128(m, ks.rk[10]);
}

}  // namespace

extern "C" {

// Fill `out` with n_blocks * 16 bytes: AES(key, LE128(ctr_lo/hi + i)).
// 8-wide pipelining to keep the AES units busy.
void tfhe_aes_ctr_blocks(const uint8_t* key_bytes, uint64_t ctr_lo,
                         uint64_t ctr_hi, uint64_t n_blocks, uint8_t* out) {
    AesKeySchedule ks;
    key_expand(key_bytes, ks);
    uint64_t lo = ctr_lo, hi = ctr_hi;
    uint64_t i = 0;
    auto next_ctr = [&]() {
        __m128i c = _mm_set_epi64x(static_cast<long long>(hi),
                                   static_cast<long long>(lo));
        if (++lo == 0) ++hi;
        return c;
    };
    for (; i + 8 <= n_blocks; i += 8) {
        __m128i b[8];
        for (int k = 0; k < 8; ++k) b[k] = _mm_xor_si128(next_ctr(), ks.rk[0]);
        for (int r = 1; r < 10; ++r)
            for (int k = 0; k < 8; ++k) b[k] = _mm_aesenc_si128(b[k], ks.rk[r]);
        for (int k = 0; k < 8; ++k) {
            b[k] = _mm_aesenclast_si128(b[k], ks.rk[10]);
            _mm_storeu_si128(reinterpret_cast<__m128i*>(out + (i + k) * 16), b[k]);
        }
    }
    for (; i < n_blocks; ++i) {
        __m128i c = encrypt_block(ks, next_ctr());
        _mm_storeu_si128(reinterpret_cast<__m128i*>(out + i * 16), c);
    }
}

}  // extern "C"
