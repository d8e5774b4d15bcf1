/* End-to-end test program of the C API over tfhe_tpu_torch
 * (scripts/c_api_tests.sh analog): exercises several widths, signed types,
 * comparisons, bools, and serialization round-trips through DynamicBuffer,
 * and prints the seconds a call of each kind.
 *
 * Usage: test_c_api [config_kind [device]]: config kind 0 (the fast
 * insecure test parameters, the default) or 1 (DEFAULT_PARAMS, the 2_2
 * set); device "cuda" (the default) or "cpu". */
#include <assert.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>
#include "tfhe_c.h"

static double now(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

/* time the call `stmt`, print "<name> <seconds>" */
#define TIMED(name, stmt)                                        \
    do {                                                         \
        double t0_ = now();                                      \
        stmt;                                                    \
        printf("seconds %s %.6f\n", name, now() - t0_);        \
    } while (0)

int main(int argc, char **argv) {
    const int config_kind = argc > 1 ? atoi(argv[1]) : 0;
    const char *device = argc > 2 ? argv[2] : "cuda";
    TfheClientKey *ck = NULL;
    TfheServerKey *sk = NULL;
    assert(tfhe_c_init() == 0);
    TIMED("generate_keys",
          assert(tfhe_generate_keys_on_device(config_kind, 77, device, &ck, &sk) == 0));
    assert(tfhe_set_server_key(sk) == 0);
    uint64_t v = 0;

    /* FheUint8 arithmetic */
    TfheFheUint8 *a = NULL, *b = NULL, *r = NULL;
    assert(tfhe_fheuint8_try_encrypt_with_client_key_u64(200, ck, &a) == 0);
    assert(tfhe_fheuint8_try_encrypt_with_client_key_u64(55, ck, &b) == 0);
    TIMED("fheuint8_add", assert(tfhe_fheuint8_add(a, b, &r) == 0));
    assert(tfhe_fheuint8_decrypt_u64(r, ck, &v) == 0);
    printf("u8: 200 + 55 = %llu\n", (unsigned long long)v);
    assert(v == 255);
    tfhe_fheuint8_destroy(r);
    TIMED("fheuint8_mul", assert(tfhe_fheuint8_mul(a, b, &r) == 0));
    assert(tfhe_fheuint8_decrypt_u64(r, ck, &v) == 0);
    assert(v == (uint8_t)(200 * 55));
    tfhe_fheuint8_destroy(r);
    assert(tfhe_fheuint8_scalar_add(a, 7, &r) == 0);
    assert(tfhe_fheuint8_decrypt_u64(r, ck, &v) == 0);
    assert(v == 207);
    tfhe_fheuint8_destroy(r);

    /* comparison -> FheBool, bool ops */
    TfheFheBool *cmp = NULL, *cmp2 = NULL, *band = NULL;
    TIMED("fheuint8_gt", assert(tfhe_fheuint8_gt(a, b, &cmp) == 0));
    int bv = 0;
    assert(tfhe_fhebool_decrypt(cmp, ck, &bv) == 0);
    printf("u8: 200 > 55 = %d\n", bv);
    assert(bv == 1);
    assert(tfhe_fheuint8_eq(a, b, &cmp2) == 0);
    assert(tfhe_fhebool_bitand(cmp, cmp2, &band) == 0);
    assert(tfhe_fhebool_decrypt(band, ck, &bv) == 0);
    assert(bv == 0);
    tfhe_fhebool_destroy(cmp2);
    tfhe_fhebool_destroy(band);

    /* serialization round-trip */
    DynamicBuffer buf = {0};
    assert(tfhe_fheuint8_serialize(a, &buf) == 0);
    printf("u8 serialized: %zu bytes\n", buf.length);
    TfheFheUint8 *a2 = NULL;
    assert(tfhe_fheuint8_deserialize(buf.pointer, buf.length, &a2) == 0);
    assert(tfhe_fheuint8_decrypt_u64(a2, ck, &v) == 0);
    assert(v == 200);
    destroy_dynamic_buffer(&buf);
    tfhe_fheuint8_destroy(a2);

    DynamicBuffer bbuf = {0};
    assert(tfhe_fhebool_serialize(cmp, &bbuf) == 0);
    TfheFheBool *cmp3 = NULL;
    assert(tfhe_fhebool_deserialize(bbuf.pointer, bbuf.length, &cmp3) == 0);
    assert(tfhe_fhebool_decrypt(cmp3, ck, &bv) == 0);
    assert(bv == 1);
    destroy_dynamic_buffer(&bbuf);
    tfhe_fhebool_destroy(cmp3);
    tfhe_fhebool_destroy(cmp);

    /* FheUint32: shifts, rotates, min/max */
    TfheFheUint32 *x = NULL, *y = NULL, *z = NULL;
    assert(tfhe_fheuint32_try_encrypt_with_client_key_u64(0x1234, ck, &x) == 0);
    TIMED("fheuint32_scalar_shl", assert(tfhe_fheuint32_scalar_shl(x, 4, &y) == 0));
    assert(tfhe_fheuint32_decrypt_u64(y, ck, &v) == 0);
    printf("u32: 0x1234 << 4 = 0x%llx\n", (unsigned long long)v);
    assert(v == 0x12340);
    assert(tfhe_fheuint32_min(x, y, &z) == 0);
    assert(tfhe_fheuint32_decrypt_u64(z, ck, &v) == 0);
    assert(v == 0x1234);
    tfhe_fheuint32_destroy(y);
    tfhe_fheuint32_destroy(z);
    TIMED("fheuint32_rotate_left", assert(tfhe_fheuint32_rotate_left(x, 28, &y) == 0));
    assert(tfhe_fheuint32_decrypt_u64(y, ck, &v) == 0);
    assert(v == ((0x1234ull << 28) | (0x1234ull >> 4)) % (1ull << 32));
    tfhe_fheuint32_destroy(y);
    tfhe_fheuint32_destroy(x);

    /* FheInt8: signed decrypt + neg */
    TfheFheInt8 *sa = NULL, *sn = NULL;
    assert(tfhe_fheint8_try_encrypt_with_client_key_u64(5, ck, &sa) == 0);
    TIMED("fheint8_neg", assert(tfhe_fheint8_neg(sa, &sn) == 0));
    int64_t sv = 0;
    assert(tfhe_fheint8_decrypt_i64(sn, ck, &sv) == 0);
    printf("i8: -(5) = %lld\n", (long long)sv);
    assert(sv == -5);
    tfhe_fheint8_destroy(sa);
    tfhe_fheint8_destroy(sn);

    /* trivial encrypt on a wide type + hex decrypt */
    TfheFheUint128 *w = NULL;
    assert(tfhe_fheuint128_try_encrypt_trivial_u64(0xdeadbeef, &w) == 0);
    char *hex = NULL;
    assert(tfhe_fheuint128_decrypt_hex(w, ck, &hex) == 0);
    printf("u128 trivial hex: %s\n", hex);
    free(hex);
    tfhe_fheuint128_destroy(w);

    tfhe_fheuint8_destroy(a);
    tfhe_fheuint8_destroy(b);
    tfhe_client_key_destroy(ck);
    tfhe_server_key_destroy(sk);
    printf("c_api: ALL OK\n");
    return 0;
}
