/* GENERATED by c_api_torch/generate.py — do not edit by hand.
 * Generic core: embeds CPython hosting the PyTorch port (tfhe_tpu_torch,
 * its kernels on the card); handles are owned PyObject*.  All entry points
 * grab the GIL and return 0/nonzero.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>
#include "tfhe_c.h"

static PyObject *g_mod = NULL;        /* tfhe_tpu_torch */
static PyObject *g_ser = NULL;        /* tfhe_tpu_torch.utils.serialization */

int tfhe_c_init(void) {
    if (Py_IsInitialized() && g_mod) return 0;
    if (!Py_IsInitialized()) Py_Initialize();
    PyGILState_STATE st = PyGILState_Ensure();
    g_mod = PyImport_ImportModule("tfhe_tpu_torch");
    if (!g_mod) { PyErr_Print(); PyGILState_Release(st); return 1; }
    g_ser = PyImport_ImportModule("tfhe_tpu_torch.utils.serialization");
    if (!g_ser) { PyErr_Print(); PyGILState_Release(st); return 1; }
    PyGILState_Release(st);
    return 0;
}

int tfhe_c_deinit(void) {
    if (!Py_IsInitialized()) return 0;
    Py_XDECREF(g_mod); g_mod = NULL;
    Py_XDECREF(g_ser); g_ser = NULL;
    return Py_FinalizeEx() == 0 ? 0 : 1;
}

int destroy_dynamic_buffer(DynamicBuffer *buffer) {
    if (buffer && buffer->pointer) {
        free(buffer->pointer);
        buffer->pointer = NULL;
        buffer->length = 0;
    }
    return 0;
}

/* ---- generic core ----------------------------------------------------- */

static int c_fail(PyGILState_STATE st) {
    if (PyErr_Occurred()) PyErr_Print();
    PyGILState_Release(st);
    return 1;
}

static int c_encrypt_u64(const char *tname, uint64_t v, int trivial,
                         PyObject *ck, void **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *cls = PyObject_GetAttrString(g_mod, tname);
    if (!cls) return c_fail(st);
    PyObject *r = trivial
        ? PyObject_CallMethod(cls, "encrypt_trivial", "K", (unsigned long long)v)
        : PyObject_CallMethod(cls, "encrypt", "KO", (unsigned long long)v, ck);
    Py_DECREF(cls);
    if (!r) return c_fail(st);
    *out = r;
    PyGILState_Release(st);
    return 0;
}

static int c_decrypt_u64(PyObject *ct, PyObject *ck, uint64_t *out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(ct, "decrypt", "O", ck);
    if (!r) return c_fail(st);
    /* low 64 bits for wide types (callers needing more use _hex) */
    PyObject *mask = PyLong_FromUnsignedLongLong(0xFFFFFFFFFFFFFFFFULL);
    PyObject *m = PyNumber_And(r, mask);
    Py_DECREF(mask); Py_DECREF(r);
    if (!m) return c_fail(st);
    *out = PyLong_AsUnsignedLongLongMask(m);
    Py_DECREF(m);
    PyGILState_Release(st);
    return 0;
}

static int c_decrypt_i64(PyObject *ct, PyObject *ck, int64_t *out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(ct, "decrypt", "O", ck);
    if (!r) return c_fail(st);
    *out = (int64_t)PyLong_AsLongLongAndOverflow(r, &(int){0});
    if (PyErr_Occurred()) { PyErr_Clear(); *out = 0; }
    Py_DECREF(r);
    PyGILState_Release(st);
    return 0;
}

static int c_decrypt_hex(PyObject *ct, PyObject *ck, char **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(ct, "decrypt", "O", ck);
    if (!r) return c_fail(st);
    PyObject *h = PyNumber_ToBase(r, 16);
    Py_DECREF(r);
    if (!h) return c_fail(st);
    const char *s = PyUnicode_AsUTF8(h);
    *out = strdup(s);
    Py_DECREF(h);
    PyGILState_Release(st);
    return 0;
}

typedef PyObject *(*nb_binary)(PyObject *, PyObject *);

static int c_binop(PyObject *a, PyObject *b, nb_binary f, void **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = f(a, b);
    if (!r) return c_fail(st);
    *out = r;
    PyGILState_Release(st);
    return 0;
}

static int c_unop(PyObject *a, PyObject *(*f)(PyObject *), void **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = f(a);
    if (!r) return c_fail(st);
    *out = r;
    PyGILState_Release(st);
    return 0;
}

static int c_scalar_binop(PyObject *a, uint64_t s, nb_binary f, void **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *ps = PyLong_FromUnsignedLongLong((unsigned long long)s);
    PyObject *r = f(a, ps);
    Py_DECREF(ps);
    if (!r) return c_fail(st);
    *out = r;
    PyGILState_Release(st);
    return 0;
}

static int c_richcmp(PyObject *a, PyObject *b, int op, void **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_RichCompare(a, b, op);
    if (!r) return c_fail(st);
    *out = r;
    PyGILState_Release(st);
    return 0;
}

static int c_method1(PyObject *a, const char *meth, PyObject *b, void **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(a, meth, "O", b);
    if (!r) return c_fail(st);
    *out = r;
    PyGILState_Release(st);
    return 0;
}

static int c_method_u32(PyObject *a, const char *meth, uint32_t v, void **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(a, meth, "I", v);
    if (!r) return c_fail(st);
    *out = r;
    PyGILState_Release(st);
    return 0;
}

static int c_serialize(PyObject *ct, DynamicBuffer *buf) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *inner = PyObject_GetAttrString(ct, "inner");
    if (!inner) return c_fail(st);
    PyObject *b = PyObject_CallMethod(g_ser, "safe_serialize", "O", inner);
    Py_DECREF(inner);
    if (!b) return c_fail(st);
    char *data; Py_ssize_t len;
    if (PyBytes_AsStringAndSize(b, &data, &len) != 0) {
        Py_DECREF(b);
        return c_fail(st);
    }
    buf->pointer = (uint8_t *)malloc(len);
    memcpy(buf->pointer, data, len);
    buf->length = (size_t)len;
    Py_DECREF(b);
    PyGILState_Release(st);
    return 0;
}

static int c_deserialize(const char *tname, const uint8_t *data, size_t len,
                         void **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *bytes = PyBytes_FromStringAndSize((const char *)data, (Py_ssize_t)len);
    PyObject *inner = PyObject_CallMethod(g_ser, "safe_deserialize", "O", bytes);
    Py_DECREF(bytes);
    if (!inner) return c_fail(st);
    PyObject *cls = PyObject_GetAttrString(g_mod, tname);
    if (!cls) { Py_DECREF(inner); return c_fail(st); }
    PyObject *obj = PyObject_CallFunction(cls, "O", inner);
    Py_DECREF(cls); Py_DECREF(inner);
    if (!obj) return c_fail(st);
    *out = obj;
    PyGILState_Release(st);
    return 0;
}

static int c_destroy(void *h) {
    if (!h) return 0;
    PyGILState_STATE st = PyGILState_Ensure();
    Py_DECREF((PyObject *)h);
    PyGILState_Release(st);
    return 0;
}

/* ---- keys ------------------------------------------------------------- */

int tfhe_generate_keys_on_device(int config_kind, uint64_t seed, const char *device,
                                 TfheClientKey **client_key, TfheServerKey **server_key) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *sh = PyImport_ImportModule("tfhe_tpu_torch.shortint");
    if (!sh) return c_fail(st);
    PyObject *params = PyObject_GetAttrString(
        sh, config_kind == 0 ? "TEST_PARAM_MESSAGE_2_CARRY_2" : "DEFAULT_PARAMS");
    Py_DECREF(sh);
    if (!params) return c_fail(st);
    PyObject *cb_cls = PyObject_GetAttrString(g_mod, "ConfigBuilder");
    PyObject *cb = PyObject_CallFunction(cb_cls, NULL);
    Py_DECREF(cb_cls);
    PyObject *cb2 = PyObject_CallMethod(cb, "use_custom_parameters", "O", params);
    Py_DECREF(cb); Py_DECREF(params);
    PyObject *cfg = PyObject_CallMethod(cb2, "build", NULL);
    Py_DECREF(cb2);
    if (!cfg) return c_fail(st);
    PyObject *fn = PyObject_GetAttrString(g_mod, "generate_keys");
    PyObject *args = Py_BuildValue("(OK)", cfg, (unsigned long long)seed);
    PyObject *kwargs = Py_BuildValue("{s:s}", "device", device);
    Py_DECREF(cfg);
    PyObject *pair = (fn && args && kwargs) ? PyObject_Call(fn, args, kwargs) : NULL;
    Py_XDECREF(fn); Py_XDECREF(args); Py_XDECREF(kwargs);
    if (!pair) return c_fail(st);
    PyObject *ck = PyTuple_GetItem(pair, 0);
    PyObject *sk = PyTuple_GetItem(pair, 1);
    Py_INCREF(ck); Py_INCREF(sk);
    *client_key = (TfheClientKey *)ck;
    *server_key = (TfheServerKey *)sk;
    Py_DECREF(pair);
    PyGILState_Release(st);
    return 0;
}

int tfhe_generate_keys(int config_kind, uint64_t seed,
                       TfheClientKey **client_key, TfheServerKey **server_key) {
    return tfhe_generate_keys_on_device(config_kind, seed, "cuda", client_key, server_key);
}

int tfhe_set_server_key(TfheServerKey *server_key) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod(g_mod, "set_server_key", "O",
                                      (PyObject *)server_key);
    if (!r) return c_fail(st);
    Py_DECREF(r);
    PyGILState_Release(st);
    return 0;
}

int tfhe_client_key_destroy(TfheClientKey *k) { return c_destroy(k); }
int tfhe_server_key_destroy(TfheServerKey *k) { return c_destroy(k); }

/* ---- FheBool ---------------------------------------------------------- */

int tfhe_fhebool_try_encrypt_with_client_key(int value, TfheClientKey *key,
                                             TfheFheBool **out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *cls = PyObject_GetAttrString(g_mod, "FheBool");
    if (!cls) return c_fail(st);
    PyObject *r = PyObject_CallMethod(cls, "encrypt", "OO",
                                      value ? Py_True : Py_False, (PyObject *)key);
    Py_DECREF(cls);
    if (!r) return c_fail(st);
    *out = (TfheFheBool *)r;
    PyGILState_Release(st);
    return 0;
}

int tfhe_fhebool_decrypt(TfheFheBool *ct, TfheClientKey *key, int *out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *r = PyObject_CallMethod((PyObject *)ct, "decrypt", "O", (PyObject *)key);
    if (!r) return c_fail(st);
    *out = PyObject_IsTrue(r);
    Py_DECREF(r);
    PyGILState_Release(st);
    return 0;
}

int tfhe_fhebool_bitand(TfheFheBool *a, TfheFheBool *b, TfheFheBool **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }
int tfhe_fhebool_bitor(TfheFheBool *a, TfheFheBool *b, TfheFheBool **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }
int tfhe_fhebool_bitxor(TfheFheBool *a, TfheFheBool *b, TfheFheBool **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }
int tfhe_fhebool_not(TfheFheBool *a, TfheFheBool **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }
int tfhe_fhebool_serialize(TfheFheBool *ct, DynamicBuffer *out) {
    PyGILState_STATE st = PyGILState_Ensure();
    PyObject *inner = PyObject_GetAttrString((PyObject *)ct, "inner");
    if (!inner) return c_fail(st);
    PyObject *b = PyObject_CallMethod(g_ser, "safe_serialize", "O", inner);
    Py_DECREF(inner);
    if (!b) return c_fail(st);
    char *data; Py_ssize_t len;
    PyBytes_AsStringAndSize(b, &data, &len);
    out->pointer = (uint8_t *)malloc(len);
    memcpy(out->pointer, data, len);
    out->length = (size_t)len;
    Py_DECREF(b);
    PyGILState_Release(st);
    return 0;
}
int tfhe_fhebool_deserialize(const uint8_t *data, size_t len, TfheFheBool **out)
{ return c_deserialize("FheBool", data, len, (void **)out); }
int tfhe_fhebool_destroy(TfheFheBool *ct) { return c_destroy(ct); }


int tfhe_fheuint2_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint2 **out)
{ return c_encrypt_u64("FheUint2", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint2_try_encrypt_trivial_u64(uint64_t value, TfheFheUint2 **out)
{ return c_encrypt_u64("FheUint2", value, 1, NULL, (void **)out); }

int tfhe_fheuint2_decrypt_u64(TfheFheUint2 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint2_decrypt_hex(TfheFheUint2 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint2_add(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint2_sub(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint2_mul(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint2_div(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint2_rem(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint2_bitand(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint2_bitor(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint2_bitxor(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint2_scalar_add(TfheFheUint2 *a, uint64_t b, TfheFheUint2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint2_scalar_sub(TfheFheUint2 *a, uint64_t b, TfheFheUint2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint2_scalar_mul(TfheFheUint2 *a, uint64_t b, TfheFheUint2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint2_scalar_shl(TfheFheUint2 *a, uint64_t b, TfheFheUint2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint2_scalar_shr(TfheFheUint2 *a, uint64_t b, TfheFheUint2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint2_ge(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint2_gt(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint2_le(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint2_lt(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint2_eq(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint2_ne(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint2_min(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint2_max(TfheFheUint2 *a, TfheFheUint2 *b, TfheFheUint2 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint2_rotate_left(TfheFheUint2 *a, uint32_t b, TfheFheUint2 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint2_rotate_right(TfheFheUint2 *a, uint32_t b, TfheFheUint2 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint2_neg(TfheFheUint2 *a, TfheFheUint2 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint2_not(TfheFheUint2 *a, TfheFheUint2 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint2_serialize(TfheFheUint2 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint2_deserialize(const uint8_t *data, size_t len, TfheFheUint2 **out)
{ return c_deserialize("FheUint2", data, len, (void **)out); }

int tfhe_fheuint2_destroy(TfheFheUint2 *ct) { return c_destroy(ct); }

int tfhe_fheuint4_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint4 **out)
{ return c_encrypt_u64("FheUint4", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint4_try_encrypt_trivial_u64(uint64_t value, TfheFheUint4 **out)
{ return c_encrypt_u64("FheUint4", value, 1, NULL, (void **)out); }

int tfhe_fheuint4_decrypt_u64(TfheFheUint4 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint4_decrypt_hex(TfheFheUint4 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint4_add(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint4_sub(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint4_mul(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint4_div(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint4_rem(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint4_bitand(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint4_bitor(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint4_bitxor(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint4_scalar_add(TfheFheUint4 *a, uint64_t b, TfheFheUint4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint4_scalar_sub(TfheFheUint4 *a, uint64_t b, TfheFheUint4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint4_scalar_mul(TfheFheUint4 *a, uint64_t b, TfheFheUint4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint4_scalar_shl(TfheFheUint4 *a, uint64_t b, TfheFheUint4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint4_scalar_shr(TfheFheUint4 *a, uint64_t b, TfheFheUint4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint4_ge(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint4_gt(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint4_le(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint4_lt(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint4_eq(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint4_ne(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint4_min(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint4_max(TfheFheUint4 *a, TfheFheUint4 *b, TfheFheUint4 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint4_rotate_left(TfheFheUint4 *a, uint32_t b, TfheFheUint4 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint4_rotate_right(TfheFheUint4 *a, uint32_t b, TfheFheUint4 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint4_neg(TfheFheUint4 *a, TfheFheUint4 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint4_not(TfheFheUint4 *a, TfheFheUint4 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint4_serialize(TfheFheUint4 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint4_deserialize(const uint8_t *data, size_t len, TfheFheUint4 **out)
{ return c_deserialize("FheUint4", data, len, (void **)out); }

int tfhe_fheuint4_destroy(TfheFheUint4 *ct) { return c_destroy(ct); }

int tfhe_fheuint6_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint6 **out)
{ return c_encrypt_u64("FheUint6", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint6_try_encrypt_trivial_u64(uint64_t value, TfheFheUint6 **out)
{ return c_encrypt_u64("FheUint6", value, 1, NULL, (void **)out); }

int tfhe_fheuint6_decrypt_u64(TfheFheUint6 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint6_decrypt_hex(TfheFheUint6 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint6_add(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint6_sub(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint6_mul(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint6_div(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint6_rem(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint6_bitand(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint6_bitor(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint6_bitxor(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint6_scalar_add(TfheFheUint6 *a, uint64_t b, TfheFheUint6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint6_scalar_sub(TfheFheUint6 *a, uint64_t b, TfheFheUint6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint6_scalar_mul(TfheFheUint6 *a, uint64_t b, TfheFheUint6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint6_scalar_shl(TfheFheUint6 *a, uint64_t b, TfheFheUint6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint6_scalar_shr(TfheFheUint6 *a, uint64_t b, TfheFheUint6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint6_ge(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint6_gt(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint6_le(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint6_lt(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint6_eq(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint6_ne(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint6_min(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint6_max(TfheFheUint6 *a, TfheFheUint6 *b, TfheFheUint6 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint6_rotate_left(TfheFheUint6 *a, uint32_t b, TfheFheUint6 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint6_rotate_right(TfheFheUint6 *a, uint32_t b, TfheFheUint6 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint6_neg(TfheFheUint6 *a, TfheFheUint6 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint6_not(TfheFheUint6 *a, TfheFheUint6 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint6_serialize(TfheFheUint6 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint6_deserialize(const uint8_t *data, size_t len, TfheFheUint6 **out)
{ return c_deserialize("FheUint6", data, len, (void **)out); }

int tfhe_fheuint6_destroy(TfheFheUint6 *ct) { return c_destroy(ct); }

int tfhe_fheuint8_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint8 **out)
{ return c_encrypt_u64("FheUint8", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint8_try_encrypt_trivial_u64(uint64_t value, TfheFheUint8 **out)
{ return c_encrypt_u64("FheUint8", value, 1, NULL, (void **)out); }

int tfhe_fheuint8_decrypt_u64(TfheFheUint8 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint8_decrypt_hex(TfheFheUint8 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint8_add(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint8_sub(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint8_mul(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint8_div(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint8_rem(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint8_bitand(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint8_bitor(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint8_bitxor(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint8_scalar_add(TfheFheUint8 *a, uint64_t b, TfheFheUint8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint8_scalar_sub(TfheFheUint8 *a, uint64_t b, TfheFheUint8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint8_scalar_mul(TfheFheUint8 *a, uint64_t b, TfheFheUint8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint8_scalar_shl(TfheFheUint8 *a, uint64_t b, TfheFheUint8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint8_scalar_shr(TfheFheUint8 *a, uint64_t b, TfheFheUint8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint8_ge(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint8_gt(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint8_le(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint8_lt(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint8_eq(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint8_ne(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint8_min(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint8_max(TfheFheUint8 *a, TfheFheUint8 *b, TfheFheUint8 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint8_rotate_left(TfheFheUint8 *a, uint32_t b, TfheFheUint8 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint8_rotate_right(TfheFheUint8 *a, uint32_t b, TfheFheUint8 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint8_neg(TfheFheUint8 *a, TfheFheUint8 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint8_not(TfheFheUint8 *a, TfheFheUint8 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint8_serialize(TfheFheUint8 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint8_deserialize(const uint8_t *data, size_t len, TfheFheUint8 **out)
{ return c_deserialize("FheUint8", data, len, (void **)out); }

int tfhe_fheuint8_destroy(TfheFheUint8 *ct) { return c_destroy(ct); }

int tfhe_fheuint10_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint10 **out)
{ return c_encrypt_u64("FheUint10", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint10_try_encrypt_trivial_u64(uint64_t value, TfheFheUint10 **out)
{ return c_encrypt_u64("FheUint10", value, 1, NULL, (void **)out); }

int tfhe_fheuint10_decrypt_u64(TfheFheUint10 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint10_decrypt_hex(TfheFheUint10 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint10_add(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint10_sub(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint10_mul(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint10_div(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint10_rem(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint10_bitand(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint10_bitor(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint10_bitxor(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint10_scalar_add(TfheFheUint10 *a, uint64_t b, TfheFheUint10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint10_scalar_sub(TfheFheUint10 *a, uint64_t b, TfheFheUint10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint10_scalar_mul(TfheFheUint10 *a, uint64_t b, TfheFheUint10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint10_scalar_shl(TfheFheUint10 *a, uint64_t b, TfheFheUint10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint10_scalar_shr(TfheFheUint10 *a, uint64_t b, TfheFheUint10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint10_ge(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint10_gt(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint10_le(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint10_lt(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint10_eq(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint10_ne(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint10_min(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint10_max(TfheFheUint10 *a, TfheFheUint10 *b, TfheFheUint10 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint10_rotate_left(TfheFheUint10 *a, uint32_t b, TfheFheUint10 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint10_rotate_right(TfheFheUint10 *a, uint32_t b, TfheFheUint10 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint10_neg(TfheFheUint10 *a, TfheFheUint10 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint10_not(TfheFheUint10 *a, TfheFheUint10 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint10_serialize(TfheFheUint10 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint10_deserialize(const uint8_t *data, size_t len, TfheFheUint10 **out)
{ return c_deserialize("FheUint10", data, len, (void **)out); }

int tfhe_fheuint10_destroy(TfheFheUint10 *ct) { return c_destroy(ct); }

int tfhe_fheuint12_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint12 **out)
{ return c_encrypt_u64("FheUint12", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint12_try_encrypt_trivial_u64(uint64_t value, TfheFheUint12 **out)
{ return c_encrypt_u64("FheUint12", value, 1, NULL, (void **)out); }

int tfhe_fheuint12_decrypt_u64(TfheFheUint12 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint12_decrypt_hex(TfheFheUint12 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint12_add(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint12_sub(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint12_mul(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint12_div(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint12_rem(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint12_bitand(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint12_bitor(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint12_bitxor(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint12_scalar_add(TfheFheUint12 *a, uint64_t b, TfheFheUint12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint12_scalar_sub(TfheFheUint12 *a, uint64_t b, TfheFheUint12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint12_scalar_mul(TfheFheUint12 *a, uint64_t b, TfheFheUint12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint12_scalar_shl(TfheFheUint12 *a, uint64_t b, TfheFheUint12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint12_scalar_shr(TfheFheUint12 *a, uint64_t b, TfheFheUint12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint12_ge(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint12_gt(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint12_le(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint12_lt(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint12_eq(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint12_ne(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint12_min(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint12_max(TfheFheUint12 *a, TfheFheUint12 *b, TfheFheUint12 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint12_rotate_left(TfheFheUint12 *a, uint32_t b, TfheFheUint12 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint12_rotate_right(TfheFheUint12 *a, uint32_t b, TfheFheUint12 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint12_neg(TfheFheUint12 *a, TfheFheUint12 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint12_not(TfheFheUint12 *a, TfheFheUint12 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint12_serialize(TfheFheUint12 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint12_deserialize(const uint8_t *data, size_t len, TfheFheUint12 **out)
{ return c_deserialize("FheUint12", data, len, (void **)out); }

int tfhe_fheuint12_destroy(TfheFheUint12 *ct) { return c_destroy(ct); }

int tfhe_fheuint14_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint14 **out)
{ return c_encrypt_u64("FheUint14", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint14_try_encrypt_trivial_u64(uint64_t value, TfheFheUint14 **out)
{ return c_encrypt_u64("FheUint14", value, 1, NULL, (void **)out); }

int tfhe_fheuint14_decrypt_u64(TfheFheUint14 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint14_decrypt_hex(TfheFheUint14 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint14_add(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint14_sub(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint14_mul(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint14_div(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint14_rem(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint14_bitand(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint14_bitor(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint14_bitxor(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint14_scalar_add(TfheFheUint14 *a, uint64_t b, TfheFheUint14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint14_scalar_sub(TfheFheUint14 *a, uint64_t b, TfheFheUint14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint14_scalar_mul(TfheFheUint14 *a, uint64_t b, TfheFheUint14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint14_scalar_shl(TfheFheUint14 *a, uint64_t b, TfheFheUint14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint14_scalar_shr(TfheFheUint14 *a, uint64_t b, TfheFheUint14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint14_ge(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint14_gt(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint14_le(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint14_lt(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint14_eq(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint14_ne(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint14_min(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint14_max(TfheFheUint14 *a, TfheFheUint14 *b, TfheFheUint14 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint14_rotate_left(TfheFheUint14 *a, uint32_t b, TfheFheUint14 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint14_rotate_right(TfheFheUint14 *a, uint32_t b, TfheFheUint14 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint14_neg(TfheFheUint14 *a, TfheFheUint14 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint14_not(TfheFheUint14 *a, TfheFheUint14 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint14_serialize(TfheFheUint14 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint14_deserialize(const uint8_t *data, size_t len, TfheFheUint14 **out)
{ return c_deserialize("FheUint14", data, len, (void **)out); }

int tfhe_fheuint14_destroy(TfheFheUint14 *ct) { return c_destroy(ct); }

int tfhe_fheuint16_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint16 **out)
{ return c_encrypt_u64("FheUint16", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint16_try_encrypt_trivial_u64(uint64_t value, TfheFheUint16 **out)
{ return c_encrypt_u64("FheUint16", value, 1, NULL, (void **)out); }

int tfhe_fheuint16_decrypt_u64(TfheFheUint16 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint16_decrypt_hex(TfheFheUint16 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint16_add(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint16_sub(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint16_mul(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint16_div(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint16_rem(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint16_bitand(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint16_bitor(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint16_bitxor(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint16_scalar_add(TfheFheUint16 *a, uint64_t b, TfheFheUint16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint16_scalar_sub(TfheFheUint16 *a, uint64_t b, TfheFheUint16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint16_scalar_mul(TfheFheUint16 *a, uint64_t b, TfheFheUint16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint16_scalar_shl(TfheFheUint16 *a, uint64_t b, TfheFheUint16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint16_scalar_shr(TfheFheUint16 *a, uint64_t b, TfheFheUint16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint16_ge(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint16_gt(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint16_le(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint16_lt(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint16_eq(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint16_ne(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint16_min(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint16_max(TfheFheUint16 *a, TfheFheUint16 *b, TfheFheUint16 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint16_rotate_left(TfheFheUint16 *a, uint32_t b, TfheFheUint16 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint16_rotate_right(TfheFheUint16 *a, uint32_t b, TfheFheUint16 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint16_neg(TfheFheUint16 *a, TfheFheUint16 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint16_not(TfheFheUint16 *a, TfheFheUint16 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint16_serialize(TfheFheUint16 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint16_deserialize(const uint8_t *data, size_t len, TfheFheUint16 **out)
{ return c_deserialize("FheUint16", data, len, (void **)out); }

int tfhe_fheuint16_destroy(TfheFheUint16 *ct) { return c_destroy(ct); }

int tfhe_fheuint24_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint24 **out)
{ return c_encrypt_u64("FheUint24", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint24_try_encrypt_trivial_u64(uint64_t value, TfheFheUint24 **out)
{ return c_encrypt_u64("FheUint24", value, 1, NULL, (void **)out); }

int tfhe_fheuint24_decrypt_u64(TfheFheUint24 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint24_decrypt_hex(TfheFheUint24 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint24_add(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint24_sub(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint24_mul(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint24_div(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint24_rem(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint24_bitand(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint24_bitor(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint24_bitxor(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint24_scalar_add(TfheFheUint24 *a, uint64_t b, TfheFheUint24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint24_scalar_sub(TfheFheUint24 *a, uint64_t b, TfheFheUint24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint24_scalar_mul(TfheFheUint24 *a, uint64_t b, TfheFheUint24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint24_scalar_shl(TfheFheUint24 *a, uint64_t b, TfheFheUint24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint24_scalar_shr(TfheFheUint24 *a, uint64_t b, TfheFheUint24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint24_ge(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint24_gt(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint24_le(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint24_lt(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint24_eq(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint24_ne(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint24_min(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint24_max(TfheFheUint24 *a, TfheFheUint24 *b, TfheFheUint24 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint24_rotate_left(TfheFheUint24 *a, uint32_t b, TfheFheUint24 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint24_rotate_right(TfheFheUint24 *a, uint32_t b, TfheFheUint24 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint24_neg(TfheFheUint24 *a, TfheFheUint24 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint24_not(TfheFheUint24 *a, TfheFheUint24 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint24_serialize(TfheFheUint24 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint24_deserialize(const uint8_t *data, size_t len, TfheFheUint24 **out)
{ return c_deserialize("FheUint24", data, len, (void **)out); }

int tfhe_fheuint24_destroy(TfheFheUint24 *ct) { return c_destroy(ct); }

int tfhe_fheuint32_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint32 **out)
{ return c_encrypt_u64("FheUint32", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint32_try_encrypt_trivial_u64(uint64_t value, TfheFheUint32 **out)
{ return c_encrypt_u64("FheUint32", value, 1, NULL, (void **)out); }

int tfhe_fheuint32_decrypt_u64(TfheFheUint32 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint32_decrypt_hex(TfheFheUint32 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint32_add(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint32_sub(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint32_mul(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint32_div(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint32_rem(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint32_bitand(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint32_bitor(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint32_bitxor(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint32_scalar_add(TfheFheUint32 *a, uint64_t b, TfheFheUint32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint32_scalar_sub(TfheFheUint32 *a, uint64_t b, TfheFheUint32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint32_scalar_mul(TfheFheUint32 *a, uint64_t b, TfheFheUint32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint32_scalar_shl(TfheFheUint32 *a, uint64_t b, TfheFheUint32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint32_scalar_shr(TfheFheUint32 *a, uint64_t b, TfheFheUint32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint32_ge(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint32_gt(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint32_le(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint32_lt(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint32_eq(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint32_ne(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint32_min(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint32_max(TfheFheUint32 *a, TfheFheUint32 *b, TfheFheUint32 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint32_rotate_left(TfheFheUint32 *a, uint32_t b, TfheFheUint32 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint32_rotate_right(TfheFheUint32 *a, uint32_t b, TfheFheUint32 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint32_neg(TfheFheUint32 *a, TfheFheUint32 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint32_not(TfheFheUint32 *a, TfheFheUint32 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint32_serialize(TfheFheUint32 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint32_deserialize(const uint8_t *data, size_t len, TfheFheUint32 **out)
{ return c_deserialize("FheUint32", data, len, (void **)out); }

int tfhe_fheuint32_destroy(TfheFheUint32 *ct) { return c_destroy(ct); }

int tfhe_fheuint40_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint40 **out)
{ return c_encrypt_u64("FheUint40", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint40_try_encrypt_trivial_u64(uint64_t value, TfheFheUint40 **out)
{ return c_encrypt_u64("FheUint40", value, 1, NULL, (void **)out); }

int tfhe_fheuint40_decrypt_u64(TfheFheUint40 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint40_decrypt_hex(TfheFheUint40 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint40_add(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint40_sub(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint40_mul(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint40_div(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint40_rem(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint40_bitand(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint40_bitor(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint40_bitxor(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint40_scalar_add(TfheFheUint40 *a, uint64_t b, TfheFheUint40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint40_scalar_sub(TfheFheUint40 *a, uint64_t b, TfheFheUint40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint40_scalar_mul(TfheFheUint40 *a, uint64_t b, TfheFheUint40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint40_scalar_shl(TfheFheUint40 *a, uint64_t b, TfheFheUint40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint40_scalar_shr(TfheFheUint40 *a, uint64_t b, TfheFheUint40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint40_ge(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint40_gt(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint40_le(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint40_lt(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint40_eq(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint40_ne(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint40_min(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint40_max(TfheFheUint40 *a, TfheFheUint40 *b, TfheFheUint40 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint40_rotate_left(TfheFheUint40 *a, uint32_t b, TfheFheUint40 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint40_rotate_right(TfheFheUint40 *a, uint32_t b, TfheFheUint40 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint40_neg(TfheFheUint40 *a, TfheFheUint40 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint40_not(TfheFheUint40 *a, TfheFheUint40 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint40_serialize(TfheFheUint40 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint40_deserialize(const uint8_t *data, size_t len, TfheFheUint40 **out)
{ return c_deserialize("FheUint40", data, len, (void **)out); }

int tfhe_fheuint40_destroy(TfheFheUint40 *ct) { return c_destroy(ct); }

int tfhe_fheuint48_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint48 **out)
{ return c_encrypt_u64("FheUint48", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint48_try_encrypt_trivial_u64(uint64_t value, TfheFheUint48 **out)
{ return c_encrypt_u64("FheUint48", value, 1, NULL, (void **)out); }

int tfhe_fheuint48_decrypt_u64(TfheFheUint48 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint48_decrypt_hex(TfheFheUint48 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint48_add(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint48_sub(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint48_mul(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint48_div(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint48_rem(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint48_bitand(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint48_bitor(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint48_bitxor(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint48_scalar_add(TfheFheUint48 *a, uint64_t b, TfheFheUint48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint48_scalar_sub(TfheFheUint48 *a, uint64_t b, TfheFheUint48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint48_scalar_mul(TfheFheUint48 *a, uint64_t b, TfheFheUint48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint48_scalar_shl(TfheFheUint48 *a, uint64_t b, TfheFheUint48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint48_scalar_shr(TfheFheUint48 *a, uint64_t b, TfheFheUint48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint48_ge(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint48_gt(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint48_le(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint48_lt(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint48_eq(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint48_ne(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint48_min(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint48_max(TfheFheUint48 *a, TfheFheUint48 *b, TfheFheUint48 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint48_rotate_left(TfheFheUint48 *a, uint32_t b, TfheFheUint48 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint48_rotate_right(TfheFheUint48 *a, uint32_t b, TfheFheUint48 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint48_neg(TfheFheUint48 *a, TfheFheUint48 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint48_not(TfheFheUint48 *a, TfheFheUint48 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint48_serialize(TfheFheUint48 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint48_deserialize(const uint8_t *data, size_t len, TfheFheUint48 **out)
{ return c_deserialize("FheUint48", data, len, (void **)out); }

int tfhe_fheuint48_destroy(TfheFheUint48 *ct) { return c_destroy(ct); }

int tfhe_fheuint56_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint56 **out)
{ return c_encrypt_u64("FheUint56", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint56_try_encrypt_trivial_u64(uint64_t value, TfheFheUint56 **out)
{ return c_encrypt_u64("FheUint56", value, 1, NULL, (void **)out); }

int tfhe_fheuint56_decrypt_u64(TfheFheUint56 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint56_decrypt_hex(TfheFheUint56 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint56_add(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint56_sub(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint56_mul(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint56_div(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint56_rem(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint56_bitand(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint56_bitor(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint56_bitxor(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint56_scalar_add(TfheFheUint56 *a, uint64_t b, TfheFheUint56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint56_scalar_sub(TfheFheUint56 *a, uint64_t b, TfheFheUint56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint56_scalar_mul(TfheFheUint56 *a, uint64_t b, TfheFheUint56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint56_scalar_shl(TfheFheUint56 *a, uint64_t b, TfheFheUint56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint56_scalar_shr(TfheFheUint56 *a, uint64_t b, TfheFheUint56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint56_ge(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint56_gt(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint56_le(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint56_lt(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint56_eq(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint56_ne(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint56_min(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint56_max(TfheFheUint56 *a, TfheFheUint56 *b, TfheFheUint56 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint56_rotate_left(TfheFheUint56 *a, uint32_t b, TfheFheUint56 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint56_rotate_right(TfheFheUint56 *a, uint32_t b, TfheFheUint56 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint56_neg(TfheFheUint56 *a, TfheFheUint56 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint56_not(TfheFheUint56 *a, TfheFheUint56 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint56_serialize(TfheFheUint56 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint56_deserialize(const uint8_t *data, size_t len, TfheFheUint56 **out)
{ return c_deserialize("FheUint56", data, len, (void **)out); }

int tfhe_fheuint56_destroy(TfheFheUint56 *ct) { return c_destroy(ct); }

int tfhe_fheuint64_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint64 **out)
{ return c_encrypt_u64("FheUint64", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint64_try_encrypt_trivial_u64(uint64_t value, TfheFheUint64 **out)
{ return c_encrypt_u64("FheUint64", value, 1, NULL, (void **)out); }

int tfhe_fheuint64_decrypt_u64(TfheFheUint64 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint64_decrypt_hex(TfheFheUint64 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint64_add(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint64_sub(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint64_mul(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint64_div(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint64_rem(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint64_bitand(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint64_bitor(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint64_bitxor(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint64_scalar_add(TfheFheUint64 *a, uint64_t b, TfheFheUint64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint64_scalar_sub(TfheFheUint64 *a, uint64_t b, TfheFheUint64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint64_scalar_mul(TfheFheUint64 *a, uint64_t b, TfheFheUint64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint64_scalar_shl(TfheFheUint64 *a, uint64_t b, TfheFheUint64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint64_scalar_shr(TfheFheUint64 *a, uint64_t b, TfheFheUint64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint64_ge(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint64_gt(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint64_le(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint64_lt(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint64_eq(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint64_ne(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint64_min(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint64_max(TfheFheUint64 *a, TfheFheUint64 *b, TfheFheUint64 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint64_rotate_left(TfheFheUint64 *a, uint32_t b, TfheFheUint64 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint64_rotate_right(TfheFheUint64 *a, uint32_t b, TfheFheUint64 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint64_neg(TfheFheUint64 *a, TfheFheUint64 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint64_not(TfheFheUint64 *a, TfheFheUint64 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint64_serialize(TfheFheUint64 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint64_deserialize(const uint8_t *data, size_t len, TfheFheUint64 **out)
{ return c_deserialize("FheUint64", data, len, (void **)out); }

int tfhe_fheuint64_destroy(TfheFheUint64 *ct) { return c_destroy(ct); }

int tfhe_fheuint72_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint72 **out)
{ return c_encrypt_u64("FheUint72", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint72_try_encrypt_trivial_u64(uint64_t value, TfheFheUint72 **out)
{ return c_encrypt_u64("FheUint72", value, 1, NULL, (void **)out); }

int tfhe_fheuint72_decrypt_u64(TfheFheUint72 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint72_decrypt_hex(TfheFheUint72 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint72_add(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint72_sub(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint72_mul(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint72_div(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint72_rem(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint72_bitand(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint72_bitor(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint72_bitxor(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint72_scalar_add(TfheFheUint72 *a, uint64_t b, TfheFheUint72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint72_scalar_sub(TfheFheUint72 *a, uint64_t b, TfheFheUint72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint72_scalar_mul(TfheFheUint72 *a, uint64_t b, TfheFheUint72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint72_scalar_shl(TfheFheUint72 *a, uint64_t b, TfheFheUint72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint72_scalar_shr(TfheFheUint72 *a, uint64_t b, TfheFheUint72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint72_ge(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint72_gt(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint72_le(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint72_lt(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint72_eq(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint72_ne(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint72_min(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint72_max(TfheFheUint72 *a, TfheFheUint72 *b, TfheFheUint72 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint72_rotate_left(TfheFheUint72 *a, uint32_t b, TfheFheUint72 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint72_rotate_right(TfheFheUint72 *a, uint32_t b, TfheFheUint72 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint72_neg(TfheFheUint72 *a, TfheFheUint72 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint72_not(TfheFheUint72 *a, TfheFheUint72 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint72_serialize(TfheFheUint72 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint72_deserialize(const uint8_t *data, size_t len, TfheFheUint72 **out)
{ return c_deserialize("FheUint72", data, len, (void **)out); }

int tfhe_fheuint72_destroy(TfheFheUint72 *ct) { return c_destroy(ct); }

int tfhe_fheuint80_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint80 **out)
{ return c_encrypt_u64("FheUint80", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint80_try_encrypt_trivial_u64(uint64_t value, TfheFheUint80 **out)
{ return c_encrypt_u64("FheUint80", value, 1, NULL, (void **)out); }

int tfhe_fheuint80_decrypt_u64(TfheFheUint80 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint80_decrypt_hex(TfheFheUint80 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint80_add(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint80_sub(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint80_mul(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint80_div(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint80_rem(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint80_bitand(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint80_bitor(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint80_bitxor(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint80_scalar_add(TfheFheUint80 *a, uint64_t b, TfheFheUint80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint80_scalar_sub(TfheFheUint80 *a, uint64_t b, TfheFheUint80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint80_scalar_mul(TfheFheUint80 *a, uint64_t b, TfheFheUint80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint80_scalar_shl(TfheFheUint80 *a, uint64_t b, TfheFheUint80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint80_scalar_shr(TfheFheUint80 *a, uint64_t b, TfheFheUint80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint80_ge(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint80_gt(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint80_le(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint80_lt(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint80_eq(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint80_ne(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint80_min(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint80_max(TfheFheUint80 *a, TfheFheUint80 *b, TfheFheUint80 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint80_rotate_left(TfheFheUint80 *a, uint32_t b, TfheFheUint80 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint80_rotate_right(TfheFheUint80 *a, uint32_t b, TfheFheUint80 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint80_neg(TfheFheUint80 *a, TfheFheUint80 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint80_not(TfheFheUint80 *a, TfheFheUint80 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint80_serialize(TfheFheUint80 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint80_deserialize(const uint8_t *data, size_t len, TfheFheUint80 **out)
{ return c_deserialize("FheUint80", data, len, (void **)out); }

int tfhe_fheuint80_destroy(TfheFheUint80 *ct) { return c_destroy(ct); }

int tfhe_fheuint88_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint88 **out)
{ return c_encrypt_u64("FheUint88", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint88_try_encrypt_trivial_u64(uint64_t value, TfheFheUint88 **out)
{ return c_encrypt_u64("FheUint88", value, 1, NULL, (void **)out); }

int tfhe_fheuint88_decrypt_u64(TfheFheUint88 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint88_decrypt_hex(TfheFheUint88 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint88_add(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint88_sub(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint88_mul(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint88_div(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint88_rem(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint88_bitand(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint88_bitor(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint88_bitxor(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint88_scalar_add(TfheFheUint88 *a, uint64_t b, TfheFheUint88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint88_scalar_sub(TfheFheUint88 *a, uint64_t b, TfheFheUint88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint88_scalar_mul(TfheFheUint88 *a, uint64_t b, TfheFheUint88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint88_scalar_shl(TfheFheUint88 *a, uint64_t b, TfheFheUint88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint88_scalar_shr(TfheFheUint88 *a, uint64_t b, TfheFheUint88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint88_ge(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint88_gt(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint88_le(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint88_lt(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint88_eq(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint88_ne(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint88_min(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint88_max(TfheFheUint88 *a, TfheFheUint88 *b, TfheFheUint88 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint88_rotate_left(TfheFheUint88 *a, uint32_t b, TfheFheUint88 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint88_rotate_right(TfheFheUint88 *a, uint32_t b, TfheFheUint88 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint88_neg(TfheFheUint88 *a, TfheFheUint88 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint88_not(TfheFheUint88 *a, TfheFheUint88 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint88_serialize(TfheFheUint88 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint88_deserialize(const uint8_t *data, size_t len, TfheFheUint88 **out)
{ return c_deserialize("FheUint88", data, len, (void **)out); }

int tfhe_fheuint88_destroy(TfheFheUint88 *ct) { return c_destroy(ct); }

int tfhe_fheuint96_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint96 **out)
{ return c_encrypt_u64("FheUint96", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint96_try_encrypt_trivial_u64(uint64_t value, TfheFheUint96 **out)
{ return c_encrypt_u64("FheUint96", value, 1, NULL, (void **)out); }

int tfhe_fheuint96_decrypt_u64(TfheFheUint96 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint96_decrypt_hex(TfheFheUint96 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint96_add(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint96_sub(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint96_mul(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint96_div(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint96_rem(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint96_bitand(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint96_bitor(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint96_bitxor(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint96_scalar_add(TfheFheUint96 *a, uint64_t b, TfheFheUint96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint96_scalar_sub(TfheFheUint96 *a, uint64_t b, TfheFheUint96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint96_scalar_mul(TfheFheUint96 *a, uint64_t b, TfheFheUint96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint96_scalar_shl(TfheFheUint96 *a, uint64_t b, TfheFheUint96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint96_scalar_shr(TfheFheUint96 *a, uint64_t b, TfheFheUint96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint96_ge(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint96_gt(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint96_le(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint96_lt(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint96_eq(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint96_ne(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint96_min(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint96_max(TfheFheUint96 *a, TfheFheUint96 *b, TfheFheUint96 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint96_rotate_left(TfheFheUint96 *a, uint32_t b, TfheFheUint96 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint96_rotate_right(TfheFheUint96 *a, uint32_t b, TfheFheUint96 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint96_neg(TfheFheUint96 *a, TfheFheUint96 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint96_not(TfheFheUint96 *a, TfheFheUint96 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint96_serialize(TfheFheUint96 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint96_deserialize(const uint8_t *data, size_t len, TfheFheUint96 **out)
{ return c_deserialize("FheUint96", data, len, (void **)out); }

int tfhe_fheuint96_destroy(TfheFheUint96 *ct) { return c_destroy(ct); }

int tfhe_fheuint104_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint104 **out)
{ return c_encrypt_u64("FheUint104", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint104_try_encrypt_trivial_u64(uint64_t value, TfheFheUint104 **out)
{ return c_encrypt_u64("FheUint104", value, 1, NULL, (void **)out); }

int tfhe_fheuint104_decrypt_u64(TfheFheUint104 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint104_decrypt_hex(TfheFheUint104 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint104_add(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint104_sub(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint104_mul(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint104_div(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint104_rem(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint104_bitand(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint104_bitor(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint104_bitxor(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint104_scalar_add(TfheFheUint104 *a, uint64_t b, TfheFheUint104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint104_scalar_sub(TfheFheUint104 *a, uint64_t b, TfheFheUint104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint104_scalar_mul(TfheFheUint104 *a, uint64_t b, TfheFheUint104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint104_scalar_shl(TfheFheUint104 *a, uint64_t b, TfheFheUint104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint104_scalar_shr(TfheFheUint104 *a, uint64_t b, TfheFheUint104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint104_ge(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint104_gt(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint104_le(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint104_lt(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint104_eq(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint104_ne(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint104_min(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint104_max(TfheFheUint104 *a, TfheFheUint104 *b, TfheFheUint104 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint104_rotate_left(TfheFheUint104 *a, uint32_t b, TfheFheUint104 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint104_rotate_right(TfheFheUint104 *a, uint32_t b, TfheFheUint104 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint104_neg(TfheFheUint104 *a, TfheFheUint104 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint104_not(TfheFheUint104 *a, TfheFheUint104 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint104_serialize(TfheFheUint104 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint104_deserialize(const uint8_t *data, size_t len, TfheFheUint104 **out)
{ return c_deserialize("FheUint104", data, len, (void **)out); }

int tfhe_fheuint104_destroy(TfheFheUint104 *ct) { return c_destroy(ct); }

int tfhe_fheuint112_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint112 **out)
{ return c_encrypt_u64("FheUint112", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint112_try_encrypt_trivial_u64(uint64_t value, TfheFheUint112 **out)
{ return c_encrypt_u64("FheUint112", value, 1, NULL, (void **)out); }

int tfhe_fheuint112_decrypt_u64(TfheFheUint112 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint112_decrypt_hex(TfheFheUint112 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint112_add(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint112_sub(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint112_mul(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint112_div(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint112_rem(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint112_bitand(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint112_bitor(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint112_bitxor(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint112_scalar_add(TfheFheUint112 *a, uint64_t b, TfheFheUint112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint112_scalar_sub(TfheFheUint112 *a, uint64_t b, TfheFheUint112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint112_scalar_mul(TfheFheUint112 *a, uint64_t b, TfheFheUint112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint112_scalar_shl(TfheFheUint112 *a, uint64_t b, TfheFheUint112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint112_scalar_shr(TfheFheUint112 *a, uint64_t b, TfheFheUint112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint112_ge(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint112_gt(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint112_le(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint112_lt(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint112_eq(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint112_ne(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint112_min(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint112_max(TfheFheUint112 *a, TfheFheUint112 *b, TfheFheUint112 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint112_rotate_left(TfheFheUint112 *a, uint32_t b, TfheFheUint112 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint112_rotate_right(TfheFheUint112 *a, uint32_t b, TfheFheUint112 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint112_neg(TfheFheUint112 *a, TfheFheUint112 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint112_not(TfheFheUint112 *a, TfheFheUint112 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint112_serialize(TfheFheUint112 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint112_deserialize(const uint8_t *data, size_t len, TfheFheUint112 **out)
{ return c_deserialize("FheUint112", data, len, (void **)out); }

int tfhe_fheuint112_destroy(TfheFheUint112 *ct) { return c_destroy(ct); }

int tfhe_fheuint120_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint120 **out)
{ return c_encrypt_u64("FheUint120", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint120_try_encrypt_trivial_u64(uint64_t value, TfheFheUint120 **out)
{ return c_encrypt_u64("FheUint120", value, 1, NULL, (void **)out); }

int tfhe_fheuint120_decrypt_u64(TfheFheUint120 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint120_decrypt_hex(TfheFheUint120 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint120_add(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint120_sub(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint120_mul(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint120_div(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint120_rem(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint120_bitand(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint120_bitor(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint120_bitxor(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint120_scalar_add(TfheFheUint120 *a, uint64_t b, TfheFheUint120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint120_scalar_sub(TfheFheUint120 *a, uint64_t b, TfheFheUint120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint120_scalar_mul(TfheFheUint120 *a, uint64_t b, TfheFheUint120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint120_scalar_shl(TfheFheUint120 *a, uint64_t b, TfheFheUint120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint120_scalar_shr(TfheFheUint120 *a, uint64_t b, TfheFheUint120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint120_ge(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint120_gt(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint120_le(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint120_lt(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint120_eq(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint120_ne(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint120_min(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint120_max(TfheFheUint120 *a, TfheFheUint120 *b, TfheFheUint120 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint120_rotate_left(TfheFheUint120 *a, uint32_t b, TfheFheUint120 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint120_rotate_right(TfheFheUint120 *a, uint32_t b, TfheFheUint120 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint120_neg(TfheFheUint120 *a, TfheFheUint120 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint120_not(TfheFheUint120 *a, TfheFheUint120 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint120_serialize(TfheFheUint120 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint120_deserialize(const uint8_t *data, size_t len, TfheFheUint120 **out)
{ return c_deserialize("FheUint120", data, len, (void **)out); }

int tfhe_fheuint120_destroy(TfheFheUint120 *ct) { return c_destroy(ct); }

int tfhe_fheuint128_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint128 **out)
{ return c_encrypt_u64("FheUint128", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint128_try_encrypt_trivial_u64(uint64_t value, TfheFheUint128 **out)
{ return c_encrypt_u64("FheUint128", value, 1, NULL, (void **)out); }

int tfhe_fheuint128_decrypt_u64(TfheFheUint128 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint128_decrypt_hex(TfheFheUint128 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint128_add(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint128_sub(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint128_mul(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint128_div(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint128_rem(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint128_bitand(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint128_bitor(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint128_bitxor(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint128_scalar_add(TfheFheUint128 *a, uint64_t b, TfheFheUint128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint128_scalar_sub(TfheFheUint128 *a, uint64_t b, TfheFheUint128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint128_scalar_mul(TfheFheUint128 *a, uint64_t b, TfheFheUint128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint128_scalar_shl(TfheFheUint128 *a, uint64_t b, TfheFheUint128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint128_scalar_shr(TfheFheUint128 *a, uint64_t b, TfheFheUint128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint128_ge(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint128_gt(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint128_le(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint128_lt(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint128_eq(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint128_ne(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint128_min(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint128_max(TfheFheUint128 *a, TfheFheUint128 *b, TfheFheUint128 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint128_rotate_left(TfheFheUint128 *a, uint32_t b, TfheFheUint128 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint128_rotate_right(TfheFheUint128 *a, uint32_t b, TfheFheUint128 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint128_neg(TfheFheUint128 *a, TfheFheUint128 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint128_not(TfheFheUint128 *a, TfheFheUint128 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint128_serialize(TfheFheUint128 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint128_deserialize(const uint8_t *data, size_t len, TfheFheUint128 **out)
{ return c_deserialize("FheUint128", data, len, (void **)out); }

int tfhe_fheuint128_destroy(TfheFheUint128 *ct) { return c_destroy(ct); }

int tfhe_fheuint136_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint136 **out)
{ return c_encrypt_u64("FheUint136", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint136_try_encrypt_trivial_u64(uint64_t value, TfheFheUint136 **out)
{ return c_encrypt_u64("FheUint136", value, 1, NULL, (void **)out); }

int tfhe_fheuint136_decrypt_u64(TfheFheUint136 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint136_decrypt_hex(TfheFheUint136 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint136_add(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint136_sub(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint136_mul(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint136_div(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint136_rem(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint136_bitand(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint136_bitor(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint136_bitxor(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint136_scalar_add(TfheFheUint136 *a, uint64_t b, TfheFheUint136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint136_scalar_sub(TfheFheUint136 *a, uint64_t b, TfheFheUint136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint136_scalar_mul(TfheFheUint136 *a, uint64_t b, TfheFheUint136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint136_scalar_shl(TfheFheUint136 *a, uint64_t b, TfheFheUint136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint136_scalar_shr(TfheFheUint136 *a, uint64_t b, TfheFheUint136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint136_ge(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint136_gt(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint136_le(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint136_lt(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint136_eq(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint136_ne(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint136_min(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint136_max(TfheFheUint136 *a, TfheFheUint136 *b, TfheFheUint136 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint136_rotate_left(TfheFheUint136 *a, uint32_t b, TfheFheUint136 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint136_rotate_right(TfheFheUint136 *a, uint32_t b, TfheFheUint136 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint136_neg(TfheFheUint136 *a, TfheFheUint136 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint136_not(TfheFheUint136 *a, TfheFheUint136 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint136_serialize(TfheFheUint136 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint136_deserialize(const uint8_t *data, size_t len, TfheFheUint136 **out)
{ return c_deserialize("FheUint136", data, len, (void **)out); }

int tfhe_fheuint136_destroy(TfheFheUint136 *ct) { return c_destroy(ct); }

int tfhe_fheuint144_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint144 **out)
{ return c_encrypt_u64("FheUint144", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint144_try_encrypt_trivial_u64(uint64_t value, TfheFheUint144 **out)
{ return c_encrypt_u64("FheUint144", value, 1, NULL, (void **)out); }

int tfhe_fheuint144_decrypt_u64(TfheFheUint144 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint144_decrypt_hex(TfheFheUint144 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint144_add(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint144_sub(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint144_mul(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint144_div(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint144_rem(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint144_bitand(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint144_bitor(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint144_bitxor(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint144_scalar_add(TfheFheUint144 *a, uint64_t b, TfheFheUint144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint144_scalar_sub(TfheFheUint144 *a, uint64_t b, TfheFheUint144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint144_scalar_mul(TfheFheUint144 *a, uint64_t b, TfheFheUint144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint144_scalar_shl(TfheFheUint144 *a, uint64_t b, TfheFheUint144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint144_scalar_shr(TfheFheUint144 *a, uint64_t b, TfheFheUint144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint144_ge(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint144_gt(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint144_le(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint144_lt(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint144_eq(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint144_ne(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint144_min(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint144_max(TfheFheUint144 *a, TfheFheUint144 *b, TfheFheUint144 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint144_rotate_left(TfheFheUint144 *a, uint32_t b, TfheFheUint144 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint144_rotate_right(TfheFheUint144 *a, uint32_t b, TfheFheUint144 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint144_neg(TfheFheUint144 *a, TfheFheUint144 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint144_not(TfheFheUint144 *a, TfheFheUint144 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint144_serialize(TfheFheUint144 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint144_deserialize(const uint8_t *data, size_t len, TfheFheUint144 **out)
{ return c_deserialize("FheUint144", data, len, (void **)out); }

int tfhe_fheuint144_destroy(TfheFheUint144 *ct) { return c_destroy(ct); }

int tfhe_fheuint152_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint152 **out)
{ return c_encrypt_u64("FheUint152", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint152_try_encrypt_trivial_u64(uint64_t value, TfheFheUint152 **out)
{ return c_encrypt_u64("FheUint152", value, 1, NULL, (void **)out); }

int tfhe_fheuint152_decrypt_u64(TfheFheUint152 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint152_decrypt_hex(TfheFheUint152 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint152_add(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint152_sub(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint152_mul(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint152_div(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint152_rem(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint152_bitand(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint152_bitor(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint152_bitxor(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint152_scalar_add(TfheFheUint152 *a, uint64_t b, TfheFheUint152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint152_scalar_sub(TfheFheUint152 *a, uint64_t b, TfheFheUint152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint152_scalar_mul(TfheFheUint152 *a, uint64_t b, TfheFheUint152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint152_scalar_shl(TfheFheUint152 *a, uint64_t b, TfheFheUint152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint152_scalar_shr(TfheFheUint152 *a, uint64_t b, TfheFheUint152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint152_ge(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint152_gt(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint152_le(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint152_lt(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint152_eq(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint152_ne(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint152_min(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint152_max(TfheFheUint152 *a, TfheFheUint152 *b, TfheFheUint152 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint152_rotate_left(TfheFheUint152 *a, uint32_t b, TfheFheUint152 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint152_rotate_right(TfheFheUint152 *a, uint32_t b, TfheFheUint152 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint152_neg(TfheFheUint152 *a, TfheFheUint152 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint152_not(TfheFheUint152 *a, TfheFheUint152 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint152_serialize(TfheFheUint152 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint152_deserialize(const uint8_t *data, size_t len, TfheFheUint152 **out)
{ return c_deserialize("FheUint152", data, len, (void **)out); }

int tfhe_fheuint152_destroy(TfheFheUint152 *ct) { return c_destroy(ct); }

int tfhe_fheuint160_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint160 **out)
{ return c_encrypt_u64("FheUint160", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint160_try_encrypt_trivial_u64(uint64_t value, TfheFheUint160 **out)
{ return c_encrypt_u64("FheUint160", value, 1, NULL, (void **)out); }

int tfhe_fheuint160_decrypt_u64(TfheFheUint160 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint160_decrypt_hex(TfheFheUint160 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint160_add(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint160_sub(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint160_mul(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint160_div(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint160_rem(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint160_bitand(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint160_bitor(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint160_bitxor(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint160_scalar_add(TfheFheUint160 *a, uint64_t b, TfheFheUint160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint160_scalar_sub(TfheFheUint160 *a, uint64_t b, TfheFheUint160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint160_scalar_mul(TfheFheUint160 *a, uint64_t b, TfheFheUint160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint160_scalar_shl(TfheFheUint160 *a, uint64_t b, TfheFheUint160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint160_scalar_shr(TfheFheUint160 *a, uint64_t b, TfheFheUint160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint160_ge(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint160_gt(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint160_le(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint160_lt(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint160_eq(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint160_ne(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint160_min(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint160_max(TfheFheUint160 *a, TfheFheUint160 *b, TfheFheUint160 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint160_rotate_left(TfheFheUint160 *a, uint32_t b, TfheFheUint160 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint160_rotate_right(TfheFheUint160 *a, uint32_t b, TfheFheUint160 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint160_neg(TfheFheUint160 *a, TfheFheUint160 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint160_not(TfheFheUint160 *a, TfheFheUint160 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint160_serialize(TfheFheUint160 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint160_deserialize(const uint8_t *data, size_t len, TfheFheUint160 **out)
{ return c_deserialize("FheUint160", data, len, (void **)out); }

int tfhe_fheuint160_destroy(TfheFheUint160 *ct) { return c_destroy(ct); }

int tfhe_fheuint168_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint168 **out)
{ return c_encrypt_u64("FheUint168", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint168_try_encrypt_trivial_u64(uint64_t value, TfheFheUint168 **out)
{ return c_encrypt_u64("FheUint168", value, 1, NULL, (void **)out); }

int tfhe_fheuint168_decrypt_u64(TfheFheUint168 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint168_decrypt_hex(TfheFheUint168 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint168_add(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint168_sub(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint168_mul(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint168_div(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint168_rem(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint168_bitand(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint168_bitor(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint168_bitxor(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint168_scalar_add(TfheFheUint168 *a, uint64_t b, TfheFheUint168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint168_scalar_sub(TfheFheUint168 *a, uint64_t b, TfheFheUint168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint168_scalar_mul(TfheFheUint168 *a, uint64_t b, TfheFheUint168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint168_scalar_shl(TfheFheUint168 *a, uint64_t b, TfheFheUint168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint168_scalar_shr(TfheFheUint168 *a, uint64_t b, TfheFheUint168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint168_ge(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint168_gt(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint168_le(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint168_lt(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint168_eq(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint168_ne(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint168_min(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint168_max(TfheFheUint168 *a, TfheFheUint168 *b, TfheFheUint168 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint168_rotate_left(TfheFheUint168 *a, uint32_t b, TfheFheUint168 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint168_rotate_right(TfheFheUint168 *a, uint32_t b, TfheFheUint168 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint168_neg(TfheFheUint168 *a, TfheFheUint168 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint168_not(TfheFheUint168 *a, TfheFheUint168 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint168_serialize(TfheFheUint168 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint168_deserialize(const uint8_t *data, size_t len, TfheFheUint168 **out)
{ return c_deserialize("FheUint168", data, len, (void **)out); }

int tfhe_fheuint168_destroy(TfheFheUint168 *ct) { return c_destroy(ct); }

int tfhe_fheuint176_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint176 **out)
{ return c_encrypt_u64("FheUint176", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint176_try_encrypt_trivial_u64(uint64_t value, TfheFheUint176 **out)
{ return c_encrypt_u64("FheUint176", value, 1, NULL, (void **)out); }

int tfhe_fheuint176_decrypt_u64(TfheFheUint176 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint176_decrypt_hex(TfheFheUint176 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint176_add(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint176_sub(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint176_mul(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint176_div(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint176_rem(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint176_bitand(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint176_bitor(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint176_bitxor(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint176_scalar_add(TfheFheUint176 *a, uint64_t b, TfheFheUint176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint176_scalar_sub(TfheFheUint176 *a, uint64_t b, TfheFheUint176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint176_scalar_mul(TfheFheUint176 *a, uint64_t b, TfheFheUint176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint176_scalar_shl(TfheFheUint176 *a, uint64_t b, TfheFheUint176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint176_scalar_shr(TfheFheUint176 *a, uint64_t b, TfheFheUint176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint176_ge(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint176_gt(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint176_le(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint176_lt(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint176_eq(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint176_ne(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint176_min(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint176_max(TfheFheUint176 *a, TfheFheUint176 *b, TfheFheUint176 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint176_rotate_left(TfheFheUint176 *a, uint32_t b, TfheFheUint176 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint176_rotate_right(TfheFheUint176 *a, uint32_t b, TfheFheUint176 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint176_neg(TfheFheUint176 *a, TfheFheUint176 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint176_not(TfheFheUint176 *a, TfheFheUint176 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint176_serialize(TfheFheUint176 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint176_deserialize(const uint8_t *data, size_t len, TfheFheUint176 **out)
{ return c_deserialize("FheUint176", data, len, (void **)out); }

int tfhe_fheuint176_destroy(TfheFheUint176 *ct) { return c_destroy(ct); }

int tfhe_fheuint184_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint184 **out)
{ return c_encrypt_u64("FheUint184", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint184_try_encrypt_trivial_u64(uint64_t value, TfheFheUint184 **out)
{ return c_encrypt_u64("FheUint184", value, 1, NULL, (void **)out); }

int tfhe_fheuint184_decrypt_u64(TfheFheUint184 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint184_decrypt_hex(TfheFheUint184 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint184_add(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint184_sub(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint184_mul(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint184_div(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint184_rem(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint184_bitand(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint184_bitor(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint184_bitxor(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint184_scalar_add(TfheFheUint184 *a, uint64_t b, TfheFheUint184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint184_scalar_sub(TfheFheUint184 *a, uint64_t b, TfheFheUint184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint184_scalar_mul(TfheFheUint184 *a, uint64_t b, TfheFheUint184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint184_scalar_shl(TfheFheUint184 *a, uint64_t b, TfheFheUint184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint184_scalar_shr(TfheFheUint184 *a, uint64_t b, TfheFheUint184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint184_ge(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint184_gt(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint184_le(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint184_lt(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint184_eq(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint184_ne(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint184_min(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint184_max(TfheFheUint184 *a, TfheFheUint184 *b, TfheFheUint184 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint184_rotate_left(TfheFheUint184 *a, uint32_t b, TfheFheUint184 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint184_rotate_right(TfheFheUint184 *a, uint32_t b, TfheFheUint184 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint184_neg(TfheFheUint184 *a, TfheFheUint184 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint184_not(TfheFheUint184 *a, TfheFheUint184 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint184_serialize(TfheFheUint184 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint184_deserialize(const uint8_t *data, size_t len, TfheFheUint184 **out)
{ return c_deserialize("FheUint184", data, len, (void **)out); }

int tfhe_fheuint184_destroy(TfheFheUint184 *ct) { return c_destroy(ct); }

int tfhe_fheuint192_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint192 **out)
{ return c_encrypt_u64("FheUint192", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint192_try_encrypt_trivial_u64(uint64_t value, TfheFheUint192 **out)
{ return c_encrypt_u64("FheUint192", value, 1, NULL, (void **)out); }

int tfhe_fheuint192_decrypt_u64(TfheFheUint192 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint192_decrypt_hex(TfheFheUint192 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint192_add(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint192_sub(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint192_mul(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint192_div(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint192_rem(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint192_bitand(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint192_bitor(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint192_bitxor(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint192_scalar_add(TfheFheUint192 *a, uint64_t b, TfheFheUint192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint192_scalar_sub(TfheFheUint192 *a, uint64_t b, TfheFheUint192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint192_scalar_mul(TfheFheUint192 *a, uint64_t b, TfheFheUint192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint192_scalar_shl(TfheFheUint192 *a, uint64_t b, TfheFheUint192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint192_scalar_shr(TfheFheUint192 *a, uint64_t b, TfheFheUint192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint192_ge(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint192_gt(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint192_le(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint192_lt(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint192_eq(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint192_ne(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint192_min(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint192_max(TfheFheUint192 *a, TfheFheUint192 *b, TfheFheUint192 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint192_rotate_left(TfheFheUint192 *a, uint32_t b, TfheFheUint192 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint192_rotate_right(TfheFheUint192 *a, uint32_t b, TfheFheUint192 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint192_neg(TfheFheUint192 *a, TfheFheUint192 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint192_not(TfheFheUint192 *a, TfheFheUint192 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint192_serialize(TfheFheUint192 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint192_deserialize(const uint8_t *data, size_t len, TfheFheUint192 **out)
{ return c_deserialize("FheUint192", data, len, (void **)out); }

int tfhe_fheuint192_destroy(TfheFheUint192 *ct) { return c_destroy(ct); }

int tfhe_fheuint200_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint200 **out)
{ return c_encrypt_u64("FheUint200", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint200_try_encrypt_trivial_u64(uint64_t value, TfheFheUint200 **out)
{ return c_encrypt_u64("FheUint200", value, 1, NULL, (void **)out); }

int tfhe_fheuint200_decrypt_u64(TfheFheUint200 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint200_decrypt_hex(TfheFheUint200 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint200_add(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint200_sub(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint200_mul(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint200_div(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint200_rem(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint200_bitand(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint200_bitor(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint200_bitxor(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint200_scalar_add(TfheFheUint200 *a, uint64_t b, TfheFheUint200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint200_scalar_sub(TfheFheUint200 *a, uint64_t b, TfheFheUint200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint200_scalar_mul(TfheFheUint200 *a, uint64_t b, TfheFheUint200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint200_scalar_shl(TfheFheUint200 *a, uint64_t b, TfheFheUint200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint200_scalar_shr(TfheFheUint200 *a, uint64_t b, TfheFheUint200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint200_ge(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint200_gt(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint200_le(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint200_lt(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint200_eq(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint200_ne(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint200_min(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint200_max(TfheFheUint200 *a, TfheFheUint200 *b, TfheFheUint200 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint200_rotate_left(TfheFheUint200 *a, uint32_t b, TfheFheUint200 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint200_rotate_right(TfheFheUint200 *a, uint32_t b, TfheFheUint200 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint200_neg(TfheFheUint200 *a, TfheFheUint200 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint200_not(TfheFheUint200 *a, TfheFheUint200 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint200_serialize(TfheFheUint200 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint200_deserialize(const uint8_t *data, size_t len, TfheFheUint200 **out)
{ return c_deserialize("FheUint200", data, len, (void **)out); }

int tfhe_fheuint200_destroy(TfheFheUint200 *ct) { return c_destroy(ct); }

int tfhe_fheuint208_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint208 **out)
{ return c_encrypt_u64("FheUint208", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint208_try_encrypt_trivial_u64(uint64_t value, TfheFheUint208 **out)
{ return c_encrypt_u64("FheUint208", value, 1, NULL, (void **)out); }

int tfhe_fheuint208_decrypt_u64(TfheFheUint208 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint208_decrypt_hex(TfheFheUint208 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint208_add(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint208_sub(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint208_mul(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint208_div(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint208_rem(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint208_bitand(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint208_bitor(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint208_bitxor(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint208_scalar_add(TfheFheUint208 *a, uint64_t b, TfheFheUint208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint208_scalar_sub(TfheFheUint208 *a, uint64_t b, TfheFheUint208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint208_scalar_mul(TfheFheUint208 *a, uint64_t b, TfheFheUint208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint208_scalar_shl(TfheFheUint208 *a, uint64_t b, TfheFheUint208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint208_scalar_shr(TfheFheUint208 *a, uint64_t b, TfheFheUint208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint208_ge(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint208_gt(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint208_le(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint208_lt(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint208_eq(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint208_ne(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint208_min(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint208_max(TfheFheUint208 *a, TfheFheUint208 *b, TfheFheUint208 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint208_rotate_left(TfheFheUint208 *a, uint32_t b, TfheFheUint208 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint208_rotate_right(TfheFheUint208 *a, uint32_t b, TfheFheUint208 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint208_neg(TfheFheUint208 *a, TfheFheUint208 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint208_not(TfheFheUint208 *a, TfheFheUint208 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint208_serialize(TfheFheUint208 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint208_deserialize(const uint8_t *data, size_t len, TfheFheUint208 **out)
{ return c_deserialize("FheUint208", data, len, (void **)out); }

int tfhe_fheuint208_destroy(TfheFheUint208 *ct) { return c_destroy(ct); }

int tfhe_fheuint216_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint216 **out)
{ return c_encrypt_u64("FheUint216", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint216_try_encrypt_trivial_u64(uint64_t value, TfheFheUint216 **out)
{ return c_encrypt_u64("FheUint216", value, 1, NULL, (void **)out); }

int tfhe_fheuint216_decrypt_u64(TfheFheUint216 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint216_decrypt_hex(TfheFheUint216 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint216_add(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint216_sub(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint216_mul(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint216_div(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint216_rem(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint216_bitand(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint216_bitor(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint216_bitxor(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint216_scalar_add(TfheFheUint216 *a, uint64_t b, TfheFheUint216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint216_scalar_sub(TfheFheUint216 *a, uint64_t b, TfheFheUint216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint216_scalar_mul(TfheFheUint216 *a, uint64_t b, TfheFheUint216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint216_scalar_shl(TfheFheUint216 *a, uint64_t b, TfheFheUint216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint216_scalar_shr(TfheFheUint216 *a, uint64_t b, TfheFheUint216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint216_ge(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint216_gt(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint216_le(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint216_lt(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint216_eq(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint216_ne(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint216_min(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint216_max(TfheFheUint216 *a, TfheFheUint216 *b, TfheFheUint216 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint216_rotate_left(TfheFheUint216 *a, uint32_t b, TfheFheUint216 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint216_rotate_right(TfheFheUint216 *a, uint32_t b, TfheFheUint216 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint216_neg(TfheFheUint216 *a, TfheFheUint216 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint216_not(TfheFheUint216 *a, TfheFheUint216 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint216_serialize(TfheFheUint216 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint216_deserialize(const uint8_t *data, size_t len, TfheFheUint216 **out)
{ return c_deserialize("FheUint216", data, len, (void **)out); }

int tfhe_fheuint216_destroy(TfheFheUint216 *ct) { return c_destroy(ct); }

int tfhe_fheuint224_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint224 **out)
{ return c_encrypt_u64("FheUint224", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint224_try_encrypt_trivial_u64(uint64_t value, TfheFheUint224 **out)
{ return c_encrypt_u64("FheUint224", value, 1, NULL, (void **)out); }

int tfhe_fheuint224_decrypt_u64(TfheFheUint224 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint224_decrypt_hex(TfheFheUint224 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint224_add(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint224_sub(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint224_mul(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint224_div(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint224_rem(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint224_bitand(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint224_bitor(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint224_bitxor(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint224_scalar_add(TfheFheUint224 *a, uint64_t b, TfheFheUint224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint224_scalar_sub(TfheFheUint224 *a, uint64_t b, TfheFheUint224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint224_scalar_mul(TfheFheUint224 *a, uint64_t b, TfheFheUint224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint224_scalar_shl(TfheFheUint224 *a, uint64_t b, TfheFheUint224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint224_scalar_shr(TfheFheUint224 *a, uint64_t b, TfheFheUint224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint224_ge(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint224_gt(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint224_le(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint224_lt(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint224_eq(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint224_ne(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint224_min(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint224_max(TfheFheUint224 *a, TfheFheUint224 *b, TfheFheUint224 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint224_rotate_left(TfheFheUint224 *a, uint32_t b, TfheFheUint224 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint224_rotate_right(TfheFheUint224 *a, uint32_t b, TfheFheUint224 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint224_neg(TfheFheUint224 *a, TfheFheUint224 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint224_not(TfheFheUint224 *a, TfheFheUint224 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint224_serialize(TfheFheUint224 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint224_deserialize(const uint8_t *data, size_t len, TfheFheUint224 **out)
{ return c_deserialize("FheUint224", data, len, (void **)out); }

int tfhe_fheuint224_destroy(TfheFheUint224 *ct) { return c_destroy(ct); }

int tfhe_fheuint232_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint232 **out)
{ return c_encrypt_u64("FheUint232", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint232_try_encrypt_trivial_u64(uint64_t value, TfheFheUint232 **out)
{ return c_encrypt_u64("FheUint232", value, 1, NULL, (void **)out); }

int tfhe_fheuint232_decrypt_u64(TfheFheUint232 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint232_decrypt_hex(TfheFheUint232 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint232_add(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint232_sub(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint232_mul(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint232_div(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint232_rem(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint232_bitand(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint232_bitor(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint232_bitxor(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint232_scalar_add(TfheFheUint232 *a, uint64_t b, TfheFheUint232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint232_scalar_sub(TfheFheUint232 *a, uint64_t b, TfheFheUint232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint232_scalar_mul(TfheFheUint232 *a, uint64_t b, TfheFheUint232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint232_scalar_shl(TfheFheUint232 *a, uint64_t b, TfheFheUint232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint232_scalar_shr(TfheFheUint232 *a, uint64_t b, TfheFheUint232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint232_ge(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint232_gt(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint232_le(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint232_lt(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint232_eq(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint232_ne(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint232_min(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint232_max(TfheFheUint232 *a, TfheFheUint232 *b, TfheFheUint232 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint232_rotate_left(TfheFheUint232 *a, uint32_t b, TfheFheUint232 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint232_rotate_right(TfheFheUint232 *a, uint32_t b, TfheFheUint232 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint232_neg(TfheFheUint232 *a, TfheFheUint232 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint232_not(TfheFheUint232 *a, TfheFheUint232 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint232_serialize(TfheFheUint232 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint232_deserialize(const uint8_t *data, size_t len, TfheFheUint232 **out)
{ return c_deserialize("FheUint232", data, len, (void **)out); }

int tfhe_fheuint232_destroy(TfheFheUint232 *ct) { return c_destroy(ct); }

int tfhe_fheuint240_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint240 **out)
{ return c_encrypt_u64("FheUint240", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint240_try_encrypt_trivial_u64(uint64_t value, TfheFheUint240 **out)
{ return c_encrypt_u64("FheUint240", value, 1, NULL, (void **)out); }

int tfhe_fheuint240_decrypt_u64(TfheFheUint240 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint240_decrypt_hex(TfheFheUint240 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint240_add(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint240_sub(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint240_mul(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint240_div(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint240_rem(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint240_bitand(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint240_bitor(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint240_bitxor(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint240_scalar_add(TfheFheUint240 *a, uint64_t b, TfheFheUint240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint240_scalar_sub(TfheFheUint240 *a, uint64_t b, TfheFheUint240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint240_scalar_mul(TfheFheUint240 *a, uint64_t b, TfheFheUint240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint240_scalar_shl(TfheFheUint240 *a, uint64_t b, TfheFheUint240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint240_scalar_shr(TfheFheUint240 *a, uint64_t b, TfheFheUint240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint240_ge(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint240_gt(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint240_le(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint240_lt(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint240_eq(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint240_ne(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint240_min(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint240_max(TfheFheUint240 *a, TfheFheUint240 *b, TfheFheUint240 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint240_rotate_left(TfheFheUint240 *a, uint32_t b, TfheFheUint240 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint240_rotate_right(TfheFheUint240 *a, uint32_t b, TfheFheUint240 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint240_neg(TfheFheUint240 *a, TfheFheUint240 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint240_not(TfheFheUint240 *a, TfheFheUint240 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint240_serialize(TfheFheUint240 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint240_deserialize(const uint8_t *data, size_t len, TfheFheUint240 **out)
{ return c_deserialize("FheUint240", data, len, (void **)out); }

int tfhe_fheuint240_destroy(TfheFheUint240 *ct) { return c_destroy(ct); }

int tfhe_fheuint248_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint248 **out)
{ return c_encrypt_u64("FheUint248", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint248_try_encrypt_trivial_u64(uint64_t value, TfheFheUint248 **out)
{ return c_encrypt_u64("FheUint248", value, 1, NULL, (void **)out); }

int tfhe_fheuint248_decrypt_u64(TfheFheUint248 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint248_decrypt_hex(TfheFheUint248 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint248_add(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint248_sub(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint248_mul(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint248_div(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint248_rem(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint248_bitand(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint248_bitor(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint248_bitxor(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint248_scalar_add(TfheFheUint248 *a, uint64_t b, TfheFheUint248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint248_scalar_sub(TfheFheUint248 *a, uint64_t b, TfheFheUint248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint248_scalar_mul(TfheFheUint248 *a, uint64_t b, TfheFheUint248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint248_scalar_shl(TfheFheUint248 *a, uint64_t b, TfheFheUint248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint248_scalar_shr(TfheFheUint248 *a, uint64_t b, TfheFheUint248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint248_ge(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint248_gt(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint248_le(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint248_lt(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint248_eq(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint248_ne(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint248_min(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint248_max(TfheFheUint248 *a, TfheFheUint248 *b, TfheFheUint248 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint248_rotate_left(TfheFheUint248 *a, uint32_t b, TfheFheUint248 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint248_rotate_right(TfheFheUint248 *a, uint32_t b, TfheFheUint248 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint248_neg(TfheFheUint248 *a, TfheFheUint248 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint248_not(TfheFheUint248 *a, TfheFheUint248 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint248_serialize(TfheFheUint248 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint248_deserialize(const uint8_t *data, size_t len, TfheFheUint248 **out)
{ return c_deserialize("FheUint248", data, len, (void **)out); }

int tfhe_fheuint248_destroy(TfheFheUint248 *ct) { return c_destroy(ct); }

int tfhe_fheuint256_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint256 **out)
{ return c_encrypt_u64("FheUint256", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint256_try_encrypt_trivial_u64(uint64_t value, TfheFheUint256 **out)
{ return c_encrypt_u64("FheUint256", value, 1, NULL, (void **)out); }

int tfhe_fheuint256_decrypt_u64(TfheFheUint256 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint256_decrypt_hex(TfheFheUint256 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint256_add(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint256_sub(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint256_mul(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint256_div(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint256_rem(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint256_bitand(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint256_bitor(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint256_bitxor(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint256_scalar_add(TfheFheUint256 *a, uint64_t b, TfheFheUint256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint256_scalar_sub(TfheFheUint256 *a, uint64_t b, TfheFheUint256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint256_scalar_mul(TfheFheUint256 *a, uint64_t b, TfheFheUint256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint256_scalar_shl(TfheFheUint256 *a, uint64_t b, TfheFheUint256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint256_scalar_shr(TfheFheUint256 *a, uint64_t b, TfheFheUint256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint256_ge(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint256_gt(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint256_le(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint256_lt(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint256_eq(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint256_ne(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint256_min(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint256_max(TfheFheUint256 *a, TfheFheUint256 *b, TfheFheUint256 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint256_rotate_left(TfheFheUint256 *a, uint32_t b, TfheFheUint256 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint256_rotate_right(TfheFheUint256 *a, uint32_t b, TfheFheUint256 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint256_neg(TfheFheUint256 *a, TfheFheUint256 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint256_not(TfheFheUint256 *a, TfheFheUint256 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint256_serialize(TfheFheUint256 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint256_deserialize(const uint8_t *data, size_t len, TfheFheUint256 **out)
{ return c_deserialize("FheUint256", data, len, (void **)out); }

int tfhe_fheuint256_destroy(TfheFheUint256 *ct) { return c_destroy(ct); }

int tfhe_fheuint512_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint512 **out)
{ return c_encrypt_u64("FheUint512", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint512_try_encrypt_trivial_u64(uint64_t value, TfheFheUint512 **out)
{ return c_encrypt_u64("FheUint512", value, 1, NULL, (void **)out); }

int tfhe_fheuint512_decrypt_u64(TfheFheUint512 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint512_decrypt_hex(TfheFheUint512 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint512_add(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint512_sub(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint512_mul(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint512_div(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint512_rem(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint512_bitand(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint512_bitor(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint512_bitxor(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint512_scalar_add(TfheFheUint512 *a, uint64_t b, TfheFheUint512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint512_scalar_sub(TfheFheUint512 *a, uint64_t b, TfheFheUint512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint512_scalar_mul(TfheFheUint512 *a, uint64_t b, TfheFheUint512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint512_scalar_shl(TfheFheUint512 *a, uint64_t b, TfheFheUint512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint512_scalar_shr(TfheFheUint512 *a, uint64_t b, TfheFheUint512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint512_ge(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint512_gt(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint512_le(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint512_lt(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint512_eq(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint512_ne(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint512_min(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint512_max(TfheFheUint512 *a, TfheFheUint512 *b, TfheFheUint512 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint512_rotate_left(TfheFheUint512 *a, uint32_t b, TfheFheUint512 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint512_rotate_right(TfheFheUint512 *a, uint32_t b, TfheFheUint512 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint512_neg(TfheFheUint512 *a, TfheFheUint512 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint512_not(TfheFheUint512 *a, TfheFheUint512 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint512_serialize(TfheFheUint512 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint512_deserialize(const uint8_t *data, size_t len, TfheFheUint512 **out)
{ return c_deserialize("FheUint512", data, len, (void **)out); }

int tfhe_fheuint512_destroy(TfheFheUint512 *ct) { return c_destroy(ct); }

int tfhe_fheuint1024_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint1024 **out)
{ return c_encrypt_u64("FheUint1024", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint1024_try_encrypt_trivial_u64(uint64_t value, TfheFheUint1024 **out)
{ return c_encrypt_u64("FheUint1024", value, 1, NULL, (void **)out); }

int tfhe_fheuint1024_decrypt_u64(TfheFheUint1024 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint1024_decrypt_hex(TfheFheUint1024 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint1024_add(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint1024_sub(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint1024_mul(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint1024_div(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint1024_rem(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint1024_bitand(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint1024_bitor(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint1024_bitxor(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint1024_scalar_add(TfheFheUint1024 *a, uint64_t b, TfheFheUint1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint1024_scalar_sub(TfheFheUint1024 *a, uint64_t b, TfheFheUint1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint1024_scalar_mul(TfheFheUint1024 *a, uint64_t b, TfheFheUint1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint1024_scalar_shl(TfheFheUint1024 *a, uint64_t b, TfheFheUint1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint1024_scalar_shr(TfheFheUint1024 *a, uint64_t b, TfheFheUint1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint1024_ge(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint1024_gt(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint1024_le(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint1024_lt(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint1024_eq(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint1024_ne(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint1024_min(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint1024_max(TfheFheUint1024 *a, TfheFheUint1024 *b, TfheFheUint1024 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint1024_rotate_left(TfheFheUint1024 *a, uint32_t b, TfheFheUint1024 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint1024_rotate_right(TfheFheUint1024 *a, uint32_t b, TfheFheUint1024 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint1024_neg(TfheFheUint1024 *a, TfheFheUint1024 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint1024_not(TfheFheUint1024 *a, TfheFheUint1024 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint1024_serialize(TfheFheUint1024 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint1024_deserialize(const uint8_t *data, size_t len, TfheFheUint1024 **out)
{ return c_deserialize("FheUint1024", data, len, (void **)out); }

int tfhe_fheuint1024_destroy(TfheFheUint1024 *ct) { return c_destroy(ct); }

int tfhe_fheuint2048_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheUint2048 **out)
{ return c_encrypt_u64("FheUint2048", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheuint2048_try_encrypt_trivial_u64(uint64_t value, TfheFheUint2048 **out)
{ return c_encrypt_u64("FheUint2048", value, 1, NULL, (void **)out); }

int tfhe_fheuint2048_decrypt_u64(TfheFheUint2048 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint2048_decrypt_hex(TfheFheUint2048 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheuint2048_add(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheuint2048_sub(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint2048_mul(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint2048_div(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheuint2048_rem(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheuint2048_bitand(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheuint2048_bitor(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheuint2048_bitxor(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheuint2048_scalar_add(TfheFheUint2048 *a, uint64_t b, TfheFheUint2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheuint2048_scalar_sub(TfheFheUint2048 *a, uint64_t b, TfheFheUint2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheuint2048_scalar_mul(TfheFheUint2048 *a, uint64_t b, TfheFheUint2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheuint2048_scalar_shl(TfheFheUint2048 *a, uint64_t b, TfheFheUint2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheuint2048_scalar_shr(TfheFheUint2048 *a, uint64_t b, TfheFheUint2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheuint2048_ge(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheuint2048_gt(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheuint2048_le(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheuint2048_lt(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheuint2048_eq(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheuint2048_ne(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheuint2048_min(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheuint2048_max(TfheFheUint2048 *a, TfheFheUint2048 *b, TfheFheUint2048 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheuint2048_rotate_left(TfheFheUint2048 *a, uint32_t b, TfheFheUint2048 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheuint2048_rotate_right(TfheFheUint2048 *a, uint32_t b, TfheFheUint2048 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheuint2048_neg(TfheFheUint2048 *a, TfheFheUint2048 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheuint2048_not(TfheFheUint2048 *a, TfheFheUint2048 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheuint2048_serialize(TfheFheUint2048 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheuint2048_deserialize(const uint8_t *data, size_t len, TfheFheUint2048 **out)
{ return c_deserialize("FheUint2048", data, len, (void **)out); }

int tfhe_fheuint2048_destroy(TfheFheUint2048 *ct) { return c_destroy(ct); }

int tfhe_fheint2_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt2 **out)
{ return c_encrypt_u64("FheInt2", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint2_try_encrypt_trivial_u64(uint64_t value, TfheFheInt2 **out)
{ return c_encrypt_u64("FheInt2", value, 1, NULL, (void **)out); }

int tfhe_fheint2_decrypt_i64(TfheFheInt2 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint2_decrypt_u64(TfheFheInt2 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint2_decrypt_hex(TfheFheInt2 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint2_add(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint2_sub(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint2_mul(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint2_div(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint2_rem(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint2_bitand(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint2_bitor(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint2_bitxor(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint2_scalar_add(TfheFheInt2 *a, uint64_t b, TfheFheInt2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint2_scalar_sub(TfheFheInt2 *a, uint64_t b, TfheFheInt2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint2_scalar_mul(TfheFheInt2 *a, uint64_t b, TfheFheInt2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint2_scalar_shl(TfheFheInt2 *a, uint64_t b, TfheFheInt2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint2_scalar_shr(TfheFheInt2 *a, uint64_t b, TfheFheInt2 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint2_ge(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint2_gt(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint2_le(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint2_lt(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint2_eq(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint2_ne(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint2_min(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint2_max(TfheFheInt2 *a, TfheFheInt2 *b, TfheFheInt2 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint2_rotate_left(TfheFheInt2 *a, uint32_t b, TfheFheInt2 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint2_rotate_right(TfheFheInt2 *a, uint32_t b, TfheFheInt2 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint2_neg(TfheFheInt2 *a, TfheFheInt2 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint2_not(TfheFheInt2 *a, TfheFheInt2 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint2_serialize(TfheFheInt2 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint2_deserialize(const uint8_t *data, size_t len, TfheFheInt2 **out)
{ return c_deserialize("FheInt2", data, len, (void **)out); }

int tfhe_fheint2_destroy(TfheFheInt2 *ct) { return c_destroy(ct); }

int tfhe_fheint4_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt4 **out)
{ return c_encrypt_u64("FheInt4", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint4_try_encrypt_trivial_u64(uint64_t value, TfheFheInt4 **out)
{ return c_encrypt_u64("FheInt4", value, 1, NULL, (void **)out); }

int tfhe_fheint4_decrypt_i64(TfheFheInt4 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint4_decrypt_u64(TfheFheInt4 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint4_decrypt_hex(TfheFheInt4 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint4_add(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint4_sub(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint4_mul(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint4_div(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint4_rem(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint4_bitand(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint4_bitor(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint4_bitxor(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint4_scalar_add(TfheFheInt4 *a, uint64_t b, TfheFheInt4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint4_scalar_sub(TfheFheInt4 *a, uint64_t b, TfheFheInt4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint4_scalar_mul(TfheFheInt4 *a, uint64_t b, TfheFheInt4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint4_scalar_shl(TfheFheInt4 *a, uint64_t b, TfheFheInt4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint4_scalar_shr(TfheFheInt4 *a, uint64_t b, TfheFheInt4 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint4_ge(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint4_gt(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint4_le(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint4_lt(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint4_eq(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint4_ne(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint4_min(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint4_max(TfheFheInt4 *a, TfheFheInt4 *b, TfheFheInt4 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint4_rotate_left(TfheFheInt4 *a, uint32_t b, TfheFheInt4 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint4_rotate_right(TfheFheInt4 *a, uint32_t b, TfheFheInt4 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint4_neg(TfheFheInt4 *a, TfheFheInt4 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint4_not(TfheFheInt4 *a, TfheFheInt4 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint4_serialize(TfheFheInt4 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint4_deserialize(const uint8_t *data, size_t len, TfheFheInt4 **out)
{ return c_deserialize("FheInt4", data, len, (void **)out); }

int tfhe_fheint4_destroy(TfheFheInt4 *ct) { return c_destroy(ct); }

int tfhe_fheint6_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt6 **out)
{ return c_encrypt_u64("FheInt6", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint6_try_encrypt_trivial_u64(uint64_t value, TfheFheInt6 **out)
{ return c_encrypt_u64("FheInt6", value, 1, NULL, (void **)out); }

int tfhe_fheint6_decrypt_i64(TfheFheInt6 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint6_decrypt_u64(TfheFheInt6 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint6_decrypt_hex(TfheFheInt6 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint6_add(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint6_sub(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint6_mul(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint6_div(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint6_rem(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint6_bitand(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint6_bitor(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint6_bitxor(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint6_scalar_add(TfheFheInt6 *a, uint64_t b, TfheFheInt6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint6_scalar_sub(TfheFheInt6 *a, uint64_t b, TfheFheInt6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint6_scalar_mul(TfheFheInt6 *a, uint64_t b, TfheFheInt6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint6_scalar_shl(TfheFheInt6 *a, uint64_t b, TfheFheInt6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint6_scalar_shr(TfheFheInt6 *a, uint64_t b, TfheFheInt6 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint6_ge(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint6_gt(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint6_le(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint6_lt(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint6_eq(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint6_ne(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint6_min(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint6_max(TfheFheInt6 *a, TfheFheInt6 *b, TfheFheInt6 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint6_rotate_left(TfheFheInt6 *a, uint32_t b, TfheFheInt6 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint6_rotate_right(TfheFheInt6 *a, uint32_t b, TfheFheInt6 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint6_neg(TfheFheInt6 *a, TfheFheInt6 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint6_not(TfheFheInt6 *a, TfheFheInt6 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint6_serialize(TfheFheInt6 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint6_deserialize(const uint8_t *data, size_t len, TfheFheInt6 **out)
{ return c_deserialize("FheInt6", data, len, (void **)out); }

int tfhe_fheint6_destroy(TfheFheInt6 *ct) { return c_destroy(ct); }

int tfhe_fheint8_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt8 **out)
{ return c_encrypt_u64("FheInt8", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint8_try_encrypt_trivial_u64(uint64_t value, TfheFheInt8 **out)
{ return c_encrypt_u64("FheInt8", value, 1, NULL, (void **)out); }

int tfhe_fheint8_decrypt_i64(TfheFheInt8 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint8_decrypt_u64(TfheFheInt8 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint8_decrypt_hex(TfheFheInt8 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint8_add(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint8_sub(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint8_mul(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint8_div(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint8_rem(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint8_bitand(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint8_bitor(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint8_bitxor(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint8_scalar_add(TfheFheInt8 *a, uint64_t b, TfheFheInt8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint8_scalar_sub(TfheFheInt8 *a, uint64_t b, TfheFheInt8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint8_scalar_mul(TfheFheInt8 *a, uint64_t b, TfheFheInt8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint8_scalar_shl(TfheFheInt8 *a, uint64_t b, TfheFheInt8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint8_scalar_shr(TfheFheInt8 *a, uint64_t b, TfheFheInt8 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint8_ge(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint8_gt(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint8_le(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint8_lt(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint8_eq(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint8_ne(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint8_min(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint8_max(TfheFheInt8 *a, TfheFheInt8 *b, TfheFheInt8 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint8_rotate_left(TfheFheInt8 *a, uint32_t b, TfheFheInt8 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint8_rotate_right(TfheFheInt8 *a, uint32_t b, TfheFheInt8 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint8_neg(TfheFheInt8 *a, TfheFheInt8 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint8_not(TfheFheInt8 *a, TfheFheInt8 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint8_serialize(TfheFheInt8 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint8_deserialize(const uint8_t *data, size_t len, TfheFheInt8 **out)
{ return c_deserialize("FheInt8", data, len, (void **)out); }

int tfhe_fheint8_destroy(TfheFheInt8 *ct) { return c_destroy(ct); }

int tfhe_fheint10_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt10 **out)
{ return c_encrypt_u64("FheInt10", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint10_try_encrypt_trivial_u64(uint64_t value, TfheFheInt10 **out)
{ return c_encrypt_u64("FheInt10", value, 1, NULL, (void **)out); }

int tfhe_fheint10_decrypt_i64(TfheFheInt10 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint10_decrypt_u64(TfheFheInt10 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint10_decrypt_hex(TfheFheInt10 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint10_add(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint10_sub(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint10_mul(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint10_div(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint10_rem(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint10_bitand(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint10_bitor(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint10_bitxor(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint10_scalar_add(TfheFheInt10 *a, uint64_t b, TfheFheInt10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint10_scalar_sub(TfheFheInt10 *a, uint64_t b, TfheFheInt10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint10_scalar_mul(TfheFheInt10 *a, uint64_t b, TfheFheInt10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint10_scalar_shl(TfheFheInt10 *a, uint64_t b, TfheFheInt10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint10_scalar_shr(TfheFheInt10 *a, uint64_t b, TfheFheInt10 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint10_ge(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint10_gt(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint10_le(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint10_lt(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint10_eq(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint10_ne(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint10_min(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint10_max(TfheFheInt10 *a, TfheFheInt10 *b, TfheFheInt10 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint10_rotate_left(TfheFheInt10 *a, uint32_t b, TfheFheInt10 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint10_rotate_right(TfheFheInt10 *a, uint32_t b, TfheFheInt10 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint10_neg(TfheFheInt10 *a, TfheFheInt10 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint10_not(TfheFheInt10 *a, TfheFheInt10 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint10_serialize(TfheFheInt10 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint10_deserialize(const uint8_t *data, size_t len, TfheFheInt10 **out)
{ return c_deserialize("FheInt10", data, len, (void **)out); }

int tfhe_fheint10_destroy(TfheFheInt10 *ct) { return c_destroy(ct); }

int tfhe_fheint12_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt12 **out)
{ return c_encrypt_u64("FheInt12", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint12_try_encrypt_trivial_u64(uint64_t value, TfheFheInt12 **out)
{ return c_encrypt_u64("FheInt12", value, 1, NULL, (void **)out); }

int tfhe_fheint12_decrypt_i64(TfheFheInt12 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint12_decrypt_u64(TfheFheInt12 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint12_decrypt_hex(TfheFheInt12 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint12_add(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint12_sub(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint12_mul(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint12_div(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint12_rem(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint12_bitand(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint12_bitor(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint12_bitxor(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint12_scalar_add(TfheFheInt12 *a, uint64_t b, TfheFheInt12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint12_scalar_sub(TfheFheInt12 *a, uint64_t b, TfheFheInt12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint12_scalar_mul(TfheFheInt12 *a, uint64_t b, TfheFheInt12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint12_scalar_shl(TfheFheInt12 *a, uint64_t b, TfheFheInt12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint12_scalar_shr(TfheFheInt12 *a, uint64_t b, TfheFheInt12 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint12_ge(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint12_gt(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint12_le(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint12_lt(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint12_eq(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint12_ne(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint12_min(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint12_max(TfheFheInt12 *a, TfheFheInt12 *b, TfheFheInt12 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint12_rotate_left(TfheFheInt12 *a, uint32_t b, TfheFheInt12 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint12_rotate_right(TfheFheInt12 *a, uint32_t b, TfheFheInt12 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint12_neg(TfheFheInt12 *a, TfheFheInt12 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint12_not(TfheFheInt12 *a, TfheFheInt12 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint12_serialize(TfheFheInt12 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint12_deserialize(const uint8_t *data, size_t len, TfheFheInt12 **out)
{ return c_deserialize("FheInt12", data, len, (void **)out); }

int tfhe_fheint12_destroy(TfheFheInt12 *ct) { return c_destroy(ct); }

int tfhe_fheint14_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt14 **out)
{ return c_encrypt_u64("FheInt14", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint14_try_encrypt_trivial_u64(uint64_t value, TfheFheInt14 **out)
{ return c_encrypt_u64("FheInt14", value, 1, NULL, (void **)out); }

int tfhe_fheint14_decrypt_i64(TfheFheInt14 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint14_decrypt_u64(TfheFheInt14 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint14_decrypt_hex(TfheFheInt14 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint14_add(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint14_sub(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint14_mul(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint14_div(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint14_rem(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint14_bitand(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint14_bitor(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint14_bitxor(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint14_scalar_add(TfheFheInt14 *a, uint64_t b, TfheFheInt14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint14_scalar_sub(TfheFheInt14 *a, uint64_t b, TfheFheInt14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint14_scalar_mul(TfheFheInt14 *a, uint64_t b, TfheFheInt14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint14_scalar_shl(TfheFheInt14 *a, uint64_t b, TfheFheInt14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint14_scalar_shr(TfheFheInt14 *a, uint64_t b, TfheFheInt14 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint14_ge(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint14_gt(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint14_le(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint14_lt(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint14_eq(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint14_ne(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint14_min(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint14_max(TfheFheInt14 *a, TfheFheInt14 *b, TfheFheInt14 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint14_rotate_left(TfheFheInt14 *a, uint32_t b, TfheFheInt14 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint14_rotate_right(TfheFheInt14 *a, uint32_t b, TfheFheInt14 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint14_neg(TfheFheInt14 *a, TfheFheInt14 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint14_not(TfheFheInt14 *a, TfheFheInt14 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint14_serialize(TfheFheInt14 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint14_deserialize(const uint8_t *data, size_t len, TfheFheInt14 **out)
{ return c_deserialize("FheInt14", data, len, (void **)out); }

int tfhe_fheint14_destroy(TfheFheInt14 *ct) { return c_destroy(ct); }

int tfhe_fheint16_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt16 **out)
{ return c_encrypt_u64("FheInt16", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint16_try_encrypt_trivial_u64(uint64_t value, TfheFheInt16 **out)
{ return c_encrypt_u64("FheInt16", value, 1, NULL, (void **)out); }

int tfhe_fheint16_decrypt_i64(TfheFheInt16 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint16_decrypt_u64(TfheFheInt16 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint16_decrypt_hex(TfheFheInt16 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint16_add(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint16_sub(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint16_mul(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint16_div(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint16_rem(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint16_bitand(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint16_bitor(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint16_bitxor(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint16_scalar_add(TfheFheInt16 *a, uint64_t b, TfheFheInt16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint16_scalar_sub(TfheFheInt16 *a, uint64_t b, TfheFheInt16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint16_scalar_mul(TfheFheInt16 *a, uint64_t b, TfheFheInt16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint16_scalar_shl(TfheFheInt16 *a, uint64_t b, TfheFheInt16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint16_scalar_shr(TfheFheInt16 *a, uint64_t b, TfheFheInt16 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint16_ge(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint16_gt(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint16_le(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint16_lt(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint16_eq(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint16_ne(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint16_min(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint16_max(TfheFheInt16 *a, TfheFheInt16 *b, TfheFheInt16 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint16_rotate_left(TfheFheInt16 *a, uint32_t b, TfheFheInt16 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint16_rotate_right(TfheFheInt16 *a, uint32_t b, TfheFheInt16 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint16_neg(TfheFheInt16 *a, TfheFheInt16 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint16_not(TfheFheInt16 *a, TfheFheInt16 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint16_serialize(TfheFheInt16 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint16_deserialize(const uint8_t *data, size_t len, TfheFheInt16 **out)
{ return c_deserialize("FheInt16", data, len, (void **)out); }

int tfhe_fheint16_destroy(TfheFheInt16 *ct) { return c_destroy(ct); }

int tfhe_fheint24_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt24 **out)
{ return c_encrypt_u64("FheInt24", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint24_try_encrypt_trivial_u64(uint64_t value, TfheFheInt24 **out)
{ return c_encrypt_u64("FheInt24", value, 1, NULL, (void **)out); }

int tfhe_fheint24_decrypt_i64(TfheFheInt24 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint24_decrypt_u64(TfheFheInt24 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint24_decrypt_hex(TfheFheInt24 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint24_add(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint24_sub(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint24_mul(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint24_div(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint24_rem(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint24_bitand(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint24_bitor(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint24_bitxor(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint24_scalar_add(TfheFheInt24 *a, uint64_t b, TfheFheInt24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint24_scalar_sub(TfheFheInt24 *a, uint64_t b, TfheFheInt24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint24_scalar_mul(TfheFheInt24 *a, uint64_t b, TfheFheInt24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint24_scalar_shl(TfheFheInt24 *a, uint64_t b, TfheFheInt24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint24_scalar_shr(TfheFheInt24 *a, uint64_t b, TfheFheInt24 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint24_ge(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint24_gt(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint24_le(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint24_lt(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint24_eq(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint24_ne(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint24_min(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint24_max(TfheFheInt24 *a, TfheFheInt24 *b, TfheFheInt24 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint24_rotate_left(TfheFheInt24 *a, uint32_t b, TfheFheInt24 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint24_rotate_right(TfheFheInt24 *a, uint32_t b, TfheFheInt24 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint24_neg(TfheFheInt24 *a, TfheFheInt24 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint24_not(TfheFheInt24 *a, TfheFheInt24 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint24_serialize(TfheFheInt24 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint24_deserialize(const uint8_t *data, size_t len, TfheFheInt24 **out)
{ return c_deserialize("FheInt24", data, len, (void **)out); }

int tfhe_fheint24_destroy(TfheFheInt24 *ct) { return c_destroy(ct); }

int tfhe_fheint32_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt32 **out)
{ return c_encrypt_u64("FheInt32", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint32_try_encrypt_trivial_u64(uint64_t value, TfheFheInt32 **out)
{ return c_encrypt_u64("FheInt32", value, 1, NULL, (void **)out); }

int tfhe_fheint32_decrypt_i64(TfheFheInt32 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint32_decrypt_u64(TfheFheInt32 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint32_decrypt_hex(TfheFheInt32 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint32_add(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint32_sub(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint32_mul(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint32_div(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint32_rem(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint32_bitand(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint32_bitor(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint32_bitxor(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint32_scalar_add(TfheFheInt32 *a, uint64_t b, TfheFheInt32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint32_scalar_sub(TfheFheInt32 *a, uint64_t b, TfheFheInt32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint32_scalar_mul(TfheFheInt32 *a, uint64_t b, TfheFheInt32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint32_scalar_shl(TfheFheInt32 *a, uint64_t b, TfheFheInt32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint32_scalar_shr(TfheFheInt32 *a, uint64_t b, TfheFheInt32 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint32_ge(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint32_gt(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint32_le(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint32_lt(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint32_eq(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint32_ne(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint32_min(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint32_max(TfheFheInt32 *a, TfheFheInt32 *b, TfheFheInt32 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint32_rotate_left(TfheFheInt32 *a, uint32_t b, TfheFheInt32 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint32_rotate_right(TfheFheInt32 *a, uint32_t b, TfheFheInt32 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint32_neg(TfheFheInt32 *a, TfheFheInt32 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint32_not(TfheFheInt32 *a, TfheFheInt32 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint32_serialize(TfheFheInt32 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint32_deserialize(const uint8_t *data, size_t len, TfheFheInt32 **out)
{ return c_deserialize("FheInt32", data, len, (void **)out); }

int tfhe_fheint32_destroy(TfheFheInt32 *ct) { return c_destroy(ct); }

int tfhe_fheint40_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt40 **out)
{ return c_encrypt_u64("FheInt40", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint40_try_encrypt_trivial_u64(uint64_t value, TfheFheInt40 **out)
{ return c_encrypt_u64("FheInt40", value, 1, NULL, (void **)out); }

int tfhe_fheint40_decrypt_i64(TfheFheInt40 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint40_decrypt_u64(TfheFheInt40 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint40_decrypt_hex(TfheFheInt40 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint40_add(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint40_sub(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint40_mul(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint40_div(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint40_rem(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint40_bitand(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint40_bitor(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint40_bitxor(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint40_scalar_add(TfheFheInt40 *a, uint64_t b, TfheFheInt40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint40_scalar_sub(TfheFheInt40 *a, uint64_t b, TfheFheInt40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint40_scalar_mul(TfheFheInt40 *a, uint64_t b, TfheFheInt40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint40_scalar_shl(TfheFheInt40 *a, uint64_t b, TfheFheInt40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint40_scalar_shr(TfheFheInt40 *a, uint64_t b, TfheFheInt40 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint40_ge(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint40_gt(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint40_le(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint40_lt(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint40_eq(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint40_ne(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint40_min(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint40_max(TfheFheInt40 *a, TfheFheInt40 *b, TfheFheInt40 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint40_rotate_left(TfheFheInt40 *a, uint32_t b, TfheFheInt40 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint40_rotate_right(TfheFheInt40 *a, uint32_t b, TfheFheInt40 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint40_neg(TfheFheInt40 *a, TfheFheInt40 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint40_not(TfheFheInt40 *a, TfheFheInt40 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint40_serialize(TfheFheInt40 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint40_deserialize(const uint8_t *data, size_t len, TfheFheInt40 **out)
{ return c_deserialize("FheInt40", data, len, (void **)out); }

int tfhe_fheint40_destroy(TfheFheInt40 *ct) { return c_destroy(ct); }

int tfhe_fheint48_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt48 **out)
{ return c_encrypt_u64("FheInt48", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint48_try_encrypt_trivial_u64(uint64_t value, TfheFheInt48 **out)
{ return c_encrypt_u64("FheInt48", value, 1, NULL, (void **)out); }

int tfhe_fheint48_decrypt_i64(TfheFheInt48 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint48_decrypt_u64(TfheFheInt48 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint48_decrypt_hex(TfheFheInt48 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint48_add(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint48_sub(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint48_mul(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint48_div(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint48_rem(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint48_bitand(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint48_bitor(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint48_bitxor(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint48_scalar_add(TfheFheInt48 *a, uint64_t b, TfheFheInt48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint48_scalar_sub(TfheFheInt48 *a, uint64_t b, TfheFheInt48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint48_scalar_mul(TfheFheInt48 *a, uint64_t b, TfheFheInt48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint48_scalar_shl(TfheFheInt48 *a, uint64_t b, TfheFheInt48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint48_scalar_shr(TfheFheInt48 *a, uint64_t b, TfheFheInt48 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint48_ge(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint48_gt(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint48_le(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint48_lt(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint48_eq(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint48_ne(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint48_min(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint48_max(TfheFheInt48 *a, TfheFheInt48 *b, TfheFheInt48 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint48_rotate_left(TfheFheInt48 *a, uint32_t b, TfheFheInt48 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint48_rotate_right(TfheFheInt48 *a, uint32_t b, TfheFheInt48 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint48_neg(TfheFheInt48 *a, TfheFheInt48 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint48_not(TfheFheInt48 *a, TfheFheInt48 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint48_serialize(TfheFheInt48 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint48_deserialize(const uint8_t *data, size_t len, TfheFheInt48 **out)
{ return c_deserialize("FheInt48", data, len, (void **)out); }

int tfhe_fheint48_destroy(TfheFheInt48 *ct) { return c_destroy(ct); }

int tfhe_fheint56_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt56 **out)
{ return c_encrypt_u64("FheInt56", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint56_try_encrypt_trivial_u64(uint64_t value, TfheFheInt56 **out)
{ return c_encrypt_u64("FheInt56", value, 1, NULL, (void **)out); }

int tfhe_fheint56_decrypt_i64(TfheFheInt56 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint56_decrypt_u64(TfheFheInt56 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint56_decrypt_hex(TfheFheInt56 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint56_add(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint56_sub(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint56_mul(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint56_div(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint56_rem(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint56_bitand(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint56_bitor(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint56_bitxor(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint56_scalar_add(TfheFheInt56 *a, uint64_t b, TfheFheInt56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint56_scalar_sub(TfheFheInt56 *a, uint64_t b, TfheFheInt56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint56_scalar_mul(TfheFheInt56 *a, uint64_t b, TfheFheInt56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint56_scalar_shl(TfheFheInt56 *a, uint64_t b, TfheFheInt56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint56_scalar_shr(TfheFheInt56 *a, uint64_t b, TfheFheInt56 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint56_ge(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint56_gt(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint56_le(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint56_lt(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint56_eq(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint56_ne(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint56_min(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint56_max(TfheFheInt56 *a, TfheFheInt56 *b, TfheFheInt56 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint56_rotate_left(TfheFheInt56 *a, uint32_t b, TfheFheInt56 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint56_rotate_right(TfheFheInt56 *a, uint32_t b, TfheFheInt56 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint56_neg(TfheFheInt56 *a, TfheFheInt56 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint56_not(TfheFheInt56 *a, TfheFheInt56 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint56_serialize(TfheFheInt56 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint56_deserialize(const uint8_t *data, size_t len, TfheFheInt56 **out)
{ return c_deserialize("FheInt56", data, len, (void **)out); }

int tfhe_fheint56_destroy(TfheFheInt56 *ct) { return c_destroy(ct); }

int tfhe_fheint64_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt64 **out)
{ return c_encrypt_u64("FheInt64", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint64_try_encrypt_trivial_u64(uint64_t value, TfheFheInt64 **out)
{ return c_encrypt_u64("FheInt64", value, 1, NULL, (void **)out); }

int tfhe_fheint64_decrypt_i64(TfheFheInt64 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint64_decrypt_u64(TfheFheInt64 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint64_decrypt_hex(TfheFheInt64 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint64_add(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint64_sub(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint64_mul(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint64_div(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint64_rem(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint64_bitand(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint64_bitor(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint64_bitxor(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint64_scalar_add(TfheFheInt64 *a, uint64_t b, TfheFheInt64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint64_scalar_sub(TfheFheInt64 *a, uint64_t b, TfheFheInt64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint64_scalar_mul(TfheFheInt64 *a, uint64_t b, TfheFheInt64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint64_scalar_shl(TfheFheInt64 *a, uint64_t b, TfheFheInt64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint64_scalar_shr(TfheFheInt64 *a, uint64_t b, TfheFheInt64 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint64_ge(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint64_gt(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint64_le(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint64_lt(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint64_eq(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint64_ne(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint64_min(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint64_max(TfheFheInt64 *a, TfheFheInt64 *b, TfheFheInt64 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint64_rotate_left(TfheFheInt64 *a, uint32_t b, TfheFheInt64 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint64_rotate_right(TfheFheInt64 *a, uint32_t b, TfheFheInt64 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint64_neg(TfheFheInt64 *a, TfheFheInt64 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint64_not(TfheFheInt64 *a, TfheFheInt64 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint64_serialize(TfheFheInt64 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint64_deserialize(const uint8_t *data, size_t len, TfheFheInt64 **out)
{ return c_deserialize("FheInt64", data, len, (void **)out); }

int tfhe_fheint64_destroy(TfheFheInt64 *ct) { return c_destroy(ct); }

int tfhe_fheint72_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt72 **out)
{ return c_encrypt_u64("FheInt72", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint72_try_encrypt_trivial_u64(uint64_t value, TfheFheInt72 **out)
{ return c_encrypt_u64("FheInt72", value, 1, NULL, (void **)out); }

int tfhe_fheint72_decrypt_i64(TfheFheInt72 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint72_decrypt_u64(TfheFheInt72 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint72_decrypt_hex(TfheFheInt72 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint72_add(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint72_sub(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint72_mul(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint72_div(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint72_rem(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint72_bitand(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint72_bitor(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint72_bitxor(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint72_scalar_add(TfheFheInt72 *a, uint64_t b, TfheFheInt72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint72_scalar_sub(TfheFheInt72 *a, uint64_t b, TfheFheInt72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint72_scalar_mul(TfheFheInt72 *a, uint64_t b, TfheFheInt72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint72_scalar_shl(TfheFheInt72 *a, uint64_t b, TfheFheInt72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint72_scalar_shr(TfheFheInt72 *a, uint64_t b, TfheFheInt72 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint72_ge(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint72_gt(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint72_le(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint72_lt(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint72_eq(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint72_ne(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint72_min(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint72_max(TfheFheInt72 *a, TfheFheInt72 *b, TfheFheInt72 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint72_rotate_left(TfheFheInt72 *a, uint32_t b, TfheFheInt72 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint72_rotate_right(TfheFheInt72 *a, uint32_t b, TfheFheInt72 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint72_neg(TfheFheInt72 *a, TfheFheInt72 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint72_not(TfheFheInt72 *a, TfheFheInt72 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint72_serialize(TfheFheInt72 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint72_deserialize(const uint8_t *data, size_t len, TfheFheInt72 **out)
{ return c_deserialize("FheInt72", data, len, (void **)out); }

int tfhe_fheint72_destroy(TfheFheInt72 *ct) { return c_destroy(ct); }

int tfhe_fheint80_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt80 **out)
{ return c_encrypt_u64("FheInt80", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint80_try_encrypt_trivial_u64(uint64_t value, TfheFheInt80 **out)
{ return c_encrypt_u64("FheInt80", value, 1, NULL, (void **)out); }

int tfhe_fheint80_decrypt_i64(TfheFheInt80 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint80_decrypt_u64(TfheFheInt80 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint80_decrypt_hex(TfheFheInt80 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint80_add(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint80_sub(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint80_mul(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint80_div(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint80_rem(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint80_bitand(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint80_bitor(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint80_bitxor(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint80_scalar_add(TfheFheInt80 *a, uint64_t b, TfheFheInt80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint80_scalar_sub(TfheFheInt80 *a, uint64_t b, TfheFheInt80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint80_scalar_mul(TfheFheInt80 *a, uint64_t b, TfheFheInt80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint80_scalar_shl(TfheFheInt80 *a, uint64_t b, TfheFheInt80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint80_scalar_shr(TfheFheInt80 *a, uint64_t b, TfheFheInt80 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint80_ge(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint80_gt(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint80_le(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint80_lt(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint80_eq(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint80_ne(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint80_min(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint80_max(TfheFheInt80 *a, TfheFheInt80 *b, TfheFheInt80 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint80_rotate_left(TfheFheInt80 *a, uint32_t b, TfheFheInt80 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint80_rotate_right(TfheFheInt80 *a, uint32_t b, TfheFheInt80 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint80_neg(TfheFheInt80 *a, TfheFheInt80 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint80_not(TfheFheInt80 *a, TfheFheInt80 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint80_serialize(TfheFheInt80 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint80_deserialize(const uint8_t *data, size_t len, TfheFheInt80 **out)
{ return c_deserialize("FheInt80", data, len, (void **)out); }

int tfhe_fheint80_destroy(TfheFheInt80 *ct) { return c_destroy(ct); }

int tfhe_fheint88_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt88 **out)
{ return c_encrypt_u64("FheInt88", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint88_try_encrypt_trivial_u64(uint64_t value, TfheFheInt88 **out)
{ return c_encrypt_u64("FheInt88", value, 1, NULL, (void **)out); }

int tfhe_fheint88_decrypt_i64(TfheFheInt88 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint88_decrypt_u64(TfheFheInt88 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint88_decrypt_hex(TfheFheInt88 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint88_add(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint88_sub(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint88_mul(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint88_div(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint88_rem(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint88_bitand(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint88_bitor(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint88_bitxor(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint88_scalar_add(TfheFheInt88 *a, uint64_t b, TfheFheInt88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint88_scalar_sub(TfheFheInt88 *a, uint64_t b, TfheFheInt88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint88_scalar_mul(TfheFheInt88 *a, uint64_t b, TfheFheInt88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint88_scalar_shl(TfheFheInt88 *a, uint64_t b, TfheFheInt88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint88_scalar_shr(TfheFheInt88 *a, uint64_t b, TfheFheInt88 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint88_ge(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint88_gt(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint88_le(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint88_lt(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint88_eq(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint88_ne(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint88_min(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint88_max(TfheFheInt88 *a, TfheFheInt88 *b, TfheFheInt88 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint88_rotate_left(TfheFheInt88 *a, uint32_t b, TfheFheInt88 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint88_rotate_right(TfheFheInt88 *a, uint32_t b, TfheFheInt88 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint88_neg(TfheFheInt88 *a, TfheFheInt88 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint88_not(TfheFheInt88 *a, TfheFheInt88 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint88_serialize(TfheFheInt88 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint88_deserialize(const uint8_t *data, size_t len, TfheFheInt88 **out)
{ return c_deserialize("FheInt88", data, len, (void **)out); }

int tfhe_fheint88_destroy(TfheFheInt88 *ct) { return c_destroy(ct); }

int tfhe_fheint96_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt96 **out)
{ return c_encrypt_u64("FheInt96", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint96_try_encrypt_trivial_u64(uint64_t value, TfheFheInt96 **out)
{ return c_encrypt_u64("FheInt96", value, 1, NULL, (void **)out); }

int tfhe_fheint96_decrypt_i64(TfheFheInt96 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint96_decrypt_u64(TfheFheInt96 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint96_decrypt_hex(TfheFheInt96 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint96_add(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint96_sub(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint96_mul(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint96_div(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint96_rem(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint96_bitand(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint96_bitor(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint96_bitxor(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint96_scalar_add(TfheFheInt96 *a, uint64_t b, TfheFheInt96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint96_scalar_sub(TfheFheInt96 *a, uint64_t b, TfheFheInt96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint96_scalar_mul(TfheFheInt96 *a, uint64_t b, TfheFheInt96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint96_scalar_shl(TfheFheInt96 *a, uint64_t b, TfheFheInt96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint96_scalar_shr(TfheFheInt96 *a, uint64_t b, TfheFheInt96 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint96_ge(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint96_gt(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint96_le(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint96_lt(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint96_eq(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint96_ne(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint96_min(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint96_max(TfheFheInt96 *a, TfheFheInt96 *b, TfheFheInt96 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint96_rotate_left(TfheFheInt96 *a, uint32_t b, TfheFheInt96 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint96_rotate_right(TfheFheInt96 *a, uint32_t b, TfheFheInt96 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint96_neg(TfheFheInt96 *a, TfheFheInt96 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint96_not(TfheFheInt96 *a, TfheFheInt96 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint96_serialize(TfheFheInt96 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint96_deserialize(const uint8_t *data, size_t len, TfheFheInt96 **out)
{ return c_deserialize("FheInt96", data, len, (void **)out); }

int tfhe_fheint96_destroy(TfheFheInt96 *ct) { return c_destroy(ct); }

int tfhe_fheint104_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt104 **out)
{ return c_encrypt_u64("FheInt104", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint104_try_encrypt_trivial_u64(uint64_t value, TfheFheInt104 **out)
{ return c_encrypt_u64("FheInt104", value, 1, NULL, (void **)out); }

int tfhe_fheint104_decrypt_i64(TfheFheInt104 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint104_decrypt_u64(TfheFheInt104 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint104_decrypt_hex(TfheFheInt104 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint104_add(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint104_sub(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint104_mul(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint104_div(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint104_rem(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint104_bitand(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint104_bitor(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint104_bitxor(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint104_scalar_add(TfheFheInt104 *a, uint64_t b, TfheFheInt104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint104_scalar_sub(TfheFheInt104 *a, uint64_t b, TfheFheInt104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint104_scalar_mul(TfheFheInt104 *a, uint64_t b, TfheFheInt104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint104_scalar_shl(TfheFheInt104 *a, uint64_t b, TfheFheInt104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint104_scalar_shr(TfheFheInt104 *a, uint64_t b, TfheFheInt104 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint104_ge(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint104_gt(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint104_le(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint104_lt(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint104_eq(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint104_ne(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint104_min(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint104_max(TfheFheInt104 *a, TfheFheInt104 *b, TfheFheInt104 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint104_rotate_left(TfheFheInt104 *a, uint32_t b, TfheFheInt104 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint104_rotate_right(TfheFheInt104 *a, uint32_t b, TfheFheInt104 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint104_neg(TfheFheInt104 *a, TfheFheInt104 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint104_not(TfheFheInt104 *a, TfheFheInt104 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint104_serialize(TfheFheInt104 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint104_deserialize(const uint8_t *data, size_t len, TfheFheInt104 **out)
{ return c_deserialize("FheInt104", data, len, (void **)out); }

int tfhe_fheint104_destroy(TfheFheInt104 *ct) { return c_destroy(ct); }

int tfhe_fheint112_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt112 **out)
{ return c_encrypt_u64("FheInt112", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint112_try_encrypt_trivial_u64(uint64_t value, TfheFheInt112 **out)
{ return c_encrypt_u64("FheInt112", value, 1, NULL, (void **)out); }

int tfhe_fheint112_decrypt_i64(TfheFheInt112 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint112_decrypt_u64(TfheFheInt112 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint112_decrypt_hex(TfheFheInt112 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint112_add(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint112_sub(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint112_mul(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint112_div(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint112_rem(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint112_bitand(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint112_bitor(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint112_bitxor(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint112_scalar_add(TfheFheInt112 *a, uint64_t b, TfheFheInt112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint112_scalar_sub(TfheFheInt112 *a, uint64_t b, TfheFheInt112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint112_scalar_mul(TfheFheInt112 *a, uint64_t b, TfheFheInt112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint112_scalar_shl(TfheFheInt112 *a, uint64_t b, TfheFheInt112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint112_scalar_shr(TfheFheInt112 *a, uint64_t b, TfheFheInt112 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint112_ge(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint112_gt(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint112_le(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint112_lt(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint112_eq(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint112_ne(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint112_min(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint112_max(TfheFheInt112 *a, TfheFheInt112 *b, TfheFheInt112 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint112_rotate_left(TfheFheInt112 *a, uint32_t b, TfheFheInt112 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint112_rotate_right(TfheFheInt112 *a, uint32_t b, TfheFheInt112 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint112_neg(TfheFheInt112 *a, TfheFheInt112 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint112_not(TfheFheInt112 *a, TfheFheInt112 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint112_serialize(TfheFheInt112 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint112_deserialize(const uint8_t *data, size_t len, TfheFheInt112 **out)
{ return c_deserialize("FheInt112", data, len, (void **)out); }

int tfhe_fheint112_destroy(TfheFheInt112 *ct) { return c_destroy(ct); }

int tfhe_fheint120_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt120 **out)
{ return c_encrypt_u64("FheInt120", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint120_try_encrypt_trivial_u64(uint64_t value, TfheFheInt120 **out)
{ return c_encrypt_u64("FheInt120", value, 1, NULL, (void **)out); }

int tfhe_fheint120_decrypt_i64(TfheFheInt120 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint120_decrypt_u64(TfheFheInt120 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint120_decrypt_hex(TfheFheInt120 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint120_add(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint120_sub(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint120_mul(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint120_div(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint120_rem(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint120_bitand(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint120_bitor(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint120_bitxor(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint120_scalar_add(TfheFheInt120 *a, uint64_t b, TfheFheInt120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint120_scalar_sub(TfheFheInt120 *a, uint64_t b, TfheFheInt120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint120_scalar_mul(TfheFheInt120 *a, uint64_t b, TfheFheInt120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint120_scalar_shl(TfheFheInt120 *a, uint64_t b, TfheFheInt120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint120_scalar_shr(TfheFheInt120 *a, uint64_t b, TfheFheInt120 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint120_ge(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint120_gt(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint120_le(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint120_lt(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint120_eq(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint120_ne(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint120_min(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint120_max(TfheFheInt120 *a, TfheFheInt120 *b, TfheFheInt120 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint120_rotate_left(TfheFheInt120 *a, uint32_t b, TfheFheInt120 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint120_rotate_right(TfheFheInt120 *a, uint32_t b, TfheFheInt120 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint120_neg(TfheFheInt120 *a, TfheFheInt120 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint120_not(TfheFheInt120 *a, TfheFheInt120 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint120_serialize(TfheFheInt120 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint120_deserialize(const uint8_t *data, size_t len, TfheFheInt120 **out)
{ return c_deserialize("FheInt120", data, len, (void **)out); }

int tfhe_fheint120_destroy(TfheFheInt120 *ct) { return c_destroy(ct); }

int tfhe_fheint128_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt128 **out)
{ return c_encrypt_u64("FheInt128", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint128_try_encrypt_trivial_u64(uint64_t value, TfheFheInt128 **out)
{ return c_encrypt_u64("FheInt128", value, 1, NULL, (void **)out); }

int tfhe_fheint128_decrypt_i64(TfheFheInt128 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint128_decrypt_u64(TfheFheInt128 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint128_decrypt_hex(TfheFheInt128 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint128_add(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint128_sub(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint128_mul(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint128_div(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint128_rem(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint128_bitand(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint128_bitor(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint128_bitxor(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint128_scalar_add(TfheFheInt128 *a, uint64_t b, TfheFheInt128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint128_scalar_sub(TfheFheInt128 *a, uint64_t b, TfheFheInt128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint128_scalar_mul(TfheFheInt128 *a, uint64_t b, TfheFheInt128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint128_scalar_shl(TfheFheInt128 *a, uint64_t b, TfheFheInt128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint128_scalar_shr(TfheFheInt128 *a, uint64_t b, TfheFheInt128 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint128_ge(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint128_gt(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint128_le(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint128_lt(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint128_eq(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint128_ne(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint128_min(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint128_max(TfheFheInt128 *a, TfheFheInt128 *b, TfheFheInt128 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint128_rotate_left(TfheFheInt128 *a, uint32_t b, TfheFheInt128 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint128_rotate_right(TfheFheInt128 *a, uint32_t b, TfheFheInt128 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint128_neg(TfheFheInt128 *a, TfheFheInt128 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint128_not(TfheFheInt128 *a, TfheFheInt128 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint128_serialize(TfheFheInt128 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint128_deserialize(const uint8_t *data, size_t len, TfheFheInt128 **out)
{ return c_deserialize("FheInt128", data, len, (void **)out); }

int tfhe_fheint128_destroy(TfheFheInt128 *ct) { return c_destroy(ct); }

int tfhe_fheint136_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt136 **out)
{ return c_encrypt_u64("FheInt136", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint136_try_encrypt_trivial_u64(uint64_t value, TfheFheInt136 **out)
{ return c_encrypt_u64("FheInt136", value, 1, NULL, (void **)out); }

int tfhe_fheint136_decrypt_i64(TfheFheInt136 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint136_decrypt_u64(TfheFheInt136 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint136_decrypt_hex(TfheFheInt136 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint136_add(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint136_sub(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint136_mul(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint136_div(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint136_rem(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint136_bitand(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint136_bitor(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint136_bitxor(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint136_scalar_add(TfheFheInt136 *a, uint64_t b, TfheFheInt136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint136_scalar_sub(TfheFheInt136 *a, uint64_t b, TfheFheInt136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint136_scalar_mul(TfheFheInt136 *a, uint64_t b, TfheFheInt136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint136_scalar_shl(TfheFheInt136 *a, uint64_t b, TfheFheInt136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint136_scalar_shr(TfheFheInt136 *a, uint64_t b, TfheFheInt136 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint136_ge(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint136_gt(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint136_le(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint136_lt(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint136_eq(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint136_ne(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint136_min(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint136_max(TfheFheInt136 *a, TfheFheInt136 *b, TfheFheInt136 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint136_rotate_left(TfheFheInt136 *a, uint32_t b, TfheFheInt136 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint136_rotate_right(TfheFheInt136 *a, uint32_t b, TfheFheInt136 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint136_neg(TfheFheInt136 *a, TfheFheInt136 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint136_not(TfheFheInt136 *a, TfheFheInt136 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint136_serialize(TfheFheInt136 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint136_deserialize(const uint8_t *data, size_t len, TfheFheInt136 **out)
{ return c_deserialize("FheInt136", data, len, (void **)out); }

int tfhe_fheint136_destroy(TfheFheInt136 *ct) { return c_destroy(ct); }

int tfhe_fheint144_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt144 **out)
{ return c_encrypt_u64("FheInt144", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint144_try_encrypt_trivial_u64(uint64_t value, TfheFheInt144 **out)
{ return c_encrypt_u64("FheInt144", value, 1, NULL, (void **)out); }

int tfhe_fheint144_decrypt_i64(TfheFheInt144 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint144_decrypt_u64(TfheFheInt144 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint144_decrypt_hex(TfheFheInt144 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint144_add(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint144_sub(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint144_mul(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint144_div(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint144_rem(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint144_bitand(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint144_bitor(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint144_bitxor(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint144_scalar_add(TfheFheInt144 *a, uint64_t b, TfheFheInt144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint144_scalar_sub(TfheFheInt144 *a, uint64_t b, TfheFheInt144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint144_scalar_mul(TfheFheInt144 *a, uint64_t b, TfheFheInt144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint144_scalar_shl(TfheFheInt144 *a, uint64_t b, TfheFheInt144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint144_scalar_shr(TfheFheInt144 *a, uint64_t b, TfheFheInt144 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint144_ge(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint144_gt(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint144_le(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint144_lt(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint144_eq(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint144_ne(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint144_min(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint144_max(TfheFheInt144 *a, TfheFheInt144 *b, TfheFheInt144 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint144_rotate_left(TfheFheInt144 *a, uint32_t b, TfheFheInt144 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint144_rotate_right(TfheFheInt144 *a, uint32_t b, TfheFheInt144 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint144_neg(TfheFheInt144 *a, TfheFheInt144 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint144_not(TfheFheInt144 *a, TfheFheInt144 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint144_serialize(TfheFheInt144 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint144_deserialize(const uint8_t *data, size_t len, TfheFheInt144 **out)
{ return c_deserialize("FheInt144", data, len, (void **)out); }

int tfhe_fheint144_destroy(TfheFheInt144 *ct) { return c_destroy(ct); }

int tfhe_fheint152_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt152 **out)
{ return c_encrypt_u64("FheInt152", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint152_try_encrypt_trivial_u64(uint64_t value, TfheFheInt152 **out)
{ return c_encrypt_u64("FheInt152", value, 1, NULL, (void **)out); }

int tfhe_fheint152_decrypt_i64(TfheFheInt152 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint152_decrypt_u64(TfheFheInt152 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint152_decrypt_hex(TfheFheInt152 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint152_add(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint152_sub(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint152_mul(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint152_div(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint152_rem(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint152_bitand(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint152_bitor(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint152_bitxor(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint152_scalar_add(TfheFheInt152 *a, uint64_t b, TfheFheInt152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint152_scalar_sub(TfheFheInt152 *a, uint64_t b, TfheFheInt152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint152_scalar_mul(TfheFheInt152 *a, uint64_t b, TfheFheInt152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint152_scalar_shl(TfheFheInt152 *a, uint64_t b, TfheFheInt152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint152_scalar_shr(TfheFheInt152 *a, uint64_t b, TfheFheInt152 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint152_ge(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint152_gt(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint152_le(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint152_lt(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint152_eq(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint152_ne(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint152_min(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint152_max(TfheFheInt152 *a, TfheFheInt152 *b, TfheFheInt152 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint152_rotate_left(TfheFheInt152 *a, uint32_t b, TfheFheInt152 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint152_rotate_right(TfheFheInt152 *a, uint32_t b, TfheFheInt152 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint152_neg(TfheFheInt152 *a, TfheFheInt152 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint152_not(TfheFheInt152 *a, TfheFheInt152 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint152_serialize(TfheFheInt152 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint152_deserialize(const uint8_t *data, size_t len, TfheFheInt152 **out)
{ return c_deserialize("FheInt152", data, len, (void **)out); }

int tfhe_fheint152_destroy(TfheFheInt152 *ct) { return c_destroy(ct); }

int tfhe_fheint160_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt160 **out)
{ return c_encrypt_u64("FheInt160", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint160_try_encrypt_trivial_u64(uint64_t value, TfheFheInt160 **out)
{ return c_encrypt_u64("FheInt160", value, 1, NULL, (void **)out); }

int tfhe_fheint160_decrypt_i64(TfheFheInt160 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint160_decrypt_u64(TfheFheInt160 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint160_decrypt_hex(TfheFheInt160 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint160_add(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint160_sub(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint160_mul(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint160_div(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint160_rem(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint160_bitand(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint160_bitor(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint160_bitxor(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint160_scalar_add(TfheFheInt160 *a, uint64_t b, TfheFheInt160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint160_scalar_sub(TfheFheInt160 *a, uint64_t b, TfheFheInt160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint160_scalar_mul(TfheFheInt160 *a, uint64_t b, TfheFheInt160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint160_scalar_shl(TfheFheInt160 *a, uint64_t b, TfheFheInt160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint160_scalar_shr(TfheFheInt160 *a, uint64_t b, TfheFheInt160 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint160_ge(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint160_gt(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint160_le(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint160_lt(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint160_eq(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint160_ne(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint160_min(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint160_max(TfheFheInt160 *a, TfheFheInt160 *b, TfheFheInt160 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint160_rotate_left(TfheFheInt160 *a, uint32_t b, TfheFheInt160 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint160_rotate_right(TfheFheInt160 *a, uint32_t b, TfheFheInt160 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint160_neg(TfheFheInt160 *a, TfheFheInt160 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint160_not(TfheFheInt160 *a, TfheFheInt160 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint160_serialize(TfheFheInt160 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint160_deserialize(const uint8_t *data, size_t len, TfheFheInt160 **out)
{ return c_deserialize("FheInt160", data, len, (void **)out); }

int tfhe_fheint160_destroy(TfheFheInt160 *ct) { return c_destroy(ct); }

int tfhe_fheint168_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt168 **out)
{ return c_encrypt_u64("FheInt168", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint168_try_encrypt_trivial_u64(uint64_t value, TfheFheInt168 **out)
{ return c_encrypt_u64("FheInt168", value, 1, NULL, (void **)out); }

int tfhe_fheint168_decrypt_i64(TfheFheInt168 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint168_decrypt_u64(TfheFheInt168 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint168_decrypt_hex(TfheFheInt168 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint168_add(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint168_sub(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint168_mul(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint168_div(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint168_rem(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint168_bitand(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint168_bitor(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint168_bitxor(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint168_scalar_add(TfheFheInt168 *a, uint64_t b, TfheFheInt168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint168_scalar_sub(TfheFheInt168 *a, uint64_t b, TfheFheInt168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint168_scalar_mul(TfheFheInt168 *a, uint64_t b, TfheFheInt168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint168_scalar_shl(TfheFheInt168 *a, uint64_t b, TfheFheInt168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint168_scalar_shr(TfheFheInt168 *a, uint64_t b, TfheFheInt168 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint168_ge(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint168_gt(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint168_le(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint168_lt(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint168_eq(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint168_ne(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint168_min(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint168_max(TfheFheInt168 *a, TfheFheInt168 *b, TfheFheInt168 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint168_rotate_left(TfheFheInt168 *a, uint32_t b, TfheFheInt168 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint168_rotate_right(TfheFheInt168 *a, uint32_t b, TfheFheInt168 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint168_neg(TfheFheInt168 *a, TfheFheInt168 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint168_not(TfheFheInt168 *a, TfheFheInt168 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint168_serialize(TfheFheInt168 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint168_deserialize(const uint8_t *data, size_t len, TfheFheInt168 **out)
{ return c_deserialize("FheInt168", data, len, (void **)out); }

int tfhe_fheint168_destroy(TfheFheInt168 *ct) { return c_destroy(ct); }

int tfhe_fheint176_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt176 **out)
{ return c_encrypt_u64("FheInt176", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint176_try_encrypt_trivial_u64(uint64_t value, TfheFheInt176 **out)
{ return c_encrypt_u64("FheInt176", value, 1, NULL, (void **)out); }

int tfhe_fheint176_decrypt_i64(TfheFheInt176 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint176_decrypt_u64(TfheFheInt176 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint176_decrypt_hex(TfheFheInt176 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint176_add(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint176_sub(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint176_mul(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint176_div(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint176_rem(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint176_bitand(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint176_bitor(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint176_bitxor(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint176_scalar_add(TfheFheInt176 *a, uint64_t b, TfheFheInt176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint176_scalar_sub(TfheFheInt176 *a, uint64_t b, TfheFheInt176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint176_scalar_mul(TfheFheInt176 *a, uint64_t b, TfheFheInt176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint176_scalar_shl(TfheFheInt176 *a, uint64_t b, TfheFheInt176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint176_scalar_shr(TfheFheInt176 *a, uint64_t b, TfheFheInt176 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint176_ge(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint176_gt(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint176_le(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint176_lt(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint176_eq(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint176_ne(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint176_min(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint176_max(TfheFheInt176 *a, TfheFheInt176 *b, TfheFheInt176 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint176_rotate_left(TfheFheInt176 *a, uint32_t b, TfheFheInt176 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint176_rotate_right(TfheFheInt176 *a, uint32_t b, TfheFheInt176 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint176_neg(TfheFheInt176 *a, TfheFheInt176 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint176_not(TfheFheInt176 *a, TfheFheInt176 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint176_serialize(TfheFheInt176 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint176_deserialize(const uint8_t *data, size_t len, TfheFheInt176 **out)
{ return c_deserialize("FheInt176", data, len, (void **)out); }

int tfhe_fheint176_destroy(TfheFheInt176 *ct) { return c_destroy(ct); }

int tfhe_fheint184_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt184 **out)
{ return c_encrypt_u64("FheInt184", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint184_try_encrypt_trivial_u64(uint64_t value, TfheFheInt184 **out)
{ return c_encrypt_u64("FheInt184", value, 1, NULL, (void **)out); }

int tfhe_fheint184_decrypt_i64(TfheFheInt184 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint184_decrypt_u64(TfheFheInt184 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint184_decrypt_hex(TfheFheInt184 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint184_add(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint184_sub(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint184_mul(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint184_div(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint184_rem(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint184_bitand(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint184_bitor(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint184_bitxor(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint184_scalar_add(TfheFheInt184 *a, uint64_t b, TfheFheInt184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint184_scalar_sub(TfheFheInt184 *a, uint64_t b, TfheFheInt184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint184_scalar_mul(TfheFheInt184 *a, uint64_t b, TfheFheInt184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint184_scalar_shl(TfheFheInt184 *a, uint64_t b, TfheFheInt184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint184_scalar_shr(TfheFheInt184 *a, uint64_t b, TfheFheInt184 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint184_ge(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint184_gt(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint184_le(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint184_lt(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint184_eq(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint184_ne(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint184_min(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint184_max(TfheFheInt184 *a, TfheFheInt184 *b, TfheFheInt184 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint184_rotate_left(TfheFheInt184 *a, uint32_t b, TfheFheInt184 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint184_rotate_right(TfheFheInt184 *a, uint32_t b, TfheFheInt184 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint184_neg(TfheFheInt184 *a, TfheFheInt184 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint184_not(TfheFheInt184 *a, TfheFheInt184 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint184_serialize(TfheFheInt184 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint184_deserialize(const uint8_t *data, size_t len, TfheFheInt184 **out)
{ return c_deserialize("FheInt184", data, len, (void **)out); }

int tfhe_fheint184_destroy(TfheFheInt184 *ct) { return c_destroy(ct); }

int tfhe_fheint192_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt192 **out)
{ return c_encrypt_u64("FheInt192", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint192_try_encrypt_trivial_u64(uint64_t value, TfheFheInt192 **out)
{ return c_encrypt_u64("FheInt192", value, 1, NULL, (void **)out); }

int tfhe_fheint192_decrypt_i64(TfheFheInt192 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint192_decrypt_u64(TfheFheInt192 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint192_decrypt_hex(TfheFheInt192 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint192_add(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint192_sub(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint192_mul(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint192_div(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint192_rem(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint192_bitand(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint192_bitor(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint192_bitxor(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint192_scalar_add(TfheFheInt192 *a, uint64_t b, TfheFheInt192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint192_scalar_sub(TfheFheInt192 *a, uint64_t b, TfheFheInt192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint192_scalar_mul(TfheFheInt192 *a, uint64_t b, TfheFheInt192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint192_scalar_shl(TfheFheInt192 *a, uint64_t b, TfheFheInt192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint192_scalar_shr(TfheFheInt192 *a, uint64_t b, TfheFheInt192 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint192_ge(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint192_gt(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint192_le(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint192_lt(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint192_eq(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint192_ne(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint192_min(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint192_max(TfheFheInt192 *a, TfheFheInt192 *b, TfheFheInt192 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint192_rotate_left(TfheFheInt192 *a, uint32_t b, TfheFheInt192 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint192_rotate_right(TfheFheInt192 *a, uint32_t b, TfheFheInt192 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint192_neg(TfheFheInt192 *a, TfheFheInt192 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint192_not(TfheFheInt192 *a, TfheFheInt192 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint192_serialize(TfheFheInt192 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint192_deserialize(const uint8_t *data, size_t len, TfheFheInt192 **out)
{ return c_deserialize("FheInt192", data, len, (void **)out); }

int tfhe_fheint192_destroy(TfheFheInt192 *ct) { return c_destroy(ct); }

int tfhe_fheint200_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt200 **out)
{ return c_encrypt_u64("FheInt200", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint200_try_encrypt_trivial_u64(uint64_t value, TfheFheInt200 **out)
{ return c_encrypt_u64("FheInt200", value, 1, NULL, (void **)out); }

int tfhe_fheint200_decrypt_i64(TfheFheInt200 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint200_decrypt_u64(TfheFheInt200 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint200_decrypt_hex(TfheFheInt200 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint200_add(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint200_sub(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint200_mul(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint200_div(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint200_rem(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint200_bitand(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint200_bitor(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint200_bitxor(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint200_scalar_add(TfheFheInt200 *a, uint64_t b, TfheFheInt200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint200_scalar_sub(TfheFheInt200 *a, uint64_t b, TfheFheInt200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint200_scalar_mul(TfheFheInt200 *a, uint64_t b, TfheFheInt200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint200_scalar_shl(TfheFheInt200 *a, uint64_t b, TfheFheInt200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint200_scalar_shr(TfheFheInt200 *a, uint64_t b, TfheFheInt200 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint200_ge(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint200_gt(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint200_le(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint200_lt(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint200_eq(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint200_ne(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint200_min(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint200_max(TfheFheInt200 *a, TfheFheInt200 *b, TfheFheInt200 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint200_rotate_left(TfheFheInt200 *a, uint32_t b, TfheFheInt200 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint200_rotate_right(TfheFheInt200 *a, uint32_t b, TfheFheInt200 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint200_neg(TfheFheInt200 *a, TfheFheInt200 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint200_not(TfheFheInt200 *a, TfheFheInt200 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint200_serialize(TfheFheInt200 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint200_deserialize(const uint8_t *data, size_t len, TfheFheInt200 **out)
{ return c_deserialize("FheInt200", data, len, (void **)out); }

int tfhe_fheint200_destroy(TfheFheInt200 *ct) { return c_destroy(ct); }

int tfhe_fheint208_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt208 **out)
{ return c_encrypt_u64("FheInt208", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint208_try_encrypt_trivial_u64(uint64_t value, TfheFheInt208 **out)
{ return c_encrypt_u64("FheInt208", value, 1, NULL, (void **)out); }

int tfhe_fheint208_decrypt_i64(TfheFheInt208 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint208_decrypt_u64(TfheFheInt208 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint208_decrypt_hex(TfheFheInt208 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint208_add(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint208_sub(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint208_mul(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint208_div(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint208_rem(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint208_bitand(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint208_bitor(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint208_bitxor(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint208_scalar_add(TfheFheInt208 *a, uint64_t b, TfheFheInt208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint208_scalar_sub(TfheFheInt208 *a, uint64_t b, TfheFheInt208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint208_scalar_mul(TfheFheInt208 *a, uint64_t b, TfheFheInt208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint208_scalar_shl(TfheFheInt208 *a, uint64_t b, TfheFheInt208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint208_scalar_shr(TfheFheInt208 *a, uint64_t b, TfheFheInt208 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint208_ge(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint208_gt(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint208_le(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint208_lt(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint208_eq(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint208_ne(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint208_min(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint208_max(TfheFheInt208 *a, TfheFheInt208 *b, TfheFheInt208 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint208_rotate_left(TfheFheInt208 *a, uint32_t b, TfheFheInt208 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint208_rotate_right(TfheFheInt208 *a, uint32_t b, TfheFheInt208 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint208_neg(TfheFheInt208 *a, TfheFheInt208 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint208_not(TfheFheInt208 *a, TfheFheInt208 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint208_serialize(TfheFheInt208 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint208_deserialize(const uint8_t *data, size_t len, TfheFheInt208 **out)
{ return c_deserialize("FheInt208", data, len, (void **)out); }

int tfhe_fheint208_destroy(TfheFheInt208 *ct) { return c_destroy(ct); }

int tfhe_fheint216_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt216 **out)
{ return c_encrypt_u64("FheInt216", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint216_try_encrypt_trivial_u64(uint64_t value, TfheFheInt216 **out)
{ return c_encrypt_u64("FheInt216", value, 1, NULL, (void **)out); }

int tfhe_fheint216_decrypt_i64(TfheFheInt216 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint216_decrypt_u64(TfheFheInt216 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint216_decrypt_hex(TfheFheInt216 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint216_add(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint216_sub(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint216_mul(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint216_div(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint216_rem(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint216_bitand(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint216_bitor(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint216_bitxor(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint216_scalar_add(TfheFheInt216 *a, uint64_t b, TfheFheInt216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint216_scalar_sub(TfheFheInt216 *a, uint64_t b, TfheFheInt216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint216_scalar_mul(TfheFheInt216 *a, uint64_t b, TfheFheInt216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint216_scalar_shl(TfheFheInt216 *a, uint64_t b, TfheFheInt216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint216_scalar_shr(TfheFheInt216 *a, uint64_t b, TfheFheInt216 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint216_ge(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint216_gt(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint216_le(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint216_lt(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint216_eq(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint216_ne(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint216_min(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint216_max(TfheFheInt216 *a, TfheFheInt216 *b, TfheFheInt216 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint216_rotate_left(TfheFheInt216 *a, uint32_t b, TfheFheInt216 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint216_rotate_right(TfheFheInt216 *a, uint32_t b, TfheFheInt216 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint216_neg(TfheFheInt216 *a, TfheFheInt216 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint216_not(TfheFheInt216 *a, TfheFheInt216 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint216_serialize(TfheFheInt216 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint216_deserialize(const uint8_t *data, size_t len, TfheFheInt216 **out)
{ return c_deserialize("FheInt216", data, len, (void **)out); }

int tfhe_fheint216_destroy(TfheFheInt216 *ct) { return c_destroy(ct); }

int tfhe_fheint224_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt224 **out)
{ return c_encrypt_u64("FheInt224", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint224_try_encrypt_trivial_u64(uint64_t value, TfheFheInt224 **out)
{ return c_encrypt_u64("FheInt224", value, 1, NULL, (void **)out); }

int tfhe_fheint224_decrypt_i64(TfheFheInt224 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint224_decrypt_u64(TfheFheInt224 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint224_decrypt_hex(TfheFheInt224 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint224_add(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint224_sub(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint224_mul(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint224_div(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint224_rem(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint224_bitand(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint224_bitor(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint224_bitxor(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint224_scalar_add(TfheFheInt224 *a, uint64_t b, TfheFheInt224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint224_scalar_sub(TfheFheInt224 *a, uint64_t b, TfheFheInt224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint224_scalar_mul(TfheFheInt224 *a, uint64_t b, TfheFheInt224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint224_scalar_shl(TfheFheInt224 *a, uint64_t b, TfheFheInt224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint224_scalar_shr(TfheFheInt224 *a, uint64_t b, TfheFheInt224 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint224_ge(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint224_gt(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint224_le(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint224_lt(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint224_eq(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint224_ne(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint224_min(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint224_max(TfheFheInt224 *a, TfheFheInt224 *b, TfheFheInt224 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint224_rotate_left(TfheFheInt224 *a, uint32_t b, TfheFheInt224 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint224_rotate_right(TfheFheInt224 *a, uint32_t b, TfheFheInt224 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint224_neg(TfheFheInt224 *a, TfheFheInt224 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint224_not(TfheFheInt224 *a, TfheFheInt224 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint224_serialize(TfheFheInt224 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint224_deserialize(const uint8_t *data, size_t len, TfheFheInt224 **out)
{ return c_deserialize("FheInt224", data, len, (void **)out); }

int tfhe_fheint224_destroy(TfheFheInt224 *ct) { return c_destroy(ct); }

int tfhe_fheint232_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt232 **out)
{ return c_encrypt_u64("FheInt232", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint232_try_encrypt_trivial_u64(uint64_t value, TfheFheInt232 **out)
{ return c_encrypt_u64("FheInt232", value, 1, NULL, (void **)out); }

int tfhe_fheint232_decrypt_i64(TfheFheInt232 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint232_decrypt_u64(TfheFheInt232 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint232_decrypt_hex(TfheFheInt232 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint232_add(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint232_sub(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint232_mul(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint232_div(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint232_rem(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint232_bitand(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint232_bitor(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint232_bitxor(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint232_scalar_add(TfheFheInt232 *a, uint64_t b, TfheFheInt232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint232_scalar_sub(TfheFheInt232 *a, uint64_t b, TfheFheInt232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint232_scalar_mul(TfheFheInt232 *a, uint64_t b, TfheFheInt232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint232_scalar_shl(TfheFheInt232 *a, uint64_t b, TfheFheInt232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint232_scalar_shr(TfheFheInt232 *a, uint64_t b, TfheFheInt232 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint232_ge(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint232_gt(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint232_le(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint232_lt(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint232_eq(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint232_ne(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint232_min(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint232_max(TfheFheInt232 *a, TfheFheInt232 *b, TfheFheInt232 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint232_rotate_left(TfheFheInt232 *a, uint32_t b, TfheFheInt232 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint232_rotate_right(TfheFheInt232 *a, uint32_t b, TfheFheInt232 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint232_neg(TfheFheInt232 *a, TfheFheInt232 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint232_not(TfheFheInt232 *a, TfheFheInt232 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint232_serialize(TfheFheInt232 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint232_deserialize(const uint8_t *data, size_t len, TfheFheInt232 **out)
{ return c_deserialize("FheInt232", data, len, (void **)out); }

int tfhe_fheint232_destroy(TfheFheInt232 *ct) { return c_destroy(ct); }

int tfhe_fheint240_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt240 **out)
{ return c_encrypt_u64("FheInt240", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint240_try_encrypt_trivial_u64(uint64_t value, TfheFheInt240 **out)
{ return c_encrypt_u64("FheInt240", value, 1, NULL, (void **)out); }

int tfhe_fheint240_decrypt_i64(TfheFheInt240 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint240_decrypt_u64(TfheFheInt240 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint240_decrypt_hex(TfheFheInt240 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint240_add(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint240_sub(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint240_mul(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint240_div(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint240_rem(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint240_bitand(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint240_bitor(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint240_bitxor(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint240_scalar_add(TfheFheInt240 *a, uint64_t b, TfheFheInt240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint240_scalar_sub(TfheFheInt240 *a, uint64_t b, TfheFheInt240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint240_scalar_mul(TfheFheInt240 *a, uint64_t b, TfheFheInt240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint240_scalar_shl(TfheFheInt240 *a, uint64_t b, TfheFheInt240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint240_scalar_shr(TfheFheInt240 *a, uint64_t b, TfheFheInt240 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint240_ge(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint240_gt(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint240_le(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint240_lt(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint240_eq(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint240_ne(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint240_min(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint240_max(TfheFheInt240 *a, TfheFheInt240 *b, TfheFheInt240 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint240_rotate_left(TfheFheInt240 *a, uint32_t b, TfheFheInt240 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint240_rotate_right(TfheFheInt240 *a, uint32_t b, TfheFheInt240 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint240_neg(TfheFheInt240 *a, TfheFheInt240 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint240_not(TfheFheInt240 *a, TfheFheInt240 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint240_serialize(TfheFheInt240 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint240_deserialize(const uint8_t *data, size_t len, TfheFheInt240 **out)
{ return c_deserialize("FheInt240", data, len, (void **)out); }

int tfhe_fheint240_destroy(TfheFheInt240 *ct) { return c_destroy(ct); }

int tfhe_fheint248_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt248 **out)
{ return c_encrypt_u64("FheInt248", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint248_try_encrypt_trivial_u64(uint64_t value, TfheFheInt248 **out)
{ return c_encrypt_u64("FheInt248", value, 1, NULL, (void **)out); }

int tfhe_fheint248_decrypt_i64(TfheFheInt248 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint248_decrypt_u64(TfheFheInt248 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint248_decrypt_hex(TfheFheInt248 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint248_add(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint248_sub(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint248_mul(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint248_div(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint248_rem(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint248_bitand(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint248_bitor(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint248_bitxor(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint248_scalar_add(TfheFheInt248 *a, uint64_t b, TfheFheInt248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint248_scalar_sub(TfheFheInt248 *a, uint64_t b, TfheFheInt248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint248_scalar_mul(TfheFheInt248 *a, uint64_t b, TfheFheInt248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint248_scalar_shl(TfheFheInt248 *a, uint64_t b, TfheFheInt248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint248_scalar_shr(TfheFheInt248 *a, uint64_t b, TfheFheInt248 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint248_ge(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint248_gt(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint248_le(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint248_lt(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint248_eq(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint248_ne(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint248_min(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint248_max(TfheFheInt248 *a, TfheFheInt248 *b, TfheFheInt248 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint248_rotate_left(TfheFheInt248 *a, uint32_t b, TfheFheInt248 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint248_rotate_right(TfheFheInt248 *a, uint32_t b, TfheFheInt248 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint248_neg(TfheFheInt248 *a, TfheFheInt248 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint248_not(TfheFheInt248 *a, TfheFheInt248 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint248_serialize(TfheFheInt248 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint248_deserialize(const uint8_t *data, size_t len, TfheFheInt248 **out)
{ return c_deserialize("FheInt248", data, len, (void **)out); }

int tfhe_fheint248_destroy(TfheFheInt248 *ct) { return c_destroy(ct); }

int tfhe_fheint256_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt256 **out)
{ return c_encrypt_u64("FheInt256", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint256_try_encrypt_trivial_u64(uint64_t value, TfheFheInt256 **out)
{ return c_encrypt_u64("FheInt256", value, 1, NULL, (void **)out); }

int tfhe_fheint256_decrypt_i64(TfheFheInt256 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint256_decrypt_u64(TfheFheInt256 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint256_decrypt_hex(TfheFheInt256 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint256_add(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint256_sub(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint256_mul(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint256_div(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint256_rem(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint256_bitand(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint256_bitor(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint256_bitxor(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint256_scalar_add(TfheFheInt256 *a, uint64_t b, TfheFheInt256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint256_scalar_sub(TfheFheInt256 *a, uint64_t b, TfheFheInt256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint256_scalar_mul(TfheFheInt256 *a, uint64_t b, TfheFheInt256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint256_scalar_shl(TfheFheInt256 *a, uint64_t b, TfheFheInt256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint256_scalar_shr(TfheFheInt256 *a, uint64_t b, TfheFheInt256 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint256_ge(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint256_gt(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint256_le(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint256_lt(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint256_eq(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint256_ne(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint256_min(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint256_max(TfheFheInt256 *a, TfheFheInt256 *b, TfheFheInt256 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint256_rotate_left(TfheFheInt256 *a, uint32_t b, TfheFheInt256 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint256_rotate_right(TfheFheInt256 *a, uint32_t b, TfheFheInt256 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint256_neg(TfheFheInt256 *a, TfheFheInt256 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint256_not(TfheFheInt256 *a, TfheFheInt256 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint256_serialize(TfheFheInt256 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint256_deserialize(const uint8_t *data, size_t len, TfheFheInt256 **out)
{ return c_deserialize("FheInt256", data, len, (void **)out); }

int tfhe_fheint256_destroy(TfheFheInt256 *ct) { return c_destroy(ct); }

int tfhe_fheint512_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt512 **out)
{ return c_encrypt_u64("FheInt512", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint512_try_encrypt_trivial_u64(uint64_t value, TfheFheInt512 **out)
{ return c_encrypt_u64("FheInt512", value, 1, NULL, (void **)out); }

int tfhe_fheint512_decrypt_i64(TfheFheInt512 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint512_decrypt_u64(TfheFheInt512 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint512_decrypt_hex(TfheFheInt512 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint512_add(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint512_sub(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint512_mul(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint512_div(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint512_rem(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint512_bitand(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint512_bitor(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint512_bitxor(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint512_scalar_add(TfheFheInt512 *a, uint64_t b, TfheFheInt512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint512_scalar_sub(TfheFheInt512 *a, uint64_t b, TfheFheInt512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint512_scalar_mul(TfheFheInt512 *a, uint64_t b, TfheFheInt512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint512_scalar_shl(TfheFheInt512 *a, uint64_t b, TfheFheInt512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint512_scalar_shr(TfheFheInt512 *a, uint64_t b, TfheFheInt512 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint512_ge(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint512_gt(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint512_le(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint512_lt(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint512_eq(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint512_ne(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint512_min(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint512_max(TfheFheInt512 *a, TfheFheInt512 *b, TfheFheInt512 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint512_rotate_left(TfheFheInt512 *a, uint32_t b, TfheFheInt512 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint512_rotate_right(TfheFheInt512 *a, uint32_t b, TfheFheInt512 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint512_neg(TfheFheInt512 *a, TfheFheInt512 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint512_not(TfheFheInt512 *a, TfheFheInt512 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint512_serialize(TfheFheInt512 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint512_deserialize(const uint8_t *data, size_t len, TfheFheInt512 **out)
{ return c_deserialize("FheInt512", data, len, (void **)out); }

int tfhe_fheint512_destroy(TfheFheInt512 *ct) { return c_destroy(ct); }

int tfhe_fheint1024_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt1024 **out)
{ return c_encrypt_u64("FheInt1024", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint1024_try_encrypt_trivial_u64(uint64_t value, TfheFheInt1024 **out)
{ return c_encrypt_u64("FheInt1024", value, 1, NULL, (void **)out); }

int tfhe_fheint1024_decrypt_i64(TfheFheInt1024 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint1024_decrypt_u64(TfheFheInt1024 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint1024_decrypt_hex(TfheFheInt1024 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint1024_add(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint1024_sub(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint1024_mul(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint1024_div(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint1024_rem(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint1024_bitand(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint1024_bitor(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint1024_bitxor(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint1024_scalar_add(TfheFheInt1024 *a, uint64_t b, TfheFheInt1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint1024_scalar_sub(TfheFheInt1024 *a, uint64_t b, TfheFheInt1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint1024_scalar_mul(TfheFheInt1024 *a, uint64_t b, TfheFheInt1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint1024_scalar_shl(TfheFheInt1024 *a, uint64_t b, TfheFheInt1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint1024_scalar_shr(TfheFheInt1024 *a, uint64_t b, TfheFheInt1024 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint1024_ge(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint1024_gt(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint1024_le(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint1024_lt(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint1024_eq(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint1024_ne(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint1024_min(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint1024_max(TfheFheInt1024 *a, TfheFheInt1024 *b, TfheFheInt1024 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint1024_rotate_left(TfheFheInt1024 *a, uint32_t b, TfheFheInt1024 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint1024_rotate_right(TfheFheInt1024 *a, uint32_t b, TfheFheInt1024 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint1024_neg(TfheFheInt1024 *a, TfheFheInt1024 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint1024_not(TfheFheInt1024 *a, TfheFheInt1024 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint1024_serialize(TfheFheInt1024 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint1024_deserialize(const uint8_t *data, size_t len, TfheFheInt1024 **out)
{ return c_deserialize("FheInt1024", data, len, (void **)out); }

int tfhe_fheint1024_destroy(TfheFheInt1024 *ct) { return c_destroy(ct); }

int tfhe_fheint2048_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, TfheFheInt2048 **out)
{ return c_encrypt_u64("FheInt2048", value, 0, (PyObject *)key, (void **)out); }

int tfhe_fheint2048_try_encrypt_trivial_u64(uint64_t value, TfheFheInt2048 **out)
{ return c_encrypt_u64("FheInt2048", value, 1, NULL, (void **)out); }

int tfhe_fheint2048_decrypt_i64(TfheFheInt2048 *ct, TfheClientKey *key, int64_t *out)
{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint2048_decrypt_u64(TfheFheInt2048 *ct, TfheClientKey *key, uint64_t *out)
{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint2048_decrypt_hex(TfheFheInt2048 *ct, TfheClientKey *key, char **out)
{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }

int tfhe_fheint2048_add(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Add, (void **)out); }

int tfhe_fheint2048_sub(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint2048_mul(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint2048_div(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_FloorDivide, (void **)out); }

int tfhe_fheint2048_rem(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Remainder, (void **)out); }

int tfhe_fheint2048_bitand(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_And, (void **)out); }

int tfhe_fheint2048_bitor(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Or, (void **)out); }

int tfhe_fheint2048_bitxor(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_binop((PyObject *)a, (PyObject *)b, PyNumber_Xor, (void **)out); }

int tfhe_fheint2048_scalar_add(TfheFheInt2048 *a, uint64_t b, TfheFheInt2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Add, (void **)out); }

int tfhe_fheint2048_scalar_sub(TfheFheInt2048 *a, uint64_t b, TfheFheInt2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Subtract, (void **)out); }

int tfhe_fheint2048_scalar_mul(TfheFheInt2048 *a, uint64_t b, TfheFheInt2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Multiply, (void **)out); }

int tfhe_fheint2048_scalar_shl(TfheFheInt2048 *a, uint64_t b, TfheFheInt2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Lshift, (void **)out); }

int tfhe_fheint2048_scalar_shr(TfheFheInt2048 *a, uint64_t b, TfheFheInt2048 **out)
{ return c_scalar_binop((PyObject *)a, b, PyNumber_Rshift, (void **)out); }

int tfhe_fheint2048_ge(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GE, (void **)out); }

int tfhe_fheint2048_gt(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_GT, (void **)out); }

int tfhe_fheint2048_le(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LE, (void **)out); }

int tfhe_fheint2048_lt(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheBool **out)
{ return c_richcmp((PyObject *)a, (PyObject *)b, Py_LT, (void **)out); }

int tfhe_fheint2048_eq(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "eq", (PyObject *)b, (void **)out); }

int tfhe_fheint2048_ne(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheBool **out)
{ return c_method1((PyObject *)a, "ne", (PyObject *)b, (void **)out); }

int tfhe_fheint2048_min(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_method1((PyObject *)a, "min", (PyObject *)b, (void **)out); }

int tfhe_fheint2048_max(TfheFheInt2048 *a, TfheFheInt2048 *b, TfheFheInt2048 **out)
{ return c_method1((PyObject *)a, "max", (PyObject *)b, (void **)out); }

int tfhe_fheint2048_rotate_left(TfheFheInt2048 *a, uint32_t b, TfheFheInt2048 **out)
{ return c_method_u32((PyObject *)a, "rotate_left", b, (void **)out); }

int tfhe_fheint2048_rotate_right(TfheFheInt2048 *a, uint32_t b, TfheFheInt2048 **out)
{ return c_method_u32((PyObject *)a, "rotate_right", b, (void **)out); }

int tfhe_fheint2048_neg(TfheFheInt2048 *a, TfheFheInt2048 **out)
{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }

int tfhe_fheint2048_not(TfheFheInt2048 *a, TfheFheInt2048 **out)
{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }

int tfhe_fheint2048_serialize(TfheFheInt2048 *ct, DynamicBuffer *out)
{ return c_serialize((PyObject *)ct, out); }

int tfhe_fheint2048_deserialize(const uint8_t *data, size_t len, TfheFheInt2048 **out)
{ return c_deserialize("FheInt2048", data, len, (void **)out); }

int tfhe_fheint2048_destroy(TfheFheInt2048 *ct) { return c_destroy(ct); }
