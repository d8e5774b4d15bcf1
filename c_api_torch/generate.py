#!/usr/bin/env python
"""Generates c_api_torch/tfhe_c.h and tfhe_c.c: the C API over the PyTorch
port's hlapi (tfhe_tpu_torch), the sibling of c_api/.

The reference's C API (tfhe/src/c_api/, ~9.5k LoC) is macro/cbindgen
generated from the Rust hlapi; this generator plays the same role over the
Python hlapi: every FheUint*/FheInt* width and FheBool gets encrypt/decrypt,
the full operator set, scalar variants, and DynamicBuffer-based safe
serialization.  A small hand-written generic core (embedded CPython calls
into tfhe_tpu_torch) does the actual work; the generated wrappers only fix
the type.  The entry points and prototypes are c_api/'s, plus
tfhe_generate_keys_on_device, which names the device the keys (and every
operation on them) run on: "cuda" (what tfhe_generate_keys asks for, and
fails without a card) or "cpu".

Run from the repo root:  python c_api_torch/generate.py
Build and run its test program:  python c_api_torch/build.py [config_kind] [device]
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

HEADER_PRELUDE = """\
/* C API over tfhe_tpu_torch, the PyTorch port — GENERATED by
 * c_api_torch/generate.py.
 * Analog of tfhe/src/c_api/: opaque handles + per-type functions + 0/nonzero
 * return codes + DynamicBuffer for serialization.  Call tfhe_c_init() first.
 */
#ifndef TFHE_TPU_TORCH_C_H
#define TFHE_TPU_TORCH_C_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct TfheClientKey TfheClientKey;
typedef struct TfheServerKey TfheServerKey;
typedef struct TfheFheBool TfheFheBool;

/* c_api/buffer.rs analog */
typedef struct DynamicBuffer {
    uint8_t *pointer;
    size_t length;
} DynamicBuffer;

int tfhe_c_init(void);
int tfhe_c_deinit(void);
int destroy_dynamic_buffer(DynamicBuffer *buffer);

/* config_kind: 0 = fast insecure test parameters, 1 = production 2_2.
 * tfhe_generate_keys runs on the card ("cuda") and fails without one;
 * tfhe_generate_keys_on_device names the device ("cuda", "cuda:1", "cpu"). */
int tfhe_generate_keys(int config_kind, uint64_t seed,
                       TfheClientKey **client_key, TfheServerKey **server_key);
int tfhe_generate_keys_on_device(int config_kind, uint64_t seed, const char *device,
                                 TfheClientKey **client_key, TfheServerKey **server_key);
int tfhe_set_server_key(TfheServerKey *server_key);
int tfhe_client_key_destroy(TfheClientKey *key);
int tfhe_server_key_destroy(TfheServerKey *key);

int tfhe_fhebool_try_encrypt_with_client_key(int value, TfheClientKey *key,
                                             TfheFheBool **out);
int tfhe_fhebool_decrypt(TfheFheBool *ct, TfheClientKey *key, int *out);
int tfhe_fhebool_bitand(TfheFheBool *a, TfheFheBool *b, TfheFheBool **out);
int tfhe_fhebool_bitor(TfheFheBool *a, TfheFheBool *b, TfheFheBool **out);
int tfhe_fhebool_bitxor(TfheFheBool *a, TfheFheBool *b, TfheFheBool **out);
int tfhe_fhebool_not(TfheFheBool *a, TfheFheBool **out);
int tfhe_fhebool_serialize(TfheFheBool *ct, DynamicBuffer *out);
int tfhe_fhebool_deserialize(const uint8_t *data, size_t len, TfheFheBool **out);
int tfhe_fhebool_destroy(TfheFheBool *ct);
"""

C_PRELUDE = r"""/* GENERATED by c_api_torch/generate.py — do not edit by hand.
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
"""

BINOPS = [
    ("add", "PyNumber_Add"),
    ("sub", "PyNumber_Subtract"),
    ("mul", "PyNumber_Multiply"),
    ("div", "PyNumber_FloorDivide"),
    ("rem", "PyNumber_Remainder"),
    ("bitand", "PyNumber_And"),
    ("bitor", "PyNumber_Or"),
    ("bitxor", "PyNumber_Xor"),
]
SCALAR_BINOPS = [
    ("scalar_add", "PyNumber_Add"),
    ("scalar_sub", "PyNumber_Subtract"),
    ("scalar_mul", "PyNumber_Multiply"),
    ("scalar_shl", "PyNumber_Lshift"),
    ("scalar_shr", "PyNumber_Rshift"),
]
# eq/ne are named methods (the dunders must return real bools for Python
# container semantics); ordering uses rich comparison
CMPS = [("ge", "Py_GE"), ("gt", "Py_GT"), ("le", "Py_LE"), ("lt", "Py_LT")]
CMP_METHODS = ["eq", "ne"]


def gen_type(py_name: str, signed: bool):
    c_tag = py_name.lower()          # fheuint8
    h = [f"\ntypedef struct Tfhe{py_name} Tfhe{py_name};"]
    c = []

    def proto(sig):
        h.append(f"int {sig};")

    # encrypt / decrypt
    proto(f"tfhe_{c_tag}_try_encrypt_with_client_key_u64(uint64_t value, "
          f"TfheClientKey *key, Tfhe{py_name} **out)")
    c.append(f"""int tfhe_{c_tag}_try_encrypt_with_client_key_u64(uint64_t value,
        TfheClientKey *key, Tfhe{py_name} **out)
{{ return c_encrypt_u64("{py_name}", value, 0, (PyObject *)key, (void **)out); }}""")
    proto(f"tfhe_{c_tag}_try_encrypt_trivial_u64(uint64_t value, Tfhe{py_name} **out)")
    c.append(f"""int tfhe_{c_tag}_try_encrypt_trivial_u64(uint64_t value, Tfhe{py_name} **out)
{{ return c_encrypt_u64("{py_name}", value, 1, NULL, (void **)out); }}""")
    if signed:
        proto(f"tfhe_{c_tag}_decrypt_i64(Tfhe{py_name} *ct, TfheClientKey *key, int64_t *out)")
        c.append(f"""int tfhe_{c_tag}_decrypt_i64(Tfhe{py_name} *ct, TfheClientKey *key, int64_t *out)
{{ return c_decrypt_i64((PyObject *)ct, (PyObject *)key, out); }}""")
    proto(f"tfhe_{c_tag}_decrypt_u64(Tfhe{py_name} *ct, TfheClientKey *key, uint64_t *out)")
    c.append(f"""int tfhe_{c_tag}_decrypt_u64(Tfhe{py_name} *ct, TfheClientKey *key, uint64_t *out)
{{ return c_decrypt_u64((PyObject *)ct, (PyObject *)key, out); }}""")
    proto(f"tfhe_{c_tag}_decrypt_hex(Tfhe{py_name} *ct, TfheClientKey *key, char **out)")
    c.append(f"""int tfhe_{c_tag}_decrypt_hex(Tfhe{py_name} *ct, TfheClientKey *key, char **out)
{{ return c_decrypt_hex((PyObject *)ct, (PyObject *)key, out); }}""")

    for name, fn in BINOPS:
        proto(f"tfhe_{c_tag}_{name}(Tfhe{py_name} *a, Tfhe{py_name} *b, Tfhe{py_name} **out)")
        c.append(f"""int tfhe_{c_tag}_{name}(Tfhe{py_name} *a, Tfhe{py_name} *b, Tfhe{py_name} **out)
{{ return c_binop((PyObject *)a, (PyObject *)b, {fn}, (void **)out); }}""")
    for name, fn in SCALAR_BINOPS:
        proto(f"tfhe_{c_tag}_{name}(Tfhe{py_name} *a, uint64_t b, Tfhe{py_name} **out)")
        c.append(f"""int tfhe_{c_tag}_{name}(Tfhe{py_name} *a, uint64_t b, Tfhe{py_name} **out)
{{ return c_scalar_binop((PyObject *)a, b, {fn}, (void **)out); }}""")
    for name, op in CMPS:
        proto(f"tfhe_{c_tag}_{name}(Tfhe{py_name} *a, Tfhe{py_name} *b, TfheFheBool **out)")
        c.append(f"""int tfhe_{c_tag}_{name}(Tfhe{py_name} *a, Tfhe{py_name} *b, TfheFheBool **out)
{{ return c_richcmp((PyObject *)a, (PyObject *)b, {op}, (void **)out); }}""")
    for name in CMP_METHODS:
        proto(f"tfhe_{c_tag}_{name}(Tfhe{py_name} *a, Tfhe{py_name} *b, TfheFheBool **out)")
        c.append(f"""int tfhe_{c_tag}_{name}(Tfhe{py_name} *a, Tfhe{py_name} *b, TfheFheBool **out)
{{ return c_method1((PyObject *)a, "{name}", (PyObject *)b, (void **)out); }}""")
    for name in ("min", "max"):
        proto(f"tfhe_{c_tag}_{name}(Tfhe{py_name} *a, Tfhe{py_name} *b, Tfhe{py_name} **out)")
        c.append(f"""int tfhe_{c_tag}_{name}(Tfhe{py_name} *a, Tfhe{py_name} *b, Tfhe{py_name} **out)
{{ return c_method1((PyObject *)a, "{name}", (PyObject *)b, (void **)out); }}""")
    for name in ("rotate_left", "rotate_right"):
        proto(f"tfhe_{c_tag}_{name}(Tfhe{py_name} *a, uint32_t b, Tfhe{py_name} **out)")
        c.append(f"""int tfhe_{c_tag}_{name}(Tfhe{py_name} *a, uint32_t b, Tfhe{py_name} **out)
{{ return c_method_u32((PyObject *)a, "{name}", b, (void **)out); }}""")
    proto(f"tfhe_{c_tag}_neg(Tfhe{py_name} *a, Tfhe{py_name} **out)")
    c.append(f"""int tfhe_{c_tag}_neg(Tfhe{py_name} *a, Tfhe{py_name} **out)
{{ return c_unop((PyObject *)a, PyNumber_Negative, (void **)out); }}""")
    proto(f"tfhe_{c_tag}_not(Tfhe{py_name} *a, Tfhe{py_name} **out)")
    c.append(f"""int tfhe_{c_tag}_not(Tfhe{py_name} *a, Tfhe{py_name} **out)
{{ return c_unop((PyObject *)a, PyNumber_Invert, (void **)out); }}""")
    proto(f"tfhe_{c_tag}_serialize(Tfhe{py_name} *ct, DynamicBuffer *out)")
    c.append(f"""int tfhe_{c_tag}_serialize(Tfhe{py_name} *ct, DynamicBuffer *out)
{{ return c_serialize((PyObject *)ct, out); }}""")
    proto(f"tfhe_{c_tag}_deserialize(const uint8_t *data, size_t len, Tfhe{py_name} **out)")
    c.append(f"""int tfhe_{c_tag}_deserialize(const uint8_t *data, size_t len, Tfhe{py_name} **out)
{{ return c_deserialize("{py_name}", data, len, (void **)out); }}""")
    proto(f"tfhe_{c_tag}_destroy(Tfhe{py_name} *ct)")
    c.append(f"""int tfhe_{c_tag}_destroy(Tfhe{py_name} *ct) {{ return c_destroy(ct); }}""")
    return "\n".join(h), "\n\n".join(c)


def generate() -> tuple:
    """(tfhe_c.h, tfhe_c.c) as text, over tfhe_tpu_torch's widths."""
    import tfhe_tpu_torch as t

    uints = sorted((n for n in dir(t) if n.startswith("FheUint") and
                    n[7:].isdigit()), key=lambda s: int(s[7:]))
    ints = sorted((n for n in dir(t) if n.startswith("FheInt") and
                   n[6:].isdigit()), key=lambda s: int(s[6:]))
    h_parts, c_parts = [HEADER_PRELUDE], [C_PRELUDE]
    for name in uints:
        hh, cc = gen_type(name, signed=False)
        h_parts.append(hh)
        c_parts.append(cc)
    for name in ints:
        hh, cc = gen_type(name, signed=True)
        h_parts.append(hh)
        c_parts.append(cc)
    h_parts.append("\n#ifdef __cplusplus\n}\n#endif\n#endif /* TFHE_TPU_TORCH_C_H */\n")
    return "\n".join(h_parts), "\n\n".join(c_parts) + "\n"


def main(out_dir: str = HERE):
    header, source = generate()
    with open(os.path.join(out_dir, "tfhe_c.h"), "w") as f:
        f.write(header)
    with open(os.path.join(out_dir, "tfhe_c.c"), "w") as f:
        f.write(source)
    print(f"generated {out_dir}/tfhe_c.h and tfhe_c.c")


if __name__ == "__main__":
    main()
