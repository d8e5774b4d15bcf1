"""The C API over the port (c_api_torch/) against c_api/ over tfhe_tpu, on
the CPU: both libraries built with gcc into a temporary directory (c_api/'s
from its unchanged tfhe_c.c), the port's header against c_api/'s (the same
entry points and prototypes, plus tfhe_generate_keys_on_device), the
committed files against what c_api_torch/generate.py writes, and both
libraries loaded into this process (ctypes.PyDLL: the embedded calls hold
the GIL) and driven through the same entry points on key sets from one
master seed at the TEST set cut to n = 2, N = 64, passed as py_object
handles.  Serialized outputs must be byte-identical (tolerance 0) and
every output must decrypt right."""

import ctypes
import dataclasses
import importlib.util
import pathlib
import re
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import tfhe_tpu as ref_t
import tfhe_tpu_torch as t
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu_torch import shortint

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

REPO = pathlib.Path(__file__).resolve().parents[1]
MASTER = 0xC0A91
CUT = dict(lwe_dimension=2, polynomial_size=64)


def _module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(f"_capi_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BUILD = _module(REPO / "c_api_torch" / "build.py")
GENERATE = _module(REPO / "c_api_torch" / "generate.py")


def _prototypes(header: str) -> dict:
    """{name: normalised prototype} of every int-returning entry point."""
    out = {}
    for m in re.finditer(r"^int\s+(\w+)\s*\(([^;]*)\);", header, re.M):
        out[m.group(1)] = " ".join(m.group(2).split())
    return out


def test_header_declares_c_apis_entry_points_and_the_device_entry():
    ref = _prototypes((REPO / "c_api" / "tfhe_c.h").read_text())
    port = _prototypes((REPO / "c_api_torch" / "tfhe_c.h").read_text())
    assert len(ref) > 2600
    extra = set(port) - set(ref)
    assert extra == {"tfhe_generate_keys_on_device"}
    assert set(ref) <= set(port)
    assert all(port[name] == proto for name, proto in ref.items())
    assert port["tfhe_generate_keys_on_device"] == (
        "int config_kind, uint64_t seed, const char *device, TfheClientKey **client_key, "
        "TfheServerKey **server_key")


def test_committed_files_are_what_generate_writes():
    header, source = GENERATE.generate()
    assert (REPO / "c_api_torch" / "tfhe_c.h").read_text() == header
    assert (REPO / "c_api_torch" / "tfhe_c.c").read_text() == source


class Handle:
    """An owned PyObject* returned by an entry point, released through the
    library's destroy entry."""

    def __init__(self, lib, ptr: ctypes.c_void_p, destroy: str):
        self.lib, self.ptr, self.destroy = lib, ptr, destroy

    @property
    def obj(self):
        return ctypes.cast(self.ptr, ctypes.py_object).value

    def __del__(self):
        getattr(self.lib, self.destroy)(self.ptr)


class CApi:
    def __init__(self, lib, ck):
        self.lib, self.ck = lib, ctypes.py_object(ck)

    def call(self, name: str, *args, destroy: str | None = None) -> Handle:
        out = ctypes.c_void_p()
        assert getattr(self.lib, name)(*args, ctypes.byref(out)) == 0, name
        return Handle(self.lib, out, destroy or name.split("_")[0] + "_" + name.split("_")[1]
                      + "_destroy")

    def encrypt(self, tag: str, value: int) -> Handle:
        return self.call(f"tfhe_{tag}_try_encrypt_with_client_key_u64", ctypes.c_uint64(value),
                         self.ck)

    def decrypt_u64(self, tag: str, h: Handle) -> int:
        v = ctypes.c_uint64()
        assert getattr(self.lib, f"tfhe_{tag}_decrypt_u64")(h.ptr, self.ck, ctypes.byref(v)) == 0
        return v.value

    def serialize(self, tag: str, h: Handle) -> bytes:
        buf = DynamicBuffer()
        assert getattr(self.lib, f"tfhe_{tag}_serialize")(h.ptr, ctypes.byref(buf)) == 0
        data = ctypes.string_at(buf.pointer, buf.length)
        self.lib.destroy_dynamic_buffer(ctypes.byref(buf))
        return data


class DynamicBuffer(ctypes.Structure):
    _fields_ = [("pointer", ctypes.POINTER(ctypes.c_uint8)), ("length", ctypes.c_size_t)]


@pytest.fixture(scope="module")
def apis(tmp_path_factory):
    """Both libraries, built and loaded, each with its package's key set
    from one master seed set as the server key."""
    out = tmp_path_factory.mktemp("c_api")
    with ThreadPoolExecutor(2) as pool:       # the two gcc runs side by side
        ref_path = pool.submit(BUILD.build_library, str(REPO / "c_api" / "tfhe_c.c"),
                               str(out / "ref"), "tfhe_tpu_c")
        port_path = pool.submit(BUILD.build_library, str(REPO / "c_api_torch" / "tfhe_c.c"),
                                str(out / "port"))
        ref_lib, port_lib = ctypes.PyDLL(ref_path.result()), ctypes.PyDLL(port_path.result())
    ref_cfg = ref_t.ConfigBuilder().use_custom_parameters(
        dataclasses.replace(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, **CUT)).build()
    cfg = t.ConfigBuilder().use_custom_parameters(
        dataclasses.replace(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, **CUT)).build()
    ref_keys = ref_t.CompressedXofKeySet(ref_cfg, MASTER).expand()
    keys = t.CompressedXofKeySet(cfg, MASTER).expand(device="cpu")
    pair = []
    for lib, ks in ((ref_lib, ref_keys), (port_lib, keys)):
        assert lib.tfhe_c_init() == 0
        assert lib.tfhe_set_server_key(ctypes.py_object(ks.server_key)) == 0
        pair.append(CApi(lib, ks.client_key))
    return pair


def both(apis, fn):
    """fn(api) through c_api/ then c_api_torch/ (the same call order, so
    both packages draw the same encryptions)."""
    return [fn(api) for api in apis]


def test_fheuint8_add_mul_gt(apis):
    def run(api):
        a, b = api.encrypt("fheuint8", 200), api.encrypt("fheuint8", 55)
        outs = {"add": api.call("tfhe_fheuint8_add", a.ptr, b.ptr),
                "mul": api.call("tfhe_fheuint8_mul", a.ptr, b.ptr)}
        gt = api.call("tfhe_fheuint8_gt", a.ptr, b.ptr, destroy="tfhe_fhebool_destroy")
        dec = {k: api.decrypt_u64("fheuint8", h) for k, h in outs.items()}
        v = ctypes.c_int()
        assert api.lib.tfhe_fhebool_decrypt(gt.ptr, api.ck, ctypes.byref(v)) == 0
        ser = {k: api.serialize("fheuint8", h) for k, h in outs.items()}
        ser["gt"] = api.serialize("fhebool", gt)
        return dec, v.value, ser

    (rdec, rgt, rser), (dec, gt, ser) = both(apis, run)
    assert dec == rdec == {"add": 255, "mul": (200 * 55) % 256}
    assert gt == rgt == 1
    assert ser == rser


def test_fhebool_and(apis):
    def run(api):
        x = api.call("tfhe_fhebool_try_encrypt_with_client_key", 1, api.ck)
        y = api.call("tfhe_fhebool_try_encrypt_with_client_key", 0, api.ck)
        z = api.call("tfhe_fhebool_bitand", x.ptr, y.ptr)
        w = api.call("tfhe_fhebool_bitand", x.ptr, x.ptr)
        vals = []
        for h in (z, w):
            v = ctypes.c_int()
            assert api.lib.tfhe_fhebool_decrypt(h.ptr, api.ck, ctypes.byref(v)) == 0
            vals.append(v.value)
        return vals, [api.serialize("fhebool", h) for h in (z, w)]

    (rvals, rser), (vals, ser) = both(apis, run)
    assert vals == rvals == [0, 1]
    assert ser == rser


def test_fheuint32_shl_and_rotate(apis):
    def run(api):
        x = api.encrypt("fheuint32", 0x1234)
        y = api.call("tfhe_fheuint32_scalar_shl", x.ptr, ctypes.c_uint64(4))
        z = api.call("tfhe_fheuint32_rotate_left", x.ptr, ctypes.c_uint32(28))
        return ([api.decrypt_u64("fheuint32", h) for h in (y, z)],
                [api.serialize("fheuint32", h) for h in (y, z)])

    (rvals, rser), (vals, ser) = both(apis, run)
    assert vals == rvals == [0x12340, ((0x1234 << 28) | (0x1234 >> 4)) % (1 << 32)]
    assert ser == rser


def test_fheint8_neg(apis):
    def run(api):
        a = api.encrypt("fheint8", 5)
        n = api.call("tfhe_fheint8_neg", a.ptr)
        v = ctypes.c_int64()
        assert api.lib.tfhe_fheint8_decrypt_i64(n.ptr, api.ck, ctypes.byref(v)) == 0
        return v.value, api.serialize("fheint8", n)

    (rv, rser), (v, ser) = both(apis, run)
    assert v == rv == -5
    assert ser == rser


def test_serialize_round_trip(apis):
    def run(api):
        a = api.encrypt("fheuint8", 173)
        data = api.serialize("fheuint8", a)
        out = ctypes.c_void_p()
        assert api.lib.tfhe_fheuint8_deserialize(data, ctypes.c_size_t(len(data)),
                                                 ctypes.byref(out)) == 0
        back = Handle(api.lib, out, "tfhe_fheuint8_destroy")
        assert api.serialize("fheuint8", back) == data
        return api.decrypt_u64("fheuint8", back), data

    (rv, rdata), (v, data) = both(apis, run)
    assert v == rv == 173
    assert data == rdata


def test_generate_keys_runs_on_the_card(apis, monkeypatch):
    """tfhe_generate_keys asks for "cuda" and fails without a card; the
    device entry takes "cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lib = apis[1].lib
    ck, sk = ctypes.c_void_p(), ctypes.c_void_p()
    assert lib.tfhe_generate_keys(0, ctypes.c_uint64(77), ctypes.byref(ck), ctypes.byref(sk)) != 0
    assert lib.tfhe_generate_keys_on_device(0, ctypes.c_uint64(77), b"cpu", ctypes.byref(ck),
                                            ctypes.byref(sk)) == 0
    client = Handle(lib, ck, "tfhe_client_key_destroy")
    server = Handle(lib, sk, "tfhe_server_key_destroy")
    assert type(client.obj) is t.ClientKey and server.obj.device.type == "cpu"
