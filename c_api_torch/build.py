#!/usr/bin/env python
"""Build the C API over tfhe_tpu_torch with gcc, and run its test program.

    python c_api_torch/build.py [config_kind [device]]

compiles c_api_torch/tfhe_c.c into build/c_api_torch/libtfhe_tpu_torch_c.so
and test_c_api.c into build/c_api_torch/test_c_api (linked against the
library and libpython), then runs the program with the config kind (0, the
test set, by default; 1 for DEFAULT_PARAMS) and device ("cuda" by default,
or "cpu").  Nothing built is committed; build/ is ignored.
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
LIB_NAME = "tfhe_tpu_torch_c"


def python_flags() -> tuple:
    """(compile flags, link flags) for embedding this interpreter."""
    include = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    version = sysconfig.get_config_var("LDVERSION")
    return [f"-I{include}"], [f"-L{libdir}", f"-lpython{version}", f"-Wl,-rpath,{libdir}"]


def build_library(source: str, out_dir: str, name: str = LIB_NAME) -> str:
    """gcc -shared of one generated tfhe_c.c (its header beside it) into
    out_dir/lib<name>.so; returns the library's path."""
    os.makedirs(out_dir, exist_ok=True)
    cflags, ldflags = python_flags()
    lib = os.path.join(out_dir, f"lib{name}.so")
    subprocess.run(["gcc", "-shared", "-fPIC", *cflags, source, "-o", lib, *ldflags],
                   check=True)
    return lib


def build_program(out_dir: str) -> str:
    """The test program linked against out_dir's library; returns its path."""
    cflags, ldflags = python_flags()
    exe = os.path.join(out_dir, "test_c_api")
    subprocess.run(["gcc", *cflags, f"-I{HERE}", os.path.join(HERE, "test_c_api.c"), "-o", exe,
                    f"-L{out_dir}", f"-l{LIB_NAME}", *ldflags,
                    f"-Wl,-rpath,{os.path.abspath(out_dir)}"], check=True)
    return exe


def build(out_dir: str = os.path.join(REPO, "build", "c_api_torch")) -> tuple:
    """The library and the test program; returns their paths."""
    lib = build_library(os.path.join(HERE, "tfhe_c.c"), out_dir)
    return lib, build_program(out_dir)


def run(exe: str, config_kind: int = 0, device: str = "cuda") -> subprocess.CompletedProcess:
    """Run the test program from the checkout's root (the embedded
    interpreter imports tfhe_tpu_torch from there)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run([exe, str(config_kind), device], cwd=REPO, env=env, check=True,
                          capture_output=True, text=True)


if __name__ == "__main__":
    _, program = build()
    result = run(program, int(sys.argv[1]) if len(sys.argv) > 1 else 0,
                 sys.argv[2] if len(sys.argv) > 2 else "cuda")
    print(result.stdout, end="")
