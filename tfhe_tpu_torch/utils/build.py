"""Build native sources into shared libraries at first use.

Libraries land in ``<checkout>/build/tfhe_tpu_torch/`` (listed in
.gitignore), one file per (sources, headers, command) content hash, so a checkout
builds what it needs the first time it is used and a changed source never
loads a stale library.  Concurrent builders (pytest-xdist workers) each
compile to a private temporary name and rename into place atomically.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "tfhe_tpu_torch"


def _target(name: str, sources: list, command: list) -> pathlib.Path:
    """The library path for these sources, the headers beside them
    (``*.cuh``) and this command."""
    digest = hashlib.sha256(" ".join(command).encode())
    dirs = sorted({pathlib.Path(src).parent for src in sources})
    headers = [h for d in dirs for h in sorted(d.glob("*.cuh"))]
    for src in list(sources) + headers:
        digest.update(pathlib.Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_shared_libraries(specs: list) -> list:
    """Compile every (name, sources, command) spec, all compilers started
    together, and return the library paths in order.  ``command`` is the
    compiler invocation without the output flag and the sources, e.g.
    ``["g++", "-O3", "-shared", "-fPIC"]``.  Raises with the compiler's
    output if any build fails."""
    outs, procs = [], []
    for name, sources, command in specs:
        out = _target(name, sources, command)
        outs.append(out)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            command + ["-o", str(tmp)] + [str(s) for s in sources],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, command, proc, tmp, out))
    errors = []
    for name, command, proc, tmp, out in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"building {name} failed ({' '.join(command)}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs
