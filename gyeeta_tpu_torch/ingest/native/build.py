"""Build the port's host C++ libraries with ``g++``.

``python -m gyeeta_tpu_torch.ingest.native.build`` builds the deframer
(``deframe.cpp``); ``ingest.native`` builds it at first use. Each source
compiles into ``build/native/`` under a name keyed by the hash of the
source and flags, through a unique temporary file and an atomic rename:
concurrent first-use builds (test workers, server processes) never load
a half-written library. A failed build raises.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "deframe.cpp"
BUILD_DIR = HERE.parents[2] / "build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror")


def lib_path(src: pathlib.Path = SRC, flags: tuple = FLAGS
             ) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(src: pathlib.Path = SRC, flags: tuple = FLAGS,
          verbose: bool = False) -> pathlib.Path:
    """Compile ``src`` unless its library exists → the library path."""
    out = lib_path(src, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [CXX, *flags, str(src), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd))
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native build failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
