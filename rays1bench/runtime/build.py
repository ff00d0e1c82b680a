"""Build the native runtime library from imageio.cpp.

Usage: python -m rays1bench.runtime.build [--force]
Also invoked lazily by runtime.native on first use. The library is built
for the machine it runs on (-march=native) into native/build/, which git
ignores: no compiled binary is tracked.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "native", "imageio.cpp")
OUT_DIR = os.path.join(HERE, "native", "build")
OUT = os.path.join(OUT_DIR, "libraysrt.so")


def build(force: bool = False) -> str:
    """Compile the native library if missing/stale; returns the .so path."""
    if (not force and os.path.exists(OUT)
            and os.path.getmtime(OUT) >= os.path.getmtime(SRC)):
        return OUT
    os.makedirs(OUT_DIR, exist_ok=True)
    # Build to a private name, then rename: concurrent processes (parallel
    # test workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=OUT_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-std=c++17", SRC, "-o", tmp], check=True)
        os.replace(tmp, OUT)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return OUT


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(f"built {path}")
