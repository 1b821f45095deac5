"""Build the native runtime library (g++; no pybind11 required).

Usage: python -m altro_jax._native.build
The library lands next to this file as `libaltro_native.so` and is loaded
lazily by `altro_jax.native`.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "src" / "altro_native.cpp"
OUT = HERE / "libaltro_native.so"


def build(verbose: bool = True) -> pathlib.Path:
    cmd = [
        "g++",
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-pthread",
        str(SRC),
        "-o",
        str(OUT),
    ]
    if verbose:
        print(" ".join(cmd))
    subprocess.run(cmd, check=True)
    return OUT


if __name__ == "__main__":
    build()
    print(f"built {OUT}")
