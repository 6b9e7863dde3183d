"""The port's CUDA kernel sources compiled for the host, for CPU tests.

``build(name, out_dir)`` turns ``flyimg_tpu_torch/csrc/<name>.cu`` into a
shared library with g++ against ``tests/cuda_host/cuda_runtime.h`` (every
CUDA thread a host thread; shuffles, votes and barriers real meeting
points): a ``kernel<<<grid, block, smem, stream>>>(...)`` launch becomes
``cuda_host::launch(kernel, grid, block, ...)`` and the dynamic shared
array a static one. The library's C entry takes host pointers in place of
device ones. Tests using it skip, saying why, where g++ cannot build it.
"""

import ctypes
import os
import re
import shutil
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_ROOT, "flyimg_tpu_torch", "csrc")
HEADERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_host")


def host_source(text: str) -> str:
    """A .cu source's text as host C++."""
    text = re.sub(r"(\w+)<<<\s*([^,]+?)\s*,\s*([^,]+?)\s*,.*?>>>\s*\(",
                  r"cuda_host::launch(\1, \2, \3, ", text, flags=re.S)
    return re.sub(r"extern __shared__ (__align__\(\d+\) )?(\w+) (\w+)\[\];",
                  r"static \1\2 \3[65536];", text)


def missing() -> str:
    """Why the host build cannot run here ("" where it can)."""
    if not shutil.which("g++"):
        return "no g++"
    return ""


def build(name: str, out_dir: str, defines=()) -> ctypes.CDLL:
    """``csrc/<name>.cu`` (with ``-D`` ``defines``) as a loaded host library."""
    tag = "".join(f"_{d}" for d in defines).replace("=", "")
    cpp = os.path.join(out_dir, f"{name}{tag}.cpp")
    lib = os.path.join(out_dir, f"{name}{tag}.so")
    with open(os.path.join(CSRC, f"{name}.cu")) as fh:
        text = host_source(fh.read())
    with open(cpp, "w") as fh:
        fh.write(text)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-pthread", f"-I{HEADERS}", *[f"-D{d}" for d in defines], cpp, "-o", lib],
                   check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(lib)
