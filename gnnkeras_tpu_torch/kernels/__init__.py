"""Build and bind the hand-written CUDA kernels of ``gnnkeras_tpu_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``gnnkeras_tpu_torch/_build/`` (named
by the hash of the sources and the shared headers, so an edit rebuilds), and loaded with
``ctypes``.  Nothing is downloaded and nothing outside the package directory
is written.  ``build_all`` starts one ``nvcc`` per translation unit at once
(the strip kernels are nine: the entries, and one per mask kind and
direction).

``LAUNCHES`` holds one plain launch counter per kernel.  The wrappers in
``ops/`` add one to their count right after a launch that returned no error,
and nowhere else; ``reset_launches`` sets every count to 0.

The kernels that ``model.forward(training=False)`` reaches are also
``torch.library`` custom operators (``gnnkeras_tpu_torch::strip_matmul`` in
``ops/strip.py``, ``gnnkeras_tpu_torch::incidence_select`` in
``ops/incidence.py``, ``gnnkeras_tpu_torch::qbcsr_matmul`` in
``ops/bcsr.py``), which a program saved by ``serving.export_forward``
calls; importing those modules registers them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_size_t
# source name -> {C entry point: argtypes}
_ENTRIES = {
    "strip_matmul": {
        "gnn_strip_matmul": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _P],
        "gnn_strip_matmul_t": [_P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _P],
    },
    "fused_unfold": {"gnn_fused_unfold_t": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "fused_unfold_rm": {"gnn_fused_unfold": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P]},
    "incidence": {
        "gnn_incidence_select": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "gnn_incidence_scatter": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    },
    "qbcsr": {
        "gnn_qbcsr_matmul": [_P] * 10 + [_I, _I, _I, _P],
        "gnn_qbcsr_matmul_t": [_P] * 10 + [_I, _I, _I, _P],
    },
    "ring": {
        "gnn_ring_create": [_I, _I, _S, _P, ctypes.POINTER(_P), ctypes.c_char_p],
        "gnn_ring_connect": [_P, ctypes.c_char_p],
        "gnn_ring_destroy": [_P],
        "gnn_ring_all_gather": [_P, _P, _P, _S, ctypes.c_ulonglong, _P],
        "gnn_ring_settle": [_P, ctypes.c_ulonglong],
    },
}
SOURCES = tuple(_ENTRIES)
# A library built from several translation units ((file of csrc/, extra
# nvcc flags), compiled in parallel, then linked); every other library is the
# one file csrc/<name>.cu.  The strip kernels: the entries, then one unit per
# mask kind and direction.
_UNITS = {"strip_matmul": (("strip_matmul", ()),) + tuple(
    ("strip_matmul_unit", (f"-DGNN_STRIP_KIND={kind}", f"-DGNN_STRIP_BWD={bwd}")) for kind in range(4) for bwd in (0, 1))}

LAUNCHES: Dict[str, int] = {
    "strip_matmul": 0, "strip_matmul_t": 0, "strip_matmul_bf16_state": 0, "strip_matmul_t_bf16_state": 0,
    "fused_unfold_t": 0, "fused_unfold": 0, "incidence_select": 0,
    "incidence_scatter": 0, "qbcsr_matmul": 0, "qbcsr_matmul_t": 0, "ring_all_gather": 0,
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")
    return found


def _source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _units(name: str):
    return _UNITS.get(name, ((name, ()),))


def library_path(name: str) -> str:
    """The library of source ``name``, named by the hash of its translation
    units, the shared headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    h.update(repr(_units(name)).encode())
    for path in sorted({_source(u) for u, _ in _units(name)}) + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas=-v``: registers, shared memory and
    spills per kernel) of the last build of ``name``."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no library yet, one ``nvcc`` per
    translation unit, all started together (a library of several units is
    linked once they are done).  Returns {name: library path}; raises with
    the compiler's output when a build fails."""
    names = list(names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not os.path.exists(paths[name])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    tmp = {name: f"{paths[name]}.tmp{os.getpid()}" for name in todo}
    procs = []
    for name in todo:
        units = _units(name)
        for i, (unit, flags) in enumerate(units):
            if len(units) == 1:
                cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", tmp[name], _source(unit)]
            else:
                cmd = [nvcc, *compile_flags, *flags, "-c", "-o", f"{tmp[name]}.{i}.o", _source(unit)]
            procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {name: [] for name in todo}
    bad = set()
    for name, proc in procs:
        out, _ = proc.communicate()
        logs[name].append(out)
        if proc.returncode != 0:
            bad.add(name)
    failed = []
    for name in todo:
        objs = [f"{tmp[name]}.{i}.o" for i in range(len(_units(name)))]
        if len(objs) > 1 and name not in bad:
            link = subprocess.run([nvcc, "-shared", "-o", tmp[name], *objs], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            logs[name].append(link.stdout)
            if link.returncode != 0:
                bad.add(name)
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        out = "".join(logs[name])
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
            f.write(out)
        if name in bad:
            failed.append(f"--- {name} (nvcc failed) ---\n{out}")
        else:
            os.replace(tmp[name], paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The bound library of source ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            for fn_name, argtypes in _ENTRIES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(err: int, kernel: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream

