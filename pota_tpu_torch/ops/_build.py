"""Build and bind the port's CUDA kernels.

At first use the sources in ``pota_tpu_torch/csrc`` are compiled by nvcc,
one process per source side by side, and linked into one shared library
with a plain C interface, under
``pota_tpu_torch/build/<hash of sources and flags>/``, and loaded with
ctypes.  Nothing is built at import: the CPU tests import every module, and
a machine without a GPU may have no nvcc.

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per launch,
counted where the kernel is launched and nowhere else), so a run can show
that the main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(PKG_DIR, "build")
LIB_NAME = "libpota_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNEL_NAMES = ("po_forward", "expand", "po_splat", "segment_accum",
                "tl_splat", "po_splat_lam", "po_splat_ext", "po_backward",
                "po_forward_vjp", "po_forward_jvp")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_ll = ctypes.c_longlong
# the one C signature of K3's and K3b's three entry points (csrc/po_splat.cu)
_PO_SPLAT = [_p] * 10 + [_i, _p, _i, _p, _i, _i, _p, _p, _i, _p, _p, _p]
# C signatures of the entry points (csrc/*.cu); each returns cudaError_t
SIGNATURES = {
    "pota_po_forward": [_p] * 4 + [_i, _p, _f, _f, _i] + [_p] * 5,
    # K1's select mode (po_forward_select_kernel: a ray a thread, its
    # candidates traced until the first that passes the pupil crops, the
    # chart mapped to the ray): the rays' sx, sy, the half sensor width,
    # r1, r2 and keys, n_rays, tries, radius, blades, the blade angle, the
    # table and K1's scalars, the pupil's constants (chart, then R to bfl),
    # origin, direction, weight, tries and the selected candidate's x, y,
    # dx, dy, out4 (null: not written)
    "pota_po_forward_selected": [_p, _p, _f, _p, _p, _p, _i, _i, _f, _i,
                                 _f, _p, _f, _f, _i, _i] + [_f] * 9
                                + [_p] * 10,
    "pota_expand": [_p, _i, _p, _i, _p, _i, _i, _p, _p, _p],
    "pota_po_splat": _PO_SPLAT,
    "pota_segment_accum": [_p, _p, _ll, _p, _i, _p, _i] + [_p] * 8,
    "pota_po_splat_lam": _PO_SPLAT,
    "pota_po_splat_ext": _PO_SPLAT,
    "pota_tl_splat": [_p] * 9 + [_i, _i, _f, _f, _p, _p, _i, _p, _p, _p],
    "pota_tl_splat_blocks_per_sm": [_i],
    "pota_po_backward": [_p] * 6 + [_i, _p, _i, _p, _i, _i] + [_p] * 6,
    "pota_po_forward_vjp": [_p] * 8 + [_i, _p, _f, _p, _p, _i, _p, _p, _p,
                                       _i, _p, _i] + [_p] * 6,
    "pota_po_forward_vjp_blocks": [_i],
    # K1v's select mode: the selected candidates' x, y, dx, dy, out4 and
    # the rays' cotangents, n, the table, the shift, the pupil's constants
    # (chart, R to scale), then as pota_po_forward_vjp from the queue on
    "pota_po_forward_vjp_selected": [_p] * 7 + [_i, _p, _f, _i] + [_f] * 6
                                    + [_p, _p, _i, _p, _p, _p, _i, _p, _i,
                                       _p, _p],
    "pota_po_forward_vjp_selected_blocks": [_i],
    "pota_po_forward_vjp_selected_blocks_per_sm": [],
    "pota_po_forward_vjp_blocks_per_sm": [],
    "pota_po_forward_jvp": [_p] * 4 + [_i, _p, _f, _f, _i] + [_p] * 6,
    "pota_po_forward_jvp_blocks_per_sm": [],
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _run(cmds: list) -> list:
    """Run the commands side by side; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=CSRC_DIR)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")
    return [out + err for out, err in outs]


def build() -> str:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  Each source compiles in its own nvcc process, all
    at once, then one link makes the library.  The compiler's
    ``-Xptxas -v`` report (registers, spills) is kept in ``ptxas.log``
    beside it."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, LIB_NAME)
    log_path = os.path.join(out_dir, "ptxas.log")
    if os.path.exists(lib_path):
        build_info.update(path=lib_path, seconds=0.0, cached=True,
                          log_path=log_path)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(c)[:-3] + f".{tag}.o")
            for c in cus]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    logs = _run([[nvcc, *NVCC_FLAGS, "-c", c, "-o", o]
                 for c, o in zip(cus, objs)])
    tmp = f"{lib_path}.{tag}"
    _run([[nvcc, "-shared", "-o", tmp, *objs]])
    seconds = time.perf_counter() - t0
    for o in objs:
        os.remove(o)
    with open(log_path, "w") as f:
        f.write("".join(logs))
    os.replace(tmp, lib_path)
    build_info.update(path=lib_path, seconds=seconds, cached=False,
                      log_path=log_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def sass_text() -> str:
    """``cuobjdump -sass`` of the built library (the toolkit's cuobjdump,
    beside nvcc)."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", build()], capture_output=True,
                          text=True, check=True).stdout


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def ptxas_entries() -> dict:
    """Per kernel entry (mangled name) of the last build: registers, stack
    frame and spill bytes, from the compiler's ``-Xptxas -v`` report."""
    path = build_info.get("log_path")
    if not path or not os.path.exists(path):
        return {}
    entries, name = {}, None
    with open(path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '([^']+)'", ln)
            if m:
                name = m.group(1)
                entries[name] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m and name:
                entries[name].update(stack=int(m.group(1)),
                                     spill_stores=int(m.group(2)),
                                     spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m and name:
                entries[name]["registers"] = int(m.group(1))
    return entries
