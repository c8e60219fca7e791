"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for Hopper (`sm_90a`), all
sources at once in parallel processes, and the objects are linked into
one shared library with a plain C interface, which `ctypes` loads. No
source includes PyTorch's headers, so a build takes seconds. The library
is named after a hash of the sources, the headers they share
(`csrc/*.cuh`) and the flags and is written under
`build/neuronika_tpu_torch/` beside the package, so an unchanged checkout
reuses it and a changed source is rebuilt. Nothing is built when a module
is imported: the first kernel launch builds (`load_library`).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PKG / "csrc").glob("*.cuh")))
BUILD_DIR = _PKG.parent / "build" / "neuronika_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME); the CUDA kernels cannot be "
            "built")
    return str(cand)


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libneuronika_tpu_torch_kernels.{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> pathlib.Path:
    """Compile the kernels unless the library for these sources exists
    (always with `force`). Raises with nvcc's output when it fails."""
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = BUILD_DIR / f"{out.name}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tag}.{src.stem}.o" for src in SOURCES]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
            list(pool.map(_run, ([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                  str(src)] for src, obj in zip(SOURCES,
                                                                objs))))
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tag}.tmp", *objs])
        os.replace(f"{tag}.tmp", out)   # atomic: no process sees half of it
    finally:
        for f in (*objs, f"{tag}.tmp"):
            pathlib.Path(f).unlink(missing_ok=True)
    return out


def _run(cmd) -> None:
    """Run one nvcc command; raise with its output if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"nvcc exited {proc.returncode}:\n{' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument types (a pointer passed without them is cut to 32
    bits)."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.nk_paged_attention
    fn.argtypes = [i, i, p, p, p, p, p, p,       # dtype route, q, pk, pv,
                   i, i, i, i, i, i, i, i,       # table, pos, out; B KV G
                   ctypes.c_float, i, i, p, p,   # hd NB BS MB window; scale,
                   p]                            # splits bps, part count,
                                                 # stream
    fn.restype = i
    f = ctypes.c_float
    # every flash kernel's dropout: seed, threshold, inv_keep
    drop = [ctypes.c_uint64, ctypes.c_uint32, f]
    # every flash entry but the stats pre-pass: dtype, then the route
    # (sm90), which the caller picks (ops/flash_attention.py::_sm90_route)
    fn = lib.nk_flash_fwd_qkv
    fn.argtypes = [i, i, p, p, p,                # dtype sm90, qkv, out, lse
                   i, i, i, i, i,                # B S H KV hd
                   f, i, i, *drop, p]            # scale causal fast, drop,
    fn.restype = i                               # stream
    fn = lib.nk_flash_bwd_stats_qkv
    fn.argtypes = [i, p, p, p, p,                # dtype, o lse do stats
                   i, i, i, i, p]                # B S H hd, stream
    fn.restype = i
    for name in ("nk_flash_bwd_dq_qkv", "nk_flash_bwd_dkv_qkv"):
        fn = getattr(lib, name)
        fn.argtypes = [i, i, p, p, p, p, p, i, p,  # dtype sm90, qkv o lse do
                       i, i, i, i, i,            # stats have_stats dqkv; B
                       f, i, *drop,              # S H KV hd; scale causal,
                       *([i] if "dkv" in name else []), p]  # drop, (dk/dv:
        fn.restype = i                           # cluster), stream
    fn = lib.nk_flash_bwd_fused_qkv
    fn.argtypes = [i, i, p, p, p, p, p, p, p, p,  # dtype sm90, qkv o lse do
                   i, i, i, i, i,                # stats dq_acc turn dqkv; B
                   f, i, *drop, i, p]            # S H KV hd; scale causal,
    fn.restype = i                               # drop, cluster, stream
    fn = lib.nk_flash_fwd
    fn.argtypes = [i, i, p, p, p, p, p, p,       # dtype sm90, q k v out lse,
                   i, i, i, i, i,                # strides; B H Sq Skv hd
                   f, i, i, *drop, p]            # scale causal window, drop,
    fn.restype = i                               # stream
    fn = lib.nk_flash_bwd_dq
    fn.argtypes = [i, i, p, p, p, p, p, p, p, p,  # dtype sm90, q k v do lse
                   i, i, i, i, i,                # delta dq strides; B H Sq
                   f, i, i, *drop, p]            # Skv hd; scale causal
    fn.restype = i                               # window, drop, stream
    fn = lib.nk_flash_bwd_dkv
    fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p,  # dtype sm90, q k v do
                   i, i, i, i, i,                # lse delta dk dv strides;
                   f, i, i, *drop, p]            # B H Sq Skv hd; scale
    fn.restype = i                               # causal window, drop, stream
    ll = ctypes.c_longlong
    fn = lib.nk_matmul
    fn.argtypes = [i, p, p, p,                   # dtype, a, b, c
                   i, i, i,                      # M N K
                   ll, ll, ll, ll,               # sam sak sbk sbn
                   p, p, p, i, p]                # a_pack b_pack ws splits,
                                                 # stream
    fn.restype = i
    fn = lib.nk_softmax
    fn.argtypes = [i, p, p, i, i, i, p]          # dtype, x, y, rows, cols,
    fn.restype = i                               # log, stream
    geo = ctypes.POINTER(ctypes.c_int)           # 19 ints, csrc/conv.cu
    for name in ("nk_conv1d", "nk_conv2d", "nk_conv3d", "nk_conv1d_sm90",
                 "nk_conv2d_sm90", "nk_conv3d_sm90",  # and conv_sm90.cu
                 "nk_conv2d_stacked_sm90"):
        fn = getattr(lib, name)
        fn.argtypes = [i, p, p, p, geo, p]       # dtype, x, w, out, geo,
        fn.restype = i                           # stream
    fn = lib.nk_conv_stack_taps
    fn.argtypes = [p, p, i, i, i, i, i, i,       # x, xs; N H W Ci H2 Wo
                   i, i, i, i, i, p]             # rows kw sw dw Cs, stream
    fn.restype = i
    for name in ("nk_conv_dw", "nk_conv_dw_sm90"):
        fn = getattr(lib, name)
        fn.argtypes = [i, p, p, p, p, geo,       # dtype, x, g, ws, out,
                       i, i, p]                  # geo, splits, chunk,
        fn.restype = i                           # stream
    for name in ("nk_ce_fwd", "nk_ce_fwd_sm90"):  # cross_entropy_sm90.cu
        fn = getattr(lib, name)
        fn.argtypes = [i, p, p, p, p, p,         # dtype, x, w, tgt, loss,
                       i, i, i, p]               # lse; N V D, stream
        fn.restype = i
    for name in ("nk_ce_dx", "nk_ce_dw", "nk_ce_dx_sm90",
                 "nk_ce_dw_sm90"):               # csrc/cross_entropy_sm90.cu
        fn = getattr(lib, name)
        fn.argtypes = [i, p, p, p, p, p, p,      # dtype, x, w, tgt, lse, g,
                       i, i, i, p]               # out; N V D, stream
        fn.restype = i
    return lib
