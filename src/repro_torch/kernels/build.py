"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries go to ``build/kernels/`` at the repository root,
named by a hash of the sources and flags, and are built at first use;
:func:`build_all` starts one ``nvcc`` per source, all at once. Nothing
here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("taylor_predict_lanes", "taylor_update_lanes", "verify_accept",
           "taylor_predict_chain", "lane_rollback", "spectral_update_lanes",
           "taylor_update", "flash_attention", "flash_attention_sm90")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# argument types of each library's C entry points (the first entry has the
# same name as the file)
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    # diffs, w, out, dtype, m1, R, C, lanes, vec, stream, device; the
    # floor entry launches an empty kernel on the grid the same arguments
    # give the predict
    "taylor_predict_lanes": {
        "taylor_predict_lanes": (_P, _P, _P, _I, _I, _LL, _LL, _I, _I, _P,
                                 _I),
        "taylor_predict_lanes_floor": (_P, _P, _P, _I, _I, _LL, _LL, _I, _I,
                                       _P, _I)},
    # old, feats, mask, out, dtype, m1, R, C, lanes, vec, stream, device
    "taylor_update_lanes": {"taylor_update_lanes": (
        _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _P, _I)},
    "verify_accept": {
        # pred, ref, tau, partials, tickets, err, accept, dtype, W, N,
        # chunk, nchunks, eps, vec, stream, device
        "verify_accept": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I,
                          _F, _I, _P, _I),
        # pred, ref, tau, gscale, paired, partials, tickets, err, accept,
        # dtype, W, N, chunk, nchunks, eps, vec, pvec, stream, device
        "verify_accept_mixed": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _LL, _LL, _I, _F, _I, _I, _P, _I),
        # pred, ref, partials, tickets, sums, dtype, W, N, chunk, nchunks,
        # vec, stream, device
        "verify_sums": (_P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _P,
                        _I),
        # pred, ref, partials, tickets, err, dtype, W, N, chunk, nchunks,
        # eps, vec, stream, device
        "verify_error": (_P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _F, _I,
                         _P, _I)},
    # diffs, w, out, dtype, m1, K, R, C, lanes, vec, stream, device (and
    # the floor entry, as the lane predict's)
    "taylor_predict_chain": {
        "taylor_predict_chain": (_P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I,
                                 _P, _I),
        "taylor_predict_chain_floor": (_P, _P, _P, _I, _I, _I, _LL, _LL, _I,
                                       _I, _P, _I)},
    "lane_rollback": {
        # chain, idx, out, K, R, row_bytes, lanes, stream, device
        "lane_rollback": (_P, _P, _P, _I, _LL, _LL, _I, _P, _I),
        # snapshot pointer array, K+1, idx, out, R, row_bytes, lanes,
        # stream, device
        "lane_rollback_snapshots": (_P, _I, _P, _P, _LL, _LL, _I, _P, _I)},
    # old, feats, mask, out, dtype, m1, R, C, lanes, vec, stream, device
    "spectral_update_lanes": {"spectral_update_lanes": (
        _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _I, _P, _I)},
    # old, feats, out, dtype, feats_dtype, m1, n, vec, stream, device
    "taylor_update": {"taylor_update": (
        _P, _P, _P, _I, _I, _I, _LL, _I, _P, _I)},
    # q, k, v, out, B, S, H, hd, q/k/v strides (b, s, h), causal, window,
    # scale, stream, device: f32 (flash_attention) and bf16
    # (flash_attention_sm90, whose TMA maps are built from the strides)
    "flash_attention": {"flash_attention": (
        _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
        _LL, _LL, _I, _I, _F, _P, _I)},
    "flash_attention_sm90": {"flash_attention_sm90": (
        _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
        _LL, _LL, _I, _I, _F, _P, _I)},
}

_loaded: Dict[str, ctypes.CDLL] = {}
# what ptxas reported for each library (kept beside it as <library>.log)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (CUDA_HOME or "
                           "/usr/local/cuda)")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start one nvcc into a temporary file; returns (popen, tmp, final)."""
    final = _library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def build_all(names: Optional[List[str]] = None) -> Dict[str, Path]:
    """Build every missing library, one nvcc per source in parallel;
    returns name -> library path. Raises with nvcc's output on failure."""
    names = list(SOURCES if names is None else names)
    paths = {n: _library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in names:
        log = paths[n].with_suffix(".log")
        if n not in todo and n not in build_logs and log.exists():
            build_logs[n] = log.read_text()
    if not todo:
        return paths
    nvcc = nvcc_path()
    jobs = {n: _start(n, nvcc) for n in todo}
    failed = []
    for n, (proc, tmp, final) in jobs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode == 0:
            final.with_suffix(".log").write_text(out)
            os.replace(tmp, final)
        else:
            os.unlink(tmp)
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(name: str, lib: ctypes.CDLL, code: int) -> None:
    """Raise when a launch returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {code} ({msg})")
