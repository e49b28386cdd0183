"""Build the port's CUDA kernels into one shared library, at first use.

Every ``*.cu`` file in ``csrc/`` is compiled by its own ``nvcc`` process,
all started together, for ``sm_90a`` (Hopper), and the objects are linked
into one ``.so`` with a plain C interface that :mod:`repro_torch.kernels.ops`
loads with ``ctypes``.  The library lands in ``build/repro_torch/`` at the
root of the checkout, named by a hash of the sources and flags, so an edited
source is never served by a stale build.  Nothing here runs when the module
is imported.

No ``--use_fast_math``: the quantizer needs IEEE division and ``rintf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "library_path",
           "build", "load", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# (name, argtypes) of every C entry point; ctypes would otherwise pass each
# pointer as a 32-bit int
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ENTRY_POINTS = {
    # win, sig, out, B, L, T, C, then the geometry: tile, blocks, threads,
    # shared-memory bytes
    "signature_corr_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P),
    # x, out, scratch, numel, cols, group floats, rq, qmax, then the
    # geometry: variant, blocks, threads, shared-memory bytes
    "fake_quant_launch": (_P, _P, _P, _LL, _I, _LL, _F, _F, _I, _I, _I, _I,
                          _P),
    # pts, centres, radii, counts, B, N, D, K, iters, then the geometry:
    # variant, blocks, threads, shared-memory bytes
    "kmeans_coreset_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P),
    # windows, idx, vals, weights, B, T, C, m, width, keep, floor, then the
    # geometry: variant, tile, blocks, threads, shared-memory bytes
    "importance_select_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                                 _I, _I, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    """``$NVCC``, then ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    and ``nvcc`` on ``PATH``."""
    cands = [os.environ.get("NVCC")]
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME; the CUDA "
                       "kernels are built on the machine with the card")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build(ptxas_verbose: bool = False) -> tuple[Path, str, float]:
    """Compile and link the kernels unless this exact build exists.

    Returns ``(library path, compiler log, seconds spent)``; the log holds
    ``-Xptxas -v``'s register and spill report when ``ptxas_verbose``, and
    is kept beside the library, so a later call that finds the build
    returns the log it was built with."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else "", 0.0
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in jobs:
            text, _ = proc.communicate()
            logs.append(f"--- {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so_tmp = Path(tmp) / out.name
        link = [nvcc, "-shared", *NVCC_FLAGS, "-o", str(so_tmp),
                *[str(obj) for _, obj, _ in jobs]]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        log_path.write_text("\n".join(logs))
        os.replace(so_tmp, out)
    return out, "\n".join(logs), time.perf_counter() - t0


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes of every kernel in a ``-Xptxas -v`` log:
    ``{mangled entry name: {"registers", "spill_stores", "spill_loads"}}``."""
    report: dict[str, dict[str, int]] = {}
    entry = None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
            report[entry] = dict(registers=0, spill_stores=0, spill_loads=0)
        elif entry is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            report[entry].update(spill_stores=int(m.group(1)),
                                 spill_loads=int(m.group(2)))
        elif m := re.search(r"Used (\d+) registers", line):
            report[entry]["registers"] = int(m.group(1))
    return report


def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare every entry point."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
