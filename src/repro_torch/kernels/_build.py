"""Build, load and call the hand-written CUDA kernels.

The ``.cu`` sources under ``csrc/`` have a plain C interface. On first use
each source is built by its own ``nvcc -shared`` process for ``sm_90a`` (all
of them at once) into its own shared library, loaded with ``ctypes``. The
libraries live in ``build/repro_torch_kernels/`` at the repository root;
their file names carry a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.

Nothing here runs at import time: a machine without ``nvcc`` or a card can
import the package and use the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("tree_refresh.cu", "topk_sim.cu", "browse_scores.cu",
           "flash_attention.cu", "flash_attention_bwd.cu",
           "decode_attention.cu", "mamba2_ssd.cu", "mamba2_ssd_bwd.cu",
           "rwkv6_scan.cu", "rwkv6_scan_bwd.cu")
HEADERS = ("tma.cuh", "mma.cuh", "wgmma.cuh",  # included by the sources:
           "tiles.cuh")                     # hashed
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point ``memforest_<kernel>``, defined in ``csrc/<kernel>.cu`` ->
# argument types; every entry point returns a cudaError_t
SIGNATURES: Dict[str, Tuple] = {
    "memforest_tree_refresh": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "memforest_topk_sim": (_P, _P, _P, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _P),
    "memforest_browse_scores": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _P),
    "memforest_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _P),
    "memforest_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _L, _I, _I, _I, _I, _I, _I, _I, _I,
                                      _P),
    "memforest_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "memforest_mamba2_ssd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _P),
    "memforest_mamba2_ssd_bwd": (_P,) * 14 + (_I,) * 7 + (_P,),
    "memforest_rwkv6_scan": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _I, _P),
    "memforest_rwkv6_scan_bwd": (_P,) * 15 + (_L,) + (_I,) * 7 + (_P,),
}


class LaunchCount:
    """Calls of one kernel wrapper: ``launches`` counts CUDA kernel launches
    (``by_thread`` splits them by the launching thread's name: the
    maintenance plane's worker launches ``tree_refresh`` beside the serve
    thread), ``plain_calls`` counts calls served by the plain PyTorch
    version (CPU tensors only)."""

    __slots__ = ("name", "launches", "by_thread", "plain_calls", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.by_thread: Dict[str, int] = {}
        self.plain_calls = 0
        self._lock = threading.Lock()

    def launched(self) -> None:
        """Count one launch of the kernel, from the calling thread."""
        thread = threading.current_thread().name
        with self._lock:
            self.launches += 1
            self.by_thread[thread] = self.by_thread.get(thread, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.by_thread = {}
            self.plain_calls = 0


@dataclass
class KernelLibrary:
    entries: Dict[str, ctypes._CFuncPtr]
    paths: List[Path]
    build_s: float                 # 0.0 when up-to-date libraries were found
    ptxas: str = field(repr=False, default="")   # only from a fresh build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build (pass device='cpu' to run the plain "
                       "PyTorch versions instead)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(outs: Dict[str, Path]) -> str:
    """Build each source into its library, all ``nvcc`` processes started
    together; return the compiler's resource report (registers, shared
    memory, spills)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in outs.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, str(CSRC / name), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = [], []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        reports.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            tmp.replace(out)    # a finished library appears in one step
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(reports))
    return "\n".join(reports)


_LIBRARY: Optional[KernelLibrary] = None
_LIBRARY_LOCK = threading.Lock()


def library() -> KernelLibrary:
    """The loaded kernel libraries, built first where no up-to-date one
    exists. Thread-safe: the first caller builds and loads them, a caller
    that arrives meanwhile (the maintenance plane's worker beside the serve
    thread) waits for that one build."""
    global _LIBRARY
    if _LIBRARY is None:
        with _LIBRARY_LOCK:
            if _LIBRARY is None:
                _LIBRARY = _load()
    return _LIBRARY


def _load() -> KernelLibrary:
    tag = source_hash()
    outs = {name: BUILD_DIR / f"lib{Path(name).stem}_{tag}.so"
            for name in SOURCES}
    missing = {name: p for name, p in outs.items() if not p.exists()}
    t0 = time.perf_counter()
    report = _compile(missing) if missing else ""
    build_s = time.perf_counter() - t0 if missing else 0.0
    entries = {}
    for entry, argtypes in SIGNATURES.items():
        lib = ctypes.CDLL(str(outs[entry.removeprefix("memforest_") + ".cu"]))
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        entries[entry] = fn
    return KernelLibrary(entries, list(outs.values()), build_s, report)


def check_cuda_inputs(name: str, *tensors: torch.Tensor,
                      dtypes=(torch.float32,)) -> torch.device:
    """Every input is a contiguous tensor on one CUDA device, of one of
    ``dtypes``."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: inputs must all lie on one CUDA device "
                             f"(got {[str(x.device) for x in tensors]})")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: the CUDA kernel takes "
                            f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             "tensors")
    return dev


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: the kernel's
    output would carry no autograd graph, so a ``backward()`` through it
    would silently give its inputs no gradient. Kernels without a backward
    kernel call this on their CUDA branch; their plain versions (CPU
    tensors) stay differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the CUDA "
                           "kernel has no backward kernel yet; call it under "
                           "torch.no_grad() or with inputs that do not "
                           "require grad")


def is_plain(name: str, *tensors: torch.Tensor) -> bool:
    """True when every input lies on the CPU (the plain version runs);
    False when every input lies on a CUDA device (the kernel runs)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{name}: inputs must all lie on the CPU or all on a "
                     f"CUDA device (got {sorted(kinds)})")


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream; raise if the
    launch was refused."""
    fn = library().entries[entry]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")


TMA_ALIGN = 8   # head dims the tensor maps take: 16-byte bf16 rows


def tma_ready(x: torch.Tensor, axes: int = 1,
              align: int = TMA_ALIGN) -> torch.Tensor:
    """``x`` with its last ``axes`` axes zero-padded to a multiple of
    ``align`` and its data 16-byte aligned, as the attention kernels'
    tensor maps and the bf16 scans' 16-byte copies need (``TMA_ALIGN``), or
    the f32 forest kernels' float4 loads (4); a copy only where ``x`` is not
    so already."""
    pad = []
    for d in reversed(x.shape[-axes:]):
        pad += [0, -d % align]
    if any(pad):
        return F.pad(x, pad)
    return x if x.data_ptr() % 16 == 0 else x.clone()


# one zeroed counter buffer per (device, stream), shared by the kernels that
# merge their splits inside the launch (``decode_attention``, ``topk_sim``):
# the last block of each merge sets its counter back to 0, and launches on
# one stream never overlap
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for launches on ``dev``'s current
    stream."""
    key = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def scan_slice(pairs: int, dim: int, sms: int, widest: int = 64,
               narrowest: int = 16) -> int:
    """Columns of P (``mamba2_ssd``) or V (``rwkv6_scan``) that one block of
    a bf16 scan owns: ``widest``, halved while the (batch, head) pairs times
    the slices leave SMs without a block, never below ``narrowest`` and
    never wider than ``dim`` rounded up to ``narrowest``. Columns are
    independent given the chunk's G or A, which each slice recomputes."""
    width = widest
    while width > narrowest and pairs * -(-dim // width) < sms:
        width //= 2
    return min(width, -(-dim // narrowest) * narrowest)

