"""Just-in-time build of the package's CUDA kernels (``csrc/*.cu``) and
of its host libraries (``csrc/cpu_adam.cpp``, ``csrc/aio.cpp``).

The kernels are compiled for Hopper (``sm_90a``) by
``torch.utils.cpp_extension.load`` into ``build/torch_ext/`` at the
checkout's root on first use, and loaded as one shared library with a
plain C interface through ``ctypes``. The sources include no PyTorch
header, so the build takes seconds rather than minutes. The import of
``torch.utils.cpp_extension`` happens inside :func:`load_kernels`, so the
package imports on machines without ``nvcc``. A failed build raises.

Every wrapper that launches a kernel adds one to its entry in
:data:`LAUNCHES` at the launch and nowhere else, so a run can show that
its main path went through the kernels.

The host libraries of the optimizer offload (CPU-Adam and the async IO
engine) are plain C++ with a C interface and no CUDA: :func:`load_host`
compiles one with the host compiler (``g++``, the flags of the JAX
package's ``CPUAdamBuilder``, ``-march=native`` dropped if the compiler
refuses it) into ``build/torch_ext/`` on first use, keyed by the
source's content, and loads it through ``ctypes``; it needs no ``nvcc``.
"""

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "decode_attention.cu", "adam.cu",
           "fused.cu", "lamb.cu", "quantizer.cu", "sparse_attention.cu")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-lineinfo"]

# kernel name -> launches since the last reset
LAUNCHES = collections.Counter()

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "ds_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                     _F, _I, _I, _P],
    # the packed DecodeArgs (ops/transformer/decode.py _ARGS), stream
    "ds_decode_attention": [ctypes.c_char_p, _P],
    # q, k, v, o, do, lse, g_lse, delta, dq, dk, dv, dtype, B, H, Sq, Sk,
    # D, strides (24 long long), sm_scale, causal, vec, stream
    "ds_flash_bwd_dq": [_P] * 11 + [_I] * 6 + [_P, _F, _I, _I, _P],
    "ds_flash_bwd_dkv": [_P] * 11 + [_I] * 6 + [_P, _F, _I, _I, _P],
    # p, g, m, v, u, m_out, v_out, cast, n, clip_coef, lr, bc1, bc2, b1,
    # 1-b1, b2, 1-b2, eps, weight_decay, adam_w_mode, read_p, vec, stream
    "ds_adam": [_P] * 8 + [_L, _P] + [_F] * 9 + [_I, _I, _I, _P],
    # table (host int64 [n, 6]), n_tensors, u, m_out, v_out, lr, bc1, bc2,
    # b1, 1-b1, b2, 1-b2, eps, weight_decay, adam_w_mode, stream
    "ds_adam_multi": [_P, _I, _P, _P, _P] + [_F] * 9 + [_I, _P],
    # x, gamma, beta, y, mu, rstd, n, h, eps, dtype, vec, stream
    "ds_ln_fwd": [_P] * 6 + [_L, _I, _F, _I, _I, _P],
    # x, gamma, mu, rstd, dy, dx, n, h, dtype, vec, stream
    "ds_ln_bwd": [_P] * 6 + [_L, _I, _I, _I, _P],
    # x, bias, y, total, h, dtype, vec, stream
    "ds_bias_gelu": [_P] * 3 + [_L, _I, _I, _I, _P],
    # table, n_tensors, n_chunks, partial, wsq, usq, bc1, bc2, b1, 1-b1,
    # b2, 1-b2, eps, weight_decay, stream
    "ds_lamb": [_P, _I, _L, _P, _P, _P] + [_F] * 8 + [_P],
    # x, y, n, h, scale, dtype, stream
    "ds_softmax": [_P, _P, _L, _I, _F, _I, _P],
    # table (host int64 [n, 9]), n_tensors, partial, scale, count, chunks,
    # groups, symmetric, stochastic, stream
    "ds_quantize_multi": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # ptrs (15: q, k, v, o, dout, lse, delta, dq, dk, dv, bias, dbias, ptr,
    # idx, bits), strides (24), dims (11), sm_scale, stream
    "ds_sparse_fwd": [_P, _P, _P, _F, _P],
    "ds_sparse_dq": [_P, _P, _P, _F, _P],
    "ds_sparse_dkv": [_P, _P, _P, _F, _P],
}

_lib = None


def reset_launch_counts():
    LAUNCHES.clear()


def load_kernels():
    """Build (once per process, cached on disk by content) and load the
    kernel library; returns the ``ctypes.CDLL``."""
    global _lib
    if _lib is None:
        from torch.utils.cpp_extension import load
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        path = load(name="deepspeed_tpu_torch_kernels",
                    sources=[str(_CSRC / s) for s in SOURCES],
                    build_directory=str(BUILD_DIR),
                    extra_cuda_cflags=NVCC_FLAGS, is_python_module=False)
        lib = ctypes.CDLL(os.fspath(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(err: int, name: str):
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


# ------------------------------------------------------------ host libraries
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-march=native",
              "-fopenmp", "-pthread"]
_PF = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
# library -> (source, {entry: (argtypes, restype)})
HOST_LIBRARIES = {
    "cpu_adam": ("cpu_adam.cpp", {
        "ds_adam_create": ([_I, _F, _F, _F, _F, _I], _I),
        "ds_adam_step": ([_I, _I64, _F, _PF, _PF, _PF, _PF, _I64], _I),
        "ds_adam_destroy": ([_I], _I),
        "ds_adagrad_step": ([_F, _F, _F, _PF, _PF, _PF, _I64], _I),
        "ds_has_avx2": ([], _I)}),
    "aio": ("aio.cpp", {
        "aio_handle_create": ([_I] * 5, _I64),
        "aio_handle_destroy": ([_I64], _I),
        "aio_async_pread": ([_I64, _P, ctypes.c_char_p, _I64, _I64], _I64),
        "aio_async_pwrite": ([_I64, _P, ctypes.c_char_p, _I64, _I64], _I64),
        "aio_sync_pread": ([_I64, _P, ctypes.c_char_p, _I64, _I64], _I64),
        "aio_sync_pwrite": ([_I64, _P, ctypes.c_char_p, _I64, _I64], _I64),
        "aio_wait": ([_I64, _I64], _I64),
        "aio_pending": ([_I64], _I64),
        "aio_kernel_available": ([ctypes.c_char_p], _I),
        "aio_max_inflight": ([], _I64),
        "aio_reset_max_inflight": ([], None)}),
}
_host = {}


def host_compiler_available():
    """True when the host compiler the host libraries need is on PATH."""
    return shutil.which("g++") is not None


def load_host(name):
    """Build (once, cached on disk by the source's content) and load host
    library ``name`` of :data:`HOST_LIBRARIES`; returns the ``ctypes.CDLL``.
    Processes that build at once (the ranks of one machine) each write a
    file of their own and rename it into place."""
    if name in _host:
        return _host[name]
    source, entries = HOST_LIBRARIES[name]
    src = _CSRC / source
    if not host_compiler_available():
        raise RuntimeError(f"host library {name}: no g++ on PATH")
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(HOST_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"ds_host_{name}_{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *HOST_FLAGS, str(src), "-o", str(tmp)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            # a compiler that refuses -march=native: without it, as the
            # JAX package's build does
            done = subprocess.run([c for c in cmd if c != "-march=native"],
                                  capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"building host library {name} failed:\n"
                               f"{done.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(os.fspath(lib_path))
    for entry, (argtypes, restype) in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = restype
    _host[name] = lib
    return lib
