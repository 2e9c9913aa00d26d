"""Just-in-time build of the package's CUDA kernels (``csrc/*.cu``).

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
"""

import collections
import ctypes
import os
import pathlib

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_ext"
SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "decode_attention.cu", "adam.cu",
           "fused.cu", "lamb.cu", "quantizer.cu", "sparse_attention.cu")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-lineinfo"]

# kernel name -> launches since the last reset
LAUNCHES = collections.Counter()

_P, _I, _F, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong, ctypes.c_ulonglong
_SIGNATURES = {
    "ds_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                     _F, _I, _I, _P],
    "ds_decode_attention": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                            _I, _I, _L, _L, _L, _L, _F, _I, _P],
    # q, k, v, do, lse, delta, dq, dk, dv, dtype, B, H, Sq, Sk, D,
    # strides (21 long long), sm_scale, causal, vec, stream
    "ds_flash_bwd_dq": [_P] * 9 + [_I] * 6 + [_P, _F, _I, _I, _P],
    "ds_flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [_P, _F, _I, _I, _P],
    # p, g, m, v, u, m_out, v_out, cast, n, clip_coef, lr, bc1, bc2, b1,
    # 1-b1, b2, 1-b2, eps, weight_decay, adam_w_mode, read_p, vec, stream
    "ds_adam": [_P] * 8 + [_L, _P] + [_F] * 9 + [_I, _I, _I, _P],
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
    # x, y, partial, partial_len, n, groups, transposed, R, C, num_bits,
    # symmetric, stochastic, seed, dtype, vec, stream
    "ds_quantize": [_P, _P, _P, _L, _L, _I, _I, _L, _L, _I, _I, _I, _U, _I,
                    _I, _P],
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
