"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface (``*.cuh`` headers are
included by them and hashed with them).  The first kernel call
in a process compiles them with ``nvcc``, one process per source, all
started together, and links the objects into one shared library under
``fusionocc_tpu_torch/_build/`` (named by a hash of the sources and flags, so
an edit rebuilds), which it loads with ``ctypes``.  Every pointer and the CUDA
stream go over as ``c_void_p``; each C entry returns ``cudaGetLastError()``
after its launch, and ``launch`` raises when that is not ``cudaSuccess``.

``KERNELS.launches`` counts, per kernel, the launches that went through
``launch``: a run resets the counts and reads them afterwards to show which
kernels its path really used.

Each kernel is a ``torch.library`` custom op in the ``fusionocc``
namespace (registered by ``ops/bev_pool.py``, ``ops/window_attn.py``,
``ops/zwin_conv.py``, ``ops/plane_sweep.py``, ``ops/swin_glue.py`` and,
for the six ``index_*`` entries of a sparse stage's index builds,
``ops/sparse_conv.py``): its CPU implementation is the plain version, its
CUDA implementation the wrapper that launches the kernel, and a fake
implementation gives ``torch.export`` its output's shape.  An exported program calls the op, so its launches go through
``launch`` and are counted too.  ``exporting()`` tells the index builds to
take their static capacities instead of reading a padded width from the
card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry point -> argument types (each returns an int cudaError_t)
SIGNATURES: Dict[str, List] = {
    # depth, feat, ranks_depth, ranks_feat, bounds, long_voxels, n_long, out,
    # num_voxels, C, max_short, feat dtype, out dtype (0 f32, 1 bf16), stream
    'bev_pool_fwd': [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, bias, out, Bn, N, C, heads, head_dim, stride_win, stride_tok,
    # nWh, nWw, w, shift, scale, dtype (0 f32, 1 bf16), stream
    'window_attn_fwd': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L,
                        _I, _I, _I, _I, _F, _I, _P],
    # feats, nbr, mask_out, weight (27, cin, cout) in fp32, (27, cout, cin)
    # in bf16, out, B, S_in, S_out, cin, cout, stride, L_in, L_out, (zi_lo,
    # nzi) for ds = 0, 1, 2, dtype (0 f32, 1 bf16), stream
    'zwin_conv_fwd': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _I, _P],
}
# K3's bf16 body with the products left out (the microbenchmark's null
# variant), same arguments, bf16 only
SIGNATURES['zwin_conv_null'] = SIGNATURES['zwin_conv_fwd']
# K3 with the fused eval epilogue: after weight, inv (L_out fp32), shift
# (L_out fp32) and the lane mask (B, S_out, f_out) uint8; then as
# zwin_conv_fwd from out on
SIGNATURES['zwin_conv_fwd_epi'] = (SIGNATURES['zwin_conv_fwd'][:4]
                                   + [_P, _P, _P]
                                   + SIGNATURES['zwin_conv_fwd'][4:])
# a sparse stage's index builds (csrc/sparse_index.cu, driven by
# ops/sparse_conv.py): coords, mask, occupancy, B, V, sx, sy, sz, n_pad
SIGNATURES['index_mark'] = [_P, _P, _P, _I, _I, _I, _I, _I, _L, _P]
# occupancy, tile offsets, n, done counters, B, T, n_pad, capacity
SIGNATURES['index_count'] = [_P, _P, _P, _P, _I, _I, _L, _I, _P]
# occupancy, tile offsets, count, B, T, n_out, n_pad
SIGNATURES['index_prefix'] = [_P, _P, _P, _I, _I, _I, _L, _P]
# count, n, keys, coords, mask, B, n_out, S, sy, sz
SIGNATURES['index_set'] = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
# keys, mask, table, G, V, row_len
SIGNATURES['index_table'] = [_P, _P, _P, _I, _I, _L, _P]
# table, in coords, in mask, out coords, out mask, in lane mask, SubM map,
# stride-2 map, out lane mask, G, V, S, sx, sy, sz, row_len, f_in, f_out
SIGNATURES['index_maps'] = [_P] * 9 + [_I] * 6 + [_L, _I, _I, _P]
# the plane sweep (csrc/plane_sweep.cu, ops/plane_sweep.py): prev, curr,
# frustum, cams, out, invalid (or null), BN, D, H, W, C, hi, wi, bias_ch,
# bias, dtype (0 f32, 1 bf16)
SIGNATURES['plane_sweep_fwd'] = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
# Swin's block glue (csrc/swin_glue.cu, ops/swin_glue.py): x, r (or null),
# x + r (or null), norm1's weight, bias, windows / o, x, x + o, norm2's
# weight, bias, its norm; then B, H, W, C, w, shift, eps, dtype
SIGNATURES['window_in_fwd'] = [_P] * 6 + [_I] * 6 + [_F, _I, _P]
SIGNATURES['window_out_fwd'] = SIGNATURES['window_in_fwd']


def find_nvcc() -> str:
    """Path of nvcc: $PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError(
        'nvcc not found (looked in $PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)'
        '; building the kernels needs: nvcc ' + ' '.join(NVCC_FLAGS)
        + f' -c {CSRC}/<name>.cu, then nvcc -shared -o <lib>.so *.o')


class KernelLibrary:
    """The compiled ``csrc/*.cu`` library and its per-kernel launch counts."""

    def __init__(self, build_dir: Path = BUILD_DIR, csrc: Path = CSRC):
        self.build_dir = Path(build_dir)
        self.csrc = Path(csrc)
        self.launches: Dict[str, int] = {name: 0 for name in SIGNATURES}
        self.build_log = ''
        self.build_seconds: Optional[float] = None
        self._lib: Optional[ctypes.CDLL] = None

    def _sources(self) -> List[Path]:
        return sorted(self.csrc.glob('*.cu'))

    def library_path(self) -> Path:
        h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
        for src in self._sources() + sorted(self.csrc.glob('*.cuh')):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return self.build_dir / f'libfusionocc_kernels_{h.hexdigest()[:16]}.so'

    def build(self) -> Path:
        """Compile the sources unless a library of the same hash exists:
        one ``nvcc -c`` per source, run in parallel, then one link."""
        path = self.library_path()
        if path.exists():
            return path
        nvcc = find_nvcc()
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tag = f'{path.stem}.{os.getpid()}'
        t0 = time.perf_counter()
        jobs = []
        for src in self._sources():
            obj = self.build_dir / f'{tag}.{src.stem}.o'
            cmd = [nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f'{" ".join(cmd)} ({proc.returncode}):\n'
                              + logs[-1][-4000:])
        objs = [str(obj) for _, obj, _ in jobs]
        tmp = path.with_suffix(f'.{os.getpid()}.tmp')
        if not failed:
            cmd = [nvcc, '-shared', '-o', str(tmp), *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f'{" ".join(cmd)} ({proc.returncode}):\n'
                              + logs[-1][-4000:])
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = '\n'.join(logs)
        if failed:
            raise RuntimeError('kernel build failed: ' + '; '.join(failed))
        os.replace(tmp, path)
        return path

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fo_error_string.argtypes = [ctypes.c_int]
            lib.fo_error_string.restype = ctypes.c_char_p
            # K3's bf16 launch plan (not a kernel: not counted)
            lib.zwin_conv_plan.argtypes = [_I, _I, _I, _P]
            lib.zwin_conv_plan.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, name: str, *args) -> None:
        """Call C entry ``name``; raise on a CUDA error, else count it."""
        lib = self.load()
        err = getattr(lib, name)(*args)
        if err != 0:
            msg = lib.fo_error_string(err).decode()
            raise RuntimeError(f'{name}: CUDA error {err} ({msg})')
        self.launches[name] += 1

    def reset_counts(self) -> None:
        for name in self.launches:
            self.launches[name] = 0


# One library per process, as there is one CUDA context per process.
KERNELS = KernelLibrary()


def exporting() -> bool:
    """True while ``torch.export`` traces: the builds then size their
    tensors by the static capacities (JAX's shapes), as a traced program
    cannot read a width from the card."""
    import torch
    return torch.compiler.is_exporting()


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle (launch
    with ``device`` current: a stream belongs to its device).  Read raw,
    without the ``torch.cuda.Stream`` object ``current_stream`` builds:
    about 0.2 us against 3 a launch on the card's host."""
    import torch
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
