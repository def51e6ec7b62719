"""What the resident kernels of ``csrc/resident.cu`` share on the Python
side: the ctypes parameter blocks, the library, the launch, and the
arithmetic of their plans.

The plans themselves live beside their wrappers (``resident_plan`` in
``ops/lstm_seq.py`` for K2 and in ``ops/wavefront.py`` for K4,
``rowgroup_plan``, ``rowgroup_bwd_plan`` and ``wgrad_plan`` in
``ops/lstm_seq.py`` for K1 and K3). A plan fixes the grid,
which block owns which rows, units and P columns, the padded sizes of the
in-block products and the shared-memory layout; the kernel reads all of
it from the parameter block and computes none of it itself, so the CPU
tests can check the partition without a card.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from rsrgan_tpu_torch.ops import _build

# Dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_CAP = 232448
ALIGN = 16


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def balanced_bounds(n: int, parts: int) -> List[int]:
    """[parts + 1] boundaries splitting range(n) into contiguous slices
    whose sizes differ by at most one: part i is [b[i], b[i+1])."""
    return [i * n // parts for i in range(parts + 1)]


def threads_per_sum(items: int) -> int:
    """Phase B's fixed-order sum: the threads (a power of two up to 32)
    that share one output's partials, so that a block's ``items`` outputs
    keep its 256 threads busy."""
    tpi = 1
    while tpi < 32 and items * tpi * 2 <= 256:
        tpi *= 2
    return tpi


def layout(fixed: Dict[str, int], weights: List[Tuple[str, int, int]],
           cap: int = SMEM_CAP, multiple: Optional[Dict[str, int]] = None):
    """Shared-memory layout: every ``fixed`` region (name -> bytes), then
    as many rows of each weight region (name, row bytes, rows) as still fit,
    in that order, rounded down to ``multiple[name]`` rows where given.
    Returns (offsets, resident rows per weight, total bytes), or raises
    ValueError when the fixed regions alone exceed ``cap``."""
    offsets, total = {}, 0
    for name, size in fixed.items():
        offsets[name] = total
        total += round_up(size, ALIGN)
    if total > cap:
        raise ValueError(f"{total} bytes of staging exceed the {cap} bytes "
                         "of shared memory a block may use")
    rows = {}
    for name, row_bytes, n_rows in weights:
        offsets[name] = total
        step = (multiple or {}).get(name, 1)
        rows[name] = min(n_rows, (cap - total) // row_bytes // step * step)
        total += round_up(rows[name] * row_bytes, ALIGN)
    return offsets, rows, total


class BwdParams(ctypes.Structure):
    """``BwdParams`` of csrc/resident.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "acts", "lengths", "dout", "c_hist", "wi", "wf", "wo", "proj_pk",
        "wh_pk", "bounds", "dh", "partial", "dxw", "m_out", "dh_out",
        "dbias", "dwi", "dwf", "dwo")]
        + [(n, ctypes.c_int) for n in (
            "T", "B", "U", "P", "blocks", "NU", "NUn", "K1", "ld1", "Np",
            "K2", "ld2", "Mp", "n_res_proj", "n_res_wh", "tpi", "acc",
            "off_a", "off_dm", "off_dg", "off_dc", "off_k", "off_proj",
            "off_wh", "smem")])


class FwdParams(ctypes.Structure):
    """``FwdParams`` of csrc/resident.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "xw1", "x", "lengths", "wg_pk", "wp_pk", "bias", "wi", "wf", "wo",
        "bounds", "h", "inbuf", "partial", "y", "tap_s", "c_s", "h_s",
        "acts")]
        + [(n, ctypes.c_int) for n in (
            "T", "B", "L", "U", "P", "residual", "save", "nbl", "NU", "NG",
            "Kp", "ldw", "Np", "Km", "ldm", "Mp", "n_res_g", "n_res_p",
            "tpi", "off_a", "off_gate", "off_m", "off_c", "off_k", "off_wg",
            "off_wp", "smem")])


class RowParams(ctypes.Structure):
    """``RowParams`` of csrc/resident.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "xw", "lengths", "wh_pk", "wp_pk", "bias", "wi", "wf", "wo", "rows",
        "out", "c_hist", "h_hist", "acts")]
        + [(n, ctypes.c_int) for n in (
            "T", "B", "U", "P", "save", "groups", "grows", "ngrp", "Kh",
            "ldh", "Np", "Km", "ldm", "ks", "kchunk", "ldx", "xchunk",
            "n_res_h", "n_res_p", "off_x", "off_h", "off_m", "off_c",
            "off_hf", "off_part", "off_k", "off_wh", "off_wp", "smem")])


class RowBwdParams(ctypes.Structure):
    """``RowBwdParams`` of csrc/resident.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "acts", "lengths", "dout", "c_hist", "wp_pk", "wh_pk", "wi", "wf",
        "wo", "rows", "dxw", "m_out", "dh_out", "part")]
        + [(n, ctypes.c_int) for n in (
            "T", "B", "U", "P", "groups", "grows", "ngrp", "K1", "ld1", "K2",
            "ld2", "Np", "ks", "kchunk", "lda", "achunk", "ldc", "cchunk",
            "n_res_p", "n_res_h", "off_a1", "off_a2", "off_dm", "off_acts",
            "off_c", "off_dc", "off_part", "off_len", "off_wp", "off_wh",
            "smem")])


class WgradParams(ctypes.Structure):
    """``WgradParams`` of csrc/resident.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "h_hist", "dxw", "m", "dh", "part", "split", "counters", "dwh",
        "dproj", "dbias", "dwi", "dwf", "dwo")]
        + [(n, ctypes.c_int) for n in (
            "T", "B", "U", "P", "groups", "splits", "tiles_wh", "tiles",
            "rows_wh", "rows_proj")])


PARAMS = (BwdParams, FwdParams, RowParams, RowBwdParams, WgradParams)
LAUNCHERS = ("lstm_bwd_resident", "wavefront_resident", "lstm_fwd_rowgroup",
             "lstm_bwd_rowgroup", "lstm_wgrad")


def library() -> ctypes.CDLL:
    lib = _build.load_library("resident")
    if lib.lstm_bwd_resident.argtypes is None:
        for name in LAUNCHERS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.resident_params_sizes.argtypes = [ctypes.c_int]
        lib.resident_params_sizes.restype = ctypes.c_int
        lib.resident_error_string.argtypes = [ctypes.c_int]
        lib.resident_error_string.restype = ctypes.c_char_p
        for which, struct in enumerate(PARAMS):
            if lib.resident_params_sizes(which) != ctypes.sizeof(struct):
                raise RuntimeError(f"{struct.__name__} does not match "
                                   "csrc/resident.cu")
    return lib


def launch(name: str, params: ctypes.Structure, bf16: bool,
           device: torch.device, shape: str) -> None:
    """Launch ``name`` (one of ``LAUNCHERS``) on the current stream of
    ``device``; raises RuntimeError on a refused launch, with the shape in
    the message."""
    lib = library()
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(ctypes.addressof(params), int(bf16), index,
                             stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed at {shape}: CUDA error {err} "
            f"({lib.resident_error_string(err).decode()})")


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def unit_index(bounds: List[int], width: int, pad: int,
               device) -> torch.Tensor:
    """[parts, width] int64: slice i's units, padded with ``pad``."""
    idx = torch.full((len(bounds) - 1, width), pad, dtype=torch.int64)
    for i in range(len(bounds) - 1):
        idx[i, :bounds[i + 1] - bounds[i]] = torch.arange(bounds[i],
                                                          bounds[i + 1])
    return idx.to(device)
