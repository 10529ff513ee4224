"""The card's image decode: the nvJPEG record loader and its resize kernel.

``csrc/image_nvjpeg.cu`` (CUDA C++ for ``sm_90a``, linked with the CUDA
toolkit's nvJPEG, built by ``_build.load_library`` at first use) holds
the record loader that ``image.ImageRecordIter`` runs on a card (its
decode on nvJPEG, one batch prefetched) and the hand-written kernel
``resize_rgb_chw``: the bilinear resize and mirror of
``_native/csrc/image_loader.cc`` (``resize_to_chw``, host C++ in the JAX
package: no Pallas kernel) from interleaved uint8 RGB to float32 CHW in
[0, 1], with the host loop's roundings one by one, so that from the same
pixels the card and the host give the same bits.
:func:`resize_rgb_chw_reference` is its plain version; a CPU tensor goes
through it, a CUDA tensor launches the kernel or raises.  The loader's
launches count under ``COUNTER`` (:func:`loader_launches` is the
loader's own tally, which the iterator adds to it after each batch).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..base import MXNetError
from .. import profiler
from . import _build

__all__ = ["resize_rgb_chw", "resize_rgb_chw_reference", "loader_lib",
           "KERNEL_SOURCE", "COUNTER"]

KERNEL_SOURCE = "mxnet_tpu_torch/ops/csrc/image_nvjpeg.cu"
COUNTER = "resize_rgb_chw_launches"

_lock = threading.Lock()
_bound = []

_p = ctypes.c_void_p
_SIGNATURES = {
    "mx_nvjpeg_create": (_p, [ctypes.c_char_p] + [ctypes.c_int] * 6
                         + [ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                            ctypes.c_char_p, ctypes.c_int]),
    "mx_nvjpeg_num_samples": (ctypes.c_int64, [_p]),
    "mx_nvjpeg_next": (ctypes.c_int, [_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_float)]),
    "mx_nvjpeg_reset": (None, [_p]),
    "mx_nvjpeg_destroy": (None, [_p]),
    "mx_nvjpeg_failures": (ctypes.c_long, [_p]),
    "mx_nvjpeg_last_failed": (ctypes.c_int, [_p]),
    "mx_nvjpeg_launches": (ctypes.c_long, [_p]),
    "mx_nvjpeg_error": (ctypes.c_char_p, [_p]),
    "mx_resize_rgb_chw": (ctypes.c_int, [_p, ctypes.c_int, ctypes.c_int, _p]
                          + [ctypes.c_int] * 4 + [_p]),
}


def loader_lib():
    """The CDLL of ``csrc/image_nvjpeg.cu`` (built at first use), its
    signatures set."""
    with _lock:
        if not _bound:
            lib = _build.load_library("image_nvjpeg")
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _bound.append(lib)
        return _bound[0]


def resize_rgb_chw_reference(src, dh, dw, channels=3, mirror=False):
    """Plain version: ``src`` (sh, sw, 3) uint8 RGB -> (channels, dh, dw)
    float32 in [0, 1], ``image_loader.cc``'s bilinear formula (sample at
    (i + 0.5) * s - 0.5, clamped at the edges) in fp32, operation by
    operation; a channel past the third repeats the third."""
    sh, sw = src.shape[:2]
    dev, f32 = src.device, torch.float32
    sx = torch.tensor(np.float32(sw) / np.float32(dw))
    sy = torch.tensor(np.float32(sh) / np.float32(dh))

    def axis(n_out, n_in, s, flip):
        i = torch.arange(n_out, device=dev, dtype=f32)
        if flip:
            i = i.flip(0)
        f = (i + 0.5) * s.to(dev) - 0.5
        i0 = torch.where(f < 0, torch.zeros_like(f), f.trunc()).long()
        i0 = i0.clamp(max=n_in - 1)
        i1 = (i0 + 1).clamp(max=n_in - 1)
        wt = (f - i0.to(f32)).clamp_min(0)
        return i0, i1, wt, 1.0 - wt

    y0, y1, wy, uy = axis(dh, sh, sy, False)
    x0, x1, wx, ux = axis(dw, sw, sx, mirror)
    chans = torch.tensor([min(ch, 2) for ch in range(channels)], device=dev)
    v = src.to(f32)[:, :, chans]                  # (sh, sw, channels)
    wx, ux = wx[None, :, None], ux[None, :, None]
    top = ux * v[y0][:, x0] + wx * v[y0][:, x1]
    bot = ux * v[y1][:, x0] + wx * v[y1][:, x1]
    out = uy[:, None, None] * top + wy[:, None, None] * bot
    out = out / torch.full_like(out, 255.0)      # a true division
    return out.permute(2, 0, 1).contiguous()


def resize_rgb_chw(src, dh, dw, channels=3, mirror=False):
    """``src`` (sh, sw, 3) uint8 RGB -> (channels, dh, dw) float32 in
    [0, 1]: on CUDA one launch of the hand-written kernel, on the CPU
    :func:`resize_rgb_chw_reference`."""
    if src.device.type == "cpu":
        return resize_rgb_chw_reference(src, dh, dw, channels, mirror)
    if src.device.type != "cuda":
        raise MXNetError("resize_rgb_chw: unsupported device %s"
                         % src.device)
    if src.dtype != torch.uint8 or src.dim() != 3 or src.shape[2] != 3 \
            or not src.is_contiguous():
        raise MXNetError("resize_rgb_chw: the source must be a contiguous "
                         "(h, w, 3) uint8 tensor, not %s %s"
                         % (tuple(src.shape), src.dtype))
    out = torch.empty((channels, dh, dw), dtype=torch.float32,
                      device=src.device)
    fn = loader_lib().mx_resize_rgb_chw
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(src.data_ptr(), src.shape[1], src.shape[0], out.data_ptr(),
                 dw, dh, channels, int(bool(mirror)), stream)
    if err != 0:
        raise MXNetError("resize_rgb_chw: kernel launch failed with "
                         "cudaError_t %d" % err)
    profiler.bump(COUNTER)
    return out
