"""The card's image decode: the nvJPEG record loader and its resize
kernel, and the decode of one JPEG (:func:`decode_jpeg`).

``csrc/image_nvjpeg.cu`` (CUDA C++ for ``sm_90a``, linked with the CUDA
toolkit's nvJPEG, built by ``_build.load_library`` at first use) holds
the record loader that ``image.ImageRecordIter`` runs on a card and the
hand-written kernel ``resize_round``: the bilinear resize and mirror of
``_native/csrc/image_loader.cc`` (``resize_to_chw``, host C++ in the JAX
package: no Pallas kernel) from interleaved uint8 RGB to float32 CHW in
[0, 1], then the iterator's mean and scale, with the host's roundings
one by one, so that from the same pixels the card and the host give the
same bits.  One launch takes a whole round of ragged images: the
loader's round (every record a batch decoded at once, those that failed
compacted out, the tail of the data's last batch written as blank
images) and :func:`resize_rgb_chw_batch`'s list, built by the same
rules (:func:`round_slots`, :func:`channel_mean`).
:func:`resize_rgb_chw_reference` and :func:`resize_rgb_chw_batch_reference`
are the plain versions; CPU tensors go through them, CUDA tensors launch
the kernel or raise.  Launches count under ``COUNTER`` (the loader's
under it too, with its rounds under ``ROUNDS_COUNTER``: the iterator adds
:func:`loader_lib`'s tallies after each batch).

:func:`decode_jpeg` decodes one buffer on a card with nvJPEG, as
``image.imdecode``, ``ImageIter``, ``ImageDetIter`` and the record
datasets do on a ``gpu`` context: HWC uint8 in RGB order (``flag`` 1),
grey (0) or as stored (-1), copied once to the host.  It uses the
library handle the loader uses (one a device) and a decoder of the
calling thread's own (its nvJPEG state, stream and buffer), so the
threads of a ``DataLoader`` decode at once.  This is a library decode,
not a kernel: no hand-written kernel runs; ``DECODE_COUNTER`` counts the
images decoded and ``DECODERS_COUNTER`` the decoders made (one a thread
and device).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..base import MXNetError
from .. import profiler
from . import _build

__all__ = ["resize_rgb_chw", "resize_rgb_chw_reference",
           "resize_rgb_chw_batch", "resize_rgb_chw_batch_reference",
           "round_slots", "round_table", "channel_mean", "launch_round",
           "div255_mismatches", "loader_lib", "decode_jpeg", "DESC",
           "KERNEL_SOURCE", "COUNTER", "ROUNDS_COUNTER", "DECODE_COUNTER",
           "DECODERS_COUNTER"]

KERNEL_SOURCE = "mxnet_tpu_torch/ops/csrc/image_nvjpeg.cu"
COUNTER = "resize_rgb_chw_launches"
ROUNDS_COUNTER = "nvjpeg_rounds"
DECODE_COUNTER = "nvjpeg_images_decoded"
DECODERS_COUNTER = "nvjpeg_decoders"

# One image of a round, as csrc/image_nvjpeg.cu's ``Desc``: the source's
# address (0: a blank image), sw / dw and sh / dh in fp32, the source's
# size, the mirror flag and the output image it writes.
DESC = np.dtype([("src", "<u8"), ("sx", "<f4"), ("sy", "<f4"),
                 ("sw", "<i4"), ("sh", "<i4"), ("flip", "<i4"),
                 ("slot", "<i4")])
MAX_ROUND = 65535   # images a launch (the grid's second dimension)

_lock = threading.Lock()
_bound = []

_p = ctypes.c_void_p
_SIGNATURES = {
    "mx_nvjpeg_create": (_p, [ctypes.c_char_p] + [ctypes.c_int] * 6
                         + [ctypes.c_uint, ctypes.c_int, _p, ctypes.c_float,
                            ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                            ctypes.c_int]),
    "mx_nvjpeg_num_samples": (ctypes.c_int64, [_p]),
    "mx_nvjpeg_next": (ctypes.c_int, [_p, ctypes.POINTER(ctypes.c_float),
                                      ctypes.POINTER(ctypes.c_float)]),
    "mx_nvjpeg_reset": (None, [_p]),
    "mx_nvjpeg_destroy": (None, [_p]),
    "mx_nvjpeg_failures": (ctypes.c_long, [_p]),
    "mx_nvjpeg_last_failed": (ctypes.c_int, [_p]),
    "mx_nvjpeg_launches": (ctypes.c_long, [_p]),
    "mx_nvjpeg_rounds": (ctypes.c_long, [_p]),
    "mx_nvjpeg_error": (ctypes.c_char_p, [_p]),
    "mx_resize_rgb_chw": (ctypes.c_int, [_p, ctypes.c_int, _p]
                          + [ctypes.c_int] * 3
                          + [_p, ctypes.c_float, ctypes.c_int, _p]),
    "mx_div255_mismatches": (ctypes.c_int, [ctypes.c_uint32, ctypes.c_uint32,
                                            _p, _p]),
    "mx_nvjpeg_decoder_create": (_p, [ctypes.c_int, ctypes.c_char_p,
                                      ctypes.c_int]),
    "mx_nvjpeg_image_info": (ctypes.c_int, [
        _p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]),
    "mx_nvjpeg_decode_image": (ctypes.c_int, [
        _p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, _p]),
    "mx_nvjpeg_decoder_error": (ctypes.c_char_p, [_p]),
    "mx_nvjpeg_decoder_destroy": (None, [_p]),
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


def _loader_lib_or_raise():
    try:
        return loader_lib()
    except MXNetError as e:
        raise MXNetError("JPEG decoding on the card needs nvJPEG "
                         "(ops/csrc/image_nvjpeg.cu), which could not be "
                         "built or loaded: %s" % e) from e


class _Decoder:
    """One thread's nvJPEG decoder of one device, freed with it."""

    def __init__(self, lib, device):
        err = ctypes.create_string_buffer(512)
        self._lib = lib
        self.handle = lib.mx_nvjpeg_decoder_create(device, err, len(err))
        if not self.handle:
            raise MXNetError("nvJPEG decoder on cuda:%d: %s"
                             % (device, err.value.decode(errors="replace")))
        profiler.bump(DECODERS_COUNTER)

    def __del__(self):
        handle, self.handle = getattr(self, "handle", None), None
        if handle:
            self._lib.mx_nvjpeg_decoder_destroy(handle)


_local = threading.local()


def _decoder(device):
    """The calling thread's decoder of CUDA device ``device`` (an index)."""
    lib = _loader_lib_or_raise()
    decoders = getattr(_local, "decoders", None)
    if decoders is None:
        decoders = _local.decoders = {}
    if device not in decoders:
        decoders[device] = _Decoder(lib, device)
    return lib, decoders[device]


def decode_jpeg(buf, flag=1, device=0):
    """JPEG bytes decoded with nvJPEG on CUDA device ``device`` into an
    HWC uint8 numpy array: RGB for ``flag`` 1, one grey channel for 0,
    as stored (1 or 3 channels) for -1, the channels libjpeg's decode
    gives.  Bytes nvJPEG refuses raise ``MXNetError("Decoding image
    failed: ...")``; a decoder that cannot be built raises naming
    nvJPEG.  There is no other decoder to fall back to."""
    lib, dec = _decoder(int(device))
    buf = bytes(buf)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.mx_nvjpeg_image_info(dec.handle, buf, len(buf), int(flag),
                                ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(c)) != 0:
        raise MXNetError("Decoding image failed: nvJPEG refused %d bytes"
                         % len(buf))
    out = np.empty((h.value, w.value, c.value), np.uint8)
    rc = lib.mx_nvjpeg_decode_image(dec.handle, buf, len(buf), int(flag),
                                    out.ctypes.data)
    if rc == 1:
        raise MXNetError("Decoding image failed: nvJPEG refused %d bytes"
                         % len(buf))
    if rc != 0:
        raise MXNetError("nvJPEG decode on cuda:%d failed: %s" % (
            device, lib.mx_nvjpeg_decoder_error(dec.handle).decode(
                errors="replace")))
    profiler.bump(DECODE_COUNTER)
    return out


def channel_mean(mean, channels):
    """``mean`` (the values a pixel loses after the division by 255: the
    iterator's ``mean_rgb / 255``) as ``channels`` float32 values, one a
    plane: flattened and broadcast as numpy broadcasts it in shape
    (1, -1, 1, 1) against a (batch, channels, h, w) batch, so it raises
    ``ValueError`` where numpy's ``-=`` would."""
    flat = np.asarray(mean, np.float32).reshape(-1)
    return np.broadcast_to(flat, (channels,)).copy()


def round_slots(decoded):
    """The loader's compaction: for each record of a round, whether it
    decoded in, the output image it goes to (the k-th that decoded to the
    k-th; the loader adds the slots its earlier rounds filled), None for
    one that failed."""
    slots, k = [], 0
    for ok in decoded:
        slots.append(k if ok else None)
        k += bool(ok)
    return slots


def _mirrors(mirrors, n):
    mirrors = [False] * n if mirrors is None else [bool(m) for m in mirrors]
    if len(mirrors) != n:
        raise MXNetError("resize_rgb_chw_batch: %d mirror flags for %d "
                         "images" % (len(mirrors), n))
    return mirrors


def round_table(srcs, dh, dw, mirrors=None):
    """The kernel's table for one round of ``len(srcs)`` images (a DESC
    row each): the sources that are not None to the slots
    :func:`round_slots` gives them, then a blank row for every slot
    past them, as the loader's last round of the data writes its tail."""
    mirrors = _mirrors(mirrors, len(srcs))
    table = np.zeros(len(srcs), DESC)
    slots = round_slots([s is not None for s in srcs])
    for src, flip, slot in zip(srcs, mirrors, slots):
        if slot is None:
            continue
        sh, sw = src.shape[:2]
        table[slot] = (src.data_ptr(), np.float32(sw) / np.float32(dw),
                       np.float32(sh) / np.float32(dh), sw, sh, flip, slot)
    n_decoded = sum(s is not None for s in slots)
    for slot in range(n_decoded, len(srcs)):
        table[slot] = (0, 1.0, 1.0, 1, 1, 0, slot)
    return table


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


def resize_rgb_chw_batch_reference(srcs, dh, dw, channels=3, mirrors=None,
                                   mean=None, scale=None):
    """Plain version of a round: each source that is not None through
    :func:`resize_rgb_chw_reference` into the slot :func:`round_slots`
    gives it, zeros past them, then the whole batch less ``mean``
    (:func:`channel_mean`) and times ``scale`` in float32, the order of
    ``ImageRecordIter``'s numpy ``-=`` and ``*=``; (len(srcs), channels,
    dh, dw)."""
    mirrors = _mirrors(mirrors, len(srcs))
    dev = next((s.device for s in srcs if s is not None),
               torch.device("cpu"))
    out = torch.zeros((len(srcs), channels, dh, dw), dtype=torch.float32,
                      device=dev)
    slots = round_slots([s is not None for s in srcs])
    for src, flip, slot in zip(srcs, mirrors, slots):
        if slot is not None:
            out[slot] = resize_rgb_chw_reference(src, dh, dw, channels, flip)
    if mean is not None:
        out -= torch.from_numpy(channel_mean(mean, channels)).to(
            dev).view(1, -1, 1, 1)
    if scale is not None:
        out *= torch.tensor(np.float32(scale), device=dev)
    return out


def launch_round(table, n, out, channels, mean=None, scale=None):
    """One launch of the kernel: ``n`` rows of ``table`` (DESC rows as a
    uint8 tensor on the card) into ``out`` (batch, channels, dh, dw)
    float32 on the card, less ``mean`` (``channels`` float32 values on the
    card) and times ``scale``, on the current stream."""
    dh, dw = out.shape[-2:]
    fn = loader_lib().mx_resize_rgb_chw
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(table.data_ptr(), n, out.data_ptr(), dw, dh, channels,
                 None if mean is None else mean.data_ptr(),
                 0.0 if scale is None else float(np.float32(scale)),
                 int(scale is not None), stream)
    if err != 0:
        raise MXNetError("resize_rgb_chw: kernel launch failed with "
                         "cudaError_t %d" % err)
    profiler.bump(COUNTER)


def div255_mismatches(device):
    """How many floats in [0, 256] the kernel divides by 255 otherwise
    than a true division does (its ``div255``, a multiply and one
    correction, against ``__fdiv_rn``), every one of them tried on
    ``device``, a CUDA device; the kernel's bits rest on this being 0."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    hi = int(np.float32(256.0).view(np.uint32))
    with torch.cuda.device(count.device):
        err = loader_lib().mx_div255_mismatches(
            0, hi, count.data_ptr(),
            torch.cuda.current_stream(count.device).cuda_stream)
    if err != 0:
        raise MXNetError("div255 check: launch failed with cudaError_t %d"
                         % err)
    return int(count.item())


def resize_rgb_chw_batch(srcs, dh, dw, channels=3, mirrors=None, mean=None,
                         scale=None):
    """A round of ragged ``srcs`` ((h, w, 3) uint8 RGB; None for a record
    that failed to decode) -> (len(srcs), channels, dh, dw) float32: the
    decoded images compacted to the front, blank images after them, each
    less ``mean`` and times ``scale`` where given.  On CUDA one launch of
    the hand-written kernel, on the CPU
    :func:`resize_rgb_chw_batch_reference`."""
    devices = {s.device for s in srcs if s is not None}
    if not devices or devices == {torch.device("cpu")}:
        return resize_rgb_chw_batch_reference(srcs, dh, dw, channels,
                                              mirrors, mean, scale)
    if len(devices) > 1:
        raise MXNetError("resize_rgb_chw_batch: sources on several devices "
                         "%s" % sorted(map(str, devices)))
    dev = devices.pop()
    if dev.type != "cuda":
        raise MXNetError("resize_rgb_chw: unsupported device %s" % dev)
    if len(srcs) > MAX_ROUND:
        raise MXNetError("resize_rgb_chw_batch: %d images; a round takes at "
                         "most %d" % (len(srcs), MAX_ROUND))
    for src in srcs:
        if src is not None and (src.dtype != torch.uint8 or src.dim() != 3
                                or src.shape[2] != 3
                                or not src.is_contiguous()):
            raise MXNetError("resize_rgb_chw: a source must be a contiguous "
                             "(h, w, 3) uint8 tensor, not %s %s"
                             % (tuple(src.shape), src.dtype))
    table = torch.from_numpy(round_table(srcs, dh, dw, mirrors).view(
        np.uint8)).pin_memory().to(dev, non_blocking=True)
    mean_t = None if mean is None else torch.from_numpy(
        channel_mean(mean, channels)).to(dev)
    out = torch.empty((len(srcs), channels, dh, dw), dtype=torch.float32,
                      device=dev)
    launch_round(table, len(srcs), out, channels, mean_t, scale)
    return out


def resize_rgb_chw(src, dh, dw, channels=3, mirror=False):
    """``src`` (sh, sw, 3) uint8 RGB -> (channels, dh, dw) float32 in
    [0, 1]: on CUDA a round of one image (:func:`resize_rgb_chw_batch`),
    on the CPU :func:`resize_rgb_chw_reference`."""
    if src.device.type == "cpu":
        return resize_rgb_chw_reference(src, dh, dw, channels, mirror)
    return resize_rgb_chw_batch([src], dh, dw, channels, [mirror])[0]
