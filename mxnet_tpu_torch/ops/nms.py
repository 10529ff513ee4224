"""Greedy non-maximum suppression: the CUDA kernels' wrapper and their plain
version.

Counterpart of the greedy NMS loops of the JAX package, which are
``lax.fori_loop``s and no Pallas kernel: ``mxnet_tpu/ops/ssd.py:237``
(``_nms_one``, class-aware unless ``force_suppress``, under
``MultiBoxDetection``) and ``mxnet_tpu/ops/rcnn.py:91-99`` (class-agnostic,
under ``Proposal`` and ``MultiProposal``).  In PyTorch each step of that loop
is about ten launches, and a call takes up to one step a box (8,732 at
SSD-300's anchors, 6,000 at Proposal's default), so the walk is two kernels
in ``csrc/nms.cu`` (CUDA C++ for ``sm_90a``, built by
``_build.load_library`` at its first launch): ``mask_kernel`` writes, over
the whole card, one ``uint64`` of suppression bits for each box i < trip
and each 64-box column tile at or after its own (bit r of word u: box
64u + r dies if i is kept), into a scratch of :func:`scratch_shape`; then
``walk_kernel``, one block an image, walks the tiles in order with one
barrier a tile.  A call is two launches (one, the walk, when trip is 0),
each counted under ``COUNTER``; no value comes back to the host, so a
call can be captured.  The scratch grows as n x trip an image: 8 *
B * ceil(n / 64) * trip bytes, 306 MB at SSD-300's 32 x 8,732 boxes with
``nms_topk`` -1, and inside a captured program it is held in the graph's
pool.  The walk keeps a word a tile in shared memory, so an image holds
at most 360,448 boxes (the wrapper raises past that, or past 65,535
images).  :func:`nms_reference` is the loop itself; a CPU or ``meta``
tensor goes through it, a CUDA tensor launches the kernels or raises.  ``test_utils.nms_tiled`` is the kernels'
decomposition in plain PyTorch, held to both loops by the CPU tests.

Both take the boxes sorted by score, (B, n, 4) corners, their class ids
(B, n), the alive mask (B, n) and the trip count, and return the alive
mask after suppression.  The IoU is :func:`iou_row`, ``_iou_matrix``'s
roundings in its order (``ssd.py:84-96``), in float32 or float64; 16-bit
boxes are widened to float32 first, on both routes.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from .. import profiler
from . import _build

__all__ = ["nms", "nms_reference", "iou_row", "launch_count",
           "reset_launch_count", "scratch_shape", "TILE", "KERNEL_SOURCE",
           "COUNTER"]

KERNEL_SOURCE = "mxnet_tpu_torch/ops/csrc/nms.cu"
COUNTER = "nms_launches"
TILE = 64            # boxes a suppression word
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
# walk_kernel keeps a word a tile in shared memory, at most 44 KB beside its
# own 2,080 bytes (a block's 48 KB without opting in): n <= 360,448, whose
# scratch is some 16 GB an image
_MAX_WORDS = 44 * 1024 // 8
_MAX_BATCH = 65535   # mask_kernel's grid y


def launch_count():
    """Kernel launches since the last :func:`reset_launch_count`."""
    return profiler.counter(COUNTER)


def reset_launch_count():
    profiler.reset_counters(COUNTER)


def _words(n):
    return -(-int(n) // TILE)


def scratch_shape(batch, n, trip):
    """(B, column tiles, trip) ``int64``: word (u, i) holds box i's
    suppression bits for boxes 64u to 64u + 63."""
    return (int(batch), _words(n), int(trip))


def _check_limits(batch, n):
    if _words(n) > _MAX_WORDS or batch > _MAX_BATCH:
        raise MXNetError("nms: (%d, %d) boxes exceed the kernels' limits "
                         "(n <= %d, B <= %d)"
                         % (batch, n, _MAX_WORDS * TILE, _MAX_BATCH))


def _kernel():
    fn = _build.load_library("nms").nms_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.c_double, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def iou_row(box, boxes):
    """IoU of ``box`` (..., 1, 4) with each of ``boxes`` (..., n, 4) ->
    (..., n), operation by operation as ``_iou_matrix`` computes it."""
    ax0, ay0, ax1, ay1 = box.unbind(-1)
    gx0, gy0, gx1, gy1 = boxes.unbind(-1)
    inter = ((torch.minimum(ax1, gx1) - torch.maximum(ax0, gx0)).clamp(min=0)
             * (torch.minimum(ay1, gy1) - torch.maximum(ay0, gy0))
             .clamp(min=0))
    area_a = (ax1 - ax0).clamp(min=0) * (ay1 - ay0).clamp(min=0)
    area_g = (gx1 - gx0).clamp(min=0) * (gy1 - gy0).clamp(min=0)
    union = area_a + area_g - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _widen(boxes, classes):
    if boxes.dtype not in _DTYPE_CODE:
        boxes = boxes.float()
    return boxes, classes.to(boxes.dtype)


def nms_reference(boxes, classes, alive, trip, threshold,
                  force_suppress=False):
    """Plain version: the JAX loop, batched over the images.  For i in
    [0, trip): box i, if alive, kills every later box of its class (any
    class with ``force_suppress``) whose IoU with it is above
    ``threshold``."""
    boxes, classes = _widen(boxes, classes)
    alive = alive.clone()
    if boxes.device.type == "meta":
        return alive
    later = torch.arange(boxes.shape[1], device=boxes.device)
    for i in range(int(trip)):
        kill = iou_row(boxes[:, i:i + 1], boxes) > threshold
        if not force_suppress:
            kill &= classes == classes[:, i:i + 1]
        kill &= (later > i) & alive[:, i:i + 1]
        alive &= ~kill
    return alive


def nms(boxes, classes, alive, trip, threshold, force_suppress=False):
    """The alive mask (B, n) after greedy suppression of the score-sorted
    ``boxes`` (B, n, 4) with class ids ``classes`` (B, n) and the mask
    ``alive`` (B, n, bool), over the first ``trip`` boxes.  On the CPU (or
    ``meta``) it runs :func:`nms_reference`; on CUDA it launches the
    kernels on a scratch of :func:`scratch_shape`."""
    if boxes.device.type in ("cpu", "meta"):
        return nms_reference(boxes, classes, alive, trip, threshold,
                             force_suppress)
    if boxes.device.type != "cuda":
        raise MXNetError("nms: unsupported device %s" % boxes.device)
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or tuple(classes.shape) != tuple(boxes.shape[:2]) \
            or tuple(alive.shape) != tuple(boxes.shape[:2]) \
            or alive.dtype != torch.bool:
        raise MXNetError("nms: boxes (B, n, 4), classes (B, n) and a bool "
                         "alive mask (B, n) expected, got %s, %s, %s %s"
                         % (tuple(boxes.shape), tuple(classes.shape),
                            tuple(alive.shape), alive.dtype))
    boxes, classes = _widen(boxes, classes)
    boxes, classes = boxes.contiguous(), classes.contiguous()
    alive = alive.contiguous()
    batch, n = alive.shape
    out = torch.empty_like(alive)
    if batch == 0 or n == 0:
        return out
    trip = max(0, min(int(trip), n))
    _check_limits(batch, n)
    scratch = torch.empty(scratch_shape(batch, n, trip), dtype=torch.int64,
                          device=boxes.device)
    fn = _kernel()
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(boxes.data_ptr(), classes.data_ptr(), alive.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), batch, n, trip,
                 float(threshold), int(bool(force_suppress)),
                 _DTYPE_CODE[boxes.dtype], stream)
    if err != 0:
        raise MXNetError("nms: kernel launch failed with cudaError_t %d at "
                         "(%d, %d) %s" % (err, batch, n, boxes.dtype))
    profiler.bump(COUNTER, 2 if trip else 1)
    return out
