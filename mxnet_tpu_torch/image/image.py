"""Host-side image decode and augmentation.

Counterpart of ``mxnet_tpu/image/image.py`` (``imdecode``:54,
``imresize``:73, the crops at :81-146, ``color_normalize``:148, the
augmenters at :164-362, ``CreateAugmenter``:364, the record and list
sources at :410-478, ``ImageIter``:479).  Every augmenter takes and
returns HWC images (``cpu()`` NDArrays or numpy); random choices draw from
Python's ``random`` module (``LightingAug`` from numpy's) in the JAX
package's order, so one ``random.seed`` draws the same crops and jitters
in both.  ``imdecode`` decodes JPEG on the context's decoder (nvJPEG on
a card, libjpeg on ``cpu()``: ``recordio.decode_image``) and other
formats with PIL where it is installed; it returns a ``cpu()`` array,
as the JAX package's does.  ``ImageIter`` fixes the current context
where it is built, so its decodes run there whichever thread calls
``next``.  Resizing follows
cv2's interpolation codes (0 nearest, 1 bilinear, 2 bicubic, 3 area,
cv2's half-pixel geometry), computed in float on the host as separable
weight matrices (:func:`resize_weights`) and, for uint8 images, rounded
half to even and saturated as cv2 does.  Batches are host NDArrays.
"""
from __future__ import annotations

import math
import os
import random as _rng

import numpy as np

from .. import io as _io
from .. import ndarray as nd
from .. import recordio
from ..base import MXNetError
from ..context import cpu, current_context

__all__ = ["imdecode", "scale_down", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "imresize", "resize_weights",
           "CreateAugmenter", "Augmenter",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
           "CenterCropAug", "RandomOrderAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "HorizontalFlipAug", "CastAug", "ImageIter"]

# ITU-R BT.601 luma weights, used by contrast/saturation jitter.
_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _to_np(img):
    """An NDArray or array-like as numpy (HWC)."""
    return img.asnumpy() if isinstance(img, nd.NDArray) else np.asarray(img)


def _wrap(arr, dtype=None):
    """numpy -> host NDArray, keeping the dtype unless told otherwise."""
    a = np.ascontiguousarray(arr)
    return nd.array(a, ctx=cpu(), dtype=dtype or a.dtype)


def imdecode(buf, flag=1, to_rgb=True, out=None, ctx=None):
    """Decode image bytes into an HWC uint8 NDArray on ``cpu()``: RGB order
    (BGR with ``to_rgb=False``, cv2's own), one channel with ``flag=0``.
    JPEG decodes on ``ctx`` (default: the current context): nvJPEG on a
    card, libjpeg on ``cpu()``."""
    raw = recordio.decode_image(buf, flag, ctx)
    if not to_rgb and raw.shape[2] == 3:
        raw = raw[:, :, ::-1]
    return _wrap(raw, dtype=np.uint8)


def _cubic(t, a=-0.75):
    t = np.abs(t)
    return np.where(t <= 1, ((a + 2) * t - (a + 3)) * t * t + 1,
                    np.where(t < 2, ((t - 5) * t + 8) * t * a - 4 * a, 0.0))


def resize_weights(src, dst, interp, area_linear=False):
    """The (dst, src) float64 matrix that resizes one axis of length
    ``src`` to ``dst`` with cv2's interpolation ``interp``: 0 nearest, the
    source pixel floor(i * src / dst); 1 bilinear and 2 bicubic (a =
    -0.75) at half-pixel centres, the edge pixels replicated; 3 area, each
    output the mean of the source span it covers, or, with
    ``area_linear`` (cv2's INTER_AREA where either axis grows), cv2's
    area-to-linear weights."""
    scale = src / dst
    w = np.zeros((dst, src))
    rows = np.arange(dst)
    if interp == 0:
        w[rows, np.minimum(np.floor(rows * scale).astype(int), src - 1)] = 1
        return w
    if interp == 3 and area_linear:
        x0 = np.floor(rows * scale).astype(int)
        frac = (rows + 1) - (x0 + 1) / scale
        frac = np.where(frac <= 0, 0.0, frac - np.floor(frac))
        taps = ((0, 1.0 - frac), (1, frac))
    elif interp in (1, 2):
        f = (rows + 0.5) * scale - 0.5
        x0 = np.floor(f).astype(int)
        frac = f - x0
        taps = ((0, 1.0 - frac), (1, frac)) if interp == 1 else \
            tuple((k, _cubic(frac - k)) for k in (-1, 0, 1, 2))
    elif interp == 3:
        for i in rows:
            lo, hi = i * scale, (i + 1) * scale
            for j in range(int(math.floor(lo)),
                           min(int(math.ceil(hi)), src)):
                w[i, j] = (min(hi, j + 1) - max(lo, j)) / scale
        return w
    else:
        raise MXNetError("imresize: interpolation %r is not supported (0 "
                         "nearest, 1 bilinear, 2 bicubic, 3 area)"
                         % (interp,))
    for k, wt in taps:
        np.add.at(w, (rows, np.clip(x0 + k, 0, src - 1)), wt)
    return w


def imresize(src, w, h, interp=1):
    """Resize an HWC image to exactly (w, h); a uint8 image stays uint8
    (rounded half to even, saturated), others come back float32."""
    arr = _to_np(src)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[:, :, None]
    sh, sw, c = arr.shape
    grows = h > sh or w > sw
    out = resize_weights(sh, h, interp, grows) @ arr.reshape(
        sh, sw * c).astype(np.float64)
    out = np.matmul(resize_weights(sw, w, interp, grows),
                    out.reshape(h, sw, c))
    if arr.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(np.float32)
    return _wrap(out)


def scale_down(src_size, size):
    """Shrink the requested crop (w, h) to fit inside src (w, h), keeping
    its aspect."""
    sw, sh = src_size
    w, h = size
    if h > sh:
        w, h = w * sh / h, sh
    if w > sw:
        w, h = sw, h * sw / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so that the shorter edge equals *size*."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if w < h:
        target = (size, size * h // w)      # (w, h)
    else:
        target = (size * w // h, size)
    return imresize(arr, target[0], target[1], interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """Crop the [y0:y0+h, x0:x0+w] window, optionally resizing to *size*."""
    window = _to_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and size != (w, h):
        return imresize(window, size[0], size[1], interp)
    return _wrap(window)


def random_crop(src, size, interp=2):
    """Uniformly-placed crop of (scaled-down) *size*; returns (img, box)."""
    h, w = src.shape[:2]
    cw, ch = scale_down((w, h), size)
    x0 = _rng.randint(0, w - cw)
    y0 = _rng.randint(0, h - ch)
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def center_crop(src, size, interp=2):
    """Centered crop of (scaled-down) *size*; returns (img, box)."""
    h, w = src.shape[:2]
    cw, ch = scale_down((w, h), size)
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return fixed_crop(src, x0, y0, cw, ch, size, interp), (x0, y0, cw, ch)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """Inception-style crop: random area fraction and aspect ratio, with a
    center-crop fallback after 10 failed attempts."""
    h, w = src.shape[:2]
    for _ in range(10):
        frac = _rng.uniform(min_area, 1.0)
        aspect = _rng.uniform(*ratio)
        cw = int(round(np.sqrt(h * w * frac * aspect)))
        ch = int(round(np.sqrt(h * w * frac / aspect)))
        if _rng.random() < 0.5:
            cw, ch = ch, cw
        if cw <= w and ch <= h:
            x0 = _rng.randint(0, w - cw)
            y0 = _rng.randint(0, h - ch)
            return fixed_crop(src, x0, y0, cw, ch, size, interp), \
                (x0, y0, cw, ch)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """(src - mean) / std with broadcasting; either part optional."""
    out = src
    if mean is not None:
        out = out - mean
    if std is not None:
        out = out / std
    return out


# The augmenters: each implements _apply(img) -> img; __call__ returns a
# list, as the reference's protocol does (RandomOrderAug may fan out).

class Augmenter(object):
    """Base augmenter; records ctor kwargs for ``dumps()`` introspection."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return [type(self).__name__.lower(), self._kwargs]

    def _apply(self, src):
        raise NotImplementedError

    def __call__(self, src):
        return [self._apply(src)]


class ResizeAug(Augmenter):
    """Shorter-edge resize."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def _apply(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Exact (w, h) resize, ignoring aspect."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def _apply(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def _apply(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)
        self.size, self.min_area = size, min_area
        self.ratio, self.interp = ratio, interp

    def _apply(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def _apply(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomOrderAug(Augmenter):
    """Apply child augmenters in a freshly shuffled order each call."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        order = list(self.ts)
        _rng.shuffle(order)
        imgs = [src]
        for aug in order:
            imgs = [out for img in imgs for out in aug(img)]
        return imgs


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def _apply(self, src):
        gain = 1.0 + _rng.uniform(-self.brightness, self.brightness)
        return _wrap(_to_np(src).astype(np.float32) * gain)


class ContrastJitterAug(Augmenter):
    """Blend toward the image's mean luma."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def _apply(self, src):
        gain = 1.0 + _rng.uniform(-self.contrast, self.contrast)
        arr = _to_np(src).astype(np.float32)
        mean_luma = float((arr * _LUMA).sum()) * 3.0 / arr.size
        return _wrap(arr * gain + mean_luma * (1.0 - gain))


class SaturationJitterAug(Augmenter):
    """Blend toward the per-pixel luma (grayscale)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def _apply(self, src):
        gain = 1.0 + _rng.uniform(-self.saturation, self.saturation)
        arr = _to_np(src).astype(np.float32)
        gray = (arr * _LUMA).sum(axis=2, keepdims=True)
        return _wrap(arr * gain + gray * (1.0 - gain))


class HueJitterAug(Augmenter):
    """Rotate hue in YIQ space by a random angle."""

    # RGB→YIQ and back (NTSC).
    _RGB2YIQ = np.array([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]], dtype=np.float32)
    _YIQ2RGB = np.array([[1.0, 0.956, 0.621],
                         [1.0, -0.272, -0.647],
                         [1.0, -1.107, 1.705]], dtype=np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def _apply(self, src):
        theta = _rng.uniform(-self.hue, self.hue) * np.pi
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[1.0, 0.0, 0.0],
                        [0.0, c, -s],
                        [0.0, s, c]], dtype=np.float32)
        full = (self._YIQ2RGB @ rot @ self._RGB2YIQ).T
        return _wrap(_to_np(src).astype(np.float32) @ full)


class ColorJitterAug(RandomOrderAug):
    """Brightness/contrast/saturation jitter in random order."""

    def __init__(self, brightness, contrast, saturation):
        members = [cls(v) for cls, v in
                   ((BrightnessJitterAug, brightness),
                    (ContrastJitterAug, contrast),
                    (SaturationJitterAug, saturation)) if v > 0]
        super().__init__(members)


class LightingAug(Augmenter):
    """AlexNet PCA lighting noise along RGB eigenvectors."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, dtype=np.float32)
        self.eigvec = np.asarray(eigvec, dtype=np.float32)

    def _apply(self, src):
        alpha = np.random.normal(0.0, self.alphastd, size=(3,))
        shift = (self.eigvec * alpha) @ self.eigval
        return _wrap(_to_np(src).astype(np.float32) + shift.astype(np.float32))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.std = None if std is None else np.asarray(std, np.float32)

    def _apply(self, src):
        arr = _to_np(src).astype(np.float32)
        return _wrap(color_normalize(arr, self.mean, self.std))


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def _apply(self, src):
        if _rng.random() >= self.p:
            return src
        return _wrap(_to_np(src)[:, ::-1])


class CastAug(Augmenter):
    def _apply(self, src):
        return _wrap(_to_np(src).astype(np.float32))


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """Assemble the standard train/val augmentation list
    (MXNet's ``CreateAugmenter``); data_shape is CHW."""
    crop = (data_shape[2], data_shape[1])       # (w, h)
    pipeline = []
    if resize > 0:
        pipeline.append(ResizeAug(resize, inter_method))
    if rand_resize:
        if not rand_crop:
            raise ValueError("rand_resize requires rand_crop=True")
        pipeline.append(
            RandomSizedCropAug(crop, 0.3, (3.0 / 4.0, 4.0 / 3.0),
                               inter_method))
    elif rand_crop:
        pipeline.append(RandomCropAug(crop, inter_method))
    else:
        pipeline.append(CenterCropAug(crop, inter_method))
    if rand_mirror:
        pipeline.append(HorizontalFlipAug(0.5))
    pipeline.append(CastAug())
    if brightness or contrast or saturation:
        pipeline.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        # ImageNet RGB covariance eigendecomposition (AlexNet paper values).
        pipeline.append(LightingAug(
            pca_noise,
            [55.46, 4.794, 1.148],
            [[-0.5675, 0.7192, 0.4009],
             [-0.5808, -0.0045, -0.8140],
             [-0.5836, -0.6948, 0.4203]]))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        pipeline.append(ColorNormalizeAug(mean, std))
    return pipeline


# ImageIter's sample sources: each gives (label, raw bytes) and resets.

class _RecordSource:
    """Sequential or index-ordered reads from a .rec (+ optional .idx)."""

    def __init__(self, path_imgrec, path_imgidx=None):
        if path_imgidx:
            self.rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self.keys = list(self.rec.keys)
        else:
            self.rec = recordio.MXRecordIO(path_imgrec, "r")
            self.keys = None

    def reset(self):
        self.rec.reset()

    def read_sequential(self):
        blob = self.rec.read()
        if blob is None:
            raise StopIteration
        header, img = recordio.unpack(blob)
        return header.label, img

    def read_key(self, key):
        header, img = recordio.unpack(self.rec.read_idx(key))
        return header.label, img


class _ListSource:
    """Samples named by key → (label, filename-or-bytes) mapping."""

    def __init__(self, table, keys, path_root):
        self.table = table
        self.keys = keys
        self.root = path_root or ""

    def reset(self):
        pass

    def read_key(self, key):
        label, fname = self.table[key]
        with open(os.path.join(self.root, fname), "rb") as fh:
            return label, fh.read()


def _parse_lst_file(path):
    """Parse a .lst file: ``key \\t label... \\t relative-path`` per line."""
    table, keys = {}, []
    with open(path) as fh:
        for line in fh:
            cells = line.strip().split("\t")
            if len(cells) < 3:
                continue
            key = int(cells[0])
            table[key] = (np.array([float(v) for v in cells[1:-1]]), cells[-1])
            keys.append(key)
    return table, keys


def _parse_inline_list(entries):
    """Normalise a python list of (label, fname) pairs into a keyed table."""
    table, keys = {}, []
    for pos, (label, fname) in enumerate(entries, start=1):
        key = str(pos)
        label = np.asarray(label) if isinstance(label, (list, np.ndarray)) \
            else np.array([label])
        table[key] = (label, fname)
        keys.append(key)
    return table, keys


class ImageIter(_io.DataIter):
    """Decode-and-augment iterator over a .rec file (with its .idx for
    shuffling), a .lst file or a list of (label, file) pairs, giving NCHW
    float32 host batches; JPEG decodes on the context current where the
    iterator is built."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0,
                 num_parts=1, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__()
        if not (path_imgrec or path_imglist or isinstance(imglist, list)):
            raise ValueError("need path_imgrec, path_imglist, or imglist")
        self._ctx = current_context()   # the decoder's, fixed here

        self._record = _RecordSource(path_imgrec, path_imgidx) \
            if path_imgrec else None
        self._list = None
        if path_imglist:
            table, keys = _parse_lst_file(path_imglist)
            self._list = _ListSource(table, keys, path_root)
            self._order = keys
        elif isinstance(imglist, list):
            table, keys = _parse_inline_list(imglist)
            self._list = _ListSource(table, keys, path_root)
            self._order = keys
        else:
            self._order = self._record.keys   # None for non-indexed .rec

        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        if num_parts > 1 and self._order is not None:
            if part_index >= num_parts:
                raise ValueError("part_index out of range")
            span = len(self._order) // num_parts
            self._order = self._order[part_index * span:
                                      (part_index + 1) * span]
        self.auglist = aug_list if aug_list is not None \
            else CreateAugmenter(data_shape, **kwargs)

        label_shape = (batch_size, label_width) if label_width > 1 \
            else (batch_size,)
        self.provide_data = [_io.DataDesc(data_name,
                                          (batch_size,) + self.data_shape)]
        self.provide_label = [_io.DataDesc(label_name, label_shape)]
        self._pos = 0
        self.reset()

    def reset(self):
        if self.shuffle and self._order is not None:
            _rng.shuffle(self._order)
        if self._record is not None:
            self._record.reset()
        self._pos = 0

    def next_sample(self):
        """Return one (label, raw-bytes) sample, honouring the shuffle order."""
        if self._order is None:
            return self._record.read_sequential()
        if self._pos >= len(self._order):
            raise StopIteration
        key = self._order[self._pos]
        self._pos += 1
        if self._record is not None:
            label, img = self._record.read_key(key)
            if self._list is not None:      # .lst labels override header
                label = self._list.table[key][0]
            return label, img
        return self._list.read_key(key)

    def next(self):
        c, h, w = self.data_shape
        data_buf = np.zeros((self.batch_size, h, w, c), dtype=np.float32)
        label_shape = (self.batch_size, self.label_width) \
            if self.label_width > 1 else (self.batch_size,)
        label_buf = np.zeros(label_shape, dtype=np.float32)

        filled = 0
        try:
            while filled < self.batch_size:
                label, blob = self.next_sample()
                img = imdecode(blob, ctx=self._ctx)
                for aug in self.auglist:
                    img = aug(img)[0]
                data_buf[filled] = _to_np(img).reshape(h, w, c)
                label_buf[filled] = label
                filled += 1
        except StopIteration:
            if filled == 0:
                raise
        batch = _wrap(data_buf.transpose(0, 3, 1, 2))
        return _io.DataBatch([batch], [_wrap(label_buf)],
                             pad=self.batch_size - filled)
