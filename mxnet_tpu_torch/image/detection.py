"""Detection augmenters and ``ImageDetIter``.

Counterpart of ``mxnet_tpu/image/detection.py`` (the ``Det*Aug`` classes
at :29-206, ``CreateDetAugmenter``:208, ``ImageDetIter``:246).  Labels are
(N, 5+) rows ``[class, x0, y0, x1, y1, ...]``, corners normalised to
[0, 1]; class < 0 marks a padding row.  Every augmenter maps (image,
label) to (image, label) on the host, drawing from Python's ``random`` in
the JAX package's order; ``ImageDetIter`` gives host batches whose label
pads to the batch's largest object count with -1 rows, decoding JPEG on
the context current where it was built (nvJPEG on a card, libjpeg on
``cpu()``).
"""
from __future__ import annotations

import random as _rng

import numpy as np

from .. import io as _io
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    ImageIter, _to_np, _wrap, imdecode, imresize)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter(object):
    """Base joint (image, label) augmenter ."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return [type(self).__name__.lower(), self._kwargs]

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only augmenter into the detection pipeline; the
    label passes through unchanged."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("DetBorrowAug requires an image Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src)[0], label


class DetRandomSelectAug(DetAugmenter):
    """Apply one randomly chosen member augmenter (or skip entirely with
    probability 1 - skip_prob... matching the reference's selection
    semantics: each call picks one of aug_list)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or _rng.random() < self.skip_prob:
            return src, label
        return _rng.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and x-coordinates together (ref DetHorizontalFlipAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _rng.random() >= self.p:
            return src, label
        img = _wrap(_to_np(src)[:, ::-1])
        flipped = label.copy()
        valid = flipped[:, 0] >= 0
        x0 = flipped[valid, 1].copy()
        flipped[valid, 1] = 1.0 - flipped[valid, 3]
        flipped[valid, 3] = 1.0 - x0
        return img, flipped


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping enough object overlap (ref DetRandomCropAug).

    Tries ``max_attempts`` crops with area in [min_object_covered-scaled
    bounds]; keeps boxes whose center survives, re-normalised to the crop;
    falls back to the untouched input."""

    def __init__(self, min_object_covered=0.3, min_eject_coverage=0.3,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.3, 1.0),
                 max_attempts=20):
        super().__init__(min_object_covered=min_object_covered,
                         area_range=area_range)
        self.min_object_covered = min_object_covered
        self.min_eject_coverage = min_eject_coverage
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts

    def _try_crop(self, label):
        frac = _rng.uniform(*self.area_range)
        aspect = _rng.uniform(*self.aspect_ratio_range)
        cw = min(np.sqrt(frac * aspect), 1.0)
        ch = min(np.sqrt(frac / aspect), 1.0)
        cx0 = _rng.uniform(0, 1.0 - cw)
        cy0 = _rng.uniform(0, 1.0 - ch)
        crop = (cx0, cy0, cx0 + cw, cy0 + ch)

        valid = label[:, 0] >= 0
        if not valid.any():
            return crop, label
        boxes = label[valid, 1:5]
        ix0 = np.maximum(boxes[:, 0], crop[0])
        iy0 = np.maximum(boxes[:, 1], crop[1])
        ix1 = np.minimum(boxes[:, 2], crop[2])
        iy1 = np.minimum(boxes[:, 3], crop[3])
        inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        coverage = np.where(area > 0, inter / np.maximum(area, 1e-12), 0)
        if coverage.max() < self.min_object_covered:
            return None, None

        keep = coverage >= self.min_eject_coverage
        out = np.full_like(label, -1.0)
        n_keep = int(keep.sum())
        if n_keep == 0:
            return None, None
        kept = boxes[keep]
        # re-normalise into crop coordinates
        new = np.empty_like(kept)
        new[:, 0] = (np.maximum(kept[:, 0], crop[0]) - crop[0]) / cw
        new[:, 1] = (np.maximum(kept[:, 1], crop[1]) - crop[1]) / ch
        new[:, 2] = (np.minimum(kept[:, 2], crop[2]) - crop[0]) / cw
        new[:, 3] = (np.minimum(kept[:, 3], crop[3]) - crop[1]) / ch
        out[:n_keep, 0] = label[valid, 0][keep]
        out[:n_keep, 1:5] = np.clip(new, 0.0, 1.0)
        return crop, out

    def __call__(self, src, label):
        arr = _to_np(src)
        h, w = arr.shape[:2]
        for _ in range(self.max_attempts):
            crop, new_label = self._try_crop(label)
            if crop is None:
                continue
            x0, y0 = int(crop[0] * w), int(crop[1] * h)
            x1, y1 = max(int(crop[2] * w), x0 + 1), max(int(crop[3] * h),
                                                        y0 + 1)
            return _wrap(arr[y0:y1, x0:x1]), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Pad the image into a larger canvas, shrinking boxes accordingly
    (ref DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=20,
                 pad_val=(127, 127, 127)):
        super().__init__(area_range=area_range)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = np.asarray(pad_val, np.float32)

    def __call__(self, src, label):
        arr = _to_np(src)
        h, w = arr.shape[:2]
        frac = _rng.uniform(*self.area_range)
        if frac <= 1.0:
            return src, label
        scale = np.sqrt(frac)
        new_h, new_w = int(h * scale), int(w * scale)
        oy = _rng.randint(0, new_h - h)
        ox = _rng.randint(0, new_w - w)
        canvas = np.empty((new_h, new_w, arr.shape[2]), arr.dtype)
        canvas[:] = self.pad_val[:arr.shape[2]].astype(arr.dtype)
        canvas[oy:oy + h, ox:ox + w] = arr
        out = label.copy()
        valid = out[:, 0] >= 0
        out[valid, 1] = (out[valid, 1] * w + ox) / new_w
        out[valid, 3] = (out[valid, 3] * w + ox) / new_w
        out[valid, 2] = (out[valid, 2] * h + oy) / new_h
        out[valid, 4] = (out[valid, 4] * h + oy) / new_h
        return _wrap(canvas), out


class _DetResize(DetAugmenter):
    """Force-resize to the network input; normalised boxes are invariant."""

    def __init__(self, width, height, interp=2):
        super().__init__(width=width, height=height)
        self.width, self.height, self.interp = width, height, interp

    def __call__(self, src, label):
        return imresize(src, self.width, self.height, self.interp), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None, brightness=0,
                       contrast=0, saturation=0, pca_noise=0, inter_method=2,
                       min_object_covered=0.3, aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.3, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmentation list (ref CreateDetAugmenter)."""
    pipeline = []
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered=min_object_covered,
                                min_eject_coverage=min_eject_coverage,
                                aspect_ratio_range=aspect_ratio_range,
                                area_range=(area_range[0],
                                            min(area_range[1], 1.0)),
                                max_attempts=max_attempts)
        pipeline.append(DetRandomSelectAug([crop], 1.0 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range=aspect_ratio_range,
                              area_range=(max(area_range[0], 1.0),
                                          area_range[1]),
                              max_attempts=max_attempts, pad_val=pad_val)
        pipeline.append(DetRandomSelectAug([pad], 1.0 - rand_pad))
    if rand_mirror:
        pipeline.append(DetHorizontalFlipAug(0.5))
    pipeline.append(_DetResize(data_shape[2], data_shape[1], inter_method))
    pipeline.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        pipeline.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        pipeline.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return pipeline


class ImageDetIter(ImageIter):
    """Detection iterator: (image, (obj, 5) label) batches
    (ref detection.py:ImageDetIter). Labels pad to the batch's max object
    count with -1 rows."""

    def __init__(self, batch_size, data_shape, label_width=-1,
                 aug_list=None, label_name="label", **kwargs):
        super().__init__(batch_size, data_shape, label_width=1,
                         aug_list=aug_list if aug_list is not None else [],
                         label_name=label_name, **kwargs)
        if aug_list is None:
            self.auglist = CreateDetAugmenter(data_shape)
        self._label_width = label_width
        self.provide_label = None       # set per batch (object count varies)
        self._label_name = label_name

    def _normalise_label(self, raw):
        """Raw header label → (obj, 5) [cls, x0, y0, x1, y1]."""
        arr = np.asarray(raw, np.float32).ravel()
        if arr.size % 5:
            arr = arr[arr.size % 5:]
        return arr.reshape(-1, 5)

    def next(self):
        c, h, w = self.data_shape
        data_buf = np.zeros((self.batch_size, h, w, c), np.float32)
        labels = []
        filled = 0
        try:
            while filled < self.batch_size:
                raw_label, blob = self.next_sample()
                img = imdecode(blob, ctx=self._ctx)
                label = self._normalise_label(raw_label)
                for aug in self.auglist:
                    img, label = aug(img, label)
                data_buf[filled] = _to_np(img).reshape(h, w, c)
                labels.append(label)
                filled += 1
        except StopIteration:
            if filled == 0:
                raise
        width = self._label_width if self._label_width > 0 else \
            max(max((l.shape[0] for l in labels), default=1), 1)
        label_buf = np.full((self.batch_size, width, 5), -1.0, np.float32)
        for i, l in enumerate(labels):
            label_buf[i, :min(width, l.shape[0])] = l[:width]
        batch = _wrap(data_buf.transpose(0, 3, 1, 2))
        return _io.DataBatch(
            [batch], [_wrap(label_buf)], pad=self.batch_size - filled,
            provide_data=[_io.DataDesc("data", batch.shape)],
            provide_label=[_io.DataDesc(self._label_name, label_buf.shape)])
