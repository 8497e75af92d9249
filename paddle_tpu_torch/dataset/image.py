"""Image preprocessing utilities (reference python/paddle/dataset/image.py).

The reference wraps cv2; this build is numpy-first (own bilinear resize,
crops, flips, CHW transpose) with PIL used only to decode encoded image
files/bytes — and gated, so the array-transform surface works without it.
Arrays are HWC uint8/float the way the reference's cv2 path produced them.
"""

from __future__ import annotations

import io
import pickle
import tarfile

import numpy as np

__all__ = [
    "batch_images_from_tar", "load_image_bytes", "load_image",
    "resize_short", "to_chw", "center_crop", "random_crop",
    "left_right_flip", "simple_transform", "load_and_transform",
]


def _require_pil():
    try:
        from PIL import Image
        return Image
    except ImportError as e:  # pragma: no cover - PIL is in the image
        raise ImportError(
            "decoding image files needs Pillow; the numpy transforms "
            "(resize_short/center_crop/...) work without it") from e


def load_image_bytes(bytes_, is_color=True):
    """Decode an encoded image from bytes → HWC uint8 (or HW if gray)."""
    Image = _require_pil()
    img = Image.open(io.BytesIO(bytes_))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(file, is_color=True):
    """Decode an image file → HWC uint8 (or HW if gray)."""
    with open(file, "rb") as f:
        return load_image_bytes(f.read(), is_color=is_color)


def _bilinear_resize(im, out_h, out_w):
    """Bilinear resample of HWC (or HW) arrays, align_corners=False
    (pixel-center sampling — what cv2.resize INTER_LINEAR computes)."""
    im2d = im[:, :, None] if im.ndim == 2 else im
    h, w, c = im2d.shape
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    grid = im2d.astype(np.float32)
    top = grid[y0][:, x0] * (1 - wx) + grid[y0][:, x1] * wx
    bot = grid[y1][:, x0] * (1 - wx) + grid[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(im.dtype, np.integer):
        out = np.clip(np.rint(out), np.iinfo(im.dtype).min,
                      np.iinfo(im.dtype).max).astype(im.dtype)
    else:
        out = out.astype(im.dtype)
    return out[:, :, 0] if im.ndim == 2 else out


def resize_short(im, size):
    """Scale so the shorter edge equals `size`, keeping aspect ratio."""
    h, w = im.shape[:2]
    if h < w:
        out_h, out_w = size, max(1, round(w * size / h))
    else:
        out_h, out_w = max(1, round(h * size / w)), size
    return _bilinear_resize(im, out_h, out_w)


def to_chw(im, order=(2, 0, 1)):
    """HWC → CHW (or any axis permutation)."""
    return im.transpose(order)


def _crop(im, size, start_h, start_w):
    return im[start_h:start_h + size, start_w:start_w + size]


def _check_crop_fits(im, size, fname):
    h, w = im.shape[:2]
    if size > min(h, w):
        raise ValueError(
            f"{fname}: crop size {size} exceeds image size {h}x{w}; "
            "resize to at least the crop size first")


def center_crop(im, size, is_color=True):
    _check_crop_fits(im, size, "center_crop")
    h, w = im.shape[:2]
    return _crop(im, size, (h - size) // 2, (w - size) // 2)


def random_crop(im, size, is_color=True):
    _check_crop_fits(im, size, "random_crop")
    h, w = im.shape[:2]
    start_h = np.random.randint(0, h - size + 1)
    start_w = np.random.randint(0, w - size + 1)
    return _crop(im, size, start_h, start_w)


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """The standard train/eval pipeline: resize short edge → crop (random
    + coin-flip mirror when training, center otherwise) → CHW float32 →
    subtract mean (scalar, per-channel, or full elementwise array)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color=is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, dtype=np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]  # per-channel
        im -= mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color=is_color),
                            resize_size, crop_size, is_train,
                            is_color=is_color, mean=mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Decode every image in a tar, pickle (data, label) batches next to
    it, and write a meta file listing the batch paths — the reference's
    pre-processing cache for big image corpora.  Returns the meta path."""
    import os

    out_path = os.path.join(os.path.dirname(data_file) or ".", dataset_name)
    os.makedirs(out_path, exist_ok=True)
    data, labels, file_id, batch_names = [], [], 0, []
    with tarfile.open(data_file) as tf:
        for member in tf.getmembers():
            if not member.isfile() or member.name not in img2label:
                continue
            data.append(tf.extractfile(member).read())
            labels.append(img2label[member.name])
            if len(data) == num_per_batch:
                batch_name = "%s/batch-%05d" % (out_path, file_id)
                with open(batch_name, "wb") as f:
                    pickle.dump({"data": data, "label": labels}, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
                batch_names.append(batch_name)
                data, labels, file_id = [], [], file_id + 1
    if data:
        batch_name = "%s/batch-%05d" % (out_path, file_id)
        with open(batch_name, "wb") as f:
            pickle.dump({"data": data, "label": labels}, f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        batch_names.append(batch_name)
    meta = "%s/%s_meta" % (out_path, dataset_name)
    with open(meta, "w") as f:
        f.write("\n".join(batch_names))
    return meta
