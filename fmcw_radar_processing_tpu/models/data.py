"""Classifier data pipeline: dataset split, image loading, augmentation.

Reproduces the semantics of the reference notebook
(Main_FYP_DCNN_training.ipynb):

  * cells 14/16 — `split_dataset`: 70/15/15 stratified split per class via
    two seeded `train_test_split` calls (random_state=42);
  * cell 17 — Keras `ImageDataGenerator`: train = rescale 1/255 + rotation
    ±20° + width/height shift ±0.2 + shear 0.2 + zoom ±0.2 + horizontal
    flip; val/test = rescale only; images 224×224, binary labels.

The augmentation here is a single batched affine warp in JAX (one fused
gather per image on device) rather than per-image PIL ops on the host.
"""

from __future__ import annotations

import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

IMAGE_SIZE = (224, 224)


def split_dataset(
    items: Sequence, seed: int = 42,
    fractions: tuple[float, float, float] = (0.7, 0.15, 0.15),
):
    """Deterministic 70/15/15 split of one class's item list (cell 14)."""
    items = list(items)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(items))
    n = len(items)
    n_train = int(round(fractions[0] * n))
    n_val = int(round(fractions[1] * n))
    train = [items[i] for i in order[:n_train]]
    val = [items[i] for i in order[n_train : n_train + n_val]]
    test = [items[i] for i in order[n_train + n_val :]]
    return train, val, test


IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg")


def merge_class_folders(
    sources: Sequence[str],
) -> list[tuple[str, str]]:
    """Merge several source folders of one class into one logical list with
    collision-free renames (notebook cell 12's combined-folders variant,
    which merges ``<class>`` and ``<class>_2`` trees via uuid4-renamed
    copies). Renames here are deterministic — ``<folderidx>_<filename>`` —
    so splits are reproducible. Only image files are merged (the notebook
    filters to .png/.jpg/.jpeg). Returns (source_path, merged_name) pairs;
    nothing is copied — callers place files directly where they belong."""
    merged: list[tuple[str, str]] = []
    for fi, src in enumerate(sources):
        for fname in sorted(os.listdir(src)):
            spath = os.path.join(src, fname)
            if not os.path.isfile(spath):
                continue
            if not fname.lower().endswith(IMAGE_EXTENSIONS):
                continue
            merged.append((spath, f"{fi}_{fname}"))
    return merged


def split_dataset_combined_folders(
    class_sources: dict[str, Sequence[str]],
    out_root: str,
    seed: int = 42,
    fractions: tuple[float, float, float] = (0.7, 0.15, 0.15),
) -> dict[str, dict[str, list[str]]]:
    """Cell 12/14 combined: merge each class's source folders, then build a
    ``out_root/{train,val,test}/<class>/`` tree with a per-class seeded
    70/15/15 split. Each image is copied exactly once, straight to its
    split directory. Any pre-existing train/val/test tree under ``out_root``
    is removed first (the notebook rmtree-s the split dir before rebuilding)
    so re-runs with a different seed or source set cannot leave stale files
    that would leak between train and test. Returns {split: {class: [paths]}}.
    """
    import shutil

    for split in ("train", "val", "test"):
        shutil.rmtree(os.path.join(out_root, split), ignore_errors=True)
    result: dict[str, dict[str, list[str]]] = {
        s: {} for s in ("train", "val", "test")
    }
    for cname, sources in sorted(class_sources.items()):
        merged = merge_class_folders(sources)
        train, val, test = split_dataset(merged, seed=seed, fractions=fractions)
        for split, files in (("train", train), ("val", val), ("test", test)):
            sdir = os.path.join(out_root, split, cname)
            os.makedirs(sdir, exist_ok=True)
            placed = []
            for src, merged_name in files:
                dst = os.path.join(sdir, merged_name)
                shutil.copyfile(src, dst)
                placed.append(dst)
            result[split][cname] = placed
    return result


def load_image(path: str, size=IMAGE_SIZE) -> np.ndarray:
    """Load + resize one RGB image to float32 [0, 1] (rescale=1/255)."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB").resize(size[::-1], Image.BILINEAR)
        return np.asarray(im, np.float32) / 255.0


def load_image_folder(
    root: str, classes: Sequence[str] | None = None, size=IMAGE_SIZE,
):
    """Load a flow_from_directory-style tree: root/<class>/*.png.

    Returns (images [N, H, W, 3] float32 in [0,1], labels [N] float32,
    class_names). Binary class indices follow sorted class-name order
    (Keras convention).
    """
    classes = sorted(classes or [
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    ])
    images, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
                images.append(load_image(os.path.join(cdir, fname), size))
                labels.append(float(ci))
    if not images:
        raise ValueError(f"no images under {root}")
    return np.stack(images), np.asarray(labels, np.float32), classes


def _affine_grid(h: int, w: int, mat: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Source sampling coordinates for a 2×3 affine matrix about the center."""
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32),
                          jnp.arange(w, dtype=jnp.float32), indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y = yy - cy
    x = xx - cx
    src_y = mat[0, 0] * y + mat[0, 1] * x + mat[0, 2] + cy
    src_x = mat[1, 0] * y + mat[1, 1] * x + mat[1, 2] + cx
    return src_y, src_x


def _warp_one(img: jax.Array, mat: jax.Array) -> jax.Array:
    """Bilinear warp of one HWC image by a 2×3 affine matrix ('nearest'
    fill, Keras ImageDataGenerator's default fill_mode)."""
    h, w, _ = img.shape
    src_y, src_x = _affine_grid(h, w, mat)
    src_y = jnp.clip(src_y, 0.0, h - 1.0)
    src_x = jnp.clip(src_x, 0.0, w - 1.0)
    y0 = jnp.floor(src_y).astype(jnp.int32)
    x0 = jnp.floor(src_x).astype(jnp.int32)
    y1 = jnp.minimum(y0 + 1, h - 1)
    x1 = jnp.minimum(x0 + 1, w - 1)
    fy = (src_y - y0)[..., None]
    fx = (src_x - x0)[..., None]
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def augment_batch(
    key: jax.Array,
    images: jax.Array,
    *,
    rotation_deg: float = 20.0,
    shift: float = 0.2,
    shear: float = 0.2,
    zoom: float = 0.2,
    horizontal_flip: bool = True,
) -> jax.Array:
    """Keras-ImageDataGenerator-style random affine augmentation (cell 17),
    batched: one random affine per image, applied as a fused bilinear warp.

    images: [N, H, W, C] float32. Jit-compatible (static shapes).
    """
    n, h, w, _ = images.shape
    k_rot, k_sy, k_sx, k_shear, k_zy, k_zx, k_flip = jax.random.split(key, 7)
    theta = jnp.deg2rad(
        jax.random.uniform(k_rot, (n,), minval=-rotation_deg, maxval=rotation_deg)
    )
    ty = jax.random.uniform(k_sy, (n,), minval=-shift, maxval=shift) * h
    tx = jax.random.uniform(k_sx, (n,), minval=-shift, maxval=shift) * w
    shear_r = jax.random.uniform(k_shear, (n,), minval=-shear, maxval=shear)
    zy = jax.random.uniform(k_zy, (n,), minval=1 - zoom, maxval=1 + zoom)
    zx = jax.random.uniform(k_zx, (n,), minval=1 - zoom, maxval=1 + zoom)
    flip = (
        jax.random.bernoulli(k_flip, 0.5, (n,)).astype(jnp.float32) * -2.0 + 1.0
        if horizontal_flip
        else jnp.ones((n,))
    )

    cos, sin = jnp.cos(theta), jnp.sin(theta)
    # Inverse-map affine (output → source), composing rotation, shear, zoom,
    # flip, and shift the way Keras' apply_affine_transform does.
    m00 = cos / zy
    m01 = sin / zy
    m10 = (-sin + shear_r * cos) / zx * flip
    m11 = (cos + shear_r * sin) / zx * flip
    mats = jnp.stack(
        [
            jnp.stack([m00, m01, ty], axis=-1),
            jnp.stack([m10, m11, tx * flip], axis=-1),
        ],
        axis=-2,
    )  # [N, 2, 3]
    return jax.vmap(_warp_one)(images, mats)
