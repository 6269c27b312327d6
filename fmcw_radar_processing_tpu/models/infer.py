"""Classifier inference service — "AI classification through API calls".

The reference serves its trained VGG16 model behind an API: spectrogram
PNGs produced by the signal chain are classified (human vs calf vs bees)
and the dashboard consumes the result (reference README.md:20, the
`vgg16_custom_model_calf_human.h5` artifact of Main_FYP_DCNN_training.ipynb
cells 21-23). The reference repo itself contains only the training
notebook; the serving side is re-built here:

  * A self-describing **artifact directory**: orbax params checkpoint +
    `meta.json` (model family, input shape, class names) — the framework's
    equivalent of the notebook's opaque `.h5` file.
  * A **jitted batched forward**. Incoming request batches are padded to
    power-of-two buckets so XLA compiles once per bucket, never per
    request; compute is bfloat16 (models/vgg.py).
  * PNG/JPEG decode + resize on host (PIL), normalization 1/255 matching
    the notebook's test-time `ImageDataGenerator(rescale=1./255)`
    (cell 17) — no augmentation at inference.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from fmcw_radar_processing_tpu.models.data import load_image
from fmcw_radar_processing_tpu.models.vgg import VGG16, SmallCNN

_MODELS = {"vgg16": VGG16, "small": SmallCNN}
META_FILENAME = "meta.json"
PARAMS_DIRNAME = "params"
MAX_BATCH_BUCKET = 64


def export_classifier(
    path: str,
    model_name: str,
    params,
    input_shape: tuple[int, int, int],
    classes: Sequence[str],
) -> str:
    """Write a self-describing inference artifact (params + meta.json)."""
    import orbax.checkpoint as ocp

    if model_name not in _MODELS:
        raise ValueError(f"unknown model {model_name!r}; one of {sorted(_MODELS)}")
    if len(classes) != 2:
        raise ValueError("binary classifier artifact needs exactly 2 classes")
    os.makedirs(path, exist_ok=True)
    with ocp.StandardCheckpointer() as ckpt:
        ckpt.save(os.path.abspath(os.path.join(path, PARAMS_DIRNAME)),
                  params, force=True)
    with open(os.path.join(path, META_FILENAME), "w") as f:
        json.dump({
            "model": model_name,
            "input_shape": list(input_shape),
            "classes": list(classes),
            "normalization": "1/255",
        }, f, indent=2)
    return path


def _bucket(n: int) -> int:
    b = 1
    while b < n and b < MAX_BATCH_BUCKET:
        b *= 2
    return b


class SpectrogramClassifier:
    """Loads an exported artifact and serves batched predictions.

    The forward is traced once per (bucketed) batch size; requests of any
    size are padded up to the nearest power-of-two bucket (≤64) and larger
    batches are processed in bucket-sized chunks, so a long-running service
    never recompiles after warmup.
    """

    def __init__(self, model_name: str, params,
                 input_shape: tuple[int, int, int],
                 classes: Sequence[str]):
        self.model_name = model_name
        self.model = _MODELS[model_name]()
        self.params = params
        self.input_shape = tuple(input_shape)
        self.classes = tuple(classes)

        def forward(params, images):
            logits = self.model.apply({"params": params}, images, train=False)
            return jax.nn.sigmoid(logits)

        self._forward = jax.jit(forward)

    def warmup(self, max_bucket: int = MAX_BATCH_BUCKET) -> None:
        """Trace/compile the forward at every batch bucket ≤ max_bucket.

        A long-running service must never compile during a request: the
        bucketed forward compiles once per power-of-two batch size, and
        without warmup the first coalesced batch of each size pays the
        trace+compile inside a client's latency window. Called at service
        start (serve/http_service.py)."""
        b = 1
        while b <= max_bucket:
            np.asarray(self._forward(
                self.params,
                jnp.zeros((b, *self.input_shape), jnp.float32)))
            b *= 2

    # ------------------------------ loading ------------------------------

    @classmethod
    def load(cls, path: str) -> "SpectrogramClassifier":
        import orbax.checkpoint as ocp

        meta_path = os.path.join(path, META_FILENAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} not found — not a classifier artifact "
                "(export one with `train --export`)"
            )
        with open(meta_path) as f:
            meta = json.load(f)
        model = _MODELS[meta["model"]]()
        input_shape = tuple(meta["input_shape"])
        dummy = jnp.zeros((1, *input_shape), jnp.float32)
        template = model.init(jax.random.PRNGKey(0), dummy, train=False)["params"]
        with ocp.StandardCheckpointer() as ckpt:
            params = ckpt.restore(
                os.path.abspath(os.path.join(path, PARAMS_DIRNAME)), template
            )
        return cls(meta["model"], params, input_shape, meta["classes"])

    # ----------------------------- prediction ----------------------------

    def predict_proba(self, images: np.ndarray) -> np.ndarray:
        """Sigmoid probabilities of class 1 for NHWC float images in [0,1]."""
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[None]
        if images.shape[1:] != self.input_shape:
            raise ValueError(
                f"expected images of shape {self.input_shape}, "
                f"got {images.shape[1:]}"
            )
        n = images.shape[0]
        probs = np.empty(n, np.float32)
        done = 0
        while done < n:
            take = min(n - done, MAX_BATCH_BUCKET)
            b = _bucket(take)
            chunk = images[done:done + take]
            if take < b:  # pad up to the bucket; padded rows are discarded
                chunk = np.concatenate(
                    [chunk, np.zeros((b - take, *self.input_shape), np.float32)]
                )
            out = np.asarray(self._forward(self.params, jnp.asarray(chunk)))
            probs[done:done + take] = out[:take]
            done += take
        return probs

    def classify(self, images: np.ndarray) -> list[dict]:
        """Label + probability per image (threshold 0.5, notebook cells 25/29)."""
        probs = self.predict_proba(images)
        out = []
        for p in probs:
            idx = int(p > 0.5)
            out.append({
                "label": self.classes[idx],
                "class_index": idx,
                "probability": round(float(p if idx else 1.0 - p), 6),
                "score": round(float(p), 6),
            })
        return out

    # --------------------------- image ingestion -------------------------

    def decode_image_bytes(self, data: bytes) -> np.ndarray:
        """PNG/JPEG bytes → normalized HWC float array at the model size."""
        import io

        from PIL import Image

        h, w = self.input_shape[:2]
        with Image.open(io.BytesIO(data)) as im:
            im = im.convert("RGB").resize((w, h), Image.BILINEAR)
            return np.asarray(im, np.float32) / 255.0

    def classify_bytes(self, blobs: Sequence[bytes]) -> list[dict]:
        imgs = np.stack([self.decode_image_bytes(b) for b in blobs])
        return self.classify(imgs)

    def classify_files(self, paths: Sequence[str]) -> list[dict]:
        imgs = np.stack([load_image(p, self.input_shape[:2]) for p in paths])
        results = self.classify(imgs)
        for path, r in zip(paths, results):
            r["file"] = path
        return results
