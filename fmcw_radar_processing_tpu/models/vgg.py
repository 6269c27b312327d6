"""Spectrogram classifiers in Flax.

The reference trains a VGG16 transfer-learning binary classifier on
micro-Doppler spectrogram PNGs (Main_FYP_DCNN_training.ipynb cell 19:
VGG16 ImageNet backbone frozen, head = Flatten → Dense(256, relu) →
Dropout(0.5) → Dense(1, sigmoid); Adam 1e-4, binary cross-entropy).

Re-design decisions:
  * Flax/optax instead of Keras; the head is identical; the final sigmoid
    lives in the loss (`sigmoid_binary_cross_entropy`) for numerical
    stability — logits out.
  * Compute in bfloat16 (tensor-core native), parameters in float32.
    VGG16's conv stacks are large, static-shape convolutions that XLA
    hands to cuDNN.
  * ImageNet weights are an offline artifact (this deployment has no
    egress); `backbone_frozen` reproduces the transfer-learning setup when
    weights are loaded from a local checkpoint, and a from-scratch mode
    plus a compact `SmallCNN` (same API) cover training without them.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
from flax import linen as nn

# Standard VGG16 configuration: (convs per block, channels).
VGG16_BLOCKS: tuple[tuple[int, int], ...] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512),
)


class VGGBackbone(nn.Module):
    blocks: Sequence[tuple[int, int]] = VGG16_BLOCKS
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        for b, (n_convs, ch) in enumerate(self.blocks):
            for c in range(n_convs):
                x = nn.Conv(ch, (3, 3), padding="SAME", dtype=self.dtype,
                            name=f"block{b + 1}_conv{c + 1}")(x)
                x = nn.relu(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        return x


class BinaryHead(nn.Module):
    """Flatten → Dense(256, relu) → Dropout(0.5) → Dense(1) (notebook cell 19)."""

    hidden: int = 256
    dropout: float = 0.5
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, *, train: bool):
        x = x.reshape(x.shape[0], -1)
        x = nn.Dense(self.hidden, dtype=self.dtype, name="fc")(x)
        x = nn.relu(x)
        x = nn.Dropout(self.dropout, deterministic=not train)(x)
        x = nn.Dense(1, dtype=jnp.float32, name="out")(x)
        return x[..., 0]  # logits


class VGG16(nn.Module):
    """VGG16 + binary head. Input NHWC float in [0, 1], 224×224×3.

    Backbone freezing (the notebook's transfer-learning setup) is applied
    through the optimizer — `train.make_optimizer(freeze_backbone=True)`
    masks backbone params to zero updates, the idiomatic optax equivalent
    of Keras `layer.trainable = False`.
    """

    dtype: jnp.dtype = jnp.bfloat16
    # Overridable for tiny test instances; layer NAMES keep the standard
    # block{b}_conv{c} scheme either way, which is what the Keras-h5
    # importer (models/import_keras.py) maps against.
    blocks: Sequence[tuple[int, int]] = VGG16_BLOCKS

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        x = x.astype(self.dtype)
        feats = VGGBackbone(blocks=self.blocks, dtype=self.dtype,
                            name="backbone")(x)
        return BinaryHead(dtype=self.dtype, name="head")(feats, train=train)


class SmallCNN(nn.Module):
    """Compact spectrogram classifier (same API as VGG16).

    4 conv blocks — appropriate when training from scratch on the
    reference-scale dataset (384 images; BASELINE.md) where a 138M-param
    VGG16 without pretrained weights would only overfit.
    """

    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, *, train: bool = False):
        x = x.astype(self.dtype)
        for ch in (32, 64, 128, 128):
            x = nn.Conv(ch, (3, 3), padding="SAME", dtype=self.dtype)(x)
            x = nn.relu(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = jnp.mean(x, axis=(1, 2))
        x = nn.Dense(128, dtype=self.dtype)(x)
        x = nn.relu(x)
        x = nn.Dropout(0.5, deterministic=not train)(x)
        return nn.Dense(1, dtype=jnp.float32)(x)[..., 0]
