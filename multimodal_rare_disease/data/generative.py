"""Learned class-conditional generative backend (conv VAE).

The reference's synthetic images come from an external StyleGAN3 pickle
(`src/synthetic_image_generator.py:44-139`, PDIDB — unshipped,
network-dependent). The hermetic default backend in `data/synthetic.py`
is procedural; this module provides an honest LEARNED alternative: a
small class-conditional convolutional VAE trained on the shipped 50-image
corpus, slotted behind the same `SyntheticImageGenerator` API.

Compiled: jitted train step (bf16-friendly shapes, NHWC convs), whole
tiny corpus resident on device, cosine-decayed Adam. A VAE trained on 5
images/class produces blurry class-prototypical faces — that is the
honest capability at this data scale, not a StyleGAN replacement.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from multimodal_rare_disease import nn

from multimodal_rare_disease.config import PREFIX_TO_SYNDROME, SYNDROME_NAMES

_SYNDROME_TO_PREFIX = {v: k for k, v in PREFIX_TO_SYNDROME.items()}

TRAIN_SIZE = 64  # VAE training/generation resolution (upsampled on save)


class ConvVAE(nn.Module):
    """Class-conditional conv VAE for [64, 64, 3] images in [0, 1]."""

    latent_dim: int = 64
    num_classes: int = 10
    width: int = 32

    def setup(self):
        w = self.width
        self.enc = [nn.Conv(w, (4, 4), strides=(2, 2), name="enc0"),      # 32
                    nn.Conv(w * 2, (4, 4), strides=(2, 2), name="enc1"),  # 16
                    nn.Conv(w * 4, (4, 4), strides=(2, 2), name="enc2"),  # 8
                    nn.Conv(w * 8, (4, 4), strides=(2, 2), name="enc3")]  # 4
        self.enc_out = nn.Dense(2 * self.latent_dim, name="enc_out")
        self.cls_embed = nn.Embed(self.num_classes, self.latent_dim,
                                  name="cls_embed")
        self.dec_in = nn.Dense(4 * 4 * self.width * 8, name="dec_in")
        self.dec = [nn.ConvTranspose(w * 4, (4, 4), strides=(2, 2), name="dec0"),
                    nn.ConvTranspose(w * 2, (4, 4), strides=(2, 2), name="dec1"),
                    nn.ConvTranspose(w, (4, 4), strides=(2, 2), name="dec2"),
                    nn.ConvTranspose(3, (4, 4), strides=(2, 2), name="dec3")]

    def encode(self, x, labels):
        h = x
        for conv in self.enc:
            h = nn.relu(conv(h))
        h = h.reshape(h.shape[0], -1)
        mu_logvar = self.enc_out(h)
        mu, logvar = jnp.split(mu_logvar, 2, axis=-1)
        return mu, jnp.clip(logvar, -8.0, 8.0)

    def decode(self, z, labels):
        zc = z + self.cls_embed(labels)
        h = self.dec_in(zc).reshape(-1, 4, 4, self.width * 8)
        for i, deconv in enumerate(self.dec):
            h = deconv(h)
            if i < len(self.dec) - 1:
                h = nn.relu(h)
        return nn.sigmoid(h)

    def __call__(self, x, labels, key):
        mu, logvar = self.encode(x, labels)
        eps = jax.random.normal(key, mu.shape)
        z = mu + jnp.exp(0.5 * logvar) * eps
        recon = self.decode(z, labels)
        return recon, mu, logvar


def train_vae(
    images_uint8: np.ndarray,   # [N, S, S, 3]
    labels: np.ndarray,         # [N]
    num_epochs: int = 400,
    latent_dim: int = 64,
    kl_weight: float = 1e-3,
    lr: float = 2e-3,
    seed: int = 0,
):
    """Train the VAE on a (tiny) corpus → (model, params). The whole
    corpus is one device-resident batch; one jitted step per epoch."""
    import optax

    n_classes = int(labels.max()) + 1 if len(labels) else 1
    model = ConvVAE(latent_dim=latent_dim, num_classes=max(n_classes, 10))

    x = jnp.asarray(images_uint8, jnp.float32) / 255.0
    if x.shape[1] != TRAIN_SIZE:
        # bilinear resize via jax.image (host-side one-time prep)
        x = jax.image.resize(
            x, (x.shape[0], TRAIN_SIZE, TRAIN_SIZE, 3), "bilinear")
    y = jnp.asarray(labels, jnp.int32)

    key = jax.random.key(seed)
    params = model.init(key, x[:1], y[:1], key)["params"]
    tx = optax.adam(optax.cosine_decay_schedule(lr, num_epochs))
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, key):
        def loss_fn(p):
            recon, mu, logvar = model.apply({"params": p}, x, y, key)
            rec = jnp.mean(jnp.sum((recon - x) ** 2, axis=(1, 2, 3)))
            kl = jnp.mean(-0.5 * jnp.sum(
                1 + logvar - mu ** 2 - jnp.exp(logvar), axis=-1))
            return rec + kl_weight * kl, (rec, kl)

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    for e in range(num_epochs):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
    return model, jax.device_get(params), float(loss)


class VAEImageGenerator:
    """`SyntheticImageGenerator`-compatible learned backend.

    generate(class_idx, sample_idx) → uint8 [image_size, image_size, 3];
    truncation_psi scales the latent prior (StyleGAN truncation analogue).
    """

    def __init__(self, model: ConvVAE, params, image_size: int = 256,
                 seed: int = 42, truncation_psi: float = 0.7):
        self.model = model
        self.params = params
        self.image_size = image_size
        self.seed = seed
        self.truncation_psi = truncation_psi
        self._decode = jax.jit(
            lambda z, y: model.apply({"params": params}, z, y,
                                     method=ConvVAE.decode))

    @classmethod
    def train_on_corpus(cls, image_dir: Optional[str] = None,
                        image_size: int = 256, seed: int = 42,
                        num_epochs: int = 400, **kw) -> "VAEImageGenerator":
        from multimodal_rare_disease.config import (
            find_image_dir,
            get_config,
        )
        from multimodal_rare_disease.data.images import (
            load_corpus_arrays,
            scan_image_corpus,
        )

        d = image_dir or find_image_dir(get_config())
        if d is None:
            raise FileNotFoundError("no image corpus for VAE training")
        samples = list(scan_image_corpus(d))
        imgs, labels = load_corpus_arrays(samples, TRAIN_SIZE)
        model, params, _ = train_vae(imgs, labels, num_epochs=num_epochs,
                                     seed=seed, **kw)
        return cls(model, params, image_size=image_size, seed=seed)

    def generate(self, class_idx: int, sample_idx: int = 0) -> np.ndarray:
        rng = np.random.default_rng(
            self.seed * 1_000_003 + class_idx * 1009 + sample_idx)
        z = jnp.asarray(
            rng.normal(0, self.truncation_psi,
                       (1, self.model.latent_dim)), jnp.float32)
        y = jnp.asarray([class_idx], jnp.int32)
        img = np.asarray(self._decode(z, y))[0]  # [64, 64, 3] in [0,1]
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if self.image_size != u8.shape[0]:
            from PIL import Image

            u8 = np.asarray(Image.fromarray(u8).resize(
                (self.image_size, self.image_size), Image.BILINEAR))
        return u8

    def generate_for_syndrome(self, syndrome: str, num: int
                              ) -> List[np.ndarray]:
        idx = SYNDROME_NAMES.index(syndrome)
        return [self.generate(idx, i) for i in range(num)]

    def generate_dataset(
        self,
        outdir: str | Path,
        num_per_class: int = 5,
        syndromes: Optional[Sequence[str]] = None,
        flat: bool = True,
    ) -> Dict[str, List[str]]:
        from PIL import Image

        outdir = Path(outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        written: Dict[str, List[str]] = {}
        for name in (syndromes or SYNDROME_NAMES):
            code = _SYNDROME_TO_PREFIX[name]
            cls = SYNDROME_NAMES.index(name)
            paths = []
            target = outdir if flat else outdir / f"SYN_{code}"
            target.mkdir(parents=True, exist_ok=True)
            for i in range(num_per_class):
                arr = self.generate(cls, i)
                p = target / f"SYN_{code}_{i + 1:03d}.png"
                Image.fromarray(arr).save(p)
                paths.append(str(p))
            written[name] = paths
        return written
