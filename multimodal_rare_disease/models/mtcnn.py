"""MTCNN face detection — P/R/O-nets + cascade pipeline.

Re-implementation of the capability the reference activates
by installing facenet-pytorch (`src/image_dataset_loader.py:27-77`):
a three-stage cascade of tiny convnets (P-Net fully-convolutional
proposal net over an image pyramid, R-Net 24x24 refinement, O-Net
48x48 output net) with per-stage thresholding, bounding-box
regression, and NMS.

Design notes:
- The nets are NHWC modules; each stage is one jitted batched
  forward (candidate crops are padded to power-of-two buckets so every
  corpus shares a handful of compiled shapes).
- The cascade orchestration (pyramid, NMS, box bookkeeping) is
  host-side numpy — face detection is data-prep that runs once per
  image at corpus load, not a train-step hot path.
- `convert_mtcnn` maps facenet-pytorch state_dicts onto the pytree so
  offline-supplied real weights slot in (OIHW->HWIO for convs, and the
  (N,W,H,C) flatten-order quirk of facenet's dense layers is unpermuted
  for our (N,H,W,C) flatten).

Weights are NOT shipped (no egress); without converted weights the
detector falls back to `heuristic_face_box` — a background-subtraction
blob detector that works well on the portrait-style synthetic corpus —
so `data.use_face_detection=True` is functional out of the box.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

from multimodal_rare_disease import nn
import jax
import jax.numpy as jnp
import numpy as np

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


class PReLU(nn.Module):
    """Per-channel PReLU (torch nn.PReLU(C) semantics)."""

    @nn.compact
    def __call__(self, x):
        a = self.param("alpha", nn.initializers.constant(0.25),
                       (x.shape[-1],), jnp.float32)
        return jnp.maximum(x, 0.0) + a * jnp.minimum(x, 0.0)


def _ceil_pool(x, window: int, stride: int):
    """Max pool with torch ceil_mode=True: right/bottom pad to cover."""
    h, w = x.shape[1], x.shape[2]
    ph = max(0, (-(h - window) % stride) if h > window else window - h)
    pw = max(0, (-(w - window) % stride) if w > window else window - w)
    return nn.max_pool(x, (window, window), (stride, stride),
                       [(0, ph), (0, pw)])


class PNet(nn.Module):
    """Proposal net: fully convolutional, 12x12 receptive field, stride 2."""

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(10, (3, 3), padding="VALID", name="conv1")(x)
        x = PReLU(name="prelu1")(x)
        x = _ceil_pool(x, 2, 2)
        x = nn.Conv(16, (3, 3), padding="VALID", name="conv2")(x)
        x = PReLU(name="prelu2")(x)
        x = nn.Conv(32, (3, 3), padding="VALID", name="conv3")(x)
        x = PReLU(name="prelu3")(x)
        prob = jax.nn.softmax(
            nn.Conv(2, (1, 1), name="conv4_1")(x), axis=-1)
        reg = nn.Conv(4, (1, 1), name="conv4_2")(x)
        return prob, reg


class RNet(nn.Module):
    """Refinement net over 24x24 crops."""

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(28, (3, 3), padding="VALID", name="conv1")(x)
        x = PReLU(name="prelu1")(x)
        x = _ceil_pool(x, 3, 2)
        x = nn.Conv(48, (3, 3), padding="VALID", name="conv2")(x)
        x = PReLU(name="prelu2")(x)
        x = _ceil_pool(x, 3, 2)
        x = nn.Conv(64, (2, 2), padding="VALID", name="conv3")(x)
        x = PReLU(name="prelu3")(x)
        x = x.reshape(x.shape[0], -1)          # (N,H,W,C) flatten
        x = nn.Dense(128, name="dense4")(x)
        x = PReLU(name="prelu4")(x)
        prob = jax.nn.softmax(nn.Dense(2, name="dense5_1")(x), axis=-1)
        reg = nn.Dense(4, name="dense5_2")(x)
        return prob, reg


class ONet(nn.Module):
    """Output net over 48x48 crops (adds landmark regression)."""

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(32, (3, 3), padding="VALID", name="conv1")(x)
        x = PReLU(name="prelu1")(x)
        x = _ceil_pool(x, 3, 2)
        x = nn.Conv(64, (3, 3), padding="VALID", name="conv2")(x)
        x = PReLU(name="prelu2")(x)
        x = _ceil_pool(x, 3, 2)
        x = nn.Conv(64, (3, 3), padding="VALID", name="conv3")(x)
        x = PReLU(name="prelu3")(x)
        x = _ceil_pool(x, 2, 2)
        x = nn.Conv(128, (2, 2), padding="VALID", name="conv4")(x)
        x = PReLU(name="prelu4")(x)
        x = x.reshape(x.shape[0], -1)
        x = nn.Dense(256, name="dense5")(x)
        x = PReLU(name="prelu5")(x)
        prob = jax.nn.softmax(nn.Dense(2, name="dense6_1")(x), axis=-1)
        reg = nn.Dense(4, name="dense6_2")(x)
        lmk = nn.Dense(10, name="dense6_3")(x)
        return prob, reg, lmk


def init_mtcnn_params(key: jax.Array) -> Dict:
    """Random-init parameter pytree for the three nets."""
    kp, kr, ko = jax.random.split(key, 3)
    return {
        "pnet": PNet().init(kp, jnp.zeros((1, 12, 12, 3)))["params"],
        "rnet": RNet().init(kr, jnp.zeros((1, 24, 24, 3)))["params"],
        "onet": ONet().init(ko, jnp.zeros((1, 48, 48, 3)))["params"],
    }


# ---------------------------------------------------------------------------
# facenet-pytorch weight conversion
# ---------------------------------------------------------------------------


def _conv(sd, name):
    w = np.asarray(sd[f"{name}.weight"], np.float32)      # OIHW
    return {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0)),  # HWIO
            "bias": jnp.asarray(np.asarray(sd[f"{name}.bias"], np.float32))}


def _prelu(sd, name):
    return {"alpha": jnp.asarray(np.asarray(sd[f"{name}.weight"],
                                            np.float32).reshape(-1))}


def _dense(sd, name, spatial: Optional[Tuple[int, int, int]] = None):
    """Linear layer; `spatial=(H,W,C)` unpermutes facenet's
    (N,W,H,C)-order flatten into our (N,H,W,C)-order flatten."""
    w = np.asarray(sd[f"{name}.weight"], np.float32)      # [out, in]
    if spatial is not None:
        h, wd, c = spatial
        w = (w.reshape(-1, wd, h, c).transpose(0, 2, 1, 3)
             .reshape(w.shape[0], -1))
    return {"kernel": jnp.asarray(w.T),                   # [in, out]
            "bias": jnp.asarray(np.asarray(sd[f"{name}.bias"], np.float32))}


def convert_mtcnn(pnet_sd: Dict, rnet_sd: Dict, onet_sd: Dict) -> Dict:
    """Map facenet-pytorch PNet/RNet/ONet state_dicts to our pytree.

    Accepts any mapping of torch-layout arrays (e.g. the result of
    `torch.load(..., map_location='cpu')` or an npz with the same keys).
    """
    pnet = {n: _conv(pnet_sd, n) for n in ("conv1", "conv2", "conv3",
                                           "conv4_1", "conv4_2")}
    pnet.update({n: _prelu(pnet_sd, n) for n in ("prelu1", "prelu2",
                                                 "prelu3")})
    rnet = {n: _conv(rnet_sd, n) for n in ("conv1", "conv2", "conv3")}
    rnet.update({n: _prelu(rnet_sd, n)
                 for n in ("prelu1", "prelu2", "prelu3", "prelu4")})
    rnet["dense4"] = _dense(rnet_sd, "dense4", spatial=(3, 3, 64))
    rnet["dense5_1"] = _dense(rnet_sd, "dense5_1")
    rnet["dense5_2"] = _dense(rnet_sd, "dense5_2")
    onet = {n: _conv(onet_sd, n)
            for n in ("conv1", "conv2", "conv3", "conv4")}
    onet.update({n: _prelu(onet_sd, n)
                 for n in ("prelu1", "prelu2", "prelu3", "prelu4",
                           "prelu5")})
    onet["dense5"] = _dense(onet_sd, "dense5", spatial=(3, 3, 128))
    onet["dense6_1"] = _dense(onet_sd, "dense6_1")
    onet["dense6_2"] = _dense(onet_sd, "dense6_2")
    onet["dense6_3"] = _dense(onet_sd, "dense6_3")
    return {"pnet": pnet, "rnet": rnet, "onet": onet}


def save_mtcnn_npz(params: Dict, path: str) -> None:
    flat = {"/".join(k.key for k in keys): np.asarray(v)
            for keys, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(path, **flat)


def load_mtcnn_npz(path: str) -> Dict:
    data = np.load(path)
    params: Dict = {}
    for key in data.files:
        node = params
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(data[key])
    return params


# ---------------------------------------------------------------------------
# cascade pipeline (host orchestration, jitted net applies)
# ---------------------------------------------------------------------------

_pnet_apply = jax.jit(lambda p, x: PNet().apply({"params": p}, x))
_rnet_apply = jax.jit(lambda p, x: RNet().apply({"params": p}, x))
_onet_apply = jax.jit(lambda p, x: ONet().apply({"params": p}, x))


def _nms(boxes: np.ndarray, scores: np.ndarray, thresh: float,
         mode: str = "union") -> np.ndarray:
    """Greedy NMS; mode 'min' divides overlap by the smaller area."""
    if len(boxes) == 0:
        return np.empty((0,), np.int64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(0.0, xx2 - xx1 + 1)
                 * np.maximum(0.0, yy2 - yy1 + 1))
        if mode == "min":
            ovr = inter / np.minimum(area[i], area[order[1:]])
        else:
            ovr = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][ovr <= thresh]
    return np.asarray(keep, np.int64)


def _rerec(boxes: np.ndarray) -> np.ndarray:
    """Square-up boxes around their centers (facenet `rerec`)."""
    out = boxes.copy()
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    side = np.maximum(w, h)
    out[:, 0] = boxes[:, 0] + w * 0.5 - side * 0.5
    out[:, 1] = boxes[:, 1] + h * 0.5 - side * 0.5
    out[:, 2] = out[:, 0] + side
    out[:, 3] = out[:, 1] + side
    return out


def _apply_reg(boxes: np.ndarray, reg: np.ndarray) -> np.ndarray:
    w = (boxes[:, 2] - boxes[:, 0] + 1)[:, None]
    h = (boxes[:, 3] - boxes[:, 1] + 1)[:, None]
    return boxes[:, :4] + reg * np.concatenate([w, h, w, h], axis=1)


def _crop_resize(img: np.ndarray, boxes: np.ndarray,
                 size: int) -> np.ndarray:
    """Crop (clamped, zero-padded) boxes and resize to [size,size]."""
    H, W = img.shape[:2]
    out = np.zeros((len(boxes), size, size, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(boxes[:, :4].astype(np.int64)):
        cx1, cy1 = max(0, x1), max(0, y1)
        cx2, cy2 = min(W, x2 + 1), min(H, y2 + 1)
        if cx2 <= cx1 or cy2 <= cy1:
            continue
        patch = np.zeros((y2 - y1 + 1, x2 - x1 + 1, 3), np.float32)
        patch[cy1 - y1:cy2 - y1, cx1 - x1:cx2 - x1] = img[cy1:cy2, cx1:cx2]
        out[i] = jax.image.resize(patch, (size, size, 3), "linear")
    return out


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def detect_faces(
    params: Dict,
    img_u8: np.ndarray,
    min_face_size: int = 20,
    thresholds: Sequence[float] = (0.6, 0.7, 0.7),
    factor: float = 0.709,
    max_candidates: int = 256,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full MTCNN cascade over one RGB uint8 image.

    Returns (boxes [N,4] float (x1,y1,x2,y2), probs [N]) — possibly
    empty. Behavioral port of facenet-pytorch `detect_face`
    (ref dependency of `src/image_dataset_loader.py:27-77`).
    """
    img = (img_u8.astype(np.float32) - 127.5) * (1.0 / 128.0)
    H, W = img.shape[:2]

    # -- stage 1: P-Net over the pyramid
    m = 12.0 / min_face_size
    min_dim = min(H, W) * m
    scales = []
    while min_dim >= 12:
        scales.append(m)
        m *= factor
        min_dim *= factor
    all_boxes = []
    for scale in scales:
        hs, ws = int(np.ceil(H * scale)), int(np.ceil(W * scale))
        scaled = np.asarray(jax.image.resize(img, (hs, ws, 3), "linear"))
        prob, reg = _pnet_apply(params["pnet"], scaled[None])
        prob = np.asarray(prob)[0, ..., 1]
        reg = np.asarray(reg)[0]
        ys, xs = np.where(prob > thresholds[0])
        if ys.size == 0:
            continue
        score = prob[ys, xs]
        r = reg[ys, xs]
        stride, cell = 2.0, 12.0
        x1 = np.floor((stride * xs + 1) / scale)
        y1 = np.floor((stride * ys + 1) / scale)
        x2 = np.floor((stride * xs + cell) / scale)
        y2 = np.floor((stride * ys + cell) / scale)
        boxes = np.stack([x1, y1, x2, y2], axis=1)
        keep = _nms(boxes, score, 0.5)
        all_boxes.append(np.concatenate(
            [boxes[keep], score[keep, None], r[keep]], axis=1))
    if not all_boxes:
        return np.empty((0, 4)), np.empty((0,))
    total = np.concatenate(all_boxes, axis=0)
    keep = _nms(total[:, :4], total[:, 4], 0.7)
    total = total[keep][:max_candidates]
    boxes = _rerec(_apply_reg(total[:, :4], total[:, 5:9]))

    # -- stage 2: R-Net
    n = len(boxes)
    crops = _crop_resize(img, np.floor(boxes), 24)
    pad = _bucket(n)
    batch = np.zeros((pad, 24, 24, 3), np.float32)
    batch[:n] = crops
    prob, reg = _rnet_apply(params["rnet"], batch)
    prob = np.asarray(prob)[:n, 1]
    reg = np.asarray(reg)[:n]
    sel = prob > thresholds[1]
    if not sel.any():
        return np.empty((0, 4)), np.empty((0,))
    boxes, prob, reg = boxes[sel], prob[sel], reg[sel]
    keep = _nms(boxes, prob, 0.7)
    boxes = _rerec(_apply_reg(boxes[keep], reg[keep]))
    prob = prob[keep]

    # -- stage 3: O-Net
    n = len(boxes)
    crops = _crop_resize(img, np.floor(boxes), 48)
    pad = _bucket(n)
    batch = np.zeros((pad, 48, 48, 3), np.float32)
    batch[:n] = crops
    oprob, oreg, _ = _onet_apply(params["onet"], batch)
    oprob = np.asarray(oprob)[:n, 1]
    oreg = np.asarray(oreg)[:n]
    sel = oprob > thresholds[2]
    if not sel.any():
        return np.empty((0, 4)), np.empty((0,))
    boxes = _apply_reg(boxes[sel], oreg[sel])
    prob = oprob[sel]
    keep = _nms(boxes, prob, 0.7, mode="min")
    return boxes[keep], prob[keep]


# ---------------------------------------------------------------------------
# detector callables for the data-layer hook
# ---------------------------------------------------------------------------


def heuristic_face_box(arr: np.ndarray
                       ) -> Optional[Tuple[int, int, int, int]]:
    """Weights-free fallback detector: largest foreground blob by
    color distance from the border (background) median. Reliable on
    portrait-style imagery (one subject, roughly uniform background)
    like the synthetic StyleGAN3 corpus; returns None when no
    coherent foreground region exists."""
    from scipy import ndimage

    f = arr.astype(np.float32) / 255.0
    border = np.concatenate(
        [f[0], f[-1], f[:, 0], f[:, -1]], axis=0)
    bg = np.median(border.reshape(-1, 3), axis=0)
    dist = np.sqrt(((f - bg) ** 2).sum(axis=-1))
    mask = dist > max(0.18, float(dist.mean()) * 1.1)
    if not mask.any():
        return None
    lab, n = ndimage.label(mask)
    sizes = ndimage.sum(mask, lab, index=range(1, n + 1))
    k = int(np.argmax(sizes)) + 1
    if sizes[k - 1] < 0.02 * mask.size:
        return None
    ys, xs = np.nonzero(lab == k)
    top, left = int(ys.min()), int(xs.min())
    return (top, left, int(ys.max()) - top + 1, int(xs.max()) - left + 1)


class MTCNNDetector:
    """Hook-compatible detector: callable(uint8 [H,W,3]) ->
    (top, left, height, width) or None, picking the highest-probability
    face like facenet's `select_largest=False` default path."""

    def __init__(self, params: Dict, min_face_size: int = 20,
                 thresholds: Sequence[float] = (0.6, 0.7, 0.7),
                 factor: float = 0.709):
        self.params = params
        self.min_face_size = min_face_size
        self.thresholds = tuple(thresholds)
        self.factor = factor

    def __call__(self, arr: np.ndarray
                 ) -> Optional[Tuple[int, int, int, int]]:
        boxes, probs = detect_faces(
            self.params, arr, self.min_face_size, self.thresholds,
            self.factor)
        if len(boxes) == 0:
            return None
        x1, y1, x2, y2 = boxes[int(np.argmax(probs))]
        x1, y1 = max(0, int(round(x1))), max(0, int(round(y1)))
        x2 = min(arr.shape[1] - 1, int(round(x2)))
        y2 = min(arr.shape[0] - 1, int(round(y2)))
        if x2 <= x1 or y2 <= y1:
            return None
        return (y1, x1, y2 - y1 + 1, x2 - x1 + 1)


def build_face_detector(kind: str = "auto", weights_path: str = ""):
    """Factory for the data-layer hook.

    kind: 'mtcnn' (requires weights_path npz of converted params),
    'heuristic' (weights-free blob detector), or 'auto' (mtcnn when
    weights exist, else heuristic).
    """
    import os

    if kind in ("auto", "mtcnn") and weights_path \
            and os.path.exists(weights_path):
        return MTCNNDetector(load_mtcnn_npz(weights_path))
    if kind == "mtcnn":
        raise FileNotFoundError(
            f"MTCNN weights not found at {weights_path!r}; convert "
            "facenet-pytorch state_dicts with convert_mtcnn + "
            "save_mtcnn_npz, or use kind='heuristic'")
    return heuristic_face_box
