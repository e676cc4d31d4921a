"""Unpaired metrics: Inception Score and Fréchet distances (torch port of
``impersonator_tpu/metrics/unpaired.py``).

The statistics (:func:`frechet_distance`, :func:`gaussian_stats`,
:func:`inception_score`, :func:`matched_cosine`) are host NumPy in
float64, copied from the JAX package: the matrix square root is an
offline eval-time step, not device work. :class:`UnpairedMetricRunner`
takes its distances with :func:`frechet_distance_of`, the same distance
solved in the span of the two feature sets (a few frames against 2,048
to 12,288 dimensions: (N1 + N2)² eigenproblems instead of D²). The embed
functions run their nets on the frames' device in float32 without TF32
and return device tensors; :class:`UnpairedMetricRunner` gathers their
outputs on the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from impersonator_tpu_torch.utils.precision import full_fp32


def accepts_bboxes(fn: Callable) -> bool:
    """Whether a face extractor takes a second (bboxes) argument, probed
    from its signature once (not by catching TypeError per call, which
    would mix cropped and uncropped features within a run)."""
    import inspect
    try:
        return len(inspect.signature(fn).parameters) >= 2
    except (TypeError, ValueError):
        return False


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians: |mu1 - mu2|² + Tr(S1 + S2 -
    2·sqrt(S1·S2)), in float64.

    Tr sqrt(S1 S2) goes the symmetric way: S1·S2 has the eigenvalues of
    A = S1^(1/2) S2 S1^(1/2), which is symmetric PSD, so two eighs give the
    trace stably even for the rank-deficient covariances FID has (N frames
    << 2048 dimensions)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1 = np.asarray(sigma1, np.float64)
    s2 = np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    offset = np.eye(s1.shape[0]) * eps
    w1, v1 = np.linalg.eigh(s1 + offset)
    s1_half = (v1 * np.sqrt(np.maximum(w1, 0.0))) @ v1.T
    a = s1_half @ (s2 + offset) @ s1_half
    wa = np.linalg.eigvalsh((a + a.T) / 2.0)
    tr_covmean = np.sum(np.sqrt(np.maximum(wa, 0.0)))
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * tr_covmean)


def frechet_distance_of(f1, f2, eps: float = 1e-6) -> float:
    """``frechet_distance`` of the Gaussians of two feature sets (N1, D)
    and (N2, D), computed in the span of their centred features when
    N1 + N2 < D (FID's usual case: a few frames, 2048 to 12,288
    dimensions). There the eigenproblems are (N1 + N2)² instead of D²:
    with a = (f1 - mu1)ᵀ / sqrt(N1 - 1), b likewise, S1 = a aᵀ, S2 = b bᵀ,
    and Q an orthonormal basis of [a b], (S1 + eps)(S2 + eps) acts on
    span Q as (Qᵀ S1 Q + eps)(Qᵀ S2 Q + eps) and as eps² on the rest, so
    Tr sqrt of it is the small problem's plus (D - k)·eps. The D² route
    rounds those D - k eigenvalues (eps² = 1e-12) at the scale of the
    largest one, and its sum of their square roots drifts by up to
    ~1e-3 of the distance; this route does not."""
    f1 = np.asarray(f1, np.float64)
    f2 = np.asarray(f2, np.float64)
    (n1, d), n2 = f1.shape, f2.shape[0]
    if min(n1, n2) < 2 or n1 + n2 >= d:
        return frechet_distance(*gaussian_stats(f1), *gaussian_stats(f2),
                                eps)
    mu1, mu2 = f1.mean(axis=0), f2.mean(axis=0)
    a = (f1 - mu1).T / np.sqrt(n1 - 1)
    b = (f2 - mu2).T / np.sqrt(n2 - 1)
    q, _ = np.linalg.qr(np.concatenate([a, b], axis=1))
    k = q.shape[1]
    qa, qb = q.T @ a, q.T @ b
    w1, v1 = np.linalg.eigh(qa @ qa.T + np.eye(k) * eps)
    p1_half = (v1 * np.sqrt(np.maximum(w1, 0.0))) @ v1.T
    m = p1_half @ (qb @ qb.T + np.eye(k) * eps) @ p1_half
    wm = np.linalg.eigvalsh((m + m.T) / 2.0)
    tr_covmean = np.sum(np.sqrt(np.maximum(wm, 0.0))) + (d - k) * eps
    diff = mu1 - mu2
    return float(diff @ diff + np.sum(a * a) + np.sum(b * b)
                 - 2 * tr_covmean)


def gaussian_stats(features: np.ndarray):
    """(N, D) features -> (mu (D,), sigma (D, D))."""
    f = np.asarray(features, np.float64)
    return f.mean(axis=0), np.cov(f, rowvar=False)


def inception_score(probs: np.ndarray, splits: int = 10) -> float:
    """IS from class probabilities (N, C): exp(E_x KL(p(y|x) || p(y)))."""
    probs = np.asarray(probs, np.float64)
    scores = []
    for part in np.array_split(probs, splits):
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-12) - np.log(py + 1e-12))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores))


def _host(x) -> np.ndarray:
    """A tensor (any device) or array -> a float32 host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def matched_cosine(pred, ref) -> float:
    """Mean row-wise cosine similarity of matched embeddings, behind both
    the paired (face-CS / OS-CS-reid) and the unpaired CS metrics."""
    pred = _host(pred).astype(np.float64)
    ref = _host(ref).astype(np.float64)
    pn = pred / np.maximum(np.linalg.norm(pred, axis=1, keepdims=True), 1e-9)
    rn = ref / np.maximum(np.linalg.norm(ref, axis=1, keepdims=True), 1e-9)
    return float((pn * rn).sum(axis=1).mean())


class UnpairedMetricRunner:
    """Unpaired suite with pluggable extractors and the reference's result
    keys:

    * ``inception_fn(imgs) -> (pool (N, 2048), probs (N, C))``: ``fid``
      (Fréchet on pool) and ``is`` (split KL on probs);
    * ``reid_fn`` (OSNet): ``OS-freid`` and ``OS-CS-reid``; ``pcb_fn``:
      ``PCB-freid`` and ``PCB-CS-reid``;
    * ``face_fn``: ``face-FD`` and ``face-CS``; ``embed_fn`` (any
      embedding): ``fd`` and ``cs``.

    An extractor left None skips its metrics. Images are (N, H, W, 3) in
    [-1, 1]; resizing to a net's input is the extractor's job."""

    def __init__(self, inception_fn: Callable | None = None,
                 reid_fn: Callable | None = None,
                 face_fn: Callable | None = None,
                 embed_fn: Callable | None = None,
                 pcb_fn: Callable | None = None):
        self.inception_fn = inception_fn
        self.reid_fn = reid_fn
        self.pcb_fn = pcb_fn
        self.face_fn = face_fn
        self.embed_fn = embed_fn
        self._acc = {k: {"pred": [], "ref": []}
                     for k in ("inc", "reid", "pcb", "face", "embed")}
        self._probs = []

    def update(self, preds, refs=None, pred_bboxes=None, ref_bboxes=None,
               pred_body_bboxes=None, ref_body_bboxes=None):
        """``pred_bboxes`` / ``ref_bboxes``: (N, 4) fractional head boxes;
        when given, the face extractor embeds head crops (the reference's
        MTCNN-cropped 160² convention). ``pred_body_bboxes`` /
        ``ref_body_bboxes``: (N, 4) fractional person boxes; when given,
        the re-id extractors embed person crops at their patch sizes
        (OSNet 256×128, PCB 384×192)."""
        preds = torch.as_tensor(preds, dtype=torch.float32)
        refs = (torch.as_tensor(refs, dtype=torch.float32,
                                device=preds.device)
                if refs is not None else None)

        def both(key, fn):
            self._acc[key]["pred"].append(_host(fn(preds)))
            if refs is not None:
                self._acc[key]["ref"].append(_host(fn(refs)))

        def boxes_of(imgs, pred_boxes, ref_boxes):
            boxes = pred_boxes if imgs is preds else ref_boxes
            return (None if boxes is None else torch.as_tensor(
                boxes, dtype=torch.float32, device=imgs.device))

        def body_crop(fn, h, w):
            def wrapped(imgs):
                boxes = boxes_of(imgs, pred_body_bboxes, ref_body_bboxes)
                if boxes is None:
                    return fn(imgs)
                from impersonator_tpu_torch.models.losses import (
                    crop_resize_fractional)
                return fn(crop_resize_fractional(imgs, boxes, h, w))
            return wrapped

        if self.inception_fn is not None:
            pool, probs = self.inception_fn(preds)
            self._acc["inc"]["pred"].append(_host(pool))
            self._probs.append(_host(probs))
            if refs is not None:
                pool_r, _ = self.inception_fn(refs)
                self._acc["inc"]["ref"].append(_host(pool_r))
        if self.reid_fn is not None:
            both("reid", body_crop(self.reid_fn, 256, 128))
        if self.pcb_fn is not None:
            both("pcb", body_crop(self.pcb_fn, 384, 192))
        if self.face_fn is not None:
            crops = accepts_bboxes(self.face_fn)

            def face(imgs):
                boxes = boxes_of(imgs, pred_bboxes, ref_bboxes)
                if boxes is not None and crops:
                    return self.face_fn(imgs, boxes)
                return self.face_fn(imgs)
            both("face", face)
        if self.embed_fn is not None:
            both("embed", self.embed_fn)

    @staticmethod
    def _fd(pred, ref):
        return frechet_distance_of(pred, ref)

    def evaluate(self) -> dict:
        out = {}

        def cat(key, which):
            lst = self._acc[key][which]
            return np.concatenate(lst) if lst else None

        if self._probs:
            out["is"] = inception_score(np.concatenate(self._probs))
        for key, fd_name, cs_name in (("inc", "fid", None),
                                      ("reid", "OS-freid", "OS-CS-reid"),
                                      ("pcb", "PCB-freid", "PCB-CS-reid"),
                                      ("face", "face-FD", "face-CS"),
                                      ("embed", "fd", "cs")):
            pred, ref = cat(key, "pred"), cat(key, "ref")
            if pred is None or ref is None or not len(ref):
                continue
            out[fd_name] = self._fd(pred, ref)
            if cs_name and len(pred) == len(ref):
                out[cs_name] = matched_cosine(pred, ref)
        return out


def _nchw(imgs) -> torch.Tensor:
    return torch.as_tensor(imgs, dtype=torch.float32).permute(0, 3, 1, 2)


def vgg_embed_fn(vgg):
    """Default embedding: the deepest feature of ``vgg`` (a net returning
    a list of NCHW features), average-pooled over positions."""

    def embed(imgs):
        with torch.no_grad(), full_fp32():
            return vgg(_nchw(imgs))[-1].mean((2, 3))

    return embed


def inception_embed_fn(model):
    """FID / IS extractor over ``metrics.zoo.InceptionV3``: (N, H, W, 3) in
    [-1, 1] resized to 299² with align_corners=False (the reference's
    preprocess) -> (pool (N, 2048), probs (N, 1000)).

    The reference registers InceptionV3 with output_blocks=[3], so its IS
    softmaxes the pool features (a bug its own README flags); this, as the
    JAX package, softmaxes the logits."""
    from impersonator_tpu_torch.ops.sampler import resize_bilinear_torch

    def fn(imgs):
        x = resize_bilinear_torch(torch.as_tensor(imgs, dtype=torch.float32),
                                  299, 299)
        with torch.no_grad(), full_fp32():
            pool, logits = model(_nchw(x))
        return pool, torch.softmax(logits, dim=-1)

    return fn


def facenet_ir_embed_fn(model):
    """Face-identity embedding from ``metrics.zoo.InceptionResnetV1`` (the
    reference's face-CS / face-FD net): head crops of ``bboxes`` (N, 4
    fractional [x0, x1, y0, y1]) or whole frames, at 160²."""
    from impersonator_tpu_torch.models.losses import crop_resize_fractional
    from impersonator_tpu_torch.ops.sampler import resize_bilinear_torch

    def fn(imgs, bboxes=None):
        imgs = torch.as_tensor(imgs, dtype=torch.float32)
        if bboxes is not None:
            x = crop_resize_fractional(imgs, torch.as_tensor(
                bboxes, dtype=torch.float32, device=imgs.device), 160, 160)
        else:
            x = resize_bilinear_torch(imgs, 160, 160)
        with torch.no_grad(), full_fp32():
            return model(_nchw(x))

    return fn


def senet_face_embed_fn(model):
    """Face-identity embedding from VGGFace2's SENet50
    (``models.facenet.SENet50``; its 2048-d pooled feature) on frames
    resized to 224²."""
    from impersonator_tpu_torch.ops.sampler import resize_bilinear_torch

    def fn(imgs):
        x = resize_bilinear_torch(torch.as_tensor(imgs, dtype=torch.float32),
                                  224, 224)
        with torch.no_grad(), full_fp32():
            return model(_nchw(x))[1]

    return fn


def sphere_face_embed_fn(model):
    """Face-identity embedding from Sphere20a (``models.facenet``; fc5,
    512-d) on frames resized to 112×96."""
    from impersonator_tpu_torch.ops.sampler import resize_bilinear_torch

    def fn(imgs):
        x = resize_bilinear_torch(torch.as_tensor(imgs, dtype=torch.float32),
                                  112, 96)
        with torch.no_grad(), full_fp32():
            return model(_nchw(x))[-1]

    return fn
