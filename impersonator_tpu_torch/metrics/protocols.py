"""Evaluation protocols (the port's copy of
``impersonator_tpu/metrics/protocols.py``, which is framework-free).

JSON-driven eval splits mirroring the his_evaluators protocol layer
(``thirdparty/his_evaluators/protocols/iPER.py:10-400``). The canonical
``iPER_protocol.json`` schema (shipped with the reference at
``thirdparty/his_evaluators/data/iPER_protocol.json``) is::

    {"val": {"001/9/1": {
        "source": [frame names at 8 view angles],
        "view angle": [0, 45, ...],
        "s_n": {"1": ["000.jpg"], "2": [...], ...},   # multi-view sources
        "self_imitation":  {"target": "001/9/1", "range": [b, e]},
        "cross_imitation": {"target": "007/1/2", "range": [b, e]},
        "flag": [b, e]}}}                             # real ref frames for
                                                      # the unpaired suite

A legacy list form (``[{"videoID": ..., "source": {...},
"self_imitation": {"begin","end"}, ...}]``) is also accepted so small
fabricated fixtures stay terse. Frame index resolution (sorted glob per
video directory, end-inclusive ranges) matches iPER.py:66-79.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class EvalUnit:
    """One protocol video, with every path resolved (iPER.py:86-195)."""

    video_id: str
    src_paths: List[str]                  # num_sources source frames
    si_paths: List[str]                   # self-imitation gt frames
    ci_video: Optional[str]               # cross-imitation target video
    ci_paths: List[str] = field(default_factory=list)   # drive frames
    flag_paths: List[str] = field(default_factory=list)  # real refs (unpaired)
    src_smpls: Optional[np.ndarray] = None      # (n_src, 85)
    si_smpls: Optional[np.ndarray] = None       # (n_si, 85)
    ci_smpls: Optional[np.ndarray] = None       # (n_ci, 85)
    flag_smpls: Optional[np.ndarray] = None     # (n_flag, 85)


class Protocol:
    """Iterate per-video :class:`EvalUnit`\\ s from a protocol JSON."""

    def __init__(self, data_dir: str, protocol_file: str,
                 images_folder: str = "images_HD",
                 smpls_folder: str = "smpls"):
        self.data_dir = data_dir
        self.images_folder = images_folder
        self.smpls_folder = smpls_folder
        self._num_sources = 1
        self._load_smpls = False
        self._smpl_cache = {}

        with open(protocol_file) as f:
            raw = json.load(f)
        if isinstance(raw, dict):
            self._items = list(raw.get("val", raw).items())
            self._legacy = False
        else:
            self._items = [(it["videoID"], it) for it in raw]
            self._legacy = True

    def setup(self, num_sources: int = 1, load_smpls: bool = False):
        """iPER.py:81-84: choose the multi-view source count and whether
        to read smpl pkls (pose_shape.pkl per video)."""
        self._num_sources = num_sources
        self._load_smpls = load_smpls

    def __len__(self):
        return len(self._items)

    def frames_dir(self, video_id: str, images_folder: str | None = None):
        return os.path.join(self.data_dir,
                            images_folder or self.images_folder, video_id)

    def frames(self, video_id: str) -> List[str]:
        out = sorted(glob.glob(os.path.join(self.frames_dir(video_id), "*")))
        return out

    def smpls(self, video_id: str) -> Optional[np.ndarray]:
        """(N, 85) thetas from pose_shape.pkl, or None if absent."""
        if video_id not in self._smpl_cache:
            pkl = os.path.join(self.data_dir, self.smpls_folder, video_id,
                               "pose_shape.pkl")
            if not os.path.exists(pkl):
                self._smpl_cache[video_id] = None
            else:
                with open(pkl, "rb") as f:
                    d = pickle.load(f)
                self._smpl_cache[video_id] = np.concatenate(
                    [np.asarray(d["cams"], np.float32),
                     np.asarray(d["pose"], np.float32),
                     np.asarray(d["shape"], np.float32)], axis=1)
        return self._smpl_cache[video_id]

    def _take(self, video_id, begin, end):
        """End-inclusive frame slice (iPER.py take_images_paths)."""
        return self.frames(video_id)[begin:end + 1]

    def __getitem__(self, idx) -> EvalUnit:
        vid, info = self._items[idx]
        frames = self.frames(vid)

        if self._legacy:
            src_sel = info.get("source", {}).get("1", [0])
            src_paths = [frames[int(str(s).split(".")[0])] for s in src_sel]
            b, e = (info["self_imitation"]["begin"],
                    info["self_imitation"]["end"])
            si_paths = frames[b:e]          # legacy fixtures: end-exclusive
            # clip like the slice does — an over-long range must not make
            # own[si_idx] fancy-index past the pkl's rows
            si_idx = list(range(b, min(e, len(frames))))
            cross = info.get("cross_imitation") or {}
            ci_video = cross.get("videoID")
            ci_range = ((cross["begin"], cross["end"]) if ci_video else None)
            flag_range = ci_range
        else:
            s_n = info["s_n"]
            key = str(self._num_sources)
            if key not in s_n:
                key = min(s_n, key=lambda k: abs(int(k) - self._num_sources))
            # "000.jpg" and "frame_00000000.png" both parse
            # (fashionvideo.py:140: split(".")[0].split("_")[-1])
            src_ids = [int(t.split(".")[0].split("_")[-1]) for t in s_n[key]]
            src_paths = [frames[i] for i in src_ids]
            b, e = info["self_imitation"]["range"]
            si_paths = frames[b:e + 1]
            si_idx = list(range(b, min(e + 1, len(frames))))
            ci = info.get("cross_imitation") or {}
            ci_video = ci.get("target")
            ci_range = tuple(ci["range"]) if ci_video else None
            flag_range = tuple(info["flag"]) if info.get("flag") else ci_range

        unit = EvalUnit(
            video_id=vid, src_paths=src_paths, si_paths=si_paths,
            ci_video=ci_video,
            ci_paths=(self._take(ci_video, *ci_range) if ci_video else []),
            flag_paths=(self._take(vid, *flag_range)
                        if (ci_video and flag_range) else []),
        )
        if self._load_smpls:
            own = self.smpls(vid)
            if own is not None:
                if not self._legacy:
                    src_ids = [int(os.path.basename(p).split(".")[0])
                               if os.path.basename(p).split(".")[0].isdigit()
                               else frames.index(p) for p in src_paths]
                else:
                    src_ids = [frames.index(p) for p in src_paths]
                unit.src_smpls = own[src_ids]
                unit.si_smpls = own[si_idx]
                if ci_video and flag_range:
                    unit.flag_smpls = own[flag_range[0]:flag_range[1] + 1]
            if ci_video:
                tgt = self.smpls(ci_video)
                if tgt is not None:
                    unit.ci_smpls = tgt[ci_range[0]:ci_range[1] + 1]
        return unit

    @property
    def videos(self):
        """All eval units (resolved lazily per access)."""
        return [self[i] for i in range(len(self))]


class IPERProtocol(Protocol):
    """iPER evaluation protocol (protocols/iPER.py)."""


@dataclass
class ATUnit:
    """One appearance-transfer pair: swap ``app_vid``'s clothes onto
    ``src_vid``'s identity, drive with ``app_vid``'s motion, and score
    predictions against ``app_vid``'s real frames (the AT evaluator's
    "self-imitation-scored swap": every pair in the real
    iPER_AT_protocol.json couples two outfits of the SAME actor, so the
    composite is reconstructable — evaluators/appearance_transfer.py:
    124-150 scores swap() output paired against motion_infos frames)."""

    src_vid: str
    app_vid: str
    src_paths: List[str]                  # identity source frames
    app_paths: List[str]                  # appearance provider frames
    motion_paths: List[str]               # drive frames == paired gt refs
    src_smpls: Optional[np.ndarray] = None
    app_smpls: Optional[np.ndarray] = None
    motion_smpls: Optional[np.ndarray] = None


class IPERATProtocol(Protocol):
    """Appearance-transfer protocol over the REAL
    ``iPER_AT_protocol.json`` schema (thirdparty/his_evaluators/data/):

        {"video_infos": {vid: {"source", "view angle", "s_n", "flag"}},
         "vid_name_pairs": [[src_vid, app_vid], ...]}

    The reference ships the JSON and the evaluator surface
    (evaluators/appearance_transfer.py:109-167) but no Protocol parser —
    ``iPER_Appearance_Transfer`` is not in protocols/__init__.py's
    VALID_DATASET, so the upstream evaluator is dead code. This is the
    working equivalent: one :class:`ATUnit` per vid_name_pair, source
    frames from the src video's ``s_n`` table, appearance frames from
    the app video's ``s_n`` table, and motion = the app video's ``flag``
    range (end-inclusive), whose real frames double as the paired refs.
    """

    def __init__(self, data_dir: str, protocol_file: str,
                 images_folder: str = "images_HD",
                 smpls_folder: str = "smpls"):
        self.data_dir = data_dir
        self.images_folder = images_folder
        self.smpls_folder = smpls_folder
        self._num_sources = 1
        self._load_smpls = False
        self._smpl_cache = {}

        with open(protocol_file) as f:
            raw = json.load(f)
        self.video_infos = raw["video_infos"]
        self.pairs = [tuple(p) for p in raw["vid_name_pairs"]]

    def __len__(self):
        return len(self.pairs)

    def _source_sel(self, vid: str):
        """Frame names/ids from the vid's s_n table for _num_sources
        (iPER.py:137-138: ids parse from the file stem)."""
        s_n = self.video_infos[vid]["s_n"]
        key = str(self._num_sources)
        if key not in s_n:
            key = min(s_n, key=lambda k: abs(int(k) - self._num_sources))
        return [int(t.split(".")[0].split("_")[-1]) for t in s_n[key]]

    def __getitem__(self, idx) -> ATUnit:
        src_vid, app_vid = self.pairs[idx]
        src_frames = self.frames(src_vid)
        app_frames = self.frames(app_vid)
        src_ids = self._source_sel(src_vid)
        app_ids = self._source_sel(app_vid)
        b, e = self.video_infos[app_vid]["flag"]

        unit = ATUnit(
            src_vid=src_vid, app_vid=app_vid,
            src_paths=[src_frames[i] for i in src_ids],
            app_paths=[app_frames[i] for i in app_ids],
            motion_paths=app_frames[b:e + 1],
        )
        if self._load_smpls:
            src = self.smpls(src_vid)
            app = self.smpls(app_vid)
            if src is not None:
                unit.src_smpls = src[src_ids]
            if app is not None:
                unit.app_smpls = app[app_ids]
                unit.motion_smpls = app[b:e + 1]
        return unit


class ProcessedDirProtocol(Protocol):
    """Shared layout of the non-iPER protocols (fashionvideo.py:76-80,
    206-207; MotionSynthetic.py:77, 206; YoutubeDancer18.py:100, 231):
    frames live at ``{data_dir}/{processed_sub}/{vid}/images/*`` and
    smpls at ``{data_dir}/{processed_sub}/{vid}/pose_shape.pkl``; the
    protocol JSON schema itself is identical to iPER's."""

    PROCESSED_SUB = "processed"
    SHAPE_ONCE = False   # pose_shape.pkl stores shape once, not per frame

    def frames_dir(self, video_id: str, images_folder: str | None = None):
        return os.path.join(self.data_dir, self.PROCESSED_SUB, video_id,
                            "images")

    def smpls(self, video_id: str) -> Optional[np.ndarray]:
        if video_id not in self._smpl_cache:
            pkl = os.path.join(self.data_dir, self.PROCESSED_SUB, video_id,
                               "pose_shape.pkl")
            if not os.path.exists(pkl):
                self._smpl_cache[video_id] = None
            else:
                with open(pkl, "rb") as f:
                    d = pickle.load(f)
                cams = np.asarray(d["cams"], np.float32)
                shape = np.asarray(d["shape"], np.float32)
                if self.SHAPE_ONCE or shape.shape[0] != cams.shape[0]:
                    # MotionSynthetic stores one shape row per video
                    # (MotionSynthetic.py:229)
                    shape = np.repeat(shape[:1], cams.shape[0], axis=0)
                self._smpl_cache[video_id] = np.concatenate(
                    [cams, np.asarray(d["pose"], np.float32), shape], axis=1)
        return self._smpl_cache[video_id]


class FashionVideoProtocol(ProcessedDirProtocol):
    """DeepFashion video protocol (protocols/fashionvideo.py:10-256):
    frames under ``processed/val``."""

    PROCESSED_SUB = os.path.join("processed", "val")


class MotionSyntheticProtocol(ProcessedDirProtocol):
    """Synthetic-motion protocol (protocols/MotionSynthetic.py:9-256);
    per-video single shape row broadcast over frames."""

    SHAPE_ONCE = True


class YoutubeDancer18Protocol(ProcessedDirProtocol):
    """Youtube-Dancer-18 protocol (protocols/YoutubeDancer18.py:35-281)."""


class MSNovelViewProtocol(MotionSyntheticProtocol):
    """MotionSynthetic novel-view protocol: the REAL
    ``MS_novel_view_protocol.json`` is the MS protocol schema with the
    self/cross ranges restricted to each clip's camera-orbit segment
    (every entry carries ``"novel view": true``); the evaluator scores
    view synthesis as self-imitation over that segment
    (evaluators/novel_view_synthesize.py:141-165 — its
    ``write_gt_masked_images`` mask path is disabled upstream at
    :157-158, so refs are the raw frames, same as here). Layout and
    smpls match MotionSynthetic; gt view smpls differ from the source
    only in cam + global orientation."""


PROTOCOLS = {
    "iPER": IPERProtocol,
    "fashionvideo": FashionVideoProtocol,
    "MotionSynthetic": MotionSyntheticProtocol,
    "YoutubeDancer18": YoutubeDancer18Protocol,
    # appearance-transfer + novel-view variants (the reference's other
    # two headline tasks; appearance_transfer.py:203-213,
    # novel_view_synthesize.py:205-214)
    "iPER_Appearance_Transfer": IPERATProtocol,
    "MotionSynthetic_Novel_View": MSNovelViewProtocol,
    # the reference NV evaluator also names an iPER novel-view variant
    # (novel_view_synthesize.py:209-210); its layout is plain iPER
    "iPER_Novel_View": IPERProtocol,
}


def build_protocol(name: str, data_dir: str, protocol_file: str,
                   **kwargs) -> Protocol:
    if name not in PROTOCOLS:
        raise ValueError(f"unknown protocol {name}")
    return PROTOCOLS[name](data_dir, protocol_file, **kwargs)
