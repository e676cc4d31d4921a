"""Video IO through an ffmpeg subprocess (torch port of
``impersonator_tpu/utils/video.py``): rawvideo pipes into and out of one
ffmpeg process, and the side-by-side demo montages. Every function that
needs ffmpeg raises ``RuntimeError("ffmpeg not available on host")``
where the host has none; :func:`have_ffmpeg` says which.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np


def _ffmpeg():
    path = shutil.which("ffmpeg")
    if path is None:
        raise RuntimeError("ffmpeg not available on host")
    return path


def have_ffmpeg() -> bool:
    """True when the host can encode/extract video at all — callers
    gate optional montage/mp4 outputs on this instead of crashing."""
    return shutil.which("ffmpeg") is not None


def frames_to_mp4(frames, out_path: str, fps: int = 25) -> str:
    """frames: iterable of (H, W, 3) float [-1,1] or uint8 RGB."""
    frames = list(frames)
    h, w = np.asarray(frames[0]).shape[:2]
    cmd = [_ffmpeg(), "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
           "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
           "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    for frame in frames:
        proc.stdin.write(_to_u8(frame).tobytes())
    proc.stdin.close()
    proc.wait()
    return out_path


def i420_to_mp4(packed, out_path: str, fps: int = 25) -> str:
    """Encode device-packed raw yuv420p frames (ops.colorspace.rgb_to_i420)
    with ZERO host-side pixel work: ``packed`` is (N, H*3//2, W) uint8 in
    I420 memory order, exactly what ffmpeg's rawvideo demuxer consumes:
    no RGB->YUV pass on the host, and the readback that produced it was
    half the bytes of u8 RGB."""
    packed = np.asarray(packed)
    if packed.dtype != np.uint8 or packed.ndim != 3:
        raise ValueError(f"packed I420 must be (N, H*3//2, W) uint8, got "
                         f"{packed.shape} {packed.dtype}")
    n, h32, w = packed.shape
    h = h32 * 2 // 3
    cmd = [_ffmpeg(), "-y", "-f", "rawvideo", "-pix_fmt", "yuv420p",
           "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
           "-c:v", "libx264", "-pix_fmt", "yuv420p", out_path]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    proc.stdin.write(packed.tobytes())
    proc.stdin.close()
    proc.wait()
    return out_path


def stream_i420(video_path: str, size: int = 224, fps: int | None = None):
    """Decode a video straight to raw planar yuv420p frames, streamed.

    Yields (size*3//2, size) uint8 arrays in I420 memory order — the
    decoder's NATIVE pixel format, so ffmpeg does no RGB conversion and
    the frames cross host->device at 1.5 bytes/pixel (half of u8 RGB).
    The device side inverts with ``ops.colorspace.i420_to_rgb_device``.
    """
    vf = f"scale={size}:{size}"
    if fps:
        vf = f"fps={fps},{vf}"
    cmd = [_ffmpeg(), "-i", video_path, "-vf", vf, "-f", "rawvideo",
           "-pix_fmt", "yuv420p", "-"]
    nbytes = size * size * 3 // 2
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, bufsize=nbytes * 4)
    try:
        while True:
            buf = proc.stdout.read(nbytes)
            if len(buf) < nbytes:
                break
            yield np.frombuffer(buf, np.uint8).reshape(size * 3 // 2, size)
    finally:
        proc.stdout.close()
        proc.wait()


def video_to_frames(video_path: str, out_dir: str, fps: int | None = None):
    """Extract frames (tools/unzip_iPER.py's ffmpeg path)."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [_ffmpeg(), "-y", "-i", video_path]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += [os.path.join(out_dir, "frame_%08d.png")]
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    return sorted(os.listdir(out_dir))


def _to_u8(arr) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = ((arr + 1.0) / 2.0 * 255).clip(0, 255).astype(np.uint8)
    return arr


def fuse_grid(streams, rows: int, cols: int) -> np.ndarray:
    """Compose per-frame grids from ``rows*cols`` aligned frame streams.

    The streams are in-memory arrays and the grid is one concatenate a
    frame.

    streams: list of (N, H, W, 3) arrays (uint8 or float [-1,1]), row-
    major grid order. Short streams repeat their last frame. Returns
    (N, H*rows, W*cols, 3) uint8.
    """
    assert len(streams) == rows * cols, (len(streams), rows, cols)
    streams = [_to_u8(s) for s in streams]
    n = max(s.shape[0] for s in streams)
    h, w = streams[0].shape[1:3]
    padded = []
    for s in streams:
        assert s.shape[1:3] == (h, w), "streams must share a frame size"
        if s.shape[0] < n:   # freeze-frame the shorter stream
            s = np.concatenate(
                [s, np.repeat(s[-1:], n - s.shape[0], axis=0)])
        padded.append(s)
    row_blocks = [np.concatenate(padded[r * cols:(r + 1) * cols], axis=2)
                  for r in range(rows)]
    return np.concatenate(row_blocks, axis=1)


def fuse_source_reference_output(src_img, ref_frames, pred_frames,
                                 out_path: str, fps: int = 25) -> str:
    """The demo format: a side-by-side [source | reference | prediction]
    mp4. ``src_img`` is one (H, W, 3) image tiled
    across time; ``ref_frames`` may be None for a 2-wide [source |
    prediction] montage."""
    pred = _to_u8(pred_frames)
    n = pred.shape[0]
    src = np.repeat(_to_u8(src_img)[None], n, axis=0)
    streams = [src, pred] if ref_frames is None else \
        [src, _to_u8(ref_frames), pred]
    grid = fuse_grid(streams, 1, len(streams))
    return frames_to_mp4(grid, out_path, fps)


class AsyncVideoWriter:
    """Collect frame batches as the device renders them; ``close`` encodes
    them into one mp4."""

    def __init__(self, out_path: str, fps: int = 25):
        self.out_path = out_path
        self.fps = fps
        self.frames = []

    def add(self, batch):
        self.frames.extend(list(np.asarray(batch)))

    def close(self) -> str:
        return frames_to_mp4(self.frames, self.out_path, self.fps)
