"""The port's image codec (``csrc/host_codec.cpp``, torch port of
``impersonator_tpu/data/native.py`` and ``csrc/dataloader.cpp``): JPEG /
PNG decode, the loader's bilinear resize (float [-1, 1] or uint8), an
order-keeping threaded prefetch ring, and a JPEG encoder (quality 95 and
4:2:0 by default, as ``cv2.imencode(".jpg")``).

The caller's device type picks the build, explicitly; there is no
fallback between them:

* ``"cpu"``: g++ against libjpeg and zlib;
* ``"cuda"``: the same source against nvJPEG (the CUDA toolkit's codec)
  and zlib, for hosts without libjpeg. JPEG decodes on the card and the
  decoded frame comes back for the host resize; the encoder reads the
  frame from device memory.

PNG is decoded by the C++ code with zlib in both builds. Each build is
compiled at first use into ``impersonator_tpu_torch/_build/``, tagged by
a hash of the source and the flags, and loaded with ctypes (whose calls
release the GIL, so the ring's threads and the caller's run together). A
build that fails raises.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host_codec.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-fPIC", "-pthread",
             "-shared")
JPEG_QUALITY = 95

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SYMBOLS = {
    "codec_init": (_I, [_I]),
    "codec_last_error": (ctypes.c_char_p, []),
    "codec_image_info": (_I, [_P, _L, _P, _P]),
    "codec_decode": (_I, [_P, _L, _P]),
    "codec_resize_u8": (None, [_P, _I, _I, _I, _P]),
    "codec_decode_resize_u8": (_I, [ctypes.c_char_p, _I, _P]),
    "codec_decode_resize": (_I, [ctypes.c_char_p, _I, _P]),
    "loader_create": (_P, [_I, _I, _I, _I]),
    "loader_submit": (_I, [_P, ctypes.c_char_p, _L]),
    "loader_next": (_I, [_P, _P, _P]),
    "loader_next_u8": (_I, [_P, _P, _P]),
    "loader_destroy": (None, [_P]),
    "codec_encode_jpeg": (_L, [_P, _I, _I, _I, _P,
                               ctypes.POINTER(ctypes.c_void_p)]),
    "codec_free": (None, [_P]),
}

_LIBS: dict = {}
_LOCK = threading.Lock()


def _command(kind: str, out: Path) -> list:
    if kind == "cpu":
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++) to build the codec")
        return [cxx, *CXX_FLAGS, "-DCODEC_LIBJPEG", "-o", str(out),
                str(SOURCE), "-ljpeg", "-lz"]
    from impersonator_tpu_torch.ops.cuda_raster import _nvcc
    nvcc = _nvcc()
    lib64 = Path(nvcc).resolve().parent.parent / "lib64"
    host = ",".join(f for f in CXX_FLAGS if f not in ("-O3", "-std=c++17",
                                                      "-shared"))
    return [nvcc, "-O3", "-std=c++17", "-shared", "-Xcompiler", host,
            "-DCODEC_NVJPEG", "-o", str(out), str(SOURCE), "-lnvjpeg", "-lz",
            "-Xlinker", f"-rpath,{lib64}"]


def _build(kind: str) -> SimpleNamespace:
    tag = hashlib.sha256(SOURCE.read_bytes() + kind.encode()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"host_codec_{kind}_{tag}.so"
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(_command(kind, tmp), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the {kind} codec failed:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    so = ctypes.CDLL(str(out))
    lib = SimpleNamespace(path=str(out), kind=kind)
    for name, (res, args) in _SYMBOLS.items():
        fn = getattr(so, name)
        fn.restype, fn.argtypes = res, args
        setattr(lib, name, fn)
    return lib


def backend(device) -> str:
    """'cpu' (libjpeg) or 'cuda' (nvJPEG): the build a device uses."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no codec for device {device}")
    return kind


def load(device="cuda") -> SimpleNamespace:
    """The codec library of ``device``'s type, built at first use."""
    kind = backend(device)
    with _LOCK:
        if kind not in _LIBS:
            lib = _build(kind)
            index = 0
            if kind == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("the cuda codec needs a CUDA device")
                dev = torch.device(device)
                index = (dev.index if dev.index is not None
                         else torch.cuda.current_device())
            if lib.codec_init(index) != 0:
                raise RuntimeError(f"codec init failed: {_error(lib)}")
            _LIBS[kind] = lib
        return _LIBS[kind]


def _error(lib) -> str:
    return (lib.codec_last_error() or b"").decode(errors="replace")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def decode(data: bytes, device="cuda") -> np.ndarray:
    """JPEG or PNG bytes -> (H, W, 3) uint8 RGB."""
    lib = load(device)
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.codec_image_info(_ptr(buf), buf.size, ctypes.byref(w),
                            ctypes.byref(h)) != 0:
        raise ValueError(f"undecodable image: {_error(lib)}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.codec_decode(_ptr(buf), buf.size, _ptr(out)) != 0:
        raise ValueError(f"undecodable image: {_error(lib)}")
    return out


def read_image(path: str, device="cuda") -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode(f.read(), device)


def resize_u8(img: np.ndarray, image_size: int, device="cuda") -> np.ndarray:
    """(H, W, 3) uint8 -> (S, S, 3) uint8: float bilinear with half-pixel
    centres, then rounded (``dataloader.cpp``'s ``resize_u8``)."""
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((image_size, image_size, 3), np.uint8)
    load(device).codec_resize_u8(_ptr(img), img.shape[1], img.shape[0],
                                 image_size, _ptr(out))
    return out


def decode_resize(path: str, image_size: int, device="cuda") -> np.ndarray:
    """Decode a file -> (S, S, 3) float32 in [-1, 1]."""
    lib = load(device)
    out = np.empty((image_size, image_size, 3), np.float32)
    if lib.codec_decode_resize(path.encode(), image_size, _ptr(out)) != 0:
        raise IOError(f"decode failed: {_error(lib)}")
    return out


def decode_resize_u8(path: str, image_size: int, device="cuda") -> np.ndarray:
    """Decode a file -> (S, S, 3) uint8 RGB (normalise on the device:
    x / 127.5 - 1)."""
    lib = load(device)
    out = np.empty((image_size, image_size, 3), np.uint8)
    if lib.codec_decode_resize_u8(path.encode(), image_size, _ptr(out)) != 0:
        raise IOError(f"decode failed: {_error(lib)}")
    return out


def encode_jpeg(img, quality: int = JPEG_QUALITY, device="cuda") -> bytes:
    """(H, W, 3) uint8 RGB (array or tensor) -> JPEG bytes, 4:2:0. On
    ``"cuda"`` nvJPEG reads the frame from device memory (a host frame is
    copied there first) on the current stream."""
    lib = load(device)
    out = ctypes.c_void_p()
    if lib.kind == "cuda":
        dev = torch.device(device)
        t = torch.as_tensor(img, dtype=torch.uint8).to(dev).contiguous()
        h, w = t.shape[0], t.shape[1]
        stream = torch.cuda.current_stream(t.device).cuda_stream
        n = lib.codec_encode_jpeg(t.data_ptr(), w, h, quality, stream,
                                  ctypes.byref(out))
    else:
        a = img.cpu().numpy() if torch.is_tensor(img) else img
        a = np.ascontiguousarray(a, np.uint8)
        h, w = a.shape[0], a.shape[1]
        n = lib.codec_encode_jpeg(_ptr(a), w, h, quality, None,
                                  ctypes.byref(out))
    if n < 0:
        raise RuntimeError(f"jpeg encode failed: {_error(lib)}")
    try:
        return ctypes.string_at(out.value, n)
    finally:
        lib.codec_free(out)


class NativeImageLoader:
    """Order-keeping threaded prefetch: submit paths, pop decoded frames
    resized to ``image_size``² in submission order, as ``(frame, tag)``.
    ``u8`` pops uint8 RGB (normalise on the device), else float32 in
    [-1, 1]. At most ``capacity`` frames are in flight; a decode error
    raises at the frame's turn, naming its path."""

    def __init__(self, image_size: int, threads: int = 4,
                 capacity: int = 64, u8: bool = False, device="cuda"):
        self._lib = load(device)
        self.image_size = image_size
        self.u8 = u8
        self._paths = collections.deque()
        self._h = self._lib.loader_create(threads, capacity, image_size,
                                          int(u8))

    def submit(self, path: str, tag: int = 0):
        if self._lib.loader_submit(self._h, path.encode(), tag) != 0:
            raise RuntimeError("loader shut down")
        self._paths.append(path)

    def next(self) -> tuple:
        s = self.image_size
        tag = ctypes.c_long(0)
        out = np.empty((s, s, 3), np.uint8 if self.u8 else np.float32)
        pop = self._lib.loader_next_u8 if self.u8 else self._lib.loader_next
        rc = pop(self._h, _ptr(out), ctypes.byref(tag))
        if rc == -2:
            raise StopIteration
        path = self._paths.popleft()
        if rc != 0:
            raise IOError(f"decode failed: {path}: {_error(self._lib)}")
        return out, tag.value

    def close(self):
        if getattr(self, "_h", None):
            self._lib.loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
