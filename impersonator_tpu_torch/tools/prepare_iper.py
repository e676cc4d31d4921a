"""iPER dataset preparation: videos -> protocol-named frame folders (the
port's counterpart of ``tools/prepare_iper.py``, on
``utils.video.video_to_frames``):

    python -m impersonator_tpu_torch.tools.prepare_iper \\
        --video_dir /data/iPER_videos --out_dir /data/iPER/images_HD [--fps 25]

Videos are ``{actor}_{outfit}_{cam}.mp4``; their frames land in
``{out_dir}/{actor}/{outfit}/{cam}/frame_%08d.png``. It needs ffmpeg on
the host and no card.
"""

from __future__ import annotations

import argparse
import glob
import os

from impersonator_tpu_torch.utils.video import video_to_frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--video_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--fps", type=int, default=None)
    args = ap.parse_args(argv)

    videos = sorted(glob.glob(os.path.join(args.video_dir, "*.mp4")))
    if not videos:
        print(f"no videos under {args.video_dir}")
        return
    for path in videos:
        stem = os.path.splitext(os.path.basename(path))[0]
        parts = stem.split("_")
        rel = os.path.join(*parts[:3]) if len(parts) >= 3 else stem
        out = os.path.join(args.out_dir, rel)
        if os.path.isdir(out) and os.listdir(out):
            print(f"skip {rel} (exists)")
            continue
        n = len(video_to_frames(path, out, fps=args.fps))
        print(f"{rel}: {n} frames")


if __name__ == "__main__":
    main()
