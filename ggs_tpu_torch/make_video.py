"""Assemble a run's saved frame PNGs into a looping .apng animation
(runners/make_video.py). run_ga and run_sa assemble theirs at the end of a
run; this covers frames from interrupted or older runs.

    python -m ggs_tpu_torch.make_video output/video_frames --prefix ga \
        --out output/ga_anim.apng --fps 30
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> str:
    """Write the animation; returns its path (exits 1 when there are no frames)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("frames_dir")
    p.add_argument("--prefix", default="ga")
    p.add_argument("--out", default="")
    p.add_argument("--fps", type=int, default=30)
    args = p.parse_args(argv)

    from .utils import io as io_mod

    out = args.out or os.path.join(
        os.path.dirname(args.frames_dir.rstrip("/")) or ".", f"{args.prefix}_anim.apng")
    path = io_mod.assemble_apng(args.frames_dir, args.prefix, out, fps=args.fps)
    if path is None:
        print(f"no frames matching {args.prefix}_*.png in {args.frames_dir}", file=sys.stderr)
        sys.exit(1)
    print(f"Assembled animation: {path}")
    return path


if __name__ == "__main__":
    main()
