"""optixOpticalFlow equivalent: standalone optical-flow driver.

Reference: `SDK/optixOpticalFlow/optixOpticalFlow.cpp` — two frames (or a
'+'-placeholder frame sequence, `--Frames first-last`) in, per-pixel flow
vectors from frame N to frame N+1 out, written as a 3-channel float EXR
with the flow in the first two channels and the third left zero (the
reference does exactly this because its ImageBuffer has no 2-channel
format, `optixOpticalFlow.cpp:205-209`). The flow model itself is the
coarse-to-fine block matcher in denoise/flow.py — the stand-in
for the driver's flow network (`optix_denoiser_opticalflow.h`).
"""
from __future__ import annotations

import argparse

import numpy as np

from .denoiser import frame_filename
from ..io.image import load_image, save_image


def _load(path):
    r = load_image(path)
    a = np.asarray(r, np.float32)[..., :3]
    return a / 255.0 if r.dtype == np.uint8 else a


def _flow_image(frame_a, frame_b, levels, radius):
    from ..denoise.flow import optical_flow
    fl = np.asarray(optical_flow(frame_a, frame_b,
                                 levels=levels, radius=radius))
    out = np.zeros(fl.shape[:2] + (3,), np.float32)
    out[..., :2] = fl
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="optical flow between two frames (optixOpticalFlow)")
    p.add_argument("frame1", help="first frame (.exr/.npz float or .png); "
                                  "'+' run = frame-number placeholder")
    p.add_argument("frame2", nargs="?", default=None,
                   help="second frame (omitted in --Frames mode: frame N+1 "
                        "comes from frame1's placeholder)")
    p.add_argument("-o", "--out", default="flow.exr",
                   help="flow output (channels: x, y, 0)")
    p.add_argument("-F", "--Frames", default=None, metavar="FIRST-LAST",
                   help="frame sequence: flow is computed between each "
                        "consecutive pair; output filenames take the "
                        "FIRST frame number of the pair")
    p.add_argument("--levels", type=int, default=4,
                   help="pyramid levels (search range ~ radius*(2^levels-1))")
    p.add_argument("--radius", type=int, default=2,
                   help="per-level search radius in pixels")
    args = p.parse_args(argv)

    if args.Frames:
        first, last = (int(x) for x in args.Frames.split("-"))
        if not 0 <= first < last:
            raise SystemExit("error: --Frames wants FIRST-LAST with "
                             "0 <= first < last")
        prev = _load(frame_filename(args.frame1, first))
        print(f"Optical flow with resolution {prev.shape[1]} x "
              f"{prev.shape[0]}")
        for frame in range(first, last):
            nxt = _load(frame_filename(args.frame2 or args.frame1,
                                       frame + 1))
            out = _flow_image(prev, nxt, args.levels, args.radius)
            path = frame_filename(args.out, frame)
            save_image(path, out)
            print(f"wrote {path}")
            prev = nxt
        return

    if args.frame2 is None:
        raise SystemExit("error: need two frames (or --Frames)")
    a = _load(args.frame1)
    b = _load(args.frame2)
    if a.shape != b.shape:
        raise SystemExit(f"error: frame sizes differ: {a.shape[:2]} vs "
                         f"{b.shape[:2]}")
    print(f"Optical flow with resolution {a.shape[1]} x {a.shape[0]}")
    out = _flow_image(a, b, args.levels, args.radius)
    save_image(args.out, out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
