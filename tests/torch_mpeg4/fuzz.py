"""Hold the port's MPEG-4 decoder to libavcodec's on random encodes.

    python tests/torch_mpeg4/fuzz.py SEED [CASES]

Each case draws a size, a frame count and a set of libavcodec `mpeg4`
encoder options (B-VOPs, 4MV, quarter-pel, MPEG quantisation, an adaptive
quantiser, video packets, data partitioning, fixed quantisers, motion
search range, GOP length, macroblock decision, trellis), encodes a seeded
moving scene (`tests/torch_video/make_fixtures.py scene`, sometimes with
white blocks or with samples at 0 and 255 in every plane) through ctypes
(`libavcodec.py`), sometimes splices Xvid user data of some build or
loaded matrices into the stream (`make_fixtures.py`), and compares the
port's `Mpeg4Decoder` planes with libavcodec's decoder's on this host.
Prints each case that differs, with the frames and macroblocks, and last
`seed S cases N fails F`. Exits 1 if a case failed, 2 without the library.
"""

import importlib.util
import random
import sys
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))

import libavcodec  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Decoder, bgr_to_yuv420  # noqa: E402

# this folder's make_fixtures.py, under another name: it imports tests/torch_video's make_fixtures.py
_spec = importlib.util.spec_from_file_location("mpeg4_fixtures", HERE / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)

XVID_USER_DATA = (None, None, b"XviD0001", b"XviD0012", b"XviD0030", b"XviD0064", b"")


def draw_case(rng: random.Random):
    """A case's size, planes, encoder options, Xvid user data (None: none
    spliced) and whether to splice loaded matrices."""
    w, h = rng.choice([16, 48, 64, 80, 98, 100, 130, 176]), rng.choice([16, 32, 48, 60, 64, 96])
    n = rng.randint(3, 12)
    opts = {}
    if rng.random() < 0.7:
        opts["bf"] = rng.randint(1, 3)
    flags = [f for f in ("+mv4", "+qpel") if rng.random() < 0.5]
    if flags:
        opts["flags"] = "".join(flags)
    if rng.random() < 0.5:
        opts["mpeg_quant"] = 1
    if rng.random() < 0.5:
        opts["p_mask"], opts["lumi_mask"] = rng.choice([0.1, 0.3, 0.6]), rng.choice([0.1, 0.3])
    if rng.random() < 0.5:
        opts["ps"] = rng.choice([50, 100, 300, 1000])
    if rng.random() < 0.3:
        opts["data_partitioning"] = 1
    if rng.random() < 0.3:
        q = rng.randint(1, 31)
        opts["qmin"], opts["qmax"] = q, min(31, q + rng.randint(0, 5))
    if rng.random() < 0.2:
        opts["me_range"] = rng.choice([4, 16, 64])
    if rng.random() < 0.2:
        opts["g"] = rng.randint(2, 8)
    if rng.random() < 0.3:
        opts["mbd"] = rng.randint(0, 2)
    if rng.random() < 0.2:
        opts["trellis"] = 1
    xvid = rng.choice(XVID_USER_DATA)
    frames = make_fixtures.scene(n, h, w, rng.randint(0, 1000))
    if rng.random() < 0.3:
        for f in frames:
            f[: h // 3, : w // 3] = 255
    planes = [bgr_to_yuv420(f) for f in frames]
    if rng.random() < 0.4:  # samples at 0 and 255 in moving rectangles of every plane
        for i, frame in enumerate(planes):
            for k, p in enumerate(frame):
                ph, pw = p.shape
                y0, x0 = (i * 2 + k) % max(ph - 4, 1), (i * 3) % max(pw - 4, 1)
                p[y0:y0 + ph // 3, x0:x0 + pw // 3] = 0
                p[ph // 2:ph // 2 + ph // 4, pw // 2:] = 255
    matrices = rng.random() < 0.2 and bool(opts.get("mpeg_quant"))
    return w, h, planes, opts, xvid, matrices


def run_case(packets, xvid, matrices):
    """None if the port's planes of an encode's `packets` (Xvid user data
    and matrices spliced in as drawn) equal libavcodec's, else what differs."""
    tag = b"FMP4"
    if xvid is not None:
        packets, tag = make_fixtures.replace_user_data(packets, xvid), b"XVID"
    if matrices:
        packets = make_fixtures.with_matrices(packets)
    want = libavcodec.decode(packets, codec_tag=tag)
    decoder = Mpeg4Decoder(fourcc=tag.decode())
    try:
        got = [f for f in [decoder.decode(p) for p in packets] + [decoder.flush()] if f is not None]
    except Exception:  # noqa: BLE001 -- a raise is a mismatch too
        return traceback.format_exc()[-600:]
    if len(got) != len(want):
        return f"{len(got)} frames, libavcodec {len(want)}"
    diffs = []
    for i, (a, b) in enumerate(zip(got, want)):
        for k, (x, y) in enumerate(zip(a, b)):
            d = np.argwhere(x != y)
            if len(d):
                size = 16 if k == 0 else 8
                mbs = sorted({(int(r) // size, int(c) // size) for r, c in d})[:10]
                diffs.append(f"frame {i} plane {k}: {len(d)} samples, macroblocks {mbs}, "
                             f"max {int(np.abs(x.astype(int) - y).max())}")
    return "; ".join(diffs) or None


def main(seed: int, cases: int) -> int:
    if not libavcodec.available():
        print("libavcodec is not available")
        return 2
    rng = random.Random(seed)
    fails = 0
    for case in range(cases):
        w, h, planes, opts, xvid, matrices = draw_case(rng)
        try:
            packets = [p[0] for p in libavcodec.encode(planes, w, h, **opts).packets]
        except (RuntimeError, ValueError) as exc:  # the encoder refused the options
            print("encode refused", opts, exc)
            continue
        diff = run_case(packets, xvid, matrices)
        if diff:
            fails += 1
            print("FAIL", case, w, h, len(planes), opts, xvid, matrices, diff)
    print("seed", seed, "cases", cases, "fails", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]) if len(sys.argv) > 2 else 40))
