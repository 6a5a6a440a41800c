"""Hold the port's MPEG-4 and H.263 decoders to libavcodec's on random encodes.

    python tests/torch_mpeg4/fuzz.py SEED [CASES] [asp|divx|h263|msmpeg4v2|div3|wmv1|wmv2|synth]

Mode `asp` (the default): each case draws a size, a frame count and a set
of libavcodec `mpeg4` encoder options (B-VOPs, 4MV, quarter-pel, MPEG
quantisation, an adaptive quantiser, video packets, data partitioning,
fixed quantisers, motion search range, GOP length, macroblock decision,
trellis), encodes a seeded moving scene
(`tests/torch_video/make_fixtures.py scene`, sometimes with white blocks or
with samples at 0 and 255 in every plane) through ctypes
(`libavcodec.py`), sometimes splices Xvid user data of some build or
loaded matrices into the stream (`make_fixtures.py`), and compares the
port's `Mpeg4Decoder` planes with libavcodec's decoder's on this host.
Mode `divx`: the same encodes with DivX or old libavcodec user data
spliced in (`DIVX_USER_DATA`), or a DivX 4 VOL under a `DIVX` tag, the
B-VOPs packed as DivX writes them (`make_fixtures.pack_divx`) or not.
Mode `h263`: the `h263` encoder at a random one of its five sizes (the
largest rarely), quantisers, GOB headers (`ps`), an adaptive quantiser and
`+mv4`, against libavcodec's `h263` decoder and `H263Decoder`. Modes
`msmpeg4v2`, `div3`, `wmv1` and `wmv2`: libavcodec's `msmpeg4v2`,
`msmpeg4`, `wmv1` and `wmv2` encoders at a random size (odd ones too),
quantiser (fixed at 1..31, so that every DC scale is met, or free), GOP,
macroblock decision, motion search range, bit rate (WMV1's per-macroblock
RL flag and its intra DC from pixels turn on by it), fps and (WMV2) the
loop filter, against the same decoders and the port's `MsMpeg4Decoder` or
`Wmv2Decoder` (`data/msmpeg4.py make_decoder`). Mode `synth`: random
streams of `tests/torch_msmpeg4/synth.py` (a random version, size and
picture order: the syntax those encoders never write) against the same
decoders. Prints each
case that differs, with the frames and macroblocks, and last `seed S cases
N fails F`. Exits 1 if a case failed, 2 without the library.
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
from yolo_infer_tpu_torch.data.h263 import H263Decoder  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Decoder, bgr_to_yuv420  # noqa: E402
from yolo_infer_tpu_torch.data.msmpeg4 import make_decoder  # noqa: E402

sys.path.append(str(REPO / "tests" / "torch_msmpeg4"))
import synth  # noqa: E402

# this folder's make_fixtures.py, under another name: it imports tests/torch_video's make_fixtures.py
_spec = importlib.util.spec_from_file_location("mpeg4_fixtures", HERE / "make_fixtures.py")
make_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_fixtures)

XVID_USER_DATA = (None, None, b"XviD0001", b"XviD0012", b"XviD0030", b"XviD0064", b"")
# DivX and old libavcodec builds: each workaround range, DivX 5.01 build 20020416's padding score
DIVX_USER_DATA = (b"DivX503b1393p", b"DivX501b1600p", b"DivX502b1813", b"DivX609Build1896p", b"DivX501b20020416p",
                  b"DivX400b1234", b"ffmpeg", b"FFmpeg0.4.9-pre1b4652", b"FFmpeg0.4.9-pre1b4654",
                  b"FFmpeg v0.4.9 / libavcodec build: 4669", b"FFmpeg0.4.9b4712", b"Lavc56.60.100",
                  b"Lavc57.64.101", b"Lavc51.40.4")
H263_SIZES = ((128, 96), (176, 144), (352, 288), (704, 576))
# mode: (libavcodec codec name, the port's MS-MPEG-4 version)
MS_MODES = {"msmpeg4v2": ("msmpeg4v2", 2), "div3": ("msmpeg4", 3), "wmv1": ("wmv1", 4), "wmv2": ("wmv2", 5)}


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


def draw_divx(rng: random.Random):
    """A DivX or old-build case: an `asp` case's encode options with the
    user data to splice, whether to pack its B-VOPs, and whether to make it
    DivX 4 (an object type 0 VOL under a `DIVX` tag, no user data, no
    B-VOPs)."""
    w, h, planes, opts, _, _ = draw_case(rng)
    opts.pop("data_partitioning", None)
    divx4 = rng.random() < 0.15
    if divx4:
        opts.pop("bf", None)
    return w, h, planes, opts, rng.choice(DIVX_USER_DATA), rng.random() < 0.6, divx4


def draw_h263(rng: random.Random):
    """An `h263` case: size, planes and encoder options."""
    w, h = H263_SIZES[min(int(rng.random() * 3.2), 3)]
    opts = {}
    if rng.random() < 0.5:
        opts["ps"] = rng.choice([50, 200, 1000])
    if rng.random() < 0.5:
        q = rng.randint(1, 31)
        opts["qmin"], opts["qmax"] = q, min(31, q + rng.randint(0, 5))
    if rng.random() < 0.4:
        opts["p_mask"], opts["lumi_mask"] = rng.choice([0.1, 0.3, 0.6]), rng.choice([0.1, 0.3])
    if rng.random() < 0.3:
        opts["flags"] = "+mv4"
    if rng.random() < 0.3:
        opts["mbd"] = rng.randint(0, 2)
    if rng.random() < 0.2:
        opts["g"] = rng.randint(2, 6)
    planes = [bgr_to_yuv420(f) for f in make_fixtures.scene(rng.randint(2, 6), h, w, rng.randint(0, 1000))]
    return w, h, planes, opts


def draw_ms(rng: random.Random, mode: str):
    """An MS-MPEG-4 or WMV case: size, planes and encoder options."""
    w = rng.choice([16, 32, 48, 64, 80, 96, 98, 100, 130, 176, 200])
    h = rng.choice([16, 32, 48, 60, 64, 96, 144])
    opts = {"g": rng.randint(1, 12)} if rng.random() < 0.6 else {}
    if rng.random() < 0.6:
        q = rng.randint(1, 31)
        opts["qmin"], opts["qmax"] = q, min(31, q + rng.randint(0, 3))
    if rng.random() < 0.4:
        opts["b"] = rng.choice([20_000, 60_000, 100_000, 140_000, 400_000, 2_000_000])
    if rng.random() < 0.3:
        opts["mbd"] = rng.randint(0, 2)
    if rng.random() < 0.2:
        opts["me_range"] = rng.choice([4, 16, 64])
    if mode == "wmv2" and rng.random() < 0.5:
        opts["flags"] = "+loop"
    fps = rng.choice([(25, 1), (30, 1), (30000, 1001), (15, 1), (60, 1)])
    frames = make_fixtures.scene(rng.randint(2, 12), h, w, rng.randint(0, 1000))
    if rng.random() < 0.3:
        for f in frames:
            f[: h // 3, : w // 3] = 255
    planes = [bgr_to_yuv420(f) for f in frames]
    if rng.random() < 0.3:  # samples at 0 and 255 in moving rectangles of every plane
        for i, frame in enumerate(planes):
            for k, p in enumerate(frame):
                ph, pw = p.shape
                y0, x0 = (i * 2 + k) % max(ph - 4, 1), (i * 3) % max(pw - 4, 1)
                p[y0:y0 + ph // 3, x0:x0 + pw // 3] = 0
                p[ph // 2:ph // 2 + ph // 4, pw // 2:] = 255
    return w, h, planes, opts, fps


def run_case(packets, xvid, matrices, tag=b"FMP4", divx=None):
    """None if the port's planes of an encode's `packets` (Xvid user data,
    matrices, DivX user data and packing as drawn: `divx` is (user data,
    pack, DivX 4)) equal libavcodec's, else what differs."""
    if xvid is not None:
        packets, tag = make_fixtures.replace_user_data(packets, xvid), b"XVID"
    if matrices:
        packets = make_fixtures.with_matrices(packets)
    if divx is not None:
        text, pack, divx4 = divx
        if divx4:
            packets, tag = make_fixtures.divx4_vol(make_fixtures.replace_user_data(packets, b"")), b"DIVX"
        else:
            packets, tag = make_fixtures.replace_user_data(packets, text), b"DX50"
        if pack:
            packets = make_fixtures.pack_divx(packets)
    want = libavcodec.decode(packets, codec_tag=tag)
    decoder = Mpeg4Decoder(fourcc=tag.decode())
    return compare(decoder, packets, want)


def compare(decoder, packets, want):
    """None if `decoder`'s planes of `packets` equal `want`, else what differs."""
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


def main(seed: int, cases: int, mode: str = "asp") -> int:
    if not libavcodec.available():
        print("libavcodec is not available")
        return 2
    rng = random.Random(seed)
    fails = 0
    for case in range(cases):
        if mode == "synth":
            version = rng.choice([2, 3, 4, 5])
            name = MS_MODES[("msmpeg4v2", "div3", "wmv1", "wmv2")[version - 2]][0]
            w, h = rng.choice([16, 32, 40, 48, 64, 80, 96, 112]), rng.choice([16, 32, 48, 64])
            writer = synth.Synth(version, w, h, rng)
            packets = [writer.picture(k) for k in [0] + [rng.choice([0, 1, 1, 1]) for _ in range(rng.randint(1, 6))]]
            want = libavcodec.decode(packets, writer.extradata, codec_name=name, video_size=f"{w}x{h}")
            diff = compare(make_decoder(w, h, version, writer.extradata), packets, want)
            planes, drawn = packets, (name,)
        elif mode in MS_MODES:
            name, version = MS_MODES[mode]
            w, h, planes, opts, fps = draw_ms(rng, mode)
            try:
                encoded = libavcodec.encode(planes, w, h, fps=fps, codec_name=name, **opts)
            except (RuntimeError, ValueError) as exc:
                print("encode refused", opts, exc)
                continue
            packets = [p[0] for p in encoded.packets]
            want = libavcodec.decode(packets, encoded.extradata, codec_name=name, video_size=f"{w}x{h}")
            diff = compare(make_decoder(w, h, version, encoded.extradata), packets, want)
            drawn = (opts, fps)
        elif mode == "h263":
            w, h, planes, opts = draw_h263(rng)
            packets = [p[0] for p in libavcodec.encode(planes, w, h, codec_name="h263", **opts).packets]
            diff = compare(H263Decoder(), packets, libavcodec.decode(packets, codec_name="h263"))
            drawn = (opts,)
        else:
            if mode == "divx":
                w, h, planes, opts, *divx = draw_divx(rng)
                xvid, matrices, drawn = None, False, (opts, divx)
            else:
                w, h, planes, opts, xvid, matrices = draw_case(rng)
                divx, drawn = None, (opts, xvid, matrices)
            try:
                packets = [p[0] for p in libavcodec.encode(planes, w, h, **opts).packets]
            except (RuntimeError, ValueError) as exc:  # the encoder refused the options
                print("encode refused", opts, exc)
                continue
            diff = run_case(packets, xvid, matrices, divx=divx)
        if diff:
            fails += 1
            print("FAIL", case, w, h, len(planes), *drawn, diff)
    print("seed", seed, "cases", cases, "mode", mode, "fails", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]) if len(sys.argv) > 2 else 40,
                  sys.argv[3] if len(sys.argv) > 3 else "asp"))
