"""Random MPEG-1 and MPEG-2 encodes through the port's decoder and libavcodec's, plane for plane.

    python tests/torch_mpeg12/fuzz.py SEED TRIALS [mpeg1video|mpeg2video]

Each trial encodes a few seeded scene frames with libavcodec's
`mpeg1video` or `mpeg2video` encoder (`tests/torch_mpeg4/libavcodec.py`)
at a random size (widths that are not a multiple of 16, odd ones too; even
heights), with random B pictures, GOP length, quantiser range, adaptive
quantisation, `intra_vlc`, intra DC precision and `non_linear_quant`, then
may rewrite its headers as `make_fixtures.py splice` does (the alternate
scan, `progressive_frame` 0, loaded matrices in the sequence header or a
quant matrix extension), and decodes it with the port (`data/mpeg12.py`)
and with libavcodec. Every mismatch is printed; the exit status is 1 if there
was one. `tests/test_torch_mpeg12.py` runs a few trials (`trial`).
"""

import importlib.util
import random
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))

_spec = importlib.util.spec_from_file_location("mpeg12_fixtures", HERE / "make_fixtures.py")
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)
libavcodec = fixtures.libavcodec

from yolo_infer_tpu_torch.data.mpeg12 import Mpeg12Decoder  # noqa: E402

SPLICES = {"mpeg1video": [None, None, "sequence_matrices"],
           "mpeg2video": [None, None, "alternate", "progressive_frame_0", "sequence_matrices",
                          "quant_matrix_extension"]}


def options(rng: random.Random, codec: str) -> dict:
    opts = {"bf": rng.choice([0, 0, 1, 2, 3]), "g": rng.randint(1, 12)}
    qmax = 28 if codec == "mpeg2video" else 31
    lo = rng.choice([1, 2, 4, 8, 16])
    opts.update(qmin=lo, qmax=rng.randint(lo, qmax))
    if rng.random() < 0.4:
        opts[rng.choice(["scplx_mask", "tcplx_mask", "lumi_mask", "dark_mask"])] = rng.choice([0.3, 0.8])
    if codec == "mpeg2video":
        if rng.random() < 0.5:
            opts["intra_vlc"] = 1
        if rng.random() < 0.5:
            opts["dc"] = rng.randint(8, 11)
        if rng.random() < 0.3:
            opts["non_linear_quant"] = 1
    return opts


def trial(rng: random.Random, codec: str):
    """One random encode; None if the port's planes equal libavcodec's, else what differed."""
    w = rng.randint(1, 12) * 16 - rng.choice([0, 0, 1, 2, 5, 6])
    h = rng.randint(1, 9) * 16 - rng.choice([0, 0, 2, 4])
    n = rng.randint(2, 7)
    opts = options(rng, codec)
    how = rng.choice(SPLICES[codec])
    seed = rng.randrange(1 << 30)
    e = fixtures.encode(codec, w, h, n, seed, rng.random() < 0.6, dict(opts))
    packets = [p[0] for p in e.packets]
    if how:
        packets = fixtures.splice(packets, how, random.Random(seed))
    want = libavcodec.decode(packets, codec_name=codec)
    decoder = Mpeg12Decoder()
    got = [f for f in map(decoder.decode, packets) if f is not None]
    last = decoder.flush()
    got += [last] if last is not None else []
    what = f"{codec} {w}x{h} n={n} {opts} splice={how} seed={seed}"
    if len(got) != len(want):
        return f"{what}: {len(got)} frames, libavcodec {len(want)}"
    for k, (a, b) in enumerate(zip(got, want)):
        for plane, (x, y) in enumerate(zip(a, b)):
            if not np.array_equal(x, y):
                return f"{what}: frame {k} plane {plane} differs in {int((x != y).sum())} samples"
    return None


def main(argv) -> int:
    seed, trials = int(argv[0]), int(argv[1])
    codecs = argv[2:] or ["mpeg1video", "mpeg2video"]
    rng = random.Random(seed)
    bad = 0
    for k in range(trials):
        found = trial(rng, codecs[k % len(codecs)])
        if found:
            bad += 1
            print(found, flush=True)
    print(f"{trials} trials, {bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
