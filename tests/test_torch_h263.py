"""H.263 baseline in the port (`data/h263.py`): its cases, its refusals and its independence from OpenCV and JAX.

The fixtures are `tests/torch_mpeg4/`'s (`make_fixtures.py`: the `h263`
encoder through ctypes, `cv2.VideoWriter('H263')`'s own AVI and MOV, a
3GP from libavformat's muxer); `tests/test_torch_mpeg4_asp.py` holds every
one of them to OpenCV's frames, the JAX package and libavcodec's `h263`
decoder. Here: every H.263 case is met across them, the picture header's
refusals raise before any frame, and the H.263 path reads without jax or
cv2.
"""

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

from torch_threads import TORCH_SUBPROCESS_ENV  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_mpeg4"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(FIXTURES))  # libavcodec
sys.path.insert(0, str(REPO / "tests" / "torch_video"))  # make_fixtures.scene

import libavcodec  # noqa: E402
from make_fixtures import scene  # noqa: E402  (tests/torch_video)

from yolo_infer_tpu_torch.data import h263  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import bgr_to_yuv420  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
H263_FILES = [n for n in MANIFEST["files"] if open_video(FIXTURES / n).codec == "h263"]
# every case the decoder's docstring lists as decoded
CASES = ("i_picture", "p_picture", "gob_header", "dquant_mb", "escape", "inter_mb", "inter4v_mb", "skipped_mb",
         "intra_mb", "intra_mb_in_p")


def first_picture(name: str) -> bytes:
    return next(open_video(FIXTURES / name).packets())


def with_bit(packet: bytes, at: int) -> bytes:
    """The packet with bit `at` (from the first) set."""
    data = bytearray(packet)
    data[at >> 3] |= 0x80 >> (at & 7)
    return bytes(data)


def test_every_h263_case_is_met_across_the_fixtures():
    total = Counter()
    for name in H263_FILES:
        reader = open_video(FIXTURES / name)
        assert sum(1 for _ in reader.read()) == len(MANIFEST["files"][name]["frames"])
        total.update(reader.counts)
    assert {case: total[case] for case in CASES if not total[case]} == {}
    assert {"avi", "mov", "3gp"} <= {n.rsplit(".", 1)[1] for n in H263_FILES}


def test_the_short_header_under_an_mpeg4_tag_gives_no_frame():
    """libavcodec's MPEG-4 decoder finds no VOP in an H.263 stream: OpenCV
    returns no frame, nor does the port, and the stream format gives the size."""
    name = "short_header_128x96.avi"
    reader = open_video(FIXTURES / name)
    assert reader.codec == "mpeg4" and reader.fourcc == "FMP4"
    assert MANIFEST["files"][name]["frames"] == []
    assert list(reader.read()) == [] and reader.counts["short_header"] == reader.frame_count == 3
    assert (reader.width, reader.height) == (128, 96)


# bits from the picture start: PSC 0..21, TR 22..29, PTYPE 30..42 (the annex flags D, E, F, G at 39..42),
# PQUANT 43..47, CPM 48
@pytest.mark.parametrize("bit,match", [(39, "annex D"), (40, "annex E"), (41, "annex F"), (42, "annex G"),
                                       (48, "continuous presence")])
def test_picture_header_refusals_raise(bit, match):
    packet = first_picture("h263_128x96.avi")
    assert not (packet[bit >> 3] >> (7 - (bit & 7))) & 1
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP Queue 1 item 11\\.2"):
        h263.check_stream([packet, with_bit(packet, bit)])


@pytest.mark.skipif(not libavcodec.available(), reason="needs the libavcodec OpenCV's wheel bundles")
def test_four_vectors_with_dquant_equal_libavcodec():
    """The inter-4V-with-DQUANT MCBPC codes, which the `h263` encoder writes
    rarely under `+mv4` and an adaptive quantiser (too rarely for a small
    fixture: this CIF encode, from the fuzz tool's seed 5, has two such
    macroblocks), against libavcodec's `h263` decoder."""
    planes = [bgr_to_yuv420(f) for f in scene(6, 288, 352, 137)]
    packets = [p[0] for p in libavcodec.encode(planes, 352, 288, codec_name="h263", flags="+mv4", ps=50, qmin=4, qmax=9,
                                               p_mask=0.1, lumi_mask=0.3).packets]
    decoder = h263.H263Decoder()
    got = [decoder.decode(p) for p in packets]
    want = libavcodec.decode(packets, codec_name="h263")
    assert decoder.counts["inter4v_dquant_mb"] and len(got) == len(want)
    assert all((a == b).all() for x, y in zip(got, want) for a, b in zip(x, y))


def test_a_p_picture_before_any_i_picture_is_corrupt():
    packets = list(open_video(FIXTURES / "h263_128x96.avi").packets())
    with pytest.raises(ValueError, match="P picture before any I picture"):
        h263.H263Decoder().decode(packets[1])


_NO_OPENCV_CODE = """
import hashlib, json, sys
from pathlib import Path
for name in ("jax", "cv2", "yaml", "PIL", "yolo_infer_tpu"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video
fixtures = Path({repo!r}) / "tests" / "torch_mpeg4"
manifest = json.loads((fixtures / "manifest.json").read_text())
for name in {names!r}:
    hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in load_video(fixtures / name, rgb=False)]
    assert hashes == manifest["files"][name]["frames"], name
    assert get_video_info(fixtures / name) == manifest["files"][name]["info"], name
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_h263_and_divx_read_without_jax_or_opencv():
    """H.263 in AVI, MOV and 3GP, the short header, packed DivX and an old
    Lavc build, with jax, the JAX package, cv2, yaml and PIL blocked."""
    names = ["h263_gob_128x96.avi", "cv2_h263_176x144.mov", "h263_gob_176x144.3gp", "short_header_128x96.avi",
             "divx_packed_64x48.avi", "lavc_b4600_100x60.avi"]
    subprocess.run([sys.executable, "-I", "-c", _NO_OPENCV_CODE.format(repo=str(REPO), names=names)], check=True,
                   timeout=120, env=TORCH_SUBPROCESS_ENV)
