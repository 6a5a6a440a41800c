"""Write the MPEG-4 Part 2 and H.263 fixtures of the port's decoders (`data/mpeg4.py`, `data/h263.py`) and their manifest.

    python tests/torch_mpeg4/make_fixtures.py

Writes small video files beside this script and `manifest.json`: for each
file the tool that made it, `get_video_info` as OpenCV reports it (the JAX
package's `yolo_infer_tpu.data.loader.get_video_info`), the sha256 and
shape of every frame `cv2.VideoCapture(path)` (the FFmpeg backend) decodes
(BGR), the decoder tallies (`Mpeg4Decoder.counts`) the file must reach
and, for an MPEG-4 file that takes libavcodec's bug workarounds, whether
its frames change when the port leaves each out
(`workarounds_change_frames`); under "raises", the files the port refuses
and what it raises. Every stream comes from libavcodec's own `mpeg4`,
`h263` or `h263p` encoder through ctypes (`libavcodec.py`), or from
`cv2.VideoWriter`, over `tests/torch_video/make_fixtures.py scene`
(seeded: it moves, so that 4MV, quarter-pel and direct mode are chosen;
`smooth` blurs it where the bytes matter):

  lavc     encoder options by name: B-VOPs (`bf`), 4MV and quarter-pel
           (`flags=+mv4+qpel`), MPEG quantisation (`mpeg_quant`), an
           adaptive quantiser (`p_mask`, `lumi_mask`, `tcplx_mask`,
           `scplx_mask`, `dark_mask`: dquant and dbquant), video packets
           (`ps`), data partitioning; black and white blocks (the 8x8
           averages of rounding type 1 over 0 samples, which libavcodec's x86
           code approximates: checked to matter); AVIs written by
           `tests/torch_video/make_fixtures.py build_avi` (packets in
           decoding order, as libavformat's AVI muxer writes them), an MP4
           and a Matroska file by libavformat's own muxers
  spliced  a libavcodec stream changed where no encoder here writes the
           syntax: its VOL rewritten with loaded intra and non-intra
           matrices (the VOPs unchanged), the header extension (HEC) set in
           its video packet headers, a B-VOP replaced by a not-coded VOP,
           dquant given to every macroblock of the port's own I-VOPs (AC
           prediction, which libavcodec's encoder does not code, rescaled
           between quantisers), its user data naming Xvid builds 1 and 64 (libavcodec then takes
           Xvid's IDCT and, at build 1, its edge, DC-clip and quarter-pel
           chroma workarounds); the 640x480 Xvid file is the video demo's
           input on the card (`chip_smoke.py mpeg4`); DivX user data with
           its B-VOPs packed as DivX writes them (`pack_divx`: a P- and a
           B-VOP in one chunk, an N-VOP placeholder after), with and
           without the 'p', DivX 6, a DivX 4 VOL (`divx4_vol`) under a
           `DIVX` tag, and old libavcodec builds, one of each workaround
           range (white blocks moving at a width that is not a multiple of
           16); the 640x480 packed DivX file is the card's second demo
  h263     the `h263` encoder at 128x96, 176x144 (in a 3GP by
           libavformat's muxer) and 352x288, with and without GOB headers
           (`ps`), at several quantisers, dquant and `+mv4`;
           `cv2.VideoWriter('H263')`'s own AVI and MOV; an `h263` stream
           under an `FMP4` tag (the short video header: OpenCV reads no
           frame of it)
  refused  a VOL with reversible VLC or sprites, H.263+ (the `h263p`
           encoder) and H.263's annex F (the `h263` encoder's `obmc`)

`tests/test_torch_mpeg4_asp.py` holds the port to the manifest, to the
JAX package and to libavcodec's decoders; `tests/test_torch_mpeg4_divx.py`
and `tests/test_torch_h263.py` hold the workaround effects, packing and
H.263 cases; `chip_smoke.py mpeg4` holds it to the manifest on the card's
host without OpenCV.
"""

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(REPO / "tests" / "torch_video"))

import libavcodec  # noqa: E402
from make_fixtures import build_avi, scene  # noqa: E402  (tests/torch_video)
from yolo_infer_tpu.data.loader import get_video_info  # noqa: E402
from yolo_infer_tpu_torch.data import mpeg4  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import (USER_DATA, VOL_FIRST, VOL_LAST, VOP_START, Mpeg4Decoder, _Bits,  # noqa: E402
                                             bgr_to_yuv420, start_codes)
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

ROADMAP = r"ROADMAP Queue 1 item 11\.2"
ASP = dict(bf=2, flags="+mv4+qpel", mpeg_quant=1, p_mask=0.5, lumi_mask=0.5, tcplx_mask=0.5, scplx_mask=0.5,
           dark_mask=0.5, ps=300)
DEMO = "xvid_asp_640x480.avi"
DARK = "lavc_dark_4mv_64x48.avi"
DIVX_DEMO = "divx_packed_640x480.avi"  # the packed DivX demo input on the card
DIVX_DEMO_FRAMES = 12
H263_CIF = "h263_352x288.avi"
# a custom intra matrix (64 values) and a non-intra one cut short by a 0 (its last value repeats)
INTRA_MATRIX = [8] + [12 + (i * 7) % 29 for i in range(1, 64)]
INTER_MATRIX = [16, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38]


def yuv(frames):
    return [bgr_to_yuv420(f) for f in frames]


def packets_of(encoded):
    return [p[0] for p in encoded.packets]


def bits_of(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def to_bytes(bits: str) -> bytes:
    return bytes(int(bits[k:k + 8], 2) for k in range(0, len(bits), 8))


def stuffed(bits: str) -> str:
    """bits, then next_start_code(): a 0 and 1s to the byte boundary."""
    return bits + "0" + "1" * ((7 - len(bits) % 8) % 8)


def units(packet: bytes):
    """(code, unit with its start code) of each start code unit of a packet."""
    return [(c, packet[s - 4:e]) for c, s, e in start_codes(packet)]


def replace_user_data(packets, text: bytes):
    """Every user data unit naming Lavc replaced by `text` (or dropped if empty)."""
    out = []
    for p in packets:
        parts = []
        for code, unit in units(p):
            if code == USER_DATA and unit[4:8] == b"Lavc":
                if text:
                    parts.append(b"\x00\x00\x01\xb2" + text)
            else:
                parts.append(unit)
        out.append(b"".join(parts))
    return out


def with_matrices(packets):
    """The VOL of every packet rewritten to load INTRA_MATRIX and
    INTER_MATRIX (zigzag order) after quant_type, the VOPs unchanged."""
    out = []
    for p in packets:
        parts = []
        for code, unit in units(p):
            if VOL_FIRST <= code <= VOL_LAST:
                bits = bits_of(unit[4:])
                at = vol_positions(unit[4:])["quant_type"] + 1
                assert bits[at - 1:at + 2] == "100", "an MPEG-quantised VOL with default matrices"
                load = "1" + "".join(f"{v:08b}" for v in INTRA_MATRIX) + "1" + "".join(
                    f"{v:08b}" for v in INTER_MATRIX) + "00000000"
                rest = bits[at + 2:].rstrip("1")[:-1]  # the VOL's own stuffing dropped
                unit = unit[:4] + to_bytes(stuffed(bits[:at] + load + rest))
            parts.append(unit)
        out.append(b"".join(parts))
    return out


def vol_positions(vol: bytes) -> dict:
    """Bit positions in a VOL payload (rectangular, progressive, as
    libavcodec writes it): `sprite` (sprite_enable), `quant_type`, and
    `partitioned` (data_partitioned), with the verid."""
    b = _Bits(vol)
    b.read(9)  # random_accessible_vol, video_object_type_indication
    verid = 1
    if b.bit():
        verid = b.read(4)
        b.read(3)
    if b.read(4) == 15:
        b.read(16)
    if b.bit():  # vol_control_parameters: chroma_format, low_delay, vbv_parameters
        b.read(3)
        if b.bit():
            b.read(79)
    b.read(2 + 1)  # shape, marker
    resolution = b.read(16)
    b.read(1)
    if b.bit():
        b.read(max((resolution - 1).bit_length(), 1))
    b.read(1 + 13 + 1 + 13 + 1 + 1 + 1)  # width, height and their markers, interlaced, obmc_disable
    at = {"verid": verid, "sprite": b.pos}
    b.read(1 if verid == 1 else 2)
    b.read(1)  # not_8_bit
    at["quant_type"] = b.pos
    if b.bit():
        for default in (mpeg4._DEFAULT_INTRA_MATRIX, mpeg4._DEFAULT_INTER_MATRIX):
            mpeg4._load_matrix(b, default)
    if verid != 1:
        b.read(1)  # quarter_sample
    b.read(2)  # complexity_estimation_disable, resync_marker_disable
    at["partitioned"] = b.pos
    return at


def vop_fields(vop: bytes, vol) -> dict:
    """The header fields of a VOP payload (after its start code)."""
    b = _Bits(vop)
    kind = b.read(2)
    seconds = 0
    while b.bit():
        seconds += 1
    b.bit()
    increment = b.read(vol.time_bits)
    b.bit()
    coded = b.bit()
    fields = {"kind": kind, "seconds": seconds, "increment": increment, "coded": coded}
    if coded:
        if kind == 1:
            b.bit()
        fields["dc_thr"] = b.read(3)
        b.read(5)
        fields["fcode"] = b.read(3) if kind else 0
        fields["bcode"] = b.read(3) if kind == 2 else 0
    return fields


def first_vol(packets):
    return next(mpeg4.Vol(u[4:]) for p in packets for c, u in units(p) if VOL_FIRST <= c <= VOL_LAST)


def packet_headers(packets):
    """For each packet, the port parser's video packet headers in its VOP:
    [(bit position of the stuffing before the resync marker, bit position
    after the header)], and the bit position where its macroblock data ends.
    Used only to place the header extension; the result is held to
    libavcodec's decoder."""
    found, ends = [], []
    start_packet, plain = Mpeg4Decoder._start_packet, Mpeg4Decoder._plain

    def record_start(self, b, vop, mb, after, q):
        found[-1].append((b.pos, after))
        return start_packet(self, b, vop, mb, after, q)

    def record_plain(self, b, vop):
        plain(self, b, vop)
        ends[-1] = b.pos

    Mpeg4Decoder._start_packet, Mpeg4Decoder._plain = record_start, record_plain
    try:
        decoder = Mpeg4Decoder()
        for p in packets:
            found.append([])
            ends.append(None)
            decoder.decode(p)
    finally:
        Mpeg4Decoder._start_packet, Mpeg4Decoder._plain = start_packet, plain
    return found, ends


def with_hec(packets, count):
    """The header extension code set, with the VOP's own fields, in every
    video packet header of the first `count` P- and B-VOPs that have any."""
    vol = first_vol(packets)
    headers, ends = packet_headers(packets)
    out = list(packets)
    which = [i for i, h in enumerate(headers) if h and any(
        c == VOP_START and packets[i][s] >> 6 in (1, 2) for c, s, _ in start_codes(packets[i]))][:count]
    assert len(which) == count, "too few VOPs with video packets"
    for i in which:
        (code, start, end), = [u for u in start_codes(packets[i]) if u[0] == VOP_START]
        vop = packets[i][start:end]
        bits = bits_of(vop)
        f = vop_fields(vop, vol)
        ext = ("1" * f["seconds"] + "0" + "1" + format(f["increment"], f"0{vol.time_bits}b") + "1"
               + format(f["kind"], "02b") + format(f["dc_thr"], "03b")
               + (format(f["fcode"], "03b") if f["kind"] else "") + (format(f["bcode"], "03b") if f["kind"] == 2 else ""))
        new, pos = "", 0
        for stuff_at, after in headers[i]:
            assert bits[after - 1] == "0"
            new += bits[pos:stuff_at]
            marker_at = stuff_at + 8 - stuff_at % 8
            new = stuffed(new) + bits[marker_at:after - 1] + "1" + ext
            pos = after
        new = stuffed(new + bits[pos:ends[i]])
        out[i] = packets[i][:start] + to_bytes(new) + packets[i][end:]
    return out


def with_intra_dquant(packets, deltas=(1, -1, 2, -2)):
    """Every macroblock of every I-VOP given dquant (the next of `deltas`
    in turn): its MCBPC swapped for the one with dquant and the 2 bits
    inserted after its CBPY, the levels unchanged (the port's writer codes
    AC prediction, which libavcodec's encoder does not, so its neighbours'
    AC predictors are rescaled between quantisers). From quantiser 2 the
    quantisers stay in 1..4, whose DC scaler is 8, so that no DC goes
    negative (libavcodec reads that as an error)."""
    marks, ends = [], []
    mcbpc, cbpy, plain = Mpeg4Decoder._mcbpc, Mpeg4Decoder._cbpy, Mpeg4Decoder._plain

    def record_mcbpc(self, b, vop, mb):
        at = b.pos
        out = mcbpc(self, b, vop, mb)
        marks[-1].append([at, b.pos, out])
        return out

    def record_cbpy(self, b, mb, intra):
        out = cbpy(self, b, mb, intra)
        marks[-1][-1].append(b.pos)
        return out

    def record_plain(self, b, vop):
        plain(self, b, vop)
        ends[-1] = b.pos

    Mpeg4Decoder._mcbpc, Mpeg4Decoder._cbpy, Mpeg4Decoder._plain = record_mcbpc, record_cbpy, record_plain
    try:
        decoder = Mpeg4Decoder()
        for p in packets:
            marks.append([])
            ends.append(None)
            decoder.decode(p)
    finally:
        Mpeg4Decoder._mcbpc, Mpeg4Decoder._cbpy, Mpeg4Decoder._plain = mcbpc, cbpy, plain
    out, k = [], 0
    for p, mbs, end in zip(packets, marks, ends):
        (code, start, stop), = [u for u in start_codes(p) if u[0] == VOP_START]
        if p[start] >> 6 != 0:
            out.append(p)
            continue
        bits, new, pos = bits_of(p[start:stop]), "", 0
        for at, after, cbpc, cbpy_end in mbs:
            c, n = mpeg4._INTRA_MCBPC[4 + (cbpc & 3)]
            delta = mpeg4._QUANT_DELTA.index(deltas[k % len(deltas)])
            k += 1
            new += bits[pos:at] + format(c, f"0{n}b") + bits[after:cbpy_end] + format(delta, "02b")
            pos = cbpy_end
        out.append(p[:start] + to_bytes(stuffed(new + bits[pos:end])) + p[stop:])
    return out


def not_coded_b(packets):
    """The first B-VOP replaced by a not-coded VOP of the same time."""
    vol = first_vol(packets)
    for i, p in enumerate(packets):
        for code, start, end in start_codes(p):
            if code == VOP_START and (p[start] >> 6) == 2:
                f = vop_fields(p[start:end], vol)
                bits = ("10" + "1" * f["seconds"] + "0" + "1" + format(f["increment"], f"0{vol.time_bits}b") + "1"
                        + "0")
                return packets[:i] + [p[:start] + to_bytes(stuffed(bits))] + packets[i + 1:]
    raise AssertionError("no B-VOP")


def with_vol_bit(packets, name):
    """Every VOL rewritten with one flag set: `sprite` (sprite_enable: static
    sprites) or `rvlc` (reversible_vlc, after a set data_partitioned)."""
    out = []
    for p in packets:
        parts = []
        for code, unit in units(p):
            if VOL_FIRST <= code <= VOL_LAST:
                bits = bits_of(unit[4:])
                at = vol_positions(unit[4:])
                if name == "sprite":
                    k = at["sprite"] + (at["verid"] != 1)
                else:
                    k = at["partitioned"] + 1
                    assert bits[at["partitioned"]] == "1"
                assert bits[k] == "0"
                unit = unit[:4] + to_bytes(bits[:k] + "1" + bits[k + 1:])
            parts.append(unit)
        out.append(b"".join(parts))
    return out


def vop_kind(packet: bytes) -> int:
    """The coding type of a packet's first VOP (0 I, 1 P, 2 B)."""
    return next(packet[s] >> 6 for c, s, _ in start_codes(packet) if c == VOP_START)


def nvop(packet: bytes, vol) -> bytes:
    """DivX's placeholder: a not-coded P-VOP with the time of the packet's VOP."""
    (code, start, end), = [u for u in start_codes(packet) if u[0] == VOP_START][:1]
    f = vop_fields(packet[start:end], vol)
    bits = "01" + "1" * f["seconds"] + "0" + "1" + format(f["increment"], f"0{vol.time_bits}b") + "1" + "0"
    return b"\x00\x00\x01\xb6" + to_bytes(stuffed(bits))


def pack_divx(packets):
    """Decoding-order packets packed as DivX 5 writes B-frames: a reference
    followed by B-VOPs shares its chunk with the first of them, any further
    B-VOP has a chunk of its own, then an N-VOP placeholder (so each frame
    keeps one chunk)."""
    vol = first_vol(packets)
    out, i = [], 0
    while i < len(packets):
        ref, i = packets[i], i + 1
        bs = []
        while i < len(packets) and vop_kind(packets[i]) == 2:
            bs.append(packets[i])
            i += 1
        if not bs:
            out.append(ref)
            continue
        out += [ref + bs[0]] + bs[1:] + [nvop(ref, vol)]
    return out


def divx4_vol(packets):
    """Every VOL rewritten as DivX 4 writes it: object type 0 and no
    vol_control_parameters (libavcodec then reads a `DIVX` tag as DivX 4)."""
    out = []
    for p in packets:
        parts = []
        for code, unit in units(p):
            if VOL_FIRST <= code <= VOL_LAST:
                bits = bits_of(unit[4:])
                b = _Bits(unit[4:])
                b.read(9)
                if b.bit():
                    b.read(7)
                if b.read(4) == 15:
                    b.read(16)
                at = b.pos
                assert bits[at] == "1" and bits[at + 4] == "0", "a VOL with control parameters and no vbv"
                rest = bits[at + 5:].rstrip("1")[:-1]  # the VOL's own stuffing dropped
                unit = unit[:4] + to_bytes(stuffed(bits[0] + "0" * 8 + bits[9:at] + "0" + rest))
            parts.append(unit)
        out.append(b"".join(parts))
    return out


def white_blocks(frames):
    """I420 planes of `frames` with a white block at the top left (DCs past 2047 at a coarse quantiser)."""
    for f in frames:
        f[:16, :32] = 255
    planes = yuv(frames)
    for y, _, _ in planes:
        y[:16, :32] = 255
    return planes


def smooth(frames):
    """`frames` blurred (a quarter-size round trip): cheaper to code than the scene's noise block."""
    return [cv2.resize(cv2.resize(f, (f.shape[1] // 4, f.shape[0] // 4), interpolation=cv2.INTER_AREA),
                       (f.shape[1], f.shape[0]), interpolation=cv2.INTER_LINEAR) for f in frames]


def h263(frames, w, h, **options):
    """The `h263` encoder's packets of BGR `frames`."""
    return packets_of(libavcodec.encode(yuv(frames), w, h, codec_name="h263", **options))


def write(name, packets, fourcc=b"FMP4", fps=25, size=None):
    w, h = size
    build_avi(HERE / name, packets, fourcc, w, h, fps)


def cv2_frames(path: Path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def make_videos():
    """{name: (tool, tallies it must reach)}."""
    made = {}
    # B-VOPs, 4MV, quarter-pel, MPEG quantisation, dquant, video packets
    e = libavcodec.encode(yuv(scene(14, 144, 176, 11)), 176, 144, **ASP)
    write("lavc_asp_176x144.avi", packets_of(e), size=(176, 144))
    made["lavc_asp_176x144.avi"] = ("lavc", ["b_vop", "b_direct", "b_direct_skip", "b_direct_delta", "b_forward",
                                             "b_backward", "b_interpolate", "b_colocated_skip", "b_direct_4mv",
                                             "inter4v_mb", "qpel_vop", "mpeg_quant_vop", "dquant_mb", "dbquant_mb",
                                             "video_packet",
                                             "mv_past_edge"])
    # the same with data partitioning, at a width that is not a multiple of 16
    e = libavcodec.encode(yuv(scene(12, 60, 100, 12)), 100, 60, data_partitioning=1, **{**ASP, "ps": 150})
    write("lavc_partitioned_100x60.avi", packets_of(e), size=(100, 60))
    made["lavc_partitioned_100x60.avi"] = ("lavc", ["partitioned_vop", "partition_packet", "video_packet", "b_vop",
                                                    "qpel_vop", "inter4v_mb", "intra_mb_in_p"])
    # loaded matrices, the header extension and a not-coded VOP
    e = libavcodec.encode(yuv(scene(9, 48, 64, 13)), 64, 48, bf=1, mpeg_quant=1, ps=100, flags="+qpel")
    packets = with_hec(not_coded_b(with_matrices(packets_of(e))), 2)
    write("spliced_asp_64x48.avi", packets, size=(64, 48))
    made["spliced_asp_64x48.avi"] = ("spliced", ["loaded_matrix_vop", "hec", "not_coded_vop", "b_vop",
                                                 "video_packet"])
    # dquant in I-VOPs with AC prediction: the port's own writer (which codes AC prediction) spliced
    encoder = mpeg4.Mpeg4Encoder(64, 48, 25, quant=2)
    packets = [encoder.encode(f) for f in scene(3, 48, 64, 21)]
    packets[0] = encoder.headers() + packets[0]
    write("port_acpred_dquant_64x48.avi", with_intra_dquant(packets), size=(64, 48))
    made["port_acpred_dquant_64x48.avi"] = ("spliced", ["dquant_mb", "ac_pred_mb", "ac_pred_rescaled"])
    # Xvid build 1: its IDCT and the edge, DC-clip and quarter-pel chroma workarounds (white blocks at
    # a coarse quantiser give DCs past 2047)
    frames = scene(12, 60, 100, 14)
    for f in frames:
        f[:16, :32] = 255
    planes = yuv(frames)
    for y, _, _ in planes:
        y[:16, :32] = 255
    e = libavcodec.encode(planes, 100, 60, bf=2, flags="+mv4+qpel", qmin=29, qmax=31)
    write("xvid_b1_100x60.avi", replace_user_data(packets_of(e), b"XviD0001"), fourcc=b"XVID", size=(100, 60))
    made["xvid_b1_100x60.avi"] = ("spliced", ["xvid_idct_vop", "xvid_edge", "xvid_dc_clip", "xvid_qpel_chroma",
                                              "b_vop", "qpel_vop"])
    # black and white blocks moving over the scene: 8x8 averages under rounding type 1 over 0 samples,
    # which libavcodec's x86 code approximates (checked below: exact averages give other frames)
    planes = yuv(scene(8, 48, 64, 20))
    for i, frame in enumerate(planes):
        for k, plane in enumerate(frame):
            h, w = plane.shape
            plane[(2 * i + k) % (h - 4):(2 * i + k) % (h - 4) + h // 3, (3 * i) % (w - 4):(3 * i) % (w - 4) + w // 3] = 0
            plane[h // 2:h // 2 + h // 4, w // 2:] = 255
    e = libavcodec.encode(planes, 64, 48, flags="+mv4", qmin=2, qmax=4)
    write(DARK, packets_of(e), size=(64, 48))
    made[DARK] = ("lavc", ["inter4v_mb", "rounding_1"])
    # the MP4 and Matroska muxers (B-VOPs: ctts, an edit list, block timestamps out of order)
    e = libavcodec.encode(yuv(scene(13, 144, 176, 15)), 176, 144, fps=(30000, 1001), global_header=True, **ASP)
    libavcodec.mux(HERE / "lavc_asp_176x144_2997.mp4", e, "mp4")
    made["lavc_asp_176x144_2997.mp4"] = ("lavc", ["b_vop", "qpel_vop", "inter4v_mb"])
    e = libavcodec.encode(yuv(scene(10, 48, 64, 16)), 64, 48, global_header=True, bf=2, flags="+qpel")
    libavcodec.mux(HERE / "lavc_asp_64x48.mkv", e, "matroska")
    made["lavc_asp_64x48.mkv"] = ("lavc", ["b_vop", "qpel_vop"])
    # the demo: Xvid build 64 (its IDCT, no workaround), B-VOPs, quarter-pel and 4MV at 640x480
    e = libavcodec.encode(yuv(scene(24, 480, 640, 17)), 640, 480, fps=(30, 1), bf=2, flags="+mv4+qpel", qmin=10,
                          qmax=31, b=300000)
    write(DEMO, replace_user_data(packets_of(e), b"XviD0064"), fourcc=b"XVID", fps=30, size=(640, 480))
    made[DEMO] = ("spliced", ["xvid_idct_vop", "b_vop", "qpel_vop", "inter4v_mb", "b_direct"])
    made.update(make_divx())
    made.update(make_old_builds())
    made.update(make_h263())
    return made


def make_divx():
    """DivX user data and tags: packed B-frames (a P- and a B-VOP in one
    chunk, an N-VOP after them), DivX 6, unflagged packing, DivX 4."""
    made = {}
    # DivX 5.03 build 1393, packed: quarter-pel chroma 2 (it overrides 1)
    e = libavcodec.encode(yuv(scene(9, 48, 64, 30)), 64, 48, bf=1, flags="+mv4+qpel")
    write("divx_packed_64x48.avi", pack_divx(replace_user_data(packets_of(e), b"DivX503b1393p")), fourcc=b"DX50",
          size=(64, 48))
    made["divx_packed_64x48.avi"] = ("spliced", ["packed_vop", "divx_qpel_chroma2", "divx_hpel_chroma", "b_vop",
                                                 "b_direct"])
    # DivX 6, two B-VOPs a reference: the second B-VOP in a chunk of its own
    e = libavcodec.encode(yuv(scene(8, 60, 100, 31)), 100, 60, bf=2, flags="+mv4+qpel", qmin=8)
    write("divx6_packed_100x60.avi", pack_divx(replace_user_data(packets_of(e), b"DivX609Build1896p")),
          fourcc=b"DIVX", size=(100, 60))
    made["divx6_packed_100x60.avi"] = ("spliced", ["packed_vop", "divx_hpel_chroma", "b_vop", "b_direct"])
    # DivX 5.01 build 1600 without the 'p': the packed B-VOPs are dropped; quarter-pel chroma 1
    e = libavcodec.encode(yuv(scene(7, 60, 100, 32)), 100, 60, bf=1, flags="+qpel", qmin=8)
    write("divx501_unflagged_100x60.avi", pack_divx(replace_user_data(packets_of(e), b"DivX501b1600")),
          fourcc=b"DX50", size=(100, 60))
    made["divx501_unflagged_100x60.avi"] = ("spliced", ["divx_qpel_chroma", "not_coded_vop"])
    # DivX 4: a DIVX tag over an object type 0 VOL with no user data: the picture's own edge
    e = libavcodec.encode(yuv(scene(6, 60, 100, 33)), 100, 60, flags="+mv4", qmin=8)
    write("divx4_100x60.avi", divx4_vol(replace_user_data(packets_of(e), b"")), fourcc=b"DIVX", size=(100, 60))
    made["divx4_100x60.avi"] = ("spliced", ["divx_edge", "divx_hpel_chroma", "inter4v_mb"])
    # the demo: packed DivX at 640x480
    e = libavcodec.encode(yuv(smooth(scene(DIVX_DEMO_FRAMES, 480, 640, 34))), 640, 480, fps=(30, 1), bf=1,
                          flags="+mv4+qpel", qmin=24, qmax=31, b=100000)
    write(DIVX_DEMO, pack_divx(replace_user_data(packets_of(e), b"DivX503b1393p")), fourcc=b"DX50", fps=30,
          size=(640, 480))
    made[DIVX_DEMO] = ("spliced", ["packed_vop", "divx_qpel_chroma2", "b_vop", "qpel_vop", "inter4v_mb"])
    return made


def make_old_builds():
    """Old libavcodec builds in the user data, one of each workaround range:
    white blocks at a coarse quantiser (DCs past 2047) moving at a width that
    is not a multiple of 16, quarter-pel, 4MV and B-VOPs."""
    made = {}
    planes = white_blocks(scene(9, 60, 100, 35))
    packets = packets_of(libavcodec.encode(planes, 100, 60, bf=1, flags="+mv4+qpel", qmin=29, qmax=31))
    for name, text, reach in (
            ("lavc_b4600_100x60.avi", b"ffmpeg", ["lavc_std_qpel", "lavc_direct_blocksize", "lavc_edge",
                                                   "lavc_dc_clip"]),
            ("lavc_b4654_100x60.avi", b"FFmpeg0.4.9-pre1b4654", ["lavc_direct_blocksize", "lavc_edge",
                                                                  "lavc_dc_clip"]),
            ("lavc_b4669_100x60.avi", b"FFmpeg v0.4.9 / libavcodec build: 4669", ["lavc_edge", "lavc_dc_clip"]),
            ("lavc_b4712_100x60.avi", b"FFmpeg0.4.9b4712", ["lavc_dc_clip"])):
        write(name, replace_user_data(packets, text), size=(100, 60))
        made[name] = ("spliced", reach + ["b_vop", "qpel_vop"])
    # Lavc 56.60.100 (FFmpeg 2.8): its intra edge workaround (no effect on these frames)
    e = libavcodec.encode(yuv(scene(6, 48, 64, 18)), 64, 48, bf=1)
    write("lavc_old_build_64x48.avi", replace_user_data(packets_of(e), b"Lavc56.60.100"), size=(64, 48))
    made["lavc_old_build_64x48.avi"] = ("spliced", ["lavc_iedge", "b_vop"])
    return made


def make_h263():
    """H.263 baseline from the `h263` encoder (AVI by this script's writer,
    3GP by libavformat's muxer) and from `cv2.VideoWriter('H263')` (AVI,
    MOV), and the short video header: an `h263` stream under an MPEG-4 tag."""
    made = {}
    write("h263_128x96.avi", h263(scene(3, 96, 128, 40), 128, 96, qmin=2, qmax=3, flags="+mv4"), fourcc=b"H263",
          size=(128, 96))
    made["h263_128x96.avi"] = ("h263", ["i_picture", "p_picture", "escape", "inter4v_mb", "skipped_mb"])
    write("h263_gob_128x96.avi", h263(scene(3, 96, 128, 41), 128, 96, ps=200, p_mask=0.5, lumi_mask=0.3),
          fourcc=b"h263", size=(128, 96))
    made["h263_gob_128x96.avi"] = ("h263", ["gob_header", "dquant_mb", "escape", "intra_mb_in_p"])
    write(H263_CIF, h263(smooth(scene(4, 288, 352, 42)), 352, 288, ps=1000, qmin=12, qmax=20), fourcc=b"H263",
          size=(352, 288))
    made[H263_CIF] = ("h263", ["gob_header", "i_picture", "p_picture"])
    e = libavcodec.encode(yuv(scene(3, 144, 176, 43)), 176, 144, codec_name="h263", qmin=16, qmax=24, ps=300)
    libavcodec.mux(HERE / "h263_gob_176x144.3gp", e, "3gp")
    made["h263_gob_176x144.3gp"] = ("h263", ["gob_header", "i_picture", "p_picture"])
    for suffix in (".avi", ".mov"):
        writer = cv2.VideoWriter(str(HERE / f"cv2_h263_176x144{suffix}"), cv2.VideoWriter_fourcc(*"H263"), 25,
                                 (176, 144))
        assert writer.isOpened()
        for f in smooth(scene(3, 144, 176, 44)):
            writer.write(f)
        writer.release()
        made[f"cv2_h263_176x144{suffix}"] = ("cv2", ["i_picture", "p_picture"])
    write("short_header_128x96.avi", h263(scene(3, 96, 128, 45), 128, 96, qmin=10, qmax=12), size=(128, 96))
    made["short_header_128x96.avi"] = ("h263", ["short_header"])
    return made


def make_refused():
    """{name: (exception, regex)} of the files the port refuses before any frame."""
    raises = {}
    e = libavcodec.encode(yuv(scene(3, 48, 64, 18)), 64, 48, bf=1)
    packets = packets_of(e)
    write("sprite_vol_64x48.avi", with_vol_bit(packets, "sprite"), size=(64, 48))
    raises["sprite_vol_64x48.avi"] = ("NotImplementedError", f"sprites.*{ROADMAP}")
    e = libavcodec.encode(yuv(scene(3, 48, 64, 19)), 64, 48, data_partitioning=1)
    write("reversible_vlc_64x48.avi", with_vol_bit(packets_of(e), "rvlc"), size=(64, 48))
    raises["reversible_vlc_64x48.avi"] = ("NotImplementedError", f"reversible VLC.*{ROADMAP}")
    frames = scene(2, 96, 128, 46)
    write("h263p_128x96.avi", packets_of(libavcodec.encode(yuv(frames), 128, 96, codec_name="h263p", qmin=12)),
          fourcc=b"H263", size=(128, 96))
    raises["h263p_128x96.avi"] = ("NotImplementedError", f"H.263\\+.*PLUSPTYPE.*{ROADMAP}")
    write("h263_obmc_128x96.avi", h263(scene(2, 96, 128, 47), 128, 96, obmc=1, qmin=12), fourcc=b"H263",
          size=(128, 96))
    raises["h263_obmc_128x96.avi"] = ("NotImplementedError", f"advanced prediction \\(annex F.*{ROADMAP}")
    return raises


def workaround_effects(name, hashes):
    """{workaround: whether the port's frames of `name` change without it}
    for each libavcodec workaround the file's decode takes (the IDCT aside)."""
    reader = open_video(HERE / name)
    decoder = Mpeg4Decoder(reader.config, reader.fourcc)
    for p in reader.packets():
        decoder.decode(p)
    real = mpeg4.workarounds
    effects = {}
    for flag in sorted(set(decoder._bugs) - {"xvid_idct"}):
        def without(ids, fourcc, vol, bugs, flag=flag):
            real(ids, fourcc, vol, bugs)
            bugs.pop(flag, None)

        mpeg4.workarounds = without
        try:
            frames = [hashlib.sha256(f.tobytes()).hexdigest() for f in open_video(HERE / name).read(rgb=False)]
        finally:
            mpeg4.workarounds = real
        effects[flag] = frames != hashes
    return effects


def main() -> None:
    assert libavcodec.available(), "needs the libavcodec OpenCV's wheel bundles"
    for old in HERE.iterdir():
        if old.suffix in (".avi", ".mp4", ".mkv", ".mov", ".3gp"):
            old.unlink()
    made = make_videos()
    files = {}
    for name, (tool, reach) in made.items():
        frames = cv2_frames(HERE / name)
        reader = open_video(HERE / name)
        mine = list(reader.read(rgb=False))
        hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]
        assert [hashlib.sha256(f.tobytes()).hexdigest() for f in mine] == hashes, name
        missing = [k for k in reach if not reader.counts[k]]
        assert not missing, (name, missing, dict(reader.counts))
        files[name] = {"tool": tool, "info": get_video_info(HERE / name),
                       "shape": list(frames[0].shape) if frames else None, "frames": hashes, "reach": reach}
        if reader.codec == "mpeg4":
            changed = workaround_effects(name, hashes)
            if changed:
                files[name]["workarounds_change_frames"] = changed
        if any(k == "packed_vop" for k in reach):
            unpacked, extra = libavcodec.unpack_bframes(list(reader.packets()), reader.config)
            want = [hashlib.sha256(mpeg4.yuv420_to_bgr(*p).tobytes()).hexdigest()
                    for p in libavcodec.decode(unpacked, extra, reader.fourcc.encode())]
            assert want == hashes, f"{name}: its mpeg4_unpack_bframes output decodes to other frames"
    exact = mpeg4.mc.halfpel

    def exact_averages(ref, sx, sy, dx, dy, size, rounding):
        g = mpeg4.mc.gather(ref, sx, sy, size + 1)
        a, r, d, rd = g[:, :size, :size], g[:, :size, 1:], g[:, 1:, :size], g[:, 1:, 1:]
        dx, dy = dx[:, None, None], dy[:, None, None]
        return np.where(dx & dy, (a + r + d + rd + 2 - rounding) >> 2, np.where(
            dx, (a + r + 1 - rounding) >> 1, np.where(dy, (a + d + 1 - rounding) >> 1, a)))

    mpeg4.mc.halfpel = exact_averages
    try:
        plain = [hashlib.sha256(f.tobytes()).hexdigest() for f in open_video(HERE / DARK).read(rgb=False)]
    finally:
        mpeg4.mc.halfpel = exact
    assert plain != files[DARK]["frames"], "exact averages decode the dark file as OpenCV does"
    raises = make_refused()
    manifest = {"libavcodec": libavcodec.version(), "files": files,
                "raises": {k: {"error": e, "match": m} for k, (e, m) in raises.items()}}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.is_file() and p.suffix != ".pyc")
    print(f"{len(files)} videos, {len(raises)} refused files, {total} bytes")


if __name__ == "__main__":
    main()
