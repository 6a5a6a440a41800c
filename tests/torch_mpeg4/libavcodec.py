"""libavcodec's MPEG-4 Part 2 and H.263 encoders and decoders, a bitstream filter and libavformat's muxers through ctypes, from the copies OpenCV's wheel bundles.

OpenCV's FFmpeg writer drives the `mpeg4` encoder at one setting (no
B-VOPs, half-pel, H.263 quantisation, no video packets). The fixture maker
asks this encoder for the rest by option name (`av_opt_set` with the
children searched): `bf` (B-VOPs), `flags=+mv4+qpel` (4MV and quarter-pel
macroblocks), `mpeg_quant`, `data_partitioning`, `ps` (video packets of
about that many bits), `p_mask` and `lumi_mask` (an adaptive quantiser:
dquant), `qmin`/`qmax`. The decoder gives each output frame's Y, U and V
planes (the plane oracle of the tests), under a container codec tag if
asked (libavcodec takes Xvid's IDCT for an Xvid tag without encoder user
data). `idct` runs the IDCT the decoder picks (`auto`: the simple one, or
`xvid`) on blocks through the `AVDCT` API. `mux` writes packets through libavformat's own MP4 or Matroska
muxer, so that the `ctts`, the edit list and the block timestamps of a
B-VOP stream are FFmpeg's own (bit-exact muxing: the same bytes each run),
or through its 3GP muxer. `encode` and
`decode` take the codec by name: `mpeg4`, `h263` (H.263 baseline, the
five source formats; `ps` gives GOB headers, `flags=+mv4` four-vector
macroblocks without the annex flag, `obmc` annex F, which the port
refuses), `h263p` (H.263+, refused), or Microsoft's MPEG-4 family:
`msmpeg4v2`, `msmpeg4` (v3, DivX ;-)), `wmv1` and `wmv2` (options such as
`qmin`/`qmax`, `g`, `mbd`, `b`, and WMV2's `flags=+loop`; WMV2's extension
header is the encode's extradata; their decoders need `video_size`, since
the streams carry no size). `parameters` makes the codec parameters of a
stream no encoder here writes (AV1 key frames from the AVIF that OpenCV's
bundled libavif writes), for `mux`. `unpack_bframes` runs the
`mpeg4_unpack_bframes` bitstream filter over packets (DivX's packed
B-frames split, one VOP a packet).

The structure offsets used are those of the bundled build (libavcodec 62,
libavutil 60, libavformat 62); `available()` checks them and is False
where the libraries are missing or differ, and the callers then skip.
"""

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

AV_PIX_FMT_YUV420P = 0
AV_CODEC_ID_MPEG4 = 12
AV_CODEC_ID_H263 = 4
AV_CODEC_ID_H263P = 19
AV_NOPTS = -(1 << 63)
EAGAIN = -11
AVERROR_EOF = -0x20464F45  # FFERRTAG('E','O','F',' ')
AV_OPT_SEARCH_CHILDREN = 1
AVIO_FLAG_WRITE = 2
# AVCodecContext: codec_id, codec_tag; AVFrame: data, linesize, width, height, format, pict_type, pts;
# AVPacket: pts, dts, data, size, stream_index, flags; AVStream: index, codecpar, time_base;
# AVFormatContext: pb; AVCodecParameters: extradata, extradata_size
_CTX_ID, _CTX_TAG = 24, 28
_FR_DATA, _FR_LINES, _FR_W, _FR_H, _FR_FMT, _FR_TYPE, _FR_PTS = 0, 64, 104, 108, 116, 120, 136
_PK_PTS, _PK_DTS, _PK_DATA, _PK_SIZE, _PK_STREAM, _PK_FLAGS, _PK_DURATION = 8, 16, 24, 32, 36, 40, 64
_ST_INDEX, _ST_PAR, _ST_TB = 8, 16, 32
_FMT_PB = 32
_PAR_EXTRA, _PAR_EXTRA_SIZE = 16, 24
_PAR_ID = 4
_PAR_WIDTH, _PAR_HEIGHT = 72, 76
_CODEC_ID = 20  # AVCodec: name, long_name, type, id
_BSF_PAR_IN, _BSF_PAR_OUT = 24, 32  # AVBSFContext: av_class, filter, priv_data, par_in, par_out


def _library():
    try:
        import cv2
    except ImportError:
        return None
    root = Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs"
    libs = {}
    for name in ("avutil", "swresample", "avcodec", "avformat"):
        found = sorted(root.glob(f"lib{name}*.so*"))
        if not found:
            return None
        libs[name] = ctypes.CDLL(str(found[0]), mode=ctypes.RTLD_GLOBAL)
    if libs["avcodec"].avcodec_version() >> 16 != 62 or libs["avutil"].avutil_version() >> 16 != 60 \
            or libs["avformat"].avformat_version() >> 16 != 62:
        return None
    vp = ctypes.c_void_p
    for lib, names in ((libs["avcodec"], ("avcodec_find_encoder_by_name", "avcodec_find_decoder_by_name",
                                         "avcodec_alloc_context3", "av_packet_alloc", "av_bsf_get_by_name")),
                       (libs["avutil"], ("av_frame_alloc",)),
                       (libs["avformat"], ("avformat_new_stream",))):
        for name in names:
            getattr(lib, name).restype = vp
    return libs


_LIBS = _library()


def available() -> bool:
    return _LIBS is not None


def version() -> str:
    v = _LIBS["avcodec"].avcodec_version()
    return f"Lavc{v >> 16}.{v >> 8 & 0xFF}.{v & 0xFF}"


def _at(ptr: int, ctype, offset: int):
    return ctype.from_address(ptr + offset)


def _set_options(ctx: int, options: Dict[str, object]) -> None:
    util = _LIBS["avutil"]
    for name, value in options.items():
        if util.av_opt_set(ctypes.c_void_p(ctx), name.encode(), str(value).encode(), AV_OPT_SEARCH_CHILDREN):
            raise ValueError(f"libavcodec refused the option {name}={value}")


def _packet(pkt: int) -> Tuple[bytes, int, int, bool]:
    data = ctypes.string_at(_at(pkt, ctypes.c_void_p, _PK_DATA).value, _at(pkt, ctypes.c_int, _PK_SIZE).value)
    return data, _at(pkt, ctypes.c_int64, _PK_PTS).value, _at(pkt, ctypes.c_int64, _PK_DTS).value, \
        bool(_at(pkt, ctypes.c_int, _PK_FLAGS).value & 1)


class Encoded:
    """An encode's packets in decoding order (`packets`: data, pts, dts, key),
    its extradata (the headers, with `global_header`), time base and codec
    parameters (for a muxer)."""

    def __init__(self, packets, extradata: bytes, time_base: Tuple[int, int], par: int):
        self.packets, self.extradata, self.time_base, self._par = packets, extradata, time_base, par

    def __del__(self):
        if _LIBS is not None and self._par:
            _LIBS["avcodec"].avcodec_parameters_free(ctypes.byref(ctypes.c_void_p(self._par)))


def encode(frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], w: int, h: int, fps: Tuple[int, int] = (25, 1),
           global_header: bool = False, codec_name: str = "mpeg4", **options) -> Encoded:
    """The `codec_name` encoder (`mpeg4`, `h263`, `h263p`) over I420 frames
    ((Y, U, V) uint8 planes of (h, w) and (h/2, ceil(w/2))), with encoder
    options by name."""
    codec, util = _LIBS["avcodec"], _LIBS["avutil"]
    enc = codec.avcodec_find_encoder_by_name(codec_name.encode())
    if not enc:
        raise RuntimeError(f"no {codec_name} encoder")
    ctx = codec.avcodec_alloc_context3(ctypes.c_void_p(enc))
    flags = str(options.pop("flags", ""))
    if global_header:
        flags += "+global_header"
    opts = {"video_size": f"{w}x{h}", "pixel_format": "yuv420p", "time_base": f"{fps[1]}/{fps[0]}", "threads": 1,
            **({"flags": flags} if flags else {}), **options}
    _set_options(ctx, opts)
    if codec.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(enc), None):
        raise RuntimeError(f"avcodec_open2 refused the {codec_name} encoder with {opts}")
    frame = util.av_frame_alloc()
    pkt = codec.av_packet_alloc()
    packets = []
    keep = []

    def drain():
        while codec.avcodec_receive_packet(ctypes.c_void_p(ctx), ctypes.c_void_p(pkt)) == 0:
            packets.append(_packet(pkt))
            codec.av_packet_unref(ctypes.c_void_p(pkt))

    try:
        for i, (y, u, v) in enumerate(frames):
            _at(frame, ctypes.c_int, _FR_W).value, _at(frame, ctypes.c_int, _FR_H).value = w, h
            _at(frame, ctypes.c_int, _FR_FMT).value = AV_PIX_FMT_YUV420P
            _at(frame, ctypes.c_int64, _FR_PTS).value = i
            for k, plane in enumerate((y, u, v)):
                buf = ctypes.create_string_buffer(np.ascontiguousarray(plane, np.uint8).tobytes())
                keep.append(buf)
                _at(frame, ctypes.c_void_p, _FR_DATA + 8 * k).value = ctypes.addressof(buf)
                _at(frame, ctypes.c_int, _FR_LINES + 4 * k).value = plane.shape[1]
            if codec.avcodec_send_frame(ctypes.c_void_p(ctx), ctypes.c_void_p(frame)):
                raise RuntimeError("avcodec_send_frame failed")
            drain()
        codec.avcodec_send_frame(ctypes.c_void_p(ctx), None)
        drain()
        par = codec.avcodec_parameters_alloc
        par.restype = ctypes.c_void_p
        p = par()
        codec.avcodec_parameters_from_context(ctypes.c_void_p(p), ctypes.c_void_p(ctx))
        size = _at(p, ctypes.c_int, _PAR_EXTRA_SIZE).value
        extra = ctypes.string_at(_at(p, ctypes.c_void_p, _PAR_EXTRA).value, size) if size else b""
    finally:
        util.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
        codec.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))
        codec.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    return Encoded(packets, extra, (fps[1], fps[0]), p)


def parameters(codec_name: str, width: int, height: int, extradata: bytes = b"") -> int:
    """New codec parameters of a video stream of the `codec_name` decoder's
    codec, its size and extradata (an `Encoded`'s `_par`, which frees them)."""
    codec, util = _LIBS["avcodec"], _LIBS["avutil"]
    dec = codec.avcodec_find_decoder_by_name(codec_name.encode())
    if not dec:
        raise RuntimeError(f"no {codec_name} decoder")
    codec.avcodec_parameters_alloc.restype = ctypes.c_void_p
    p = codec.avcodec_parameters_alloc()
    _at(p, ctypes.c_int, 0).value = 0  # AVMEDIA_TYPE_VIDEO
    _at(p, ctypes.c_int, _PAR_ID).value = _at(dec, ctypes.c_int, _CODEC_ID).value
    _at(p, ctypes.c_int, _PAR_WIDTH).value, _at(p, ctypes.c_int, _PAR_HEIGHT).value = width, height
    if extradata:
        util.av_mallocz.restype = ctypes.c_void_p
        buf = util.av_mallocz(len(extradata) + 64)
        ctypes.memmove(buf, extradata, len(extradata))
        _at(p, ctypes.c_void_p, _PAR_EXTRA).value = buf
        _at(p, ctypes.c_int, _PAR_EXTRA_SIZE).value = len(extradata)
    return p


def decode(packets: Sequence[bytes], extradata: bytes = b"", codec_tag: Optional[bytes] = None,
           codec_name: str = "mpeg4", stop_on_error: bool = False, **options
           ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(Y, U, V) of each frame the `codec_name` decoder (`mpeg4`, `h263`,
    `msmpeg4v2`, `msmpeg4`, `wmv1`, `wmv2`) outputs for `packets` (in
    decoding order), the delayed frames drained
    at the end, as OpenCV's FFmpeg backend drains them; `codec_tag` is the
    container's fourcc, `options` decoder options by name. An empty packet
    is not sent (OpenCV's reader skips it). A packet the decoder refuses
    raises, or with `stop_on_error` ends the input, as it ends OpenCV's
    reading."""
    codec, util = _LIBS["avcodec"], _LIBS["avutil"]
    dec = codec.avcodec_find_decoder_by_name(codec_name.encode())
    codec_id = _at(dec, ctypes.c_int, _CODEC_ID).value
    ctx = codec.avcodec_alloc_context3(ctypes.c_void_p(dec))
    if _at(ctx, ctypes.c_int, _CTX_ID).value != codec_id:
        raise RuntimeError("unexpected AVCodecContext layout")
    if codec_tag is not None:
        _at(ctx, ctypes.c_uint32, _CTX_TAG).value = int.from_bytes(codec_tag, "little")
    keep = None
    if extradata:
        buf = util.av_mallocz
        buf.restype = ctypes.c_void_p
        keep = buf(len(extradata) + 64)
        ctypes.memmove(keep, extradata, len(extradata))
        _set_extradata(ctx, keep, len(extradata), codec_id)
    _set_options(ctx, {"threads": 1, **options})
    if codec.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(dec), None):
        raise RuntimeError(f"avcodec_open2 refused the {codec_name} decoder")
    frame = util.av_frame_alloc()
    pkt = codec.av_packet_alloc()
    out = []

    def drain():
        while codec.avcodec_receive_frame(ctypes.c_void_p(ctx), ctypes.c_void_p(frame)) == 0:
            w, h = _at(frame, ctypes.c_int, _FR_W).value, _at(frame, ctypes.c_int, _FR_H).value
            planes = []
            for k, (ph, pw) in enumerate(((h, w), ((h + 1) // 2, (w + 1) // 2), ((h + 1) // 2, (w + 1) // 2))):
                ptr, line = _at(frame, ctypes.c_void_p, _FR_DATA + 8 * k).value, _at(frame, ctypes.c_int,
                                                                                      _FR_LINES + 4 * k).value
                rows = np.frombuffer(ctypes.string_at(ptr, line * ph), np.uint8).reshape(ph, line)
                planes.append(rows[:, :pw].copy())
            out.append(tuple(planes))
            util.av_frame_unref(ctypes.c_void_p(frame))

    try:
        for data in packets:
            if not data:
                continue
            buf = ctypes.create_string_buffer(bytes(data) + bytes(64), len(data) + 64)
            _at(pkt, ctypes.c_void_p, _PK_DATA).value = ctypes.addressof(buf)
            _at(pkt, ctypes.c_int, _PK_SIZE).value = len(data)
            ret = codec.avcodec_send_packet(ctypes.c_void_p(ctx), ctypes.c_void_p(pkt))
            if ret and ret != EAGAIN:
                if stop_on_error:
                    break
                raise ValueError(f"libavcodec refused a packet ({ret})")
            drain()
        codec.avcodec_send_packet(ctypes.c_void_p(ctx), None)
        drain()
    finally:
        _at(pkt, ctypes.c_void_p, _PK_DATA).value = None
        util.av_frame_free(ctypes.byref(ctypes.c_void_p(frame)))
        codec.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))
        codec.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    return out


def _set_extradata(ctx: int, buf: int, size: int, codec_id: int = AV_CODEC_ID_MPEG4) -> None:
    """AVCodecContext.extradata / extradata_size, found by their neighbours'
    layout in this build: set through a parameters struct."""
    codec = _LIBS["avcodec"]
    codec.avcodec_parameters_alloc.restype = ctypes.c_void_p
    p = codec.avcodec_parameters_alloc()
    _at(p, ctypes.c_int, 0).value = 0  # AVMEDIA_TYPE_VIDEO
    _at(p, ctypes.c_int, _PAR_ID).value = codec_id
    _at(p, ctypes.c_void_p, _PAR_EXTRA).value = buf
    _at(p, ctypes.c_int, _PAR_EXTRA_SIZE).value = size
    codec.avcodec_parameters_to_context(ctypes.c_void_p(ctx), ctypes.c_void_p(p))
    _at(p, ctypes.c_void_p, _PAR_EXTRA).value = None
    _at(p, ctypes.c_int, _PAR_EXTRA_SIZE).value = 0
    codec.avcodec_parameters_free(ctypes.byref(ctypes.c_void_p(p)))


def mux(path: Path, encoded: Encoded, format_name: str) -> None:
    """Write `encoded`'s packets with libavformat's `format_name` muxer
    ("mp4", "matroska", "webm", "3gp", ...), each packet's pts and dts from the encoder,
    under the muxer's own tag for the codec."""
    fmt, codec = _LIBS["avformat"], _LIBS["avcodec"]
    oc = ctypes.c_void_p()
    if fmt.avformat_alloc_output_context2(ctypes.byref(oc), None, format_name.encode(), str(path).encode()):
        raise RuntimeError(f"no {format_name} muxer")
    if _LIBS["avutil"].av_opt_set(oc, b"fflags", b"+bitexact", 0):  # no random UIDs, no version strings
        raise RuntimeError("fflags +bitexact refused")
    st = fmt.avformat_new_stream(oc, None)
    if _at(st, ctypes.c_int, _ST_INDEX).value != 0:
        raise RuntimeError("unexpected AVStream layout")
    codec.avcodec_parameters_copy(ctypes.c_void_p(_at(st, ctypes.c_void_p, _ST_PAR).value),
                                  ctypes.c_void_p(encoded._par))
    tb_num, tb_den = encoded.time_base
    _at(st, ctypes.c_int, _ST_TB).value, _at(st, ctypes.c_int, _ST_TB + 4).value = tb_num, tb_den
    pb = ctypes.c_void_p.from_address(oc.value + _FMT_PB)
    if fmt.avio_open(ctypes.byref(pb), str(path).encode(), AVIO_FLAG_WRITE):
        raise RuntimeError(f"avio_open {path}")
    if fmt.avformat_write_header(oc, None) < 0:
        raise RuntimeError("avformat_write_header failed")
    st_num, st_den = _at(st, ctypes.c_int, _ST_TB).value, _at(st, ctypes.c_int, _ST_TB + 4).value
    pkt = codec.av_packet_alloc()
    try:
        for data, pts, dts, key in encoded.packets:
            buf = ctypes.create_string_buffer(data + bytes(64), len(data) + 64)
            _at(pkt, ctypes.c_void_p, _PK_DATA).value = ctypes.addressof(buf)
            _at(pkt, ctypes.c_int, _PK_SIZE).value = len(data)
            scale = lambda t: t * tb_num * st_den // (tb_den * st_num)  # noqa: E731
            _at(pkt, ctypes.c_int64, _PK_PTS).value = scale(pts)
            _at(pkt, ctypes.c_int64, _PK_DTS).value = scale(dts)
            _at(pkt, ctypes.c_int, _PK_STREAM).value = 0
            _at(pkt, ctypes.c_int, _PK_FLAGS).value = int(key)
            _at(pkt, ctypes.c_int64, _PK_DURATION).value = scale(1)
            if fmt.av_write_frame(oc, ctypes.c_void_p(pkt)) < 0:
                raise RuntimeError("av_write_frame failed")
        fmt.av_write_trailer(oc)
    finally:
        _at(pkt, ctypes.c_void_p, _PK_DATA).value = None
        codec.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))
        fmt.avio_closep(ctypes.byref(pb))
        fmt.avformat_free_context(oc)


def unpack_bframes(packets: Sequence[bytes], extradata: bytes = b"") -> Tuple[List[bytes], bytes]:
    """The `mpeg4_unpack_bframes` bitstream filter over MPEG-4 `packets` (in
    file order, an empty one passed as it is): the packets it gives and its
    extradata (the DivX user data's trailing 'p' removed)."""
    codec = _LIBS["avcodec"]
    bsf = codec.av_bsf_get_by_name(b"mpeg4_unpack_bframes")
    ctx = ctypes.c_void_p()
    if not bsf or codec.av_bsf_alloc(ctypes.c_void_p(bsf), ctypes.byref(ctx)):
        raise RuntimeError("no mpeg4_unpack_bframes filter")
    par_in = _at(ctx.value, ctypes.c_void_p, _BSF_PAR_IN).value
    _at(par_in, ctypes.c_int, _PAR_ID).value = AV_CODEC_ID_MPEG4
    if extradata:
        util = _LIBS["avutil"]
        util.av_mallocz.restype = ctypes.c_void_p
        buf = util.av_mallocz(len(extradata) + 64)
        ctypes.memmove(buf, extradata, len(extradata))
        _at(par_in, ctypes.c_void_p, _PAR_EXTRA).value = buf
        _at(par_in, ctypes.c_int, _PAR_EXTRA_SIZE).value = len(extradata)
    pkt = codec.av_packet_alloc()
    out = []
    try:
        if codec.av_bsf_init(ctx):
            raise RuntimeError("av_bsf_init refused mpeg4_unpack_bframes")
        par_out = _at(ctx.value, ctypes.c_void_p, _BSF_PAR_OUT).value
        size = _at(par_out, ctypes.c_int, _PAR_EXTRA_SIZE).value
        extra = ctypes.string_at(_at(par_out, ctypes.c_void_p, _PAR_EXTRA).value, size) if size else b""

        def drain():
            while codec.av_bsf_receive_packet(ctx, ctypes.c_void_p(pkt)) == 0:
                out.append(_packet(pkt)[0])
                codec.av_packet_unref(ctypes.c_void_p(pkt))

        for data in packets:
            codec.av_new_packet(ctypes.c_void_p(pkt), len(data))
            ctypes.memmove(_at(pkt, ctypes.c_void_p, _PK_DATA).value, data, len(data))
            if codec.av_bsf_send_packet(ctx, ctypes.c_void_p(pkt)):
                raise RuntimeError("av_bsf_send_packet failed")
            drain()
        codec.av_bsf_send_packet(ctx, None)
        drain()
    finally:
        codec.av_packet_free(ctypes.byref(ctypes.c_void_p(pkt)))
        codec.av_bsf_free(ctypes.byref(ctx))
    return out, extra


def idct(blocks: np.ndarray, algo: str = "auto") -> np.ndarray:
    """libavcodec's IDCT `algo` ("auto", "xvid", ...), as its decoders pick
    it on this machine (`avcodec_dct_init`), over (n, 8, 8) int16 blocks:
    each block permuted as the IDCT wants, transformed in place."""
    codec, util = _LIBS["avcodec"], _LIBS["avutil"]
    codec.avcodec_dct_alloc.restype = ctypes.c_void_p
    dct = codec.avcodec_dct_alloc()
    try:
        if util.av_opt_set(ctypes.c_void_p(dct), b"idct", algo.encode(), 0) or codec.avcodec_dct_init(
                ctypes.c_void_p(dct)):
            raise RuntimeError(f"avcodec_dct_init refused idct={algo}")
        # AVDCT: av_class, idct, idct_permutation[64]
        run = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(_at(dct, ctypes.c_void_p, 8).value)
        perm = np.frombuffer(ctypes.string_at(dct + 16, 64), np.uint8)
        out = np.empty((len(blocks), 8, 8), np.int16)
        buf = np.zeros(64 + 16, np.int16)
        aligned = buf[(-buf.ctypes.data // 2) % 8:][:64]  # 16-byte aligned, as the SIMD versions need
        for k, block in enumerate(np.asarray(blocks, np.int16)):
            aligned[perm] = block.reshape(64)
            run(aligned.ctypes.data)
            out[k] = aligned.reshape(8, 8)
        return out
    finally:
        util.av_free(ctypes.c_void_p(dct))
