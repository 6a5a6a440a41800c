"""libvpx's VP8 encoder and decoder through ctypes, from the copy OpenCV's wheel bundles.

OpenCV's FFmpeg backend writes VP8 through libvpx at one setting (version
0, one token partition, no altref); the fixture maker asks this encoder for
the rest: versions 1-3, 8 token partitions, error resilience (probabilities
restored after every frame, segmentation), a filter sharpness, and a
two-pass encode with an automatic altref (hidden frames). The decoder gives
each frame's Y, U and V planes, which the tests hold the port's to.

`available()` is False where the library is missing; the callers then skip.
"""

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

VPX_IMG_FMT_I420 = 0x102
VPX_DL_GOOD_QUALITY = 1000000
VP8E_SET_ENABLEAUTOALTREF, VP8E_SET_SHARPNESS, VP8E_SET_TOKEN_PARTITIONS = 14, 16, 18
_FRAME_PKT, _STATS_PKT = 0, 1
_KEY_FLAG = 1  # VPX_FRAME_IS_KEY
# vpx_codec_enc_cfg_t's leading fields, as uint32 slots
_PROFILE, _WIDTH, _HEIGHT, _ERROR_RESILIENT, _PASS, _LAG = 2, 3, 4, 9, 10, 11
_STATS_IN = 80  # byte offset of rc_twopass_stats_in (buf, sz)


class _Image(ctypes.Structure):
    _fields_ = [("fmt", ctypes.c_int), ("cs", ctypes.c_int), ("range", ctypes.c_int), ("w", ctypes.c_uint),
                ("h", ctypes.c_uint), ("bit_depth", ctypes.c_uint), ("d_w", ctypes.c_uint), ("d_h", ctypes.c_uint),
                ("r_w", ctypes.c_uint), ("r_h", ctypes.c_uint), ("x_chroma_shift", ctypes.c_uint),
                ("y_chroma_shift", ctypes.c_uint), ("planes", ctypes.c_void_p * 4), ("stride", ctypes.c_int * 4)]


def _library() -> Optional[ctypes.CDLL]:
    try:
        import cv2
    except ImportError:
        return None
    libs = sorted((Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs").glob("libvpx*.so*"))
    if not libs:
        return None
    lib = ctypes.CDLL(str(libs[0]))
    lib.vpx_codec_vp8_cx.restype = lib.vpx_codec_vp8_dx.restype = ctypes.c_void_p
    lib.vpx_img_wrap.restype = lib.vpx_codec_get_cx_data.restype = ctypes.c_void_p
    lib.vpx_codec_get_frame.restype = ctypes.POINTER(_Image)
    lib.vpx_codec_version_str.restype = ctypes.c_char_p
    return lib


_LIB = _library()


def available() -> bool:
    return _LIB is not None


def version() -> str:
    return _LIB.vpx_codec_version_str().decode()


def decode(frames: List[bytes], iface: Optional[int] = None) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(Y, U, V) of each frame libvpx's decoder outputs (none for a hidden
    frame): VP8's, or the decoder interface `iface` (VP9's)."""
    ctx = ctypes.create_string_buffer(1024)
    iface = _LIB.vpx_codec_vp8_dx() if iface is None else iface
    for abi in range(8, 40):  # VPX_DECODER_ABI_VERSION differs between releases
        if _LIB.vpx_codec_dec_init_ver(ctx, ctypes.c_void_p(iface), None, 0, abi) == 0:
            break
    else:
        raise RuntimeError("vpx_codec_dec_init_ver failed")
    out = []
    try:
        for data in frames:
            if _LIB.vpx_codec_decode(ctx, data, len(data), None, 0):
                raise ValueError("libvpx refused a frame")
            it = ctypes.c_void_p(0)
            while True:
                img = _LIB.vpx_codec_get_frame(ctx, ctypes.byref(it))
                if not img:
                    break
                img = img.contents
                cw, ch = (img.d_w + 1) // 2, (img.d_h + 1) // 2
                planes = []
                for k, (w, h) in enumerate(((img.d_w, img.d_h), (cw, ch), (cw, ch))):
                    buf = (ctypes.c_uint8 * (img.stride[k] * h)).from_address(img.planes[k])
                    planes.append(np.frombuffer(buf, np.uint8).reshape(h, img.stride[k])[:, :w].copy())
                out.append(tuple(planes))
    finally:
        _LIB.vpx_codec_destroy(ctx)
    return out


def _encode_pass(frames_i420, w: int, h: int, profile: int, partitions: int, lag: int, altref: bool,
                 error_resilient: bool, sharpness: Optional[int], passno: int, stats: Optional[bytes]):
    cfg = (ctypes.c_uint32 * 512)()
    if _LIB.vpx_codec_enc_config_default(ctypes.c_void_p(_LIB.vpx_codec_vp8_cx()), cfg, 0):
        raise RuntimeError("vpx_codec_enc_config_default failed")
    cfg[_PROFILE], cfg[_WIDTH], cfg[_HEIGHT] = profile, w, h
    cfg[_ERROR_RESILIENT], cfg[_PASS], cfg[_LAG] = int(error_resilient), passno, lag
    keep = None
    if stats is not None:
        keep = ctypes.create_string_buffer(stats, len(stats))
        ctypes.c_void_p.from_address(ctypes.addressof(cfg) + _STATS_IN).value = ctypes.addressof(keep)
        ctypes.c_size_t.from_address(ctypes.addressof(cfg) + _STATS_IN + 8).value = len(stats)
    ctx = ctypes.create_string_buffer(1024)
    for abi in range(8, 60):  # VPX_ENCODER_ABI_VERSION differs between releases
        if _LIB.vpx_codec_enc_init_ver(ctx, ctypes.c_void_p(_LIB.vpx_codec_vp8_cx()), cfg, 0, abi) == 0:
            break
    else:
        raise RuntimeError("vpx_codec_enc_init_ver failed")
    for ctrl, value in ((VP8E_SET_TOKEN_PARTITIONS, partitions), (VP8E_SET_ENABLEAUTOALTREF, int(altref)),
                        (VP8E_SET_SHARPNESS, sharpness)):
        if value and _LIB.vpx_codec_control_(ctx, ctrl, ctypes.c_int(value)):
            raise RuntimeError(f"vpx_codec_control_ {ctrl} failed")
    packets, stats_out = [], []
    img = ctypes.create_string_buffer(512)

    def drain():
        it = ctypes.c_void_p(0)
        while True:
            pkt = _LIB.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
            if not pkt:
                return
            kind = ctypes.c_int.from_address(pkt).value
            buf, size = ctypes.c_void_p.from_address(pkt + 8).value, ctypes.c_size_t.from_address(pkt + 16).value
            if kind == _FRAME_PKT:
                packets.append((ctypes.string_at(buf, size), bool(ctypes.c_uint32.from_address(pkt + 40).value
                                                                  & _KEY_FLAG)))
            elif kind == _STATS_PKT:
                stats_out.append(ctypes.string_at(buf, size))

    try:
        for i, f in enumerate(frames_i420):
            data = ctypes.create_string_buffer(f.tobytes())
            p = _LIB.vpx_img_wrap(img, VPX_IMG_FMT_I420, w, h, 1, data)
            if _LIB.vpx_codec_encode(ctx, ctypes.c_void_p(p), ctypes.c_int64(i), ctypes.c_ulong(1), ctypes.c_long(0),
                                     ctypes.c_ulong(VPX_DL_GOOD_QUALITY)):
                raise RuntimeError("vpx_codec_encode failed")
            drain()
        _LIB.vpx_codec_encode(ctx, None, ctypes.c_int64(-1), ctypes.c_ulong(1), ctypes.c_long(0),
                              ctypes.c_ulong(VPX_DL_GOOD_QUALITY))
        drain()
    finally:
        _LIB.vpx_codec_destroy(ctx)
    del keep
    return packets, b"".join(stats_out)


def encode(frames_i420, w: int, h: int, profile: int = 0, partitions: int = 0, altref: bool = False,
           error_resilient: bool = False, sharpness: Optional[int] = None) -> List[Tuple[bytes, bool]]:
    """VP8 frames (data, is key) of I420 frames (each Y, U, V flattened),
    one pass, or two with `altref` (which needs the first pass's stats)."""
    args = (frames_i420, w, h, profile, partitions)
    if not altref:
        return _encode_pass(*args, 0, False, error_resilient, sharpness, 0, None)[0]
    _, stats = _encode_pass(*args, 25, True, error_resilient, sharpness, 1, None)
    return _encode_pass(*args, 25, True, error_resilient, sharpness, 2, stats)[0]
