"""libvpx's VP9 encoder and decoder through ctypes, from the copy OpenCV's wheel bundles.

OpenCV's `VP90` writer drives libvpx at one setting (profile 0, no
hidden frames, frame-parallel mode, no segmentation). The fixture maker
asks this encoder for the rest: an automatic altref with lag, one layer
or several (superframes, hidden frames, compound prediction, frame
contexts 1-3, show_existing_frame), error resilience, frame-parallel
mode off (backward adaptation), lossless coding, an AQ mode and an active
map (segmentation), and the library's defaults. It also writes the odd
width OpenCV's writer rounds down.
The decoder gives each shown frame's Y, U and V planes, which the tests
hold the port's to. The shared ctypes plumbing is `tests/torch_vp8/libvpx.py`.

`available()` is False where the library is missing; the callers then skip.
"""

import ctypes
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

sys.path.append(str(Path(__file__).resolve().parent.parent / "torch_vp8"))
import libvpx  # noqa: E402  (tests/torch_vp8: the library, its image struct, the config slots)

VP8E_SET_ACTIVEMAP, VP8E_SET_CPUUSED, VP8E_SET_ENABLEAUTOALTREF = 9, 13, 14
VPX_DL_REALTIME = 1
VP9E_SET_LOSSLESS, VP9E_SET_FRAME_PARALLEL_DECODING, VP9E_SET_AQ_MODE = 32, 35, 36
_MIN_Q, _MAX_Q = 29, 30  # vpx_codec_enc_cfg_t's rc_min_quantizer and rc_max_quantizer, as uint32 slots
_LIB = libvpx._LIB
if _LIB is not None:
    _LIB.vpx_codec_vp9_cx.restype = _LIB.vpx_codec_vp9_dx.restype = ctypes.c_void_p


def available() -> bool:
    return _LIB is not None


def version() -> str:
    return libvpx.version()


def decode(frames: List[bytes]) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(Y, U, V) of each frame libvpx's VP9 decoder outputs (a superframe's hidden frame gives none)."""
    return libvpx.decode(frames, _LIB.vpx_codec_vp9_dx())


class _ActiveMap(ctypes.Structure):  # vpx_active_map_t
    _fields_ = [("active_map", ctypes.c_void_p), ("rows", ctypes.c_uint), ("cols", ctypes.c_uint)]


def encode(frames_i420, w: int, h: int, altref: int = 0, error_resilient: bool = False,
           frame_parallel: Optional[bool] = True, lossless: bool = False, aq_mode: Optional[int] = None,
           speed: Optional[int] = 4, realtime: bool = False, quantizer: Optional[int] = None,
           active_map: Optional[np.ndarray] = None) -> List[Tuple[bytes, bool]]:
    """VP9 frames (data, is key) of I420 frames (each Y, U, V flattened):
    one pass without lag, or with `altref` two passes with a lag of 25
    frames (the second reads the first's statistics) and the automatic
    altref at that value (1, or up to 6 for layers of them). `speed` is
    cpu-used; `realtime` asks for the real-time deadline (at speed 9
    libvpx then codes every inter frame with the bilinear filter);
    `quantizer` (0-63) pins the rate control's quantizer; `active_map`
    (uint8 by 16x16 block, 0 inactive) is handed over before every frame
    after the first (libvpx drops it at a key frame). A `speed` or
    `frame_parallel` of None leaves that control at the library's
    default."""
    opts = dict(error_resilient=error_resilient, frame_parallel=frame_parallel, lossless=lossless, aq_mode=aq_mode,
                speed=speed, deadline=VPX_DL_REALTIME if realtime else libvpx.VPX_DL_GOOD_QUALITY,
                quantizer=quantizer, active_map=active_map, altref=int(altref))
    if not altref:
        return _encode_pass(frames_i420, w, h, opts, 0, 0, None)[0]
    _, stats = _encode_pass(frames_i420, w, h, opts, 25, 1, None)
    return _encode_pass(frames_i420, w, h, opts, 25, 2, stats)[0]


def _encode_pass(frames_i420, w: int, h: int, opts: dict, lag: int, passno: int, stats: Optional[bytes]):
    cfg = (ctypes.c_uint32 * 512)()
    if _LIB.vpx_codec_enc_config_default(ctypes.c_void_p(_LIB.vpx_codec_vp9_cx()), cfg, 0):
        raise RuntimeError("vpx_codec_enc_config_default failed")
    cfg[libvpx._WIDTH], cfg[libvpx._HEIGHT] = w, h
    cfg[libvpx._ERROR_RESILIENT], cfg[libvpx._PASS], cfg[libvpx._LAG] = int(opts["error_resilient"]), passno, lag
    if opts["quantizer"] is not None:
        cfg[_MIN_Q] = cfg[_MAX_Q] = opts["quantizer"]
    keep = None
    if stats is not None:
        keep = ctypes.create_string_buffer(stats, len(stats))
        ctypes.c_void_p.from_address(ctypes.addressof(cfg) + libvpx._STATS_IN).value = ctypes.addressof(keep)
        ctypes.c_size_t.from_address(ctypes.addressof(cfg) + libvpx._STATS_IN + 8).value = len(stats)
    ctx = ctypes.create_string_buffer(4096)
    for abi in range(8, 60):  # VPX_ENCODER_ABI_VERSION differs between releases
        if _LIB.vpx_codec_enc_init_ver(ctx, ctypes.c_void_p(_LIB.vpx_codec_vp9_cx()), cfg, 0, abi) == 0:
            break
    else:
        raise RuntimeError("vpx_codec_enc_init_ver failed")
    frame_parallel = opts["frame_parallel"]
    controls = [(VP8E_SET_CPUUSED, opts["speed"]), (VP8E_SET_ENABLEAUTOALTREF, opts["altref"] if lag else 0),
                (VP9E_SET_FRAME_PARALLEL_DECODING, None if frame_parallel is None else int(frame_parallel)),
                (VP9E_SET_LOSSLESS, int(opts["lossless"])), (VP9E_SET_AQ_MODE, opts["aq_mode"])]
    for ctrl, value in controls:
        if value is None:
            continue
        if _LIB.vpx_codec_control_(ctx, ctrl, ctypes.c_int(value)):
            raise RuntimeError(f"vpx_codec_control_ {ctrl} failed")
    packets, stats_out = [], []
    img = ctypes.create_string_buffer(512)
    active = None
    if opts["active_map"] is not None:
        cells = ctypes.create_string_buffer(np.ascontiguousarray(opts["active_map"], np.uint8).tobytes())
        active = _ActiveMap(ctypes.addressof(cells), *opts["active_map"].shape)

    def drain():
        it = ctypes.c_void_p(0)
        while True:
            pkt = _LIB.vpx_codec_get_cx_data(ctx, ctypes.byref(it))
            if not pkt:
                return
            kind = ctypes.c_int.from_address(pkt).value
            buf, size = ctypes.c_void_p.from_address(pkt + 8).value, ctypes.c_size_t.from_address(pkt + 16).value
            if kind == 0:  # a frame
                packets.append((ctypes.string_at(buf, size), bool(ctypes.c_uint32.from_address(pkt + 40).value & 1)))
            elif kind == 1:  # first-pass statistics
                stats_out.append(ctypes.string_at(buf, size))

    try:
        for i, f in enumerate(frames_i420):
            if active is not None and i and _LIB.vpx_codec_control_(ctx, VP8E_SET_ACTIVEMAP, ctypes.byref(active)):
                raise RuntimeError("vpx_codec_control_ VP8E_SET_ACTIVEMAP failed")
            data = ctypes.create_string_buffer(f.tobytes())
            p = _LIB.vpx_img_wrap(img, libvpx.VPX_IMG_FMT_I420, w, h, 1, data)
            if _LIB.vpx_codec_encode(ctx, ctypes.c_void_p(p), ctypes.c_int64(i), ctypes.c_ulong(1), ctypes.c_long(0),
                                     ctypes.c_ulong(opts["deadline"])):
                raise RuntimeError("vpx_codec_encode failed")
            drain()
        while True:  # flush: the lagged frames come out a few at a time
            n = len(packets)
            _LIB.vpx_codec_encode(ctx, None, ctypes.c_int64(-1), ctypes.c_ulong(1), ctypes.c_long(0),
                                  ctypes.c_ulong(opts["deadline"]))
            drain()
            if len(packets) == n:
                break
    finally:
        _LIB.vpx_codec_destroy(ctx)
    del keep
    return packets, b"".join(stats_out)
