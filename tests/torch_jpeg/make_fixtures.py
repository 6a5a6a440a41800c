"""Write the JPEG fixtures of the port's decoder and their manifest, with OpenCV.

    python tests/torch_jpeg/make_fixtures.py

Writes small JPEGs (each sampling cv2 writes: 444, 422, 420, 440, 411; grey;
restart intervals; odd sizes; EXIF orientations 3, 6 and 8) beside this
script, and `manifest.json`: for each file, and for `assets/sample.jpg`,
the sha256 and shape of `cv2.imread(path, cv2.IMREAD_COLOR)`'s pixels (BGR);
and the sha256 of `cv2.imencode(".jpg")`'s default bytes for the seeded
640x480 frames `chip_smoke.jpeg_frame(seed)`, seeds 0..ENCODE_FRAMES - 1.
`tests/test_torch_jpeg.py` holds the manifest to OpenCV, and
`chip_smoke.py` holds the port's decoder and encoder to it on the card's
host without importing OpenCV.
"""

import hashlib
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import jpeg_frame  # noqa: E402

ENCODE_FRAMES = 4
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def with_exif_orientation(jpeg: bytes, orientation: int, big_endian: bool = False) -> bytes:
    """`jpeg` with an APP1 Exif segment holding IFD0's Orientation tag, after SOI."""
    o = ">" if big_endian else "<"
    tiff = ((b"MM" if big_endian else b"II") + struct.pack(o + "HI", 42, 8) + struct.pack(o + "H", 1)
            + struct.pack(o + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(o + "I", 0))
    body = b"Exif\0\0" + tiff
    return jpeg[:2] + struct.pack(">BBH", 0xFF, 0xE1, len(body) + 2) + body + jpeg[2:]


def pixels_entry(path: Path) -> dict:
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(), "shape": list(img.shape)}


def main() -> int:
    files = {}
    for i, (name, s) in enumerate(SAMPLING.items()):
        img = jpeg_frame(10 + i, 17 + 8 * i, 33 + 6 * i)
        params = [cv2.IMWRITE_JPEG_QUALITY, (75, 95, 90, 60, 100)[i], cv2.IMWRITE_JPEG_SAMPLING_FACTOR, s]
        files[f"s{name}.jpg"] = cv2.imencode(".jpg", img[..., ::-1], params)[1].tobytes()
    files["grey_31x23.jpg"] = cv2.imencode(".jpg", jpeg_frame(20, 23, 31)[..., 1])[1].tobytes()
    files["rst3_420_48x64.jpg"] = cv2.imencode(".jpg", jpeg_frame(21, 48, 64)[..., ::-1],
                                               [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])[1].tobytes()
    files["odd_1x1.jpg"] = cv2.imencode(".jpg", jpeg_frame(22, 1, 1))[1].tobytes()
    files["odd_97x129.jpg"] = cv2.imencode(".jpg", jpeg_frame(23, 97, 129)[..., ::-1])[1].tobytes()
    base = cv2.imencode(".jpg", jpeg_frame(24, 40, 64)[..., ::-1])[1].tobytes()
    for orientation in (3, 6, 8):
        files[f"exif{orientation}_40x64.jpg"] = with_exif_orientation(base, orientation, big_endian=orientation == 8)
    manifest = {"files": {}, "encoder": {"frames": "chip_smoke.jpeg_frame(seed) for seed in range(%d)"
                                         % ENCODE_FRAMES, "sha256": []}}
    for name, data in files.items():
        (HERE / name).write_bytes(data)
        manifest["files"][name] = pixels_entry(HERE / name)
    manifest["files"]["../../assets/sample.jpg"] = pixels_entry(REPO / "assets" / "sample.jpg")
    for seed in range(ENCODE_FRAMES):
        data = cv2.imencode(".jpg", jpeg_frame(seed)[..., ::-1])[1].tobytes()
        manifest["encoder"]["sha256"].append(hashlib.sha256(data).hexdigest())
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    print(f"{len(files)} fixtures, {sum(len(d) for d in files.values())} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
