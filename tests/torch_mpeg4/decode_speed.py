"""Time the port's MPEG-4 decode in one or more checkouts on this host.

    python tests/torch_mpeg4/decode_speed.py ROOT [ROOT ...]

For each ROOT in the order given (a checkout of the repo; name two
checkouts as A B B A to compare two versions on one host), a fresh
process imports `yolo_infer_tpu_torch` from ROOT and decodes two committed
files three times each, packet by packet through `Mpeg4Decoder.decode`
(plus `yuv420_to_bgr` of the frame a packet gives): the 640x480 Simple
Profile mp4v file (`tests/torch_video/mp4v_640x480_30.mp4`: 2 I-VOPs, 22
P-VOPs) and the 640x480 Xvid Advanced Simple Profile file
(`tests/torch_mpeg4/xvid_asp_640x480.avi`: 3 I-, 6 P-, 15 B-VOPs,
quarter-pel, 4MV). Prints one JSON line per ROOT: for each file the median
seconds of a packet by its VOP type over the three passes and the whole
file's packets/s (best pass), and the host's `nvidia-smi` name and power
limit where there is a card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

FILES = {"sp": Path("tests") / "torch_video" / "mp4v_640x480_30.mp4",
         "asp": Path("tests") / "torch_mpeg4" / "xvid_asp_640x480.avi"}
PASSES = 3


def measure(root: Path) -> dict:
    """This process's timings of the files, with the package from `root`."""
    sys.path.insert(0, str(root))
    from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Decoder, yuv420_to_bgr
    from yolo_infer_tpu_torch.data.video import open_video

    out = {"root": str(root)}
    for key, name in FILES.items():
        reader = open_video(root / name)
        packets = list(reader.packets())
        kinds = ["IPBS"[p[p.index(b"\x00\x00\x01\xb6") + 4] >> 6] for p in packets]
        times = {k: [] for k in sorted(set(kinds))}
        passes = []
        for _ in range(PASSES):
            decoder = Mpeg4Decoder(reader.config, reader.fourcc)
            start = time.perf_counter()
            for kind, packet in zip(kinds, packets):
                t0 = time.perf_counter()
                planes = decoder.decode(packet)
                if planes is not None:
                    yuv420_to_bgr(*planes)
                times[kind].append(time.perf_counter() - t0)
            passes.append(time.perf_counter() - start)
        out[key] = {**{f"{k.lower()}_vop_s": sorted(v)[len(v) // 2] for k, v in times.items()},
                    "vops": {k: len(v) // PASSES for k, v in times.items()},
                    "file_packets_per_s": len(packets) / min(passes)}
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main(args) -> int:
    if args[:1] == ["--one"]:
        print(json.dumps(measure(Path(args[1]).resolve())))
        return 0
    host = card()
    for root in args:
        out = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True, text=True)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        print(json.dumps({**json.loads(out.stdout.strip().splitlines()[-1]), "card": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
