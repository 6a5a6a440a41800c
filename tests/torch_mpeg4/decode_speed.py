"""Time the port's MPEG-4 Simple Profile decode in one or more checkouts on this host.

    python tests/torch_mpeg4/decode_speed.py ROOT [ROOT ...]

For each ROOT in the order given (a checkout of the repo; name two
checkouts as A B B A to compare two versions on one host), a fresh
process imports `yolo_infer_tpu_torch` from ROOT and reads the committed
640x480 mp4v file (`tests/torch_video/mp4v_640x480_30.mp4`: 2 I-VOPs, 22
P-VOPs, one VOP a frame) through `open_video(path).read(rgb=False)` three
times. Each frame's seconds cover its VOP's decode and the conversion to
BGR. Prints one JSON line per ROOT: the median seconds of an I-VOP and of a
P-VOP over the three passes, the whole file's frames/s (best pass), and
the host's `nvidia-smi` name and power limit where there is a card.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

FILE = Path("tests") / "torch_video" / "mp4v_640x480_30.mp4"
PASSES = 3


def measure(root: Path) -> dict:
    """This process's timings of the file, with the package from `root`."""
    sys.path.insert(0, str(root))
    from yolo_infer_tpu_torch.data.video import open_video

    path = root / FILE
    kinds = ["IPBS"[p[p.index(b"\x00\x00\x01\xb6") + 4] >> 6] for p in open_video(path).packets()]
    times = {"I": [], "P": []}
    passes = []
    for _ in range(PASSES):
        frames = open_video(path).read(rgb=False)
        start = t0 = time.perf_counter()
        for kind in kinds:
            next(frames)
            t1 = time.perf_counter()
            times[kind].append(t1 - t0)
            t0 = t1
        passes.append(time.perf_counter() - start)
    return {"root": str(root), "i_vop_s": sorted(times["I"])[len(times["I"]) // 2],
            "p_vop_s": sorted(times["P"])[len(times["P"]) // 2], "vops": {k: len(v) // PASSES for k, v in times.items()},
            "file_frames_per_s": len(kinds) / min(passes)}


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
