"""DetectionDemo: the image and directory demos.

Port of `yolo_infer_tpu/demos/detection_demo.py` (`DetectionDemo` with its
signature and defaults, conf 0.5 and iou 0.45; `detect_image` and its
result dict; the standalone `main`). An image runs through
`YOLO11Model.predict` on the card (or the CPU with `device="cpu"`), is drawn
by `utils/visualization.py draw_results` and, with an output path, written
by `data/loader.py save_image` (JPEG through the port's own encoder). A
directory runs every image in it through `detect_image`
(`detect_directory`). `last_timing` holds the host seconds of the last
image's parts: decode, predict, draw and encode.

Video and webcam sources need a video decoder and encoder, which the port
does not have yet (the JAX package uses OpenCV's VideoCapture and
VideoWriter): `detect_video` and `detect_webcam` raise (ROADMAP Queue 1
item 11). There is no window toolkit either: `display=True` logs
that the display is unavailable and goes on, as the JAX package does on a
headless host.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.core.model import SUPPORTED_TASKS, YOLO11Model
from yolo_infer_tpu_torch.data.loader import VIDEO_EXTS, list_image_files, load_image, save_image
from yolo_infer_tpu_torch.utils.visualization import draw_results

logger = logging.getLogger(__name__)

_NO_VIDEO = "needs a video decoder, which the port does not have yet (ROADMAP Queue 1 item 11)"


class DetectionDemo:
    """Object-detection demo runner over the port's predict pipeline."""

    TASK_SUFFIX = SUPPORTED_TASKS

    def __init__(
        self,
        model_size: str = "n",
        model_path: Optional[str] = None,
        device: Optional[str] = None,
        conf_threshold: float = 0.5,
        iou_threshold: float = 0.45,
        imgsz: int = 640,
        task: str = "detect",
        compute_dtype: torch.dtype = torch.bfloat16,
    ):
        if task not in self.TASK_SUFFIX:
            raise ValueError(f"unknown task {task!r}; expected one of {sorted(self.TASK_SUFFIX)}")
        if model_path:
            self.model = YOLO11Model(model_path, device=device, compute_dtype=compute_dtype)
            self.task = self.model.task
        else:
            self.model = YOLO11Model(f"yolo11{model_size}{self.TASK_SUFFIX[task]}", device=device,
                                     compute_dtype=compute_dtype)
            self.task = task
        self.conf_threshold = conf_threshold
        self.iou_threshold = iou_threshold
        self.imgsz = imgsz
        self.last_timing: Dict[str, float] = {}

    # ----------------------------------------------------------------- image

    def detect_image(
        self,
        image_path: Union[str, Path, np.ndarray],
        output_path: Optional[Union[str, Path]] = None,
        display: bool = False,
    ) -> Dict[str, Any]:
        """Detect on one image; returns num_detections, classes (names),
        confidences, boxes (xyxy, original pixels), inference_time_s (the
        predict call) and annotated_image."""
        t0 = time.perf_counter()
        img = load_image(image_path) if isinstance(image_path, (str, Path)) else image_path
        t1 = time.perf_counter()
        result = self.model.predict(img, conf=self.conf_threshold, iou=self.iou_threshold, imgsz=self.imgsz)[0]
        t2 = time.perf_counter()
        annotated = draw_results(img, result)
        t3 = time.perf_counter()
        if output_path:
            save_image(output_path, annotated)
            logger.info("saved annotated image to %s", output_path)
        t4 = time.perf_counter()
        self.last_timing = {"decode": t1 - t0, "predict": t2 - t1, "draw": t3 - t2, "encode": t4 - t3}
        if display:
            logger.warning("display unavailable (no window toolkit); skipping it")
        return {
            "num_detections": len(result),
            "classes": [result.names.get(int(c), str(int(c))) for c in result.classes],
            "confidences": result.scores.tolist(),
            "boxes": result.boxes.tolist(),
            "inference_time_s": t2 - t1,
            "annotated_image": annotated,
        }

    def detect_directory(
        self,
        directory: Union[str, Path],
        output_dir: Optional[Union[str, Path]] = None,
        display: bool = False,
    ) -> Dict[str, Any]:
        """`detect_image` on every image under `directory` (sorted); with
        `output_dir`, each annotated image is written there under its own
        name. Returns the per-image dicts (without the images, with their
        host seconds by part) and the host seconds of each part summed over
        the images."""
        files = list_image_files(directory)
        images: List[Dict[str, Any]] = []
        totals = {"decode": 0.0, "predict": 0.0, "draw": 0.0, "encode": 0.0}
        t0 = time.perf_counter()
        for f in files:
            out_path = Path(output_dir) / f.relative_to(directory) if output_dir else None
            out = self.detect_image(f, out_path, display=display)
            out.pop("annotated_image")
            images.append({"image": str(f), **out, "host_s": dict(self.last_timing)})
            for k, v in self.last_timing.items():
                totals[k] += v
        elapsed = time.perf_counter() - t0
        return {"num_images": len(files), "images": images, "host_s": totals, "processing_time_s": elapsed,
                "output_dir": str(output_dir) if output_dir else None}

    def run_source(self, src: str, output: Optional[Union[str, Path]] = None, display: bool = False,
                   batch_size: int = 8) -> Dict[str, Any]:
        """Run the demo on what `src` names: a camera index, a video, a directory
        of images or one image; the result without the annotated pixels."""
        if src.isdigit():
            return self.detect_webcam(int(src), display=display)
        if Path(src).suffix.lower() in VIDEO_EXTS:
            return self.detect_video(src, output, display=display, batch_size=batch_size)
        if Path(src).is_dir():
            return self.detect_directory(src, output, display=display)
        out = self.detect_image(src, output, display=display)
        out.pop("annotated_image", None)
        return out

    # ----------------------------------------------------------- video, webcam

    def detect_video(self, video_path: Union[str, Path], output_path: Optional[Union[str, Path]] = None,
                     display: bool = False, batch_size: int = 8, pipeline_depth: int = 2,
                     max_frames: Optional[int] = None, progress_every: int = 30) -> Dict[str, Any]:
        raise NotImplementedError(f"video input {_NO_VIDEO}")

    def detect_webcam(self, camera_id: int = 0, display: bool = True,
                      max_frames: Optional[int] = None) -> Dict[str, Any]:
        raise NotImplementedError(f"webcam input {_NO_VIDEO}")


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone command line: `python -m yolo_infer_tpu_torch.demos.detection_demo --help`."""
    import argparse

    p = argparse.ArgumentParser(description="YOLO11 detection demo (the PyTorch port)")
    p.add_argument("--input", required=True, help="image path, directory, video path or camera index")
    p.add_argument("--output", default=None, help="annotated image (or directory, for a directory input)")
    p.add_argument("--model-size", default="n", choices=list("nsmlx"))
    p.add_argument("--model-path", default=None)
    p.add_argument("--task", default="detect", choices=["detect", "segment", "classify", "pose", "obb"])
    p.add_argument("--conf", type=float, default=0.5)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=8, help="video batch size")
    p.add_argument("--display", action="store_true")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    demo = DetectionDemo(args.model_size, args.model_path, device=args.device, conf_threshold=args.conf,
                         iou_threshold=args.iou, imgsz=args.imgsz, task=args.task)
    print(demo.run_source(args.input, args.output, display=args.display, batch_size=args.batch))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
