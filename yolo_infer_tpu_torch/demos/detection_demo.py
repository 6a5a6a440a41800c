"""DetectionDemo: the image, directory and video demos.

Port of `yolo_infer_tpu/demos/detection_demo.py` (`DetectionDemo` with its
signature and defaults, conf 0.5 and iou 0.45; `detect_image` and its
result dict; `detect_video` and its summary; the standalone `main`). An
image runs through `YOLO11Model.predict` on the card (or the CPU with
`device="cpu"`), is drawn by `utils/visualization.py draw_results` and, with
an output path, written by `data/loader.py save_image` (JPEG through the
port's own encoder). A directory runs every image in it through
`detect_image` (`detect_directory`). `last_timing` holds the host seconds of
the last image's parts: decode, predict, draw and encode.

A video is read by its signature (`data/loader.py load_video`,
`data/video.py`): MPEG-4 Part 2 in MP4, MOV, Matroska or AVI, VP8 in
WebM, or motion JPEG in AVI; other containers and codecs raise before any
frame is read (ROADMAP Queue 1 item 11.2). The output's suffix picks its
writer (`create_video_writer`): MPEG-4 Part 2 for `.mp4`, `.m4v`, `.mov`
and `.mkv`, motion JPEG for `.avi`. For detect, `detect_video` is the JAX demo's
batched pipeline: a decode thread reads and letterboxes frames on the host
into batches of `batch_size` (the last one padded with its last frame), the
predictor's staging pipeline (`Predictor._serve_stream`, the one
`predict_many` runs) keeps up to `pipeline_depth` batches in flight through
`predict_raw` at `imgsz`, and this thread draws and encodes each drained
batch. A failure of the decode thread is raised here. `last_timing` then
holds the run's host seconds by part: decode and letterbox (the decode
thread), device_wait (drains waiting for the device), pipeline (the rest of
this thread's time in the pipeline: launches, staging, waiting for decoded
batches), draw and encode. The other tasks run each frame through
`YOLO11Model.predict` and `draw_results` (`_video_per_frame`). Webcam input
needs a camera reader, which the port does not have (`detect_webcam`
raises, ROADMAP Queue 1 item 11.3). There is no window toolkit either:
`display=True` logs that the display is unavailable and goes on, as the JAX
package does on a headless host.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.core.model import SUPPORTED_TASKS, YOLO11Model
from yolo_infer_tpu_torch.data.loader import (
    VIDEO_EXTS,
    get_video_info,
    list_image_files,
    load_image,
    load_video,
    save_image,
)
from yolo_infer_tpu_torch.ops.letterbox import letterbox, letterbox_params, scale_boxes
from yolo_infer_tpu_torch.utils.visualization import create_video_writer, draw_detections, draw_results

logger = logging.getLogger(__name__)

_END = object()  # the decode thread's last item


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
        """Batched video inference with decode, device and draw/encode
        overlapped (detect; the other tasks go frame by frame). Returns
        total_frames, total_detections, processing_time_s, fps, video_info
        and output_path."""
        if self.task != "detect":
            return self._video_per_frame(video_path, output_path, display, max_frames)
        info = get_video_info(video_path)
        frames = load_video(video_path)
        writer = create_video_writer(output_path, info["fps"] or 30.0, (info["width"], info["height"])) \
            if output_path else None
        timing = dict.fromkeys(("decode", "letterbox", "device_wait", "pipeline", "draw", "encode"), 0.0)
        batch_q: "queue.Queue" = queue.Queue(maxsize=pipeline_depth + 1)
        stop = threading.Event()

        def put(item) -> None:
            while not stop.is_set():
                try:
                    batch_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def decode() -> None:
            """Read and letterbox frames into batches of (letterboxed, original)."""
            lbs: List[np.ndarray] = []
            rgbs: List[np.ndarray] = []
            try:
                n = 0
                while not stop.is_set() and not (max_frames and n >= max_frames):
                    t0 = time.perf_counter()
                    rgb = next(frames, None)
                    t1 = time.perf_counter()
                    if rgb is None:
                        break
                    lbs.append(letterbox(rgb, self.imgsz)[0])
                    rgbs.append(rgb)
                    timing["decode"] += t1 - t0
                    timing["letterbox"] += time.perf_counter() - t1
                    n += 1
                    if len(rgbs) == batch_size:
                        put((lbs, rgbs))
                        lbs, rgbs = [], []
                if rgbs:
                    put((lbs, rgbs))
                put(_END)
            except BaseException as exc:  # noqa: BLE001 -- handed to the consumer, which raises it
                put(exc)
            finally:
                frames.close()

        def batches():
            """The decode thread's batches; its failure raised here."""
            while True:
                try:
                    item = batch_q.get(timeout=0.1)
                except queue.Empty:
                    if stop.is_set():
                        return
                    continue
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item

        decoder = threading.Thread(target=decode, name="video-decode", daemon=True)
        decoder.start()
        predictor = self.model.predictor
        ratio, pad, _ = letterbox_params((info["height"], info["width"]), self.imgsz)
        total_frames = total_dets = n_batches = 0
        t_start = time.perf_counter()
        stream = None
        try:
            source = batches()
            first = next(source, None)
            if first is not None:
                shape = (batch_size,) + first[0][0].shape
                stream = predictor._serve_stream(itertools.chain([first], source), shape, self.conf_threshold,
                                                 self.iou_threshold, self.imgsz, None, False, pipeline_depth)
                t_pipe = time.perf_counter()
                for dets, rgbs, _, waited in stream:
                    t0 = time.perf_counter()
                    timing["device_wait"] += waited
                    timing["pipeline"] += t0 - t_pipe - waited
                    for i, frame in enumerate(rgbs):
                        k = int(dets["num"][i])
                        boxes = scale_boxes(dets["boxes"][i, :k], ratio, pad, frame.shape[:2])
                        total_dets += k
                        t1 = time.perf_counter()
                        annotated = draw_detections(frame, boxes, dets["scores"][i, :k],
                                                    dets["classes"][i, :k].astype(np.int32), self.model.names)
                        t2 = time.perf_counter()
                        if writer is not None:
                            writer.write(annotated[..., ::-1])
                        timing["draw"] += t2 - t1
                        timing["encode"] += time.perf_counter() - t2
                    total_frames += len(rgbs)
                    n_batches += 1
                    if progress_every and n_batches % progress_every == 0:
                        logger.info("processed %d frames", total_frames)
                    t_pipe = time.perf_counter()
        finally:
            stop.set()
            if stream is not None:
                stream.close()
            decoder.join()
            if writer is not None:
                writer.release()
        if display:
            logger.warning("display unavailable (no window toolkit); skipping it")
        elapsed = time.perf_counter() - t_start
        self.last_timing = timing
        summary = {
            "total_frames": total_frames,
            "total_detections": total_dets,
            "processing_time_s": elapsed,
            "fps": total_frames / elapsed if elapsed > 0 else 0.0,
            "video_info": info,
            "output_path": str(output_path) if output_path else None,
        }
        logger.info("video done: %d frames in %.1fs (%.1f fps)", total_frames, elapsed, summary["fps"])
        return summary

    def _video_per_frame(self, video_path, output_path, display, max_frames) -> Dict[str, Any]:
        """Every frame through `YOLO11Model.predict` and `draw_results` (the
        tasks other than detect)."""
        info = get_video_info(video_path)
        frames = load_video(video_path)
        writer = create_video_writer(output_path, info["fps"] or 30.0, (info["width"], info["height"])) \
            if output_path else None
        n, total_dets = 0, 0
        t0 = time.perf_counter()
        try:
            for rgb in frames:
                if max_frames and n >= max_frames:
                    break
                result = self.model.predict(rgb, conf=self.conf_threshold, iou=self.iou_threshold, imgsz=self.imgsz)[0]
                annotated = draw_results(rgb, result)
                total_dets += len(result)
                n += 1
                if writer is not None:
                    writer.write(annotated[..., ::-1])
        finally:
            if writer is not None:
                writer.release()
        if display:
            logger.warning("display unavailable (no window toolkit); skipping it")
        elapsed = time.perf_counter() - t0
        return {
            "total_frames": n,
            "total_detections": total_dets,
            "processing_time_s": elapsed,
            "fps": n / elapsed if elapsed > 0 else 0.0,
            "video_info": info,
            "output_path": str(output_path) if output_path else None,
        }

    def detect_webcam(self, camera_id: int = 0, display: bool = True,
                      max_frames: Optional[int] = None) -> Dict[str, Any]:
        raise NotImplementedError("webcam input needs a camera reader, which the port does not have "
                                  "(ROADMAP Queue 1 item 11.3)")


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone command line: `python -m yolo_infer_tpu_torch.demos.detection_demo --help`."""
    import argparse

    p = argparse.ArgumentParser(description="YOLO11 detection demo (the PyTorch port)")
    p.add_argument("--input", required=True, help="image path, directory, video path or camera index")
    p.add_argument("--output", default=None, help="annotated image, directory (for a directory input) or video (.mp4, .m4v, .mov: MPEG-4 Part 2; .avi: "
                        "motion JPEG)")
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
