"""DatasetValidator — offline label QA with a content-hash cache.

API parity with the reference's utils/dataset_validator.py (mtime-hash cache
:43-91, per-file checks — >=5 fields, class range, coords in [0,1] :93-157,
validate_dataset rglob :159-215, delete_invalid_files :226-255, CLI
:257-302). Pure host Python; this is the offline half of the robust-training
story (bad labels are what caused the reference's in-training shape
mismatches). The port's own copy of the JAX package's
`data/dataset_validator.py`; run it as `python -m
yolo_infer_tpu_torch.data.dataset_validator DATASET_DIR [--num-classes N]`.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

logger = logging.getLogger(__name__)

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class DatasetValidator:
    """Validate YOLO-format label files under a directory tree."""

    def __init__(
        self,
        dataset_dir: Union[str, Path],
        num_classes: int = 80,
        cache_dir: Optional[Union[str, Path]] = None,
        use_cache: bool = True,
    ):
        self.dataset_dir = Path(dataset_dir)
        self.num_classes = num_classes
        self.use_cache = use_cache
        self.cache_path = Path(cache_dir or self.dataset_dir / ".cache") / "validation_cache.json"
        self._cache: Dict[str, Any] = self._load_cache()
        self.invalid_files: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------ cache

    def _load_cache(self) -> Dict[str, Any]:
        if self.use_cache and self.cache_path.exists():
            try:
                return json.loads(self.cache_path.read_text())
            except json.JSONDecodeError:
                logger.warning("corrupt validation cache; ignoring")
        return {}

    def _save_cache(self) -> None:
        if not self.use_cache:
            return
        self.cache_path.parent.mkdir(parents=True, exist_ok=True)
        self.cache_path.write_text(json.dumps(self._cache))

    def _file_key(self, path: Path) -> str:
        st = path.stat()
        # num_classes is part of the verdict, so it must be part of the key —
        # otherwise a re-run with a different --num-classes reuses stale results
        return hashlib.md5(f"{path}:{st.st_mtime_ns}:{st.st_size}:nc={self.num_classes}".encode()).hexdigest()

    # ------------------------------------------------------------- validation

    def validate_label_file(self, path: Path) -> Tuple[bool, List[str]]:
        """Per-file checks: >=5 fields, class index range, coords in [0,1]."""
        errors: List[str] = []
        try:
            lines = path.read_text().splitlines()
        except OSError as e:
            return False, [f"unreadable: {e}"]
        for ln, line in enumerate(lines, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) < 5:
                errors.append(f"line {ln}: expected >=5 fields, got {len(parts)}")
                continue
            try:
                cls = int(float(parts[0]))
                coords = [float(v) for v in parts[1:5]]
            except ValueError:
                errors.append(f"line {ln}: non-numeric fields")
                continue
            if not (0 <= cls < self.num_classes):
                errors.append(f"line {ln}: class {cls} out of range [0, {self.num_classes})")
            bad = [v for v in coords if not (0.0 <= v <= 1.0)]
            if bad:
                errors.append(f"line {ln}: coords out of [0,1]: {bad}")
        return not errors, errors

    def validate_dataset(self, labels_subdir: str = "") -> Dict[str, Any]:
        """Validate all *.txt labels under the dataset dir (cached by content)."""
        root = self.dataset_dir / labels_subdir if labels_subdir else self.dataset_dir
        label_files = sorted(root.rglob("*.txt"))
        self.invalid_files = []
        n_cached = 0
        for lf in label_files:
            key = self._file_key(lf)
            if key in self._cache:
                n_cached += 1
                cached = self._cache[key]
                if not cached["valid"]:
                    self.invalid_files.append({"path": str(lf), "errors": cached["errors"]})
                continue
            ok, errors = self.validate_label_file(lf)
            self._cache[key] = {"valid": ok, "errors": errors}
            if not ok:
                self.invalid_files.append({"path": str(lf), "errors": errors})
        self._save_cache()
        result = {
            "total_files": len(label_files),
            "valid_files": len(label_files) - len(self.invalid_files),
            "invalid_files": len(self.invalid_files),
            "cached_hits": n_cached,
            "details": self.invalid_files,
        }
        logger.info(
            "dataset validation: %d/%d valid (%d cached)",
            result["valid_files"], result["total_files"], n_cached,
        )
        return result

    # --------------------------------------------------------------- cleanup

    def delete_invalid_files(self, dry_run: bool = True) -> List[str]:
        """Remove invalid label files and their paired images
        (reference dataset_validator.py:226-255)."""
        removed: List[str] = []
        for entry in self.invalid_files:
            label = Path(entry["path"])
            targets = [label]
            img_dir_parts = [("images" if p == "labels" else p) for p in label.parts]
            img_base = Path(*img_dir_parts).with_suffix("")
            for ext in IMAGE_EXTS:
                cand = img_base.with_suffix(ext)
                if cand.exists():
                    targets.append(cand)
            for t in targets:
                removed.append(str(t))
                if not dry_run:
                    t.unlink(missing_ok=True)
        if not dry_run:
            logger.info("deleted %d files", len(removed))
        return removed


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone CLI (reference dataset_validator.py:257-302)."""
    p = argparse.ArgumentParser(description="Validate YOLO-format dataset labels")
    p.add_argument("dataset_dir")
    p.add_argument("--num-classes", type=int, default=80)
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--delete-invalid", action="store_true")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    v = DatasetValidator(args.dataset_dir, num_classes=args.num_classes, use_cache=not args.no_cache)
    result = v.validate_dataset()
    print(json.dumps({k: v2 for k, v2 in result.items() if k != "details"}, indent=2))
    for entry in result["details"][:20]:
        print(f"INVALID {entry['path']}: {entry['errors'][:3]}")
    if args.delete_invalid:
        removed = v.delete_invalid_files(dry_run=args.dry_run)
        print(f"{'would delete' if args.dry_run else 'deleted'} {len(removed)} files")
    return 0 if result["invalid_files"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
