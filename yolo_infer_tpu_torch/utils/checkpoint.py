"""Checkpoint manager: msgpack tree checkpoints with resume semantics.

Port of `yolo_infer_tpu/utils/checkpoint.py` (`CheckpointManager`,
`save_training_state`, `load_training_state`), in the same file format:
`checkpoint_epoch_NNNN.msgpack` holding {"train_state": tree} in flax's
msgpack wire format (`utils/msgpack.py`) and a JSON sidecar with the epoch,
step, metrics, time and best flag; `best.msgpack` beside the best one;
keep-last-N cleanup by epoch. Files are readable by either package.

As `flax.serialization.to_state_dict` does before saving, lists and tuples
in a train state are stored as dicts keyed "0", "1", ...; `target` puts
them back. Torch tensors are stored as numpy arrays (bfloat16 as flax's
"bfloat16").
"""

from __future__ import annotations

import json
import logging
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.utils.msgpack import msgpack_restore, msgpack_serialize

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"checkpoint_epoch_(\d+)\.msgpack$")


def _to_host(tree: Any) -> Any:
    """Every leaf as a host array, as the JAX package's `np.asarray` over the
    tree makes it (a scalar becomes a 0-d array; bfloat16 stays a CPU tensor,
    which the writer stores as flax does); None and containers kept."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if tree is None:
        return None
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


def to_state_dict(tree: Any) -> Any:
    """flax's `to_state_dict` for plain containers: lists and tuples become
    dicts keyed by their indices as strings, dict keys strings."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(target: Any, state: Any) -> Any:
    """flax's `from_state_dict` for plain containers: `state` given the
    container types of `target` (lists and tuples from their index dicts)."""
    if isinstance(target, dict):
        missing = set(map(str, target)) - set(state)
        if missing:
            raise ValueError(f"the state dict lacks the target's keys {sorted(missing)}")
        return {k: from_state_dict(v, state[str(k)]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(f"the target has {len(target)} entries, the state dict {len(state)}")
        return type(target)(from_state_dict(v, state[str(i)]) for i, v in enumerate(target))
    return state


class CheckpointManager:
    """Save/load/rotate training checkpoints in `checkpoint_dir`."""

    def __init__(self, checkpoint_dir: Union[str, Path] = "checkpoints", max_checkpoints: int = 5):
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.max_checkpoints = max_checkpoints

    # -- save -----------------------------------------------------------------

    def save_checkpoint(
        self,
        train_state: Dict[str, Any],
        epoch: int,
        step: Optional[int] = None,
        metrics: Optional[Dict[str, float]] = None,
        is_best: bool = False,
    ) -> Path:
        """train_state: a tree of dicts, lists and arrays or tensors."""
        path = self.checkpoint_dir / f"checkpoint_epoch_{epoch:04d}.msgpack"
        path.write_bytes(msgpack_serialize({"train_state": _to_host(to_state_dict(train_state))}))
        meta = {
            "epoch": epoch,
            "step": step,
            "metrics": metrics or {},
            "timestamp": time.time(),
            "is_best": is_best,
        }
        path.with_suffix(".json").write_text(json.dumps(meta, indent=2, default=float))
        if is_best:
            best = self.checkpoint_dir / "best.msgpack"
            best.write_bytes(path.read_bytes())
            best.with_suffix(".json").write_text(path.with_suffix(".json").read_text())
        self.cleanup_checkpoints()
        logger.info("saved checkpoint %s", path)
        return path

    def save_best_model(self, params: Any, metric_name: str, value: float) -> Path:
        path = self.checkpoint_dir / f"best_{metric_name}_{value:.4f}.msgpack"
        path.write_bytes(msgpack_serialize({"params": _to_host(params)}))
        return path

    # -- load -----------------------------------------------------------------

    def load_checkpoint(
        self,
        checkpoint_path: Optional[Union[str, Path]] = None,
        target: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Load a checkpoint (the latest if no path is given).

        With `target` (a tree of the same structure) the restored arrays take
        the target's container types; without it come plain nested dicts of
        numpy arrays."""
        path = Path(checkpoint_path) if checkpoint_path else self.get_latest_checkpoint()
        if path is None or not Path(path).exists():
            raise FileNotFoundError(f"no checkpoint found at {checkpoint_path or self.checkpoint_dir}")
        state = msgpack_restore(Path(path).read_bytes())["train_state"]
        if target is not None:
            state = from_state_dict(target, state)
        meta_path = Path(path).with_suffix(".json")
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        return {"train_state": state, **meta}

    # -- discovery / rotation ---------------------------------------------------

    def list_checkpoints(self) -> List[Path]:
        return sorted(self.checkpoint_dir.glob("checkpoint_epoch_*.msgpack"))

    def get_latest_checkpoint(self) -> Optional[Path]:
        ckpts = self.list_checkpoints()
        if not ckpts:
            return None
        return max(ckpts, key=lambda p: int(_CKPT_RE.search(p.name).group(1)))

    def get_checkpoint_info(self, path: Union[str, Path]) -> Dict[str, Any]:
        meta_path = Path(path).with_suffix(".json")
        info: Dict[str, Any] = {"path": str(path), "size_bytes": Path(path).stat().st_size}
        if meta_path.exists():
            info.update(json.loads(meta_path.read_text()))
        return info

    def cleanup_checkpoints(self) -> None:
        ckpts = self.list_checkpoints()
        if len(ckpts) <= self.max_checkpoints:
            return
        by_epoch = sorted(ckpts, key=lambda p: int(_CKPT_RE.search(p.name).group(1)))
        for old in by_epoch[: len(by_epoch) - self.max_checkpoints]:
            old.unlink(missing_ok=True)
            old.with_suffix(".json").unlink(missing_ok=True)
            logger.info("removed old checkpoint %s", old)


def save_training_state(path: Union[str, Path], train_state: Dict[str, Any], **meta) -> None:
    """Module-level convenience: {"train_state": ..., "meta": {...}} in one file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize({"train_state": _to_host(train_state), "meta": meta}))


def load_training_state(path: Union[str, Path], target: Optional[Any] = None) -> Dict[str, Any]:
    raw = msgpack_restore(Path(path).read_bytes())
    if target is not None:
        raw["train_state"] = from_state_dict(target, raw["train_state"])
    return raw
