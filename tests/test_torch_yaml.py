"""The port's YAML reader and writer (`utils/yaml_io.py`) against PyYAML.

The reader must give what `yaml.safe_load` gives on the repo's config and
on dataset files (the JAX package's `create_dataset_config` output and the
shapes of ultralytics' dataset YAMLs), and raise on input outside its
subset rather than guess. What the writer writes must read back equal under
`yaml.safe_load` and under the port's reader.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import yaml

from torch_threads import one_torch_thread  # noqa: F401

from yolo_infer_tpu_torch.utils import yaml_io
from yolo_infer_tpu_torch.utils.helpers import load_config, save_config

REPO = Path(__file__).resolve().parent.parent


def same(a, b) -> bool:
    """Equal values of equal types, dict order included (nan equals nan)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_reads_the_repo_config_as_pyyaml():
    text = (REPO / "configs" / "default.yaml").read_text()
    assert same(yaml_io.safe_load(text), yaml.safe_load(text))
    assert same(load_config(REPO / "configs" / "default.yaml"), yaml.safe_load(text))


def test_reads_the_jax_dataset_config_as_pyyaml(tmp_path):
    from yolo_infer_tpu.data.loader import create_dataset_config

    path = create_dataset_config(tmp_path / "data.yaml", "images/train", "images/val",
                                 ["person", "true", "1.5", "a: b", "#x", "", "null", "it's"], test="images/test")
    assert same(yaml_io.load(path), yaml.safe_load(path.read_text()))


ULTRALYTICS_STYLE = [
    # coco8.yaml's layout: comments, an empty value, a names mapping with int keys
    """# Ultralytics YOLO, AGPL-3.0 license
path: ../datasets/coco8 # dataset root dir
train: images/train # train images (relative to 'path') 4 images
val: images/val # val images (relative to 'path') 4 images
test: # test images (optional)

# Classes
names:
  0: person
  1: bicycle
  2: car

# Download script/URL (optional)
download: https://github.com/ultralytics/assets/releases/download/v0.0.0/coco8.zip
""",
    # pose: flow lists of ints; names as a flow list; quoted scalars
    "path: ../datasets/coco8-pose\ntrain: images/train\nval: images/val\nkpt_shape: [17, 3]\n"
    "flip_idx: [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]\nnames: ['person', \"dog\", cat]\n",
    # a sequence at its key's indent, a mapping in a sequence, nested flow maps, over two lines
    "train:\n- images/a\n- images/b\nval: [images/c,\n  images/d]\nextra:\n  - {a: 1, b: [1, 2.5]}\n"
    "  - name: x\n    id: 3\nnc: 2\n",
    # YAML 1.1 scalars as PyYAML resolves them
    "a: 0x1F\nb: 010\nc: 0b101\nd: +12\ne: -0.5e-3\nf: 1e5\ng: .inf\nh: -.Inf\ni: .NaN\nj: 1_000\nk: 3.\n"
    "l: yes\nm: Off\nn: ~\no: NULL\np: \"\\u00e9\\x41\\n\\t\"\nq: 'it''s'\nr: a:b\ns: a#b\nt: -x\nu: 2.5e+3\n",
    "---\nlist:\n  -\n    a: 1\n  - - x\n    - y\n...\n",
    "true: 1\n1.5: x\nnull: y\n'3': z\n",
    "- a\n- b\n",
    "42\n",
    "",
    "# a comment only\n",
]


@pytest.mark.parametrize("index", range(len(ULTRALYTICS_STYLE)))
def test_reads_dataset_style_yaml_as_pyyaml(index):
    text = ULTRALYTICS_STYLE[index]
    assert same(yaml_io.safe_load(text), yaml.safe_load(text))


OUTSIDE = {
    "block scalar": "download: |\n  import x\n",
    "folded scalar": "a: >\n  text\n",
    "anchor": "a: &x 1\nb: 2\n",
    "alias": "b: *x\n",
    "tag": "a: !!str 1\n",
    "complex key": "? a\n: b\n",
    "timestamp": "a: 2001-12-14\n",
    "multi-line plain": "a: b\n  c\n",
    "multi-line quoted": "a: 'x\n  y'\n",
    "tab indent": "a:\n\t- 1\n",
    "two documents": "a: 1\n---\nb: 2\n",
    "sexagesimal": "a: 1:20\n",
    "merge key": "<<: {a: 1}\n",
    "value on a value": "a: b: c\n",
    "unclosed flow": "a: [1, 2\n",
    "bad indentation": "a:\n    b: 1\n  c: 2\n",
}


@pytest.mark.parametrize("kind", list(OUTSIDE))
def test_raises_outside_the_subset(kind):
    with pytest.raises(yaml_io.YAMLSubsetError):
        yaml_io.safe_load(OUTSIDE[kind])


WRITTEN = [
    {"train": "images/train", "val": "/abs/val", "nc": 11,
     "names": {0: "person", 1: "true", 2: "1.5", 3: "a: b", 4: "#x", 5: "", 6: " lead", 7: "é", 8: "null",
               9: "- x", 10: "x'y\"z", 11: "tab\there", 12: "0x10", 13: "~", 14: "2001-12-14", 15: "😀"}},
    {"a": [1, 2.5, 1e-05, 1e300, float("inf"), -float("inf"), float("nan"), None, True, False, [], {}, -0.0],
     "b": {"c": {"d": [{"e": 1}, [1, [2]]]}}},
    [1, "a", {"k": [None]}],
    "plain",
    1.0,
    {},
]


@pytest.mark.parametrize("index", range(len(WRITTEN)))
def test_written_yaml_reads_back_under_pyyaml_and_the_port(tmp_path, index):
    value = WRITTEN[index]
    text = yaml_io.dump(value)
    assert same(yaml.safe_load(text), value)
    assert same(yaml_io.safe_load(text), value)
    if isinstance(value, dict):
        save_config(value, tmp_path / "c.yaml")
        assert same(yaml.safe_load((tmp_path / "c.yaml").read_text()), value)


def test_port_dataset_config_reads_back(tmp_path):
    from yolo_infer_tpu_torch.data.dataset import parse_dataset_config
    from yolo_infer_tpu_torch.data.loader import create_dataset_config

    path = create_dataset_config(tmp_path / "d" / "data.yaml", "images/train", "images/val", ["a", "b"])
    assert yaml.safe_load(path.read_text()) == {"train": "images/train", "val": "images/val",
                                                "names": {0: "a", 1: "b"}, "nc": 2}
    cfg = parse_dataset_config(path)
    assert cfg["names"] == {0: "a", 1: "b"} and cfg["nc"] == 2 and cfg["_base"] == path.parent


def test_relative_dataset_config_without_path_resolves_its_splits(tmp_path, monkeypatch):
    """A dataset YAML named by a relative path and without a `path` key finds
    its splits under its own directory (the CLI's `--data ds/data.yaml`)."""
    from yolo_infer_tpu_torch.data.dataset import YOLODataset
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image

    save_image(tmp_path / "ds" / "images" / "val" / "a.png", np.zeros((8, 8, 3), np.uint8))
    create_dataset_config(tmp_path / "ds" / "data.yaml", "images/val", "images/val", ["a"])
    monkeypatch.chdir(tmp_path)
    assert [p.name for p in YOLODataset("ds/data.yaml", split="val").images] == ["a.png"]
