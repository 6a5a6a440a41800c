"""`python -m yolo_infer_tpu_torch <command>`: the port's command line (`cli.py`)."""

import sys

from yolo_infer_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
