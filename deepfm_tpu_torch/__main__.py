"""``python -m deepfm_tpu_torch --task_type train ...``: launch/cli.py."""

import sys

from .launch.cli import main

if __name__ == "__main__":
    sys.exit(main())
