"""``python -m terra_gan_tpu_torch``: the pipeline CLI (cli/main_pipeline.py)."""

import sys

from .cli.main_pipeline import main

if __name__ == "__main__":
    sys.exit(main())
