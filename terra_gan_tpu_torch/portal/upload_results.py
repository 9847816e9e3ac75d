"""Upload colored inpainted tiles to the annotation portal (counterpart of
terra_gan_tpu/portal/upload_results.py; reference: upload_results.py, a
retried, chunked upload of data/output/<grid>/colored/*.png).

    python -m terra_gan_tpu_torch.portal.upload_results --grid NJ05
        [--retry 3] [--config config.yaml]
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from ..config import Config
from .client import PortalClient

logger = logging.getLogger(__name__)


def upload_results(grid_square: str, config: Optional[Config] = None,
                   retry_count: int = 3) -> bool:
    cfg = config or Config()
    colored_dir = Path(cfg.data.output_dir) / grid_square / "colored"
    if not colored_dir.exists():
        logger.error("colored dir missing: %s", colored_dir)
        return False
    image_paths = sorted(colored_dir.glob("*.png"))
    if not image_paths:
        logger.error("no colored tiles to upload for %s", grid_square)
        return False
    client = PortalClient(cfg.portal.base_url, cfg.portal.api_key)
    for attempt in range(1, retry_count + 1):
        if client.upload_batch(grid_square, image_paths):
            logger.info("uploaded %d tiles for %s", len(image_paths), grid_square)
            return True
        logger.warning("upload attempt %d/%d failed", attempt, retry_count)
    logger.error("all upload attempts failed for %s", grid_square)
    return False


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Upload results to the portal")
    p.add_argument("--grid", required=True)
    p.add_argument("--retry", type=int, default=3)
    p.add_argument("--config", default="config.yaml")
    args = p.parse_args(argv)
    cfg = Config.load(args.config) if Path(args.config).exists() else Config()
    return 0 if upload_results(args.grid, cfg, args.retry) else 1


if __name__ == "__main__":
    raise SystemExit(main())
