"""Host-side thread-pool helpers (counterpart of terra_gan_tpu/data/parallel.py;
reference: utils/parallel_processing.py).

Map-over-images helpers for mask generation and IO stages. Workers
default to min(cpu_count, 8) (parallel_processing.py:26-30); errors are
counted and logged, never raised (log-and-continue).
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor, as_completed
from functools import partial
from typing import Any, Callable, List, Optional, Sequence

logger = logging.getLogger(__name__)


def default_workers() -> int:
    return min(os.cpu_count() or 4, 8)


def process_images_in_parallel(
    image_paths: Sequence,
    processor_func: Callable,
    max_workers: Optional[int] = None,
    **kwargs,
) -> List[Any]:
    """Thread-pool map with error counting; returns successful results."""
    workers = max_workers or default_workers()
    fn = partial(processor_func, **kwargs) if kwargs else processor_func

    results: List[Any] = []
    errors = 0
    with ThreadPoolExecutor(max_workers=workers) as pool:
        futures = {pool.submit(fn, p): p for p in image_paths}
        for fut in as_completed(futures):
            try:
                results.append(fut.result())
            except Exception as e:
                errors += 1
                logger.error("processing failed for %s: %s", futures[fut], e)
    if errors:
        logger.warning("%d/%d items failed", errors, len(image_paths))
    return results


def batch_process(
    items: Sequence,
    processor_func: Callable,
    batch_size: int = 16,
    max_workers: Optional[int] = None,
    **kwargs,
) -> List[Any]:
    """Chunked variant: processes items in batches to bound memory."""
    out: List[Any] = []
    for start in range(0, len(items), batch_size):
        chunk = items[start : start + batch_size]
        out.extend(
            process_images_in_parallel(
                chunk, processor_func, max_workers=max_workers, **kwargs
            )
        )
        logger.info(
            "batch %d/%d done",
            start // batch_size + 1,
            -(-len(items) // batch_size),
        )
    return out
