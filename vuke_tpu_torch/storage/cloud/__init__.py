"""Cloud sync: S3/R2/MinIO upload with retry/backoff and bounded concurrency.

The port's copy of ``vuke_tpu/storage/cloud/__init__.py``: CloudConfig (5
retries, 100ms -> 30s exponential backoff, fail_fast vs
continue-and-report), CloudPath.url, bounded concurrent uploads (default 4),
remote keys preserving the ``transform=/date=`` partition components,
delete-local only after a confirmed upload, and atomic UploadStats.  The S3
client (``s3.py``) is SigV4 over ``requests``, imported when it uploads;
``sync_to_cloud`` takes an injected ``uploader`` (the tests' in-memory one).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEFAULT_CONCURRENCY = 4


@dataclass
class CloudConfig:
    endpoint: Optional[str] = None
    bucket: Optional[str] = None
    prefix: Optional[str] = None
    delete_local: bool = False
    max_retries: int = 5
    base_retry_delay: float = 0.1
    max_retry_delay: float = 30.0
    fail_fast: bool = False
    concurrency: int = DEFAULT_CONCURRENCY


@dataclass
class CloudPath:
    bucket: str
    key: str

    def url(self, endpoint: Optional[str] = None) -> str:
        if endpoint:
            return f"{endpoint.rstrip('/')}/{self.bucket}/{self.key}"
        return f"s3://{self.bucket}/{self.key}"


class UploadStats:
    """Atomic counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.started = 0
        self.completed = 0
        self.failed = 0
        self.bytes_uploaded = 0
        self.retries = 0

    def record_start(self):
        with self._lock:
            self.started += 1

    def record_complete(self, nbytes: int):
        with self._lock:
            self.completed += 1
            self.bytes_uploaded += nbytes

    def record_failure(self):
        with self._lock:
            self.failed += 1

    def record_retry(self):
        with self._lock:
            self.retries += 1


def remote_key(local_path: str, base_dir: str, prefix: Optional[str]) -> str:
    """Remote key preserving the transform=/date= partition components."""
    rel = os.path.relpath(local_path, base_dir)
    parts = rel.split(os.sep)
    key = "/".join(parts)
    if prefix:
        key = f"{prefix.rstrip('/')}/{key}"
    return key


def upload_with_retry(uploader, local_path: str, key: str, config: CloudConfig,
                      stats: UploadStats) -> CloudPath:
    delay = config.base_retry_delay
    last_err = None
    for attempt in range(config.max_retries + 1):
        try:
            return uploader.upload_file(local_path, key)
        except Exception as e:  # noqa: BLE001 — retried, re-raised at the end
            last_err = e
            if attempt == config.max_retries:
                break
            stats.record_retry()
            time.sleep(delay)
            delay = min(delay * 2, config.max_retry_delay)
    raise RuntimeError(f"upload failed after {config.max_retries} retries: {last_err}")


def sync_files(uploader, paths: List[str], base_dir: str, config: CloudConfig,
               stats: Optional[UploadStats] = None) -> Tuple[List[CloudPath], List[str]]:
    """Bounded-concurrency sync.  Returns (uploaded CloudPaths, failed paths).

    fail_fast: stop scheduling on first failure; otherwise continue and
    report.  delete_local removes files only after a confirmed upload.
    """
    stats = stats or UploadStats()
    uploaded: List[CloudPath] = []
    failed: List[str] = []
    lock = threading.Lock()
    stop = threading.Event()

    def work(p: str):
        if stop.is_set():
            with lock:
                failed.append(p)
            return
        stats.record_start()
        key = remote_key(p, base_dir, config.prefix)
        try:
            cp = upload_with_retry(uploader, p, key, config, stats)
            stats.record_complete(os.path.getsize(p) if os.path.exists(p) else 0)
            with lock:
                uploaded.append(cp)
            if config.delete_local:
                try:
                    os.remove(p)
                except OSError:
                    pass
        except Exception:
            stats.record_failure()
            with lock:
                failed.append(p)
            if config.fail_fast:
                stop.set()

    with concurrent.futures.ThreadPoolExecutor(max_workers=config.concurrency) as ex:
        list(ex.map(work, paths))
    return uploaded, failed


def sync_to_cloud(paths: List[str], base_dir: str, config: CloudConfig,
                  uploader=None) -> List[CloudPath]:
    """CLI entry: build the S3 uploader from config/env and sync."""
    import sys
    if uploader is None:
        from .s3 import S3Uploader
        if not config.bucket:
            print("Cloud upload requested but no bucket configured "
                  "(--cloud-bucket / CLOUD_BUCKET)", file=sys.stderr)
            return []
        uploader = S3Uploader(config)
    stats = UploadStats()
    uploaded, failed = sync_files(uploader, paths, base_dir, config, stats)
    print(f"Cloud upload: {stats.completed} succeeded, {stats.failed} failed, "
          f"{stats.bytes_uploaded} bytes, {stats.retries} retries", file=sys.stderr)
    for cp in uploaded:
        print(f"  {cp.url(config.endpoint)}", file=sys.stderr)
    if failed and config.fail_fast:
        raise SystemExit("cloud upload failed (fail-fast)")
    return uploaded
