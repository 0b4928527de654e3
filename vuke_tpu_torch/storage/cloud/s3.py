"""Minimal S3-compatible client: AWS SigV4 PUT/GET/LIST over requests.

The port's copy of ``vuke_tpu/storage/cloud/s3.py``, with no SDK;
``requests`` is imported by the calls that use the network.  Credentials
resolve CLOUD_* then AWS_* environment variables.  ``InMemoryUploader`` is
the tests' fake, with failure injection.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import os
import urllib.parse
from typing import List, Optional

from . import CloudConfig, CloudPath


# multipart streaming parameters: 8MB parts
MULTIPART_THRESHOLD = 8 * 1024 * 1024
PART_SIZE = 8 * 1024 * 1024
PART_RETRIES = 3


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


class S3Uploader:
    def __init__(self, config: CloudConfig):
        self.config = config
        self.bucket = config.bucket
        self.endpoint = config.endpoint
        self.access_key = _env("CLOUD_ACCESS_KEY_ID", "AWS_ACCESS_KEY_ID")
        self.secret_key = _env("CLOUD_SECRET_ACCESS_KEY", "AWS_SECRET_ACCESS_KEY")
        self.region = _env("CLOUD_REGION", "AWS_REGION", default="us-east-1")
        if not self.access_key or not self.secret_key:
            raise RuntimeError(
                "missing credentials: set CLOUD_ACCESS_KEY_ID/CLOUD_SECRET_ACCESS_KEY "
                "or AWS_ACCESS_KEY_ID/AWS_SECRET_ACCESS_KEY")

    # -- SigV4 --------------------------------------------------------------

    def _sign(self, method: str, url: str, payload_hash: str, headers: dict) -> dict:
        parsed = urllib.parse.urlparse(url)
        now = _dt.datetime.now(_dt.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers = dict(headers)
        headers["host"] = parsed.netloc
        headers["x-amz-date"] = amz_date
        headers["x-amz-content-sha256"] = payload_hash

        signed_names = sorted(headers)
        canonical_headers = "".join(f"{k}:{headers[k].strip()}\n" for k in signed_names)
        signed_headers = ";".join(signed_names)
        canonical_request = "\n".join([
            method, urllib.parse.quote(parsed.path, safe="/-_.~"),
            parsed.query, canonical_headers, signed_headers, payload_hash])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical_request.encode()).hexdigest()])

        def _hmac(key, msg):
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}")
        return headers

    def _url(self, key: str) -> str:
        if self.endpoint:
            return f"{self.endpoint.rstrip('/')}/{self.bucket}/{urllib.parse.quote(key)}"
        return (f"https://{self.bucket}.s3.{self.region}.amazonaws.com/"
                f"{urllib.parse.quote(key)}")

    # -- operations ---------------------------------------------------------

    def upload_file(self, local_path: str, key: str) -> CloudPath:
        """Upload a file; large files stream as S3 multipart parts.

        Files over MULTIPART_THRESHOLD never sit whole in memory: parts are
        read, signed and PUT one at a time with per-part retry, and the
        upload is aborted server-side on failure."""
        size = os.path.getsize(local_path)
        if size > MULTIPART_THRESHOLD:
            return self._upload_multipart(local_path, key, size)
        import requests
        with open(local_path, "rb") as f:
            data = f.read()
        payload_hash = hashlib.sha256(data).hexdigest()
        url = self._url(key)
        headers = self._sign("PUT", url, payload_hash,
                             {"content-length": str(len(data))})
        resp = requests.put(url, data=data, headers=headers, timeout=60)
        if resp.status_code not in (200, 201):
            raise RuntimeError(f"S3 PUT {key} failed: {resp.status_code} {resp.text[:200]}")
        return CloudPath(self.bucket, key)

    def _upload_multipart(self, local_path: str, key: str, size: int) -> CloudPath:
        import requests

        empty_hash = hashlib.sha256(b"").hexdigest()
        base = self._url(key)

        resp = requests.post(base + "?uploads",
                             headers=self._sign("POST", base + "?uploads",
                                                empty_hash, {}), timeout=60)
        if resp.status_code != 200:
            raise RuntimeError(f"S3 CreateMultipartUpload {key} failed: "
                               f"{resp.status_code} {resp.text[:200]}")
        import re
        m = re.search(r"<UploadId>([^<]+)</UploadId>", resp.text)
        if not m:
            raise RuntimeError(f"S3 CreateMultipartUpload {key}: no UploadId")
        upload_id = m.group(1)

        etags = []
        try:
            with open(local_path, "rb") as f:
                part_no = 1
                while True:
                    data = f.read(PART_SIZE)
                    if not data:
                        break
                    url = (f"{base}?partNumber={part_no}&"
                           f"uploadId={urllib.parse.quote(upload_id)}")
                    payload_hash = hashlib.sha256(data).hexdigest()
                    last = None
                    for _attempt in range(PART_RETRIES):
                        headers = self._sign("PUT", url, payload_hash,
                                             {"content-length": str(len(data))})
                        r = requests.put(url, data=data, headers=headers, timeout=120)
                        if r.status_code == 200:
                            etags.append((part_no, r.headers.get("ETag", "")))
                            last = None
                            break
                        last = RuntimeError(
                            f"S3 UploadPart {key}#{part_no}: {r.status_code}")
                    if last is not None:
                        raise last
                    part_no += 1

            body = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in etags) + "</CompleteMultipartUpload>"
            url = f"{base}?uploadId={urllib.parse.quote(upload_id)}"
            payload_hash = hashlib.sha256(body.encode()).hexdigest()
            headers = self._sign("POST", url, payload_hash,
                                 {"content-length": str(len(body))})
            resp = requests.post(url, data=body.encode(), headers=headers,
                                 timeout=60)
            if resp.status_code != 200 or "<Error>" in resp.text:
                raise RuntimeError(f"S3 CompleteMultipartUpload {key} failed: "
                                   f"{resp.status_code} {resp.text[:200]}")
        except BaseException:
            url = f"{base}?uploadId={urllib.parse.quote(upload_id)}"
            try:
                requests.delete(url, headers=self._sign("DELETE", url,
                                                        empty_hash, {}),
                                timeout=30)
            except Exception:
                pass
            raise
        return CloudPath(self.bucket, key)

    def list_objects(self, prefix: Optional[str] = None) -> List[CloudPath]:
        import requests
        q = {"list-type": "2"}
        if prefix:
            q["prefix"] = prefix
        base = (self.endpoint.rstrip("/") + "/" + self.bucket if self.endpoint
                else f"https://{self.bucket}.s3.{self.region}.amazonaws.com")
        url = base + "/?" + urllib.parse.urlencode(sorted(q.items()))
        payload_hash = hashlib.sha256(b"").hexdigest()
        headers = self._sign("GET", url, payload_hash, {})
        resp = requests.get(url, headers=headers, timeout=60)
        if resp.status_code != 200:
            raise RuntimeError(f"S3 LIST failed: {resp.status_code}")
        import re
        keys = re.findall(r"<Key>([^<]+)</Key>", resp.text)
        return [CloudPath(self.bucket, k) for k in keys]


class InMemoryUploader:
    """Test fake: an in-memory object store with optional failure
    injection."""

    def __init__(self, bucket: str = "test-bucket", fail_keys=(), fail_times: int = 0,
                 part_size: int = PART_SIZE,
                 multipart_threshold: int = MULTIPART_THRESHOLD):
        self.bucket = bucket
        self.objects = {}
        self.fail_keys = set(fail_keys)
        self.fail_times = fail_times
        self._failures = {}
        self.part_size = part_size
        self.multipart_threshold = multipart_threshold
        self.multipart_parts = {}  # key -> number of parts streamed

    def upload_file(self, local_path: str, key: str) -> CloudPath:
        if key in self.fail_keys:
            n = self._failures.get(key, 0)
            if self.fail_times < 0 or n < self.fail_times:
                self._failures[key] = n + 1
                raise RuntimeError(f"injected failure for {key}")
        size = os.path.getsize(local_path)
        if size > self.multipart_threshold:
            # mirror S3Uploader's streaming split so tests can assert on it
            parts = []
            with open(local_path, "rb") as f:
                while True:
                    data = f.read(self.part_size)
                    if not data:
                        break
                    parts.append(data)
            self.multipart_parts[key] = len(parts)
            self.objects[key] = b"".join(parts)
        else:
            with open(local_path, "rb") as f:
                self.objects[key] = f.read()
        return CloudPath(self.bucket, key)

    def list_objects(self, prefix: Optional[str] = None) -> List[CloudPath]:
        keys = sorted(k for k in self.objects if not prefix or k.startswith(prefix))
        return [CloudPath(self.bucket, k) for k in keys]
