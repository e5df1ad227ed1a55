"""Checksummed artifact fetching (the twin of
``luciddreamer_tpu/utils/download.py``): download with an md5 check,
delete on corruption, keep a verified local copy.  Standard library only;
a fetch that cannot reach its source raises ``IOError``."""
from __future__ import annotations

import hashlib
import os
import urllib.request


def md5_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def fetch_checked(url: str, dest: str, md5: str | None = None,
                  retries: int = 2) -> str:
    """Download ``url`` to ``dest`` unless a verified copy exists there;
    check the md5 when given and delete a file that fails it.  Tries
    ``retries + 1`` times, then raises ``IOError``."""
    if os.path.exists(dest):
        if md5 is None or md5_of(dest) == md5:
            return dest
        os.remove(dest)                     # corrupt cache
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    last = None
    for _ in range(retries + 1):
        try:
            urllib.request.urlretrieve(url, dest)
            if md5 is not None and md5_of(dest) != md5:
                os.remove(dest)
                raise IOError(f"md5 mismatch for {url}")
            return dest
        except Exception as e:              # noqa: BLE001 - retried, then raised
            last = e
            if os.path.exists(dest):
                os.remove(dest)
    raise IOError(f"failed to fetch {url}: {last}")
