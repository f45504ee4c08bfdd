"""The GCE metadata fetcher of the JAX package's ``scheduler/labeler.py``
(``METADATA_BASE``, ``metadata_fetcher``), copied so that the port
imports nothing of the JAX package."""

import logging
import urllib.error
import urllib.request
from typing import Callable, Optional

log = logging.getLogger(__name__)

METADATA_BASE = "http://metadata.google.internal/computeMetadata/v1"

Fetcher = Callable[[str], Optional[str]]


def metadata_fetcher(base: str = METADATA_BASE) -> Fetcher:
    """fetch(path) -> the metadata server's answer, or None when it does
    not answer."""

    def fetch(path: str) -> Optional[str]:
        req = urllib.request.Request(base + path,
                                     headers={"Metadata-Flavor": "Google"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.read().decode()
        except (urllib.error.URLError, OSError) as e:
            log.warning("metadata fetch %s failed: %s", path, e)
            return None

    return fetch
